"""Weight management (port of the parts of ``engine/weights.py`` the
serving path needs): preset resolution, load-time blocking of the int8
projections, and conversion of the reference's param trees (Llama and
BERT, with the rerank head), KV caches and paged KV pools from numpy, and
``weights_dir_for`` (where a provisioned checkpoint would be).  HF
safetensors loading is not ported yet (``ROADMAP.md``, Queue 1 item 5)."""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix, block_matrix
from generativeaiexamples_tpu_torch.ops.quant import QuantizedMatrix

logger = get_logger(__name__)

WEIGHTS_DIR_ENV = "GAIE_WEIGHTS_DIR"

# Per-layer projection leaves the W8A8 kernel consumes (packed layout).
PREBLOCK_TARGETS = ("wqkv", "w_gu", "w_down", "wo")


def preblock_llama_params(params):
    """Block every int8 projection leaf once, at load, into the W8A8
    kernel's layout (``ops.qmm.block_matrix``); blocked leaves pass
    through, so this is idempotent."""
    layers = dict(params["layers"])
    for name in PREBLOCK_TARGETS:
        layers[name] = block_matrix(layers[name])
    return {**params, "layers": layers}


def head_for_logits(params, cfg):
    """Hold an int8 head's values in the compute dtype, once, at load:
    int8 -> bf16 (or f32) is exact, and ``models.llama.logits`` multiplies
    them with f32 accumulation, as the reference's convert-in-the-dot does."""
    head = params.get("lm_head")
    if isinstance(head, QuantizedMatrix) and head.q.dtype == torch.int8:
        params = {**params, "lm_head": QuantizedMatrix(head.q.to(cfg.compute_dtype), head.scale)}
    return params


def resolve_model_preset(model_name: str) -> str:
    """Map a model name (HF id or NIM-style) to one of the port's presets."""
    name = model_name.lower()
    for family in ("mixtral", "8x7b", "gemma", "starcoder", "moe"):
        if family in name:
            raise ValueError(f"model {model_name!r}: the {family} family is not ported yet")
    if "70b" in name:
        return "llama3-70b"
    if re.search(r"(?<!\d)1b", name) and ("3.2" in name or "llama" in name):
        return "llama3.2-1b"
    if "8b" in name or "llama-3" in name or "llama3" in name:
        return "llama3-8b"
    if "tiny" in name:
        return "llama-tiny"
    logger.warning("unknown model %r; defaulting to llama-tiny preset", model_name)
    return "llama-tiny"


def weights_dir_for(model_name: str) -> Optional[str]:
    """Local checkpoint dir for a model, if one is provisioned (a copy of
    the reference's: ``$GAIE_WEIGHTS_DIR/<name with / as -->``)."""
    root = os.environ.get(WEIGHTS_DIR_ENV, "")
    if not root:
        return None
    cand = os.path.join(root, model_name.replace("/", "--"))
    return cand if os.path.isdir(cand) else None


def _tensor(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> a torch copy, exactly (the
    port updates caches in place, so it never shares the caller's buffer)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf(x, device):
    if hasattr(x, "tiles") and hasattr(x, "k"):
        # Reference layout: tiles (..., NB, K_pad, BN), scale (..., NB, 1, BN).
        tiles = np.asarray(x.tiles)
        *lead, nb, k_pad, bn = tiles.shape
        n_pad = -(-int(x.n) // 64) * 64
        w = np.swapaxes(tiles, -1, -2).reshape(*lead, nb * bn, k_pad)[..., :n_pad, :]
        scale = np.asarray(x.scale, np.float32).reshape(*lead, nb * bn)[..., :n_pad]
        return BlockedQuantizedMatrix(
            w=_tensor(np.ascontiguousarray(w), device),
            scale=_tensor(np.ascontiguousarray(scale), device),
            k=int(x.k),
            n=int(x.n),
        )
    if hasattr(x, "q") and hasattr(x, "scale"):
        return QuantizedMatrix(q=_tensor(x.q, device), scale=_tensor(x.scale, device))
    return _tensor(x, device)


def params_from_numpy(tree, cfg, device) -> dict:
    """The reference's llama param tree, with numpy leaves
    (``jax.tree.map(np.asarray, params)``), as the port's params.

    Plain arrays become tensors, ``QuantizedMatrix(q, scale)`` the port's
    QuantizedMatrix, and ``BlockedQuantizedMatrix(tiles, scale, k, n)`` the
    port's K-contiguous blocked layout (the same int8 values and scales).
    An int8 head is held in the compute dtype (:func:`head_for_logits`),
    as ``engine.decode.prepare_params`` does.
    """
    embed_rows = np.shape(getattr(tree["embed"], "q", tree["embed"]))[0]
    depth = np.shape(np.asarray(tree["layers"]["attn_norm"]))[0]
    if (embed_rows, depth) != (cfg.vocab_size, cfg.n_layers):
        raise ValueError(
            f"param tree has vocab {embed_rows} and {depth} layers; the config "
            f"says {cfg.vocab_size} and {cfg.n_layers}"
        )
    out = {k: _leaf(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: _leaf(v, device) for k, v in tree["layers"].items()}
    return head_for_logits(out, cfg)


def cache_from_numpy(cache, device) -> tuple:
    """The reference's KV cache leaves (numpy) as the port's cache tuple."""
    return tuple(_tensor(leaf, device) for leaf in cache)


def pool_from_numpy(pool, cfg, device):
    """A reference ``PagedKVPool``'s state as the port's pool: the leaves
    (read with ``np.asarray``), page tables, refcounts, free list, held
    counts and counters, so both pools continue from one state."""
    from generativeaiexamples_tpu_torch.engine.paged_kv import PagedKVPool

    out = PagedKVPool(cfg, pool.max_batch, pool.max_len, pool.page_tokens, pool.total_pages, device=device)
    out.leaves = cache_from_numpy([np.asarray(leaf) for leaf in pool.leaves], device)
    out.tables = np.array(pool.tables, dtype=np.int32, copy=True)
    out._refcount = np.array(pool._refcount, dtype=np.int32, copy=True)
    out._free = [int(p) for p in pool._free]
    out._held = np.array(pool._held, dtype=np.int32, copy=True)
    out.cow_breaks = int(pool.cow_breaks)
    out.frees_total = int(pool.frees_total)
    out._dirty = True
    return out


def _tree_from_numpy(tree, shapes, device, what: str) -> dict:
    out = {}
    for name, shape in shapes.items():
        if isinstance(shape, dict):
            out[name] = _tree_from_numpy(tree[name], shape, device, what)
            continue
        leaf = _tensor(tree[name], device)
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f"{what} leaf {name!r} has shape {tuple(leaf.shape)}; the config says {shape}")
        out[name] = leaf
    return out


def bert_params_from_numpy(tree, cfg, device) -> dict:
    """The reference's BERT param tree, with numpy leaves
    (``jax.tree.map(np.asarray, params)``), as the port's params: the same
    leaf names, shapes and values (bfloat16 leaves exactly)."""
    from generativeaiexamples_tpu_torch.models.bert import param_shapes

    return _tree_from_numpy(tree, param_shapes(cfg), device, "bert param")


def rerank_head_from_numpy(head, device) -> dict:
    """The reference's rerank head (``w_pool``/``b_pool`` when it has the
    pooler, ``w``/``b``) with numpy leaves, as tensors."""
    return {name: _tensor(leaf, device) for name, leaf in head.items()}
