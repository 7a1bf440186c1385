"""Weight management (port of ``engine/weights.py``): preset resolution,
HF safetensors checkpoints (the reader and writer; Llama / Mistral,
Mixtral, Gemma and StarCoder2 causal LMs; BERT encoders and
cross-encoders; ViT encoders; wav2vec2-CTC), load-time blocking of the
int8 projections, conversion of the reference's param trees (the Llama
family and BERT, with the rerank head; the ViT, the VLM and the speech
models), KV caches and paged KV pools from numpy, training state from
numpy (optax's Adam moments, LoRA adapters, the train states), and
``weights_dir_for`` (where a provisioned checkpoint is).

Checkpoints keep BF16 as bf16: the reference widens it to f32 on the
host (``(u16 << 16).view(f32)``), which at 8B parameters is a 32 GB host
copy; the port views the mmapped bytes as ``torch.bfloat16``, which is
the same value (bf16 -> f32 -> bf16 round-trips).  Loaders read the
checkpoint tensor by tensor and drop each layer's pages from the mapping
once it is on the device, so the host holds about one layer at a time.
"""

from __future__ import annotations

import json
import mmap
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

# Per-layer projection leaves the W8A8 kernel consumes, packed (wqkv,
# w_gu) or unpacked (biased trees: StarCoder2; MoE trees have no dense MLP).
# The head, the embedding, the router and the experts are not blocked.
PREBLOCK_TARGETS = ("wqkv", "w_gu", "wq", "wk", "wv", "w_gate", "w_up", "w_down", "wo")


def preblock_llama_params(params):
    """Block every int8 projection leaf the tree has, once, at load, into
    the W8A8 kernel's layout (``ops.qmm.block_matrix``); blocked leaves
    pass through, so this is idempotent."""
    layers = dict(params["layers"])
    for name in PREBLOCK_TARGETS:
        if isinstance(layers.get(name), (QuantizedMatrix, BlockedQuantizedMatrix)):
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
    if "mixtral" in name or "8x7b" in name:
        return "mixtral-8x7b"
    if "gemma" in name:
        if "tiny" in name:
            return "gemma-tiny"
        return "gemma-7b" if "7b" in name else "gemma-2b"
    if "starcoder" in name:
        return "starcoder2-tiny" if "tiny" in name else "starcoder2-3b"
    if "moe" in name and "tiny" in name:
        return "llama-moe-tiny"
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


# -- HF safetensors checkpoints ----------------------------------------------

_ST_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
}
_ST_NAMES = {dt: name for name, dt in _ST_DTYPES.items()}


class _Checkpoint(dict):
    """``{name: tensor}`` over mmapped safetensors shards.  The tensors are
    views of private (copy-on-write) mappings; :meth:`release` drops the
    pages read so far from the process (a later read faults them back in
    from the file), so a loader that releases after each layer keeps one
    layer's pages resident, not the model's."""

    def __init__(self) -> None:
        super().__init__()
        self.maps: list = []

    def release(self) -> None:
        for mm in self.maps:
            mm.madvise(mmap.MADV_DONTNEED)


def _open_safetensors(path: str) -> _Checkpoint:
    """Minimal safetensors reader: ``{name: tensor}``, each a lazy view of
    the mmapped file (BF16 as ``torch.bfloat16``, never widened)."""
    with open(path, "rb") as fh:
        header_len = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(header_len))
        base = 8 + header_len
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
    tensors = _Checkpoint()
    tensors.maps.append(mm)
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        count = (end - start) // dt.itemsize
        if count == 0:
            flat = torch.empty(0, dtype=dt)
        elif (base + start) % dt.itemsize:
            # An unaligned tensor (a writer that does not pad its header):
            # read it through bytes, which any offset allows.
            flat = torch.frombuffer(bytearray(mm[base + start : base + end]), dtype=dt)
        else:
            flat = torch.frombuffer(mm, dtype=dt, count=count, offset=base + start)
        tensors[name] = flat.reshape(meta["shape"])
    return tensors


def _load_safetensors_dir(ckpt_dir: str) -> _Checkpoint:
    """Every ``*.safetensors`` shard of a directory as one lazy dict (a
    sharded ``model-0000k-of-0000n`` checkpoint loads as one)."""
    import glob

    shards = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no safetensors found in {ckpt_dir}")
    tensors = _Checkpoint()
    for path in shards:
        shard = _open_safetensors(path)
        tensors.update(shard)
        tensors.maps += shard.maps
    return tensors


def save_safetensors(tensors: dict, path: str) -> None:
    """Write ``{name: tensor or np.ndarray}`` as a safetensors file, tensor
    by tensor (no second copy of the data).

    Counterpart of :func:`_open_safetensors`.  float32 / float16 / bfloat16
    (torch, or numpy's ml_dtypes ``bfloat16``) / int32 / int64 store as
    F32 / F16 / BF16 / I32 / I64; the header is padded to 8 bytes, as the
    ``safetensors`` package pads it, so every tensor starts aligned.
    """
    arrays = {}
    for name, arr in tensors.items():
        if not isinstance(arr, torch.Tensor):
            arr = np.ascontiguousarray(arr)
            if arr.dtype.name == "bfloat16":
                arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                arr = torch.from_numpy(arr)
        t = arr.detach().cpu().contiguous()
        arrays[name] = (_ST_NAMES[t.dtype], t)
    header: dict = {}
    offset = 0
    for name, (dtype, t) in arrays.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": dtype, "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little"))
        fh.write(head)
        for _, t in arrays.values():
            fh.write(t.reshape(-1).view(torch.uint8).numpy().data)


def _release(tensors) -> None:
    release = getattr(tensors, "release", None)
    if release is not None:
        release()


def _owned(t: torch.Tensor, dt, device) -> torch.Tensor:
    """A copy of a checkpoint tensor in ``dt`` on ``device`` (never a view
    of the file's mapping)."""
    return t.to(device=device, dtype=dt, copy=True)


def _transposed(t: torch.Tensor, dt, device) -> torch.Tensor:
    """A checkpoint's (out, in) matrix as a contiguous (in, out) copy,
    transposed on ``device``."""
    return t.to(device).T.contiguous().to(dt)


def _stack_layers(tensors, fmt: str, n_layers: int, dt, device, transpose: bool = True) -> torch.Tensor:
    """Stack per-layer HF tensors onto a leading layer axis, transposing
    (out, in) -> (in, out) matmul weights, one layer at a time: each
    layer's contiguous rows go to the device and are transposed there, and
    its pages leave the host after."""
    out = None
    for i in range(n_layers):
        w = tensors[fmt.format(i)].to(device)
        w = w.T if transpose else w
        if out is None:
            out = torch.empty((n_layers, *w.shape), dtype=dt, device=device)
        out[i].copy_(w)
        del w
        _release(tensors)
    return out


def llama_config_from_hf(ckpt_dir: str, **overrides):
    """A LlamaConfig from a HF checkpoint's ``config.json`` (LlamaForCausalLM
    fields) instead of a by-name preset.  Refuses what the reference
    refuses: anything but the llama / mistral family (gemma and starcoder2
    carry the same keys but need other architecture knobs)."""
    import dataclasses

    from generativeaiexamples_tpu_torch.models import llama

    with open(os.path.join(ckpt_dir, "config.json"), encoding="utf-8") as fh:
        hf = json.load(fh)
    mtype = hf.get("model_type", "llama")
    archs = hf.get("architectures") or []
    if mtype not in ("llama", "mistral") or any("Llama" not in a and "Mistral" not in a for a in archs):
        raise ValueError(
            f"checkpoint is model_type={mtype!r} architectures={archs!r}; "
            "llama_config_from_hf only maps the llama/mistral family — "
            "use the matching preset + converter for other families"
        )
    n_heads = hf["num_attention_heads"]
    cfg = llama.LlamaConfig(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // n_heads,
        d_ff=hf["intermediate_size"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        max_seq_len=min(int(hf.get("max_position_embeddings", 8192)), 8192),
    )
    return dataclasses.replace(cfg, **overrides)


def _stack_experts(tensors, fmt: str, cfg, dt, device) -> torch.Tensor:
    """(L, E, in, out) expert weights from HF's per-expert (out, in)
    tensors ``fmt.format(layer, expert)``, one matrix at a time onto the
    device (transposed there), each layer's pages dropped after."""
    out = None
    for i in range(cfg.n_layers):
        for e in range(cfg.n_experts):
            w = tensors[fmt.format(i, e)].to(device).T
            if out is None:
                out = torch.empty((cfg.n_layers, cfg.n_experts, *w.shape), dtype=dt, device=device)
            out[i, e].copy_(w)
            del w
        _release(tensors)
    return out


def _tied_or_own_head(params: dict, tensors, dt, device) -> torch.Tensor:
    """``lm_head.weight`` transposed, or the embedding's transpose when the
    checkpoint ties them (Gemma, StarCoder2): the head is quantized per
    output channel apart from the embedding's per-row quantization."""
    if "lm_head.weight" in tensors:
        return _transposed(tensors["lm_head.weight"], dt, device)
    return params["embed"].T


def load_hf_llama(cfg, ckpt_dir: str, *, device=None) -> dict:
    """Convert a HF Llama / Mistral / Mixtral / Gemma safetensors
    checkpoint into the port's float param tree
    (``models.llama.init_params``' layout), in ``cfg.compute_dtype`` on
    ``device`` (the card unless ``"cpu"``).

    HF layout (``model.layers.N.self_attn.q_proj.weight`` etc., (out, in))
    maps to ours ((in, out), layers stacked on axis 0); RoPE is half-split
    in both, so no permutation.  Mixtral's MoE layers (the
    ``block_sparse_moe.gate`` router and each expert's ``w1`` / ``w3`` /
    ``w2``: gate / up / down) stack onto (L, E, ...) expert tensors.  A
    checkpoint without ``lm_head.weight`` (Gemma) ties the head to
    ``embed.T``.  ``engine.decode.prepare_params`` quantizes, packs and
    blocks the result; the experts and the router stay float.
    """
    from generativeaiexamples_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    tensors = _load_safetensors_dir(ckpt_dir)
    dt = cfg.compute_dtype

    def stack_layers(fmt: str, transpose: bool = True) -> torch.Tensor:
        return _stack_layers(tensors, fmt, cfg.n_layers, dt, device, transpose)

    lay = "model.layers.{}."
    if cfg.n_experts > 1:
        moe = lay + "block_sparse_moe."
        mlp = {
            "router": stack_layers(moe + "gate.weight"),
            "w_gate_e": _stack_experts(tensors, moe + "experts.{}.w1.weight", cfg, dt, device),
            "w_up_e": _stack_experts(tensors, moe + "experts.{}.w3.weight", cfg, dt, device),
            "w_down_e": _stack_experts(tensors, moe + "experts.{}.w2.weight", cfg, dt, device),
        }
    else:
        mlp = {
            "w_gate": stack_layers(lay + "mlp.gate_proj.weight"),
            "w_up": stack_layers(lay + "mlp.up_proj.weight"),
            "w_down": stack_layers(lay + "mlp.down_proj.weight"),
        }
    params = {"embed": _owned(tensors["model.embed_tokens.weight"], dt, device)}
    params["layers"] = {
        "attn_norm": stack_layers(lay + "input_layernorm.weight", transpose=False),
        "wq": stack_layers(lay + "self_attn.q_proj.weight"),
        "wk": stack_layers(lay + "self_attn.k_proj.weight"),
        "wv": stack_layers(lay + "self_attn.v_proj.weight"),
        "wo": stack_layers(lay + "self_attn.o_proj.weight"),
        "mlp_norm": stack_layers(lay + "post_attention_layernorm.weight", transpose=False),
        **mlp,
    }
    params["final_norm"] = _owned(tensors["model.norm.weight"], dt, device)
    params["lm_head"] = _tied_or_own_head(params, tensors, dt, device)
    _release(tensors)
    logger.info("loaded %d HF tensors from %s", len(tensors), ckpt_dir)
    return params


def load_hf_causal_lm(cfg, ckpt_dir: str, *, device=None) -> dict:
    """Config-dispatched HF causal-LM converter: the Llama / Mistral /
    Mixtral / Gemma map (:func:`load_hf_llama`), or the GPT family's
    (LayerNorm and biases, ungated MLP: :func:`load_hf_starcoder2`).  A
    gated MLP with LayerNorm or biases has no converter (no published
    checkpoint family has that shape), as in the reference."""
    if cfg.norm_type == "layernorm" or cfg.proj_bias:
        if cfg.mlp_gated:
            raise ValueError(
                "no HF converter for gated-MLP configs with layernorm/biases (no published checkpoint family "
                "has this shape)"
            )
        return load_hf_starcoder2(cfg, ckpt_dir, device=device)
    return load_hf_llama(cfg, ckpt_dir, device=device)


def load_hf_starcoder2(cfg, ckpt_dir: str, *, device=None) -> dict:
    """Convert a HF ``Starcoder2ForCausalLM`` checkpoint into the port's
    float param tree, in ``cfg.compute_dtype`` on ``device``.

    GPT-family layout: LayerNorm norms (weight and bias), biased q / k / v
    / o and ``c_fc`` / ``c_proj`` projections (``c_fc -> w_up``, ``c_proj
    -> w_down``), an ungated MLP, a head tied to the embedding unless the
    checkpoint has ``lm_head.weight``.  A checkpoint with another layer
    count than the config raises: the loader reads ``cfg.n_layers`` layers
    and would otherwise serve a truncated model (the 3b preset against a
    7b or 15b checkpoint).
    """
    from generativeaiexamples_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    tensors = _load_safetensors_dir(ckpt_dir)
    n_ckpt = len({k.split(".")[2] for k in tensors if k.startswith("model.layers.")})
    if n_ckpt != cfg.n_layers:
        raise ValueError(
            f"checkpoint has {n_ckpt} layers but config expects {cfg.n_layers} — pass a matching preset/overrides "
            "(starcoder2-7b/15b need their own geometry)"
        )
    dt = cfg.compute_dtype

    def stack_layers(fmt: str, transpose: bool = True) -> torch.Tensor:
        return _stack_layers(tensors, fmt, cfg.n_layers, dt, device, transpose)

    lay = "model.layers.{}."
    layers = {}
    for ours, hf in (("attn_norm", "input_layernorm"), ("mlp_norm", "post_attention_layernorm")):
        layers[ours] = stack_layers(lay + hf + ".weight", transpose=False)
        layers[ours + "_b"] = stack_layers(lay + hf + ".bias", transpose=False)
    for w, b, hf in (("wq", "bq", "self_attn.q_proj"), ("wk", "bk", "self_attn.k_proj"),
                     ("wv", "bv", "self_attn.v_proj"), ("wo", "bo", "self_attn.o_proj"),
                     ("w_up", "b_up", "mlp.c_fc"), ("w_down", "b_down", "mlp.c_proj")):
        layers[w] = stack_layers(lay + hf + ".weight")
        layers[b] = stack_layers(lay + hf + ".bias", transpose=False)
    params = {"embed": _owned(tensors["model.embed_tokens.weight"], dt, device), "layers": layers}
    params["final_norm"] = _owned(tensors["model.norm.weight"], dt, device)
    params["final_norm_b"] = _owned(tensors["model.norm.bias"], dt, device)
    params["lm_head"] = _tied_or_own_head(params, tensors, dt, device)
    _release(tensors)
    logger.info("loaded %d HF starcoder2 tensors from %s", len(tensors), ckpt_dir)
    return params


def bert_config_from_hf(ckpt_dir: str, **overrides):
    """A BertConfig from a HF checkpoint's ``config.json``."""
    from generativeaiexamples_tpu_torch.models import bert

    with open(os.path.join(ckpt_dir, "config.json"), encoding="utf-8") as fh:
        c = json.load(fh)
    kw = dict(
        vocab_size=c["vocab_size"],
        d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        d_ff=c["intermediate_size"],
        max_positions=c["max_position_embeddings"],
        type_vocab_size=c.get("type_vocab_size", 2),
        norm_eps=c.get("layer_norm_eps", 1e-12),
    )
    kw.update(overrides)
    return bert.BertConfig(**kw)


def _prefixed(tensors: dict, prefix: str) -> dict:
    """Strip a submodel prefix (e.g. ``bert.``) when present (the result
    releases the same mappings as ``tensors``)."""
    if not any(k.startswith(prefix) for k in tensors):
        return tensors
    out = _Checkpoint()
    out.maps = list(getattr(tensors, "maps", ()))
    out.update({k[len(prefix) :]: v for k, v in tensors.items() if k.startswith(prefix)})
    out.update({k: v for k, v in tensors.items() if not k.startswith(prefix)})
    return out


def load_hf_bert(cfg, ckpt_dir: str, _tensors=None, *, device=None) -> dict:
    """Convert a HF BERT checkpoint (arctic-embed-l class: a plain
    ``BertModel``, or a ``bert.``-prefixed task model) into the port's BERT
    tree (``models.bert.param_shapes``' names and shapes), in
    ``cfg.compute_dtype`` on ``device``."""
    from generativeaiexamples_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    tensors = _tensors if _tensors is not None else _load_safetensors_dir(ckpt_dir)
    dt = cfg.compute_dtype
    stripped = _prefixed(tensors, "bert.")

    def t(name: str) -> torch.Tensor:
        return _owned(stripped[name], dt, device)

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        return _stack_layers(stripped, fmt, cfg.n_layers, dt, device, transpose)

    lay = "encoder.layer.{}."
    params = {
        "tok_embed": t("embeddings.word_embeddings.weight"),
        "pos_embed": t("embeddings.position_embeddings.weight"),
        "type_embed": t("embeddings.token_type_embeddings.weight"),
        "embed_norm_g": t("embeddings.LayerNorm.weight"),
        "embed_norm_b": t("embeddings.LayerNorm.bias"),
        "layers": {
            "wq": stack(lay + "attention.self.query.weight", True),
            "bq": stack(lay + "attention.self.query.bias", False),
            "wk": stack(lay + "attention.self.key.weight", True),
            "bk": stack(lay + "attention.self.key.bias", False),
            "wv": stack(lay + "attention.self.value.weight", True),
            "bv": stack(lay + "attention.self.value.bias", False),
            "wo": stack(lay + "attention.output.dense.weight", True),
            "bo": stack(lay + "attention.output.dense.bias", False),
            "attn_norm_g": stack(lay + "attention.output.LayerNorm.weight", False),
            "attn_norm_b": stack(lay + "attention.output.LayerNorm.bias", False),
            "w_up": stack(lay + "intermediate.dense.weight", True),
            "b_up": stack(lay + "intermediate.dense.bias", False),
            "w_down": stack(lay + "output.dense.weight", True),
            "b_down": stack(lay + "output.dense.bias", False),
            "mlp_norm_g": stack(lay + "output.LayerNorm.weight", False),
            "mlp_norm_b": stack(lay + "output.LayerNorm.bias", False),
        },
    }
    _release(tensors)
    logger.info("loaded %d HF BERT tensors from %s", len(tensors), ckpt_dir)
    return params


def load_hf_cross_encoder(cfg, ckpt_dir: str, *, device=None) -> tuple[dict, dict]:
    """Convert a HF cross-encoder (``BertForSequenceClassification``)
    checkpoint: ``(encoder_params, rerank_head)``, the head carrying the
    BERT pooler (tanh dense) and the 1-logit classifier, as HF scores.
    A classifier with more than one logit is refused."""
    from generativeaiexamples_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    tensors = _load_safetensors_dir(ckpt_dir)
    stripped = _prefixed(tensors, "bert.")
    cls_w = stripped["classifier.weight"]
    if cls_w.shape[0] != 1:
        raise ValueError(f"cross-encoder classifier must have 1 logit, got {tuple(cls_w.shape)}")
    params = load_hf_bert(cfg, ckpt_dir, _tensors=tensors, device=device)
    dt = cfg.compute_dtype
    head = {
        "w_pool": _transposed(stripped["pooler.dense.weight"], dt, device),
        "b_pool": _owned(stripped["pooler.dense.bias"], dt, device),
        "w": _transposed(cls_w, dt, device),
        "b": _owned(stripped["classifier.bias"], dt, device),
    }
    _release(tensors)
    return params, head


# -- the reference's param trees, from numpy -----------------------------------


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


def _tree_from_numpy(tree, shapes, device, what: str):
    if isinstance(shapes, list):  # a list of subtrees (wav2vec2's conv layers)
        if len(tree) != len(shapes):
            raise ValueError(f"{what} tree has {len(tree)} entries; the config says {len(shapes)}")
        return [_tree_from_numpy(t, s, device, what) for t, s in zip(tree, shapes)]
    out = {}
    for name, shape in shapes.items():
        if isinstance(shape, (dict, list)):
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


def vit_params_from_numpy(tree, cfg, device) -> dict:
    """The reference's ViT param tree with numpy leaves, as tensors (the
    same names, shapes and values)."""
    from generativeaiexamples_tpu_torch.models.vision import vit_param_shapes

    return _tree_from_numpy(tree, vit_param_shapes(cfg), device, "vit param")


def vlm_params_from_numpy(tree, cfg, device) -> dict:
    """The reference's VLM tree (``vit``, ``projector``, ``lm``) with numpy
    leaves: the ViT through :func:`vit_params_from_numpy`, the LM through
    :func:`params_from_numpy`."""
    proj = _tensor(tree["projector"], device)
    if tuple(proj.shape) != (cfg.vit.d_model, cfg.lm.d_model):
        raise ValueError(f"projector has shape {tuple(proj.shape)}; the config says {(cfg.vit.d_model, cfg.lm.d_model)}")
    return {"vit": vit_params_from_numpy(tree["vit"], cfg.vit, device), "projector": proj,
            "lm": params_from_numpy(tree["lm"], cfg.lm, device)}


def speech_params_from_numpy(tree, shapes: dict, device, what: str = "speech param") -> dict:
    """A reference speech tree (ASR, TTS or wav2vec2) with numpy leaves, as
    tensors; ``shapes`` is the port's ``models.speech.*_param_shapes(cfg)``."""
    return _tree_from_numpy(tree, shapes, device, what)


# -- training state ----------------------------------------------------------------


def _arrays_from_numpy(tree, device):
    """A nested dict / list of numpy arrays as the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: _arrays_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_arrays_from_numpy(v, device) for v in tree]
    return _tensor(tree, device)


def lora_params_from_numpy(tree, device) -> dict:
    """The reference's adapter tree (``{name: {"a", "b"}}``, numpy leaves)
    as tensors."""
    return {name: {ab: _tensor(mat, device) for ab, mat in d.items()} for name, d in tree.items()}


def adam_state_from_numpy(opt_state, device):
    """The reference's ``optax.adam`` / ``optax.adamw`` state with numpy
    leaves (``jax.tree.map(np.asarray, opt_state)``: a chain whose
    ``ScaleByAdamState`` holds ``count``, ``mu`` and ``nu``) as the port's
    :class:`~generativeaiexamples_tpu_torch.engine.training.AdamState`."""
    from generativeaiexamples_tpu_torch.engine.training import AdamState

    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    adam = next(p for p in parts if hasattr(p, "mu") and hasattr(p, "nu"))
    return AdamState(count=int(np.asarray(adam.count)), mu=_arrays_from_numpy(adam.mu, device),
                     nu=_arrays_from_numpy(adam.nu, device))


def train_state_from_numpy(state, params, device):
    """A reference ``TrainState`` with numpy leaves as the port's, over
    ``params`` (its params tree already carried: :func:`params_from_numpy`,
    :func:`bert_params_from_numpy`, :func:`lora_params_from_numpy`)."""
    from generativeaiexamples_tpu_torch.engine.training import TrainState

    return TrainState(params=params, opt_state=adam_state_from_numpy(state.opt_state, device),
                      step=int(np.asarray(state.step)))


def bert_train_state_from_numpy(state, cfg, device):
    """The reference's embedder fine-tuning state (``init_bert_train_state``
    and its steps) with numpy leaves, as the port's."""
    return train_state_from_numpy(state, bert_params_from_numpy(state.params, cfg, device), device)


# -- HF ViT and wav2vec2 checkpoints -------------------------------------------


def vit_config_from_hf(ckpt_dir: str, **overrides):
    """A ViTConfig from a HF checkpoint's ``config.json``."""
    from generativeaiexamples_tpu_torch.models import vision

    with open(os.path.join(ckpt_dir, "config.json"), encoding="utf-8") as fh:
        c = json.load(fh)
    kw = dict(
        image_size=c["image_size"],
        patch_size=c["patch_size"],
        d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        d_ff=c["intermediate_size"],
        norm_eps=c.get("layer_norm_eps", 1e-6),
    )
    kw.update(overrides)
    return vision.ViTConfig(**kw)


def load_hf_vit(cfg, ckpt_dir: str, *, device=None) -> dict:
    """Convert a HF ``ViTModel`` checkpoint (or a ``vit.``-prefixed task
    model) into the port's ViT tree, in ``cfg.compute_dtype`` on ``device``.

    The conv patch embedding (D, C, p, p) becomes the (patch_dim, D) matmul
    weight in ``vision.patchify``'s (patch row, patch column, channel)
    order; query, key and value fuse on the output axis into ``wqkv``."""
    from generativeaiexamples_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    tensors = _load_safetensors_dir(ckpt_dir)
    stripped = _prefixed(tensors, "vit.")
    dt = cfg.compute_dtype

    def t(name: str) -> torch.Tensor:
        return _owned(stripped[name], dt, device)

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        return _stack_layers(stripped, fmt, cfg.n_layers, dt, device, transpose)

    att = "encoder.layer.{}.attention.attention."
    wqkv = torch.empty((cfg.n_layers, cfg.d_model, 3 * cfg.d_model), dtype=dt, device=device)
    bqkv = torch.empty((cfg.n_layers, 3 * cfg.d_model), dtype=dt, device=device)
    for i in range(cfg.n_layers):
        for j, w in enumerate(("query", "key", "value")):
            cols = slice(j * cfg.d_model, (j + 1) * cfg.d_model)
            wqkv[i, :, cols] = stripped[(att + w + ".weight").format(i)].to(device).T
            bqkv[i, cols] = stripped[(att + w + ".bias").format(i)].to(device)
        _release(tensors)
    conv = stripped["embeddings.patch_embeddings.projection.weight"].to(device)  # (D, C, p, p)
    lay = "encoder.layer.{}."
    params = {
        "patch_proj": conv.permute(2, 3, 1, 0).reshape(cfg.patch_dim, cfg.d_model).to(dt).contiguous(),
        "patch_bias": t("embeddings.patch_embeddings.projection.bias"),
        "pos_embed": t("embeddings.position_embeddings")[0],
        "cls": t("embeddings.cls_token"),
        "layers": {
            "ln1_g": stack(lay + "layernorm_before.weight", False),
            "ln1_b": stack(lay + "layernorm_before.bias", False),
            "wqkv": wqkv,
            "bqkv": bqkv,
            "wo": stack(lay + "attention.output.dense.weight", True),
            "bo": stack(lay + "attention.output.dense.bias", False),
            "ln2_g": stack(lay + "layernorm_after.weight", False),
            "ln2_b": stack(lay + "layernorm_after.bias", False),
            "w1": stack(lay + "intermediate.dense.weight", True),
            "b1": stack(lay + "intermediate.dense.bias", False),
            "w2": stack(lay + "output.dense.weight", True),
            "b2": stack(lay + "output.dense.bias", False),
        },
        "final_ln_g": t("layernorm.weight"),
        "final_ln_b": t("layernorm.bias"),
    }
    _release(tensors)
    logger.info("loaded %d HF ViT tensors from %s", len(tensors), ckpt_dir)
    return params


def w2v2_config_from_hf(ckpt_dir: str, **overrides):
    """A Wav2Vec2Config from a HF checkpoint's ``config.json`` (geometry
    from the checkpoint, so custom-vocab CTC fine-tunes load with the right
    head).  Refuses non-wav2vec2 and layer-norm-variant checkpoints, as the
    reference does: the converter maps the group-norm family only."""
    import dataclasses

    from generativeaiexamples_tpu_torch.models import speech

    with open(os.path.join(ckpt_dir, "config.json"), encoding="utf-8") as fh:
        hf = json.load(fh)
    if hf.get("model_type", "wav2vec2") != "wav2vec2":
        raise ValueError(f"checkpoint is model_type={hf.get('model_type')!r}, not wav2vec2")
    if hf.get("do_stable_layer_norm", False):
        raise ValueError(
            "layer-norm wav2vec2 variant (do_stable_layer_norm=True) is not supported; use a "
            "wav2vec2-base-960h-class checkpoint"
        )
    cfg = speech.Wav2Vec2Config(
        vocab_size=hf.get("vocab_size", 32),
        d_model=hf.get("hidden_size", 768),
        n_layers=hf.get("num_hidden_layers", 12),
        n_heads=hf.get("num_attention_heads", 12),
        d_ff=hf.get("intermediate_size", 3072),
        conv_dim=tuple(hf.get("conv_dim", (512,) * 7)),
        conv_kernel=tuple(hf.get("conv_kernel", (10, 3, 3, 3, 3, 2, 2))),
        conv_stride=tuple(hf.get("conv_stride", (5, 2, 2, 2, 2, 2, 2))),
        pos_conv_kernel=hf.get("num_conv_pos_embeddings", 128),
        pos_conv_groups=hf.get("num_conv_pos_embedding_groups", 16),
        norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
    )
    return dataclasses.replace(cfg, **overrides)


def load_hf_wav2vec2(cfg, ckpt_dir: str, *, device=None) -> dict:
    """Convert a HF ``Wav2Vec2ForCTC`` checkpoint (wav2vec2-base-960h
    class: group-norm feature extractor, post-LN encoder) into the port's
    wav2vec2 tree, in ``cfg.compute_dtype`` on ``device``.

    Conv kernels move from HF's (out, in, k) to the tree's (k, in, out).
    The positional conv is weight-normalized (``weight_g`` / ``weight_v``,
    or ``parametrizations.weight.original0/1``): the effective weight
    ``g * v / ||v||`` (one norm per kernel position, in f64) is built here.
    The layer-norm variant and a geometry other than the config's raise,
    as in the reference."""
    from generativeaiexamples_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    tensors = _load_safetensors_dir(ckpt_dir)
    fe = "wav2vec2.feature_extractor.conv_layers."
    if fe + "1.layer_norm.weight" in tensors or fe + "0.conv.bias" in tensors:
        raise ValueError(
            "checkpoint is the layer-norm wav2vec2 variant (do_stable_layer_norm=True); only the group-norm "
            "variant (wav2vec2-base-960h class) is supported"
        )
    n_enc = len({k.split(".")[3] for k in tensors if k.startswith("wav2vec2.encoder.layers.")})
    n_conv = len({k.split(".")[3] for k in tensors if k.startswith(fe)})
    if n_enc != cfg.n_layers or n_conv != len(cfg.conv_dim):
        raise ValueError(
            f"checkpoint geometry ({n_conv} conv / {n_enc} encoder layers) does not match config "
            f"({len(cfg.conv_dim)} conv / {cfg.n_layers} encoder layers)"
        )
    dt = cfg.compute_dtype

    def t(name: str) -> torch.Tensor:
        return _owned(tensors[f"wav2vec2.{name}"], dt, device)

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        return _stack_layers(tensors, "wav2vec2." + fmt, cfg.n_layers, dt, device, transpose)

    convs = []
    for i in range(len(cfg.conv_dim)):
        leaf = {"w": tensors[f"{fe}{i}.conv.weight"].to(device).permute(2, 1, 0).to(dt).contiguous()}
        if i == 0:
            leaf["gn_g"] = t("feature_extractor.conv_layers.0.layer_norm.weight")
            leaf["gn_b"] = t("feature_extractor.conv_layers.0.layer_norm.bias")
        convs.append(leaf)
    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in tensors:
        g, v = tensors[f"{pc}.weight_g"], tensors[f"{pc}.weight_v"]
    else:
        g, v = tensors[f"{pc}.parametrizations.weight.original0"], tensors[f"{pc}.parametrizations.weight.original1"]
    v64 = v.to(device=device, dtype=torch.float64)
    norm = v64.pow(2).sum(dim=tuple(d for d in range(v64.ndim) if d != 2), keepdim=True).sqrt()
    pos_w = ((g.to(device).float() * v.to(device).float()).double() / norm.clamp_min(1e-12)).float()
    enc = "encoder.layers.{}."
    params = {
        "conv_layers": convs,
        "fp_norm_g": t("feature_projection.layer_norm.weight"),
        "fp_norm_b": t("feature_projection.layer_norm.bias"),
        "fp_w": _transposed(tensors["wav2vec2.feature_projection.projection.weight"], dt, device),
        "fp_b": t("feature_projection.projection.bias"),
        "pos_conv_w": pos_w.permute(2, 1, 0).to(dt).contiguous(),
        "pos_conv_b": _owned(tensors[f"{pc}.bias"], dt, device),
        "enc_norm_g": t("encoder.layer_norm.weight"),
        "enc_norm_b": t("encoder.layer_norm.bias"),
        "layers": {
            "wq": stack(enc + "attention.q_proj.weight"),
            "bq": stack(enc + "attention.q_proj.bias", False),
            "wk": stack(enc + "attention.k_proj.weight"),
            "bk": stack(enc + "attention.k_proj.bias", False),
            "wv": stack(enc + "attention.v_proj.weight"),
            "bv": stack(enc + "attention.v_proj.bias", False),
            "wo": stack(enc + "attention.out_proj.weight"),
            "bo": stack(enc + "attention.out_proj.bias", False),
            "ln1_g": stack(enc + "layer_norm.weight", False),
            "ln1_b": stack(enc + "layer_norm.bias", False),
            "ff_in_w": stack(enc + "feed_forward.intermediate_dense.weight"),
            "ff_in_b": stack(enc + "feed_forward.intermediate_dense.bias", False),
            "ff_out_w": stack(enc + "feed_forward.output_dense.weight"),
            "ff_out_b": stack(enc + "feed_forward.output_dense.bias", False),
            "ln2_g": stack(enc + "final_layer_norm.weight", False),
            "ln2_b": stack(enc + "final_layer_norm.bias", False),
        },
        "lm_head_w": _transposed(tensors["lm_head.weight"], dt, device),
        "lm_head_b": _owned(tensors["lm_head.bias"], dt, device),
    }
    _release(tensors)
    logger.info("loaded %d HF wav2vec2 tensors from %s", len(tensors), ckpt_dir)
    return params


# -- one rank's shard of a mesh-sharded tree -----------------------------------


def _owned_slice(x, index, device) -> torch.Tensor:
    """``x[index]`` (numpy, ml_dtypes bf16 included, or torch) as a tensor
    of its own on ``device``: a slice never keeps the whole leaf alive."""
    if isinstance(x, torch.Tensor):
        return x[index].to(device).clone()
    return _tensor(np.asarray(x)[index], device)


def _scale_spec(q_shape, scale_shape, spec) -> tuple:
    """A quantized leaf's scale spec: q's, with None wherever the scale has
    size 1 (it broadcasts there), as the reference's ``_quant_spec``."""
    parts = tuple(spec) + (None,) * (len(q_shape) - len(tuple(spec)))
    return tuple(None if dim == 1 else part for dim, part in zip(scale_shape, parts[-len(scale_shape):]))


def shard_params(tree, cfg, sizes, coords, device) -> dict:
    """This rank's slice of every leaf of a llama param tree under the
    default sharding rules (``models.llama.partition_specs``): the block
    ``jax.sharding.NamedSharding`` places on the device at mesh position
    ``coords`` of a mesh of ``sizes``.  Leaves may be numpy (a carried JAX
    tree, ``QuantizedMatrix`` with ``q`` / ``scale`` attributes) or the
    port's tensors; ``QuantizedMatrix`` scales shard as q does except
    along their size-1 axes.  The blocked W8A8 layout is single-device
    only (the reference never blocks on a mesh), so it is refused.  An
    int8 head is held in the compute dtype (:func:`head_for_logits`)."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel.mesh import shard_slices

    specs = llama.partition_specs(cfg)

    def leaf(x, spec):
        if isinstance(x, BlockedQuantizedMatrix) or hasattr(x, "tiles"):
            raise ValueError("the blocked W8A8 layout is single-device; a mesh serves weight-only int8")
        if hasattr(x, "q") and hasattr(x, "scale"):
            q_shape, s_shape = tuple(np.shape(x.q)), tuple(np.shape(x.scale))
            return QuantizedMatrix(
                q=_owned_slice(x.q, shard_slices(q_shape, spec, sizes, coords), device),
                scale=_owned_slice(x.scale, shard_slices(s_shape, _scale_spec(q_shape, s_shape, spec), sizes,
                                                         coords), device),
            )
        return _owned_slice(x, shard_slices(tuple(np.shape(x)), spec, sizes, coords), device)

    for packed in ("wqkv", "w_gu"):
        if packed in tree["layers"]:
            raise ValueError(f"a packed {packed!r} leaf crosses the head shards: shard the unpacked tree")
    out = {k: leaf(v, specs[k]) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: leaf(v, specs["layers"][k]) for k, v in tree["layers"].items()}
    return head_for_logits(out, cfg)


# -- the port's checkpoint format (one device or a mesh) ------------------------
#
# It replaces the reference's orbax checkpoints (``save_orbax``,
# ``load_orbax``, ``load_orbax_sharded``), a JAX format neither machine can
# read without tensorstore.  A checkpoint is a directory: ``index.json``
# (each leaf's tree path, whole shape, dtype and file, the step and Adam's
# count) and one ``.npy`` a leaf (bfloat16 stored as its uint16 bits).
# Over a mesh the controller writes the headers, each rank writes only its
# slice into the memory maps (a replicated slice by one rank) and reads
# only its slice back, so a state saved on one mesh shape loads onto
# another or onto one device, and the reverse.

CHECKPOINT_FORMAT = "generativeaiexamples-torch-checkpoint/1"
# Bytes of leaf data this process wrote and read (a rank reads only its
# slices: the tests and ``chip_smoke.py`` read these).
CHECKPOINT_STATS = {"written_bytes": 0, "read_bytes": 0}


def _npy_dtype(name: str):
    return np.dtype("<u2") if name == "bfloat16" else np.dtype(name)


def _leaf_file(path: str) -> str:
    return path.replace("/", ".") + ".npy"


def create_checkpoint(path: str, leaves: dict, *, step: int = 0, count: int = 0) -> None:
    """A checkpoint's index and the ``.npy`` header of every leaf, its data
    still to be written (``leaves``: tree path -> (whole shape, dtype
    name))."""
    os.makedirs(path, exist_ok=True)
    index = {"format": CHECKPOINT_FORMAT, "step": int(step), "count": int(count), "leaves": {}}
    for name, (shape, dtype) in leaves.items():
        f = _leaf_file(name)
        np.lib.format.open_memmap(os.path.join(path, f), mode="w+", dtype=_npy_dtype(dtype),
                                  shape=tuple(shape)).flush()
        index["leaves"][name] = {"shape": list(shape), "dtype": dtype, "file": f}
    with open(os.path.join(path, "index.json"), "w") as fh:
        json.dump(index, fh, indent=1)


def _read_index(path: str) -> dict:
    with open(os.path.join(path, "index.json")) as fh:
        index = json.load(fh)
    if index.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this format ({index.get('format')!r})")
    return index


def _host_bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().contiguous().cpu()
    return x.view(torch.uint16).numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _writer(spec, sizes, coords) -> bool:
    """Whether this rank writes its slice of a leaf: the one rank at
    coordinate 0 of every populated axis the leaf is replicated over."""
    return all(coords[a] == 0 for a, n in sizes.items() if n > 1 and a not in tuple(spec))


def _data_offset(path: str) -> int:
    """Where a ``.npy`` file's array data starts."""
    with open(path, "rb") as fh:
        version = np.lib.format.read_magic(fh)
        if version == (1, 0):
            np.lib.format.read_array_header_1_0(fh)
        else:
            np.lib.format.read_array_header_2_0(fh)
        return fh.tell()


def _runs(shape, index) -> tuple[np.ndarray, int]:
    """The contiguous runs of the block ``index`` (a slice a dimension) of
    a C-order array of ``shape``: each run's offset in elements, in the
    block's own order, and the run's length."""
    shape = tuple(shape)
    index = tuple(index) + (slice(None),) * (len(shape) - len(tuple(index)))
    bounds = [sl.indices(n)[:2] for sl, n in zip(index, shape)]
    k = len(shape) - 1
    while k >= 0 and bounds[k] == (0, shape[k]):
        k -= 1
    if k < 0:
        return np.zeros(1, np.int64), int(np.prod(shape, dtype=np.int64))
    strides = np.cumprod((1,) + shape[::-1][:-1])[::-1].astype(np.int64)
    run = (bounds[k][1] - bounds[k][0]) * int(strides[k])
    offsets = np.asarray(bounds[k][0] * strides[k], np.int64)
    for d in range(k - 1, -1, -1):
        offsets = (np.arange(*bounds[d], dtype=np.int64)[:, None] * strides[d] + offsets.reshape(1, -1)).reshape(-1)
    return offsets.reshape(-1), run


# Leaves a process writes or reads at once: ``pwrite`` / ``preadv`` and the
# copies to and from the card release the GIL, and a tmpfs page cache
# takes new pages faster from several threads than from one.
CHECKPOINT_IO_THREADS = 4


def _each_leaf(fn, jobs: list) -> list:
    """``fn(job)`` for every job on CHECKPOINT_IO_THREADS threads, in
    order."""
    from concurrent.futures import ThreadPoolExecutor

    if len(jobs) <= 1:
        return [fn(j) for j in jobs]
    with ThreadPoolExecutor(min(CHECKPOINT_IO_THREADS, len(jobs))) as pool:
        return list(pool.map(fn, jobs))


def write_checkpoint_shard(path: str, trees: dict, specs, sizes, coords) -> int:
    """Write this rank's slice of every leaf of ``trees`` (name -> a tree
    like ``specs``) into a checkpoint whose headers exist, one ``pwrite``
    a contiguous run of the slice; returns the bytes written."""
    from generativeaiexamples_tpu_torch.parallel.mesh import shard_slices
    from generativeaiexamples_tpu_torch.utils.trees import flatten

    index = _read_index(path)["leaves"]
    spec_of = dict(flatten(specs))
    jobs = [(index[f"{name}/{leaf_path}"], spec_of[leaf_path], x) for name, tree in trees.items()
            for leaf_path, x in flatten(tree) if _writer(spec_of[leaf_path], sizes, coords)]

    def write(job) -> int:
        meta, spec, x = job
        file = os.path.join(path, meta["file"])
        offsets, run = _runs(meta["shape"], shard_slices(tuple(meta["shape"]), spec, sizes, coords))
        data = memoryview(_host_bits(x).reshape(-1)).cast("B")
        item, start = x.element_size(), _data_offset(file)
        fd = os.open(file, os.O_WRONLY)
        try:
            for i, off in enumerate(offsets.tolist()):
                os.pwrite(fd, data[i * run * item : (i + 1) * run * item], start + off * item)
        finally:
            os.close(fd)
        return x.numel() * item

    written = sum(_each_leaf(write, jobs))
    CHECKPOINT_STATS["written_bytes"] += written
    return written


def read_checkpoint_shard(path: str, sizes, coords, device, specs_of, trees=None) -> dict:
    """This rank's slice of every leaf of a checkpoint, as tensors on
    ``device``: ``{"params", "mu", "nu"}`` (the trees it holds, or those
    named in ``trees``), ``"step"`` and ``"count"``.  ``specs_of(params)``
    gives the spec tree from the params tree of the leaves' headers (an
    array of the leaf's shape a leaf, its data not read).  Only the
    slices' bytes are read, one ``preadv`` a contiguous run."""
    from generativeaiexamples_tpu_torch.parallel.mesh import shard_slices
    from generativeaiexamples_tpu_torch.utils.trees import flatten, unflatten

    index = _read_index(path)
    metas: dict = {}
    for name, meta in index["leaves"].items():
        tree, leaf_path = name.split("/", 1)
        metas.setdefault(tree, []).append((leaf_path, meta))
    shapes = unflatten([(p, np.broadcast_to(np.zeros((), np.uint8), tuple(m["shape"]))) for p, m in metas["params"]])
    spec_of = dict(flatten(specs_of(shapes)))

    def read(job) -> torch.Tensor:
        leaf_path, meta = job
        block = shard_slices(tuple(meta["shape"]), spec_of[leaf_path], sizes, coords)
        offsets, run = _runs(meta["shape"], block)
        dt = _npy_dtype(meta["dtype"])
        part = np.empty(len(offsets) * run, dt)
        file = os.path.join(path, meta["file"])
        start, raw = _data_offset(file), memoryview(part).cast("B")
        fd = os.open(file, os.O_RDONLY)
        try:
            for i, off in enumerate(offsets.tolist()):
                chunk = raw[i * run * dt.itemsize : (i + 1) * run * dt.itemsize]
                if os.preadv(fd, [chunk], start + off * dt.itemsize) != len(chunk):
                    raise ValueError(f"{file} is shorter than its header says")
        finally:
            os.close(fd)
        shape = tuple(sl.indices(n)[1] - sl.indices(n)[0] for sl, n in
                      zip(tuple(block) + (slice(None),) * (len(meta["shape"]) - len(tuple(block))), meta["shape"]))
        t = torch.from_numpy(part.reshape(shape))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)

    out = {"step": index["step"], "count": index["count"]}
    for tree, items in metas.items():
        if trees is not None and tree not in trees:
            continue
        leaves = _each_leaf(read, items)
        CHECKPOINT_STATS["read_bytes"] += sum(t.numel() * t.element_size() for t in leaves)
        out[tree] = unflatten([(p, t) for (p, _), t in zip(items, leaves)])
    return out


def save_checkpoint(trees: dict, path: str, *, step: int = 0, count: int = 0) -> None:
    """Save whole trees (name -> a dict tree of tensors: ``{"params": ...}``,
    or a train state's ``params``, ``mu`` and ``nu``) from one device."""
    from generativeaiexamples_tpu_torch.utils.trees import flatten, unflatten

    leaves = {f"{name}/{p}": (list(x.shape), str(x.dtype).replace("torch.", ""))
              for name, tree in trees.items() for p, x in flatten(tree)}
    create_checkpoint(path, leaves, step=step, count=count)
    for name, tree in trees.items():
        write_checkpoint_shard(path, {name: tree}, unflatten((p, ()) for p, _ in flatten(tree)), {}, {})


def load_checkpoint(path: str, *, device=None) -> dict:
    """A checkpoint's whole trees on one device (``device`` defaults to the
    card): ``{"params", ...trees, "step", "count"}``."""
    from generativeaiexamples_tpu_torch.core.device import resolve_device
    from generativeaiexamples_tpu_torch.utils.trees import flatten, unflatten

    return read_checkpoint_shard(path, {}, {}, resolve_device(device),
                                 lambda params: unflatten((p, ()) for p, _ in flatten(params)))


def load_checkpoint_shard(cfg, path: str, sizes, coords, device, rules=None) -> dict:
    """One rank's slice of a llama checkpoint's params under ``rules``
    (default: the serving rules), as :func:`shard_params` would slice the
    whole tree: only the slice is read.  An int8 head is held in the
    compute dtype."""
    from generativeaiexamples_tpu_torch.models import llama

    specs = llama.partition_specs(cfg, rules)
    return head_for_logits(read_checkpoint_shard(path, sizes, coords, device, lambda _: specs, ("params",))["params"],
                           cfg)


def load_checkpoint_sharded(cfg, path: str, mesh, rules=None, key: str = "params") -> str:
    """Restore a llama checkpoint straight onto a mesh (the port of
    ``load_orbax_sharded``): each rank reads only its slice under
    ``rules`` (default: the serving rules) and keeps it in its context's
    ``state[key]``; no process holds the whole tree.  Returns ``key``."""
    mesh.run(_load_params_shard, cfg, path, rules, key)
    return key


def _load_params_shard(ctx, cfg, path, rules, key):
    ctx.state[key] = load_checkpoint_shard(cfg, path, ctx.sizes, ctx.coords, ctx.device, rules)
