"""BERT-architecture text encoder (arctic-embed-l class) in PyTorch (port
of ``models/bert.py``).

The embedder (``engine.embedder``) and the cross-encoder reranker
(``engine.reranker``) run on it.  Params are a plain dict of tensors with
the reference's leaf names and shapes: per-layer leaves are stacked on a
leading ``n_layers`` axis (``params["layers"]``), so the reference's param
trees convert leaf by leaf (``engine.weights.bert_params_from_numpy``) and
the layer loop takes views.

The arithmetic is the reference's, not the fastest: LayerNorm in f32 cast
back, q/k/v upcast to f32 for the scores, the softmax and P·V, padded keys
biased by -1e30 (not -inf), exact GELU, pooling normalised in f32, and the
rerank head in f32.  No kernel of the port's ``csrc/`` runs here: the
reference computes BERT in plain XLA (einsums and a softmax), so the port
computes it in plain PyTorch, with cuBLAS products on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

Params = Any  # dict of tensors

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    max_positions: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    pooling: str = "cls"  # "cls" | "mean"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def arctic_embed_l(**overrides) -> BertConfig:
    """snowflake/arctic-embed-l geometry (BERT-large, CLS pooling)."""
    return dataclasses.replace(BertConfig(), **overrides)


def bert_tiny(**overrides) -> BertConfig:
    """Tiny geometry for CPU tests."""
    return dataclasses.replace(
        BertConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_positions=128),
        **overrides,
    )


PRESETS = {"arctic-embed-l": arctic_embed_l, "bert-tiny": bert_tiny}


def param_axes(cfg: BertConfig) -> dict:
    """Every parameter as ``(shape, logical axes)`` (the reference's
    ``param_axes``; ``parallel.mesh`` maps the logical axes to mesh
    axes)."""
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    HD = cfg.n_heads * cfg.head_dim
    return {
        "tok_embed": ((V, D), ("vocab", "embed")),
        "pos_embed": ((cfg.max_positions, D), (None, "embed")),
        "type_embed": ((cfg.type_vocab_size, D), (None, "embed")),
        "embed_norm_g": ((D,), ("embed",)),
        "embed_norm_b": ((D,), ("embed",)),
        "layers": {
            "wq": ((L, D, HD), ("layers", "embed", "heads")),
            "bq": ((L, HD), ("layers", "heads")),
            "wk": ((L, D, HD), ("layers", "embed", "heads")),
            "bk": ((L, HD), ("layers", "heads")),
            "wv": ((L, D, HD), ("layers", "embed", "heads")),
            "bv": ((L, HD), ("layers", "heads")),
            "wo": ((L, HD, D), ("layers", "heads", "embed")),
            "bo": ((L, D), ("layers", "embed")),
            "attn_norm_g": ((L, D), ("layers", "embed")),
            "attn_norm_b": ((L, D), ("layers", "embed")),
            "w_up": ((L, D, F_), ("layers", "embed", "mlp")),
            "b_up": ((L, F_), ("layers", "mlp")),
            "w_down": ((L, F_, D), ("layers", "mlp", "embed")),
            "b_down": ((L, D), ("layers", "embed")),
            "mlp_norm_g": ((L, D), ("layers", "embed")),
            "mlp_norm_b": ((L, D), ("layers", "embed")),
        },
    }


def param_shapes(cfg: BertConfig) -> dict:
    """Leaf names and shapes, those of the reference's ``param_axes``."""
    axes = param_axes(cfg)
    out = {k: a[0] for k, a in axes.items() if k != "layers"}
    out["layers"] = {k: a[0] for k, a in axes["layers"].items()}
    return out


def partition_specs(cfg: BertConfig, rules=None) -> dict:
    """Each parameter's partition spec (a tuple of mesh axes or None per
    dimension, ``parallel.mesh.logical_to_partition``), in
    :func:`init_params`' tree."""
    from generativeaiexamples_tpu_torch.parallel.mesh import logical_to_partition

    axes = param_axes(cfg)
    out = {k: logical_to_partition(a[1], rules) for k, a in axes.items() if k != "layers"}
    out["layers"] = {k: logical_to_partition(a[1], rules) for k, a in axes["layers"].items()}
    return out


_NORM_GAINS = ("embed_norm_g", "attn_norm_g", "mlp_norm_g")
_NORM_BIASES = ("embed_norm_b", "attn_norm_b", "mlp_norm_b")


def init_params(cfg: BertConfig, generator: torch.Generator, device) -> Params:
    """Random-normal leaves (0.02 std), LayerNorm gains 1 and biases 0, as
    the reference initializes (the other biases are random too)."""

    def leaf(name, shape):
        if name in _NORM_GAINS:
            return torch.ones(shape, dtype=cfg.compute_dtype, device=device)
        if name in _NORM_BIASES:
            return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(cfg.compute_dtype)

    shapes = param_shapes(cfg)
    params = {k: leaf(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: leaf(k, s) for k, s in shapes["layers"].items()}
    return params


def layer_norm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with its statistics and affine in f32, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * gain + bias).to(x.dtype)


def encode(
    params: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bidirectional transformer encoder (post-LN BERT).

    Args:
      tokens: (b, s) integer ids.
      attention_mask: (b, s): 1 for real tokens, 0 for padding.
      token_type_ids: (b, s) BERT segment ids; None = all segment 0.

    Returns:
      (b, s, d_model) hidden states in the compute dtype.
    """
    b, s = tokens.shape
    if token_type_ids is None:
        type_vec = params["type_embed"][0][None, None, :]
    else:
        type_vec = params["type_embed"][token_type_ids.long()]
    x = (params["tok_embed"][tokens.long()] + params["pos_embed"][None, :s] + type_vec).to(cfg.compute_dtype)
    x = layer_norm(x, params["embed_norm_g"], params["embed_norm_b"], cfg.norm_eps)

    mask_bias = torch.zeros(attention_mask.shape, dtype=torch.float32, device=x.device)
    mask_bias = mask_bias.masked_fill(~attention_mask.bool(), -1e30)[:, None, None, :]
    scale = cfg.head_dim ** -0.5
    heads = (b, s, cfg.n_heads, cfg.head_dim)
    lps = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in lps.items()}
        q = (x @ lp["wq"] + lp["bq"]).reshape(heads).float()
        k = (x @ lp["wk"] + lp["bk"]).reshape(heads).float()
        v = (x @ lp["wv"] + lp["bv"]).reshape(heads).float()
        scores = torch.einsum("bsnh,btnh->bnst", q, k) * scale + mask_bias
        weights = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bnst,btnh->bsnh", weights, v)
        attn = attn.reshape(b, s, cfg.n_heads * cfg.head_dim).to(x.dtype)
        x1 = layer_norm(x + (attn @ lp["wo"] + lp["bo"]), lp["attn_norm_g"], lp["attn_norm_b"], cfg.norm_eps)
        ff = F.gelu(x1 @ lp["w_up"] + lp["b_up"], approximate="none")
        x = layer_norm(x1 + (ff @ lp["w_down"] + lp["b_down"]), lp["mlp_norm_g"], lp["mlp_norm_b"], cfg.norm_eps)
    return x


def pool(hidden: torch.Tensor, attention_mask: torch.Tensor, method: str, normalize: bool = True) -> torch.Tensor:
    """(b, s, d) -> (b, d) f32 sentence embeddings."""
    if method == "cls":
        emb = hidden[:, 0]
    elif method == "mean":
        m = attention_mask[..., None].to(hidden.dtype)
        emb = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-6)
    else:
        raise ValueError(f"unknown pooling {method!r}")
    emb = emb.float()
    if normalize:
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
    return emb


def embed(
    params: Params, cfg: BertConfig, tokens: torch.Tensor, attention_mask: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """Tokens -> unit-norm sentence embeddings (b, d) f32."""
    return pool(encode(params, cfg, tokens, attention_mask), attention_mask, cfg.pooling, normalize)


# ---------------------------------------------------------------------------
# Cross-encoder rerank head


def rerank_head_shapes(cfg: BertConfig) -> dict:
    return {"w_pool": (cfg.d_model, cfg.d_model), "b_pool": (cfg.d_model,), "w": (cfg.d_model, 1), "b": (1,)}


def init_rerank_head(cfg: BertConfig, generator: torch.Generator, device) -> Params:
    """Pooler and 1-logit classifier: random-normal weights (0.02 std),
    zero biases."""
    dt = cfg.compute_dtype

    def leaf(name, shape):
        if name.startswith("b"):
            return torch.zeros(shape, dtype=dt, device=device)
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device) * 0.02).to(dt)

    return {name: leaf(name, shape) for name, shape in rerank_head_shapes(cfg).items()}


def rerank_score(
    params: Params,
    head: Params,
    cfg: BertConfig,
    tokens: torch.Tensor,
    attention_mask: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Score concatenated (query, passage) token sequences: (b,) f32.

    The HF ``BertForSequenceClassification`` head, in f32: the BERT pooler
    (tanh dense on CLS) then a 1-logit classifier; a head without
    ``w_pool`` is a bare linear on CLS.
    """
    hidden = encode(params, cfg, tokens, attention_mask, token_type_ids)
    cls = hidden[:, 0].float()
    if "w_pool" in head:
        cls = torch.tanh(cls @ head["w_pool"].float() + head["b_pool"].float())
    return (cls @ head["w"].float() + head["b"].float())[:, 0]
