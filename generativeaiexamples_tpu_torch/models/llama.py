"""The Llama family in PyTorch (port of ``models/llama.py``): Llama-3,
and the Mixtral (MoE), Gemma and StarCoder2 branches of the same forward.

Params are a plain dict of tensors, as in the reference: per-layer leaves
are stacked on a leading ``n_layers`` axis (``params["layers"]``), so the
reference's param trees convert leaf by leaf
(``engine.weights.params_from_numpy``) and the layer loop takes views.

:func:`forward` runs cacheless (``cache=None``: scoring, and the oracle of
the tests; attention over the fresh k/v through the flash kernel), or one
of the serving modes of the int8 KV cache, on the contiguous cache or on
the paged pool (``engine.paged_kv``, through a page table):

* cold prefill (``cold_prefill=True``, s > 1): the prompt's K/V are
  quantized into the cache, and attention runs over the fresh K/V through
  the flash kernel (``ops.flash_attention``);
* warm multi-token (chunked or suffix prefill): fresh K/V scatter into the
  cache, and attention reads the quantized window back (plain PyTorch,
  ``ops.attention.gqa_attention``, as the reference leaves it to XLA);
* append-buffer decode (``append_cache``, s == 1): the fresh K/V go to the
  decode chunk's append buffer, and attention reads the cache window plus
  the buffer through the decode kernel (``ops.decode_attention``; the
  paged decode kernel on the pool);
* append-buffer verify (``append_cache``, s > 1, the speculative verify
  pass): the s fresh K/V fill an s-slot buffer, and attention reads the
  whole cache plus the causal buffer (``ops.decode_attention.
  verify_gqa_attention`` or its paged twin, plain PyTorch, as the
  reference leaves it to XLA; the reference reads ``kv_bucket``).

The paged pool takes no cold prefill: the scheduler cold-prefills into a
small contiguous cache and scatters the rows into pages.

The float cache (``kv_dtype`` other than int8: ``(k, v)`` in the compute
dtype, the reference's default) is contiguous only, with the reference's
modes:

* cold prefill: the fresh k/v are written at rows ``[row_offset,
  row_offset + b)``, and attention runs over them through the flash kernel;
* warm multi-token (chunked or suffix prefill): the fresh k/v scatter at
  ``positions``, and attention reads the ``kv_bucket`` window back through
  the flash kernel (``t > s`` at offset positions);
* warm decode (s == 1): the fresh k/v scatter, and attention reads the
  whole cache (``ops.decode_attention.float_cache_attention``, plain
  PyTorch as in the reference; never a bucket of the batch's longest row,
  whose sums would follow the batch);
* verify (``append_cache``, s > 1): the s fresh k/v fill an s-slot float
  buffer, and attention reads the whole cache plus the causal buffer
  (the same plain function).

Projections go through ``ops.quant.q_dot`` by their layout
(``engine.decode.prepare_params``): pre-blocked int8 to the W8A8 kernel
(``ops.qmm``, the ``pallas_w8a8`` route), weight-only int8 or float
(the ``xla`` route); packed (``wqkv``, ``w_gu``) when they carry no bias,
unpacked with their biases added after the product (StarCoder2).  The
MoE router and experts stay float, as in the reference (``_moe_mlp``).
The cache is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from generativeaiexamples_tpu_torch.ops.attention import attention
from generativeaiexamples_tpu_torch.ops.decode_attention import (
    decode_gqa_attention,
    float_cache_attention,
    paged_decode_gqa_attention,
    paged_slots,
    paged_verify_gqa_attention,
    paged_window_index,
    verify_gqa_attention,
)
from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix
from generativeaiexamples_tpu_torch.ops.quant import (
    QuantizedMatrix,
    _validate_q_dot,
    f32_product,
    float_dot,
    int8_max_like,
    q_dot,
)
from generativeaiexamples_tpu_torch.ops.rope import apply_rope

Params = Any  # dict of tensors / QuantizedMatrix / BlockedQuantizedMatrix

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    # KV-cache storage: "int8" (per-token-per-head symmetric bf16 scales),
    # or anything else for the compute dtype (the presets' default, as in
    # the reference).
    kv_dtype: str = "bfloat16"
    # Mixture-of-experts MLP (Mixtral): 0 = dense.  Top-k routing with
    # capacity-dropping one-hot dispatch in groups of up to 128 tokens
    # (_moe_mlp); ``moe_dropless`` sets each expert's capacity to the
    # whole group, so no token is dropped (HF Mixtral's inference
    # semantics; the engine server turns it on).
    n_experts: int = 0
    n_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25
    moe_dropless: bool = False
    # Gemma: the MLP activation ("silu", or "gelu_tanh" as Gemma and
    # StarCoder2 use), embeddings scaled by sqrt(d_model), and RMSNorm by
    # (1 + g) over zero-centred gains.
    hidden_act: str = "silu"
    scale_embeddings: bool = False
    norm_unit_offset: bool = False
    # StarCoder2: "layernorm" (mean-centred, with bias) instead of
    # "rmsnorm", biases on every projection, and an ungated up -> act ->
    # down MLP.
    norm_type: str = "rmsnorm"
    proj_bias: bool = False
    mlp_gated: bool = True
    # Training: with ``forward(..., remat=True)`` each layer runs under
    # gradient checkpointing (its activations recomputed in the backward).
    remat: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def act_fn(self):
        if self.hidden_act == "silu":
            return F.silu
        if self.hidden_act == "gelu_tanh":
            return lambda x: F.gelu(x, approximate="tanh")
        raise ValueError(f"unknown hidden_act {self.hidden_act!r}")


def llama3_8b(**overrides) -> LlamaConfig:
    """meta-llama/Meta-Llama-3-8B(-Instruct) geometry."""
    return dataclasses.replace(LlamaConfig(), **overrides)


def llama3_70b(**overrides) -> LlamaConfig:
    """meta-llama/Meta-Llama-3-70B(-Instruct) geometry."""
    return dataclasses.replace(
        LlamaConfig(d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672),
        **overrides,
    )


def llama32_1b(**overrides) -> LlamaConfig:
    """meta-llama/Llama-3.2-1B(-Instruct) geometry."""
    return dataclasses.replace(
        LlamaConfig(d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192),
        **overrides,
    )


def llama_tiny(**overrides) -> LlamaConfig:
    """Tiny geometry for CPU tests and byte-level serving."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, max_seq_len=512, rope_theta=10000.0,
        ),
        **overrides,
    )


def mixtral_8x7b(**overrides) -> LlamaConfig:
    """mistralai/Mixtral-8x7B geometry: Llama-shaped with 8-expert, top-2
    MoE MLPs, routed droplessly (HF Mixtral's inference semantics)."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
            rope_theta=1e6, n_experts=8, n_experts_per_tok=2, moe_dropless=True,
        ),
        **overrides,
    )


def llama_moe_tiny(**overrides) -> LlamaConfig:
    """Tiny MoE geometry for CPU tests."""
    defaults = {"n_experts": 4, "n_experts_per_tok": 2}
    return dataclasses.replace(llama_tiny(), **{**defaults, **overrides})


_GEMMA_ARCH = {
    "hidden_act": "gelu_tanh",
    "scale_embeddings": True,
    "norm_unit_offset": True,
    "rope_theta": 10000.0,
    "norm_eps": 1e-6,
}


def gemma_2b(**overrides) -> LlamaConfig:
    """google/gemma-2b(-it) geometry: MQA (1 kv head), head_dim 256,
    gelu_tanh MLP, sqrt(d_model)-scaled embeddings, (1 + g) RMSNorm, tied
    LM head."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=256000, d_model=2048, n_layers=18, n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384,
            **_GEMMA_ARCH,
        ),
        **overrides,
    )


def gemma_7b(**overrides) -> LlamaConfig:
    """google/gemma-7b(-it) geometry (the same architecture, 16 / 16 heads)."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=256000, d_model=3072, n_layers=28, n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576,
            **_GEMMA_ARCH,
        ),
        **overrides,
    )


def gemma_tiny(**overrides) -> LlamaConfig:
    """Tiny Gemma-architecture geometry for CPU tests."""
    return gemma_2b(**{
        **dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
               max_seq_len=512),
        **overrides,
    })


_STARCODER2_ARCH = {
    "hidden_act": "gelu_tanh",
    "norm_type": "layernorm",
    "proj_bias": True,
    "mlp_gated": False,
    "norm_eps": 1e-5,
}


def starcoder2_3b(**overrides) -> LlamaConfig:
    """bigcode/starcoder2-3b geometry: LayerNorm with bias, biased
    projections, an ungated c_fc / c_proj MLP, GQA (24 / 2 heads), rope,
    tied LM head.  ``rope_theta`` is the published config's; sliding-window
    attention is a no-op at contexts up to 4096 and is not modelled."""
    return dataclasses.replace(
        LlamaConfig(
            vocab_size=49152, d_model=3072, n_layers=30, n_heads=24, n_kv_heads=2, head_dim=128, d_ff=12288,
            max_seq_len=4096, rope_theta=999999.4342952444, **_STARCODER2_ARCH,
        ),
        **overrides,
    )


def starcoder2_tiny(**overrides) -> LlamaConfig:
    """Tiny StarCoder2-architecture geometry for CPU tests."""
    return starcoder2_3b(**{
        **dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
               max_seq_len=512, rope_theta=10000.0),
        **overrides,
    })


PRESETS = {
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama3.2-1b": llama32_1b,
    "llama-tiny": llama_tiny,
    "mixtral-8x7b": mixtral_8x7b,
    "llama-moe-tiny": llama_moe_tiny,
    "gemma-2b": gemma_2b,
    "gemma-7b": gemma_7b,
    "gemma-tiny": gemma_tiny,
    "starcoder2-3b": starcoder2_3b,
    "starcoder2-tiny": starcoder2_tiny,
}


def param_axes(cfg: LlamaConfig) -> dict:
    """Every parameter as ``(shape, logical axes)``, in :func:`init_params`'
    tree (the reference's ``param_axes``; ``parallel.mesh`` maps the
    logical axes to mesh axes)."""
    L, D, H, KV, HD, FF, V = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
    )
    if cfg.n_experts > 1:
        E = cfg.n_experts
        mlp = {
            "router": ((L, D, E), ("layers", "embed", None)),
            "w_gate_e": ((L, E, D, FF), ("layers", "expert", "embed", "mlp")),
            "w_up_e": ((L, E, D, FF), ("layers", "expert", "embed", "mlp")),
            "w_down_e": ((L, E, FF, D), ("layers", "expert", "mlp", "embed")),
        }
    elif cfg.mlp_gated:
        mlp = {
            "w_gate": ((L, D, FF), ("layers", "embed", "mlp")),
            "w_up": ((L, D, FF), ("layers", "embed", "mlp")),
            "w_down": ((L, FF, D), ("layers", "mlp", "embed")),
        }
    else:  # plain up -> act -> down (StarCoder2's c_fc / c_proj)
        mlp = {
            "w_up": ((L, D, FF), ("layers", "embed", "mlp")),
            "w_down": ((L, FF, D), ("layers", "mlp", "embed")),
        }
    layers = {
        "attn_norm": ((L, D), ("layers", "embed")),
        "wq": ((L, D, H * HD), ("layers", "embed", "heads")),
        "wk": ((L, D, KV * HD), ("layers", "embed", "kv_heads")),
        "wv": ((L, D, KV * HD), ("layers", "embed", "kv_heads")),
        "wo": ((L, H * HD, D), ("layers", "heads", "embed")),
        "mlp_norm": ((L, D), ("layers", "embed")),
        **mlp,
    }
    if cfg.proj_bias:
        layers.update({
            "bq": ((L, H * HD), ("layers", "heads")),
            "bk": ((L, KV * HD), ("layers", "kv_heads")),
            "bv": ((L, KV * HD), ("layers", "kv_heads")),
            "bo": ((L, D), ("layers", "embed")),
            "b_up": ((L, FF), ("layers", "mlp")),
            "b_down": ((L, D), ("layers", "embed")),
        })
        if cfg.mlp_gated and cfg.n_experts <= 1:
            layers["b_gate"] = ((L, FF), ("layers", "mlp"))
    if cfg.norm_type == "layernorm":
        layers["attn_norm_b"] = ((L, D), ("layers", "embed"))
        layers["mlp_norm_b"] = ((L, D), ("layers", "embed"))
    out = {
        "embed": ((V, D), ("vocab", "embed")),
        "layers": layers,
        "final_norm": ((D,), ("embed",)),
        "lm_head": ((D, V), ("embed", "vocab")),
    }
    if cfg.norm_type == "layernorm":
        out["final_norm_b"] = ((D,), ("embed",))
    return out


def param_shapes(cfg: LlamaConfig) -> dict:
    """Every parameter's shape, in :func:`init_params`' tree."""
    axes = param_axes(cfg)
    out = {name: leaf[0] for name, leaf in axes.items() if name != "layers"}
    out["layers"] = {name: leaf[0] for name, leaf in axes["layers"].items()}
    return out


def partition_specs(cfg: LlamaConfig, rules=None) -> dict:
    """Each parameter's partition spec (a tuple of mesh axes or None per
    dimension, ``parallel.mesh.logical_to_partition``), in
    :func:`init_params`' tree."""
    from generativeaiexamples_tpu_torch.parallel.mesh import logical_to_partition

    axes = param_axes(cfg)
    out = {name: logical_to_partition(leaf[1], rules) for name, leaf in axes.items() if name != "layers"}
    out["layers"] = {name: logical_to_partition(leaf[1], rules) for name, leaf in axes["layers"].items()}
    return out


def kv_cache_specs(cfg: LlamaConfig, rules=None) -> tuple:
    """One partition spec per cache leaf, matching :func:`init_kv_cache`."""
    from generativeaiexamples_tpu_torch.parallel.mesh import logical_to_partition

    spec = logical_to_partition(("layers", "kv_heads", "batch", None, "head_dim"), rules)
    if cfg.kv_dtype == "int8":
        scale_spec = logical_to_partition(("layers", "kv_heads", "batch", None), rules)
        return spec, spec, scale_spec, scale_spec
    return spec, spec


def local_config(cfg: LlamaConfig, mesh) -> LlamaConfig:
    """The geometry one rank of ``mesh`` (a ``parallel.runtime.RankContext``)
    holds under the default rules: heads, kv heads, MLP columns and the
    vocabulary over ``tensor`` (experts over ``expert`` stay counted
    globally: the router routes over all of them).  Each must divide."""
    if mesh is None:
        return cfg
    tp = mesh.size("tensor")
    if tp == 1:
        return cfg
    for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{what}={n} not divisible by tensor={tp}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                               d_ff=cfg.d_ff // tp, vocab_size=cfg.vocab_size // tp)


def fsdp_dims(cfg: LlamaConfig) -> dict:
    """Each leaf's dimension that ``parallel.mesh.fsdp_rules`` shards over
    ``fsdp`` (its ``embed`` axis; every llama leaf but the projection
    biases of the heads and MLP columns has one), for the top-level leaves
    and, under ``"layers"``, for one layer's leaf (the stacked axis
    dropped)."""
    axes = param_axes(cfg)
    out = {n: a[1].index("embed") for n, a in axes.items() if n != "layers" and "embed" in a[1]}
    out["layers"] = {n: a[1].index("embed") - 1 for n, a in axes["layers"].items() if "embed" in a[1]}
    return out


def fsdp_sharded(params: Params, cfg: LlamaConfig, mesh) -> bool:
    """Whether ``params`` holds fsdp shards (a tree sharded with
    ``fsdp_rules`` over a mesh whose ``fsdp`` axis is populated): the
    final norm then holds ``d_model / fsdp`` gains."""
    return mesh is not None and mesh.size("fsdp") > 1 and params["final_norm"].shape[-1] != cfg.d_model


def fsdp_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """A leaf's fsdp shards gathered just before use (training: inside the
    rematerialized layer, so the whole weight is never kept for the
    backward; its gradient is reduce-scattered back to the shard)."""
    return mesh.all_gather(x, "fsdp", dim)


def column_input(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The input of a product whose weight's columns are sharded over
    ``axis`` (q/k/v, gate/up, the experts, the vocabulary-sharded head):
    the f op, identity here and the gradient summed over the axis in a
    training graph (``parallel.autograd``)."""
    return x if mesh is None else mesh.copy_to(x, axis)


# Leaves init_params starts at 1 (norm gains) and at 0 (biases).
NORM_GAINS = ("attn_norm", "mlp_norm", "final_norm")
BIASES = ("bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down", "attn_norm_b", "mlp_norm_b", "final_norm_b")


def init_params(cfg: LlamaConfig, generator: torch.Generator, device) -> Params:
    """Random-normal initialization (0.02 std); norm gains at 1, biases
    (projection and norm) at 0."""
    shapes = param_shapes(cfg)

    def leaf(shape, name):
        if name in NORM_GAINS:
            return torch.ones(shape, dtype=cfg.compute_dtype, device=device)
        if name in BIASES:
            return torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(cfg.compute_dtype)

    out = {name: leaf(shape, name) for name, shape in shapes.items() if name != "layers"}
    out["layers"] = {n: leaf(shape, n) for n, shape in shapes["layers"].items()}
    return out


def pack_for_serving(params: Params) -> Params:
    """Fuse ``wq|wk|wv -> wqkv`` and ``w_gate|w_up -> w_gu`` on the output
    axis (tensors or QuantizedMatrix leaves); idempotent.  Biased trees
    (StarCoder2) stay unpacked, as the packed branches add no bias, and
    MoE experts are never packed."""
    layers = dict(params["layers"])
    if "bq" in layers or "wqkv" in layers:
        return params

    def cat(*ms):
        if isinstance(ms[0], QuantizedMatrix):
            return QuantizedMatrix(
                q=torch.cat([m.q for m in ms], dim=-1),
                scale=torch.cat([m.scale for m in ms], dim=-1),
            )
        return torch.cat(ms, dim=-1)

    layers["wqkv"] = cat(layers.pop("wq"), layers.pop("wk"), layers.pop("wv"))
    if "w_gate" in layers:  # the dense gated MLP only
        layers["w_gu"] = cat(layers.pop("w_gate"), layers.pop("w_up"))
    return {**params, "layers": layers}


def _mean_sq_f64(x: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis of f32 ``x``, taken in float64
    and rounded to float32: the sum's order cannot move its f32 result, so
    a row's statistics do not depend on how many rows share the call (a
    prompt served alone or in a batch sees the same numbers)."""
    return x.double().square().mean(dim=-1, keepdim=True).float()


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float, unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm: statistics in f32 (the sum of squares in float64,
    :func:`_mean_sq_f64`).  Llama casts the normalized value to x's dtype
    and multiplies by the gain in x's dtype; with ``unit_offset`` (Gemma)
    the whole product by ``1 + g`` runs in f32 with one final cast, as HF's
    GemmaRMSNorm does."""
    xf = x.float()
    scale = torch.rsqrt(_mean_sq_f64(xf) + eps)
    if unit_offset:
        return ((xf * scale) * (1.0 + gain.float())).to(x.dtype)
    return (xf * scale).to(x.dtype) * gain


def _affine_layer_norm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Mean-centred LayerNorm with bias (StarCoder2): statistics in f32
    (both sums in float64, as :func:`rms_norm`'s), the normalized value
    cast to x's dtype, then gain and bias in x's dtype."""
    xf = x.float()
    centred = xf - xf.double().mean(dim=-1, keepdim=True).float()
    out = centred * torch.rsqrt(_mean_sq_f64(centred) + eps)
    return out.to(x.dtype) * gain + bias


def block_norm(x: torch.Tensor, cfg: LlamaConfig, lp, name: str) -> torch.Tensor:
    """A layer's norm: RMSNorm (Llama, Gemma) or LayerNorm (StarCoder2,
    whose bias is ``name + "_b"``)."""
    if cfg.norm_type == "layernorm":
        return _affine_layer_norm(x, lp[name], lp[name + "_b"], cfg.norm_eps)
    return rms_norm(x, lp[name], cfg.norm_eps, cfg.norm_unit_offset)


def apply_final_norm(x: torch.Tensor, cfg: LlamaConfig, params: Params) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return _affine_layer_norm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    return rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_unit_offset)


def _badd(x: torch.Tensor, lp, name: str) -> torch.Tensor:
    """Add a projection's bias when the tree has it (StarCoder2)."""
    return x + lp[name] if name in lp else x


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None, *, device) -> tuple:
    """Head-major KV cache.  ``kv_dtype="int8"``: ``(k8, v8, k_scale,
    v_scale)``, values (L, KH, B, T, HD) int8 and per-(token, head) bf16
    scales (L, KH, B, T).  Otherwise ``(k, v)``, each (L, KH, B, T, HD) in
    the compute dtype (bf16 when served; f32 in a float32 config)."""
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, cfg.n_kv_heads, batch, max_len, cfg.head_dim)
    if cfg.kv_dtype != "int8":
        return (
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        )
    return (
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
    )


def embed(params: Params, tokens: torch.Tensor, dtype, mesh=None) -> torch.Tensor:
    """Token-embedding lookup; an int8 table dequantizes only the gathered
    rows.  Over a mesh whose ``tensor`` axis shards the vocabulary, each
    rank looks up the ids in its rows (others give zeros) and a ``psum``
    over ``tensor`` assembles the rows (exact: one nonzero term each)."""
    table = params["embed"]
    tp = mesh.size("tensor") if mesh is not None else 1
    if tp > 1:
        rows_here = (table.q if isinstance(table, QuantizedMatrix) else table).shape[0]
        local = tokens - mesh.index("tensor") * rows_here
        inside = (local >= 0) & (local < rows_here)
        x = embed(params, local.clamp(0, rows_here - 1), dtype)
        return mesh.psum(x * inside[..., None].to(x.dtype), "tensor")
    if isinstance(table, QuantizedMatrix):
        rows = table.q[tokens].float()
        scales = table.scale[:, 0][tokens]
        return (rows * scales[..., None]).to(dtype)
    return table[tokens].to(dtype)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x (b, s, n_kv, hd) -> (q8, bf16 scale)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / int8_max_like(amax)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _layer_params(layers: dict, li: int) -> dict:
    out = {}
    for name, leaf in layers.items():
        if isinstance(leaf, BlockedQuantizedMatrix):
            out[name] = leaf.layer(li)
        elif isinstance(leaf, QuantizedMatrix):
            out[name] = QuantizedMatrix(leaf.q[li], leaf.scale[li])
        else:
            out[name] = leaf[li]
    return out


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(b, s, KH, ...) -> (KH, b, s, ...), the cache's head-major order."""
    return x.permute(2, 0, 1, *range(3, x.ndim))


# Rows of every MoE product (the router's and the experts'): each runs on
# blocks of exactly this many rows, the last padded with zero rows, so
# cuBLAS sees the same shapes whatever the batch and picks the same
# algorithm and split over K (a row's sums do not depend on its
# batch-mates).  128 keeps decode (32 rows, padded) bound by the weights'
# bytes on an H100, where the product is not the limit.
MOE_BLOCK_ROWS = 128
# Tokens a dispatch group holds at most (the reference's GShard blocking).
MOE_GROUP = 128


def _row_blocks(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` over ``x``'s axis ``dim`` in blocks of :data:`MOE_BLOCK_ROWS`
    rows (the last padded with zeros and cut off after), concatenated."""
    n = x.shape[dim]
    pad = (-n) % MOE_BLOCK_ROWS
    if pad:
        widths = [0, 0] * (x.ndim - 1 - dim) + [0, pad]
        x = F.pad(x, widths)
    outs = [fn(blk) for blk in torch.split(x, MOE_BLOCK_ROWS, dim=dim)]
    return torch.cat(outs, dim=dim).narrow(dim, 0, n)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values and their indices, the lower index first among
    equal values (``jax.lax.top_k``'s order; ``torch.topk`` promises none
    on the card): a stable descending sort."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _expert_ffn(x: torch.Tensor, lp, mesh=None) -> torch.Tensor:
    """Every expert's gated MLP on its rows: x (E, R, d) -> (E, R, d), each
    product with f32 accumulation and one rounding to x's dtype, as the
    reference's ``preferred_element_type=f32`` einsums.  With ``mesh`` the
    experts' columns are sharded over ``tensor`` and the down products'
    f32 partials are summed over it before their one rounding."""
    gated = F.silu(float_dot(x, lp["w_gate_e"])) * float_dot(x, lp["w_up_e"])
    if mesh is None:
        return float_dot(gated, lp["w_down_e"])
    return mesh.psum(f32_product(gated, lp["w_down_e"]), "tensor").to(x.dtype)


def moe_aux_terms(frac: torch.Tensor, mean_prob: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each dispatch group's load-balancing term ``E * sum_e frac_e *
    mean_prob_e`` (1 at uniform routing), over every expert: the router is
    replicated, so each rank computes the whole term for its groups."""
    return n_experts * (frac * mean_prob).sum(-1)


def _moe_mlp(h: torch.Tensor, lp, cfg: LlamaConfig, mesh=None, seq_sharded: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed mixture-of-experts MLP (the reference's GShard-style
    one-hot dispatch).  Returns ``(out, aux_loss)``.

    Tokens dispatch within groups of ``min(s, 128)`` (the sequence padded
    to a whole number of groups; padded slots claim no capacity) into
    per-expert buffers of ``cap`` slots: the whole group when
    ``moe_dropless``, else ``max(8, ceil(capacity_factor * s * k / E))``
    (tokens past it are dropped).  Routing is top-k over the softmax of the
    router's logits, ties to the lower expert; the gate weights renormalize
    over the k.  ``aux_loss`` is the load-balancing term ``E * sum_e
    fraction_dispatched_e * mean_prob_e`` (1 at uniform routing), averaged
    over the groups.

    The router's and the experts' products run on fixed blocks of rows
    (:data:`MOE_BLOCK_ROWS`), so a token's result does not depend on its
    batch-mates; the dispatch and combine products are exact (one and k
    nonzero terms a sum; the combine in f32).

    Over a mesh (``mesh`` a ``parallel.runtime.RankContext``) the router is
    replicated and routes over all experts; this rank holds experts
    ``[i * E/P, (i + 1) * E/P)`` of the ``expert`` axis (and a column block
    of each over ``tensor``), runs them on their dispatched rows, combines
    them in f32 and a ``psum`` over ``expert`` and ``tensor`` adds the
    other ranks' experts.  In a training graph the dispatched rows and the
    combine weights pass the f op over the axes that split them, so the
    router's and ``h``'s gradients are whole on every rank.  There
    ``aux_loss`` is this rank's share of the mean over every group of the
    global batch: its groups' terms over the count of all groups, so that
    the sum over ``data``, ``fsdp`` and ``seq`` is the mean.

    ``seq_sharded``: ``h`` is this rank's chunk of the sequence over the
    ``seq`` axis.  The groups are the reference's, cut from the global
    sequence: when they cross the chunks (a global sequence shorter than
    128 tokens a rank, or not a multiple of 128 a chunk) the sequence is
    gathered, routed whole on every rank of the axis, and each keeps its
    chunk's rows (the groups' terms counted on the axis' first rank).
    """
    seq = mesh.size("seq") if (mesh is not None and seq_sharded) else 1
    split = (mesh.size("data") * mesh.size("fsdp")) if mesh is not None else 1
    if seq > 1:
        s_local = h.shape[1]
        if s_local % min(s_local * seq, MOE_GROUP):
            i = mesh.index("seq")
            out, terms = _moe_dispatch(mesh.all_gather(h, "seq", dim=1), lp, cfg, mesh)
            share = terms.sum() / (terms.numel() * split)
            return out[:, i * s_local : (i + 1) * s_local], share if i == 0 else share * 0
        split *= seq
    out, terms = _moe_dispatch(h, lp, cfg, mesh)
    if mesh is None:
        return out, terms.mean()
    return out, terms.sum() / (terms.numel() * split)


def _moe_dispatch(h: torch.Tensor, lp, cfg: LlamaConfig, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_moe_mlp` on whole groups: ``(out, each group's aux term)``."""
    b_orig, s_orig, d = h.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    group = min(s_orig, MOE_GROUP)
    pad = (-s_orig) % group
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    n_groups = (s_orig + pad) // group
    valid = (torch.arange(s_orig + pad, device=h.device) < s_orig).float()
    valid = valid.reshape(n_groups, group)[None].expand(b_orig, n_groups, group).reshape(b_orig * n_groups, group)
    h = h.reshape(b_orig * n_groups, group, d)
    b, s = h.shape[:2]
    if cfg.moe_dropless:
        cap = s
    else:
        cap = min(max(8, int(cfg.expert_capacity_factor * s * k / E + 0.999)), s)

    router_logits = _row_blocks(lambda x: q_dot(x, lp["router"], "router"), h.reshape(b * s, d), 0)
    probs = torch.softmax(router_logits.reshape(b, s, E).float(), dim=-1)
    gate_w, gate_idx = _top_k(probs, k)  # (b, s, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)

    onehot = F.one_hot(gate_idx, E).float() * valid[:, :, None, None]  # (b, s, k, E); pads claim nothing
    valid_row = valid.sum(dim=1).clamp_min(1.0)
    frac = onehot.sum(dim=(1, 2)) / (valid_row * k)[:, None]  # (b, E)
    mean_prob = (probs * valid[:, :, None]).sum(dim=1) / valid_row[:, None]
    terms = moe_aux_terms(frac, mean_prob, E)

    # Slot of each (token, choice) in its expert's buffer: the count of
    # earlier choices of the same expert; past ``cap`` it is dropped.
    flat = onehot.reshape(b, s * k, E)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).long()
    keep = (pos < cap).float()
    pos_oh = F.one_hot(pos.clamp(max=cap - 1), cap).float() * keep[..., None]
    disp_k = (flat[:, :, :, None] * pos_oh[:, :, None, :]).reshape(b, s, k, E, cap)
    combine = (disp_k * gate_w[..., None, None]).sum(dim=2).to(h.dtype)  # (b, s, E, cap)
    disp = disp_k.sum(dim=2).to(h.dtype)

    ep = mesh.size("expert") if mesh is not None else 1
    tp = mesh.size("tensor") if mesh is not None else 1
    # Each rank's experts see only their rows of h and of the combine
    # weights: their gradients are summed over the axes that split them.
    h_experts = column_input(column_input(h, mesh, "expert"), mesh, "tensor")
    x_e = torch.einsum("bsec,bsd->becd", disp, h_experts)  # (b, E, cap, d)
    if ep > 1:
        if E % ep:
            raise ValueError(f"n_experts={E} not divisible by expert={ep}")
        e0 = mesh.index("expert") * (E // ep)
        combine = column_input(combine, mesh, "expert")
        x_e, combine = x_e[:, e0 : e0 + E // ep], combine[:, :, e0 : e0 + E // ep]
    e_here = x_e.shape[1]
    rows = x_e.transpose(0, 1).reshape(e_here, b * cap, d)
    y = _row_blocks(lambda x: _expert_ffn(x, lp, None if tp == 1 else mesh), rows, 1)
    y = y.reshape(e_here, b, cap, d).transpose(0, 1)
    out = torch.einsum("bsec,becd->bsd", combine.float(), y.float())
    if ep > 1:
        out = mesh.psum(out, "expert")
    out = out.to(h.dtype)
    return out.reshape(b_orig, s_orig + pad, d)[:, :s_orig], terms


def _mlp(h: torch.Tensor, lp, cfg: LlamaConfig, row_dot=q_dot):
    """The dense MLPs: packed gated (``w_gu``), unpacked gated with
    optional biases, or plain up -> act -> down (StarCoder2).  ``row_dot``
    is the down projection's product (tensor parallelism:
    :func:`row_parallel_dot`, before the replicated bias; ``h`` then comes
    through :func:`column_input`)."""
    if "w_gu" in lp:
        gu = q_dot(h, lp["w_gu"], "w_gu")
        gated = cfg.act_fn(gu[..., : cfg.d_ff]) * gu[..., cfg.d_ff :]
        return row_dot(gated, lp["w_down"], "w_down")
    if "w_gate" in lp:
        gated = cfg.act_fn(_badd(q_dot(h, lp["w_gate"], "w_gate"), lp, "b_gate")) * _badd(
            q_dot(h, lp["w_up"], "w_up"), lp, "b_up"
        )
    else:
        gated = cfg.act_fn(_badd(q_dot(h, lp["w_up"], "w_up"), lp, "b_up"))
    return _badd(row_dot(gated, lp["w_down"], "w_down"), lp, "b_down")


def row_parallel_dot(x: torch.Tensor, w, name: str, mesh, axis: str = "tensor") -> torch.Tensor:
    """``x @ w`` for a row-sharded projection (wo, w_down): this rank's
    f32 partial product over its rows of ``w`` (weight-only int8 scaled
    per column, or float), a ``psum`` over ``axis`` in f32, and one
    rounding to x's dtype, as the single device's product accumulates in
    f32 and rounds once.  Only the order of the f32 sum differs."""
    _validate_q_dot(x, w, name)
    if isinstance(w, QuantizedMatrix):
        part = f32_product(x, w.q.to(x.dtype)) * w.scale[..., 0, :]
    elif isinstance(w, torch.Tensor) and w.is_floating_point():
        part = f32_product(x, w)
    else:
        raise TypeError(f"projection {name!r}: a mesh serves weight-only int8 or float weights, got "
                        f"{type(w).__name__}")
    return mesh.psum(part, axis).to(x.dtype)


def _qkv(h: torch.Tensor, lp, cfg: LlamaConfig):
    """The attention projections, (b, s, heads, hd) each: one packed
    ``wqkv`` product, or three unpacked ones with their biases."""
    b, s = h.shape[:2]
    n_q, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "wqkv" in lp:
        qkv = q_dot(h, lp["wqkv"], "wqkv")
        q = qkv[..., : n_q * hd].reshape(b, s, n_q, hd)
        k = qkv[..., n_q * hd : (n_q + n_kv) * hd].reshape(b, s, n_kv, hd)
        v = qkv[..., (n_q + n_kv) * hd :].reshape(b, s, n_kv, hd)
        return q, k, v
    q = _badd(q_dot(h, lp["wq"], "wq"), lp, "bq").reshape(b, s, n_q, hd)
    k = _badd(q_dot(h, lp["wk"], "wk"), lp, "bk").reshape(b, s, n_kv, hd)
    v = _badd(q_dot(h, lp["wv"], "wv"), lp, "bv").reshape(b, s, n_kv, hd)
    return q, k, v


def dense_layer(
    x: torch.Tensor,
    lp,
    cfg: LlamaConfig,
    positions: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    mesh=None,
    tp_axis: Optional[str] = None,
) -> torch.Tensor:
    """One cacheless dense layer, as :func:`forward`'s cacheless mode runs
    it for a dense tree (the same attention block and MLP).

    ``tp_axis`` is Megatron-style tensor parallelism over that axis of
    ``mesh`` (a ``parallel.runtime.RankContext``): ``lp`` holds this rank's
    head and MLP shards (wq/wk/wv/w_gate/w_up column-sharded, wo/w_down
    row-sharded), attention runs over the local heads, and one ``psum``
    of each of wo's and w_down's f32 partial products restores the full
    residual (:func:`row_parallel_dot`).  Projection
    biases would be added once per shard, so trees that carry them
    (StarCoder2) are refused, as in the reference (:func:`forward` over a
    mesh adds them after the sums)."""
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    row_dot = q_dot
    if tp_axis is not None:
        if mesh is None:
            raise ValueError("tp_axis needs the rank's mesh context")
        if cfg.proj_bias:
            raise NotImplementedError("tensor-parallel dense_layer with projection biases")
        tp = mesh.size(tp_axis)
        if n_q % tp or n_kv % tp:
            raise ValueError(f"heads ({n_q} q / {n_kv} kv) not divisible by tp={tp}")
        cfg = dataclasses.replace(cfg, n_heads=n_q // tp, n_kv_heads=n_kv // tp, d_ff=cfg.d_ff // tp)

        def row_dot(x, w, name):
            return row_parallel_dot(x, w, name, mesh, tp_axis)

    col_mesh = mesh if tp_axis is not None else None
    x = _attention_block(x, lp, cfg, positions, lambda q, k, v: attention(q, k, v, positions, kv_lengths,
                                                                          **_mesh_kw(mesh)), row_dot,
                         col_mesh, tp_axis)
    h = column_input(block_norm(x, cfg, lp, "mlp_norm"), col_mesh, tp_axis)
    return x + _mlp(h, lp, cfg, row_dot)


def _attention_block(x: torch.Tensor, lp, cfg: LlamaConfig, positions: torch.Tensor, attend,
                     row_dot=q_dot, mesh=None, axis: str = "tensor") -> torch.Tensor:
    """``x`` plus one layer's attention: the norm, the projections, RoPE,
    ``attend(q, k, v)`` -> (b, s, heads, hd), and the output projection
    through ``row_dot`` (over the heads' shards: :func:`row_parallel_dot`,
    before its replicated bias; the projections' input then comes through
    :func:`column_input` over ``axis`` of ``mesh``)."""
    b, s = x.shape[:2]
    q, k, v = _qkv(column_input(block_norm(x, cfg, lp, "attn_norm"), mesh, axis), lp, cfg)
    attn = attend(apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v)
    return x + _badd(row_dot(attn.reshape(b, s, cfg.n_heads * cfg.head_dim), lp["wo"], "wo"), lp, "bo")


def _mesh_kw(mesh) -> dict:
    """``mesh=`` for the attention calls over a mesh; nothing without one,
    so a single-device call keeps the signature it always had."""
    return {} if mesh is None else {"mesh": mesh}


def _check_mlp_tree(cfg: LlamaConfig, params: Params) -> None:
    if cfg.n_experts > 1 and "router" not in params["layers"]:
        raise ValueError(
            "config has n_experts > 1 but params carry a dense MLP tree — the MoE config requires "
            "router/w_*_e leaves (load or init params with the same config)"
        )
    if cfg.n_experts <= 1 and "router" in params["layers"]:
        raise ValueError(
            "params carry MoE leaves (router/w_*_e) but the config is dense (n_experts <= 1) — use the "
            "matching MoE config"
        )


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[tuple] = None,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    kv_bucket: Optional[int] = None,
    cold_prefill: bool = False,
    append_cache: Optional[tuple] = None,
    page_table: Optional[torch.Tensor] = None,
    page_tokens: int = 0,
    pages_len: int = 0,
    return_aux: bool = False,
    row_offset: int = 0,
    embeds: Optional[torch.Tensor] = None,
    remat: bool = False,
    mesh=None,
    seq_sharded: bool = False,
):
    """Run the transformer body, cacheless or against a serving cache.

    ``cache=None`` is cacheless causal self-attention over ``tokens``
    (scoring; ``kv_lengths`` optionally masks padding): nothing is
    written, attention runs over the fresh k/v.  Otherwise ``cache`` is
    the int8 ``(k8, v8, ks, vs)`` or the float ``(k, v)`` tuple
    (:func:`init_kv_cache`), updated in place.
    ``kv_bucket`` caps the cache window attention reads (not the verify
    pass's, which reads the whole cache).  ``cold_prefill``
    asserts that the cache holds nothing visible to these queries and that
    ``positions`` is ``arange(s)`` for every row (cache rows ``[row_offset,
    row_offset + b)`` are written).  ``append_cache`` is
    ``(ab, step)`` for the decode chunk's append buffer (s == 1): the fresh
    K/V go to ``ab`` slot ``step`` and the big cache is only read.  With
    s > 1 it is the verify pass: ``ab`` has exactly s slots, ``step`` is 0,
    the fresh block fills them, and ``kv_lengths`` is each row's valid
    cache prefix (the caller flushes the buffer after the pass).  A float
    cache takes only the verify pass (its ``ab`` is ``(k, v)`` of s slots):
    its decode scatters each step into the cache.

    ``page_table`` switches to the paged layout: ``cache`` is the 4-tuple
    of flat pool leaves (values (L, KH, P, HD), scales (L, KH, P)) and
    ``page_table`` (b, n_slot_pages) int32 maps row ``r``'s logical token
    ``t`` to pool slot ``table[r, t // page_tokens] * page_tokens + t %
    page_tokens``; ``pages_len`` is the logical per-slot capacity that
    ``kv_bucket`` windows against.  Warm writes scatter through the table
    and reads gather the logical window, so the results equal the
    contiguous layout's on the same content.

    ``embeds`` (b, s, d_model) replaces the token-embedding lookup in
    every mode (cast to the compute dtype; Gemma's ``scale_embeddings``
    applies to it too): the VLM's image prefix (``models.vision``).

    ``remat`` (training, with ``cfg.remat``) runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes
    the layer's activations, as the reference's ``jax.checkpoint`` does.

    ``mesh`` (a ``parallel.runtime.RankContext``, inside a program every
    rank of a mesh runs) makes this one rank's share of the forward, its
    params and cache being its shards (``engine.weights.shard_params``,
    :func:`local_config`): the embedding is looked up over the vocabulary
    shards (:func:`embed`), each layer runs its local heads and MLP
    columns with one ``psum`` over ``tensor`` after wo and one after
    w_down (f32 partials, one rounding after the sum, biases after that:
    :func:`row_parallel_dot`), MoE layers run the rank's
    experts (:func:`_moe_mlp`), and self-attention over fresh k/v goes
    sequence-parallel when the ``seq`` axis is populated
    (``ops.attention.attention``).  The rows are the rank's share of the
    ``data`` axis.  Every other step is the single-device code on the
    local shapes, the port's kernels included.

    Training over a mesh (inside a rank's graph, ``parallel.autograd``):
    a tree sharded with ``fsdp_rules`` over a populated ``fsdp`` axis
    (:func:`fsdp_sharded`) has each leaf gathered just before use
    (:func:`fsdp_gather`; a layer's inside its remat block), the inputs
    of column-sharded products pass the f op (:func:`column_input`), and
    ``seq_sharded`` (cacheless) says that ``tokens`` and ``positions`` are
    this rank's chunk of the sequence over the ``seq`` axis (global
    positions): attention rings the K/V chunks around the axis
    (``parallel.ring_attention``) and the MoE layers keep the reference's
    groups of the global sequence (:func:`_moe_mlp`).  With
    ``return_aux`` the aux loss is then this rank's share of the global
    mean (its sum over ``data``, ``fsdp`` and ``seq`` is the mean).

    Returns ``(hidden, cache)``, ``(hidden, cache, ab)`` with
    ``append_cache``, or ``(hidden, cache, aux)`` with ``return_aux``
    (the MoE load-balancing loss averaged over layers; 0 for dense trees).
    """
    if cache is not None and len(cache) not in (2, 4):
        raise ValueError("cache must be the int8 (k8, v8, k_scale, v_scale) or the float (k, v) tuple")
    b, s = tokens.shape
    paged = page_table is not None
    if paged:
        if cache is None or len(cache) != 4:
            raise ValueError("paged KV requires the int8 4-tuple of flat pool leaves")
        if cold_prefill:
            raise ValueError(
                "cold_prefill is contiguous-only: paged callers stage cold prefill "
                "in a small contiguous cache and scatter rows into pool pages"
            )
        if page_tokens < 1 or pages_len < 1:
            raise ValueError("paged KV requires page_tokens >= 1 and pages_len >= 1")
        t = pages_len
    else:
        t = cache[0].shape[3] if cache is not None else 0
    window = t if kv_bucket is None else min(kv_bucket, t)
    if append_cache is not None:
        if cache is None or kv_lengths is None:
            raise ValueError("append_cache requires the int8 KV cache and kv_lengths")
        ab, step = append_cache
        if s > 1 and (ab[0].shape[3] != s or step != 0):
            raise ValueError(f"verify append buffer has {ab[0].shape[3]} slots at step {step} for {s} fresh tokens")
        if len(cache) == 2 and s == 1:
            raise ValueError("the float cache decodes by scattering each step (no append buffer); append_cache "
                             "over it is the s > 1 verify pass")
        if len(ab) != len(cache):
            raise ValueError(f"append buffer of {len(ab)} leaves for a cache of {len(cache)}")
    else:
        ab, step = None, None
    if cache is not None and cold_prefill and s > 1 and (row_offset + b > cache[0].shape[2] or s > t):
        raise ValueError("cold prefill rows/slots exceed the cache")
    _check_mlp_tree(cfg, params)

    paging = None
    if paged:
        # Warm mode: physical write slot of each fresh token (positions
        # clamp to the logical capacity, so a padded tail lands on the
        # row's last entry: an owned page's garbage tail or page 0) and
        # the flat gather index of the logical window [0, window).
        warm = ab is None
        paging = (
            page_table, page_tokens,
            paged_slots(page_table, positions.clamp(max=pages_len - 1), page_tokens) if warm else None,
            paged_window_index(page_table, window, page_tokens) if warm else None,
        )

    lc = local_config(cfg, mesh)
    row_dot = q_dot
    if mesh is not None and mesh.size("tensor") > 1:

        def row_dot(x, w, name):
            return row_parallel_dot(x, w, name, mesh)

    gathered = fsdp_dims(cfg) if fsdp_sharded(params, cfg, mesh) else None
    if gathered is not None:
        params = {**params, **{n: fsdp_gather(params[n], mesh, gathered[n]) for n in params
                               if n in gathered and n not in ("layers", "lm_head")}}
    x = embed(params, tokens, cfg.compute_dtype, mesh) if embeds is None else embeds.to(cfg.compute_dtype)
    if cfg.scale_embeddings:
        # Gemma: sqrt(d_model) rounded to the activations' dtype first.
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(x, li):
        lp = _layer_params(params["layers"], li)
        if gathered is not None:
            dims = gathered["layers"]
            lp = {n: fsdp_gather(w, mesh, dims[n]) if n in dims else w for n, w in lp.items()}

        def attend(q, k, v):
            if cache is None:
                kw = _mesh_kw(mesh)
                if seq_sharded:
                    kw["seq_sharded"] = True
                return attention(q, k, v, positions, kv_lengths, **kw)
            if len(cache) == 2:
                return _float_cache_attention(
                    q, k, v, li, positions, kv_lengths, cache, ab, cold_prefill, window, t, row_offset,
                    **_mesh_kw(mesh),
                )
            return _cache_attention(
                q, k, v, li, positions, kv_lengths, cache, append_cache, cold_prefill, window, t, paging, row_offset,
                **_mesh_kw(mesh),
            )

        x = _attention_block(x, lp, lc, positions, attend, row_dot, mesh)
        h = block_norm(x, lc, lp, "mlp_norm")
        if "router" in lp:
            mlp_out, layer_aux = _moe_mlp(h, lp, lc, mesh, seq_sharded)
        else:
            mlp_out, layer_aux = _mlp(column_input(h, mesh, "tensor"), lp, lc, row_dot), None
        return x + mlp_out, layer_aux

    for li in range(cfg.n_layers):
        if remat and cfg.remat:
            x, layer_aux = torch.utils.checkpoint.checkpoint(layer, x, li, use_reentrant=False)
        else:
            x, layer_aux = layer(x, li)
        if layer_aux is not None:
            aux = aux + layer_aux

    x = apply_final_norm(x, cfg, params)
    if ab is not None:
        return x, cache, ab
    if return_aux:
        return x, cache, aux / max(cfg.n_layers, 1)
    return x, cache


def _float_cache_attention(q, k, v, li, positions, kv_lengths, cache, ab, cold_prefill, window, t, row_offset,
                           mesh=None):
    """Layer ``li``'s attention over the float ``(k, v)`` cache in one of
    :func:`forward`'s modes (verify, cold prefill, warm chunk, warm
    decode), writing the fresh k/v where the mode keeps them."""
    b, s = q.shape[:2]
    kc, vc = cache
    if kv_lengths is None:
        kv_lengths = torch.full((b,), t, dtype=torch.int32, device=q.device)
    if ab is not None:
        # Verify block: the fresh k/v fill the s-slot buffer of layer li;
        # the queries attend the whole cache prefix and the causal buffer
        # (a window of the batch's longest row would move a row's sums).
        ab[0][li] = _heads_first(k)
        ab[1][li] = _heads_first(v)
        return float_cache_attention(q, kc[li, :, :b], vc[li, :, :b], positions, kv_lengths,
                                     append=(ab[0][li], ab[1][li]))
    if cold_prefill and s > 1:
        kc[li, :, row_offset : row_offset + b, :s] = _heads_first(k)
        vc[li, :, row_offset : row_offset + b, :s] = _heads_first(v)
        return attention(q, k, v, positions, kv_lengths, **_mesh_kw(mesh))
    # Warm write, clamped onto the last slot as the int8 path's.
    bidx = torch.arange(b, device=q.device)[:, None]
    wpos = positions.clamp(max=t - 1)
    kc[li][:, bidx, wpos] = _heads_first(k)
    vc[li][:, bidx, wpos] = _heads_first(v)
    if s == 1:
        # Decode reads the whole cache: its sums then never follow the
        # window the batch's longest row sets.
        return float_cache_attention(q, kc[li, :, :b], vc[li, :, :b], positions, kv_lengths)

    def window_of(buf):
        # (KH, B, window, HD) -> (B, window, KH, HD)
        return buf[li, :, :b, :window].permute(1, 2, 0, 3)

    return attention(q, window_of(kc), window_of(vc), positions, kv_lengths)


def _cache_attention(q, k, v, li, positions, kv_lengths, cache, append_cache, cold_prefill, window, t, paging,
                     row_offset=0, mesh=None):
    """Layer ``li``'s attention in one of :func:`forward`'s serving modes:
    quantize the fresh K/V, write them where the mode keeps them, and
    attend.  ``paging`` is None on the contiguous cache, else ``(table,
    page_tokens, warm write slots, warm window index)``."""
    b, s = q.shape[:2]
    k8c, v8c, ksc, vsc = cache
    ab, step = append_cache if append_cache is not None else (None, None)
    paged = paging is not None
    page_table, page_tokens, phys_pos, page_flat = paging if paged else (None,) * 4
    k8, ks = _quantize_kv(k)
    v8, vs = _quantize_kv(v)

    if ab is not None and s > 1:
        # Verify block: (b, s, KH, ...) -> (KH, b, s, ...) into slots
        # [0, s) of layer li; the queries attend the cache prefix and
        # the causal buffer.
        ab[0][li] = _heads_first(k8)
        ab[1][li] = _heads_first(v8)
        ab[2][li] = _heads_first(ks)
        ab[3][li] = _heads_first(vs)
        block = (ab[0], ab[1], ab[2], ab[3])
        # The verify window is the whole cache, not ``kv_bucket``: the
        # plain core's sums run over the window's length, and a bucket
        # follows the batch's longest row, so a row's logits would
        # depend on its batch-mates (masked slots add exact zeros).
        if paged:
            return paged_verify_gqa_attention(
                q, k8c, v8c, ksc, vsc, li, kv_lengths, page_table, block, window=t, page_tokens=page_tokens,
            )
        return verify_gqa_attention(q, k8c, v8c, ksc, vsc, li, kv_lengths, block, window=t)
    if ab is not None:
        # (b, 1, KH, ...) -> (KH, b, ...) into slot ``step`` of layer li.
        ab[0][li, :, :, step] = _heads_first(k8)[:, :, 0]
        ab[1][li, :, :, step] = _heads_first(v8)[:, :, 0]
        ab[2][li, :, :, step] = _heads_first(ks)[:, :, 0]
        ab[3][li, :, :, step] = _heads_first(vs)[:, :, 0]
        append = (ab[0], ab[1], ab[2], ab[3], step + 1)
        if paged:
            return paged_decode_gqa_attention(
                q[:, 0], k8c, v8c, ksc, vsc, li, kv_lengths, page_table,
                append=append, window=window, page_tokens=page_tokens,
            )[:, None]
        return decode_gqa_attention(q[:, 0], k8c, v8c, ksc, vsc, li, kv_lengths, append=append, window=window)[:, None]
    if cold_prefill and s > 1:
        rows = slice(row_offset, row_offset + b)
        k8c[li, :, rows, :s] = _heads_first(k8)
        v8c[li, :, rows, :s] = _heads_first(v8)
        ksc[li, :, rows, :s] = _heads_first(ks)
        vsc[li, :, rows, :s] = _heads_first(vs)
        # Attend over the fresh k/v: no quantization error on the
        # prompt pass (the cache stores int8 for later reads).
        return attention(q, k, v, positions, kv_lengths, **_mesh_kw(mesh))
    if paged:
        # Paged warm mode: scatter the fresh KV through the table, then
        # the contiguous warm path's attention call over the gathered
        # logical window.
        k8c[li][:, phys_pos] = _heads_first(k8)
        v8c[li][:, phys_pos] = _heads_first(v8)
        ksc[li][:, phys_pos] = _heads_first(ks)
        vsc[li][:, phys_pos] = _heads_first(vs)

        def gather(buf):
            # (KH, P, ...) -> (b, window, KH, ...)
            g = buf[li][:, page_flat]
            return g.permute(1, 2, 0, *range(3, g.ndim))

        return attention(
            q, gather(k8c), gather(v8c), positions, kv_lengths, k_scale=gather(ksc), v_scale=gather(vsc),
        )
    # Warm write.  The reference drops out-of-range writes (padded tail
    # positions past the cache); the port clamps them onto the last slot,
    # which lies in the tail garbage zone no live KV reaches
    # (ops.decode_attention.flush_clip_start).
    bidx = torch.arange(b, device=q.device)[:, None]
    wpos = positions.clamp(max=t - 1)
    k8c[li][:, bidx, wpos] = _heads_first(k8)
    v8c[li][:, bidx, wpos] = _heads_first(v8)
    ksc[li][:, bidx, wpos] = _heads_first(ks)
    vsc[li][:, bidx, wpos] = _heads_first(vs)

    def window_of(buf):
        # (KH, B, window, ...) -> (B, window, KH, ...)
        sl = buf[li, :, :b, :window]
        return sl.permute(1, 2, 0, *range(3, sl.ndim))

    return attention(
        q, window_of(k8c), window_of(v8c), positions, kv_lengths, k_scale=window_of(ksc), v_scale=window_of(vsc),
    )


def logits(params: Params, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """Project hidden states to f32 vocab logits (f32 accumulation).

    An int8 head is held with its values in the compute dtype
    (``engine.weights.head_for_logits``, once at load): int8 -> bf16 is
    exact, so the product equals the reference's convert-in-the-dot.  On
    the card a bf16 x bf16 product runs with f32 accumulation and f32
    output, on fixed row blocks (``ops.quant.f32_product``); elsewhere the
    operands go to f32.

    Over a mesh whose ``tensor`` axis shards the vocabulary, each rank
    projects onto its columns and the shards are gathered, so every rank
    holds the whole f32 logits (the sampler's input)."""
    head = params["lm_head"]
    w, scale = (head.q, head.scale[..., 0, :]) if isinstance(head, QuantizedMatrix) else (head, None)
    if hidden.dtype != w.dtype:
        hidden, w = hidden.float(), w.float()
    out = f32_product(hidden, w)
    out = out if scale is None else out * scale
    if mesh is not None and mesh.size("tensor") > 1:
        out = mesh.all_gather(out.contiguous(), "tensor", dim=-1)
    return out
