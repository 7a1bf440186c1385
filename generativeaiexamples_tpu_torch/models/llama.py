"""Llama-3 model family in PyTorch (port of ``models/llama.py``, the
dense serving path).

Params are a plain dict of tensors, as in the reference: per-layer leaves
are stacked on a leading ``n_layers`` axis (``params["layers"]``), so the
reference's param trees convert leaf by leaf
(``engine.weights.params_from_numpy``) and the layer loop takes views.

:func:`forward` runs the three serving modes of the int8 KV cache the
scheduler uses, on the contiguous cache or on the paged pool
(``engine.paged_kv``, through a page table):

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

The projections are packed (``wqkv``, ``w_gu``) and pre-blocked int8
(``engine.decode.prepare_params``), and each goes through
``ops.quant.q_dot`` to the W8A8 kernel (``ops.qmm``).  The cache is
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.ops.attention import attention
from generativeaiexamples_tpu_torch.ops.decode_attention import (
    decode_gqa_attention,
    paged_decode_gqa_attention,
    paged_slots,
    paged_verify_gqa_attention,
    paged_window_index,
    verify_gqa_attention,
)
from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix
from generativeaiexamples_tpu_torch.ops.quant import QuantizedMatrix, int8_max_like, q_dot
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
    # KV-cache storage.  The port serves "int8" (per-token-per-head
    # symmetric bf16 scales); the default mirrors the reference's presets.
    kv_dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


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


PRESETS = {
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama3.2-1b": llama32_1b,
    "llama-tiny": llama_tiny,
}


def param_shapes(cfg: LlamaConfig) -> dict:
    L, D, H, KV, HD, FF, V = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
    )
    return {
        "embed": (V, D),
        "layers": {
            "attn_norm": (L, D),
            "wq": (L, D, H * HD),
            "wk": (L, D, KV * HD),
            "wv": (L, D, KV * HD),
            "wo": (L, H * HD, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, FF),
            "w_up": (L, D, FF),
            "w_down": (L, FF, D),
        },
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator, device) -> Params:
    """Random-normal initialization (0.02 std), norms at 1."""
    shapes = param_shapes(cfg)

    def leaf(shape, name):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=cfg.compute_dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(cfg.compute_dtype)

    return {
        "embed": leaf(shapes["embed"], "embed"),
        "layers": {n: leaf(s, n) for n, s in shapes["layers"].items()},
        "final_norm": leaf(shapes["final_norm"], "final_norm"),
        "lm_head": leaf(shapes["lm_head"], "lm_head"),
    }


def pack_for_serving(params: Params) -> Params:
    """Fuse ``wq|wk|wv -> wqkv`` and ``w_gate|w_up -> w_gu`` on the output
    axis (QuantizedMatrix leaves); idempotent."""
    layers = dict(params["layers"])
    if "wqkv" in layers:
        return params

    def cat(*ms):
        return QuantizedMatrix(
            q=torch.cat([m.q for m in ms], dim=-1),
            scale=torch.cat([m.scale for m in ms], dim=-1),
        )

    layers["wqkv"] = cat(layers.pop("wq"), layers.pop("wk"), layers.pop("wv"))
    layers["w_gu"] = cat(layers.pop("w_gate"), layers.pop("w_up"))
    return {**params, "layers": layers}


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: statistics in f32, normalized value cast to x's dtype, then
    the gain in x's dtype.  The sum of squares runs in float64 before its
    f32 rounding, so a row's result does not depend on how many rows share
    the call (reduction order): a prompt served alone or in a batch sees
    the same numbers."""
    xf = x.float()
    ms = xf.double().square().mean(dim=-1, keepdim=True).float()
    scale = torch.rsqrt(ms + eps)
    return (xf * scale).to(x.dtype) * gain


def block_norm(x: torch.Tensor, cfg: LlamaConfig, lp, name: str) -> torch.Tensor:
    return rms_norm(x, lp[name], cfg.norm_eps)


def apply_final_norm(x: torch.Tensor, cfg: LlamaConfig, params: Params) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None, *, device) -> tuple:
    """Head-major int8 KV cache ``(k8, v8, k_scale, v_scale)``: values
    (L, KH, B, T, HD) int8, per-(token, head) bf16 scales (L, KH, B, T).
    (The reference's bf16 cache is not ported yet.)"""
    if cfg.kv_dtype != "int8":
        raise ValueError(f"the port serves the int8 KV cache, not kv_dtype={cfg.kv_dtype!r}")
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, cfg.n_kv_heads, batch, max_len, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
    )


def embed(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token-embedding lookup; an int8 table dequantizes only the gathered rows."""
    table = params["embed"]
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


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: tuple,
    kv_lengths: torch.Tensor,
    *,
    kv_bucket: Optional[int] = None,
    cold_prefill: bool = False,
    append_cache: Optional[tuple] = None,
    page_table: Optional[torch.Tensor] = None,
    page_tokens: int = 0,
    pages_len: int = 0,
):
    """Run the transformer body against the int8 serving cache.

    ``cache`` is the ``(k8, v8, ks, vs)`` tuple, updated in place.
    ``kv_bucket`` caps the cache window attention reads (not the verify
    pass's, which reads the whole cache).  ``cold_prefill``
    asserts that the cache holds nothing visible to these queries and that
    ``positions`` is ``arange(s)`` for every row (cache rows ``[0, b)``
    are written).  ``append_cache`` is
    ``(ab, step)`` for the decode chunk's append buffer (s == 1): the fresh
    K/V go to ``ab`` slot ``step`` and the big cache is only read.  With
    s > 1 it is the verify pass: ``ab`` has exactly s slots, ``step`` is 0,
    the fresh block fills them, and ``kv_lengths`` is each row's valid
    cache prefix (the caller flushes the buffer after the pass).

    ``page_table`` switches to the paged layout: ``cache`` is the 4-tuple
    of flat pool leaves (values (L, KH, P, HD), scales (L, KH, P)) and
    ``page_table`` (b, n_slot_pages) int32 maps row ``r``'s logical token
    ``t`` to pool slot ``table[r, t // page_tokens] * page_tokens + t %
    page_tokens``; ``pages_len`` is the logical per-slot capacity that
    ``kv_bucket`` windows against.  Warm writes scatter through the table
    and reads gather the logical window, so the results equal the
    contiguous layout's on the same content.

    Returns ``(hidden, cache)``, or ``(hidden, cache, ab)`` with
    ``append_cache``.
    """
    if cache is None or len(cache) != 4:
        raise ValueError("forward serves the int8 KV cache (k8, v8, k_scale, v_scale)")
    b, s = tokens.shape
    n_q, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    paged = page_table is not None
    if paged:
        if cold_prefill:
            raise ValueError(
                "cold_prefill is contiguous-only: paged callers stage cold prefill "
                "in a small contiguous cache and scatter rows into pool pages"
            )
        if page_tokens < 1 or pages_len < 1:
            raise ValueError("paged KV requires page_tokens >= 1 and pages_len >= 1")
        t = pages_len
    else:
        t = cache[0].shape[3]
    window = t if kv_bucket is None else min(kv_bucket, t)
    if append_cache is not None:
        ab, step = append_cache
        if s > 1 and (ab[0].shape[3] != s or step != 0):
            raise ValueError(f"verify append buffer has {ab[0].shape[3]} slots at step {step} for {s} fresh tokens")
    else:
        ab, step = None, None
    if cold_prefill and s > 1 and (b > cache[0].shape[2] or s > t):
        raise ValueError("cold prefill rows/slots exceed the cache")

    if paged and ab is None:
        # Warm mode: physical write slot of each fresh token (positions
        # clamp to the logical capacity, so a padded tail lands on the
        # row's last entry: an owned page's garbage tail or page 0) and
        # the flat gather index of the logical window [0, window).
        phys_pos = paged_slots(page_table, positions.clamp(max=pages_len - 1), page_tokens)
        page_flat = paged_window_index(page_table, window, page_tokens)

    x = embed(params, tokens, cfg.compute_dtype)
    k8c, v8c, ksc, vsc = cache
    for li in range(cfg.n_layers):
        lp = _layer_params(params["layers"], li)
        h = block_norm(x, cfg, lp, "attn_norm")
        qkv = q_dot(h, lp["wqkv"], "wqkv")
        q = qkv[..., : n_q * hd].reshape(b, s, n_q, hd)
        k = qkv[..., n_q * hd : (n_q + n_kv) * hd].reshape(b, s, n_kv, hd)
        v = qkv[..., (n_q + n_kv) * hd :].reshape(b, s, n_kv, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
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
                attn = paged_verify_gqa_attention(
                    q, k8c, v8c, ksc, vsc, li, kv_lengths, page_table, block,
                    window=t, page_tokens=page_tokens,
                )
            else:
                attn = verify_gqa_attention(q, k8c, v8c, ksc, vsc, li, kv_lengths, block, window=t)
        elif ab is not None:
            # (b, 1, KH, ...) -> (KH, b, ...) into slot ``step`` of layer li.
            ab[0][li, :, :, step] = _heads_first(k8)[:, :, 0]
            ab[1][li, :, :, step] = _heads_first(v8)[:, :, 0]
            ab[2][li, :, :, step] = _heads_first(ks)[:, :, 0]
            ab[3][li, :, :, step] = _heads_first(vs)[:, :, 0]
            append = (ab[0], ab[1], ab[2], ab[3], step + 1)
            if paged:
                attn = paged_decode_gqa_attention(
                    q[:, 0], k8c, v8c, ksc, vsc, li, kv_lengths, page_table,
                    append=append, window=window, page_tokens=page_tokens,
                )[:, None]
            else:
                attn = decode_gqa_attention(
                    q[:, 0], k8c, v8c, ksc, vsc, li, kv_lengths, append=append, window=window,
                )[:, None]
        elif cold_prefill and s > 1:
            k8c[li, :, :b, :s] = _heads_first(k8)
            v8c[li, :, :b, :s] = _heads_first(v8)
            ksc[li, :, :b, :s] = _heads_first(ks)
            vsc[li, :, :b, :s] = _heads_first(vs)
            # Attend over the fresh k/v: no quantization error on the
            # prompt pass (the cache stores int8 for later reads).
            attn = attention(q, k, v, positions, kv_lengths)
        elif paged:
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

            attn = attention(
                q, gather(k8c), gather(v8c), positions, kv_lengths,
                k_scale=gather(ksc), v_scale=gather(vsc),
            )
        else:
            # Warm write.  The reference drops out-of-range writes (padded
            # tail positions past the cache); the port clamps them onto the
            # last slot, which lies in the tail garbage zone no live KV
            # reaches (ops.decode_attention.flush_clip_start).
            bidx = torch.arange(b, device=tokens.device)[:, None]
            wpos = positions.clamp(max=t - 1)
            k8c[li][:, bidx, wpos] = _heads_first(k8)
            v8c[li][:, bidx, wpos] = _heads_first(v8)
            ksc[li][:, bidx, wpos] = _heads_first(ks)
            vsc[li][:, bidx, wpos] = _heads_first(vs)

            def window_of(buf):
                # (KH, B, window, ...) -> (B, window, KH, ...)
                sl = buf[li, :, :b, :window]
                return sl.permute(1, 2, 0, *range(3, sl.ndim))

            attn = attention(
                q, window_of(k8c), window_of(v8c), positions, kv_lengths,
                k_scale=window_of(ksc), v_scale=window_of(vsc),
            )
        x = x + q_dot(attn.reshape(b, s, n_q * hd), lp["wo"], "wo")

        h = block_norm(x, cfg, lp, "mlp_norm")
        gu = q_dot(h, lp["w_gu"], "w_gu")
        gated = F.silu(gu[..., : cfg.d_ff]) * gu[..., cfg.d_ff :]
        x = x + q_dot(gated, lp["w_down"], "w_down")

    x = apply_final_norm(x, cfg, params)
    if ab is not None:
        return x, cache, ab
    return x, cache


def logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Project hidden states to f32 vocab logits (f32 accumulation).

    An int8 head is held with its values in the compute dtype
    (``engine.weights.head_for_logits``, once at load): int8 -> bf16 is
    exact, so the product equals the reference's convert-in-the-dot.  On
    the card a bf16 x bf16 product runs with f32 accumulation and f32
    output; elsewhere the operands go to f32."""
    head = params["lm_head"]
    w, scale = (head.q, head.scale[..., 0, :]) if isinstance(head, QuantizedMatrix) else (head, None)
    if hidden.is_cuda and hidden.dtype == w.dtype == torch.bfloat16:
        out = torch.mm(hidden.reshape(-1, hidden.shape[-1]), w, out_dtype=torch.float32)
        out = out.reshape(*hidden.shape[:-1], w.shape[-1])
    else:
        out = torch.matmul(hidden.float(), w.float())
    return out if scale is None else out * scale
