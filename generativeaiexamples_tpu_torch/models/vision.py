"""Vision models in PyTorch (port of ``models/vision.py``): the ViT encoder
and the VLM bridge onto the Llama decoder.

* **ViT** — patchify as a reshape (patch rows, patch columns, channels),
  the patch projection as one matmul, a CLS row and learned positions,
  pre-LN bidirectional blocks with exact (erf) GELU.  Its attention is
  bidirectional f32 written here (``ops.f32``), never ``ops.attention``,
  whose multi-token blocks go to the causal flash kernel.
* **VLM** — the encoder's rows projected into the Llama embedding space
  and prepended as prefix embeddings (``llama.forward(embeds=...)``); a
  greedy prefill over [image prefix ; prompt] into a fresh bf16 cache (a
  warm multi-token block from position 0: the flash kernel on the card)
  and a greedy decode of single-token steps over it (on the card, in the
  vision analyst, one step captured as a CUDA graph per batch and cache
  size and replayed across generations: :class:`DecodeGraphs`);
  :func:`vlm_caption_loss`, the captioning fine-tune objective.

Params are plain dicts of tensors with the reference's leaf names and
shapes, so its trees carry over (``engine.weights.vlm_params_from_numpy``).
bf16 products accumulate in f32 and round once (``ops.quant.float_dot``,
fixed row blocks on the card); the LayerNorm keeps the reference's
rounding order (normalize in f32, cast, then ``* g + b`` in the compute
dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import f32
from generativeaiexamples_tpu_torch.ops.quant import float_dot

Params = Any


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def compute_dtype(self) -> torch.dtype:
        return llama._DTYPES[self.dtype]


def vit_base(**overrides) -> ViTConfig:
    """ViT-B/16 geometry."""
    return dataclasses.replace(ViTConfig(), **overrides)


def vit_tiny(**overrides) -> ViTConfig:
    """Tiny geometry for CPU tests."""
    return dataclasses.replace(
        ViTConfig(image_size=32, patch_size=8, d_model=64, n_layers=2, n_heads=4, d_ff=128), **overrides
    )


def vit_param_shapes(cfg: ViTConfig) -> dict:
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    return {
        "patch_proj": (cfg.patch_dim, D),
        "patch_bias": (D,),
        "pos_embed": (cfg.n_patches + 1, D),
        "cls": (1, 1, D),
        "layers": {
            "ln1_g": (L, D), "ln1_b": (L, D), "wqkv": (L, D, 3 * D), "bqkv": (L, 3 * D), "wo": (L, D, D),
            "bo": (L, D), "ln2_g": (L, D), "ln2_b": (L, D), "w1": (L, D, F_), "b1": (L, F_), "w2": (L, F_, D),
            "b2": (L, D),
        },
        "final_ln_g": (D,),
        "final_ln_b": (D,),
    }


_VIT_DRAWN = ("patch_proj", "pos_embed", "cls", "wqkv", "wo", "w1", "w2")


def init_vit_params(cfg: ViTConfig, generator: torch.Generator, device) -> Params:
    """0.02-std normal weights (drawn in f32 from ``generator`` on
    ``device``, then cast), LayerNorm gains 1, biases 0."""
    dt = cfg.compute_dtype

    def leaf(name, shape):
        if name in _VIT_DRAWN:
            return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device) * 0.02).to(dt)
        fill = torch.ones if name.endswith("_g") else torch.zeros
        return fill(shape, dtype=dt, device=device)

    shapes = vit_param_shapes(cfg)
    out = {n: leaf(n, s) for n, s in shapes.items() if n != "layers"}
    out["layers"] = {n: leaf(n, s) for n, s in shapes["layers"].items()}
    return out


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: bf16 with f32 accumulation and one rounding, f32 at
    IEEE precision."""
    return f32.matmul(x, w) if x.dtype == torch.float32 else float_dot(x, w)


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) images -> (b, n_patches, patch_dim), each patch
    flattened in (patch row, patch column, channel) order."""
    b = images.shape[0]
    p, n = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(b, n, p, n, p, cfg.channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * n, cfg.patch_dim)


def vit_encode(params: Params, cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) in [0, 1] -> (b, n_patches + 1, d_model); row 0 = CLS."""
    b = images.shape[0]
    x = _dot(patchify(cfg, images.to(cfg.compute_dtype)), params["patch_proj"]) + params["patch_bias"]
    cls = params["cls"].expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    hd = cfg.d_model // cfg.n_heads
    lay = params["layers"]
    s = x.shape[1]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in lay.items()}
        h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
        qkv = _dot(h, lp["wqkv"]) + lp["bqkv"]
        q, k, v = (t.reshape(b, s, cfg.n_heads, hd).float() for t in qkv.split(cfg.d_model, dim=-1))
        # Bidirectional attention in f32: no mask at all.
        scores = f32.einsum("bsnh,btnh->bnst", q, k) * (hd**-0.5)
        w = torch.softmax(scores, dim=-1)
        attn = f32.einsum("bnst,btnh->bsnh", w, v).reshape(b, s, cfg.d_model).to(x.dtype)
        x = x + (_dot(attn, lp["wo"]) + lp["bo"])
        h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
        ff = F.gelu(_dot(h, lp["w1"]) + lp["b1"])  # exact (erf) GELU, as HF ViT trains it
        x = x + (_dot(ff, lp["w2"]) + lp["b2"])
    return _layer_norm(x, params["final_ln_g"], params["final_ln_b"], cfg.norm_eps)


# -- VLM: ViT features as prefix embeddings for the Llama decoder ------------


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vit: ViTConfig
    lm: llama.LlamaConfig

    @property
    def n_prefix(self) -> int:
        return self.vit.n_patches + 1


def vlm_base(**overrides) -> VLMConfig:
    """ViT-B/16 encoder + Llama-3-8B decoder."""
    return dataclasses.replace(VLMConfig(vit=vit_base(), lm=llama.llama3_8b()), **overrides)


def vlm_tiny(**overrides) -> VLMConfig:
    return dataclasses.replace(VLMConfig(vit=vit_tiny(), lm=llama.llama_tiny()), **overrides)


def init_vlm_params(cfg: VLMConfig, generator: torch.Generator, device) -> Params:
    """Random VLM params from ``generator`` on ``device``: the ViT's, the
    projector's (0.02-std normal) and the LM's, drawn one layer at a time
    (``engine.decode.init_random_params``).  The values differ from the
    reference's PRNG; its trees carry over through
    ``engine.weights.vlm_params_from_numpy``."""
    from generativeaiexamples_tpu_torch.engine.decode import init_random_params

    vit = init_vit_params(cfg.vit, generator, device)
    proj = torch.randn((cfg.vit.d_model, cfg.lm.d_model), generator=generator, dtype=torch.float32, device=device)
    return {"vit": vit, "projector": (proj * 0.02).to(cfg.lm.compute_dtype),
            "lm": init_random_params(cfg.lm, generator, device)}


def vlm_prefix(params: Params, cfg: VLMConfig, images: torch.Tensor) -> torch.Tensor:
    """Encode images to Llama-space prefix embeddings (b, n_prefix, d_lm)."""
    feats = vit_encode(params["vit"], cfg.vit, images)
    proj = params["projector"]
    if feats.dtype != proj.dtype:
        feats, proj = feats.float(), proj.float()
    return _dot(feats, proj).to(cfg.lm.compute_dtype)


def vlm_caption_loss(params: Params, cfg: VLMConfig, images: torch.Tensor, input_tokens: torch.Tensor,
                     targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Next-token CE for caption / table generation conditioned on images
    (the DePlot-style fine-tune objective).  ``input_tokens`` is the
    teacher-forced text ``[BOS, t_0 .. t_{n-2}]`` and ``targets`` ``[t_0 ..
    t_{n-1}]``; gradients flow through the LM, the projector and the ViT.
    ``hidden[p]`` predicts the token at ``p + 1``: BOS sits at position
    ``n_prefix``, so ``hidden[n_prefix + i]`` predicts ``t_i``."""
    from generativeaiexamples_tpu_torch.engine.training import masked_cross_entropy

    b, n = input_tokens.shape
    dev = input_tokens.device
    prefix = vlm_prefix(params, cfg, images)
    embeds = torch.cat([prefix, llama.embed(params["lm"], input_tokens.long(), prefix.dtype)], dim=1)
    total = cfg.n_prefix + n
    positions = torch.arange(total, dtype=torch.int32, device=dev).expand(b, total)
    hidden, _ = llama.forward(params["lm"], cfg.lm, torch.zeros((b, total), dtype=torch.int32, device=dev),
                              positions, embeds=embeds)
    return masked_cross_entropy(params["lm"], hidden[:, cfg.n_prefix : cfg.n_prefix + n], targets, mask)


def vlm_prefill(params: Params, cfg: VLMConfig, images: torch.Tensor, prompt_tokens: torch.Tensor, max_len: int,
                cache: Optional[tuple] = None):
    """Prefill over [image prefix ; prompt] into a fresh cache of
    ``max_len`` slots (the preset's bf16 cache): positions ``arange(total)``,
    every row ``total`` long, zero token ids under ``embeds``.  A given
    ``cache`` of that shape is zeroed and written in place instead of a new
    one (:meth:`DecodeGraphs.cache`).  Returns (the last position's f32
    logits (b, vocab), the cache, lengths (b,))."""
    b, prompt_len = prompt_tokens.shape
    total = cfg.n_prefix + prompt_len
    dev = prompt_tokens.device
    prefix = vlm_prefix(params, cfg, images)
    tok_emb = llama.embed(params["lm"], prompt_tokens, prefix.dtype)
    embeds = torch.cat([prefix, tok_emb], dim=1)
    positions = torch.arange(total, dtype=torch.int32, device=dev).expand(b, total)
    lengths = torch.full((b,), total, dtype=torch.int32, device=dev)
    if cache is None:
        cache = llama.init_kv_cache(cfg.lm, b, max_len, device=dev)
    else:
        for leaf in cache:
            leaf.zero_()
    hidden, cache = llama.forward(
        params["lm"], cfg.lm, torch.zeros((b, total), dtype=torch.int32, device=dev), positions, cache, lengths,
        embeds=embeds,
    )
    return llama.logits(params["lm"], hidden[:, -1:, :])[:, 0], cache, lengths


def vlm_decode_step(params_lm: Params, cfg_lm: llama.LlamaConfig, cache, tok: torch.Tensor, pos: torch.Tensor):
    """One greedy decode step: ``tok`` (b,) at positions ``pos`` (b,),
    attending the whole cache (``kv_lengths = pos + 1``): f32 logits (b, vocab)."""
    hidden, _ = llama.forward(params_lm, cfg_lm, tok[:, None], pos[:, None], cache, pos + 1)
    return llama.logits(params_lm, hidden)[:, 0]


def vlm_decode(params_lm: Params, cfg_lm: llama.LlamaConfig, cache, tok: torch.Tensor, start_pos: torch.Tensor,
               n_steps: int) -> torch.Tensor:
    """Greedy decode of ``n_steps`` eager single-token steps: (n_steps, b) ids."""
    toks = torch.zeros((n_steps, start_pos.shape[0]), dtype=torch.int32, device=start_pos.device)
    pos = start_pos
    for i in range(n_steps):
        tok = vlm_decode_step(params_lm, cfg_lm, cache, tok, pos).argmax(dim=-1).to(torch.int32)
        pos = pos + 1
        toks[i] = tok
    return toks


class DecodeGraphs:
    """The greedy decode step on the card, captured as a CUDA graph once per
    (batch, cache slots) and replayed across generations: one graph launch
    a step instead of thousands of kernel launches (the eager step is
    host-bound).

    Each key owns a static cache (:meth:`cache`: the prefill zeroes it and
    writes it in place, as a fresh one), the token and position tensors and
    the graph.  The first decode at a key runs its first step eagerly on
    this object's side stream (the warm-up a capture needs) and captures
    the next there in thread-local mode, without ``torch.cuda.graph``'s
    device-wide synchronize and ``empty_cache``: other threads on the card
    (a served LLM's tick thread, the embedder) go on allocating and
    launching while it runs.  The steps equal :func:`vlm_decode`'s bit for
    bit.  Callers take turns (the vision analyst's lock)."""

    def __init__(self, params_lm: Params, cfg_lm: llama.LlamaConfig, device) -> None:
        self.params_lm, self.cfg_lm, self.device = params_lm, cfg_lm, torch.device(device)
        self.stream = torch.cuda.Stream(device=self.device)
        self.captures = 0
        self._slots: dict = {}

    def cache(self, b: int, max_len: int) -> tuple:
        """The static cache of key (b, max_len), allocated on first use."""
        slot = self._slots.get((b, max_len))
        if slot is None:
            slot = self._slots[(b, max_len)] = dict(
                cache=llama.init_kv_cache(self.cfg_lm, b, max_len, device=self.device),
                tok=torch.zeros((b,), dtype=torch.int32, device=self.device),
                pos=torch.zeros((b,), dtype=torch.int32, device=self.device), graph=None, nxt=None)
        return slot["cache"]

    def _step(self, slot) -> torch.Tensor:
        return vlm_decode_step(self.params_lm, self.cfg_lm, slot["cache"], slot["tok"], slot["pos"]).argmax(
            dim=-1).to(torch.int32)

    def _capture(self, slot, first: torch.Tensor) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            first.copy_(self._step(slot))
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                nxt = self._step(slot)
            finally:
                graph.capture_end()
        cur.wait_stream(self.stream)
        slot["graph"], slot["nxt"] = graph, nxt
        self.captures += 1

    def decode(self, cache, tok: torch.Tensor, start_pos: torch.Tensor, n_steps: int) -> torch.Tensor:
        """:func:`vlm_decode` over ``cache``, which :meth:`cache` returned."""
        b, max_len = cache[0].shape[2], cache[0].shape[3]
        slot = self._slots.get((b, max_len))
        if slot is None or slot["cache"] is not cache:
            raise ValueError("DecodeGraphs.decode takes the cache that DecodeGraphs.cache returned")
        toks = torch.zeros((n_steps, b), dtype=torch.int32, device=self.device)
        if n_steps == 0:
            return toks
        slot["tok"].copy_(tok)
        slot["pos"].copy_(start_pos)
        done = 0
        if slot["graph"] is None:
            self._capture(slot, toks[0])
            done = 1
        for i in range(done, n_steps):
            if i:
                slot["tok"].copy_(toks[i - 1])
                slot["pos"].add_(1)
            slot["graph"].replay()
            toks[i].copy_(slot["nxt"])
        return toks


@torch.inference_mode()
def vlm_generate(
    params: Params,
    cfg: VLMConfig,
    images: torch.Tensor,
    prompt_tokens: torch.Tensor,
    max_new_tokens: int = 64,
    eos_id: Optional[int] = None,
    graphs: Optional[DecodeGraphs] = None,
) -> list[list[int]]:
    """Greedy caption / table generation for a batch of images: one prefill
    over [image prefix ; prompt], then ``max_new_tokens - 1`` decode steps
    (replays of ``graphs``' captured step where given, eager otherwise),
    each row cut at its first ``eos_id``."""
    b, prompt_len = prompt_tokens.shape
    max_len = cfg.n_prefix + prompt_len + max_new_tokens
    cache = graphs.cache(b, max_len) if graphs is not None else None
    first, cache, lengths = vlm_prefill(params, cfg, images, prompt_tokens, max_len, cache=cache)
    next_tok = first.argmax(dim=-1).to(torch.int32)
    if graphs is not None:
        toks = graphs.decode(cache, next_tok, lengths, max_new_tokens - 1)
    else:
        toks = vlm_decode(params["lm"], cfg.lm, cache, next_tok, lengths, max_new_tokens - 1)
    rows = torch.cat([next_tok[None], toks], dim=0).cpu().numpy()
    out: list[list[int]] = []
    for i in range(rows.shape[1]):
        column = rows[:, i].tolist()
        if eos_id is not None and eos_id in column:
            column = column[: column.index(eos_id)]
        out.append(column)
    return out
