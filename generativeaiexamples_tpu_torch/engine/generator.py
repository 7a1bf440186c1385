"""Offline batch generation over a fixed set of KV-cache slots (port of
``engine/generator.py``).

* **Prefill, then chunked decode**: ``generate`` cold-prefills its prompts
  (a power-of-two batch bucket, prompts padded to a length bucket) into a
  ``max_batch`` x ``max_len`` cache and then decodes every slot in chunks
  of up to ``decode_chunk_size`` steps (``engine.decode``), one host
  transfer a chunk.
* **Row-chunked prefill**: a prefill batch wider than ``prefill_chunk``
  rows goes in row chunks (:meth:`LlamaGenerator._prefill_extend` writes
  rows ``[row0, row0 + chunk)`` of the cache), so the MLP's transients
  stay one chunk's.
* **One cache per call**: the cache is a local of ``generate``, so its
  memory frees on return.
* **Per-slot sampling**: temperature / top-p / top-k are tensors; the
  sampler draws from the generator's own ``torch.Generator``.

The cache follows ``cfg.kv_dtype``: the float cache (the reference's
default) decodes with the per-step scatter, the int8 one with the
append-buffer protocol and the decode kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.engine.decode import make_decode_chunk_fn, prepare_params
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams, sample
from generativeaiexamples_tpu_torch.engine.scheduler import live_matmul_kernel
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.utils.buckets import bucket_size


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[int]
    finish_reason: str  # "stop" | "length"


class LlamaGenerator:
    """Batch generation over ``max_batch`` KV-cache slots on ``device``
    (default ``cuda``; ``"cpu"`` runs the kernels' plain versions).

    ``params`` (None: random from ``seed``) are laid out by
    ``engine.decode.prepare_params`` with ``quantize``, ``pack`` and
    ``matmul_kernel``, as in the reference."""

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params=None,
        *,
        device=None,
        max_batch: int = 8,
        max_len: Optional[int] = None,
        decode_chunk_size: int = 32,
        seed: int = 0,
        quantize: bool = False,
        pack: bool = True,
        prefill_chunk: int = 192,
        matmul_kernel: Optional[str] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.decode_chunk_size = decode_chunk_size
        self.prefill_chunk = prefill_chunk
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            self.params = prepare_params(cfg, params, device=self.device, quantize=quantize, pack=pack,
                                         matmul_kernel=matmul_kernel, generator=self._gen)
        self.matmul_kernel = live_matmul_kernel(self.params)
        self._decode_chunk = make_decode_chunk_fn(cfg, self.max_len)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _prefill(self, tokens, lengths, temp, top_p, top_k):
        """A fresh ``max_batch`` x ``max_len`` cache with rows ``[0, b)``
        cold-prefilled; returns (cache, first tokens)."""
        cache = llama.init_kv_cache(self.cfg, self.max_batch, self.max_len, device=self.device)
        return cache, self._prefill_extend(cache, tokens, lengths, temp, top_p, top_k, 0)

    def _prefill_extend(self, cache, tokens, lengths, temp, top_p, top_k, row0: int):
        """Cold-prefill another row chunk into rows ``[row0, row0 + b)`` of
        ``cache`` (in place); returns the chunk's first tokens."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)
        hidden, _ = llama.forward(self.params, self.cfg, tokens.long(), positions, cache, lengths,
                                  kv_bucket=s, cold_prefill=True, row_offset=row0)
        last = hidden[torch.arange(b, device=self.device), (lengths.long() - 1).clamp(min=0)]
        lg = llama.logits(self.params, last[:, None, :])[:, 0]
        return sample(lg, self._gen, temp, top_p, top_k)

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        sampling: SamplingParams | Sequence[SamplingParams] = SamplingParams(),
        *,
        eos_id: Optional[int] = None,
        stream_cb: Optional[Callable[[int, int], None]] = None,
    ) -> list[GenerationResult]:
        """Generate completions for up to ``max_batch`` prompts (token-id
        lists, already templated), with one shared or per-prompt
        ``SamplingParams``; ``eos_id`` stops a row (none by default);
        ``stream_cb(prompt_index, token_id)`` runs per emitted token, in
        step order."""
        n = len(prompts)
        if n == 0:
            return []
        if n > self.max_batch:
            raise ValueError(f"{n} prompts > max_batch {self.max_batch}")
        if isinstance(sampling, SamplingParams):
            sampling = [sampling] * n
        b = self.max_batch
        # Prefill computes a power-of-two batch bucket covering the live
        # prompts; the cache keeps max_batch rows and decode runs them all.
        pb = bucket_size(n, minimum=min(4, b), maximum=b)
        max_prompt = max(len(p) for p in prompts)
        if max_prompt > self.max_len:
            raise ValueError(f"prompt length {max_prompt} > max_len {self.max_len}")
        s = bucket_size(max_prompt, maximum=self.max_len, dense=True)
        tokens = np.zeros((pb, s), dtype=np.int32)
        lengths = np.zeros((b,), dtype=np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            lengths[i] = len(p)
        temp = np.array([sampling[i].temperature if i < n else 0.0 for i in range(b)], dtype=np.float32)
        top_p = np.array([sampling[i].top_p if i < n else 1.0 for i in range(b)], dtype=np.float32)
        top_k = np.array([sampling[i].top_k if i < n else 0 for i in range(b)], dtype=np.int32)
        max_new = max(sp.max_tokens for sp in sampling)
        temp_d, top_p_d, top_k_d = self._h2d(temp), self._h2d(top_p), self._h2d(top_k)

        with torch.inference_mode():
            chunk = pb
            while chunk > self.prefill_chunk and chunk % 2 == 0:
                chunk //= 2
            parts = []
            cache = None
            for r0 in range(0, pb, chunk):
                rows = slice(r0, r0 + chunk)
                args = (self._h2d(tokens[rows]), self._h2d(lengths[rows]), temp_d[rows], top_p_d[rows],
                        top_k_d[rows])
                if cache is None:
                    cache, tok_c = self._prefill(*args)
                else:
                    tok_c = self._prefill_extend(cache, *args, r0)
                parts.append(tok_c.to(torch.int32))
            tok = torch.zeros((b,), dtype=torch.int32, device=self.device)
            tok[:pb] = torch.cat(parts)

            outputs: list[list[int]] = [[] for _ in range(b)]
            finished = np.zeros((b,), dtype=bool)
            finished[n:] = True
            reasons = ["length"] * b
            # Every slot advances one position a step (finished slots write
            # masked garbage, clamped at max_len - 1).
            write_pos = lengths.copy()

            def process_row(row: np.ndarray) -> None:
                for i in range(n):
                    if finished[i]:
                        continue
                    tid = int(row[i])
                    if eos_id is not None and tid == eos_id and sampling[i].stop_on_eos:
                        finished[i] = True
                        reasons[i] = "stop"
                        continue
                    outputs[i].append(tid)
                    if stream_cb is not None:
                        stream_cb(i, tid)
                    if len(outputs[i]) >= sampling[i].max_tokens:
                        finished[i] = True
                    elif lengths[i] + len(outputs[i]) >= self.max_len:
                        finished[i] = True  # cache full: the last slot is written

            process_row(tok.cpu().numpy())
            emitted = 1
            while not finished.all() and emitted < max_new:
                # Power-of-two chunk lengths: a short remainder takes a short chunk.
                remaining = max_new - emitted
                n_steps = 4
                while n_steps < remaining and n_steps < self.decode_chunk_size:
                    n_steps *= 2
                n_steps = min(n_steps, self.decode_chunk_size)
                kv_bucket = bucket_size(int(write_pos.max()) + n_steps, maximum=self.max_len)
                cache, toks = self._decode_chunk(
                    self.params, cache, tok, self._h2d(write_pos), self._gen, temp_d, top_p_d, top_k_d, n_steps,
                    kv_bucket,
                )
                tok = toks[-1].to(torch.int32)
                write_pos = np.minimum(write_pos + n_steps, self.max_len - 1)
                for row in toks.cpu().numpy():
                    process_row(row)
                    emitted += 1
                    if finished.all() or emitted >= max_new:
                        break
            del cache
        return [GenerationResult(outputs[i], reasons[i]) for i in range(n)]
