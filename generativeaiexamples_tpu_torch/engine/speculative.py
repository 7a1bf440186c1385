"""Offline speculative generation: a small draft model proposes, the
target verifies (port of ``engine/speculative.py``).

Each round is the serving scheduler's (``engine.spec_decode``): the
draft decodes ``gamma`` greedy tokens into its own contiguous cache
(``_draft_round``), the target scores ``[tok, d_1..d_gamma]`` in one
verify forward, and greedy acceptance keeps the longest prefix that
agrees with the target's argmax plus the target's own next token
(``_verify_and_emit``), so the output equals target-only greedy decoding
(``engine.generator.LlamaGenerator``) token for token.  Rows advance by
their own acceptance; sampling is not offered here, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.engine import spec_decode
from generativeaiexamples_tpu_torch.engine.decode import prepare_params
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.utils.buckets import bucket_size


class SpeculativeGenerator:
    """Greedy batch generation with draft-model speculation on ``device``
    (default ``cuda``).  The target's params are laid out with
    ``quantize`` and ``pack``, the draft's with ``pack`` (float, the
    reference's draft); each cache follows its config's ``kv_dtype``.
    ``stats`` after :meth:`generate`: ``rounds``, ``emitted``,
    ``proposed`` and ``accepted`` (draft tokens proposed to and kept by
    live rows)."""

    def __init__(
        self,
        target_cfg: llama.LlamaConfig,
        draft_cfg: llama.LlamaConfig,
        target_params=None,
        draft_params=None,
        *,
        device=None,
        max_batch: int = 8,
        max_len: Optional[int] = None,
        gamma: int = 4,
        quantize: bool = False,
        pack: bool = True,
        seed: int = 0,
    ) -> None:
        if target_cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.device = resolve_device(device)
        self.tcfg = target_cfg
        self.dcfg = draft_cfg
        self.max_batch = max_batch
        self.max_len = max_len or target_cfg.max_seq_len
        self.gamma = gamma
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            self.tparams = prepare_params(target_cfg, target_params, device=self.device, quantize=quantize,
                                          pack=pack, generator=gen)
            self.dparams = prepare_params(draft_cfg, draft_params, device=self.device, pack=pack, generator=gen)
        self.stats = {"rounds": 0, "emitted": 0, "proposed": 0, "accepted": 0}

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _prefill(self, tokens, lengths):
        """Cold-prefill both models into fresh ``max_batch`` x ``max_len``
        caches; returns (tcache, dcache, the target's first tokens)."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)
        tcache = llama.init_kv_cache(self.tcfg, self.max_batch, self.max_len, device=self.device)
        hidden, _ = llama.forward(self.tparams, self.tcfg, tokens.long(), positions, tcache, lengths, kv_bucket=s,
                                  cold_prefill=True)
        last = hidden[torch.arange(b, device=self.device), (lengths.long() - 1).clamp(min=0)]
        first = torch.argmax(llama.logits(self.tparams, last[:, None, :])[:, 0], dim=-1).to(torch.int32)
        dcache = llama.init_kv_cache(self.dcfg, self.max_batch, self.max_len, device=self.device)
        llama.forward(self.dparams, self.dcfg, tokens.long(), positions, dcache, lengths, kv_bucket=s,
                      cold_prefill=True)
        return tcache, dcache, first

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_tokens: int = 64,
        eos_id: Optional[int] = None,
    ) -> list[list[int]]:
        """Greedy speculative generation; returns the token ids of each
        prompt."""
        n = len(prompts)
        if n == 0:
            return []
        if n > self.max_batch:
            raise ValueError(f"{n} prompts > max_batch {self.max_batch}")
        b, gamma, max_len = self.max_batch, self.gamma, self.max_len
        s = bucket_size(max(len(p) for p in prompts), maximum=max_len)
        tokens = np.zeros((b, s), dtype=np.int32)
        lengths = np.zeros((b,), dtype=np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            lengths[i] = len(p)
        greedy = torch.ones((b,), dtype=torch.bool, device=self.device)
        temp = torch.zeros((b,), dtype=torch.float32, device=self.device)
        top_p = torch.ones((b,), dtype=torch.float32, device=self.device)
        top_k = torch.zeros((b,), dtype=torch.int32, device=self.device)
        outputs: list[list[int]] = [[] for _ in range(b)]
        finished = np.zeros((b,), dtype=bool)
        finished[n:] = True
        self.stats = {"rounds": 0, "emitted": 0, "proposed": 0, "accepted": 0}
        with torch.inference_mode():
            tcache, dcache, tok = self._prefill(self._h2d(tokens), self._h2d(lengths))
            first = tok.cpu().numpy()
            for i in range(n):
                self._emit(outputs, finished, i, int(first[i]), max_tokens, eos_id, lengths)
            cur_len = lengths.copy()
            while not finished.all():
                kv_bucket = bucket_size(int(cur_len.max()) + gamma + 2, maximum=max_len)
                lengths0 = self._h2d(np.minimum(cur_len, max_len - 1).astype(np.int32))
                drafts, q_ids, q_probs = spec_decode._draft_round(
                    self.dparams, self.dcfg, dcache, tok, lengths0, max_len, kv_bucket, gamma, greedy, temp, top_p,
                    top_k, None, False,
                )
                out, n_emit, next_tok, _ = spec_decode._verify_and_emit(
                    self.tparams, self.tcfg, max_len, kv_bucket, gamma, tcache, tok, lengths0, drafts, q_ids, q_probs,
                    greedy, temp, top_p, top_k, None, False,
                )
                out_h, n_h = out.cpu().numpy(), n_emit.cpu().numpy()
                self.stats["rounds"] += 1
                live = ~finished
                self.stats["proposed"] += gamma * int(live.sum())
                self.stats["accepted"] += int((n_h[live] - 1).sum())
                for i in np.flatnonzero(live):
                    for j in range(int(n_h[i])):
                        self._emit(outputs, finished, i, int(out_h[i, j]), max_tokens, eos_id, lengths)
                        if finished[i]:
                            break
                # Finished rows stay where they are: they rewrite their own
                # positions, and their tokens are never read.
                cur_len = np.where(live, np.minimum(cur_len + n_h, max_len - 1), cur_len).astype(np.int32)
                tok = torch.where(self._h2d(live), next_tok, tok)
            del tcache, dcache
        self.stats["emitted"] = sum(len(o) for o in outputs[:n])
        return [outputs[i] for i in range(n)]

    def _emit(self, outputs, finished, i, tid, max_tokens, eos_id, prompt_len) -> None:
        if finished[i]:
            return
        if eos_id is not None and tid == eos_id:
            finished[i] = True
            return
        outputs[i].append(tid)
        if len(outputs[i]) >= max_tokens:
            finished[i] = True
        elif prompt_len[i] + len(outputs[i]) >= self.max_len:
            # The cache is full: the same limit, against the same prompt
            # length, as LlamaGenerator's.
            finished[i] = True
