"""Sequence/context-parallel attention: ring (ppermute) and Ulysses
(all-to-all), port of ``parallel/ring_attention.py``.

Both keep the masking contract of :func:`ops.attention.gqa_attention`:
the key at absolute position ``t`` is visible to the query at absolute
position ``p`` iff ``t <= p`` and ``t < kv_length[b]``.

* **Ring** (:func:`ring_gqa_attention`): each rank keeps its query chunk
  and rotates K/V chunks around the ``seq`` axis with ``ppermute``,
  merging per-chunk partial softmaxes with the online (flash) update.  It
  stays plain torch, as it is plain XLA in the reference: the port's
  flash kernel returns no log-sum-exp to merge.
* **Ulysses** (:func:`ulysses_gqa_attention`): two ``all_to_all``
  reshards, sequence-sharded -> head-sharded and back, around the port's
  :func:`ops.attention.attention` over the whole sequence on a head subset
  (the flash kernel on the card).  Requires ``n_kv_heads % axis_size ==
  0``.

The two take per-rank shards and ``mesh``, the rank's
:class:`~generativeaiexamples_tpu_torch.parallel.runtime.RankContext`;
:func:`sequence_parallel_attention` does the sharding for full
(replicated) arrays and gathers the result back.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def _partial_update(qg, q_pos, k_c, v_c, pos_c, kv_lengths, m, l, acc, scale):
    """One online-softmax update of (m, l, acc) against a K/V chunk.

    qg (b, sq, n_kv, group, d) f32 queries; k_c (b, sk, n_kv, d) chunk keys;
    pos_c (b, sk) absolute positions; m, l (b, n_kv, group, sq, 1) running
    max and sum; acc (b, n_kv, group, sq, d) the weighted-value sum."""
    scores = torch.einsum("bsngh,btnh->bngst", qg, k_c.float()) * scale
    visible = pos_c[:, None, :] <= q_pos[:, :, None]  # (b, sq, sk)
    if kv_lengths is not None:
        visible = visible & (pos_c[:, None, :] < kv_lengths[:, None, None])
    mask = visible[:, None, None, :, :].float()
    scores = torch.where(mask > 0, scores, torch.full_like(scores, _NEG_INF))
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    # m stays the finite sentinel until a row sees its first visible key, so
    # exp(m - m_new) is 1 there and l stays 0: no inf - inf.
    alpha = torch.exp(m - m_new)
    weights = torch.exp(scores - m_new) * mask
    l_new = l * alpha + weights.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bngst,btnh->bngsh", weights, v_c.float())
    return m_new, l_new, acc_new


def ring_gqa_attention(q, k, v, q_positions, kv_positions, kv_lengths=None, *, mesh, axis_name: str = "seq",
                       axis_size: int):
    """Ring attention over a sequence-sharded K/V (per-rank shards).

    q (b, sq, n_q, d) the local query chunk; k, v (b, sk, n_kv, d) the local
    K/V chunk; q_positions (b, sq) and kv_positions (b, sk) absolute
    positions; kv_lengths (b,) the global count of valid kv slots (None:
    all valid); ``axis_size`` the ring's size.  Returns (b, sq, n_q, d) in
    q's dtype."""
    b, sq, n_q, d = q.shape
    n_kv = k.shape[2]
    group = n_q // n_kv
    scale = d**-0.5
    qg = q.reshape(b, sq, n_kv, group, d).float()
    m = torch.full((b, n_kv, group, sq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_kv, group, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, group, sq, d), dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    k_c, v_c, pos_c = k, v, kv_positions
    for step in range(axis_size):
        m, l, acc = _partial_update(qg, q_positions, k_c, v_c, pos_c, kv_lengths, m, l, acc, scale)
        if step + 1 < axis_size:
            # Rotate the K/V chunk and its positions to the next rank (the
            # reference's last rotation returns them home; its result is
            # not read).
            k_c = mesh.ppermute(k_c, axis_name, perm)
            v_c = mesh.ppermute(v_c, axis_name, perm)
            pos_c = mesh.ppermute(pos_c, axis_name, perm)
    out = acc / l.clamp_min(1e-30)  # fully masked rows: l = 0 -> exact zeros
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, n_q, d).to(q.dtype)


def ulysses_gqa_attention(q, k, v, q_positions, kv_lengths=None, *, mesh, axis_name: str = "seq",
                          axis_size: int):
    """Ulysses sequence parallelism: all-to-all to head sharding and back.

    Per-rank shards q (b, sq, n_q, d), k/v (b, sk, n_kv, d) with sq = s/P,
    sk = t/P; requires n_kv % axis_size == 0.  A contiguous head split keeps
    GQA groups whole, since n_q/P = group * (n_kv/P).  ``q_positions`` must
    be the identity layout (contiguous chunks of arange)."""
    from generativeaiexamples_tpu_torch.ops.attention import attention

    if k.shape[2] % axis_size:
        raise ValueError(f"ulysses needs n_kv_heads % axis_size == 0, got {k.shape[2]} % {axis_size}")
    # seq-sharded -> head-sharded: split heads (axis 2), gather seq (axis 1).
    q_h = mesh.all_to_all(q, axis_name, 2, 1)
    k_h = mesh.all_to_all(k, axis_name, 2, 1)
    v_h = mesh.all_to_all(v, axis_name, 2, 1)
    pos = mesh.all_gather(q_positions, axis_name, dim=1)
    out = attention(q_h.contiguous(), k_h.contiguous(), v_h.contiguous(), pos.contiguous(), kv_lengths)
    # head-sharded -> seq-sharded.
    return mesh.all_to_all(out, axis_name, 1, 2)


def sequence_parallel_attention(q, k, v, q_positions, kv_lengths=None, *, mesh, axis_name: str = "seq",
                                strategy: str = "ring"):
    """Attention over full (b, s, h, d) arrays, sharded over ``axis_name``.

    Each rank takes its contiguous sequence chunk of q/k/v/q_positions,
    runs the chosen strategy, and the chunks' results are gathered back,
    so every rank returns the whole (b, s, n_q, d) result (the reference
    returns the same global array, sequence-sharded)."""
    axis_size = mesh.size(axis_name)
    if q.shape[1] % axis_size or k.shape[1] % axis_size:
        raise ValueError("sequence length must divide the seq mesh axis")
    i = mesh.index(axis_name)
    sq, sk = q.shape[1] // axis_size, k.shape[1] // axis_size
    q_l, qp_l = q[:, i * sq : (i + 1) * sq], q_positions[:, i * sq : (i + 1) * sq]
    k_l, v_l = k[:, i * sk : (i + 1) * sk], v[:, i * sk : (i + 1) * sk]
    if strategy == "ring":
        kv_pos = torch.arange(i * sk, (i + 1) * sk, dtype=torch.int32, device=k.device).expand(k.shape[0], sk)
        out = ring_gqa_attention(q_l, k_l, v_l, qp_l, kv_pos.contiguous(), kv_lengths, mesh=mesh,
                                 axis_name=axis_name, axis_size=axis_size)
    elif strategy == "ulysses":
        out = ulysses_gqa_attention(q_l, k_l, v_l, qp_l, kv_lengths, mesh=mesh, axis_name=axis_name,
                                    axis_size=axis_size)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return mesh.all_gather(out.contiguous(), axis_name, dim=1)


def seq_parallel_ok(mesh, q, k) -> bool:
    """The reference's test for the ring branch of ``ops.attention``: a
    populated ``seq`` axis and self-attention (q-len == kv-len > 1) whose
    length divides it."""
    n = mesh.size("seq") if mesh is not None else 1
    return n > 1 and q.shape[1] == k.shape[1] and q.shape[1] > 1 and q.shape[1] % n == 0
