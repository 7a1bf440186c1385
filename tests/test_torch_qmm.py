"""The port's W8A8 matmul (``ops/qmm.py``) against the JAX reference.

The plain path must be bit-identical to JAX ``q_matmul`` both through the
interpret-mode Pallas kernel and through the XLA twin ``_qmm_xla``; the
CUDA kernel is held to the same plain path on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import qmm as jqmm
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models.llama import LlamaConfig
from generativeaiexamples_tpu_torch.ops import qmm as tqmm
from generativeaiexamples_tpu_torch.ops import quant as tquant

SHAPES = [
    (1, 64, 96),
    (5, 200, 300),
    (8, 128, 384),
    (32, 256, 512),
    (4, 4096, 6144),  # Llama-3-8B wqkv width at decode M
]


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n), dtype=np.float32)
    x = rng.standard_normal((m, k), dtype=np.float32)
    return w, x


def _port_blocked(w):
    return tqmm.block_matrix(tquant.quantize_matrix(torch.from_numpy(w)))


CASES = [(shape, path) for shape in SHAPES[:4] for path in ("interpret", "xla_twin")]
CASES.append((SHAPES[4], "xla_twin"))  # the 8B-width projection: interpret mode is slow


@pytest.mark.parametrize("shape,jax_path", CASES)
def test_plain_bit_identical_to_jax(monkeypatch, shape, jax_path):
    m, k, n = shape
    w, x = _operands(m, k, n)
    jbw = jqmm.block_matrix(jquant.quantize_matrix(jnp.asarray(w)))
    if jax_path == "interpret":
        monkeypatch.setenv("GAIE_QMM_INTERPRET", "1")
        ref = np.asarray(jqmm.q_matmul(jnp.asarray(x), jbw))
    else:
        xq, a_scale = jqmm.quantize_activations(jnp.asarray(x))
        xq = jnp.pad(xq, ((0, 0), (0, jbw.tiles.shape[1] - k)))
        ref = np.asarray(jqmm._qmm_xla(xq, a_scale, jbw.tiles, jbw.scale, jnp.float32))[:, :n]
    out = tqmm.q_matmul(torch.from_numpy(x), _port_blocked(w))
    assert out.shape == (m, n)
    assert torch.equal(out, torch.from_numpy(ref.copy()))


@pytest.mark.parametrize("m,k,n", SHAPES[:3])
def test_converted_reference_layout_bit_identical(m, k, n):
    """Reference tiles carried across by params_from_numpy give the same
    product as the port's own blocking."""
    w, x = _operands(m, k, n, seed=1)
    jbw = jqmm.block_matrix(jquant.quantize_matrix(jnp.asarray(w)))
    tree = {
        "embed": np.zeros((4, 8), np.float32),
        "layers": {"attn_norm": np.ones((1, 8), np.float32), "wo": jax.tree.map(np.asarray, jbw)},
    }
    conv = params_from_numpy(tree, LlamaConfig(vocab_size=4, n_layers=1), "cpu")["layers"]["wo"]
    own = _port_blocked(w)
    assert torch.equal(conv.w, own.w) and torch.equal(conv.scale, own.scale)
    xt = torch.from_numpy(x)
    assert torch.equal(tqmm.q_matmul(xt, conv), tqmm.q_matmul(xt, own))


def test_quantize_activations_bitwise():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((7, 300)) * 3).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # exact halves after scaling stay ties
    jq, js = jqmm.quantize_activations(jnp.asarray(x))
    tq, ts = tqmm.quantize_activations(torch.from_numpy(x))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


def test_block_matrix_layout():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((200, 300), dtype=np.float32)
    before = tqmm.BLOCK_EVENTS["count"]
    bw = _port_blocked(w)
    assert tqmm.BLOCK_EVENTS["count"] == before + 1
    assert bw.w.shape == (320, 256) and bw.scale.shape == (320,)  # N->5x64, K->128x2
    assert bw.shape == (200, 300) and bw.w.is_contiguous()
    qm = tquant.quantize_matrix(torch.from_numpy(w))
    assert torch.equal(bw.w[:300, :200], qm.q.t())
    assert not bw.w[300:].any() and not bw.w[:, 200:].any()
    assert float(bw.scale[300:].abs().max()) == 0.0
    assert tqmm.block_matrix(bw) is bw and tqmm.BLOCK_EVENTS["count"] == before + 1
    with pytest.raises(TypeError, match="QuantizedMatrix"):
        tqmm.block_matrix(torch.zeros(4, 4))
    jq = jquant.quantize_matrix(jnp.asarray(w))
    assert np.array_equal(np.asarray(jq.q), qm.q.numpy())
    assert np.array_equal(np.asarray(jq.scale), qm.scale.numpy())
    assert np.array_equal(
        np.asarray(jquant.dequantize(jq, jnp.float32)), tquant.dequantize(qm, torch.float32).numpy()
    )


def test_q_dot_names_projection():
    qm = tquant.quantize_matrix(torch.randn(64, 96))
    with pytest.raises(ValueError, match="projection 'wqkv'"):
        tquant.q_dot(torch.zeros(2, 48), qm, "wqkv")
    with pytest.raises(ValueError, match="projection 'w_gu'"):
        tquant.q_dot(torch.zeros(2, 48), tqmm.block_matrix(qm), "w_gu")


def test_q_dot_takes_only_blocked_weights():
    qm = tquant.quantize_matrix(torch.randn(48, 96))
    with pytest.raises(TypeError, match="projection 'wo'.*pre-blocked"):
        tquant.q_dot(torch.zeros(2, 48), qm, "wo")
    with pytest.raises(TypeError, match="pre-blocked"):
        tquant.q_dot(torch.zeros(2, 48), torch.zeros(48, 96), "wo")
    out = tquant.q_dot(torch.ones(2, 48), tqmm.block_matrix(qm), "wo")
    assert out.shape == (2, 96) and out.dtype == torch.float32


# The four Llama-3-8B projections (K, N) and odd shapes: (m, k_pad, n_pad).
LLAMA3_8B_PROJECTIONS = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w_gu": (4096, 28672), "w_down": (14336, 4096)}
PLAN_CASES = [(32, k, n) for k, n in LLAMA3_8B_PROJECTIONS.values()] + [
    (1, 128, 64),  # one K step, one ragged tile
    (5, 256, 320),  # ragged N: the last 128-channel tile half padding
    (64, 384, 64),  # the decode design's widest token side
    (65, 4096, 6144),  # the first wide M
    (2048, 14336, 4096),
    (17, 128 * 13, 192),  # K steps that split unevenly
]


@pytest.mark.parametrize("m,k_pad,n_pad", PLAN_CASES)
def test_qmm_plan_covers_k_in_whole_steps(m, k_pad, n_pad):
    plan = tqmm.qmm_plan(m, n_pad, k_pad)
    assert plan.design == ("decode" if m <= tqmm.DECODE_MAX_M else "wide")
    assert len(plan.splits) == plan.split
    bounds = [b for split in plan.splits for b in split]
    assert bounds[0] == 0 and bounds[-1] == k_pad  # the splits cover k_pad exactly, in order
    assert all(bounds[i] == bounds[i + 1] for i in range(1, len(bounds) - 1, 2))
    for k0, k1 in plan.splits:
        assert k0 % tqmm.BK == 0 and k1 % tqmm.BK == 0 and k1 > k0  # whole BK steps, none empty
    assert 1 <= plan.split <= tqmm.MAX_CLUSTER  # a split-K cluster is at most 8 blocks
    assert plan.smem_bytes <= 227 * 1024
    n_tiles = -(-n_pad // plan.tile_n)
    if plan.design == "decode":
        assert plan.grid == (plan.split, n_tiles) and m <= plan.tile_m <= 64 and plan.tile_n == tqmm.TILE_N
    else:
        assert plan.split == 1 and plan.grid == (-(-m // plan.tile_m), n_tiles)
        assert (plan.tile_m, plan.tile_n) in tqmm.WIDE_TILES


@pytest.mark.parametrize("proj", sorted(LLAMA3_8B_PROJECTIONS))
def test_qmm_plan_fills_the_card_at_decode(proj):
    """At a decode step's M every Llama-3-8B projection launches at least
    one block per SM of an H100, with the fewest splits that do."""
    k, n = LLAMA3_8B_PROJECTIONS[proj]
    plan = tqmm.qmm_plan(32, n, k)
    assert plan.design == "decode" and plan.blocks >= tqmm.SMS
    if plan.split > 1:
        assert plan.grid[1] * (plan.split - 1) < tqmm.SMS


def test_qmm_plan_refuses_unpadded_shapes():
    with pytest.raises(ValueError, match="qmm_plan"):
        tqmm.qmm_plan(4, 64, 100)
    with pytest.raises(ValueError, match="qmm_plan"):
        tqmm.qmm_plan(4, 100, 128)
