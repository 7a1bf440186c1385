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
