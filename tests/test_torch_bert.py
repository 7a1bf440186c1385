"""The port's BERT encoder (``models/bert.py``) against the JAX package on
the CPU.

Both packages get the same weights (the reference's init, carried across
with ``bert_params_from_numpy`` / ``rerank_head_from_numpy``) and the same
tokens, with padded rows (one row of a single real token).  In float32 the
hidden states, pooled embeddings (cls and mean) and rerank scores agree
within atol 1e-5.  In bfloat16 they agree within the stated BF16 bounds:
the two packages round the bf16 sums of the embedding lookup, the GELU and
the bias adds at different points (XLA fuses them), which moves a hidden
value by a few bf16 steps (2^-6 at magnitude 4) and a unit-norm embedding
element by a few 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu_torch.engine.weights import bert_params_from_numpy, rerank_head_from_numpy
from generativeaiexamples_tpu_torch.models import bert as tbert

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = {"hidden": dict(atol=6e-2, rtol=2e-2), "embed": dict(atol=1e-2, rtol=0), "score": dict(atol=2e-3, rtol=2e-2)}


def _tol(dtype, what):
    return F32 if dtype == "float32" else BF16[what]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    mask[3, 1:] = 0  # one real token
    types = np.zeros((4, 32), np.int32)
    types[:, 12:] = 1
    return tokens, mask, types


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request, inputs):
    """Both packages' params, and every reference output the tests compare
    with, computed in one jitted call per dtype."""
    dtype = request.param
    jcfg, tcfg = jbert.bert_tiny(dtype=dtype), tbert.bert_tiny(dtype=dtype)
    jp = jbert.init_params(jcfg, jax.random.PRNGKey(0))
    jh = jbert.init_rerank_head(jcfg, jax.random.PRNGKey(1))
    tp = bert_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    th = rerank_head_from_numpy(jax.tree.map(np.asarray, jh), "cpu")
    bare = {k: jh[k] for k in ("w", "b")}

    @jax.jit
    def reference(tokens, mask, types):
        out, hidden = {}, {}
        for seg, tt in (("none", None), ("segments", types)):
            hidden[seg] = jbert.encode(jp, jcfg, tokens, mask, tt)
            out[f"hidden/{seg}"] = hidden[seg].astype(jnp.float32)
            for pooler, head in (("pooler", jh), ("bare", bare)):
                out[f"score/{pooler}/{seg}"] = jbert.rerank_score(jp, head, jcfg, tokens, mask, tt)
        for method in ("cls", "mean"):
            for normalize in (True, False):
                out[f"pool/{method}/{normalize}"] = jbert.pool(hidden["none"], mask, method, normalize)
            out[f"embed/{method}"] = jbert.embed(jp, jbert.bert_tiny(dtype=dtype, pooling=method), tokens, mask)
        return out

    ref = {k: np.asarray(v) for k, v in reference(*(jnp.asarray(a) for a in inputs)).items()}
    return dtype, (jcfg, jp, jh), (tcfg, tp, th), ref


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("segments", [False, True])
def test_encode_matches_reference(models, inputs, segments):
    dtype, _, (tcfg, tp, _), ref = models
    tokens, mask, types = inputs
    got = tbert.encode(tp, tcfg, _t(tokens), _t(mask), _t(types) if segments else None)
    assert got.dtype == tcfg.compute_dtype and got.shape == (4, 32, tcfg.d_model)
    want = ref["hidden/segments" if segments else "hidden/none"]
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype, "hidden"))


@pytest.mark.parametrize("method", ["cls", "mean"])
def test_pool_and_embed_match_reference(models, inputs, method):
    dtype, _, (tcfg, tp, _), ref = models
    tokens, mask, _ = inputs
    hidden = torch.from_numpy(ref["hidden/none"].copy()).to(tcfg.compute_dtype)
    for normalize in (True, False):
        got = tbert.pool(hidden, _t(mask), method, normalize)
        assert got.dtype == torch.float32
        # The same hidden states in: the pooling alone differs only in its
        # summation order.
        np.testing.assert_allclose(got.numpy(), ref[f"pool/{method}/{normalize}"],
                                   atol=1e-5 if dtype == "float32" else 1e-2, rtol=1e-5)
    got = tbert.embed(tp, tbert.bert_tiny(dtype=dtype, pooling=method), _t(tokens), _t(mask)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref[f"embed/{method}"], **_tol(dtype, "embed"))


@pytest.mark.parametrize("pooler", [True, False])
@pytest.mark.parametrize("segments", [False, True])
def test_rerank_score_matches_reference(models, inputs, pooler, segments):
    dtype, _, (tcfg, tp, th), ref = models
    tokens, mask, types = inputs
    if not pooler:
        th = {k: v for k, v in th.items() if k in ("w", "b")}
    got = tbert.rerank_score(tp, th, tcfg, _t(tokens), _t(mask), _t(types) if segments else None)
    assert got.dtype == torch.float32 and got.shape == (4,)
    want = ref[f"score/{'pooler' if pooler else 'bare'}/{'segments' if segments else 'none'}"]
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype, "score"))


def test_bert_params_from_numpy_round_trip(models):
    dtype, (jcfg, jp, jh), (tcfg, tp, th), _ = models
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat) == 5 + 16
    for path, leaf in flat:
        keys = [p.key for p in path]
        got = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        want = np.asarray(leaf.astype(jnp.float32))
        assert got.dtype == tcfg.compute_dtype
        assert np.array_equal(got.float().numpy(), want), keys  # bit for bit
    for name, leaf in jh.items():
        assert np.array_equal(th[name].float().numpy(), np.asarray(leaf.astype(jnp.float32)))
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"]["wq"] = bad["layers"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        bert_params_from_numpy(bad, tcfg, "cpu")


def test_init_params_shapes_and_norms():
    cfg = tbert.bert_tiny()
    params = tbert.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = tbert.param_shapes(cfg)
    jaxes = jbert.param_axes(jbert.bert_tiny())
    assert {k: v[0] for k, v in jaxes.items() if k != "layers"} == {k: v for k, v in shapes.items() if k != "layers"}
    assert {k: v[0] for k, v in jaxes["layers"].items()} == shapes["layers"]
    for name, shape in shapes["layers"].items():
        leaf = params["layers"][name]
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.bfloat16
        if name.endswith("norm_g"):
            assert bool((leaf == 1).all())
        elif name.endswith("norm_b"):
            assert bool((leaf == 0).all())
        else:
            assert 0.01 < leaf.float().std().item() < 0.03
    head = tbert.init_rerank_head(cfg, torch.Generator().manual_seed(1), "cpu")
    assert {k: tuple(v.shape) for k, v in head.items()} == tbert.rerank_head_shapes(cfg)
