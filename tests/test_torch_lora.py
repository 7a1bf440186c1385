"""The port's LoRA (``engine/lora.py``) against the JAX package's, on the
CPU: the counterparts of ``tests/test_lora.py`` over the Llama, Gemma and
StarCoder2 tiny families (f32, 2 layers), the same numpy-seeded base
params, the JAX adapters carried over (``engine.weights.
lora_params_from_numpy``), and adapter files read in both directions.

Tolerances (f32): merged weights within 1e-6 of JAX's (one product of
rank 4 and an add; measured ~1e-8); two LoRA steps at lr 5e-3 against
JAX's jitted step: loss and grad norm within 1e-5 relative, the adapters
within 0.1 x lr a step (Adam's normalized step on near-zero gradients;
see ``tests/test_torch_training.py``); files bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import lora as jlora
from generativeaiexamples_tpu.engine import training as jt
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.engine import lora as tlora
from generativeaiexamples_tpu_torch.engine import training as tt
from generativeaiexamples_tpu_torch.engine import weights as tw
from generativeaiexamples_tpu_torch.models import llama as tl
from test_torch_training import numpy_tree, one_intra_op_thread  # noqa: F401 (autouse)

FAMILIES = ("llama_tiny", "gemma_tiny", "starcoder2_tiny")
LR = 5e-3


@pytest.fixture(scope="module", params=FAMILIES)
def tiny(request):
    name = request.param
    jc = getattr(jl, name)(dtype="float32", n_layers=2, max_seq_len=64)
    tc = getattr(tl, name)(dtype="float32", n_layers=2, max_seq_len=64)
    tree = numpy_tree(tl.param_shapes(tc), seed=FAMILIES.index(name), gains=tl.NORM_GAINS)
    return name, jc, tc, tree, tw.params_from_numpy(tree, tc, "cpu")


def _adapters(jc, lcfg, seed: int = 1):
    ja = jlora.init_lora_params(jc, lcfg, jax.random.PRNGKey(seed))
    return ja, tw.lora_params_from_numpy(jax.tree.map(np.asarray, ja), "cpu")


class TestAdapters:
    def test_zero_b_is_identity(self, tiny):
        _, jc, tc, _, params = tiny
        lcfg = tlora.LoRAConfig(rank=4, targets=("wq", "w_up"))
        adapters = tlora.init_lora_params(tc, lcfg, torch.Generator().manual_seed(1), "cpu")
        assert torch.count_nonzero(adapters["wq"]["a"]) > 0 and not adapters["wq"]["b"].any()
        merged = tlora.merge_lora(params, adapters, lcfg)
        assert torch.equal(merged["layers"]["wq"], params["layers"]["wq"])

    def test_nonzero_b_changes_targets_only_as_jax_does(self, tiny):
        _, jc, tc, tree, params = tiny
        lcfg = jlora.LoRAConfig(rank=4, targets=("wq", "w_down"))
        ja, ta = _adapters(jc, lcfg)
        ja["wq"]["b"] = jnp.ones_like(ja["wq"]["b"]) * 0.01
        ta["wq"]["b"] = torch.ones_like(ta["wq"]["b"]) * 0.01
        want = jlora.merge_lora(jax.tree.map(jnp.asarray, tree), ja, lcfg)
        got = tlora.merge_lora(params, ta, tlora.LoRAConfig(rank=4, targets=("wq", "w_down")))
        assert not torch.allclose(got["layers"]["wq"], params["layers"]["wq"])
        assert torch.equal(got["layers"]["wk"], params["layers"]["wk"])
        for name in ("wq", "w_down", "wk"):
            np.testing.assert_allclose(got["layers"][name].numpy(), np.asarray(want["layers"][name]), rtol=0,
                                       atol=1e-6)

    def test_unknown_target_rejected(self):
        with pytest.raises(ValueError, match="unknown LoRA targets"):
            tlora.LoRAConfig(targets=("nonexistent",))

    def test_absent_leaves_rejected_as_jax_does(self):
        for jc, tc, targets in ((jl.llama_moe_tiny(), tl.llama_moe_tiny(), ("wq", "w_up")),
                                (jl.starcoder2_tiny(), tl.starcoder2_tiny(), ("w_gate",))):
            with pytest.raises(ValueError) as want:
                jlora.init_lora_params(jc, jlora.LoRAConfig(targets=targets), jax.random.PRNGKey(0))
            with pytest.raises(ValueError) as got:
                tlora.init_lora_params(tc, tlora.LoRAConfig(targets=targets), torch.Generator(), "cpu")
            assert str(got.value)[:30] == str(want.value)[:30]

    def test_save_load_round_trip_and_across_packages(self, tiny, tmp_path):
        _, jc, _, _, _ = tiny
        lcfg = jlora.LoRAConfig(rank=4, targets=("wq", "wo"))
        ja, ta = _adapters(jc, lcfg)
        ta["wq"]["b"].normal_(generator=torch.Generator().manual_seed(3))
        ja["wq"]["b"] = jnp.asarray(ta["wq"]["b"].numpy())
        tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
        tlora.save_lora(ta, tpath)
        jlora.save_lora(ja, jpath)
        for loaded in (tlora.load_lora(tpath, device="cpu"), tlora.load_lora(jpath, device="cpu")):
            for name in ta:
                for ab in ("a", "b"):
                    assert torch.equal(loaded[name][ab], ta[name][ab])
        from_port = jlora.load_lora(tpath)
        for name in ja:
            for ab in ("a", "b"):
                np.testing.assert_array_equal(np.asarray(from_port[name][ab]), np.asarray(ja[name][ab]))

    def test_bf16_files_through_a_uint16_view(self, tmp_path):
        """bf16 adapters: the port reads the reference's file bit for bit and
        writes the same bytes (numpy stores them as 2-byte records)."""
        jc = jl.llama_tiny(n_layers=2)
        lcfg = jlora.LoRAConfig(rank=4, targets=("wq", "wv"))
        ja = jlora.init_lora_params(jc, lcfg, jax.random.PRNGKey(2))
        assert ja["wq"]["a"].dtype == jnp.bfloat16
        jpath, tpath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
        jlora.save_lora(ja, jpath)
        got = tlora.load_lora(jpath, device="cpu")
        for name in ja:
            for ab in ("a", "b"):
                want_bits = np.asarray(ja[name][ab]).view(np.uint16)
                assert got[name][ab].dtype == torch.bfloat16
                assert np.array_equal(got[name][ab].view(torch.int16).numpy().view(np.uint16), want_bits)
        tlora.save_lora(got, tpath)
        with np.load(jpath) as want, np.load(tpath) as mine:
            assert sorted(want.files) == sorted(mine.files)
            for key in want.files:
                assert want[key].dtype == mine[key].dtype and want[key].tobytes() == mine[key].tobytes()
        assert tlora.load_lora(tpath, dtype=torch.float32, device="cpu")["wq"]["a"].dtype == torch.float32


class TestLoRATraining:
    def test_loss_decreases_and_base_frozen(self, tiny):
        _, _, tc, _, params = tiny
        lcfg = tlora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
        opt = tt.make_optimizer(learning_rate=LR)
        state = tlora.init_lora_train_state(tc, lcfg, opt, torch.Generator().manual_seed(2), device="cpu")
        step = tlora.make_lora_train_step(tc, lcfg, opt, params)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, tc.vocab_size, (4, 16)).astype(np.int32),
                 "targets": rng.integers(0, tc.vocab_size, (4, 16)).astype(np.int32),
                 "mask": np.ones((4, 16), np.float32)}
        before = {k: v.clone() for k, v in params["layers"].items()}
        losses = []
        for _ in range(8):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0], losses
        for k, v in before.items():
            assert torch.equal(params["layers"][k], v) and not params["layers"][k].requires_grad
        assert set(state.params) == {"wq", "wv"}

    def test_steps_match_the_jitted_jax_step(self):
        jc = jl.llama_tiny(dtype="float32", n_layers=2, max_seq_len=64)
        tc = tl.llama_tiny(dtype="float32", n_layers=2, max_seq_len=64)
        tree = numpy_tree(tl.param_shapes(tc), seed=7, gains=tl.NORM_GAINS)
        params = tw.params_from_numpy(tree, tc, "cpu")
        lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wk", "wv", "wo"))
        tcfg = tlora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wk", "wv", "wo"))
        jopt, topt = jt.make_optimizer(LR), tt.make_optimizer(LR)
        js = jlora.init_lora_train_state(jc, lcfg, jopt, jax.random.PRNGKey(4))
        ts = tw.train_state_from_numpy(jax.tree.map(np.asarray, js),
                                       tw.lora_params_from_numpy(jax.tree.map(np.asarray, js.params), "cpu"), "cpu")
        jstep = jax.jit(jlora.make_lora_train_step(jc, lcfg, jopt, jax.tree.map(jnp.asarray, tree)))
        tstep = tlora.make_lora_train_step(tc, tcfg, topt, params)
        batch = tlora.sft_batch([([5, 6, 7, 8], [9, 10, 11]), ([1, 2], [3, 4, 5, 6, 7])], max_len=12)
        jbatch = jlora.sft_batch([([5, 6, 7, 8], [9, 10, 11]), ([1, 2], [3, 4, 5, 6, 7])], max_len=12)
        for _ in range(2):
            js, jm = jstep(js, jbatch)
            ts, tm = tstep(ts, batch)
            for key in ("loss", "grad_norm"):
                assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
        for name in js.params:
            for ab in ("a", "b"):
                np.testing.assert_allclose(ts.params[name][ab].numpy(), np.asarray(js.params[name][ab]), rtol=0,
                                           atol=2 * 0.1 * LR)

    def test_sft_masking_and_batch_match_jax(self):
        for args in (([5, 6, 7], [8, 9], 8), ([1, 2, 3, 4, 5], [6, 7, 8, 9], 6), ([], [1, 2], 4)):
            want, got = jlora.sft_example(*args), tlora.sft_example(*args)
            for key in want:
                assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), (args, key)
        row = tlora.sft_example([5, 6, 7], [8, 9], max_len=8)
        np.testing.assert_array_equal(row["mask"][:4], [0.0, 0.0, 1.0, 1.0])
        pairs = [([1, 2], [3]), ([4], [5, 6, 7])]
        want, got = jlora.sft_batch(pairs, max_len=6), tlora.sft_batch(pairs, max_len=6)
        assert got["tokens"].shape == (2, 6) and got["mask"].dtype == torch.float32
        for key in want:
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
