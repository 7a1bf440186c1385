"""The VLM on the card: the greedy decode captured as CUDA graphs
(``models/vision.py::DecodeGraphs``) against eager steps on the same cache:
the same ids and the same cache, bit for bit, across generations that
replay one capture; and a capture that runs while another thread allocates
and launches on the card.

The graph path exists only on a card, so these tests skip without one (the
decision is made inside the fixture).  On a machine with one:

    python -m pytest --noconftest tests/test_torch_vision_cuda.py -q
"""

import threading

import pytest
import torch

from generativeaiexamples_tpu_torch.models import vision

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph decode has no CPU mode")
    return torch.device("cuda", 0)


def _tiny(dev):
    from generativeaiexamples_tpu_torch.models import llama

    cfg = vision.vlm_tiny(lm=llama.llama_tiny(n_heads=4, n_kv_heads=2, head_dim=128, d_model=128))
    params = vision.init_vlm_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    return cfg, params, images


def _prompt(n, dev):
    return torch.tensor([[1, 68, 101, 115, 99, 114, 105][:n]] * 2, dtype=torch.int32, device=dev)


@torch.inference_mode()
def test_graph_decode_equals_eager_steps(dev):
    """Four generations through one ``DecodeGraphs`` at two prompt lengths
    (each length twice): the ids and the cache equal eager steps' on a
    fresh cache, bit for bit, and each length is captured once."""
    cfg, params, images = _tiny(dev)
    graphs = vision.DecodeGraphs(params["lm"], cfg.lm, dev)
    n = 24
    for prompt in (_prompt(5, dev), _prompt(7, dev), _prompt(5, dev), _prompt(7, dev)):
        max_len = cfg.n_prefix + prompt.shape[1] + n
        runs = []
        for g in (None, graphs):
            cache = g.cache(2, max_len) if g is not None else None
            first, cache, lengths = vision.vlm_prefill(params, cfg, images, prompt, max_len, cache=cache)
            tok = first.argmax(-1).to(torch.int32)
            if g is not None:
                ids = g.decode(cache, tok, lengths, n)
            else:
                ids = vision.vlm_decode(params["lm"], cfg.lm, cache, tok, lengths, n)
            runs.append((ids.cpu(), [c.cpu() for c in cache]))
        assert torch.equal(runs[0][0], runs[1][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert graphs.captures == 2


@torch.inference_mode()
def test_capture_beside_a_thread_that_allocates(dev, monkeypatch):
    """While the step is being captured, another thread allocates fresh
    device memory (a ``cudaMalloc``), launches a kernel and copies to the
    host: both succeed, and the generation equals the eager one."""
    cfg, params, images = _tiny(dev)
    prompt = _prompt(5, dev)
    want = vision.vlm_generate(params, cfg, images, prompt, max_new_tokens=16)
    go, done, seen, errors = threading.Event(), threading.Event(), [], []

    def other_user():
        go.wait(60)
        try:
            x = torch.ones((3 << 28) + 7, dtype=torch.uint8, device=dev)  # ~0.8 GB: nothing cached fits
            seen.append(int(x[-1000:].sum().item()))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)
        finally:
            done.set()

    step = vision.DecodeGraphs._step

    def step_beside_other_user(self, slot):
        if torch.cuda.is_current_stream_capturing():
            go.set()
            assert done.wait(60)
        return step(self, slot)

    monkeypatch.setattr(vision.DecodeGraphs, "_step", step_beside_other_user)
    thread = threading.Thread(target=other_user)
    thread.start()
    graphs = vision.DecodeGraphs(params["lm"], cfg.lm, dev)
    try:
        got = vision.vlm_generate(params, cfg, images, prompt, max_new_tokens=16, graphs=graphs)
    finally:
        go.set()
        thread.join(60)
    assert not errors and seen == [1000] and graphs.captures == 1
    assert got == want
