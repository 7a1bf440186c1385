"""The port's vision analysts (``engine/vision_service.py``) against the JAX
package's: the heuristic analyst's strings, and ``GPUVisionAnalyst(device=
"cpu")`` on the reference VLM's params (carried over, f32 tiny configs)
giving ``TPUVisionAnalyst``'s ids and strings (the port's byte tokenizer
renders ids past its vocabulary as ``<|id|>`` where the reference's
renders nothing: the strings are compared with those markers removed);
``get_vision_analyst`` from ``APP_VLM_*``."""

import re

import jax
import numpy as np
import pytest
from PIL import Image

import chip_smoke as cs
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine import tokenizer as jtokenizer
from generativeaiexamples_tpu.engine import vision_service as jvs
from generativeaiexamples_tpu.models import vision as JV
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.engine import tokenizer as ttokenizer
from generativeaiexamples_tpu_torch.engine import vision_service as tvs
from generativeaiexamples_tpu_torch.engine.weights import vlm_params_from_numpy
from tests.test_torch_vision import vlm_f32


def _images():
    chart, photo = cs.chart_pixels(np), cs.photo_pixels(np)
    return [Image.fromarray(chart), chart, photo, photo.astype(np.float32) / 255.0, Image.fromarray(photo).convert("RGB"),
            np.zeros((5, 7, 3), np.uint8)]


def test_heuristic_strings_equal_the_reference():
    j, t = jvs.HeuristicVisionAnalyst(), tvs.HeuristicVisionAnalyst()
    for img in _images():
        assert t.is_graph(img) == j.is_graph(img)
        assert t.describe_image(img) == j.describe_image(img)
        assert t.chart_to_table(img) == j.chart_to_table(img)
        np.testing.assert_array_equal(tvs._to_array(img), jvs._to_array(img))
    assert t.is_graph(Image.fromarray(cs.chart_pixels(np))) and not t.is_graph(cs.photo_pixels(np))


@pytest.fixture(scope="module")
def analysts():
    jc, tc = vlm_f32()
    jp = JV.init_vlm_params(jc, jax.random.PRNGKey(0))
    j = jvs.TPUVisionAnalyst(cfg=jc, params=jp, tokenizer=jtokenizer.ByteTokenizer(), max_new_tokens=10)
    t = tvs.GPUVisionAnalyst(cfg=tc, params=vlm_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu"),
                             tokenizer=ttokenizer.ByteTokenizer(), max_new_tokens=10, device="cpu")
    return j, t


def _unmarked(text: str) -> str:
    return re.sub(r"<\|\d+\|>", "", text)


def test_vlm_analyst_strings_equal_the_reference(analysts):
    j, t = analysts
    seen = []
    for img in _images()[:4]:
        np.testing.assert_array_equal(t._resize(img), j._resize(img))
        for prompt in (tvs.DESCRIBE_PROMPT, tvs.TABLE_PROMPT):
            ids = t.generate_ids(t._resize(img)[None], prompt)[0]
            want = j._vision.vlm_generate(j.params, j.cfg, j._resize(img)[None],
                                          np.asarray([j.tokenizer.encode(prompt)], np.int32),
                                          max_new_tokens=j.max_new_tokens)[0]
            assert ids == want
            seen += ids
        assert _unmarked(t.describe_image(img)) == j.describe_image(img)
        assert _unmarked(t.chart_to_table(img)) == j.chart_to_table(img)
        assert t.is_graph(img) == j.is_graph(img)
    assert min(seen) < 256  # some ids are bytes
    assert t.PRESETS == j.PRESETS and t.device.type == "cpu"


def test_get_vision_analyst_from_app_env(clean_app_env, monkeypatch):
    for module in (jconfiguration, tconfiguration):
        module.reset_config_cache()
    tvs.reset_vision_analyst()
    try:
        assert isinstance(tvs.get_vision_analyst("cpu"), tvs.HeuristicVisionAnalyst)
        assert tvs.get_vision_analyst() is tvs.get_vision_analyst()
        monkeypatch.setenv("APP_VLM_MODELENGINE", "tpu")
        monkeypatch.setenv("APP_VLM_MODELNAME", "vlm-tiny")
        monkeypatch.delenv("GAIE_WEIGHTS_DIR", raising=False)
        tconfiguration.reset_config_cache()
        tvs.reset_vision_analyst()
        analyst = tvs.get_vision_analyst("cpu")
        assert isinstance(analyst, tvs.GPUVisionAnalyst) and analyst.device.type == "cpu"
        assert analyst.cfg.vit.image_size == 32 and analyst.max_new_tokens == 96
        monkeypatch.setenv("APP_VLM_MODELENGINE", "neva")
        tconfiguration.reset_config_cache()
        tvs.reset_vision_analyst()
        with pytest.raises(ValueError, match="unknown vlm.model_engine"):
            tvs.get_vision_analyst("cpu")
        jconfiguration.reset_config_cache()
        jvs.reset_vision_analyst()
        with pytest.raises(ValueError, match="unknown vlm.model_engine"):
            jvs.get_vision_analyst()
    finally:
        for module in (jconfiguration, tconfiguration):
            module.reset_config_cache()
        tvs.reset_vision_analyst()
        jvs.reset_vision_analyst()


def test_the_card_is_the_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvs.GPUVisionAnalyst(model_name="vlm-tiny")
