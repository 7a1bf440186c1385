"""Vision analysis services for multimodal ingestion (port of
``engine/vision_service.py``).

Two backends behind one :class:`VisionAnalyst` interface (is the image a
chart, describe it, linearize a chart into a data table):

* ``tpu`` — :class:`GPUVisionAnalyst`, the in-process VLM
  (``models.vision``: ViT encoder + Llama decoder) on the card, greedy
  decoding with the reference's role prompts;
* ``heuristic`` — :class:`HeuristicVisionAnalyst`, deterministic image
  statistics (size, palette, edge density, intensity profiles): a numpy
  copy of the reference's, string for string.

Random VLM weights draw from a seeded ``torch.Generator`` on the device
(values other than the reference's PRNG's); a provisioned checkpoint's
``vit/`` and ``lm/`` parts load through ``engine.weights``.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Protocol

import numpy as np

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


class VisionAnalyst(Protocol):
    def describe_image(self, image) -> str: ...

    def is_graph(self, image) -> bool: ...

    def chart_to_table(self, image) -> str: ...


def _to_array(image) -> np.ndarray:
    """PIL image or array -> (H, W, 3) float32 in [0, 1]."""
    if hasattr(image, "convert"):
        image = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
    else:
        image = np.asarray(image, dtype=np.float32)
        if image.max() > 1.5:
            image = image / 255.0
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
    return image


class HeuristicVisionAnalyst:
    """Deterministic image analysis from pixel statistics.

    Produces stable, information-bearing text so retrieval over captions
    works end-to-end without any model weights.
    """

    def __init__(self) -> None:
        # One-entry cache: ingestion calls is_graph / describe_image /
        # chart_to_table back-to-back on the same image; holding a strong
        # ref to the image keys the cache safely (no id() reuse).
        self._last: Optional[tuple] = None

    def _arr_stats(self, image) -> tuple[np.ndarray, dict]:
        if self._last is not None and self._last[0] is image:
            return self._last[1], self._last[2]
        arr = _to_array(image)
        st = self._stats(arr)
        self._last = (image, arr, st)
        return arr, st

    def _stats(self, arr: np.ndarray) -> dict:
        h, w, _ = arr.shape
        gray = arr.mean(axis=-1)
        gx = np.abs(np.diff(gray, axis=1)).mean()
        gy = np.abs(np.diff(gray, axis=0)).mean()
        quant = (arr * 7).astype(np.int32)
        colors = len(
            np.unique(quant.reshape(-1, 3).view([("", quant.dtype)] * 3))
        )
        return {
            "h": h,
            "w": w,
            "mean": arr.mean(axis=(0, 1)),
            "edge_x": gx,
            "edge_y": gy,
            "colors": colors,
        }

    def is_graph(self, image) -> bool:
        """Charts are sparse-palette images with strong axis-aligned
        structure (long horizontal/vertical runs of constant color)."""
        arr, st = self._arr_stats(image)
        gray = arr.mean(axis=-1)
        # Fraction of rows/cols that are near-constant (axes, gridlines,
        # bar edges) — photographs rarely have any.
        row_flat = (np.ptp(gray, axis=1) < 0.08).mean()
        col_flat = (np.ptp(gray, axis=0) < 0.08).mean()
        return bool(
            st["colors"] <= 64 and (row_flat > 0.08 or col_flat > 0.08)
        )

    def describe_image(self, image) -> str:
        arr, st = self._arr_stats(image)
        r, g, b = st["mean"]
        dominant = ("red", "green", "blue")[int(np.argmax([r, g, b]))]
        kind = "chart or diagram" if self.is_graph(image) else "image"
        return (
            f"A {st['w']}x{st['h']} {kind} with {st['colors']} distinct "
            f"colors, predominantly {dominant} "
            f"(rgb {r:.2f},{g:.2f},{b:.2f}), edge density "
            f"{st['edge_x'] + st['edge_y']:.3f}."
        )

    def chart_to_table(self, image) -> str:
        """Linearized column-profile table (DePlot output shape: header row
        then value rows separated by ' | ')."""
        arr, _ = self._arr_stats(image)
        gray = 1.0 - arr.mean(axis=-1)  # ink density
        n_bins = min(8, gray.shape[1])
        cols = np.array_split(np.arange(gray.shape[1]), n_bins)
        rows = ["bin | ink"]
        for i, c in enumerate(cols):
            rows.append(f"{i} | {gray[:, c].mean():.3f}")
        return "\n".join(rows)


class GPUVisionAnalyst:
    """VLM-backed analyst: the ViT + Llama decoder with role prompts, on
    ``device`` (the card unless ``"cpu"``)."""

    PRESETS = ("vlm-tiny", "vlm-base")

    def __init__(
        self,
        cfg=None,
        params=None,
        tokenizer=None,
        max_new_tokens: int = 96,
        seed: int = 0,
        model_name: str = "vlm-tiny",
        device=None,
    ) -> None:
        from generativeaiexamples_tpu_torch.core.device import resolve_device
        from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
        from generativeaiexamples_tpu_torch.models import vision

        self._vision = vision
        self.device = resolve_device(device)
        if cfg is None:
            cfg = vision.vlm_base() if model_name == "vlm-base" else vision.vlm_tiny()
        self.cfg = cfg
        if params is None:
            params = self._load_or_init(model_name, seed)
        self.params = params
        self.tokenizer = tokenizer or get_tokenizer()
        self.max_new_tokens = max_new_tokens
        # is_graph stays the calibrated heuristic until a classifier head
        # is trained, as in the reference.
        self._heuristic = HeuristicVisionAnalyst()
        # One image at a time on the card: the chain server ingests on
        # several threads.
        self._lock = threading.Lock()
        # The decode step captured once per prompt length and replayed
        # across images (on the card only).
        self.graphs = (vision.DecodeGraphs(params["lm"], cfg.lm, self.device)
                       if self.device.type == "cuda" else None)

    def _load_or_init(self, model_name: str, seed: int):
        """Converted HF weights when provisioned, random init otherwise: a
        VLM checkpoint directory may carry ``vit/`` (HF ViTModel) and
        ``lm/`` (HF Llama); each present part loads, the rest (the
        projector included) stays random."""
        import torch

        from generativeaiexamples_tpu_torch.engine import weights as W

        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self._vision.init_vlm_params(self.cfg, gen, self.device)
        ckpt_dir = W.weights_dir_for(model_name)
        if not ckpt_dir:
            logger.info("initializing random VLM params (%s)", self.cfg)
            return params
        vit_dir = os.path.join(ckpt_dir, "vit")
        if os.path.isdir(vit_dir):
            params["vit"] = W.load_hf_vit(self.cfg.vit, vit_dir, device=self.device)
            logger.info("loaded ViT encoder weights from %s", vit_dir)
        lm_dir = os.path.join(ckpt_dir, "lm")
        if os.path.isdir(lm_dir):
            params["lm"] = W.load_hf_llama(self.cfg.lm, lm_dir, device=self.device)
            logger.info("loaded VLM decoder weights from %s", lm_dir)
        return params

    def _resize(self, image) -> np.ndarray:
        size = self.cfg.vit.image_size
        if hasattr(image, "convert"):
            image = image.convert("RGB").resize((size, size))
            return np.asarray(image, dtype=np.float32) / 255.0
        arr = _to_array(image)
        # Nearest-neighbor resize without PIL.
        ys = (np.arange(size) * arr.shape[0] // size).clip(0, arr.shape[0] - 1)
        xs = (np.arange(size) * arr.shape[1] // size).clip(0, arr.shape[1] - 1)
        return arr[ys][:, xs]

    def generate_ids(self, images: np.ndarray, prompt: str) -> list:
        """Greedy ids for (b, H, W, 3) f32 images under one prompt."""
        import torch

        tokens = torch.tensor([self.tokenizer.encode(prompt)] * len(images), dtype=torch.int32, device=self.device)
        with self._lock:
            return self._vision.vlm_generate(
                self.params, self.cfg, torch.from_numpy(np.ascontiguousarray(images)).to(self.device), tokens,
                max_new_tokens=self.max_new_tokens, graphs=self.graphs,
            )

    def _generate(self, image, prompt: str) -> str:
        return self.tokenizer.decode(self.generate_ids(self._resize(image)[None], prompt)[0])

    def describe_image(self, image) -> str:
        return self._generate(image, DESCRIBE_PROMPT)

    def is_graph(self, image) -> bool:
        return self._heuristic.is_graph(image)

    def chart_to_table(self, image) -> str:
        return self._generate(image, TABLE_PROMPT)


DESCRIBE_PROMPT = "Describe this image in detail:"
TABLE_PROMPT = "Generate the underlying data table for this figure:"

_ANALYST: list = []
_ANALYST_LOCK = threading.Lock()


def get_vision_analyst(device=None) -> VisionAnalyst:
    """The configured analyst singleton (``APP_VLM_MODELENGINE``:
    ``heuristic`` (or empty / ``none``), or ``tpu``, the in-process VLM
    on ``device``, the card unless ``"cpu"``; ``APP_VLM_MODELNAME`` picks
    ``vlm-tiny`` or ``vlm-base``).  The first build fixes its device."""
    with _ANALYST_LOCK:
        if not _ANALYST:
            from generativeaiexamples_tpu_torch.core.configuration import get_config

            engine = getattr(get_config(), "vlm", None)
            name = engine.model_engine.lower() if engine else "heuristic"
            if name in ("heuristic", "", "none"):
                _ANALYST.append(HeuristicVisionAnalyst())
            elif name == "tpu":
                _ANALYST.append(GPUVisionAnalyst(model_name=engine.model_name, device=device))
            else:
                raise ValueError(f"unknown vlm.model_engine {name!r}")
        return _ANALYST[0]


def reset_vision_analyst() -> None:
    with _ANALYST_LOCK:
        _ANALYST.clear()
