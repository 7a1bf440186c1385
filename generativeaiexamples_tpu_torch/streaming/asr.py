"""PCM -> incremental ASR -> chain-server intake (port of
``streaming/asr.py``).

The DSP chain's PCM blocks stream through the port's
:class:`models.speech.StreamingTranscriber`; partials surface through a
callback (the live caption), and each *final* utterance is POSTed to the
streaming chain server's ``/storeStreamingText``, as the reference's ASR
client does.  The POST goes through ``core.httpclient`` (the card machine
has no ``requests``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.core.httpclient import post_json
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.models import speech

logger = get_logger(__name__)


class ASRSink:
    """Terminal pipeline operator: feed PCM blocks, emit transcripts.

    Usable directly as a :class:`streaming.graph.Operator` function (it
    returns None).  ``flush()`` finalizes the open utterance at end of
    stream.  Without ``asr_params`` the model is drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card by
    default); the reference draws from ``jax.random.PRNGKey(seed)``.
    """

    def __init__(
        self,
        asr_params=None,
        asr_cfg: Optional[speech.ASRConfig] = None,
        *,
        server_url: str = "",
        source: str = "stream",
        sample_rate: int = 16_000,
        on_partial: Optional[Callable[[str], None]] = None,
        on_final: Optional[Callable[[str], None]] = None,
        seed: int = 0,
        device=None,
        **transcriber_kwargs,
    ) -> None:
        cfg = asr_cfg or speech.conformer_s()
        if asr_params is None:
            dev = resolve_device(device)
            asr_params = speech.asr_init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        self.session = speech.StreamingTranscriber(asr_params, cfg, sample_rate=sample_rate, **transcriber_kwargs)
        self.server_url = server_url.rstrip("/")
        self.source = source
        self.on_partial = on_partial
        self.on_final = on_final
        self.finals: list[str] = []

    def _post_final(self, text: str) -> None:
        self.finals.append(text)
        if self.on_final is not None:
            self.on_final(text)
        if self.server_url and text.strip():
            try:
                with post_json(f"{self.server_url}/storeStreamingText", {"text": text, "source": self.source}, {},
                               connect_timeout=10, read_timeout=10) as resp:
                    resp.read()
            except OSError:
                logger.exception("storeStreamingText failed")

    def _handle(self, events: list[dict]) -> None:
        for ev in events:
            if ev["is_final"]:
                self._post_final(ev["text"])
            elif self.on_partial is not None:
                self.on_partial(ev["text"])

    def __call__(self, pcm_block) -> None:
        pcm = np.asarray(pcm_block)
        if pcm.dtype == np.int16:
            pcm = pcm.astype(np.float32) / 32768.0
        self._handle(self.session.feed(pcm.astype(np.float32)))
        return None

    def flush(self) -> None:
        """End of stream: finalize the open utterance."""
        self._handle(self.session.finish())
