"""Streaming SDR -> ASR -> RAG pipeline (port of ``streaming/``).

The upstream's live FM-radio RAG stack (``experimental/fm-asr-streaming-
rag``): a UDP I/Q source and a thread-per-operator graph
(``streaming.graph``), the FM receiver's DSP chain on the card
(``streaming.dsp``), streaming ASR posting finals (``streaming.asr``), the
streaming chain server (``streaming.server``: ``/storeStreamingText``,
``/flush``, ``/generate``) with its rolling-transcript accumulator and
sqlite timestamp database, the intent-routed chains, and the file-replay
harness (``streaming.replay``).
"""

from generativeaiexamples_tpu_torch.streaming import dsp
from generativeaiexamples_tpu_torch.streaming.accumulator import TextAccumulator
from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase

__all__ = ["TextAccumulator", "TimestampDatabase", "dsp"]
