"""Minimal operator-graph runtime + UDP I/Q source (port of
``streaming/graph.py``).

The reference uses Holoscan's C++ operator graph (``sdr-holoscan/app.py:
34-50``: network_rx -> pkt_format -> lowpassfilt -> demodulate -> resample
-> pcm_to_asr).  Holoscan's value there is zero-copy GPU scheduling; here
the DSP chain is a few device calls per block (``streaming.dsp``), so
the graph runtime only needs to move blocks between I/O and compute —
a thread-per-operator pipeline with bounded queues is the honest
equivalent, and the UDP source matches the reference's packet format
(raw interleaved float32 I/Q payloads, ``operators.py:77-165``).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

_STOP = object()


class Operator:
    """One pipeline stage: pulls from its inbox, pushes downstream."""

    def __init__(self, name: str, fn: Callable[[Any], Optional[Any]], maxsize: int = 64):
        self.name = name
        self.fn = fn
        self.inbox: queue.Queue = queue.Queue(maxsize=maxsize)
        self.downstream: list[Operator] = []
        self._thread: Optional[threading.Thread] = None

    def connect(self, other: "Operator") -> "Operator":
        self.downstream.append(other)
        return other

    def _run(self) -> None:
        while True:
            item = self.inbox.get()
            if item is _STOP:
                for d in self.downstream:
                    d.inbox.put(_STOP)
                return
            try:
                out = self.fn(item)
            except Exception:
                logger.exception("operator %s failed; dropping block", self.name)
                continue
            if out is None:
                continue
            for d in self.downstream:
                try:
                    d.inbox.put(out, timeout=5)
                except queue.Full:
                    logger.warning("%s -> %s queue full; dropping", self.name, d.name)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name=self.name)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread:
            self._thread.join(timeout)


class Pipeline:
    """A linear (or branched) graph of operators with one entry point."""

    def __init__(self, operators: Sequence[Operator]) -> None:
        self.operators = list(operators)
        for a, b in zip(self.operators, self.operators[1:]):
            a.connect(b)

    @property
    def entry(self) -> Operator:
        return self.operators[0]

    def start(self) -> None:
        for op in self.operators:
            op.start()

    def push(self, item: Any) -> None:
        self.entry.inbox.put(item)

    def stop(self, wait: bool = True) -> None:
        self.entry.inbox.put(_STOP)
        if wait:
            for op in self.operators:
                op.join(timeout=10)


class UDPSource:
    """UDP receiver for interleaved-float32 I/Q packets (the reference's
    ``BasicNetworkRxOp``+``PacketFormatterOp`` contract)."""

    def __init__(
        self,
        pipeline: Pipeline,
        host: str = "0.0.0.0",
        port: int = 5005,
        block_samples: int = 65536,
    ) -> None:
        self.pipeline = pipeline
        self.block_samples = block_samples
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            # Burst tolerance: I/Q floods faster than the DSP drains while
            # the first block warms the device up; a few MB of kernel buffer rides
            # that out (the reference sizes Holoscan queues the same way).
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        except OSError:  # pragma: no cover - platform cap
            pass
        self.sock.bind((host, port))
        self.sock.settimeout(0.5)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._buf = np.zeros(0, np.complex64)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                payload, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            flat = np.frombuffer(payload, dtype=np.float32)
            if len(flat) % 2:
                flat = flat[:-1]
            iq = flat[0::2] + 1j * flat[1::2]
            self._buf = np.concatenate([self._buf, iq.astype(np.complex64)])
            while len(self._buf) >= self.block_samples:
                self.pipeline.push(self._buf[: self.block_samples])
                self._buf = self._buf[self.block_samples :]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="udp-src")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.sock.close()
