"""Ingest-job journal: JSONL record of bulk-ingest progress (port of the JAX
package's ``durability/journal.py``; the same lines, so either package
resumes the other's jobs).

A `/documents/bulk` job that dies with the process currently vanishes
from `/documents/status`; the journal makes the job itself durable.
Each pipeline event appends one JSON line (fsync'd — these are rare,
one per file, so per-line fsync is cheap relative to parse+embed):

    {"ev": "job",      "job": id, "files": [[staged_path, name], ...]}
    {"ev": "file_done",   "job": id, "name": ..., "chunks": n}
    {"ev": "file_failed", "job": id, "name": ..., "error": ...}
    {"ev": "job_done",    "job": id, "status": "completed"|...}

``file_done`` is written only after the chunks are durable in the WAL
(the pipeline fsyncs the durable store first), so on restart
``unfinished_jobs()`` yields exactly the files whose chunks may be
missing or half-applied; the resume path deletes each such file's
source and re-ingests it — idempotent, so neither a crash between WAL
append and journal mark (chunks present, file not marked) nor one
between journal write and fsync (file marked, mark lost) produces
duplicates or losses.

Torn tails: a crash mid-line leaves trailing garbage; ``_read`` skips
undecodable lines instead of failing.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional


class IngestJournal:
    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def _record(self, obj: dict[str, Any]) -> None:
        line = json.dumps(obj, separators=(",", ":"))
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def job_submitted(
        self, job_id: str, files: list[tuple[str, str]]
    ) -> None:
        self._record(
            {"ev": "job", "job": job_id, "files": [list(f) for f in files]}
        )

    def file_done(self, job_id: str, name: str, chunks: int) -> None:
        self._record(
            {"ev": "file_done", "job": job_id, "name": name, "chunks": chunks}
        )

    def file_failed(self, job_id: str, name: str, error: str) -> None:
        self._record(
            {
                "ev": "file_failed",
                "job": job_id,
                "name": name,
                "error": error[:500],
            }
        )

    def job_finished(self, job_id: str, status: str) -> None:
        self._record({"ev": "job_done", "job": job_id, "status": status})

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()

    # -- recovery ----------------------------------------------------------

    @staticmethod
    def _read(path: str) -> list[dict[str, Any]]:
        if not os.path.exists(path):
            return []
        events = []
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue  # torn tail / partial line
        return events

    def unfinished_jobs(self) -> list[dict[str, Any]]:
        """Jobs submitted but never finished, with the files still owed.

        Each entry: ``{"job_id", "files": [(path, name), ...],
        "pending": [(path, name), ...], "done": {name: chunks},
        "failed": {name: error}}`` — ``pending`` preserves submit order.
        """
        jobs: dict[str, dict[str, Any]] = {}
        finished: set[str] = set()
        for ev in self._read(self.path):
            kind = ev.get("ev")
            job_id = ev.get("job")
            if not job_id:
                continue
            if kind == "job":
                jobs[job_id] = {
                    "job_id": job_id,
                    "files": [tuple(f) for f in ev.get("files", [])],
                    "done": {},
                    "failed": {},
                }
            elif kind == "file_done" and job_id in jobs:
                jobs[job_id]["done"][ev.get("name")] = int(
                    ev.get("chunks", 0)
                )
            elif kind == "file_failed" and job_id in jobs:
                jobs[job_id]["failed"][ev.get("name")] = str(
                    ev.get("error", "")
                )
            elif kind == "job_done":
                finished.add(job_id)
        out = []
        for job_id, info in jobs.items():
            if job_id in finished:
                continue
            settled = set(info["done"]) | set(info["failed"])
            info["pending"] = [
                (p, n) for p, n in info["files"] if n not in settled
            ]
            out.append(info)
        return out

    def compact(self, drop_jobs: Optional[set[str]] = None) -> None:
        """Atomically rewrite the journal keeping only unfinished jobs'
        events (minus ``drop_jobs``), bounding file growth across
        restarts."""
        keep = {
            j["job_id"]
            for j in self.unfinished_jobs()
            if not drop_jobs or j["job_id"] not in drop_jobs
        }
        events = [
            ev
            for ev in self._read(self.path)
            if ev.get("job") in keep
        ]
        tmp = self.path + ".tmp"
        with self._lock:
            with open(tmp, "w", encoding="utf-8") as fh:
                for ev in events:
                    fh.write(json.dumps(ev, separators=(",", ":")) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            if not self._fh.closed:
                self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
