# Counterpart of src/repro/pipeline/journal.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Append-only run journal for crash-resume.

One JSONL file per (store, logical run config) records the lifecycle of
every pipeline execution against that config: ``run_start``,
``stage_start`` / ``stage_commit`` per stage, ``run_end``.  Each line is
flushed and fsync'd as it is written, so a SIGKILL'd run leaves a
faithful prefix — the rerun reads it to report which stages were
already committed (``resumed_stages`` in the manifest) before the
content-addressed store turns them into plain cache hits.

The journal is *advisory*: resume correctness comes from the store's
atomic commits (``spec.json`` last), not from the journal.  A torn
final line (the crash landed mid-write) is skipped on read.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List


class RunJournal:
    """Thread-safe append-only JSONL event log."""

    def __init__(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")

    def append(self, kind: str, **fields: Any) -> None:
        rec = {"kind": kind, "t": round(time.time(), 3), **fields}
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- reading -------------------------------------------------------
    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        """Events in file order; unparsable (torn) lines are dropped."""
        if not os.path.exists(path):
            return []
        out: List[Dict[str, Any]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
        return out

    @staticmethod
    def committed(events: List[Dict[str, Any]]) -> Dict[str, str]:
        """stage name -> artifact key for every recorded commit (last
        commit wins when a stage re-ran)."""
        return {e["stage"]: e.get("key", "")
                for e in events if e.get("kind") == "stage_commit"}
