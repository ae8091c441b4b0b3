# Counterpart of src/repro/data/loader.py: a copy without the reference's
# unused `import jax`; nothing of it is left unported.
"""Sharded, prefetching host loader.

In a multi-host deployment each process materializes only its slice of the
global batch (``host_slice``); in a single process the slice is the whole
batch.  A background thread prefetches ``depth`` steps ahead — the data
pipeline never blocks the step.  ``put_fn`` (identity by default) moves a
batch where the step wants it, e.g. numpy arrays to tensors on the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np


class PrefetchLoader:
    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 *, start_step: int = 0, depth: int = 2,
                 put_fn: Optional[Callable[[Dict], Any]] = None):
        self.batch_fn = batch_fn
        self.put_fn = put_fn or (lambda x: x)
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self._step
        while not self._stop.is_set():
            try:
                item = (s, self.put_fn(self.batch_fn(s)))
            except Exception as e:           # surface errors on get()
                item = (s, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def get(self, expected_step: Optional[int] = None) -> Dict[str, Any]:
        step, item = self._q.get()
        if isinstance(item, Exception):
            raise item
        if expected_step is not None and step != expected_step:
            raise RuntimeError(
                f"loader out of sync: got step {step}, wanted {expected_step}"
                " (reset() after seeking)")
        return item

    def reset(self, step: int):
        self.stop()
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._step = step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def host_slice(global_batch: int, n_hosts: int, host_id: int) -> slice:
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)
