# Counterpart of src/repro/checkpoint/checkpointer.py; nothing of it is left
# unported.  A DTensor leaf is saved as its full array (`full_tensor()`, a
# collective: every rank calls `save`), so each process's
# `arrays_p{pidx}.npz` holds the whole state, and `restore(shardings=...)`
# puts each leaf onto its `(mesh, placements)`, any mesh shape (elastic
# restore).  The commit renames one directory a step, as the reference's
# does, so processes that share a checkpoint directory would replace each
# other's step: give each process its own directory.
"""Atomic, async, keep-N checkpointing with manifest + checksums.

Layout::

    <dir>/step_00000123/
        arrays_p0.npz      # flattened keypath -> array (per process)
        manifest.json      # step, keys, checksums, writer metadata
    <dir>/LATEST           # name of last committed checkpoint (atomic rename)

Commit protocol (crash-safe): write into ``.tmp-step_X``, fsync files, rename
dir, then rewrite LATEST via tmp+rename.  A partially-written checkpoint can
never be observed as committed — the restart path always reads LATEST.

The files are the JAX package's: the same key paths (a NamedTuple field is
``.name``, a dict key its name, joined by ``/``: ``.params/embed/embedding``,
``.opt/.mu/...``), the same manifest and checksum, bf16 arrays as the raw
2-byte values that the reference's ``np.savez`` writes, and the work meter as
its two uint32 limbs.  A checkpoint of the JAX ``Trainer`` restores into the
port's ``TrainState`` and the other way round.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.meter import is_meter, meter_from_limbs, meter_to_limbs
from repro_torch.distributed.sharding import distribute

_BF16 = np.dtype("V2")          # how numpy stores a bf16 array it cannot name


def _to_numpy(leaf) -> np.ndarray:
    """A host copy: the state goes on being updated in place while an
    asynchronous save writes it."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.array(leaf)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` cast to the template leaf's dtype, on its device."""
    if arr.dtype == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    t = t.to(device=like.device, dtype=like.dtype)
    return t.requires_grad_(like.requires_grad)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}

    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if tree is None:
        return flat
    if is_meter(tree):
        tree = meter_to_limbs(tree)
    if hasattr(tree, "_fields"):                     # NamedTuple
        for name in tree._fields:
            flat.update(_flatten(getattr(tree, name), key(f".{name}")))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, key(k)))
    else:
        flat[prefix] = _to_numpy(tree)
    return flat


def _unflatten(template, arrays: Dict[str, np.ndarray], prefix: str = ""):
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if template is None:
        return None
    if is_meter(template):
        limbs = {k: arrays[key(k)]
                 for k in ("uow_lo", "uow_hi", "counts", "steps")}
        return meter_from_limbs(limbs, template["counts"].device)
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten(getattr(template, n), arrays, key(f".{n}"))
            for n in template._fields])
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, key(k)) for k, v in template.items()}
    arr = arrays[prefix]
    if isinstance(template, torch.Tensor):
        return _to_tensor(arr, template)
    return np.asarray(arr).astype(np.asarray(template).dtype)


def _checksum(arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[:1 << 20])
    return h.hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str, *, keep_n: int = 3,
                 process_index: int = 0, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.pidx = process_index
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             *, blocking: bool = False) -> None:
        # snapshot to host memory NOW (the state is updated in place)
        arrays = _flatten(tree)
        if self._pool is None or blocking:
            self._write(step, arrays, extra or {})
            return
        self.wait()                       # only one in-flight save
        self._pending = self._pool.submit(self._write, step, arrays,
                                          extra or {})

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               extra: Dict) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp-{name}-{self.pidx}")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        npz_path = os.path.join(tmp, f"arrays_p{self.pidx}.npz")
        np.savez(npz_path, **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "checksum": _checksum(arrays),
            "time": time.time(),
            "process": self.pidx,
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._commit_latest(name)
            self._gc()

    def _commit_latest(self, name: str) -> None:
        tmp = os.path.join(self.dir, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_"):
                try:
                    out.append(int(n[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        full = os.path.join(self.dir, name)
        if not os.path.exists(os.path.join(full, "manifest.json")):
            return None
        return int(name[5:])

    def restore(self, template: Any, step: Optional[int] = None,
                *, shardings: Any = None, verify: bool = True
                ) -> Tuple[Any, Dict]:
        """Restore into ``template``'s structure, each tensor cast to the
        template leaf's dtype and put on its device.  ``shardings``: a tree
        of the template's structure whose leaves are ``(mesh, placements)``
        (``distributed.sharding.params_shardings``) or None; each such leaf
        is put onto its mesh (elastic restore onto another mesh shape).
        Without it a DTensor leaf of the template is placed as that leaf
        is."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        name = f"step_{step:08d}"
        full = os.path.join(self.dir, name)
        with open(os.path.join(full, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(full, f"arrays_p{self.pidx}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if verify and _checksum(arrays) != manifest["checksum"]:
            raise IOError(f"checksum mismatch restoring {full}")
        tree = _place(_unflatten(template, arrays), template, shardings)
        return tree, manifest.get("extra", {})


def _place(tree, template, shardings, prefix: str = ""):
    """Put the restored leaves onto their meshes (see ``restore``)."""
    if isinstance(tree, dict):
        return {k: _place(v, template[k],
                          None if shardings is None else shardings[k],
                          f"{prefix}/{k}")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[
            _place(v, t, None if shardings is None else s, f"{prefix}/.{n}")
            for n, v, t, s in zip(tree._fields, tree, template,
                                  shardings or (None,) * len(tree))])
    if shardings is None and isinstance(template, DTensor):
        shardings = (template.device_mesh, template.placements)
    if shardings is None or not isinstance(tree, torch.Tensor):
        return tree
    return distribute(tree, shardings, prefix)
