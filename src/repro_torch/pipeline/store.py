# Counterpart of src/repro/pipeline/store.py: a copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Content-addressed artifact store for the sampling pipeline.

Generalizes ``core/profile_store.py`` (which persists only Profiles) to
*every* lifecycle product: profiles, selections, nuggets, replay results,
full-run baselines and validation reports.  Layout::

    <root>/<kind>/<key>/spec.json    # provenance: spec + upstream keys
    <root>/<kind>/<key>/...          # kind-specific payload files

Keys are **input-addressed**: ``key = sha256(kind || upstream keys ||
canonical spec JSON)``.  A stage's spec is everything its computation
depends on (resolved config), and its upstream list is the keys of the
artifacts it consumes — so digests chain through the stage graph exactly
like a build system.  Re-running a pipeline after changing only the
selector changes the selection key (and, transitively, every downstream
key) while the profile and baseline keys — which do not consume the
selection — stay put and hit the cache.

``spec.json`` is written last, atomically (write + ``os.replace``); its
presence marks the artifact complete, so a crashed run never leaves a
half-written directory that later loads as a hit.  At commit the sha256
of every payload file is recorded in ``spec.json`` (``files``); every
cache-hit ``lookup`` re-hashes the payload against it, and a mismatch
quarantines the artifact (moved to ``<root>/.quarantine/``) and reports
a miss so the caller transparently recomputes instead of poisoning the
warm run.  ``orphans`` lists uncommitted (crash-debris) directories and
``gc`` removes them.

The store is concurrency-safe: every key has a per-key re-entrant lock
(``single_flight``) that ``Stage.run`` holds across its
check-compute-commit critical section, so two stages (or two pipelines
sharing a store) that resolve the same artifact key compute it exactly
once — the loser of the race blocks, then loads the winner's commit as
a plain cache hit.  ``commit`` takes the same lock and is idempotent:
an already-committed key returns without rewriting ``spec.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

from repro_torch import obs
from repro_torch.core.intervals import Profile
from repro_torch.core.profile_store import load_profile, save_profile

ARTIFACT_KINDS = ("profile", "selection", "nuggets", "replay", "baseline",
                  "validation")


def canonical_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace, tuples as lists."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=_jsonable)


def _jsonable(o: Any):
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.asdict(o)
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"not canonically serializable: {o!r}")


def artifact_key(kind: str, spec: Dict, upstream: Sequence[str] = ()) -> str:
    """sha256 content address of an artifact: kind + upstream digests + spec."""
    h = hashlib.sha256()
    h.update(kind.encode())
    for k in upstream:
        h.update(b"\x00")
        h.update(k.encode())
    h.update(b"\x01")
    h.update(canonical_json(spec).encode())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Artifact:
    """Handle to one stored pipeline product (payload lives on disk)."""
    kind: str
    key: str
    path: str                      # directory under the store root
    spec: Dict                     # resolved config that produced it
    upstream: List[str]            # keys of consumed artifacts


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


class ArtifactStore:
    """Content-addressed, kind-partitioned on-disk artifact cache.

    ``injector`` (a :class:`repro_torch.faults.FaultInjector`) threads the
    fault-injection harness through the store: its ``corrupt`` rules
    fire right after a commit, which integrity verification must then
    catch on the next cache-hit load.
    """

    QUARANTINE = ".quarantine"

    def __init__(self, root: str, injector: Optional[Any] = None):
        self.root = str(root)
        self.injector = injector
        # per-instance cache accounting, mirrored into the process
        # MetricsRegistry (store.hit / store.miss / store.put_bytes / ...)
        self.counters = {"hit": 0, "miss": 0, "put_bytes": 0,
                         "verified": 0, "verify_s": 0.0, "quarantined": 0}
        self._counters_lock = threading.Lock()
        # per-key re-entrant locks (commit() re-acquires under
        # single_flight()); the registry itself is guarded by _locks_lock
        self._key_locks: Dict[str, threading.RLock] = {}
        self._locks_lock = threading.Lock()

    def _key_lock(self, key: str) -> threading.RLock:
        with self._locks_lock:
            lock = self._key_locks.get(key)
            if lock is None:
                lock = self._key_locks.setdefault(key, threading.RLock())
            return lock

    @contextlib.contextmanager
    def single_flight(self, key: str) -> Iterator[None]:
        """Serialize the check-compute-commit critical section of one key.

        Concurrent holders of the same key queue up; whoever enters first
        computes, everyone after it sees the committed artifact and loads.
        Re-entrant, so ``commit`` may be called while held.
        """
        with self._key_lock(key):
            yield

    def _count(self, name: str, amount: float = 1) -> None:
        with self._counters_lock:
            self.counters[name] += amount

    # -- addressing ----------------------------------------------------
    def path(self, kind: str, key: str) -> str:
        return os.path.join(self.root, kind, key)

    def resolve(self, kind: str, spec: Dict,
                upstream: Sequence[str] = ()) -> Artifact:
        key = artifact_key(kind, spec, upstream)
        return Artifact(kind, key, self.path(kind, key), dict(spec),
                        list(upstream))

    def exists(self, artifact: Artifact) -> bool:
        hit = os.path.exists(os.path.join(artifact.path, "spec.json"))
        self._count("hit" if hit else "miss")
        obs.metrics().count(f"store.{'hit' if hit else 'miss'}")
        if obs.enabled():
            obs.event("store.lookup", kind=artifact.kind,
                      key=artifact.key[:12], hit=hit)
        return hit

    def lookup(self, artifact: Artifact) -> bool:
        """``exists`` plus payload integrity: a committed artifact whose
        payload fails verification is quarantined and reported as a miss,
        so the caller transparently recomputes it."""
        present = os.path.exists(os.path.join(artifact.path, "spec.json"))
        hit = present and self.verify(artifact)
        if present and not hit:
            self.quarantine(artifact)
        self._count("hit" if hit else "miss")
        obs.metrics().count(f"store.{'hit' if hit else 'miss'}")
        if obs.enabled():
            obs.event("store.lookup", kind=artifact.kind,
                      key=artifact.key[:12], hit=hit)
        return hit

    # -- integrity -----------------------------------------------------
    def verify(self, artifact: Artifact) -> bool:
        """Re-hash every payload file against the digests recorded in
        ``spec.json`` at commit.  Artifacts committed before integrity
        recording (no ``files`` entry) pass vacuously."""
        t0 = time.perf_counter()
        try:
            with open(os.path.join(artifact.path, "spec.json")) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return False
        files = doc.get("files")
        ok = True
        if files is not None:
            for rel, want in sorted(files.items()):
                p = os.path.join(artifact.path, rel)
                try:
                    got = _sha256_file(p)
                except OSError:
                    ok = False
                    break
                if got != want:
                    ok = False
                    break
        dt = time.perf_counter() - t0
        self._count("verified")
        self._count("verify_s", dt)
        obs.metrics().count("store.verified")
        obs.metrics().observe("store.verify_s", dt)
        return ok

    def quarantine(self, artifact: Artifact) -> str:
        """Move a corrupt artifact directory under ``<root>/.quarantine``
        (same filesystem, atomic rename) so it can never satisfy another
        cache hit; returns the destination path."""
        qroot = os.path.join(self.root, self.QUARANTINE)
        os.makedirs(qroot, exist_ok=True)
        base = os.path.join(qroot, f"{artifact.kind}-{artifact.key}")
        dest, i = base, 0
        while os.path.exists(dest):
            i += 1
            dest = f"{base}.{i}"
        os.rename(artifact.path, dest)
        self._count("quarantined")
        obs.metrics().count("store.quarantined")
        obs.log.kv("artifact_quarantined", logger="store",
                   kind=artifact.kind, key=artifact.key[:12], dest=dest)
        if obs.enabled():
            obs.event("store.quarantine", kind=artifact.kind,
                      key=artifact.key[:12])
        return dest

    # -- payload IO ----------------------------------------------------
    def write_json(self, artifact: Artifact, name: str, payload: Any) -> None:
        """Atomic payload write: temp file in the artifact dir, then
        ``os.replace`` — the same discipline as ``commit``, so a crash
        mid-write can never leave a torn payload behind an eventual
        completion marker."""
        os.makedirs(artifact.path, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=artifact.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, default=_jsonable)
            os.replace(tmp, os.path.join(artifact.path, name))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def read_json(self, artifact: Artifact, name: str) -> Any:
        with open(os.path.join(artifact.path, name)) as f:
            return json.load(f)

    def write_profile(self, artifact: Artifact, profile: Profile) -> None:
        save_profile(os.path.join(artifact.path, "profile"), profile)

    def read_profile(self, artifact: Artifact) -> Profile:
        return load_profile(os.path.join(artifact.path, "profile"))

    # -- completion marker --------------------------------------------
    def commit(self, artifact: Artifact) -> None:
        """Mark the artifact complete (atomic: spec.json appears last).

        Idempotent under concurrency: the per-key lock serializes racing
        committers and an already-committed key returns without touching
        the directory (or the put counters) again.
        """
        with self._key_lock(artifact.key):
            marker = os.path.join(artifact.path, "spec.json")
            if os.path.exists(marker):      # already committed: fast path
                obs.metrics().count("store.commit_dedup")
                return
            os.makedirs(artifact.path, exist_ok=True)
            # one walk: payload byte count + per-file sha256 (integrity
            # record; hash-on-commit amortizes into the compute miss)
            nbytes = 0
            files: Dict[str, str] = {}
            for d, _, fs in os.walk(artifact.path):
                for fn in fs:
                    p = os.path.join(d, fn)
                    if fn.endswith(".tmp"):
                        continue
                    nbytes += os.path.getsize(p)
                    rel = os.path.relpath(p, artifact.path)
                    files[rel.replace(os.sep, "/")] = _sha256_file(p)
            doc = {"kind": artifact.kind, "key": artifact.key,
                   "spec": artifact.spec, "upstream": artifact.upstream,
                   "files": files}
            fd, tmp = tempfile.mkstemp(dir=artifact.path, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(doc, f, indent=1, default=_jsonable)
                os.replace(tmp, marker)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            nbytes += os.path.getsize(marker)
            if self.injector is not None:
                # fault harness: corrupt rules land right after the
                # commit so verification must catch them on the next hit
                self.injector.corrupt(artifact.path, artifact.kind)
        self._count("put_bytes", nbytes)
        obs.metrics().count("store.put_bytes", nbytes)
        obs.metrics().count("store.put")

    # -- maintenance ---------------------------------------------------
    def keys(self, kind: str) -> List[str]:
        d = os.path.join(self.root, kind)
        if not os.path.isdir(d):
            return []
        return sorted(k for k in os.listdir(d)
                      if os.path.exists(os.path.join(d, k, "spec.json")))

    def orphans(self, kind: str) -> List[str]:
        """Uncommitted artifact directories (no ``spec.json``): the
        debris a crashed run leaves mid-compute.  ``keys`` silently
        skips them; this makes them visible (the pipeline manifest
        surfaces the counts)."""
        d = os.path.join(self.root, kind)
        if not os.path.isdir(d):
            return []
        return sorted(k for k in os.listdir(d)
                      if os.path.isdir(os.path.join(d, k))
                      and not os.path.exists(os.path.join(d, k, "spec.json")))

    def gc(self, min_age_s: float = 0.0) -> List[str]:
        """Remove orphaned (uncommitted) artifact directories; returns
        ``kind/key`` for each one removed.

        ``min_age_s > 0`` spares directories touched within that window
        — use it when other pipelines may be computing into the same
        store concurrently (their in-flight artifacts are uncommitted
        by design).  The default (0) is the rerun-after-crash posture:
        the pipeline gc's at run start, before any stage computes.
        """
        removed: List[str] = []
        cutoff = time.time() - min_age_s
        for kind in ARTIFACT_KINDS:
            base = os.path.join(self.root, kind)
            for key in self.orphans(kind):
                p = os.path.join(base, key)
                if min_age_s > 0:
                    try:
                        newest = max(
                            [os.path.getmtime(p)] +
                            [os.path.getmtime(os.path.join(d, f))
                             for d, _, fs in os.walk(p) for f in fs])
                    except OSError:
                        continue
                    if newest > cutoff:
                        continue
                shutil.rmtree(p, ignore_errors=True)
                removed.append(f"{kind}/{key}")
        if removed:
            obs.metrics().count("store.gc_removed", len(removed))
            obs.log.kv("store_gc", logger="store", removed=len(removed))
        return removed


def persist_profile_cli(builder, *, profile_out: Optional[str],
                        profile_cache: Optional[str],
                        store: Optional[str], spec: Dict) -> None:
    """Shared profile-persistence tail for the train/serve launchers.

    ``--profile-cache`` keys on the *step stream* (core-level cache);
    ``--store`` keys on the *run spec* (pipeline-level ArtifactStore);
    ``--profile-out`` writes a plain profile directory.
    """
    from repro_torch.core.profile_store import cached_finalize
    if profile_cache:
        prof, hit = cached_finalize(profile_cache, builder)
        obs.log.kv("profile_cache", logger="pipeline",
                   hit=hit, path=profile_cache)
    else:
        prof = builder.finalize()
    if store:
        s = ArtifactStore(store)
        art = s.resolve("profile", spec)
        if not s.exists(art):
            s.write_profile(art, prof)
            s.commit(art)
        obs.log.kv("profile_artifact", logger="pipeline",
                   key=art.key[:12], path=art.path)
    if profile_out:
        save_profile(profile_out, prof)
        obs.log.kv("profile_saved", logger="pipeline", path=profile_out)
