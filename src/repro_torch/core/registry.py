# Counterpart of src/repro/core/registry.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Block registry: the IRBB analogue (DESIGN.md §2).

A *block* is an instrumented unit of the step program (embed, attention
layer, MoE router, expert, SSD scan, head/loss …).  The :class:`BlockTable`
records, per block, its static IR cost (jaxpr ops per execution) and the
step *program*: the ordered hook stream one step produces.  Dense-arch step
programs are static (XLA programs have static shapes); data-dependence enters
through *virtual* signature blocks (expert token occupancy, sequence-length
bins) that enrich the interval signature exactly like input-driven control
flow enriches the paper's BBVs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockDef:
    name: str
    cost_ops: float                  # IR ops per execution (unit of work)
    cost_flops: float = 0.0
    virtual: bool = False            # signature-only (not in the hook stream)
    dyn_key: Optional[str] = None    # aux-dict key feeding a virtual block
    dyn_index: int = -1              # index into the aux vector (-1 = scalar)


@dataclasses.dataclass(frozen=True)
class Segment:
    """``repeat`` consecutive executions of ``pattern`` (list of block ids)."""
    pattern: Tuple[int, ...]
    repeat: int


@dataclasses.dataclass
class BlockTable:
    """Blocks + one hook-stream *program* per step kind.

    Homogeneous workloads (training) have one "default" program; serving has
    heterogeneous steps (prefill vs decode) with different streams over a
    shared block id space (see ``merge_tables``).
    """
    blocks: List[BlockDef]
    program: List[Segment]                       # "default" step kind
    programs: Optional[Dict[str, List[Segment]]] = None

    # ---- derived ----------------------------------------------------------
    def __post_init__(self):
        self._expand_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._expand_count: Dict[str, int] = {}   # actual expansions, per kind
        self._counts_cache: Dict[str, np.ndarray] = {}
        self._occ_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if self.programs is None:
            self.programs = {}
        if "default" not in self.programs:
            self.programs["default"] = self.program

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def names(self) -> List[str]:
        return [b.name for b in self.blocks]

    def id_of(self, name: str) -> int:
        for i, b in enumerate(self.blocks):
            if b.name == name:
                return i
        raise KeyError(name)

    def costs(self) -> np.ndarray:
        return np.array([b.cost_ops for b in self.blocks], np.float64)

    def kinds(self) -> List[str]:
        return list(self.programs)

    def expand(self, kind: str = "default") -> Tuple[np.ndarray, np.ndarray]:
        """One step's hook stream -> (block_ids [M], cum_uow [M]).

        cum_uow[i] is the global-counter increment *after* hook i fires
        (i.e. the count-stamp the paper's hook would record), relative to
        the start of the step.  Expansions are memoized per kind (the
        stream is static); ``_expand_count`` records how many times each
        kind was actually materialized (regression-tested to stay at 1).
        """
        if kind in self._expand_cache:
            return self._expand_cache[kind]
        self._expand_count[kind] = self._expand_count.get(kind, 0) + 1
        ids: List[int] = []
        for seg in self.programs[kind]:
            ids.extend(list(seg.pattern) * seg.repeat)
        ids_arr = np.asarray(ids, np.int64)
        costs = self.costs()[ids_arr]
        cum = np.cumsum(costs)
        self._expand_cache[kind] = (ids_arr, cum)
        return self._expand_cache[kind]

    def expand_all(self) -> None:
        """Materialize every kind's stream, counts and occurrence structure
        (thread-safety warmup: worker threads then only read the caches)."""
        for kind in self.programs:
            self.expand(kind)
            self.step_counts(kind)
            self.step_occ(kind)

    def step_uow(self, kind: str = "default") -> float:
        _, cum = self.expand(kind)
        return float(cum[-1]) if len(cum) else 0.0

    def step_counts(self, kind: str = "default") -> np.ndarray:
        """Static per-step execution count of every (non-virtual) block."""
        if kind not in self._counts_cache:
            ids, _ = self.expand(kind)
            self._counts_cache[kind] = np.bincount(
                ids, minlength=self.n_blocks).astype(np.int64)
        return self._counts_cache[kind]

    def step_occ(self, kind: str = "default"
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Static within-step occurrence structure of one kind's stream:
        ``(occ, cnt_gather)`` where ``occ[i]`` is the 1-based rank of hook
        ``i`` among executions of its block within one step and
        ``cnt_gather[i]`` is that block's total per-step count.  A step
        ``s`` of a same-kind run then has global cumulative hit counts
        ``base + s * cnt_gather + occ`` — the vectorized batch analyzer's
        sort-free hit computation.  Cached per kind (streams are static).
        """
        if kind not in self._occ_cache:
            ids, _ = self.expand(kind)
            m = len(ids)
            occ = np.empty(m, np.int64)
            if m:
                order = np.argsort(ids, kind="stable")
                sid = ids[order]
                new = np.empty(m, bool)
                new[0] = True
                new[1:] = sid[1:] != sid[:-1]
                starts = np.flatnonzero(new)
                glen = np.diff(np.append(starts, m))
                occ[order] = np.arange(m) - np.repeat(starts, glen) + 1
            self._occ_cache[kind] = (occ, self.step_counts(kind)[ids])
        return self._occ_cache[kind]

    def virtual_ids(self) -> List[int]:
        return [i for i, b in enumerate(self.blocks) if b.virtual]

    def to_json(self) -> Dict:
        return {
            "blocks": [dataclasses.asdict(b) for b in self.blocks],
            "program": [{"pattern": list(s.pattern), "repeat": s.repeat}
                        for s in self.program],
            "programs": {k: [{"pattern": list(s.pattern), "repeat": s.repeat}
                             for s in v] for k, v in (self.programs or {}).items()},
        }

    @staticmethod
    def from_json(d: Dict) -> "BlockTable":
        progs = {k: [Segment(tuple(s["pattern"]), s["repeat"]) for s in v]
                 for k, v in d.get("programs", {}).items()} or None
        return BlockTable(
            [BlockDef(**b) for b in d["blocks"]],
            [Segment(tuple(s["pattern"]), s["repeat"]) for s in d["program"]],
            progs,
        )


def merge_tables(tables: Dict[str, BlockTable]) -> BlockTable:
    """Merge per-kind tables into one shared block id space; block names get
    a ``<kind>/`` prefix (prefill attention is a different IRBB than decode
    attention — different code paths, different IR size)."""
    blocks: List[BlockDef] = []
    programs: Dict[str, List[Segment]] = {}
    for kind, t in tables.items():
        offset = len(blocks)
        for b in t.blocks:
            blocks.append(dataclasses.replace(b, name=f"{kind}/{b.name}"))
        programs[kind] = [
            Segment(tuple(p + offset for p in s.pattern), s.repeat)
            for s in t.program]
    first = next(iter(programs.values()))
    return BlockTable(blocks, first, programs)
