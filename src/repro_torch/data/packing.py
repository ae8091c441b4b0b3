# Counterpart of src/repro/data/packing.py: a verbatim copy (numpy only);
# nothing of it is left unported.
"""Greedy sequence packing: variable-length documents -> fixed [B,S] rows
with segment ids and intra-segment positions (FFD bin packing).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> Dict[str, np.ndarray]:
    """First-fit-decreasing packing.  Returns tokens/segment_ids/positions
    of shape [n_rows, seq_len]; segment id 0 marks padding."""
    order = sorted(range(len(docs)), key=lambda i: -len(docs[i]))
    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    for i in order:
        d = np.asarray(docs[i], np.int32)[:seq_len]
        placed = False
        for r in range(len(rows)):
            if space[r] >= len(d):
                rows[r].append(d)
                space[r] -= len(d)
                placed = True
                break
        if not placed:
            rows.append([d])
            space.append(seq_len - len(d))
    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    seg = np.zeros((n, seq_len), np.int32)
    pos = np.zeros((n, seq_len), np.int32)
    for r, ds in enumerate(rows):
        off = 0
        for j, d in enumerate(ds):
            tokens[r, off:off + len(d)] = d
            seg[r, off:off + len(d)] = j + 1
            pos[r, off:off + len(d)] = np.arange(len(d))
            off += len(d)
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def packing_efficiency(packed: Dict[str, np.ndarray]) -> float:
    seg = packed["segment_ids"]
    return float((seg > 0).mean())
