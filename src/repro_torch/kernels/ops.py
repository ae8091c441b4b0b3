# Counterpart of src/repro/kernels/ops.py.  `ssd` (the Mamba2 intra-chunk
# kernel plus its inter-chunk recurrence) is not ported yet.
"""Model-facing wrappers of the kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, group: int,
                    causal: bool = True, window=None,
                    cap: float = 0.0) -> torch.Tensor:
    """Model-facing signature (positions are arange; rope pre-applied)."""
    return _flash(q, k, v, group=group, causal=causal, window=window, cap=cap)


def flash_decode(q, k_cache, v_cache, lengths, *, group: int, window=None,
                 cap: float = 0.0) -> torch.Tensor:
    return _flash_decode(q, k_cache, v_cache, lengths, group=group,
                         window=window, cap=cap)
