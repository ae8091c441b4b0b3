"""What the benchmark takes from the program: its configuration type, built
from the configuration file by the family's module, and its counters.

The program is the PyTorch and CUDA package (``repro_torch``); this module
imports it only inside functions, after ``run.py`` has put ``src`` on the
path.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the memory's peak or
    operations at the bf16 peak, the larger."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def arch_config(cell):
    """The program's ``ArchConfig`` of the cell's configuration, with the
    traffic mix's program settings (``program`` in its file) on top."""
    from repro_torch.configs.base import (ArchConfig, AttnConfig, MoEConfig,
                                          SSMConfig)
    kw = dict(cell.family().program_config(cell.config))
    for key, cls in (("attn", AttnConfig), ("moe", MoEConfig),
                     ("ssm", SSMConfig)):
        if key in kw:
            kw[key] = cls(**kw[key])
    kw.update(cell.traffic.get("program", {}))
    return ArchConfig(name=cell.config["name"], source=cell.config["source"],
                      **kw)


def counter(name: str) -> float:
    from repro_torch import obs
    return float(obs.metrics().value(name) or 0.0)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics)."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
