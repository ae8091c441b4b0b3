"""Device choice of the port's entry points (no counterpart in ``src/repro``,
where JAX picks the backend).

An entry point runs on the card unless the caller asks for the CPU by name.
There is no silent fallback: with no card and no such request it raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; asking for ``cuda`` without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
