# Counterpart of src/repro/serve/sampler.py; nothing left unported.
"""Token samplers for decoding."""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: [B,1,V] -> [B,1] int32."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


def sample(logits: torch.Tensor, gen: Optional[torch.Generator], *,
           temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Categorical sample from ``gen`` (where the JAX package takes a PRNG
    key); the generator must live on the logits' device."""
    if temperature <= 0:
        return greedy(logits)
    lf = logits[:, -1].float() / temperature
    if top_k > 0:
        kth = torch.sort(lf, dim=-1).values[:, -top_k][:, None]
        lf = torch.where(lf < kth, float("-inf"), lf)
    probs = torch.softmax(lf, dim=-1)
    tok = torch.multinomial(probs, 1, generator=gen)
    return tok.to(torch.int32)
