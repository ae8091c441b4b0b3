"""The comparisons that decide ``correct``, against the plain reference
under ``reference/``, which imports nothing of the program.

A sample of the requests finished in the window, drawn from the seed with
the longest among them, is run through the reference once, prompt and
served tokens together; the numbers are the widest and the mean gap by which
a served token's reference logit lies below the reference's best at its
position.  The control puts the reference in float8 in the program's place:
its served tokens are those that it ranks first at the same positions, and
its gaps are read as the program's are.  A cell's limits file says which of
the numbers it compares.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.common import no_tf32


def serve_sample(finished: List, n_requests: int, seed: int) -> List:
    """The longest finished request and ``n_requests - 1`` others, drawn
    from the seed."""
    if not finished:
        return []
    done = sorted(finished, key=lambda r: r.req_id)
    longest = max(done, key=lambda r: (len(r.output), -r.req_id))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(np.random.SeedSequence([seed, 4])
                                  ).permutation(len(rest))
    return [longest] + [rest[i] for i in order[:n_requests - 1]]


def served_gaps(fam, c: dict, params, sample: List, prompt_len: int,
                device, control: str = "") -> Dict[str, float]:
    """The widest and the mean gap over the sample's served tokens (``inf``
    if there is nothing to compare); with ``control``, the gaps of the
    tokens that the reference in that precision ranks first."""
    no_tf32()
    gaps = []
    for r in sample:
        seq = np.concatenate([np.asarray(r.prompt, np.int64)[:prompt_len],
                              np.asarray(r.output[:-1], np.int64)])
        tokens = torch.from_numpy(seq).to(device)
        rows = slice(prompt_len - 1, prompt_len - 1 + len(r.output))
        ref = fam.forward(params, c, tokens, prompt_len, "f32")[rows]
        if control:
            chosen = fam.forward(params, c, tokens, prompt_len,
                                 control)[rows].argmax(-1)
        else:
            chosen = torch.tensor(r.output, device=device)
        gap = ref.max(-1).values - ref.gather(-1, chosen[:, None].long())[:, 0]
        gaps.append(gap.float().cpu())
        del ref
    if not gaps:
        return {"served_gap": float("inf"), "served_gap_mean": float("inf")}
    g = torch.cat(gaps)
    return {"served_gap": float(g.max()), "served_gap_mean": float(g.mean())}
