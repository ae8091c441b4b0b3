# Counterpart of src/repro/distributed/pipeline.py; nothing of it is left
# unported.  The reference's `shard_map` over the stage axis becomes one
# process a stage: each rank holds its stage's parameters (its slice of the
# stacked tree), a Python loop of M + S - 1 ticks replaces the `lax.scan`,
# the ring permute is `dist.batch_isend_irecv` to the next rank and from the
# previous one, and the closing `psum` of the masked outputs an
# `all_reduce(SUM)`.
"""GPipe-style pipeline parallelism over a "stage" group of ranks.

The production meshes are (data, model)-shaped, so PP is an *optional* extra
dimension for deployments that prefer pipelining over FSDP for very deep
models (88-layer mistral at low batch).  Each rank owns one stage's params;
M + S - 1 ticks stream microbatches through a ring (the classic GPipe
schedule, bubble fraction (S-1)/(M+S-1)).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import process_group


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          group_or_mesh=None, axis: str = "stage"):
    """Build a pipelined apply: (this rank's stage params, microbatches
    [M, mb, ...]) -> outputs [M, mb, ...] on every rank of the group.

    ``stage_fn(params_one_stage, x) -> y`` must be shape-preserving (x and y
    share shape and dtype — standard residual-stack stages).  Stage ``i`` is
    rank ``i`` of the process group, or of the DeviceMesh's ``axis`` dim;
    every rank passes the same microbatches."""
    pg = process_group(group_or_mesh, axis)

    def apply(params, xs: torch.Tensor) -> torch.Tensor:
        n_stages = dist.get_world_size(pg)
        idx = dist.get_rank(pg)
        nxt = dist.get_global_rank(pg, (idx + 1) % n_stages) \
            if pg is not None else (idx + 1) % n_stages
        prv = dist.get_global_rank(pg, (idx - 1) % n_stages) \
            if pg is not None else (idx - 1) % n_stages
        m = xs.shape[0]
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            # stage 0 injects microbatch t (while available); other stages
            # consume what the previous stage passed in
            inp = xs[min(t, m - 1)] if idx == 0 else buf
            y = stage_fn(params, inp)
            if n_stages > 1:
                buf = torch.empty_like(y)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, pg),
                    dist.P2POp(dist.irecv, buf, prv, pg)])
                for r in reqs:
                    r.wait()
            mb = t - (n_stages - 1)
            if idx == n_stages - 1 and mb >= 0:
                outs[mb] = y
        # replicate the last stage's outputs to every stage
        outs = outs * float(idx == n_stages - 1)
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=pg)
        return outs

    return apply


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
