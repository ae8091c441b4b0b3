"""Helpers shared by the tests of the PyTorch port: numpy inputs from a seed
handed to both packages, parameters of the JAX package converted into the
port's, and a runner of spawned process groups.  JAX is imported inside the
functions that need it, so that a spawned rank, which imports this module to
run, does not load it."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model as pt_build_model


# reduced SSM-family configs of the tests: mamba2, and a hybrid of two groups
# of two Mamba2 layers plus a remainder of one (`reduced()` sets
# attn_every = 2; with its default n_layers = 2 there would be no remainder)
SSM_ARCHS = {"mamba2-780m": {}, "zamba2-1.2b": dict(n_layers=5)}


def to_jax(a: np.ndarray, bf16: bool = False):
    import jax.numpy as jnp
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if bf16 else x


def to_torch(a: np.ndarray, bf16: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close_to_scale(got, want, tol: float = 2e-4) -> None:
    """max |got - want| <= tol * max(1, max |want|): for outputs whose f32
    rounding grows with their magnitude (SSM states, gated-norm blocks)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def model_pair(arch: str, jax_impl: str = "pallas", **reduce_kw):
    """(jax cfg, jax model, jax params, port cfg, port model, port params) at
    the reduced size, the port's parameters converted from the JAX ones."""
    import jax

    from repro.configs import get_config as jx_get_config
    from repro.configs import reduced as jx_reduced
    from repro.models.model_zoo import build_model as jx_build_model
    jcfg = dataclasses.replace(jx_reduced(jx_get_config(arch), **reduce_kw),
                               attention_impl=jax_impl)
    jmodel = jx_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    pcfg = pt_reduced(pt_get_config(arch), **reduce_kw)
    pmodel = pt_build_model(pcfg, device="cpu")
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                device="cpu")
    return jcfg, jmodel, jparams, pcfg, pmodel, pparams


def run_ranks(target, world: int, *args, timeout: float = 240.0) -> list:
    """Run ``target(rank, world, init_file, *args)`` in ``world`` spawned
    processes that meet at a ``file://`` store in a fresh temporary
    directory (no fixed port), and return each rank's return value, in
    rank order.  The target must be a module-level function of a module
    that the children can import, and its return value picklable.  A rank
    that raises fails the call with its traceback; a group that has not
    finished after ``timeout`` seconds (a rank stuck in a collective) is
    killed and fails it too."""
    import multiprocessing as mp
    import os
    import queue as queue_mod
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        init_file = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(target, r, world, init_file, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world} ranks did not finish in {timeout} s; "
                        f"done: {sorted(out)}")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [p for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and len(out) < world:
                        raise RuntimeError(
                            f"rank process exited with {dead[0].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [out[r] for r in range(world)]


def _rank_main(target, rank, world, init_file, args, results):
    """A spawned rank: one CPU thread (the ranks share the host's cores),
    the target's value or its traceback onto the queue, the process group
    destroyed at the end."""
    import traceback
    torch.set_num_threads(1)
    try:
        value = target(rank, world, init_file, *args)
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
