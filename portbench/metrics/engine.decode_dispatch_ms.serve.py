"""Milliseconds the host spends issuing a decode step: the median of the
program's ``engine.decode.forward`` histogram (the step's model call and
sampler, up to its one device read; one observation a step) over its recent
window, read from the process's registry as the run leaves it."""


def read(run):
    from repro_torch import obs
    h = obs.metrics().snapshot().get("engine.decode.forward")
    if not h or not h.get("count"):
        return None
    return 1e3 * h["p50"]
