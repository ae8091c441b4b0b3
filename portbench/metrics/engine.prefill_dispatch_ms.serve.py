"""Milliseconds the host spends issuing a prefill: the median of the
program's ``engine.prefill.forward`` histogram (the model's prefill, the
copies into the slot and the sampler, up to its one device read; one
observation a prefill) over its recent window, read from the process's
registry as the run leaves it."""


def read(run):
    from repro_torch import obs
    h = obs.metrics().snapshot().get("engine.prefill.forward")
    if not h or not h.get("count"):
        return None
    return 1e3 * h["p50"]
