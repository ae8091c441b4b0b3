"""Milliseconds the host spends issuing one layer's latent attention in a
decode step (projections, the products to and from the latent, the kernel,
the output projection): the median of the program's ``attn.mla.decode``
histogram (one observation a layer a step) over its recent window, read from
the process's registry as the run leaves it.  A program without that span
gives nothing."""


def read(run):
    from repro_torch import obs
    h = obs.metrics().snapshot().get("attn.mla.decode")
    if not h or not h.get("count"):
        return None
    return 1e3 * h["p50"]
