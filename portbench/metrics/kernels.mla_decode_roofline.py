"""The latent-decode kernel in the traced slice: the least time of its calls
(one a layer a decode step: the active rows' cache keys read once, q read and
the output written, at 3.35 TB/s, or their operations at 989 TFLOP/s) over
their device time, in %.  A family without ``mla_decode_work``, or a program
without the kernel, gives nothing."""
import re

from portbench.harness.program import bound_s
from portbench.harness.readers import roofline

PATTERN = re.compile(r"mla_decode_kernel")


def read(run):
    fam, c = run["family"], run["config"]
    if not hasattr(fam, "mla_decode_work"):
        return None
    bounds = []
    for kind, positions in run.get("slice_steps", ()):
        if kind == "decode" and positions:
            b = bound_s(*fam.mla_decode_work(c, [p + 1 for p in positions]))
            bounds += [b] * fam.dims(c)["L"]
    return roofline(run, PATTERN, bounds)
