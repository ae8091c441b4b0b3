"""K2 (flash decode) in the traced slice: the least time of its calls (the
cache rows of the active rows read once, at 3.35 TB/s, or their operations
at 989 TFLOP/s) over their device time, in %."""
import re

from portbench.harness.readers import k2_bounds, roofline

PATTERN = re.compile(r"flash_decode_kernel")


def read(run):
    return roofline(run, PATTERN, k2_bounds(run))
