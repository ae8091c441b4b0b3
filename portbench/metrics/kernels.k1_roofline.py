"""K1 (flash attention over a prompt) in the traced slice: the least time
of its calls (q, k, v read once and the output written once, at 3.35 TB/s,
or the causal pairs' operations at 989 TFLOP/s) over their device time, in
%."""
import re

from portbench.harness.readers import k1_bounds, roofline

PATTERN = re.compile(r"flash_attention(_bf16)?_kernel")


def read(run):
    return roofline(run, PATTERN, k1_bounds(run))
