"""The share of the expert products' buffer rows that hold a routed token
in the window, in %: the program's ``moe.entries`` (routed (token, expert)
entries) over its ``moe.slots`` (the rows the products run over), each the
difference of the counter between the window's open and its close as the
run recorded it; of a run that recorded no window, the process's counters
as the run leaves them."""
from portbench.harness import program


def read(run):
    if "moe_entries" in run:
        entries, slots = run["moe_entries"], run["moe_slots"]
    else:
        entries = program.counter("moe.entries")
        slots = program.counter("moe.slots")
    if not entries or not slots:
        return None
    return 100.0 * entries / slots
