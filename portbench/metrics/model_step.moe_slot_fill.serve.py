"""The share of the expert products' buffer rows that hold a routed token,
in %: the program's ``moe.entries`` (routed (token, expert) entries) over
its ``moe.slots`` (the rows the products run over), read from the process's
registry as the run leaves it: the whole process, warm-up, pre-roll and
profiled slice included, not the window alone."""
from portbench.harness import program


def read(run):
    entries = program.counter("moe.entries")
    slots = program.counter("moe.slots")
    if not entries or not slots:
        return None
    return 100.0 * entries / slots
