"""Milliseconds per engine iteration in the window (host clock over the
program's iteration counters)."""
from portbench.harness.readers import ms_per_iter as read  # noqa: F401
