"""Milliseconds of the program's profile finalize (host clock)."""
from portbench.harness.readers import finalize_ms as read  # noqa: F401
