"""The device's idle share of the traced slice, in %."""
from portbench.harness.readers import idle_share as read  # noqa: F401
