"""The whole step's share of the card's bf16 peak over the window, in %."""
from portbench.harness.readers import mfu as read  # noqa: F401
