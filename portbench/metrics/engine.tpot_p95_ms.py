"""The 95th percentile of the time per output token (host clock), over the
requests finished in the window: above capacity a reading, not a bound."""
from portbench.harness.readers import tpot_p95_ms as read  # noqa: F401
