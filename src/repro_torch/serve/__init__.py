# Counterpart of src/repro/serve/__init__.py.
from repro_torch.serve.engine import Request, ServeEngine, SyntheticRequests  # noqa: F401
from repro_torch.serve.sampler import greedy, sample  # noqa: F401
