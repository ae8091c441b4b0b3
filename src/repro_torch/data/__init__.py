# Counterpart of src/repro/data/__init__.py.  Not ported yet: `packing.py`
# and `loader.py` (document packing, the prefetch loader), which no ported
# path uses.
from repro_torch.data.synthetic import (  # noqa: F401
    DEFAULT_DOMAINS, Domain, PhaseSchedule, SyntheticCorpus, default_schedule,
)
