# Counterpart of src/repro/data/__init__.py: the same re-exports.
from repro_torch.data.synthetic import (  # noqa: F401
    DEFAULT_DOMAINS, Domain, PhaseSchedule, SyntheticCorpus, default_schedule,
)
from repro_torch.data.packing import pack_documents, packing_efficiency  # noqa: F401
from repro_torch.data.loader import PrefetchLoader, host_slice  # noqa: F401
