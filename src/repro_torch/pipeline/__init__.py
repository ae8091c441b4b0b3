# Counterpart of src/repro/pipeline/__init__.py: the same re-exports; nothing of it
# is left unported.
"""Artifact-driven sampling pipeline: the paper's profile -> select ->
mark -> replay -> validate lifecycle as composable typed stages over a
content-addressed :class:`ArtifactStore` (see ``docs/pipeline.md``)."""
from repro_torch.pipeline.store import (  # noqa: F401
    ARTIFACT_KINDS, Artifact, ArtifactStore, artifact_key, canonical_json,
    persist_profile_cli,
)
from repro_torch.pipeline.stages import (  # noqa: F401
    BaselineStage, MarkStage, ProfileStage, ReplayStage, SelectStage, Stage,
    ValidateStage,
)
from repro_torch.pipeline.runtime import (  # noqa: F401
    Pipeline, PipelineConfig, PipelineContext, platform_config,
)
from repro_torch.pipeline.journal import RunJournal  # noqa: F401
from repro_torch.pipeline.scheduler import run_dag  # noqa: F401
from repro_torch.faults import (  # noqa: F401  (shared failure vocabulary)
    FaultInjector, RetryPolicy,
)
