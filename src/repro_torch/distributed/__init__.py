# Counterpart of src/repro/distributed/__init__.py: the same re-exports.
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingPlan, logical_rules, shard, spec_for, set_rules, active_rules,
    plan_for, params_shardings,
)
from repro_torch.distributed.pipeline import bubble_fraction, gpipe  # noqa: F401
from repro_torch.distributed.faults import (  # noqa: F401
    FaultInjectingRun, HeartbeatCoordinator,
)
