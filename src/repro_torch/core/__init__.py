# Counterpart of src/repro/core/__init__.py.  Re-exports what the port has:
# unit of work, block registry and tables, interval analysis.  Not ported yet:
# meter, select, kmeans, markers, nugget, replay, validate, profile_store,
# hlo_analysis.
from repro_torch.core.unit_of_work import IRCost, graph_cost, trace_cost  # noqa: F401
from repro_torch.core.registry import BlockDef, BlockTable, Segment  # noqa: F401
from repro_torch.core.blocks_lm import build_block_table  # noqa: F401
from repro_torch.core.intervals import (  # noqa: F401
    Interval, IntervalBuilder, Marker, Profile, build_profile,
    build_profile_from_steps, build_profile_parallel,
)
from repro_torch.core.intervals_vec import (  # noqa: F401
    ChunkResult, analyze_steps, analyze_steps_parallel, as_steps,
)
