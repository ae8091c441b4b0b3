# Counterpart of src/repro/core/__init__.py: the same re-exports, with
# `graph_cost` (the ATen graph's cost) where the reference has `jaxpr_cost`.
# `hlo_analysis` analyses the per-rank program that DTensor dispatches (the
# port has no compiled HLO), and holds the §V-B study's histograms and the
# block-label search over a recorded profile.
"""Nugget for PyTorch: the paper's portable targeted-sampling framework.

Pipeline (paper Fig. 1):
  preparation  -> BlockTable (blocks_lm.build_block_table)
  analysis     -> WorkMeter hooks + IntervalBuilder -> Profile
  selection    -> select.{Random,KMeans,Systematic}Selector -> Selection
  creation     -> nugget.create_nuggets (markers incl. low-overhead search)
  validation   -> replay.ReplayEngine + validate.* (native, cross-platform)
"""
from repro_torch.core.unit_of_work import IRCost, graph_cost, trace_cost  # noqa: F401
from repro_torch.core.registry import BlockDef, BlockTable, Segment  # noqa: F401
from repro_torch.core.blocks_lm import build_block_table  # noqa: F401
from repro_torch.core.meter import (  # noqa: F401
    init_meter, materialize_dyn, meter_value, read_meter, read_meters,
    tick_step,
)
from repro_torch.core.intervals import (  # noqa: F401
    Interval, IntervalBuilder, Marker, Profile, build_profile,
    build_profile_from_steps, build_profile_parallel,
)
from repro_torch.core.intervals_vec import (  # noqa: F401
    ChunkResult, analyze_steps, analyze_steps_parallel, as_steps,
)
from repro_torch.core.select import (  # noqa: F401
    KMeansSelector, RandomSelector, Selection, SystematicSelector, SELECTORS,
)
from repro_torch.core.markers import (  # noqa: F401
    MarkerPlan, low_overhead_marker, marker_hook_fraction, plan_markers,
)
from repro_torch.core.nugget import Nugget, create_nuggets, load_nuggets, save_nuggets  # noqa: F401
from repro_torch.core.replay import ReplayEngine, ReplayResult, SimpleRunner, measure_full_run  # noqa: F401
from repro_torch.core.validate import (  # noqa: F401
    PlatformResult, consistency_report, full_run_baseline, nugget_variability,
    platform_results, predict_total_time, prediction_error,
    signature_divergence, speedup_error_matrix, validation_report,
)
from repro_torch.core.profile_store import (  # noqa: F401
    cached_build, cached_finalize, load_profile, profile_cache_key,
    save_profile, stream_digest,
)
from repro_torch.core import hlo_analysis  # noqa: F401
