# Counterpart of src/repro/optim/__init__.py.  Not ported yet: the gradient
# compression of `grad_compress.py` and `opt_state_axes`, which wait for the
# distributed slice.
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, OptState, adamw_update, clip_by_global_norm, global_norm,
    init_opt_state,
)
from repro_torch.optim.schedule import constant, linear_warmup_cosine  # noqa: F401
