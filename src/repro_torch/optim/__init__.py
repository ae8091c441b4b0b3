# Counterpart of src/repro/optim/__init__.py; nothing of it is left unported.
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, OptState, adamw_update, clip_by_global_norm, global_norm,
    init_opt_state, opt_state_axes,
)
from repro_torch.optim.schedule import constant, linear_warmup_cosine  # noqa: F401
from repro_torch.optim.grad_compress import (  # noqa: F401
    compressed_psum, compression_ratio, init_error_feedback, quantize_int8,
    dequantize,
)
