# Counterpart of src/repro/train/__init__.py; nothing of it is left unported.
from repro_torch.train.state import (  # noqa: F401
    TrainState, init_train_state, make_train_step,
)
from repro_torch.train.trainer import Trainer, WatchdogReport  # noqa: F401
