# Counterpart of src/repro/checkpoint/__init__.py; nothing of it is left
# unported.
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
