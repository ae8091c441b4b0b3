# Counterpart of src/repro/obs/log.py: a verbatim copy (numpy / stdlib only) with the
# package renamed in its imports; nothing of it is left unported.
"""Structured logging for the repro_torch CLIs and libraries.

One ``setup()`` replaces the per-launcher ``logging.basicConfig`` /
``print`` mix with a single handler emitting structured ``key=value``
lines::

    ts=2026-08-08T12:00:01.123 level=info logger=repro_torch.launch.pipeline \
        event=manifest_written path=/tmp/manifest.json

Level resolution order: explicit ``level`` argument, then the
``REPRO_LOG_LEVEL`` environment variable (``debug``/``info``/``warning``/
``error`` or a numeric level), then ``info``.  ``kv()`` is the logging
helper call sites use: an event name plus keyword fields, rendered in
stable order.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Any, Optional

ENV_LEVEL = "REPRO_LOG_LEVEL"
_ROOT = "repro"


def _quote(v: Any) -> str:
    s = str(v)
    if any(c in s for c in ' "='):
        return '"' + s.replace('"', r'\"') + '"'
    return s


class KVFormatter(logging.Formatter):
    """``key=value`` line formatter; extra fields come via ``kv()``."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(record.created))
        parts = [f"ts={ts}.{int(record.msecs):03d}",
                 f"level={record.levelname.lower()}",
                 f"logger={record.name}"]
        fields = getattr(record, "kv_fields", None)
        if fields is not None:
            parts.append(f"event={record.getMessage()}")
            parts.extend(f"{k}={_quote(v)}" for k, v in fields.items())
        else:
            parts.append(f"msg={_quote(record.getMessage())}")
        if record.exc_info:
            parts.append(f"exc={_quote(self.formatException(record.exc_info))}")
        return " ".join(parts)


def resolve_level(level: Optional[str] = None) -> int:
    raw = level if level is not None else os.environ.get(ENV_LEVEL, "info")
    if isinstance(raw, int):
        return raw
    raw = str(raw).strip()
    if raw.isdigit():
        return int(raw)
    resolved = logging.getLevelName(raw.upper())
    return resolved if isinstance(resolved, int) else logging.INFO


def setup(level: Optional[str] = None, stream=None) -> logging.Logger:
    """Install one KV-formatted handler on the ``repro`` logger (idempotent:
    re-running replaces the handler, so repeated CLI invocations in one
    process never double-log)."""
    root = logging.getLogger(_ROOT)
    root.setLevel(resolve_level(level))
    for h in list(root.handlers):
        if getattr(h, "_repro_kv", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stderr)
    handler.setFormatter(KVFormatter())
    handler._repro_kv = True
    root.addHandler(handler)
    root.propagate = False
    return root


def get_logger(name: str = _ROOT) -> logging.Logger:
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def kv(event: str, *, logger: str = _ROOT, level: int = logging.INFO,
       **fields: Any) -> None:
    """Log one structured event: ``kv("cache_hit", kind="profile", ...)``."""
    get_logger(logger).log(level, event, extra={"kv_fields": fields})
