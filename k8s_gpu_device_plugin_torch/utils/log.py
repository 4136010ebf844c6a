"""Structured JSON logging on the stdlib ``logging`` stack.

The port's own copy of the reference's ``utils/log.py`` contract: one
JSON object per line with the ``level/ts/caller/msg`` field names, plus
whatever a call passes as ``extra={"fields": {...}}``, and the active
span's ``trace_id``/``span_id`` (``obs/trace.py``) when a record is
logged inside one. Per-level file rotation stays with the reference.
"""

from __future__ import annotations

import json
import logging
import sys

from k8s_gpu_device_plugin_torch.obs.trace import current_trace_ids

_NAME = "tpu-device-plugin-torch"


class JsonFormatter(logging.Formatter):
    """One JSON object per line: {"level", "ts", "caller", "msg", ...fields}."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "level": record.levelname.lower(),
            "ts": round(record.created, 6),
            "caller": f"{record.filename}:{record.lineno}",
            "msg": record.getMessage(),
        }
        ids = current_trace_ids()
        if ids is not None:
            entry["trace_id"], entry["span_id"] = ids
        if record.exc_info and record.exc_info[0] is not None:
            entry["exc"] = self.formatException(record.exc_info)
        fields = getattr(record, "fields", None)
        if isinstance(fields, dict):
            entry.update(fields)
        return json.dumps(entry, default=str)


def get_logger() -> logging.Logger:
    """The process-global port logger (JSON lines on stderr, INFO and up).
    Configured once, on first use."""
    logger = logging.getLogger(_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(JsonFormatter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
