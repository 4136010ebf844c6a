"""Structured JSON logging on the stdlib ``logging`` stack.

The port's own copy of the reference's ``utils/log.py`` contract: one
JSON object per line with the ``level/ts/caller/msg`` field names, plus
whatever a call passes as ``extra={"fields": {...}}``. Per-level file
rotation and trace-id stamping stay with the reference until the port
grows an observability layer.
"""

from __future__ import annotations

import json
import logging
import sys

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
