"""Structured logging with trace correlation (stdlib only — leaf module).

``setup()`` configures the ``repro_torch`` logger hierarchy once: plain
single-line text by default, JSON objects with ``--log-json`` — either way
every record carries the active trace id (``repro_torch.obs.trace``), so an
access-log line, an error and the ``/trace`` span tree of one request all
join on ``trace_id``.

Extra structured fields ride on ``logging``'s ``extra=`` mechanism:

    log.info("access", extra={"route": "/mine", "code": 200, "ms": 12.3})
"""

from __future__ import annotations

import json
import logging
import sys
import time

from .trace import current_trace_id

__all__ = ["setup", "get_logger", "JsonFormatter", "TextFormatter"]

# logging.LogRecord's own attribute names — anything else on a record came
# in through ``extra=`` and belongs in the structured payload
_RESERVED = frozenset(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


def _extras(record: logging.LogRecord) -> dict:
    return {
        k: v for k, v in record.__dict__.items()
        if k not in _RESERVED and not k.startswith("_")
    }


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        trace_id = getattr(record, "trace_id", None) or current_trace_id()
        if trace_id:
            out["trace_id"] = trace_id
        out.update(_extras(record))
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        trace_id = getattr(record, "trace_id", None) or current_trace_id()
        head = f"{ts} {record.levelname:<7} {record.name}: {record.getMessage()}"
        fields = _extras(record)
        if trace_id:
            fields = {"trace_id": trace_id, **fields}
        if fields:
            head += " " + " ".join(f"{k}={v}" for k, v in fields.items())
        if record.exc_info:
            head += "\n" + self.formatException(record.exc_info)
        return head


def setup(level: str = "info", json_mode: bool = False, stream=None) -> logging.Logger:
    """(Re)configure the ``repro_torch`` root logger; returns it. Idempotent —
    repeat calls replace the handler (tests re-setup with StringIO)."""
    logger = logging.getLogger("repro_torch")
    for h in list(logger.handlers):
        logger.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter() if json_mode else TextFormatter())
    logger.addHandler(handler)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    return logger


def get_logger(name: str = "repro_torch") -> logging.Logger:
    return logging.getLogger(name)
