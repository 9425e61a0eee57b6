"""Shared logging setup: INFO/DEBUG to stdout, WARNING+ to stderr.

The port's own copy of ``analyzer_tpu.logging_utils`` (stdlib only; the
rater, the serve plane and the HTTP plumbing log through it), with the same
environment variable, so one setting governs both packages.

The reference duplicates this block in both files and marks it
``# TODO share this between the two classes`` (``rater.py:172-188``,
``worker.py:202-217``); this module is that TODO done. It also fixes the
reference's quirk of naming the logger with the literal string ``"__name__"``
(``rater.py:178``) — loggers here are namespaced per module.

Two operator affordances:

  * ``ANALYZER_TPU_LOG_LEVEL`` (DEBUG/INFO/WARNING/ERROR/CRITICAL) sets
    the level for every logger this module hands out — read per
    ``get_logger`` call, so an env change before a late import applies.
  * Records render as ONE structured key=value line
    (``ts=... level=... logger=... msg="..."``), the same shape the obs
    layer uses for event output (:func:`kv_line`), so worker logs and
    metric-event lines grep and parse with the same tooling.
"""

from __future__ import annotations

import logging
import os
import sys
import time

_ENV_LEVEL = "ANALYZER_TPU_LOG_LEVEL"


def kv_line(**fields) -> str:
    """``k=v`` pairs joined by spaces, values quoted when they contain
    whitespace or quotes — the shared structured-line vocabulary of the
    log formatter and the obs layer's event output."""
    parts = []
    for k, v in fields.items():
        s = str(v)
        if s == "" or any(c.isspace() for c in s) or '"' in s or "=" in s:
            s = '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
        parts.append(f"{k}={s}")
    return " ".join(parts)


class KVFormatter(logging.Formatter):
    """One structured line per record: ``ts=<iso8601> level=<level>
    logger=<name> msg="..."`` (plus ``exc`` when an exception rides
    along)."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime(
            "%Y-%m-%dT%H:%M:%S", time.localtime(record.created)
        ) + f".{int(record.msecs):03d}"
        fields = {
            "ts": ts,
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            fields["exc"] = self.formatException(record.exc_info)
        return kv_line(**fields)


class InfoFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno in (logging.DEBUG, logging.INFO)


def _env_level() -> int:
    name = os.environ.get(_ENV_LEVEL, "INFO").strip().upper()
    level = getattr(logging, name, None)
    return level if isinstance(level, int) else logging.INFO


_configured: set[str] = set()
_shared_handlers: list[logging.Handler] = []


def add_shared_handler(handler: logging.Handler) -> None:
    """Attaches ``handler`` to every logger this module configured and to
    all future ones. The loggers here deliberately do not propagate (the
    stream handlers would double-print under a configured root), so a
    root-level handler sees nothing — this is the sanctioned tap for
    whole-package capture (the flight recorder's event ring)."""
    if handler in _shared_handlers:
        return
    _shared_handlers.append(handler)
    for name in _configured:
        logging.getLogger(name).addHandler(handler)


def remove_shared_handler(handler: logging.Handler) -> None:
    if handler in _shared_handlers:
        _shared_handlers.remove(handler)
    for name in _configured:
        logging.getLogger(name).removeHandler(handler)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if name not in _configured:
        formatter = KVFormatter()
        h1 = logging.StreamHandler(sys.stdout)
        h1.setLevel(logging.DEBUG)  # the logger level is the one gate
        h1.addFilter(InfoFilter())
        h1.setFormatter(formatter)
        logger.addHandler(h1)
        h2 = logging.StreamHandler(sys.stderr)
        h2.setLevel(logging.WARNING)
        h2.setFormatter(formatter)
        logger.addHandler(h2)
        for shared in _shared_handlers:
            logger.addHandler(shared)
        logger.propagate = False
        _configured.add(name)
    logger.setLevel(_env_level())
    return logger
