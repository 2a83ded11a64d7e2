"""Structured logging: every human-readable line is also a JSONL record.

Port of ``src/repro/obs/logging.py`` (``:26-94``). A ``StructuredLogger``
sends the human line unchanged to its ``sink`` (default ``print``) and
keeps a parallel record ``{"ts", "level", "logger", "event", **fields}``
(plus ``msg`` when there is a line) in memory, and appends it as JSON Lines
to ``jsonl_path`` when one is set. ``as_logger`` adapts a plain callable,
so ``train_loop(log=print)`` and ``train_loop(log=lines.append)`` behave as
before: the callable becomes the human sink and the records ride beside it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable

LEVELS = ("debug", "info", "warning", "error")


class StructuredLogger:
    """``log(level, event, msg, **fields)`` -> the human line and a record.

    ``sink`` receives the human line (None silences it; the records still
    accumulate). ``min_level`` filters both. Records are plain dicts in
    ``records`` (at most ``max_records``) and, with ``jsonl_path``, lines
    appended to that file."""

    def __init__(self, name: str, sink: Callable[[str], None] | None = print,
                 jsonl_path: str | None = None, min_level: str = "debug",
                 max_records: int = 1 << 16):
        self.name = name
        self.sink = sink
        self.records: list[dict] = []
        self.max_records = max_records
        self._min = LEVELS.index(min_level)
        self._file = None
        if jsonl_path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._file = open(jsonl_path, "a")

    def log(self, level: str, event: str, msg: str | None = None, **fields) -> None:
        if LEVELS.index(level) < self._min:
            return
        rec = {"ts": time.time(), "level": level, "logger": self.name, "event": event,
               **fields}
        if msg is not None:
            rec["msg"] = msg
        if len(self.records) < self.max_records:
            self.records.append(rec)
        if self._file is not None:
            self._file.write(json.dumps(rec, default=str) + "\n")
            self._file.flush()
        if self.sink is not None and msg is not None:
            self.sink(msg)

    def debug(self, event: str, msg: str | None = None, **fields) -> None:
        self.log("debug", event, msg, **fields)

    def info(self, event: str, msg: str | None = None, **fields) -> None:
        self.log("info", event, msg, **fields)

    def warning(self, event: str, msg: str | None = None, **fields) -> None:
        self.log("warning", event, msg, **fields)

    def error(self, event: str, msg: str | None = None, **fields) -> None:
        self.log("error", event, msg, **fields)

    def __call__(self, msg: str) -> None:
        """The plain-callable surface: an "info" record of event "log"."""
        self.info("log", msg)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def as_logger(log, name: str = "loop") -> StructuredLogger:
    """A ``StructuredLogger`` as it is; any other callable becomes the
    human sink of a fresh one."""
    if isinstance(log, StructuredLogger):
        return log
    return StructuredLogger(name, sink=log)
