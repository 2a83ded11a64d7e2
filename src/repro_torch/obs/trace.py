"""Structured span tracer: nestable wall-clock spans, Chrome-trace export.

``tracer.span("gather_prefetch")`` is a context manager; spans nest through
a per-thread stack so concurrent engine/loop threads interleave without
locking the hot path (only the shared event list append is locked). Two
export forms:

  * ``write_jsonl(path)`` — one event per line, machine-grep-friendly;
  * ``write_chrome_trace(path)`` / ``to_chrome_trace()`` — the Chrome
    trace-event JSON (``{"traceEvents": [...]}``) Perfetto and
    ``chrome://tracing`` load directly: complete ("ph": "X") events with
    microsecond ``ts``/``dur``, instant ("ph": "i") marks, and process/
    thread-name metadata ("ph": "M").

Disabled tracers still *measure* (two ``perf_counter`` reads — the span
object's ``dur_s`` is always valid, which is what lets benchmark scripts use
one clock for their own reporting) but retain nothing, so the retained-event
path costs zero when telemetry is off.
"""
from __future__ import annotations

import json
import os
import threading
import time


class Span:
    """One timed region. ``dur_s`` is valid after the ``with`` block exits
    whether or not the tracer retains events."""

    __slots__ = ("name", "attrs", "t0_s", "dur_s", "depth", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0_s = 0.0
        self.dur_s = 0.0
        self.depth = 0

    def __enter__(self) -> "Span":
        self.depth = len(self._tracer._stack_of(threading.get_ident()))
        self._tracer._stack_of(threading.get_ident()).append(self)
        self.t0_s = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.dur_s = time.perf_counter() - self.t0_s
        stack = self._tracer._stack_of(threading.get_ident())
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self)


class Tracer:
    """Span recorder. ``enabled=False`` keeps the timing contract but drops
    every event (the no-op used when telemetry is off)."""

    def __init__(self, enabled: bool = True, max_events: int = 1 << 18):
        self.enabled = enabled
        self.max_events = max_events
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._stacks: dict[int, list] = {}
        self._epoch = time.perf_counter()

    def _stack_of(self, tid: int) -> list:
        got = self._stacks.get(tid)
        if got is None:
            got = self._stacks.setdefault(tid, [])
        return got

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration mark (Chrome "i" event)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i",
              "ts_s": time.perf_counter() - self._epoch, "dur_s": 0.0,
              "tid": threading.get_ident(), "depth": 0, "args": attrs}
        with self._lock:
            if len(self.events) < self.max_events:
                self.events.append(ev)

    def _record(self, span: Span) -> None:
        if not self.enabled:
            return
        ev = {"name": span.name, "ph": "X",
              "ts_s": span.t0_s - self._epoch, "dur_s": span.dur_s,
              "tid": threading.get_ident(), "depth": span.depth,
              "args": span.attrs}
        with self._lock:
            if len(self.events) < self.max_events:
                self.events.append(ev)

    # -- export ---------------------------------------------------------------
    def to_chrome_trace(self, process_name: str = "repro") -> dict:
        """Chrome trace-event format: ``ts``/``dur`` in microseconds,
        complete events per span, thread-name metadata per seen thread."""
        with self._lock:
            events = list(self.events)
        tids = sorted({e["tid"] for e in events})
        tid_ix = {t: i for i, t in enumerate(tids)}
        out = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                "args": {"name": process_name}}]
        for t in tids:
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid_ix[t], "args": {"name": f"thread-{tid_ix[t]}"}})
        for e in events:
            rec = {"name": e["name"], "ph": e["ph"], "pid": 0,
                   "tid": tid_ix[e["tid"]],
                   "ts": round(e["ts_s"] * 1e6, 3)}
            if e["ph"] == "X":
                rec["dur"] = round(e["dur_s"] * 1e6, 3)
            if e["ph"] == "i":
                rec["s"] = "t"  # instant scope: thread
            if e["args"]:
                rec["args"] = {k: v for k, v in e["args"].items()}
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str, process_name: str = "repro") -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(process_name), f)
            f.write("\n")
        return path

    def write_jsonl(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with self._lock:
            events = list(self.events)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        return path


NULL_TRACER = Tracer(enabled=False)
