"""Profiling hooks (port of the JAX package's ``utils/profiling.py``): the
program's own spans, and device traces.

Two tiers:

- Always on, in memory: :func:`span` records a named host interval (start
  and end on ``time.perf_counter_ns``), its attributes, the span it opened
  in on its thread, and a unit id that every span of one request or step
  shares. Records go into a ring of ``RING`` records, so a long serving
  process holds a constant amount; :func:`records` hands them out. A span
  given a ``device`` is split into contiguous phases by :func:`phase`,
  each with its device milliseconds: one CUDA timing event on the span's
  stream at every phase boundary (:func:`records` synchronises on them),
  the host time standing in for it on the CPU. A CUDA event costs about as
  much as a span and a half to record and as much again to destroy, so on
  each thread such a span takes its events only where the last one that
  did began ``DEVICE_EVERY_NS`` or more before: every step of a step that
  long, one in a few of a shorter one (the others' ``device_ms`` is None),
  which holds their cost to about a tenth of a percent of the host's time.
  The program keeps about 4 spans a serving request
  (``infer.Predictor.rollout``) and 9 a training step (``train/step.py``).
- Only while a ``torch.profiler`` runs, each span also enters
  ``record_function("acgan:<name>")``, so the chrome trace holds it on the
  device trace's clock (``profile-report`` names idle gaps and splits
  device time by these spans). Without a profiler no ``record_function``
  is entered: checking for one costs a fraction of a microsecond, entering
  one several.

``ACGAN_TELEMETRY=0`` in the environment, read once at import, makes every
span and phase a no-op (to measure what the recorder costs).

``trace`` wraps steps in a ``torch.profiler`` trace written as a chrome
trace into a log directory (``utils/trace_report.py`` reads it, as
``train --profile-steps`` writes it). The JAX package's
``analytic_matmul_cost`` (FLOPs from a jaxpr) has its counterpart in
``bench.step_flop_counts``, which counts a step's conv and matmul FLOPs
with ``torch.utils.flop_counter`` on meta tensors.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, List, Optional

import torch

from action_conditioned_gans_tpu_torch.config import resolve_device

ENABLED = os.environ.get("ACGAN_TELEMETRY", "1") != "0"
RING = 1 << 15  # records kept: a whole 30 s window of the busiest serving path
DEVICE_EVERY_NS = 100_000_000  # least host time between two device-timed spans

_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_profiling = torch.autograd._profiler_enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """An open span, and once closed its record in the ring: ``name``,
    ``id``, ``parent`` (the id of the span it opened in on its thread, or
    None), ``unit`` (shared by the spans of one request or step), host
    ``start_ns`` / ``end_ns``, ``attrs``, and ``device_ms`` for a span given
    a device and its phases (None otherwise, and on CUDA for a span that
    took no events; resolved by :func:`records`)."""

    __slots__ = ("name", "id", "parent", "unit", "start_ns", "end_ns", "attrs", "device_ms",
                 "new_unit", "device", "owner", "_stream", "_phase", "_start", "_mark",
                 "_events", "_annotation")

    def __init__(self, name: str, unit: bool, device, attrs: dict, owner=None):
        self.name, self.new_unit, self.device, self.owner = name, unit, device, owner
        self.id, self.parent, self.unit = 0, None, 0
        self.start_ns = self.end_ns = 0
        self.attrs = attrs
        self.device_ms: Optional[float] = None
        self._stream = None  # the CUDA stream its phase boundaries are recorded on
        self._phase: Optional[Span] = None  # the open phase of a span given a device
        self._start = self._mark = None  # CUDA events: the span's start, the last boundary
        self._events = None  # (start, end) CUDA events until resolved
        self._annotation = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def set(self, **attrs) -> None:
        """Add attributes to the span's record."""
        self.attrs.update(attrs)

    def _event(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record(self._stream)
        return event

    def _open(self, stack: list) -> None:
        self.id = next(_ids)
        if stack:
            self.parent = stack[-1].id
            self.unit = self.id if self.new_unit else stack[-1].unit
        else:
            self.unit = self.id
        stack.append(self)
        if _profiling():
            self._annotation = torch.profiler.record_function(f"acgan:{self.name}")
            self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()

    def _close(self, end_event) -> None:
        self.end_ns = time.perf_counter_ns()
        if end_event is not None:
            self._events = (self._start, end_event)
        elif self.device is not None and self.device.type != "cuda":
            self.device_ms = self.host_ms
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        self._start = self._mark = self._stream = None
        _ring.append(self)

    def __enter__(self) -> "Span":
        if self.device is not None and self.device.type == "cuda":
            now = time.perf_counter_ns()
            if now - getattr(_local, "timed_ns", now - DEVICE_EVERY_NS) >= DEVICE_EVERY_NS:
                _local.timed_ns = now
                self._stream = torch.cuda.current_stream(self.device)
                self._start = self._mark = self._event()
        self._open(_stack())
        return self

    def __exit__(self, *exc) -> None:
        stack = _stack()
        end_event = self._event() if self._stream is not None else None
        if self._phase is not None:
            stack.pop()._close(end_event)
            self._phase = None
        stack.pop()
        self._close(end_event)


class _NoSpan:
    """What :func:`span` returns with ``ACGAN_TELEMETRY=0``."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, *, unit: bool = False, device=None, **attrs):
    """A context manager recording the enclosed host work as ``name``
    (module docstring), with ``attrs``; ``.set(**attrs)`` adds to them
    before it closes:

        with profiling.span("rollout", unit=True, B=8) as s:
            ...
            s.set(dispatches=330)

    A span without an enclosing span on its thread, or with ``unit``,
    starts a unit. Given ``device``, :func:`phase` splits it and each phase
    gets its device milliseconds (on CUDA, where the span takes its events:
    module docstring)."""
    if not ENABLED:
        return _NO_SPAN
    return Span(name, unit, None if device is None else torch.device(device), attrs)


def phase(name: str) -> None:
    """End the open phase of the innermost span given a device on this
    thread and start its phase ``<span>.<name>``: the two share one
    boundary (one CUDA event on the device). The span's exit ends its last
    phase. Nothing happens where the innermost open span is neither such a
    span nor one of its phases."""
    if not ENABLED:
        return
    stack = _stack()
    if not stack:
        return
    owner = stack[-1].owner or stack[-1]
    if owner.device is None:
        return
    if owner._phase is not None:
        boundary = owner._event() if owner._stream is not None else None
        stack.pop()._close(boundary)
        owner._mark = boundary
    child = Span(f"{owner.name}.{name}", False, owner.device, {}, owner)
    child._start = owner._mark
    owner._phase = child
    child._open(stack)


def records() -> List[Span]:
    """The ring's records in the order they opened, after waiting for the
    CUDA events of those whose device time is not resolved yet."""
    out = sorted(list(_ring), key=lambda r: r.start_ns)
    for rec in out:
        if rec._events is not None:
            start, end = rec._events
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec._events = None
    return out


def reset() -> None:
    """Forget every record (spans open now still record)."""
    _ring.clear()


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[None]:
    """A device trace of the enclosed steps, as ``<logdir>/trace.json``:

        with profiling.trace("/tmp/trace"):
            for _ in range(10):
                state, m = step(state, batch)

    ``device`` (cuda unless another is given) is synchronised before the
    trace closes. View it in Perfetto or ``chrome://tracing``, or summarise
    it with ``profile-report``."""
    os.makedirs(logdir, exist_ok=True)
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
