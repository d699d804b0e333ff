"""Spans of the decode step and prefill (``models/runtime.py``), off by
default.

    tracing.enable(device_events=False)   # start recording
    with tracing.span("decode.qkv"):      # in the program
        ...
    spans = tracing.drain()               # [(name, host start ns, host end ns,
                                          #   device ms or None)], and empty
    tracing.count("decode.moe_tokens.3", t)  # in the program: add a device
    counts = tracing.drain_counts()       # tensor into a counter; {name: sum}
    tracing.disable()

Off, ``span`` returns one shared object whose ``__enter__`` and
``__exit__`` do nothing: no allocation, no clock read, no CUDA call. On,
a span reads ``time.perf_counter_ns()`` at entry and exit, the host clock
that a profiler's trace can be mapped onto by a marker kernel launched at
a known host time. With ``device_events`` (and a CUDA card) it also records
a timing ``torch.cuda.Event`` on the current stream at each end, except
while that stream is being captured into a CUDA graph, where an event
cannot be recorded; such a span has no device time. Nothing here
synchronises but ``drain``, which waits for the last event.

The spans of the decode step and of prefill are leaves: none opens inside
another, so a reader sums a name over the layers and never counts a
stretch twice. A span is appended when it closes. A counter adds device
tensors on their device (one addition a call, no host read) while
recording, and is not touched while off. ``disable`` stops
recording and keeps what was recorded until the next ``drain``; ``enable``
with a recording under way changes only whether device events are taken.
"""

from __future__ import annotations

import time

import torch


class _Off:
    """The span of the off state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


_recording = False
_device_events = False
# finished spans, (name, host start ns, host end ns, start event, end
# event), until drained; the events are None without device events
_spans: list = []
# counters, name -> the sum of the tensors counted, until drained
_counts: dict = {}


class _Span:
    __slots__ = ("name", "t0", "ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.ev0 = _event() if _device_events else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        ev1 = _event() if self.ev0 is not None else None
        _spans.append((self.name, self.t0, t1, self.ev0 if ev1 is not None else None, ev1))
        return False


def _event():
    """A timing event recorded on the current stream, or None while the
    stream is being captured."""
    if torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def enable(device_events: bool = False):
    """Start recording spans (host times; with ``device_events`` device
    times as well, where there is a CUDA card)."""
    global _recording, _device_events
    _device_events = device_events and torch.cuda.is_available()
    _recording = True


def disable():
    """Stop recording; what was recorded waits for ``drain``."""
    global _recording
    _recording = False


def recording() -> bool:
    """Whether spans and counters are being recorded."""
    return _recording


def span(name: str):
    """A context manager timing the code inside it as ``name``."""
    return _Span(name) if _recording else _OFF


def count(name: str, values: torch.Tensor):
    """Add ``values`` into the counter ``name`` while recording (on values'
    device, without a host read); nothing while off."""
    if _recording:
        held = _counts.get(name)
        _counts[name] = values.clone() if held is None else held + values


def drain_counts() -> dict:
    """{name: summed tensor} of the counters; the recorder's are emptied."""
    global _counts
    counts, _counts = _counts, {}
    return counts


def drain() -> list:
    """The finished spans, [(name, host start ns, host end ns, device ms or
    None)] in the order they closed; the recorder is emptied (it keeps
    recording if it was). Waits for the last device event."""
    global _spans
    spans, _spans = _spans, []
    last = next((ev1 for *_, ev1 in reversed(spans) if ev1 is not None), None)
    if last is not None:
        last.synchronize()
    return [(name, t0, t1, ev0.elapsed_time(ev1) if ev1 is not None else None)
            for name, t0, t1, ev0, ev1 in spans]
