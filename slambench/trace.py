"""The traced window: ``torch.profiler`` over the CPU and the card, read
from its raw events (the profiler's own per-event tables would take minutes
over the million kernels of a window with BA graph replays).

From the trace: the device's busy seconds (the union of every kernel, copy
and set on the card, inside the benchmark's ``slambench.window`` span), the
kernel time by name, the busy time of each stream, and the longest idle
gaps, each named by what the host was doing at its middle (the innermost
host event there, inside the innermost ``slambench.*`` span).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

MARK_PREFIX = "slambench."
WINDOW_SPAN = MARK_PREFIX + "window"
TOP = 10
NAME_CHARS = 160


def no_mark(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass
class Summary:
    window_s: float            # the traced window, by the trace's clock
    busy_s: float              # seconds with an operation on the device
    kernel_s: Dict[str, float]  # device seconds by operation name
    stream_s: Dict[int, float]  # busy seconds by stream
    idle_gaps: List[Tuple[str, float]]
    device_events: int

    def device_ops(self) -> List[List]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:NAME_CHARS], s] for name, s in top]


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Tracer:
    """``with Tracer(device) as t: ... t.mark(name) ...``; then ``t.summary()``."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    @staticmethod
    def mark(name: str):
        return torch.profiler.record_function(name)

    def summary(self) -> Summary:
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        host, dev = [], []
        window = None
        for e in events:
            s = _start_ns(e)
            d = _dur_ns(e)
            if e.device_type() == DeviceType.CUDA:
                if not e.name().startswith(MARK_PREFIX):  # a mark's span on the device's timeline
                    dev.append((s, s + d, e.name(), e.device_resource_id()))
            else:
                name = e.name()
                if name == WINDOW_SPAN:
                    window = (s, s + d)
                host.append((s, s + d, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        w0, w1 = window
        kernel_s: Dict[str, float] = defaultdict(float)
        per_stream: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        spans = []
        for a, b, name, stream in dev:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            kernel_s[name] += (b - a) * 1e-9
            per_stream[stream].append((a, b))
            spans.append((a, b))
        busy = _merge(spans)
        busy_ns = sum(b - a for a, b in busy)
        gaps = []
        cursor = w0
        for a, b in busy:
            if a > cursor:
                gaps.append((a - cursor, cursor, a))
            cursor = max(cursor, b)
        if w1 > cursor:
            gaps.append((w1 - cursor, cursor, w1))
        gaps = sorted(gaps, reverse=True)[:TOP]
        return Summary(
            window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, kernel_s=dict(kernel_s),
            stream_s={k: sum(b - a for a, b in _merge(v)) * 1e-9 for k, v in per_stream.items()},
            idle_gaps=[[_label(host, (a + b) // 2)[:NAME_CHARS], n * 1e-9] for n, a, b in gaps],
            device_events=len(dev))


def _label(host: List[Tuple[int, int, str]], t: int) -> str:
    """What the host was doing at ``t``: the innermost host event covering
    it, inside the innermost ``slambench.*`` span covering it."""
    inner: Optional[Tuple[int, int, str]] = None
    span: Optional[Tuple[int, int, str]] = None
    for a, b, name in host:
        if a <= t < b:
            if name.startswith(MARK_PREFIX) and name != WINDOW_SPAN:
                if span is None or b - a < span[1] - span[0]:
                    span = (a, b, name)
            elif inner is None or b - a < inner[1] - inner[0]:
                inner = (a, b, name)
    where = span[2] if span else WINDOW_SPAN
    return f"{where}: {inner[2] if inner else 'python'}"

