"""Structured per-frame metrics and wall-clock profiling (``Profiler`` and
``FrameRecord`` copy ``stereoslam_tpu/utils/prof.py``), and the port's spans
and host-read counter.

The reference's observability is glog lines plus an end-of-run average FPS
(reference app/run_kitti_stereo.cpp:57-104, loopclosing.cpp:153-154).  Here
every frame gets a structured record (inliers, track count, stage timings,
keyframe/loop events) that can be dumped as JSONL or summarized, and stage
timers wrap the host-visible boundaries of the frame step.

For kernel-level profiling use ``torch.profiler.profile`` around a run
(the benchmark's traced run, ``slambench/run.py --trace 1``) — the stage
timers here measure host-observed latency, which is the number the pipeline
actually feels.  The timers add no device sync of their own.

**Spans.**  ``with span(name, into=record):`` times a stretch of host code
and, while ``torch.profiler`` records, also puts it on the profiler's
timeline as a host event named ``slam.<name>``, on the clock of the
device's events.  ``into`` (a mapping of name to seconds, such as a
``defaultdict(float)``) gets the stretch's ``perf_counter`` seconds added
under ``name``.  With the profiler off a span costs two clock reads and one
flag check: the profiler's own ``record_function`` costs about 14 us even
then, so it is entered only while the profiler records.  The event is a
function-scope one (``RecordFunctionFast``), not ``record_function``'s
user-scope one: CUPTI copies a user-scope range onto the device's timeline
too, where it would read as device time.  ``Profiler.stage`` emits the same
event, so ``StereoSlam``'s ``track`` and ``branch`` stages reach the trace.

**Host reads.**  :class:`HostReads` counts the blocking host syncs of a
facade by site, with the seconds each blocked the host: ``with
host_read(reads, site, n):`` around the statement that makes ``n`` of them:
a device-to-host read (``int()``, ``.tolist()``, an event's
``synchronize()``), a read that PyTorch makes inside an op (an index by a
0-dim tensor, ``torch.linalg.eigh``'s status), or a Python scalar written
into a device tensor (a pageable host-to-device copy, which waits for the
stream as a read does).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, MutableMapping, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

_profiler_enabled = torch._C._autograd._profiler_enabled
SPAN_PREFIX = "slam."


def _trace_open(name: str):
    """The profiler's event for ``slam.<name>``, entered; None while the
    profiler does not record."""
    if not _profiler_enabled():
        return None
    ev = _RecordFunctionFast(SPAN_PREFIX + name)
    ev.__enter__()
    return ev


class span:
    """``with span(name, into=record):`` a stretch of host code: a
    ``slam.<name>`` event while the profiler records, and its seconds added
    to ``into[name]`` where ``into`` is given; ``seconds`` after the exit."""

    __slots__ = ("name", "into", "seconds", "_ev", "_t0")

    def __init__(self, name: str, into: Optional[MutableMapping[str, float]] = None):
        self.name, self.into = name, into

    def __enter__(self):
        self._ev = _trace_open(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = dt = time.perf_counter() - self._t0
        if self._ev is not None:
            self._ev.__exit__(None, None, None)
        if self.into is not None:
            self.into[self.name] += dt
        return False


class HostReads:
    """Blocking host syncs by site: ``counts[site]`` syncs, ``seconds[site]``
    the host spent blocked in them, and the totals ``n`` and ``s``."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = defaultdict(int)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.n = 0
        self.s = 0.0


class _Read(span):
    """The span ``read.<site>``, counted in ``reads``."""

    __slots__ = ("reads", "site", "n")

    def __init__(self, reads: HostReads, site: str, n: int = 1):
        super().__init__("read." + site)
        self.reads, self.site, self.n = reads, site, n

    def __exit__(self, *exc):
        super().__exit__(*exc)
        r, dt = self.reads, self.seconds
        r.counts[self.site] += self.n
        r.seconds[self.site] += dt
        r.n += self.n
        r.s += dt
        return False


def host_read(reads: Optional[HostReads], site: str, n: int = 1):
    """``with host_read(reads, site, n):`` around a statement that makes ``n``
    blocking syncs; counted in ``reads`` where it is given."""
    return span("read." + site) if reads is None else _Read(reads, site, n)


@dataclass
class FrameRecord:
    frame: int
    timestamp: float
    status: int
    num_inliers: int = -1
    num_tracked: int = -1
    keyframe_id: int = -1
    loop_closed_with: int = -1
    stage_ms: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(self.__dict__, separators=(",", ":"))


class Profiler:
    """Collects per-frame records + aggregate stage timings."""

    def __init__(self) -> None:
        self.frames: List[FrameRecord] = []
        self._stage_totals: Dict[str, float] = defaultdict(float)
        self._stage_counts: Dict[str, int] = defaultdict(int)
        self._current: Optional[FrameRecord] = None

    def start_frame(self, frame: int, timestamp: float) -> FrameRecord:
        self._current = FrameRecord(frame=frame, timestamp=timestamp, status=-1)
        return self._current

    def end_frame(self) -> None:
        if self._current is not None:
            self.frames.append(self._current)
            self._current = None

    @contextmanager
    def stage(self, name: str):
        ev = _trace_open(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            if ev is not None:
                ev.__exit__(None, None, None)
            self._stage_totals[name] += dt
            self._stage_counts[name] += 1
            if self._current is not None:
                self._current.stage_ms[name] = round(
                    self._current.stage_ms.get(name, 0.0) + dt, 3
                )

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_ms": round(total, 1),
                "count": self._stage_counts[name],
                "mean_ms": round(total / max(self._stage_counts[name], 1), 2),
            }
            for name, total in sorted(self._stage_totals.items())
        }

    def dump_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for rec in self.frames:
                f.write(rec.to_json() + "\n")
        return path
