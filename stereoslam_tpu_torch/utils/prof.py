"""Structured per-frame metrics and wall-clock profiling (copy of
``stereoslam_tpu/utils/prof.py``; framework-free).

The reference's observability is glog lines plus an end-of-run average FPS
(reference app/run_kitti_stereo.cpp:57-104, loopclosing.cpp:153-154).  Here
every frame gets a structured record (inliers, track count, stage timings,
keyframe/loop events) that can be dumped as JSONL or summarized, and stage
timers wrap the host-visible boundaries of the frame step.

For kernel-level profiling use ``torch.profiler.profile`` around a run
(``chip_smoke.py --profile N``) — the stage timers here measure
host-observed latency, which is the number the pipeline actually feels.
The timers add no device sync of their own.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
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
