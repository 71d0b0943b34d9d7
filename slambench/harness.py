"""One run of one cell: set-up, warm-up, the measured window, the program's
outputs checked against the plain reference, and the result.

Two drives serve every cell; the configuration's ``system`` picks one:

- ``StereoSlam``: one vehicle.  Each frame goes to ``process_staged`` and
  the card is synchronised before the next (closed loop: the caller needs
  every pose before it sends the next frame).  A frame's host-clock time,
  from the call to the synchronised card, is its latency.
- ``MultiSeqVO``: a fleet of ``streams`` vehicles, one batched step a call,
  the next step sent as soon as the call returns (closed loop over the
  batch), the recordings processed as drives of ``drive_frames`` frames;
  the window ends once every step handed in has retired and the card is
  synchronised.

The program sees only the staged frames and their timestamps (the
configuration's ``timestep_s`` apart).  Around the calls into its layers the
benchmark keeps its own spans (a frame's kind and time, the facade's
counters) and, where a check samples it, a copy of the state a layer read
and of what it wrote.  A traced window runs the profiler and nothing else.

A ``StereoSlam`` configuration has no cell of its own yet; its drive is
kept so that a cell of it needs only data files and readers.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from slambench import check as check_mod
from slambench import trajectory
from slambench.roofline import lk_work
from slambench.traffic import drive


@dataclasses.dataclass
class Span:
    """One frame (or one fleet step) of the window."""

    t0: float
    t1: float
    kind: str          # "plain", "keyframe", "replenish" (StereoSlam); "step", "drive_start" (fleet)
    reads: int = 0     # the facade's outcome reads inside the call
    serviced: int = 0  # keyframes serviced in the step (fleet)

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    seed: int
    device: torch.device
    spans: List[Span] = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    facade: object = None
    lap: Optional[drive.Lap] = None
    stage_s: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: object = None   # trace.Summary of a traced window
    probe: dict = dataclasses.field(default_factory=dict)  # inputs kept for the kernel readers
    samples: dict = dataclasses.field(default_factory=dict)  # the check's samples (check.py)
    notes: dict = dataclasses.field(default_factory=dict)  # earlier lines of the output

    def frames(self, kind: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans if kind is None or s.kind == kind]


def slam_config(cfg: dict):
    """The program's ``SlamConfig`` from the configuration's ``slam`` section:
    every key stated, none left to the program's defaults."""
    from stereoslam_tpu_torch.config import SlamConfig

    base = SlamConfig()
    kw = {}
    for key, value in cfg["slam"].items():
        cur = getattr(base, key)  # an unknown key raises
        if dataclasses.is_dataclass(cur):
            kw[key] = dataclasses.replace(cur, **{k: tuple(v) if isinstance(v, list) else v
                                                  for k, v in value.items()})
        else:
            kw[key] = value
    return base.replace(**kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class OnlineDrive:
    """One vehicle through ``StereoSlam.process_staged``."""

    def __init__(self, run: Run, sampler: "check_mod.Sampler"):
        from stereoslam_tpu_torch.core.system import StereoSlam

        self.run, self.sampler = run, sampler
        args = run.config["system_args"]
        self.slam = StereoSlam(slam_config(run.config), device=run.device,
                               enable_loop=args["enable_loop"],
                               readback_lag=run.cell["drive"]["readback_lag"],
                               inline_ba=args["inline_ba"])
        run.facade = self.slam
        self.n = len(run.lap.T_cw)
        self.start = drive.stream_starts(run.lap, 1, run.cell["drive"]["start"])[0]
        self.k = 0       # frames handed in
        self.lost = False
        self.sampler.attach_ba(self.slam)

    def lap_index(self, k: int) -> int:
        return (self.start + k) % self.n

    def _counts(self):
        m = self.slam.map
        return int(m.n_kf), int(m.n_lm)

    def warm_up(self) -> None:
        """Initialization (with the first BA's capture), the tracked frame's
        capture, and frames until a keyframe branch and a replenishment have
        run, so that no kernel is first loaded inside the window."""
        t = self.run.cell["drive"]
        before = self._counts()
        replenishes = self.slam.cfg.tracking.replenish_min_inliers > 0
        seen_kf = seen_rep = False
        self.sampler.take_next_ba(self.lap_index(0))
        while self.k < t["warmup_frames_max"]:
            ok = self._hand()
            _sync(self.run.device)
            after = self._counts()
            seen_kf |= self.k > 1 and after[0] != before[0]
            seen_rep |= self.k > 1 and after[0] == before[0] and after[1] != before[1]
            before = after
            if not ok:
                raise RuntimeError(f"tracking LOST during warm-up, frame {self.k - 1}")
            if seen_kf and (seen_rep or not replenishes) and self.k >= t["warmup_frames_min"]:
                return
        raise RuntimeError(f"no keyframe and replenishment in {self.k} warm-up frames")

    def _hand(self) -> bool:
        lr = self.run.lap.frames[self.lap_index(self.k)]
        ok = self.slam.process_staged(lr, self.k * self.run.config["timestep_s"])
        self.k += 1
        return ok

    def window(self, seconds: float, mark) -> None:
        run = self.run
        self.sampler.open(self.slam.fs, self.slam.map, batched=False)
        before = self._counts()
        with mark("slambench.window"):
            t_start = time.perf_counter()
            self._frames(seconds, mark, before, t_start)
            # A LOST vehicle hands in no more frames: its window runs out.
            time.sleep(max(0.0, seconds - (time.perf_counter() - t_start)))
            run.window_s = time.perf_counter() - t_start
        self.sampler.close()
        self.probe()

    def _frames(self, seconds, mark, before, t_start) -> None:
        run, dev = self.run, self.run.device
        while not self.lost and time.perf_counter() - t_start < seconds:
            k = self.k
            pre = self.sampler.before_frame(self.slam, k, self.lap_index(k))
            reads0 = self.slam.outcome_reads
            with mark("slambench.frame"):
                t0 = time.perf_counter()
                ok = self._hand()
                _sync(dev)
                t1 = time.perf_counter()
            after = self._counts()
            kind = ("keyframe" if after[0] != before[0]
                    else "replenish" if after[1] != before[1] else "plain")
            before = after
            run.spans.append(Span(t0, t1, kind, reads=self.slam.outcome_reads - reads0))
            run.attempted += 1
            if not ok:
                self.lost = True
                run.failed += 1
                run.notes["lost_at_window_frame"] = k
            elif pre is not None and kind == "plain":
                self.sampler.after_frame(self.slam, pre, self.lap_index(k - 1),
                                         self.lap_index(k))

    def probe(self) -> None:
        """The LK kernel roofline reader's inputs: the last frame's tracks
        and image, and the drive's next image."""
        k = self.k
        self.run.probe["lk"] = dict(prev=self.run.lap.frames[self.lap_index(k - 1), 0],
                                    cur=self.run.lap.frames[self.lap_index(k), 0],
                                    pts=self.slam.fs.tracks.xy.clone())

    def keyframe_ate(self) -> float:
        """ATE (m) of the keyframe trajectory against the lap's ground truth."""
        s = self.slam
        _, _, T_cw = s.keyframe_trajectory()
        fid = s.map.kf_frame_id[:len(T_cw)].cpu().numpy()
        gt = self.run.lap.T_cw[[self.lap_index(int(f)) for f in fid]]
        return trajectory.ate_rmse(trajectory.centres(T_cw), trajectory.centres(gt))

    def notes(self) -> dict:
        s = self.slam
        from stereoslam_tpu_torch.ops.lk import lk_pyramid

        return dict(n_kf=int(s.map.n_kf), n_lm=int(s.map.n_lm), rescues=dict(s.rescues),
                    outcome_reads=s.outcome_reads, track_replays=getattr(
                        s.track_graph, "replays", None), lk_launches=lk_pyramid.launches)


def _clone(tree):
    """A copy of a state tree (named tuples of tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return None if tree is None else type(tree)(*(_clone(x) for x in tree))


def _copy_into(dst, src) -> None:
    """Write a state tree into another of the same shapes, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dst is not None:
        for d, s_ in zip(dst, src):
            _copy_into(d, s_)


class FleetDrive:
    """A fleet of vehicles through ``MultiSeqVO.process_staged``.

    Each vehicle's recording is cut into drives of ``drive_frames`` frames,
    and the fleet processes 8 drives at a time: when they end, the next 8
    start where they ended (the program's state of each stream back to the
    fresh state it was built with, then ``initialize`` on the drives' first
    frames).  A drive's length is fixed in frames, so a faster program
    processes more drives in the window, never a longer one."""

    def __init__(self, run: Run, sampler: "check_mod.Sampler"):
        from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO

        self.run, self.sampler = run, sampler
        t = run.cell["drive"]
        args = run.config["system_args"]
        self.B = t["streams"]
        self.drive_frames = t["drive_frames"]
        self.vo = MultiSeqVO(slam_config(run.config), batch=self.B, device=run.device,
                             readback_lag=t["readback_lag"], enable_loop=args["enable_loop"],
                             kf_sub=args["kf_sub"], verify_loops=args["verify_loops"])
        run.facade = self.vo
        # The state a drive starts from: the program's, as built.
        self.fresh = (_clone(self.vo.fs), _clone(self.vo.maps))
        lap = run.lap
        self.n = len(lap.T_cw)
        self.starts = drive.stream_starts(lap, self.B, run.cell["drive"]["start"])
        starts = torch.as_tensor(self.starts, device=run.device)
        # Every step's (B, 2, H, W) stack, staged once: a step hands in a view.
        steps = torch.arange(self.n, device=run.device)
        self.stacks = lap.frames[(starts[None, :] + steps[:, None]) % self.n]
        self.k = 0            # frames handed in to each stream
        self.drive_start = 0  # the step of the current drives' first frame
        self.dead_at = [None] * self.B
        self.sampler.attach_ba(self.vo)

    def lap_index(self, b: int, k: int) -> int:
        return (self.starts[b] + k) % self.n

    def _ts(self) -> np.ndarray:
        return np.full(self.B, (self.k - self.drive_start) * self.run.config["timestep_s"])

    def _start_drives(self) -> None:
        """Initialize every stream on the current step's frames."""
        first = self.stacks[self.k % self.n]
        self.drive_start = self.k
        self.vo.initialize(first[:, 0].cpu().numpy(), first[:, 1].cpu().numpy(), self._ts())
        self.k += 1

    def warm_up(self) -> None:
        """Initialization, the batched step's capture, and steps until a
        keyframe service (with its BA's capture) has run."""
        t = self.run.cell["drive"]
        self._start_drives()
        while self.k < t["warmup_frames_max"]:
            served = self.vo.keyframes_serviced
            self.vo.process_staged(self.stacks[self.k % self.n], self._ts())
            self.k += 1
            if self.vo.keyframes_serviced > served and self.k >= t["warmup_frames_min"]:
                self.vo.drain()
                _sync(self.run.device)
                return
        raise RuntimeError(f"no keyframe service in {self.k} warm-up steps")

    def _note_deaths(self, retired: int) -> None:
        for b in range(self.B):
            if self.dead_at[b] is None and not self.vo.alive[b]:
                self.dead_at[b] = retired - 1

    def _end_drives(self, k0: int) -> None:
        """Count the frames that the ending drives' dead streams were
        handed in the window after their death, and note the deaths."""
        self.vo.drain()
        self._note_deaths(self.k)
        for b, d in enumerate(self.dead_at):
            if d is not None:
                self.run.failed += max(0, self.k - max(d, k0))
                self.run.notes.setdefault("deaths", []).append(
                    dict(stream=b, drive_start=self.drive_start, at=d))
        self.dead_at = [None] * self.B

    def window(self, seconds: float, mark) -> None:
        run, vo = self.run, self.vo
        self.sampler.open(vo.fs, vo.maps, batched=True)
        k0 = self.k
        with mark("slambench.window"):
            t_start = time.perf_counter()
            steps = self._steps(seconds, mark, t_start, k0)
            with mark("slambench.drain"):
                self._end_drives(k0)
                _sync(run.device)
            run.window_s = time.perf_counter() - t_start
        run.attempted = (self.k - k0) * self.B
        run.stage_s = {key: list(v[-steps:]) for key, v in vo.stage_s.items()}
        self.sampler.close()
        self.probe()

    def _steps(self, seconds, mark, t_start, k0) -> int:
        """Steps until the window's time is up; returns how many."""
        run, vo = self.run, self.vo
        lag, steps = vo.readback_lag, 0
        while time.perf_counter() - t_start < seconds:
            k = self.k
            if k - self.drive_start >= self.drive_frames:
                with mark("slambench.drive_start"):
                    t0 = time.perf_counter()
                    self._end_drives(k0)
                    _copy_into(vo.fs, self.fresh[0])
                    _copy_into(vo.maps, self.fresh[1])
                    vo.alive[:] = True
                    self._start_drives()
                    t1 = time.perf_counter()
                run.spans.append(Span(t0, t1, "drive_start"))
                continue
            pre = self.sampler.before_step(vo, k)
            served = vo.keyframes_serviced
            with mark("slambench.step"):
                t0 = time.perf_counter()
                vo.process_staged(self.stacks[k % self.n], self._ts())
                t1 = time.perf_counter()
            self.k += 1
            steps += 1
            run.spans.append(Span(t0, t1, "step", serviced=vo.keyframes_serviced - served))
            self._note_deaths(max(self.drive_start, self.k - lag))
            if pre is not None:
                self.sampler.after_step(vo, pre, [self.lap_index(b, k - 1) for b in range(self.B)],
                                        [self.lap_index(b, k) for b in range(self.B)])
        return steps

    def probe(self) -> None:
        """As ``OnlineDrive.probe``, for every stream."""
        k = self.k
        idx_prev = torch.as_tensor([self.lap_index(b, k - 1) for b in range(self.B)])
        idx_cur = torch.as_tensor([self.lap_index(b, k) for b in range(self.B)])
        lap = self.run.lap.frames
        self.run.probe["lk_batched"] = dict(prev=lap[idx_prev.to(lap.device), 0],
                                            cur=lap[idx_cur.to(lap.device), 0],
                                            pts=self.vo.fs.tracks.xy.clone())

    def keyframe_ate(self) -> list:
        """ATE (m) of each stream's keyframe trajectory in the current
        drives against the lap's ground truth."""
        vo, out = self.vo, []
        for b in range(self.B):
            _, pos = vo.keyframe_trajectory(b)
            fid = vo.maps.kf_frame_id[b][:len(pos)].cpu().numpy()
            gt = self.run.lap.T_cw[[self.lap_index(b, self.drive_start + int(f)) for f in fid]]
            out.append(trajectory.ate_rmse(pos, trajectory.centres(gt)))
        return out

    def notes(self) -> dict:
        vo = self.vo
        from stereoslam_tpu_torch.ops.lk import lk_pyramid

        return dict(alive=int(vo.alive.sum()), steps=vo.steps,
                    keyframes_serviced=vo.keyframes_serviced, outcome_reads=vo.outcome_reads,
                    n_kf=[int(x) for x in vo.maps.n_kf.tolist()],
                    drives_started=len(self.run.frames("drive_start")),
                    batched_launches=lk_pyramid.batched_launches)


DRIVES = {"StereoSlam": OnlineDrive, "MultiSeqVO": FleetDrive}


def camera_of(config: dict) -> dict:
    """The renderer's camera from the configuration's ``slam.camera``."""
    cam, slam = config["slam"]["camera"], config["slam"]
    return dict(height=slam["image_height"], width=slam["image_width"], fx=cam["fx"],
                fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], baseline=cam["bf"] / cam["fx"])


def execute(run: Run, seconds: float, trace: bool, t_process: float) -> None:
    """Render the lap, set up, warm up and measure ``run``'s cell; keep the
    spans, counters, trace summary and the check's samples in ``run``."""
    from slambench import trace as trace_mod

    dev = run.device
    t0 = time.perf_counter()
    run.lap = drive.render_lap(camera_of(run.config), run.config["world"], dev)
    _sync(dev)
    if dev.type == "cuda":
        # The peak reported is the program's (with the staged lap), not the renderer's.
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    sampler = check_mod.Sampler(run)
    drv = DRIVES[run.config["system"]](run, sampler)
    _sync(dev)
    t2 = time.perf_counter()
    drv.warm_up()
    _sync(dev)
    t3 = time.perf_counter()
    run.setup_s = t3 - t_process
    run.notes["setup_parts_s"] = dict(imports=t0 - t_process, render=t1 - t0, construct=t2 - t1,
                                      warm_up=t3 - t2)
    if trace:
        with trace_mod.Tracer(dev) as tracer:
            drv.window(seconds, tracer.mark)
        t4 = time.perf_counter()
        run.trace = tracer.summary()
        run.notes["trace_read_s"] = time.perf_counter() - t4
    else:
        drv.window(seconds, trace_mod.no_mark)
    run.notes.update(drv.notes())
    run.notes["keyframe_ate_m"] = drv.keyframe_ate()
    run.notes["lap_frames"] = len(run.lap.T_cw)
    run.samples = {"tracked": sampler.tracked, "ba": sampler.ba}


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, cell: Optional[dict] = None,
             config: Optional[dict] = None, bench_dir: Optional[Path] = None):
    """One run of cell ``name``: its workload, configuration and metric
    readers found by name under ``bench_dir`` (``slambench/``), unless
    ``cell`` and ``config`` are given.  Returns (the result line's object,
    the earlier readings)."""
    from slambench import spec

    bench_dir = bench_dir or spec.BENCH_DIR
    cell = cell or spec.workload(name, bench_dir)
    config = config or spec.config(cell["config"], bench_dir)
    run = Run(cell=cell, config=config, seed=int(seed), device=device)
    execute(run, seconds, trace, t_process)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1,
                "memory_peak_bytes": memory_peak(device)}
    if trace and run.trace is not None:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
    metrics = spec.read_metrics(run, spec.metrics_for(bench, name, trace), bench_dir)
    breakdown = None
    if trace and run.trace is not None:
        breakdown = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps}
    # The reference runs once the program's state is freed: the process's
    # peak memory is the program's.
    run.facade = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chk = check_mod.evaluate(run, cell["check"]["limits"])
    info = dict(cell=name, seed=int(seed), window_s=run.window_s, setup_s=run.setup_s,
                frames={k: len(run.frames(k)) for k in ("plain", "keyframe", "replenish",
                                                        "step", "drive_start")},
                check_s=time.perf_counter() - t0, numbers=chk["numbers"], samples=chk["samples"],
                card=lk_work.power_limit() if device.type == "cuda" else "cpu",
                peaks=dict(bytes_per_s=lk_work.PEAK_BYTES_PER_S,
                           fp32_flops=lk_work.PEAK_FP32_FLOPS),
                **run.notes)
    if run.trace is not None:
        info["stream_busy_s"] = run.trace.stream_s
        info["device_events"] = run.trace.device_events
    result = {"correct": chk["correct"], "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in chk["compared"].items()}
    return result, info


def memory_peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
