"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # the full run: VO, BA, CLI, undistortion, CALC, CALC
                                         # training, Caffe, loop-closing, world, endurance,
                                         # multi-sequence and multi-device
    python3 chip_smoke.py --profile 20   # also profile 20 more VO frames (torch.profiler)

Phases, each printing its lines and stopping the run with a non-zero exit on
failure:

1. device  — a CUDA device must be present (there is no CPU fallback); prints
             the ``nvidia-smi`` name and power limit.
2. build   — compiles ``stereoslam_tpu_torch/csrc/lk_level.cu`` for sm_90a.
3. kernels — at the main path's shapes (400 FAST corners of a 376x1241
             frame): the per-level entries ``lk_level`` (4 levels, 20
             iterations from a zero flow and 10 from a seeded one) and
             ``lk_final_error`` against their plain versions; ``lk_pyramid``
             against the same call composed of per-level launches (bit for
             bit), against itself gated on (bit for bit) and gated off (no
             track kept), and against ``lk_pyramid_plain`` (tolerances), for
             the temporal forward+FB, stereo, deep-rescue and border calls;
             then
             device times per launch (a CUDA graph of back-to-back launches),
             each beside its roofline bound, and the time by iteration
             budget.
4. main    — ``StereoSlam(cfg, device="cuda", enable_loop=False)`` with inline
             BA over the synthetic KITTI-00-geometry sequence of ``bench.py``
             Phase A; checks no LOST, the keyframe/landmark counts and the
             trajectory error against ground truth (and that they repeat the
             port's known run), that every tracked frame went through
             ``lk_pyramid`` and that no per-level entry was launched, and
             that every tracked frame replayed the frame's CUDA graph.
5. pipeline — phase main's frames staged on the card in advance: every
             replay of the tracked frame's graph against the eager
             ``track_frame`` on the same inputs (bit for bit); host syncs per
             tracked frame through ``process_staged`` by kind (a
             keyframe-free frame must make exactly one, its outcome read);
             ``readback_lag=10`` and ``process_chunk`` (C=8) against phase
             main's keyframes and trajectory; the keyframe-free frame eager
             against replayed, interleaved: wall time, device time, busy
             share; ``ops/svd.py`` against ``torch.linalg.svd`` (bit for
             bit, float32 and float64).
6. ba      — the windowed BA as one CUDA graph (``core/graphs.py``
             ``BAGraph``) and the asynchronous BA: (a) on phase main's
             final map, the replay against the eager ``optimize_active_map``
             and the fixed steps against the early exit (every output
             field, bit for bit), no host read (sync-debug "error"), the
             early exit's steps, the replay, the eager early exit and the
             eager fixed steps timed in turns; (b) phase main's frames
             through ``StereoSlam(inline_ba=False)`` at lag 0 and 10, twice
             each: no LOST, keyframes in band, ATE, bit-for-bit repeats,
             the launches, and the BA's overlap with tracked frames (CUDA
             events); (c) the inline BA through the graph against the
             eager early exit in turns: keyframe frame time, host syncs,
             and every run equal to phase main's.
7. cli     — the user's entry point, ``stereoslam_tpu_torch.run``: writes phase
             main's 100 frames as a KITTI directory (8-bit grey PNGs by a
             stdlib writer, ``times.txt``, a poses file, the config as
             OpenCV YAML, which must load back equal to phase main's);
             decodes it through the native loader where g++ and libpng are
             installed, else through ``kitti.frames``' fallback, bit-equal to
             the frames written; runs the CLI in-process (VO only, ``--gt``)
             and checks its ``trajectory.txt`` byte-equal to phase main's,
             its logged ATE equal to phase main's keyframe ATE, and its
             ``lk_pyramid`` launches; runs ``python3 -m
             stereoslam_tpu_torch.run`` with the default flags (loop closing
             with trained CALC) on 40 frames as a subprocess and checks its
             files; checks phase main's profiler records.
8. undistort — bench.py's undistortion-ON configuration (k1 -0.28, k2 0.07
             on both cameras) on phase main's frames: the remapped pair on
             the card against the plain CPU remap, its device time, a timed
             run beside phase main's configuration run right after it, no
             LOST, keyframes within the band of the JAX package's CPU run of
             the same configuration (scripts/jax_undistort_run.py), one graph
             replay and at least one ``lk_pyramid`` launch per tracked frame,
             the pinned run, then a checking run: replay against the eager
             ``track_frame`` on 3 frames (bit for bit), one host read per
             keyframe-free frame, and the same trajectory.
9. calc    — the shipped trained CALC encoder (``preprocess`` + ``CalcEncoder``)
             and the HOG descriptor on one 376x1241 keyframe image, on the
             card against the same module on the CPU (float32, TF32 off),
             with each one's device time per call.
10. train   — CALC training (``models/train_calc.py``) at CALC's widths and
             the default run's batch (64), geometries and loss settings:
             (a) the shipped weights through the port on the card against
             ``tests/test_descriptor_precision.py``'s five bars (seed 555,
             120x188), and at the held-out seed 999 at both geometries
             beside the JAX run's medians; (b) one ``pair_loss`` step from
             the same init, batch and augmentation on the card against the
             CPU (loss terms, every gradient); (c) ``train_encoder_pairs``
             on 2 x 128 card-rendered pairs for 300 steps with the seed-777
             probe every 100: finite, the total down to 0.8x, the best probe
             above the untrained encoder's, unit descriptors, held-out
             revisits above different places by 0.05; ms a step, pairs a
             second and the device busy share over 50 steps; (d) the
             float16 npz round trip into ``DescriptorModel``.  The full run
             is ``scripts/torch_train_calc_default.py``'s.
11. caffe  — a CALC-shaped Caffe net written from a seed (deploy.prototxt and
             calc.caffemodel: 1x1x120x160 input, Convolution/ReLU/Pooling/LRN,
             a 1064-value last blob): the importer's runner on the card
             against the CPU; ``StereoSlam`` with the files in
             ``cfg.loop.caffe_*`` over 40 of phase main's frames, loop
             closing on, every stored keyframe descriptor equal to the runner
             on that keyframe's preprocessed left image.
12. loop   — ``StereoSlam(cfg, device="cuda", enable_loop=True)`` with the HOG
             descriptor over a closed blob-world circuit at KITTI geometry,
             with the full-size state (400 features x 8 ORB levels, 1536
             keyframe rows, 131,072 landmark rows); checks no LOST, a true
             loop edge, the trajectory error, that every tracked frame went
             through ``lk_pyramid``, and that the run repeats the port's
             known one; prints FPS, per-stage keyframe times and PGO
             iterations.
13. world  — the canonical 548-frame world circuit of ``run_world_eval``
             (240x376, trained CALC at the shipped 0.94/0.92 thresholds):
             renders it on the card and holds four frames of each camera to
             the CPU render; checks ``DeviceFeed`` over 50 host frames; runs
             ``run_world_eval(device="cuda")`` loop ON and OFF and checks no
             LOST, the keyframe rate, ATE and that any loop edge is a true
             revisit, against the JAX package's documented CPU envelope (see
             ``WORLD_MAX_ATE_M``), that every tracked frame went through
             ``lk_pyramid``; holds ``lk_pyramid`` against the per-level
             composition and ``lk_pyramid_plain`` at this path's shapes
             (frames 0 and 1 of the circuit: temporal, stereo, deep-rescue
             and border calls); round-trips the final state through a
             checkpoint into a fresh ``StereoSlam``; prints FPS, p50, ATE,
             edges, per-stage keyframe times, and the refused loop
             verifications by the guard that refused them.
14. endurance — (a) ``run_endurance(device="cuda")`` cut from 10.8 laps to 2
             (843 frames): tracking at least as far as the JAX package's CPU
             run of the same frames (LOST at frame 678), every loop edge a
             true revisit with an id gap >= 20, FPS, p50 over the first and
             last 800 frames, the
             detection scan and full-graph PGO at the final size; (b) the
             first 548 frames with the landmark table cut until live
             compaction fires at least twice: no LOST, the tracked frame
             after each compaction replayed bit for bit as the eager
             ``track_frame``, no live track left on a freed row.  The full
             run is ``scripts/torch_endurance.py``'s.
15. multiseq — the batched multi-sequence mode (``parallel/multiseq.py``
             ``MultiSeqVO``): (a) one batched ``lk_pyramid`` launch at bench.py
             Phase M's shapes (B=8, 240x376, 3 levels, 400 slots a sequence)
             against 8 single launches (bit for bit), with a mixed gate
             vector, against the batched plain version, and timed against
             the 8 single launches; (b) Phase M's workload (8 synthetic
             sequences, 72 frames, 16 warm-up, ``BatchFeed``, the defaults):
             no LOST, >= 3 keyframes a sequence, at most ``kf_sub`` a step,
             one graph replay a step, the batched LK launch on every step,
             the pinned per-sequence (KFs, ATE); the keyframe service with
             its BA through the BA graph against the eager early exit in
             one process (host ms a step, the maps bit for bit); then a checking
             run: replay
             against the eager batched step (bit for bit), each sequence's
             batched step against the single-sequence ``track_frame``
             (flags equal, tracks and ``T_rk`` within tolerances), one host
             read a keyframe-free step, the step's time against 8
             single-sequence graphs, the host stages and the device busy
             share; (c) the ``MULTISEQ_LOOP.json`` experiment
             (``scripts/torch_multiseq_world.py``: two world circuits loop ON
             and OFF): no LOST, every edge a true revisit, ATE ON <= OFF a
             sequence, printed beside the TPU record with the refusals.
16. dist   — multi-device (``parallel/``): (a) one rank on NCCL (a mesh of the
             card alone): the sharded descriptor search over the full
             1536x1064 database against the dense scan (equal id, score and
             count), the sharded PGO on a graph of the endurance run's size
             (195 vertices in 1536 rows, 3 GN x 512 CG) against
             ``optimize_pose_graph(cg_rtol=1e-12, gn_xtol=-1)`` bit for bit,
             the sharded BA at the window's shapes (W=7, N=400) against the
             truth, each op's time; (b) two Gloo ranks on the one card, in
             processes of their own, on the same inputs, held to (a) within
             the CPU tests' tolerances; (c) ``StereoSlam(mesh=make_mesh())``
             over phase loop's circuit (the asynchronous BA): no LOST, true
             edges with an id gap >= 20, ATE, ``lk_pyramid`` on every tracked
             frame and no per-level launch, the pinned run; the correction
             at the last edge on the final state through the sharded PGO
             (30 GN x 512 CG in full) against the dense one, timed; (d) ``MultiSeqVO(mesh=make_mesh(dp=1))``
             at Phase M: every sequence as phase multiseq's pinned run, one
             graph replay a step (the step's NCCL sum inside the graph).
17. profile — with ``--profile N``: device busy share, the top kernels, the
             LK kernels' self device time per launch, host syncs per frame
             for keyframe, replenish and keyframe-free frames.

Each phase prints ``phase <name>: start`` and ``phase <name>: done in <s> s``;
a failure prints ``FAIL: phase <name>, check <check>: ...`` and exits 1.  The
second-to-last line is a JSON object of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Only torch, numpy and the port are
imported.
"""

from __future__ import annotations

import argparse
import binascii
import dataclasses
import functools
import gc
import importlib.util
import json
import logging
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

# Kernel-vs-plain tolerances: a different summation order can shift one
# convergence step, which moves a flow by up to the eps scale (0.01 px).
TOL_MEDIAN_PX = 1e-3
TOL_P99_PX = 2e-2
TOL_GOOD_AGREE = 0.995
TOL_FINAL_ERROR = 1e-3
# Main-path bands.  The JAX package on a CPU gives ATE 0.0905 m and 15 KFs on
# this exact workload.  A run of the port repeats bit for bit on one card
# (fixed-order sums, see ops/schur.py), so its ATE is one number per seed,
# not a sample of run-to-run noise.
MAX_ATE_M = 0.25
KF_BAND = (8, 30)
# The run of seed 11 as the port has produced it on the card since the BA's
# damping floor (ops/schur.py): (keyframes, landmarks, ATE in m).  Before the
# floor it was (15, 850, 0.1161).
EXPECTED_RUN = (15, 845, 0.1836)
N_FRAMES = 100
WARMUP = 12
# CALC on the card against the CPU (float32, TF32 off).
CALC_MAX_ABS = 1e-5
CALC_MIN_DOT = 0.99999
# The loop phase's circuit: tests/test_system_loop.py's closed loop (radius
# 6.68 m) sampled 2.25x as densely, so that the image motion per frame at
# fx = 718.856 is the test's at fx = 320; 4000 blobs of seed 8, on which the
# JAX package initializes at frame 0 and tracks the whole circuit; a 6-level
# stereo pyramid for the 2.25x larger disparities.  At this geometry every
# keyframe pair of the blob world scores 0.95-0.97 by HOG, so the test's
# 0.93/0.92 thresholds make every keyframe a suspect; they are re-tuned to
# this similarity scale (scripts/jax_loop_circuit.py prints it).
LOOP_SCALE = 2.25
LOOP_CIRCUIT = dict(n_frames=338, loop_frames=270, speed=0.35 / LOOP_SCALE, n_points=4000, seed=8)
LOOP_LK_LEVELS, LOOP_STEREO_LEVELS = 4, 6
LOOP_SIMILARITY = (0.975, 0.970)
MAX_LOOP_ATE_M = 1.0
MAX_LOOP_GT_M = 4.0
# The loop run as the port has produced it on the card since the BA's damping
# floor (before it: (84, 2, 0.1089)): (keyframes, loop edges, frame ATE in m).
# It repeats bit for bit, as the VO run does.  The JAX package on a CPU gives
# 83 KFs, 2 edges and 0.1827 m on it.
EXPECTED_LOOP_RUN = (79, 2, 0.129)

# The canonical world circuit of run_world_eval (stereoslam_tpu/eval.py): 548
# frames (1.3 laps) at 240x376, fx 320, step 0.8 m, seed 1, a 90x50 m block,
# trained CALC at the shipped thresholds.  The bands are the JAX package's
# documented CPU envelope (tests/test_eval_world.py: no LOST, kf_rate within
# 0.03 of the record's 0.219, ATE <= 5.6 m and no worse than loop OFF;
# tests/test_world_loop.py: edges with id gap >= id_gap, under 5 m apart),
# except where the JAX package on a CPU misses them itself today
# (scripts/eval_world.py: LOST at frame 272, ATE 14.0137 m over those 272
# frames, no loop edge): there the port is held to that run plus the test's
# 10%, over all 548 frames: ATE <= 15.415 m, and any loop edge true.
WORLD_FRAMES, WORLD_STEP, WORLD_SEED = 548, 0.8, 1
WORLD_LENGTH, WORLD_WIDTH = 90.0, 50.0
WORLD_MAX_ATE_M = round(14.0137 * 1.1, 3)
WORLD_KF_RATE, WORLD_KF_RATE_TOL = 0.219, 0.03
WORLD_MAX_EDGE_GT_M = 5.0
# The world run (loop ON) as the port produces it on the card, bit for bit in
# every call: (keyframes, loop edges, ATE in m).  The same code on a CPU gives
# other runs, which differ with the CPU's thread count as much as from the
# card's (scripts/torch_world_trace.py traces where two runs part).
EXPECTED_WORLD_RUN = (131, 0, 13.1142)
# Card render against the CPU render: the CPU tests' tolerances against JAX.
WORLD_CHECK_FRAMES = (0, 137, 300, 547)
RENDER_MEDIAN, RENDER_NEAR, RENDER_NEAR_SHARE, RENDER_U8_SHARE = 1e-3, 0.05, 0.999, 0.995


def fail(phase: str, check: str, msg: str) -> None:
    print(f"FAIL: phase {phase}, check {check}: {msg}", flush=True)
    raise SystemExit(1)


def run_phase(name: str, fn, *args):
    """Run one phase between a start line and a done line with its wall time."""
    print(f"phase {name}: start", flush=True)
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: done in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail("device", "nvidia-smi", f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, launches: int = 200, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` back-to-back calls
    captured in one CUDA graph, timed by CUDA events around one replay after
    a warm-up replay.  The graph keeps the host's per-call work (argument
    checks, allocations, the ctypes call) out of the gaps between kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def eager_ms(fn, launches: int = 200, warmup: int = 3) -> float:
    """Milliseconds per call of ``launches`` back-to-back eager calls, by CUDA
    events: what a caller pays when the host, not the device, sets the pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def kitti_sequence():
    from stereoslam_tpu_torch.utils.synthetic import generate_sequence

    # bench.py Phase A: KITTI 00 geometry, 1241x376, fx=718.856, bf=386.1448.
    return generate_sequence(n_frames=N_FRAMES, h=376, w=1241, fx=718.856,
                             baseline=386.1448 / 718.856, n_points=4000,
                             trajectory="forward", speed=0.8, seed=11)


def kitti_config(seq):
    from stereoslam_tpu_torch.config import (CameraConfig, FeatureConfig, MapConfig,
                                             SlamConfig)

    return SlamConfig(
        camera=CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                            fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                            bf=seq.fx * seq.baseline),
        features=FeatureConfig(),
        map=MapConfig(),
        image_height=seq.left.shape[1],
        image_width=seq.left.shape[2],
    )


@functools.lru_cache(maxsize=None)
def loop_sequence():
    from stereoslam_tpu_torch.utils.synthetic import generate_sequence

    return generate_sequence(h=376, w=1241, fx=718.856, baseline=386.1448 / 718.856,
                             trajectory="loop", **LOOP_CIRCUIT)


def loop_config(seq):
    """KITTI geometry with the default feature and map sizes and the loop
    settings of tests/test_system_loop.py's loop_cfg, its similarity
    thresholds re-tuned to this geometry."""
    from stereoslam_tpu_torch.config import LoopClosingConfig

    cfg = kitti_config(seq)
    return cfg.replace(
        loop=LoopClosingConfig(similarity_high=LOOP_SIMILARITY[0],
                               similarity_low=LOOP_SIMILARITY[1], max_above_low=6,
                               database_min_size=5, id_gap=10, min_matches=10, min_inliers=10,
                               correction_threshold=0.5),
        tracking=dataclasses.replace(cfg.tracking, lk_levels=LOOP_LK_LEVELS,
                                     lk_stereo_levels=LOOP_STEREO_LEVELS),
    )


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# the least time a kernel could take is the larger of its bytes over the
# memory rate and its float32 operations over the FP32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Float32 operations of the LK arithmetic, counted from the source: a bilinear
# sample is 13 (two weights, eight products, three sums), a window has 121
# samples.  One Gauss-Newton iteration: a sample, the residual and two
# multiply-adds per sample (18), two 31-add sums, about 20 for the update.
# A level's template: five samples and six gradient-product terms per sample.
# The final error: one sample, a difference and a sum per sample.
FLOPS_ITER = 121 * 18 + 2 * 31 + 20
FLOPS_TEMPLATE = 121 * (5 * 13 + 2 + 6)
FLOPS_ERROR = 121 * (13 + 2)


class Work:
    """What one LK launch needs for these inputs: the pixels it taps, each
    read once (a mask per image, so a pixel that two features, levels or
    passes tap counts once), and its float32 operations, counted from the
    iterations the data runs."""

    def __init__(self, K):
        self.K, self.masks, self.flops = K, {}, 0

    def _mark(self, img, x0, y0, side: int) -> None:
        """Set the pixels of ``side`` x ``side`` boxes at integer origins,
        clamped to the image (a clamped tap reads an edge pixel)."""
        mask = self.masks.setdefault(img.data_ptr(), torch.zeros(img.shape, dtype=torch.bool,
                                                                 device=img.device))
        h, w = mask.shape
        ar = torch.arange(side, device=mask.device)
        ys = (y0[:, None] + ar).clamp(0, h - 1)
        xs = (x0[:, None] + ar).clamp(0, w - 1)
        mask[ys[:, :, None].expand(-1, -1, side), xs[:, None, :].expand(-1, side, -1)] = True

    def template(self, img, pts) -> None:
        """The 14x14 box a template and its +-0.5 px gradients tap."""
        org, _ = self.K.window_origins(pts, torch.zeros_like(pts))
        self._mark(img, org[:, 0], org[:, 1], self.K.window_plan().template_side)

    def taps(self, img, at) -> None:
        """The 12x12 bilinear footprints of windows sampled at ``at``."""
        base = torch.stack([self.K._split(at[:, i])[0] for i in (0, 1)], dim=-1)
        base = base - self.K.WINDOW // 2
        self._mark(img, base[:, 0], base[:, 1], self.K.WINDOW + 1)

    def level(self, prev, nxt, pts, flow, iters: int, eps: float):
        """One level: the templates and the taps of every iteration that
        runs.  Returns the level's flow."""
        self.template(prev, pts)
        self.flops += pts.shape[0] * FLOPS_TEMPLATE

        def visit(f, active):
            self.flops += int(active.sum()) * FLOPS_ITER
            self.taps(nxt, (pts + f)[active])

        flow, _ = self.K.lk_level_plain(prev, nxt, pts, flow, iters, eps, visit=visit)
        return flow

    def nbytes(self) -> int:
        return 4 * sum(int(m.sum()) for m in self.masks.values())


def lk_work(K, pa, pb, pts, init, iters: int, eps: float, fb: float = 0.0, fb_iters: int = 0):
    """Bytes and float32 operations of one pyramidal-LK call for these
    inputs: the pixels it taps, the points read and the results written
    once; the iterations the data runs."""
    work = Work(K)

    def one_pass(pyr_a, pyr_b, p, seed, n_iters):
        flow = (seed - p) / float(2 ** (len(pyr_a) - 1))
        for lvl in range(len(pyr_a) - 1, -1, -1):
            flow = work.level(pyr_a[lvl], pyr_b[lvl], p / float(2 ** lvl), flow, n_iters, eps)
            if lvl:
                flow = flow * 2.0
        work.taps(pyr_b[0], p + flow)  # the final error
        work.flops += p.shape[0] * FLOPS_ERROR
        return p + flow

    q = one_pass(pa, pb, pts, init, iters)
    if fb > 0.0:
        one_pass(pb, pa, q, q, fb_iters)
    return work.nbytes() + pts.shape[0] * (16 + 13), work.flops


def bound(nbytes: int, flops: int):
    """(bound_ms, bound_by, description) of the roofline for this work."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    text = (f"{nbytes / 1e6:.3f} MB in {t_bytes * 1e3:.3f} us, {flops / 1e6:.2f} MFLOP in "
            f"{t_ops * 1e3:.3f} us")
    return (t_bytes, "bytes", text) if t_bytes >= t_ops else (t_ops, "operations", text)


def round_trip_ties(L, pa, pb, pts, res, kw) -> torch.Tensor:
    """Tracks whose round trip in the per-level composition lies within
    1e-5 px of the forward-backward threshold: there the kernel's sqrtf and
    torch.linalg.norm may round to different sides."""
    nb = kw["fb_levels"] or len(pa)
    back = L.lk_pyramid_levels(pb[:nb], pa[:nb], res.points, res.points, iters=kw["fb_iters"],
                               eps=kw["eps"], max_error=kw["max_error"])
    return (torch.linalg.norm(back.points - pts, dim=-1) - kw["forward_backward"]).abs() < 1e-5


def check_pyramid_case(L, name, pa, pb, pts, init, kw, phase: str = "kernels") -> float:
    """lk_pyramid against the composition of per-level kernel launches (bit
    for bit, status up to round-trip ties) and against lk_pyramid_plain
    (the per-level tolerances).  Returns the largest |d point| against plain where
    both keep the track."""
    got = L.lk_pyramid(pa, pb, pts, init, **kw)
    ref = L.lk_pyramid_levels(pa, pb, pts, init, **kw)
    plain = L.lk_pyramid_plain(pa, pb, pts, init, **kw)
    on = L.lk_pyramid(pa, pb, pts, init, gate=torch.ones((), dtype=torch.bool, device=pts.device),
                      **kw)
    off = L.lk_pyramid(pa, pb, pts, init, gate=torch.zeros((), dtype=torch.bool,
                                                            device=pts.device), **kw)
    torch.cuda.synchronize()
    gate_ok = (all(torch.equal(x, y) for x, y in zip(on, got)) and not bool(off.status.any())
               and torch.equal(off.points, init) and not bool(off.error.any()))
    if not gate_ok:
        fail(phase, "lk_pyramid gate", f"lk_pyramid ({name}) gated on differs from the ungated "
             f"call, or gated off keeps a track")
    same = torch.equal(got.points, ref.points) and torch.equal(got.error, ref.error)
    differ = got.status != ref.status
    n_flip = int(differ.sum())
    if kw["forward_backward"] > 0.0:
        differ &= ~round_trip_ties(L, pa, pb, pts, ref, kw)
    agree = (got.status == plain.status).float().mean().item()
    both = got.status & plain.status
    d = (got.points - plain.points).norm(dim=1)[both]
    med, p99 = d.median().item(), d.quantile(0.99).item()
    print(f"{phase}: lk_pyramid {name}: {len(pa)} levels {tuple(pa[0].shape)} -> "
          f"{tuple(pa[-1].shape)}, N={pts.shape[0]}, "
          f"{int(got.status.sum())} kept; vs per-level launches: points and error "
          f"{'bit-identical' if same else 'DIFFER'}, {n_flip} status flips "
          f"({int(differ.sum())} not round-trip ties); gated on: bit-identical to ungated, gated "
          f"off: no track kept; vs plain: status agree {agree:.4f}, "
          f"|dpoint| median {med:.2e} p99 {p99:.2e} px", flush=True)
    if not same or bool(differ.any()):
        fail(phase, "lk_pyramid vs per-level launches",
             f"lk_pyramid ({name}) differs from the composition of per-level launches")
    if not (agree >= TOL_GOOD_AGREE and med < TOL_MEDIAN_PX and p99 < TOL_P99_PX):
        fail(phase, "lk_pyramid vs plain", f"lk_pyramid ({name}) disagrees with lk_pyramid_plain")
    return (got.points - plain.points).abs()[both].max().item()


def border_case(pts, h: int, w: int):
    """The corners plus points at every edge and far outside, seeded to push
    their windows past the edges and +-1e4 px outside."""
    edge = torch.tensor([[0.3, 0.2], [w - 1.2, 2.5], [3.0, h - 1.5], [w - 0.5, h - 0.5],
                         [-1e4, 50.0], [50.0, 1e4], [1e4, -1e4], [w / 2, h / 2],
                         [2.0, h / 2], [w - 3.0, h / 2]], device=pts.device)
    seed = torch.tensor([[-20.0, -20.0], [30.0, 0.0], [0.0, 30.0], [25.0, 25.0], [0.0, 0.0],
                         [-1e4, 0.0], [1e4, 1e4], [0.0, -1e4], [-11.0, 0.0], [11.5, 3.0]],
                        device=pts.device)
    p = torch.cat([pts, edge])
    return p, p + torch.cat([torch.zeros_like(pts), seed])


def pyramid_cases(t, a, b, right, pts, n_stereo: int, n_deep: int):
    """The path's lk_pyramid calls for the corners ``pts`` of image ``a``
    under the tracking config ``t``: temporal forward+FB into ``b`` from seeds
    within 8 px, stereo into ``right`` at ``n_stereo`` levels, the deep rescue
    at ``n_deep`` levels, and the border case.  Returns (cases, the temporal
    call's keywords, its seeds)."""
    from stereoslam_tpu_torch.ops.image import build_lk_pyramid

    lk_kw = dict(window=t.lk_window, iters=t.lk_iters, eps=t.lk_eps, max_error=30.0,
                 forward_backward=t.lk_forward_backward, fb_iters=t.lk_fb_iters,
                 fb_levels=t.lk_fb_levels)
    no_fb = dict(lk_kw, forward_backward=0.0)
    gen = torch.Generator().manual_seed(0)
    seeded = pts + (torch.rand(pts.shape, generator=gen) * 16.0 - 8.0).to(pts.device)
    pa, pb = build_lk_pyramid(a, t.lk_levels), build_lk_pyramid(b, t.lk_levels)
    border_pts, border_init = border_case(pts, *a.shape)
    cases = [
        ("temporal forward+FB, seeds within 8 px", pa, pb, pts, seeded, lk_kw),
        ("stereo left->right, zero seed", build_lk_pyramid(a, n_stereo),
         build_lk_pyramid(right, n_stereo), pts, pts, no_fb),
        ("deep rescue", build_lk_pyramid(a, n_deep), build_lk_pyramid(b, n_deep), pts, pts,
         lk_kw),
        ("border and +-1e4 px outside", pa, pb, border_pts, border_init, lk_kw),
    ]
    return cases, lk_kw, seeded


def phase_kernels(dev, seq, card: str):
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.ops.fast import detect_keypoints
    from stereoslam_tpu_torch.ops.image import build_lk_pyramid

    cfg = kitti_config(seq)
    t = cfg.tracking
    frame = [torch.from_numpy(img.astype(np.uint8)).to(dev).float()
             for img in (seq.left[0], seq.left[1], seq.right[0])]
    a, b, right = frame
    kps = detect_keypoints(a, cfg.features.max_features)
    pts = kps.xy[kps.valid].contiguous()
    if pts.shape[0] != cfg.features.max_features:
        fail("kernels", "corners", f"expected {cfg.features.max_features} FAST corners, got "
             f"{pts.shape[0]}")

    # Per level: the device code alone against the plain level, from a zero
    # flow with lk_iters and from a seeded flow (clamped to 11 px, near the
    # 12 px clip) with lk_fb_iters, at all 4 levels of the stereo pyramid.
    n_lvl = t.lk_stereo_levels
    pa, pb = build_lk_pyramid(a, n_lvl), build_lk_pyramid(b, n_lvl)
    iters, eps = t.lk_iters, t.lk_eps
    cases = [(lvl, iters, 0.0) for lvl in range(n_lvl)]
    cases += [(lvl, t.lk_fb_iters, 4.0) for lvl in range(n_lvl)]
    worst = 0.0
    for lvl, n_it, seed_px in cases:
        p = (pts / 2.0 ** lvl).contiguous()
        gen = torch.Generator().manual_seed(lvl)
        flow0 = (torch.randn(p.shape, generator=gen) * seed_px).clamp(-11.0, 11.0).to(dev)
        fk, gk = K.lk_level(pa[lvl], pb[lvl], p, flow0, n_it, eps)
        fp, gp = K.lk_level_plain(pa[lvl], pb[lvl], p, flow0, n_it, eps)
        torch.cuda.synchronize()
        agree = (gk == gp).float().mean().item()
        both = gk & gp
        d = (fk - fp).norm(dim=1)[both]
        med, p99 = d.median().item(), d.quantile(0.99).item()
        worst = max(worst, (fk - fp).abs()[both].max().item())
        print(f"kernels: lk_level level {lvl} {tuple(pa[lvl].shape)} N={p.shape[0]} iters {n_it} "
              f"seed flow sd {seed_px} px: good agree {agree:.4f} ({int(both.sum())} good), "
              f"|dflow| median {med:.2e} p99 {p99:.2e} px", flush=True)
        if not (agree >= TOL_GOOD_AGREE and med < TOL_MEDIAN_PX and p99 < TOL_P99_PX):
            fail("kernels", "lk_level vs plain",
                 f"lk_level disagrees with its plain version at level {lvl}, {n_it} iters")
    z = torch.zeros_like(pts)
    fk, _ = K.lk_level(pa[0], pb[0], pts, z, iters, eps)
    ek = K.lk_final_error(pa[0], pb[0], pts, fk)
    ep = K.lk_final_error_plain(pa[0], pb[0], pts, fk)
    err_final = (ek - ep).abs().max().item()
    print(f"kernels: lk_final_error max |d| {err_final:.2e}", flush=True)
    if not err_final < TOL_FINAL_ERROR:
        fail("kernels", "lk_final_error vs plain", "lk_final_error disagrees with its plain version")

    # Whole calls, as the main path makes them.
    cases, lk_kw, seeded = pyramid_cases(t, a, b, right, pts, n_lvl, n_lvl)
    p3a, p3b = pa[:t.lk_levels], pb[:t.lk_levels]
    worst_pyr = max(check_pyramid_case(L, *case) for case in cases)

    # Device times per call (CUDA graph of back-to-back launches), each
    # beside its bound for this call's work.
    t_k = device_ms(lambda: K.lk_level(pa[0], pb[0], pts, z, iters, eps))
    t_p = device_ms(lambda: K.lk_level_plain(pa[0], pb[0], pts, z, iters, eps), launches=5)
    t_ek = device_ms(lambda: K.lk_final_error(pa[0], pb[0], pts, fk))
    t_ep = device_ms(lambda: K.lk_final_error_plain(pa[0], pb[0], pts, fk), launches=20)
    t_y = device_ms(lambda: L.lk_pyramid(p3a, p3b, pts, seeded, **lk_kw))
    t_yl = device_ms(lambda: L.lk_pyramid_levels(p3a, p3b, pts, seeded, **lk_kw), launches=20)
    t_yp = device_ms(lambda: L.lk_pyramid_plain(p3a, p3b, pts, seeded, **lk_kw), launches=2)
    e_k = eager_ms(lambda: K.lk_level(pa[0], pb[0], pts, z, iters, eps))
    e_y = eager_ms(lambda: L.lk_pyramid(p3a, p3b, pts, seeded, **lk_kw))

    # A level alone: its pixels, the points and flows in, the flows and good
    # flags out.  The final error alone: its pixels, the points and flows in,
    # the errors out; a template sample and a window sample per position.
    w_k = Work(K)
    w_k.level(pa[0], pb[0], pts, z, iters, eps)
    b_k = bound(w_k.nbytes() + pts.shape[0] * 25, w_k.flops)
    w_ek = Work(K)
    w_ek.template(pa[0], pts)
    w_ek.taps(pb[0], pts + fk)
    b_ek = bound(w_ek.nbytes() + pts.shape[0] * 20, pts.shape[0] * 121 * (2 * 13 + 2))
    b_y = bound(*lk_work(K, p3a, p3b, pts, seeded, iters, eps, lk_kw["forward_backward"],
                         lk_kw["fb_iters"]))
    for name, ms, plain, bnd in (("lk_level (level 0, zero flow, 20 iters)", t_k, t_p, b_k),
                                 ("lk_final_error (level 0)", t_ek, t_ep, b_ek),
                                 ("lk_pyramid (3 levels, forward+FB)", t_y, t_yp, b_y)):
        print(f"kernels: device time {name}: {ms * 1e3:.3f} us per launch, plain {plain:.4f} ms; "
              f"bound {bnd[0] * 1e3:.3f} us by {bnd[1]} ({bnd[2]}), {bnd[0] / ms:.1%} of it "
              f"reached [{card}]", flush=True)
    print(f"kernels: the same forward+FB call composed of per-level launches (lk_pyramid_levels, "
          f"with its torch glue): {t_yl * 1e3:.3f} us device time per call; eager back-to-back "
          f"calls: lk_level {e_k * 1e3:.3f} us, lk_pyramid {e_y * 1e3:.3f} us (host-paced)",
          flush=True)

    # Where a launch's time goes: the iteration budget against the windows'
    # staging, the templates and the final errors (which run at 0 iterations).
    budget = [f"{n_it} -> {device_ms(lambda: K.lk_level(pa[0], pb[0], pts, z, n_it, eps)) * 1e3:.3f}"
              for n_it in (0, 1, 5, 20)]
    t_y0 = device_ms(lambda: L.lk_pyramid(p3a, p3b, pts, seeded, **dict(lk_kw, iters=0,
                                                                         fb_iters=0)))
    gate_off = torch.zeros((), dtype=torch.bool, device=dev)
    t_off = device_ms(lambda: L.lk_pyramid(p3a, p3b, pts, seeded, gate=gate_off, **lk_kw))
    print(f"kernels: device us per launch by iteration budget: lk_level level 0 "
          f"{', '.join(budget)}; lk_pyramid forward+FB at 0 iterations {t_y0 * 1e3:.3f}; "
          f"lk_pyramid gated off (a rescue call that does not fire) {t_off * 1e3:.3f} [{card}]",
          flush=True)

    def entry(err, ms, plain, bnd):
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    return {
        "lk_pyramid": entry(worst_pyr, t_y, t_yp, b_y),
        "lk_level": entry(worst, t_k, t_p, b_k),
        "lk_final_error": entry(err_final, t_ek, t_ep, b_ek),
    }


def phase_main(dev, seq, work: Path, card: str):
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K

    cfg = kitti_config(seq)
    slam = StereoSlam(cfg, device=dev, enable_loop=False)
    n = len(seq.left)
    reset_counters()
    fps, p50 = timed_run(slam, seq, "main")
    launches = {"lk_pyramid": L.lk_pyramid.launches, "lk_level": K.lk_level.launches,
                "lk_final_error": K.lk_final_error.launches}

    n_kf, n_lm = int(slam.map.n_kf), int(slam.map.n_lm)
    _, T = slam.frame_trajectory()
    if T.shape != (n, 4, 4) or not np.isfinite(T).all():
        fail("main", "trajectory", f"frame trajectory has shape {T.shape} or non-finite poses")
    ate = frame_ate(slam, seq)
    tracked = n - 1  # every frame after the stereo-init frame
    gated, fired = rescue_launches(cfg, tracked), slam.rescues["retry"] + slam.rescues["deep"]
    print(f"main: {n} frames 376x1241: {fps:.2f} FPS after {WARMUP} warmup frames, p50 frame "
          f"{p50:.2f} ms [{card}]", flush=True)
    print(f"main: n_kf {n_kf}, n_lm {n_lm}, frame ATE {ate:.4f} m (align=False; the JAX package "
          f"on a CPU at 100 frames: 0.0905 m, 15 KFs), median inliers "
          f"{int(np.median(slam.metrics['num_inliers']))}, lk_pyramid launches "
          f"{launches['lk_pyramid']} ({launches['lk_pyramid'] / tracked:.2f}/tracked frame), "
          f"per-level launches: lk_level {launches['lk_level']}, lk_final_error "
          f"{launches['lk_final_error']}; of them {gated} gated rescue launches, {fired} on "
          f"(retry {slam.rescues['retry']}, deep {slam.rescues['deep']}), {gated - fired} gated "
          f"off; {slam.track_graph.replays} graph replays", flush=True)
    if slam.track_graph.replays != tracked:
        fail("main", "graph", f"{slam.track_graph.replays} graph replays for {tracked} tracked "
             f"frames")
    if n_kf < 2 or n_lm <= 0:
        fail("main", "map", f"map did not grow: n_kf {n_kf}, n_lm {n_lm}")
    if launches["lk_pyramid"] < tracked:
        fail("main", "launches", f"the main path bypassed the LK kernel: {launches}")
    if launches["lk_level"] or launches["lk_final_error"]:
        fail("main", "launches", f"the main path launched the per-level entries: {launches}")
    if not ate <= MAX_ATE_M:
        fail("main", "ATE", f"frame ATE {ate:.4f} m exceeds {MAX_ATE_M} m")
    if not KF_BAND[0] <= n_kf <= KF_BAND[1]:
        fail("main", "keyframes", f"{n_kf} keyframes outside {KF_BAND}")
    if (n_kf, n_lm, round(ate, 4)) != EXPECTED_RUN:
        fail("main", "repeat", f"(KFs, landmarks, ATE) = {(n_kf, n_lm, round(ate, 4))}, expected "
             f"{EXPECTED_RUN}: "
             f"the run repeats bit for bit, so the code's arithmetic changed")
    # What phase cli holds the CLI's outputs to.
    slam.save_trajectory(str(work / "main_trajectory.txt"))
    return launches, slam


def rescue_launches(cfg, tracked: int) -> int:
    """The gated LK rescue launches of ``tracked`` frames: the rescue pass
    and, where the image allows a deeper pyramid, the deep one, each
    launched on every tracked frame and gated on the device."""
    from stereoslam_tpu_torch.core.frontend import _max_pyramid_depth

    t = cfg.tracking
    deep_n = min(t.lk_levels + t.lk_rescue_extra_levels,
                 _max_pyramid_depth(cfg.image_height, cfg.image_width, t.lk_window))
    per_frame = (t.lk_retry_fail_frac > 0) * (1 + (t.lk_rescue_extra_levels > 0
                                                   and deep_n > t.lk_levels))
    return per_frame * tracked


# ---------------------------------------------------------------------------
# Phase pipeline: the tracked frame's CUDA graph, its host syncs, the lag
# ---------------------------------------------------------------------------

PIPE_LAG, PIPE_CHUNK = 10, 8
PIPE_MAX_ATE_M = 0.02
PIPE_TIMING_REPS = 10


class SyncCount:
    """Counts the host syncs torch's sync-debug mode reports ("called a
    synchronizing CUDA operation"; its one-time notice that the mode is a
    prototype is not a sync)."""

    def __enter__(self):
        import warnings

        self.n = 0
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _show(self, message, *args, **kw):
        self.n += "called a synchronizing CUDA operation" in str(message)

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)


def frame_kind(before, after) -> str:
    """'keyframe', 'replenish' or 'plain' from (n_kf, n_lm) around a frame."""
    if after[0] != before[0]:
        return "keyframe"
    return "replenish" if after[1] != before[1] else "plain"


def time_frames(fn, reps: int):
    """(wall, event span, device kernel time), ms per call: the host clock
    around ``reps`` calls that end in a synchronize, CUDA events around the
    same calls, and the CUDA kernels' time (torch.profiler) in a second
    window of as many calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    span = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps
    return wall, span, kern


def check_svd(dev, phase: str) -> None:
    """ops/svd.py's cuSOLVER call (no host read) against torch.linalg.svd,
    bit for bit, on 3x3 matrices one at a time (the tracked frame's float32
    pose), in batches of 7 (the windowed BA's float64 window) and in one
    batch: rotations off by 1e-7 to 1 of noise, in float32 and float64."""
    from stereoslam_tpu_torch.ops.svd import svd

    def same(m):
        return all(torch.equal(x, y) for x, y in zip(svd(m), torch.linalg.svd(m)))

    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(5)
        mats = []
        for scale in (1e-7, 1e-6, 1e-3, 1.0):
            q, _ = torch.linalg.qr(torch.randn(49, 3, 3, device=dev, dtype=dtype, generator=gen))
            mats.append(q * torch.sign(torch.linalg.det(q))[:, None, None]
                        + scale * torch.randn(49, 3, 3, device=dev, dtype=dtype, generator=gen))
        mats = torch.cat(mats)
        one = all(same(m) for m in mats)
        sevens = all(same(m) for m in mats.reshape(-1, 7, 3, 3))
        batch = same(mats)
        print(f"{phase}: ops/svd.py svd against torch.linalg.svd on {len(mats)} 3x3 {dtype} "
              f"matrices: {'bit-identical' if one else 'DIFFER'} one at a time, "
              f"{'bit-identical' if sevens else 'DIFFER'} in batches of 7, "
              f"{'bit-identical' if batch else 'DIFFER'} as one batch", flush=True)
        if not (one and sevens and batch):
            fail(phase, "svd", f"ops/svd.py's cuSOLVER call differs from torch.linalg.svd "
                 f"in {dtype}")


def phase_pipeline(dev, seq, main_slam, card: str) -> None:
    """Phase main's frames through the pipelined facade, staged on the card
    in advance: every replay against the eager track_frame (bit for bit),
    host syncs per frame by kind, lag 10 and process_chunk against phase
    main's run, and the keyframe-free frame eager against replayed."""
    from stereoslam_tpu_torch.core import frontend as F
    from stereoslam_tpu_torch.core.graphs import _clone
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    cfg = kitti_config(seq)
    n = len(seq.left)
    check_svd(dev, "pipeline")
    staged = [torch.from_numpy(np.stack([seq.left[t], seq.right[t]]).astype(np.uint8)).to(dev)
              for t in range(n)]
    torch.cuda.synchronize()
    t_phase = time.perf_counter()

    # Lag 0, each replay held against the eager frame, syncs counted.
    slam = StereoSlam(cfg, device=dev, enable_loop=False)
    g = slam.track_graph
    syncs = {"plain": [], "replenish": [], "keyframe": []}
    differ = []
    snapshot = None
    for t in range(n):
        before = (int(slam.map.n_kf), int(slam.map.n_lm))
        reads = slam.outcome_reads
        torch.cuda.synchronize()
        with SyncCount() as sc:
            ok = slam.process_staged(staged[t], seq.timestamps[t])
        if not ok:
            fail("pipeline", "LOST", f"tracking LOST at frame {t}")
        kind = frame_kind(before, (int(slam.map.n_kf), int(slam.map.n_lm)))
        if t >= 2:  # frame 0 initializes, frame 1 captures the graph
            syncs[kind].append((sc.n, slam.outcome_reads - reads))
        if t >= 1 and not replay_equals_eager(g):
            differ.append(t)
        if kind == "plain" and t >= WARMUP and snapshot is None:
            snapshot = (t, _clone(g._inputs))
    print(f"pipeline: graph replay against the eager track_frame on the same inputs, frames "
          f"1..{n - 1}: {'bit-identical' if not differ else f'DIFFER at frames {differ}'} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if differ:
        fail("pipeline", "replay vs eager", f"graph replay differs from the eager track_frame at "
             f"frames {differ}")
    for kind, v in syncs.items():
        if v:
            arr = np.asarray(v)
            print(f"pipeline: host syncs per {kind} tracked frame through process_staged (frames "
                  f"staged in advance): {arr.sum(1).mean():.2f} (min {arr.sum(1).min()}, max "
                  f"{arr.sum(1).max()}) over {len(v)} frames: outcome reads {arr[:, 1].mean():.2f}, "
                  f"other syncs {arr[:, 0].mean():.2f}", flush=True)
    plain = np.asarray(syncs["plain"])
    if len(plain) == 0 or not (plain[:, 0] == 0).all() or not (plain[:, 1] == 1).all():
        fail("pipeline", "syncs", f"a keyframe-free tracked frame made other than one host read: "
             f"(other syncs, outcome reads) {syncs['plain']}")
    same_run = all(np.array_equal(a, b) for a, b in
                   zip(slam.keyframe_trajectory(), main_slam.keyframe_trajectory()))
    if not same_run:
        fail("pipeline", "repeat", "the run with staged frames differs from phase main's")

    # Lag 10 and process_chunk against phase main's run.
    main_ids, main_T = main_slam.frame_trajectory()
    main_kf = main_slam.map.kf_frame_id[:int(main_slam.map.n_kf)].cpu().numpy()
    lag = StereoSlam(cfg, device=dev, enable_loop=False, readback_lag=PIPE_LAG)
    t0 = time.perf_counter()
    for t in range(n):
        if not lag.process_staged(staged[t], seq.timestamps[t]):
            fail("pipeline", "LOST", f"lag {PIPE_LAG}: LOST retired by frame {t}")
    torch.cuda.synchronize()
    t_lag = time.perf_counter() - t0
    chunk = StereoSlam(cfg, device=dev, enable_loop=False)
    for t in range(2):
        chunk.process_staged(staged[t], seq.timestamps[t])
    t0 = time.perf_counter()
    for base in range(2, n, PIPE_CHUNK):
        hi = min(base + PIPE_CHUNK, n)
        if not chunk.process_chunk(torch.stack(staged[base:hi]), seq.timestamps[base:hi]):
            fail("pipeline", "LOST", f"process_chunk: LOST retired by frame {hi - 1}")
    torch.cuda.synchronize()
    t_chunk = time.perf_counter() - t0
    for name, other, wall, frames in (("lag 10", lag, t_lag, n), (f"process_chunk C={PIPE_CHUNK}",
                                                                  chunk, t_chunk, n - 2)):
        ids, T = other.frame_trajectory()
        kf = other.map.kf_frame_id[:int(other.map.n_kf)].cpu().numpy()
        ate = ate_rmse(np.linalg.inv(T.astype(np.float64)), np.linalg.inv(main_T.astype(np.float64)),
                       align=False) if np.array_equal(ids, main_ids) else float("inf")
        bit = np.array_equal(T, main_T)
        print(f"pipeline: {name}: keyframe frames {'equal to' if np.array_equal(kf, main_kf) else 'DIFFER from'} "
              f"phase main's ({len(kf)}), frame-trajectory ATE against phase main's run {ate:.2e} m "
              f"({'bit-identical' if bit else 'not bit-identical'}); {frames / wall:.2f} FPS over "
              f"{frames} frames (staged in advance, card synchronized at the end) [{card}]",
              flush=True)
        if not np.array_equal(kf, main_kf) or not ate <= PIPE_MAX_ATE_M:
            fail("pipeline", name, f"keyframe frames {kf.tolist()} against {main_kf.tolist()}, "
                 f"ATE {ate} m against phase main's run (bound {PIPE_MAX_ATE_M} m)")

    # The keyframe-free frame, eager against replayed, interleaved, on the
    # inputs of the first keyframe-free frame after the warm-up.
    t_snap, (lr, pyr_prev, fs, tmap) = snapshot
    host = torch.empty(F.OUTCOME_SIZE, dtype=torch.float32, pin_memory=True)
    landed = torch.cuda.Event()

    def eager():
        F.track_frame(lr[0].to(torch.float32), pyr_prev, fs, tmap, slam.intr_left, cfg)[2].cpu()

    def replayed():
        g.run(lr, pyr_prev, fs, tmap)
        host.copy_(g._outputs[3], non_blocking=True)
        landed.record()
        landed.synchronize()

    t0 = time.perf_counter()
    runs = [(name, time_frames(fn, PIPE_TIMING_REPS)) for name, fn in
            (("eager", eager), ("replayed", replayed), ("replayed", replayed), ("eager", eager))]
    for name, (wall, span, kern) in runs:
        print(f"pipeline: keyframe-free frame {t_snap} {name}: {wall:.3f} ms wall, {span:.3f} ms "
              f"between CUDA events, {kern:.3f} ms device kernel time (profiler), device busy "
              f"{kern / wall:.1%} (track_frame and its outcome read; replayed adds the copy-in; "
              f"{PIPE_TIMING_REPS} calls each) [{card}]", flush=True)
    print(f"pipeline: the timing took {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase ba: the windowed BA as one CUDA graph, and the asynchronous BA
# ---------------------------------------------------------------------------

BA_LAGS = (0, 10)
BA_REPLAYS = 10       # BA graph replays timed back to back
BA_EAGER_REPS = 3     # eager BA calls timed back to back


class SyncError:
    """torch's sync-debug mode at "error": a host read raises."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def ba_fields_equal(a, b) -> bool:
    from stereoslam_tpu_torch.core.backend import BA_OUTPUTS

    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in BA_OUTPUTS)


def check_ba_graph(dev, cfg, m0, intr, card: str) -> None:
    """(a) On phase main's final map: the BA graph's replay against the eager
    optimize_active_map, the fixed-step driver against the early-exit one
    (every output field, bit for bit), no host read in the eager fixed-step
    BA nor in a replay, the early exit's steps, and the times."""
    from stereoslam_tpu_torch.core import backend as B
    from stereoslam_tpu_torch.core.graphs import BAGraph
    from stereoslam_tpu_torch.ops import schur

    steps = []
    real = schur._lm_step
    schur._lm_step = lambda *a: (steps.append(1), real(*a))[1]
    try:
        early = B.optimize_active_map(m0, intr, cfg, host_exit=True)
    finally:
        schur._lm_step = real
    try:
        with SyncError():
            fixed = B.optimize_active_map(m0, intr, cfg)
        g = BAGraph(cfg, intr, dev)
        g(m0)  # the capture, after its warm-up
        with SyncError():
            replay = g(m0)
    except RuntimeError as e:
        fail("ba", "(a) host read", f"the BA on the card read the host: {e}")
    torch.cuda.synchronize()
    fixed_early, replay_fixed = ba_fields_equal(fixed, early), ba_fields_equal(replay, fixed)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    src = B.BAMap.of(m0)
    w = cfg.backend

    def replays() -> tuple:
        """(device ms a replay by CUDA events around BA_REPLAYS back to back,
        host ms a replay to enqueue them)."""
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(BA_REPLAYS):
            g.run(src)
        end.record()
        host = (time.perf_counter() - t0) * 1e3 / BA_REPLAYS
        end.synchronize()
        return start.elapsed_time(end) / BA_REPLAYS, host

    def fixed_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        B.optimize_active_map(m0, intr, cfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def early():
        return time_frames(lambda: B.optimize_active_map(m0, intr, cfg, host_exit=True),
                           BA_EAGER_REPS)

    # In turns: replay, early exit, fixed steps, fixed steps, early exit, replay.
    times = [replays(), early(), fixed_ms(), fixed_ms(), early(), replays()]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.run(src)
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kern)
    print(f"ba: (a) on phase main's final map (W={m0.active_kf.shape[0]}, N="
          f"{m0.kf_feat_valid.shape[1]}): the graph's replay against the eager "
          f"optimize_active_map {'bit-identical' if replay_fixed else 'DIFFER'}, the fixed "
          f"{w.ba_rounds}x{w.ba_iters} steps against the early exit "
          f"{'bit-identical' if fixed_early else 'DIFFER'} (every output field); no host read "
          f"in the eager fixed-step BA nor in a replay (sync-debug 'error'); the early exit took "
          f"{len(steps)} LM steps of {w.ba_rounds * w.ba_iters}", flush=True)
    print(f"ba: (a) BA graph replay with its copy-in: {times[0][0]:.3f}, {times[5][0]:.3f} ms a "
          f"replay between CUDA events ({BA_REPLAYS} back to back), {times[0][1]:.3f}, "
          f"{times[5][1]:.3f} ms of host enqueue; the eager fixed steps {times[2]:.1f}, "
          f"{times[3]:.1f} ms wall (card synchronized) [{card}]", flush=True)
    for wall, span, k in (times[1], times[4]):
        print(f"ba: (a) BA eager early exit: {wall:.3f} ms wall, {span:.3f} ms between CUDA "
              f"events, {k:.3f} ms device kernel time (profiler), device busy {k / wall:.1%} "
              f"[{card}]", flush=True)
    print(f"ba: (a) one replay, {sum(e.count for e in kern)} kernels, {total / 1e3:.2f} ms; the "
          f"top 8 by device time (launches, ms): " + "; ".join(
              f"{e.key[:70]} ({e.count}, {e.self_device_time_total / 1e3:.2f})" for e in kern[:8])
          + f" [{card}]", flush=True)
    if not (fixed_early and replay_fixed):
        fail("ba", "(a) bit for bit", f"fixed vs early exit {fixed_early}, replay vs eager "
             f"{replay_fixed}")


def ba_async_run(dev, cfg, staged, seq, lag: int, trace: bool):
    """Phase main's frames, staged in advance, through
    StereoSlam(inline_ba=False): (slam, seconds, spans).  With ``trace``,
    CUDA events around every BA replay (on the BA's side stream) and every
    tracked frame's replay (on the facade's stream), after their captures."""
    from stereoslam_tpu_torch.core.system import StereoSlam

    slam = StereoSlam(cfg, device=dev, enable_loop=False, inline_ba=False, readback_lag=lag)
    spans = {"ba": [], "track": []}
    if trace:
        for name, graph in (("ba", slam._ba), ("track", slam.track_graph)):
            def run(*a, _run=graph.run, _name=name, _graph=graph):
                if _graph.graph is None:
                    return _run(*a)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = _run(*a)
                end.record()
                spans[_name].append((start, end))
                return out
            graph.run = run
    base = torch.cuda.Event(enable_timing=True)
    base.record()
    t0 = time.perf_counter()
    for t in range(len(staged)):
        if not slam.process_staged(staged[t], seq.timestamps[t]):
            fail("ba", "(b) LOST", f"lag {lag}: LOST retired by frame {t}")
    slam.frame_trajectory()  # drains: the last BA swapped in
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = {k: [(base.elapsed_time(a), base.elapsed_time(b)) for a, b in v]
             for k, v in spans.items()}
    return slam, wall, spans


def overlap(spans) -> tuple:
    """(BA replays that overlap a tracked frame's replay, overlapped ms, BA ms)."""
    hit, both = 0, 0.0
    for a, b in spans["ba"]:
        o = sum(max(0.0, min(b, d) - max(a, c)) for c, d in spans["track"])
        hit += o > 0
        both += o
    return hit, both, sum(b - a for a, b in spans["ba"])


def check_ba_async(dev, cfg, staged, seq, card: str) -> int:
    """(b) Phase main's frames with inline_ba=False at lags 0 and 10, twice
    each: no LOST, the keyframe band, ATE, bit-for-bit repeats, the graphs
    and kernels, and the BA's overlap with tracked frames."""
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K

    n = len(staged)
    launches = 0
    for lag in BA_LAGS:
        result = []
        for rep in range(2):
            reset_counters()
            slam, wall, spans = ba_async_run(dev, cfg, staged, seq, lag, trace=rep == 0)
            lk, per_level = L.lk_pyramid.launches, K.lk_level.launches + K.lk_final_error.launches
            launches += lk
            n_kf = int(slam.map.n_kf)
            ids, T = slam.frame_trajectory()
            kf = slam.keyframe_trajectory()
            ate = frame_ate(slam, seq)
            result.append((T, kf))
            line = (f"ba: (b) inline_ba=False, lag {lag}, run {rep + 1}: {(n - 1) / wall:.2f} FPS "
                    f"over {n} frames staged in advance (card synchronized at the end), "
                    f"{n_kf} KFs, {int(slam.map.n_lm)} landmarks, frame ATE {ate:.4f} m, "
                    f"{slam._ba.replays} BA replays, {slam.track_graph.replays} frame replays, "
                    f"lk_pyramid {lk}, per-level {per_level}")
            if rep == 0:
                hit, both, ba_ms = overlap(spans)
                line += (f"; {hit} of {len(spans['ba'])} BA replays on the side stream overlap a "
                         f"tracked frame's replay, {both:.2f} of {ba_ms:.2f} ms of BA overlapped "
                         f"(CUDA events)")
                if hit < 1:
                    fail("ba", "(b) overlap", f"lag {lag}: no BA replay overlapped a tracked frame")
            print(line + f" [{card}]", flush=True)
            if not KF_BAND[0] <= n_kf <= KF_BAND[1]:
                fail("ba", "(b) keyframes", f"lag {lag}: {n_kf} keyframes outside {KF_BAND}")
            if not ate <= MAX_ATE_M:
                fail("ba", "(b) ATE", f"lag {lag}: frame ATE {ate:.4f} m exceeds {MAX_ATE_M} m")
            if slam.track_graph.replays != n - 1 or lk < n - 1 or per_level:
                fail("ba", "(b) launches", f"lag {lag}: {slam.track_graph.replays} replays, "
                     f"lk_pyramid {lk}, per-level {per_level} for {n - 1} tracked frames")
            if slam._ba.replays < n_kf:
                fail("ba", "(b) BA replays", f"lag {lag}: {slam._ba.replays} for {n_kf} KFs")
        (Ta, kfa), (Tb, kfb) = result
        same = np.array_equal(Ta, Tb) and all(np.array_equal(x, y) for x, y in zip(kfa, kfb))
        print(f"ba: (b) lag {lag}: the two runs {'bit-identical' if same else 'DIFFER'}",
              flush=True)
        if not same:
            fail("ba", "(b) repeat", f"lag {lag}: two runs of the same frames differ")
    return launches


def check_ba_inline(dev, cfg, staged, seq, main_slam, card: str) -> None:
    """(c) The inline BA through its graph against the eager early-exit BA,
    in turns in one process: keyframe frames' wall time (card synchronized
    around each frame) and host syncs, FPS at lag 0 (card synchronized
    after each frame; in turns) and at lag 10 (at the end; one run each),
    and the runs bit for bit."""
    from stereoslam_tpu_torch.core import backend as B
    from stereoslam_tpu_torch.core.system import StereoSlam

    def facade(kind: str, lag: int = 0):
        slam = StereoSlam(cfg, device=dev, enable_loop=False, readback_lag=lag)
        if kind == "eager early exit":
            slam._ba = functools.partial(B.optimize_active_map, intr=slam.intr_left, cfg=cfg,
                                         host_exit=True)
        return slam

    def lagged(kind: str):
        slam = facade(kind, PIPE_LAG)
        for t in range(WARMUP):
            slam.process_staged(staged[t], seq.timestamps[t])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(WARMUP, len(staged)):
            if not slam.process_staged(staged[t], seq.timestamps[t]):
                fail("ba", "(c) LOST", f"{kind}, lag {PIPE_LAG}: LOST by frame {t}")
        slam._drain()
        torch.cuda.synchronize()
        return (len(staged) - WARMUP) / (time.perf_counter() - t0), slam.keyframe_trajectory()

    def run(kind: str, count: bool):
        slam = facade(kind)
        kf_ms, kf_syncs, frame_ms = [], [], []
        for t in range(len(staged)):
            before = (int(slam.map.n_kf), int(slam.map.n_lm))
            reads = slam.outcome_reads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if count:
                with SyncCount() as sc:
                    ok = slam.process_staged(staged[t], seq.timestamps[t])
            else:
                ok = slam.process_staged(staged[t], seq.timestamps[t])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            frame_ms.append(dt)
            if not ok:
                fail("ba", "(c) LOST", f"{kind}: LOST at frame {t}")
            if t >= 2 and frame_kind(before, (int(slam.map.n_kf), int(slam.map.n_lm))) == "keyframe":
                kf_ms.append(dt)
                if count:
                    kf_syncs.append(sc.n + slam.outcome_reads - reads)
        fps = (len(staged) - WARMUP) / (sum(frame_ms[WARMUP:]) / 1e3)
        return slam.keyframe_trajectory(), kf_ms, kf_syncs, fps

    out = [(kind, count, run(kind, count)) for kind, count in (
        ("graph", False), ("eager early exit", False), ("eager early exit", True),
        ("graph", True))]
    lag = [(kind, lagged(kind)) for kind in ("eager early exit", "graph")]
    ref = main_slam.keyframe_trajectory()
    same = all(all(np.array_equal(x, y) for x, y in zip(kf, ref))
               for kf in [o[2][0] for o in out] + [o[1][1] for o in lag])
    for kind, (fps, _) in lag:
        print(f"ba: (c) inline BA through the {kind}, lag {PIPE_LAG}: {fps:.2f} FPS after "
              f"{WARMUP} warm-up frames (staged in advance, card synchronized at the end) "
              f"[{card}]", flush=True)
    for kind, count, (_, kf_ms, syncs, fps) in out:
        print(f"ba: (c) inline BA through the {kind}, lag 0: {fps:.2f} FPS after {WARMUP} "
              f"warm-up frames; keyframe frames {np.median(kf_ms):.2f} ms "
              f"median (min {min(kf_ms):.2f}, max {max(kf_ms):.2f}) over {len(kf_ms)} frames "
              f"(card synchronized around each)"
              + (f"; host syncs a keyframe frame {np.mean(syncs):.2f} (min {min(syncs)}, max "
                 f"{max(syncs)}) under the sync count" if count else "") + f" [{card}]",
              flush=True)
    print(f"ba: (c) the six runs' keyframe trajectories against phase main's: "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        fail("ba", "(c) repeat", "the inline BA through the graph or the eager early exit "
             "changed the run")


def phase_ba(dev, seq, main_slam, card: str) -> int:
    """The windowed BA as one CUDA graph and the asynchronous BA: (a) on
    phase main's final map, (b) inline_ba=False over phase main's frames,
    (c) the inline BA's graph against the eager early exit."""
    cfg = kitti_config(seq)
    t_part = [time.perf_counter()]

    def part(name):
        t_part.append(time.perf_counter())
        print(f"ba: {name} took {t_part[-1] - t_part[-2]:.1f} s", flush=True)

    check_ba_graph(dev, cfg, main_slam.map, main_slam.intr_left, card)
    part("(a)")
    staged = [torch.from_numpy(np.stack([seq.left[t], seq.right[t]]).astype(np.uint8)).to(dev)
              for t in range(len(seq.left))]
    launches = check_ba_async(dev, cfg, staged, seq, card)
    part("(b)")
    check_ba_inline(dev, cfg, staged, seq, main_slam, card)
    part("(c)")
    return launches


# ---------------------------------------------------------------------------
# Phase cli: the user's entry point over phase main's frames
# ---------------------------------------------------------------------------

CLI_RUN2_FRAMES = 40
CLI_RUN2_PLOT_EVERY = 20
CLI_RUN2_TIMEOUT_S = 600


def write_png_gray(path: Path, img: np.ndarray) -> None:
    """An 8-bit greyscale, non-interlaced PNG (filter 0 on every row), with
    the standard library only, so that neither cv2 nor PIL is needed."""
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.astype(np.uint8)], axis=1)
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                     + chunk(b"IEND", b""))


def write_kitti_dir(seq, cfg, d: Path) -> None:
    """Phase main's frames as a KITTI odometry directory: image_0/, image_1/,
    times.txt (repr floats, so they parse back exactly), a poses file of
    T_wc rows, and the config as reference-style OpenCV YAML."""
    for cam, frames in (("image_0", seq.left), ("image_1", seq.right)):
        (d / cam).mkdir()
        for i, img in enumerate(frames):
            write_png_gray(d / cam / f"{i:06d}.png", img)
    (d / "times.txt").write_text("".join(f"{float(t)!r}\n" for t in seq.timestamps))
    T_wc = np.linalg.inv(seq.T_cw.astype(np.float64))
    np.savetxt(d / "poses.txt", T_wc[:, :3, :].reshape(len(T_wc), 12))
    c = cfg.camera
    keys = {"Camera.left.fx": c.fx, "Camera.left.fy": c.fy, "Camera.left.cx": c.cx,
            "Camera.left.cy": c.cy, "Camera.right.fx": c.fx_right,
            "Camera.right.fy": c.fy_right, "Camera.right.cx": c.cx_right,
            "Camera.right.cy": c.cy_right, "Camera.bf": c.bf}
    (d / "config.yaml").write_text(
        "%YAML:1.0\n" + "".join(f"{k}: {float(v)!r}\n" for k, v in keys.items()))


class LogLines(logging.Handler):
    """Keeps the messages a logger emits."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())


def check_decode(seq, d: Path) -> str:
    """The written PNGs decode back bit for bit, in order, through the native
    loader where it can be built, else through kitti.frames' fallback."""
    from stereoslam_tpu_torch.native import dataloader
    from stereoslam_tpu_torch.utils import kitti

    t0 = time.perf_counter()
    try:
        dataloader.library()
    except dataloader.ToolchainMissing as e:
        route = "kitti.frames fallback (read_gray)"
        print(f"cli: native loader not built, g++ or libpng missing: {e}; holding the "
              f"fallback decoder instead", flush=True)
        out = list(kitti.frames(str(d)))
    except (OSError, RuntimeError) as e:
        fail("cli", "native build", f"the native loader failed to build or load: {e}")
    else:
        route = "native loader"
        print(f"cli: native loader built and loaded ({dataloader.build_library().name}) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        lp, rp, ts = kitti.load_image_paths(str(d))
        out = list(dataloader.stream_pairs(lp, rp, ts))
    dt = time.perf_counter() - t0
    if len(out) != len(seq.left):
        fail("cli", "decode", f"{route} yielded {len(out)} pairs, expected {len(seq.left)}")
    for i, (left, right, ts) in enumerate(out):
        if not (np.array_equal(left, seq.left[i].astype(np.uint8))
                and np.array_equal(right, seq.right[i].astype(np.uint8))):
            fail("cli", "decode", f"{route}: pair {i} differs from the frames written")
        if float(ts) != float(seq.timestamps[i]):
            fail("cli", "decode", f"{route}: timestamp {i} is {ts!r}, wrote "
                 f"{float(seq.timestamps[i])!r}")
    print(f"cli: {route}: {len(out)} pairs 376x1241 bit-equal to the frames written, in order "
          f"({dt:.2f} s)", flush=True)
    return route


def check_profiler(slam, seq) -> None:
    """Phase main's profiler records: one per frame, in order, with the
    keyframe ids the map holds for keyframes after the init frame."""
    recs = slam.profiler.frames
    n = len(seq.left)
    if [r.frame for r in recs] != list(range(n)):
        fail("cli", "profiler frames", f"{len(recs)} records, frames {[r.frame for r in recs][:5]}..., "
             f"expected 0..{n - 1}")
    if [r.timestamp for r in recs] != [float(t) for t in seq.timestamps]:
        fail("cli", "profiler timestamps", "record timestamps differ from the sequence's")
    n_kf = int(slam.map.n_kf)
    kf_frames = slam.map.kf_frame_id[:n_kf].cpu().numpy().tolist()
    kf = [(r.keyframe_id, r.frame) for r in recs if r.keyframe_id >= 0]
    if [k for k, _ in kf] != list(range(1, n_kf)) or [f for _, f in kf] != kf_frames[1:]:
        fail("cli", "profiler keyframes", f"records' (keyframe_id, frame) {kf} against the map's "
             f"keyframe frames {kf_frames}")
    track = slam.profiler.summary().get("track", {})
    if track.get("count") != n - 1:
        fail("cli", "profiler track stage", f"'track' timed {track.get('count')} times, expected "
             f"{n - 1}")
    print(f"cli: profiler of phase main: {len(recs)} records, {len(kf)} keyframe records "
          f"matching the map, 'track' mean {track['mean_ms']} ms", flush=True)


def phase_cli(dev, seq, main_slam, work: Path, card: str) -> None:
    from stereoslam_tpu_torch import run as cli
    from stereoslam_tpu_torch.config import load_config
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    cfg = kitti_config(seq)
    d = work / "kitti"
    d.mkdir()
    t0 = time.perf_counter()
    write_kitti_dir(seq, cfg, d)
    print(f"cli: wrote {len(seq.left)} stereo pairs as PNG, times.txt, poses.txt and "
          f"config.yaml in {time.perf_counter() - t0:.1f} s", flush=True)
    loaded = dataclasses.asdict(load_config(str(d / "config.yaml")))
    if loaded != dataclasses.asdict(cfg):
        diff = {k: (v, dataclasses.asdict(cfg)[k]) for k, v in loaded.items()
                if v != dataclasses.asdict(cfg)[k]}
        fail("cli", "config", f"load_config of the written YAML differs from phase main's: {diff}")
    check_decode(seq, d)

    # Phase main's keyframe ATE, as the CLI computes it (align=True).
    ids, _, T_cw = main_slam.keyframe_trajectory()
    fid = main_slam.map.kf_frame_id[:len(ids)].cpu().numpy()
    main_ate = ate_rmse(np.linalg.inv(T_cw.astype(np.float64)),
                        np.linalg.inv(seq.T_cw[fid].astype(np.float64)), align=True)

    # Run 1: in-process, VO only, on every frame.
    out1 = work / "run1"
    slams = []
    log_lines = LogLines()
    pkg_log = logging.getLogger("stereoslam_tpu_torch")
    pkg_log.addHandler(log_lines)
    pkg_log.setLevel(logging.INFO)
    L.lk_pyramid.launches = 0
    K.lk_level.launches = 0
    K.lk_final_error.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main([str(d / "config.yaml"), str(d), "--output", str(out1), "--no-loop",
                       "--gt", str(d / "poses.txt"), "--device", str(dev)],
                      on_slam=slams.append)
    finally:
        pkg_log.removeHandler(log_lines)
        pkg_log.setLevel(logging.WARNING)
    wall = time.perf_counter() - t0
    launches = {"lk_pyramid": L.lk_pyramid.launches, "lk_level": K.lk_level.launches,
                "lk_final_error": K.lk_final_error.launches}
    if rc != 0:
        fail("cli", "run 1 exit", f"stereoslam_tpu_torch.run.main returned {rc}")
    slam = slams[0]
    n = len(seq.left)
    tracked = n - 1
    if len(slam.frame_latency_ms) != n:
        fail("cli", "run 1 frames", f"the CLI processed {len(slam.frame_latency_ms)} of {n} frames")
    got, want = (out1 / "trajectory.txt").read_bytes(), (work / "main_trajectory.txt").read_bytes()
    if got != want:
        fail("cli", "run 1 trajectory", f"trajectory.txt ({len(got)} bytes) differs from phase "
             f"main's ({len(want)} bytes): the IO path changed the frames")
    if (out1 / "loopEdges.txt").read_text() != "":
        fail("cli", "run 1 loop edges", "loopEdges.txt of a --no-loop run is not empty")
    ate_lines = [m for m in log_lines.lines if m.startswith("ATE RMSE vs ground truth")]
    logged = re.match(r"ATE RMSE vs ground truth: (\S+) m", ate_lines[-1]) if ate_lines else None
    if logged is None or logged.group(1) != f"{main_ate:.3f}":
        fail("cli", "run 1 ATE", f"logged {ate_lines}, phase main's keyframe ATE is {main_ate:.3f} m")
    if launches["lk_pyramid"] < tracked:
        fail("cli", "run 1 launches", f"the CLI path bypassed the LK kernel: {launches}")
    if launches["lk_level"] or launches["lk_final_error"]:
        fail("cli", "run 1 launches", f"the CLI path launched the per-level entries: {launches}")
    avg = [m for m in log_lines.lines if m.startswith("processed ")]
    decoder = [m for m in log_lines.lines if m.startswith("decoding ")]
    lat = np.asarray(slam.frame_latency_ms[WARMUP:])
    main_lat = np.asarray(main_slam.frame_latency_ms[WARMUP:])
    track = slam.profiler.summary()["track"]
    if slam.rescues != main_slam.rescues:
        fail("cli", "run 1 rescues", f"LK rescues {slam.rescues} against phase main's "
             f"{main_slam.rescues}")
    print(f"cli: run 1 (in-process, --no-loop --gt, {n} frames): trajectory.txt byte-equal to "
          f"phase main's, keyframe ATE {logged.group(1)} m (align=True) as phase main's, "
          f"lk_pyramid launches {launches['lk_pyramid']} ({launches['lk_pyramid'] / tracked:.2f}"
          f"/tracked frame), per-level launches: lk_level {launches['lk_level']}, "
          f"lk_final_error {launches['lk_final_error']}; decoder: {decoder}", flush=True)
    print(f"cli: run 1 speed: the CLI logged '{avg[-1] if avg else None}'; main() returned after "
          f"{wall:.2f} s; after {WARMUP} warmup frames: {len(lat) / lat.sum() * 1e3:.2f} FPS by "
          f"process_staged latency (phase main: {len(main_lat) / main_lat.sum() * 1e3:.2f}), "
          f"p50 {np.median(lat):.2f} ms (phase main {np.median(main_lat):.2f}); profiler 'track' "
          f"mean {track['mean_ms']} ms over {track['count']} frames [{card}]", flush=True)
    del slam, slams

    # Run 2: the module entry with the default flags (loop closing with the
    # trained CALC, backend on, the card), in a process of its own.
    out2 = work / "run2"
    plot = importlib.util.find_spec("matplotlib") is not None
    cmd = [sys.executable, "-m", "stereoslam_tpu_torch.run", str(d / "config.yaml"), str(d),
           "--max-frames", str(CLI_RUN2_FRAMES), "--output", str(out2)]
    if plot:
        cmd += ["--plot-every", str(CLI_RUN2_PLOT_EVERY)]
    else:
        print("cli: run 2 without --plot-every: matplotlib is not installed", flush=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=str(Path(__file__).resolve().parent), capture_output=True,
                              text=True, timeout=CLI_RUN2_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail("cli", "run 2 exit", f"{' '.join(cmd[1:4])} ran over {CLI_RUN2_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    tail = "\n".join(proc.stderr.strip().splitlines()[-15:])
    if proc.returncode != 0:
        fail("cli", "run 2 exit", f"python -m stereoslam_tpu_torch.run exited {proc.returncode}:\n"
             f"{tail}")
    rows = (out2 / "trajectory.txt").read_text().strip().splitlines() \
        if (out2 / "trajectory.txt").exists() else []
    if not rows or any(len(r.split()) != 9 for r in rows):
        fail("cli", "run 2 trajectory", f"trajectory.txt has {len(rows)} rows, or rows that are "
             f"not 9 fields:\n{tail}")
    wanted = ["loopEdges.txt", "map.ply"] + (["live.png"] if plot else [])
    missing = [f for f in wanted if not (out2 / f).exists()]
    if missing:
        fail("cli", "run 2 files", f"missing {missing}:\n{tail}")
    run2_log = [line for line in proc.stderr.splitlines()
                if "processed " in line or "decoding " in line or "3D map" in line]
    print(f"cli: run 2 (python -m stereoslam_tpu_torch.run, defaults: loop ON with trained "
          f"CALC, {CLI_RUN2_FRAMES} frames): exit 0 in {wall:.1f} s wall, {len(rows)} keyframe rows, "
          f"files {wanted}; its log: {run2_log} [{card}]", flush=True)

    check_profiler(main_slam, seq)


def phase_calc(dev, img_np, card: str) -> None:
    """The shipped CALC encoder and the HOG descriptor on one keyframe image,
    on the card against the CPU."""
    from stereoslam_tpu_torch.models import calc

    img_cpu = torch.from_numpy(img_np.astype(np.uint8)).float()
    img = img_cpu.to(dev)
    on_card, on_cpu = calc.DescriptorModel.default(), calc.DescriptorModel.default()
    if on_card.params is None:
        fail("calc", "weights", f"the shipped CALC weights were not found at {calc.DEFAULT_WEIGHTS}")
    for name, card_fn, cpu_fn in (("CALC encoder (shipped weights)", on_card, on_cpu),
                                  ("HOG descriptor", calc.hog_descriptor, calc.hog_descriptor)):
        got, ref = card_fn(img), cpu_fn(img_cpu)
        err = (got.cpu() - ref).abs().max().item()
        dot = float(got.cpu() @ ref)
        ms = device_ms(lambda: card_fn(img), launches=20)
        print(f"calc: {name} on {tuple(img.shape)}: max |d| card vs CPU {err:.2e}, dot {dot:.7f}, "
              f"device time {ms:.4f} ms per call [{card}]", flush=True)
        if not (err <= CALC_MAX_ABS and dot >= CALC_MIN_DOT and got.shape == (1064,)):
            fail("calc", "card vs CPU",
                 f"{name} on the card disagrees with the CPU (max |d| {err:.2e}, dot {dot:.7f})")


# Phase train: CALC training (models/train_calc.py) on the card, at CALC's
# published widths and scripts/torch_train_calc_default.py's batch, corpus
# geometries, probe and loss settings, cut in depth (steps and places).
TRAIN_BATCH = 64
TRAIN_STEPS = 300
TRAIN_PLACES = 128                 # pairs per geometry (the full run: 1024)
TRAIN_SCENES = 8                   # scenes per geometry (the full run: 32)
TRAIN_PROBE_EVERY = 100
TRAIN_LOG_EVERY = 50
TRAIN_TIMED_STEPS = 50
TRAIN_LOSS_RTOL = 1e-4             # card vs CPU, total / contrast / hinge
TRAIN_RECON_RTOL = 1e-2            # the bfloat16 decoder's reconstruction
TRAIN_GRAD_COS = 0.9999            # encoder gradients, card vs CPU
TRAIN_DEC_GRAD_COS = 0.999         # bfloat16 decoder gradients
TRAIN_MAX_DROP = 0.8               # last logged total <= 0.8x the first
TRAIN_SEPARATION = 0.05            # mean revisit > mean different place + this
TRAIN_NPZ_DOT = 0.9999             # float16 npz round trip, per descriptor
TRAIN_LOSS_KW = dict(margin_pos=0.97)
# The JAX package's trained weights' held-out medians (README, the JAX run
# of scripts/train_calc_default.py).
JAX_RUN_MEDIANS = {"240x376": 0.978, "120x188": 0.977}


def train_script():
    """scripts/torch_train_calc_default.py: the operating point, the bars
    and the probe of the full training run."""
    path = Path(__file__).resolve().parent / "scripts" / "torch_train_calc_default.py"
    spec = importlib.util.spec_from_file_location("torch_train_calc_default", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def check_train_step(dev, tc, a, b, card: str) -> None:
    """(b) One pair_loss step from the same init (seed 0), batch and Augment
    on the card and on the CPU: the loss terms and every gradient."""
    aug = tc.draw_augment(torch.Generator().manual_seed(0), len(a))
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        enc, dec = tc.init_modules(0, d)
        total, aux = tc.pair_loss(enc, dec, a.to(d), b.to(d), aug.to(d), **TRAIN_LOSS_KW)
        total.backward()
        grads = {f"enc.{k}": p.grad.cpu() for k, p in enc.named_parameters()}
        grads.update({f"dec.{k}": p.grad.cpu() for k, p in dec.named_parameters()})
        out[name] = ([float(x.detach()) for x in (total, *aux)], grads)
    (got, g_card), (ref, g_cpu) = out["card"], out["cpu"]
    rel = [_rel(x, y) for x, y in zip(got, ref)]
    cos = {k: float(torch.nn.functional.cosine_similarity(
        g_card[k].double().reshape(1, -1), g_cpu[k].double().reshape(1, -1))) for k in g_cpu}
    enc_cos = min(v for k, v in cos.items() if k.startswith("enc."))
    dec_cos = min(v for k, v in cos.items() if k.startswith("dec."))
    print(f"train: (b) one step, batch {len(a)}, card vs CPU: total {got[0]:.6f} / {ref[0]:.6f}, "
          f"recon {got[1]:.6f} / {ref[1]:.6f}, contrast {got[2]:.6f} / {ref[2]:.6f}, hinge "
          f"{got[3]:.6f} / {ref[3]:.6f} (relative {', '.join(f'{r:.2e}' for r in rel)}); gradient "
          f"cosine min encoder {enc_cos:.7f}, decoder {dec_cos:.7f} [{card}]", flush=True)
    if not (rel[0] <= TRAIN_LOSS_RTOL + TRAIN_RECON_RTOL * abs(ref[1] / ref[0])
            and rel[1] <= TRAIN_RECON_RTOL and rel[2] <= TRAIN_LOSS_RTOL
            and rel[3] <= TRAIN_LOSS_RTOL):
        fail("train", "step card vs CPU", f"loss terms differ: card {got}, CPU {ref}")
    if not (enc_cos >= TRAIN_GRAD_COS and dec_cos >= TRAIN_DEC_GRAD_COS):
        fail("train", "gradients card vs CPU", f"gradient cosines {cos}")


def time_train_steps(dev, tc, corpA, corpB, card: str) -> dict:
    """ms a training step, pairs a second and the device busy share over
    TRAIN_TIMED_STEPS steps of the loop's own step (batch 64: 192 encoder
    views, the decoder, AdamW), after 3 warm-up steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc, dec = tc.init_modules(0, dev)
    opt = torch.optim.AdamW(list(enc.parameters()) + list(dec.parameters()), lr=1e-3,
                            weight_decay=3e-4)
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(np.stack([rng.choice(len(corpA), TRAIN_BATCH, replace=False)
                                     for _ in range(3 + 2 * TRAIN_TIMED_STEPS)])).to(dev)

    def step(i):
        a, b = corpA.index_select(0, idx[i]), corpB.index_select(0, idx[i])
        tc.pair_step(enc, dec, opt, a, b, tc.draw_augment(gen, TRAIN_BATCH), **TRAIN_LOSS_KW)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 3 + TRAIN_TIMED_STEPS):
        step(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3 + TRAIN_TIMED_STEPS, 3 + 2 * TRAIN_TIMED_STEPS):
            step(i)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    ms = wall / TRAIN_TIMED_STEPS * 1e3
    print(f"train: {TRAIN_TIMED_STEPS} steps of batch {TRAIN_BATCH} pairs: {ms:.2f} ms a step, "
          f"{TRAIN_BATCH * 1e3 / ms:.1f} pairs/s ({3 * TRAIN_BATCH * 1e3 / ms:.1f} encoder views/s); "
          f"under the profiler {wall_p * 1e3 / TRAIN_TIMED_STEPS:.2f} ms a step, device kernel time "
          f"{dev_s * 1e3 / TRAIN_TIMED_STEPS:.2f} ms a step, device busy {dev_s / wall_p:.1%}, "
          f"{sum(e.count for e in kern) / TRAIN_TIMED_STEPS:.0f} kernel launches a step; top "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / TRAIN_TIMED_STEPS:.2f} ms"
                      for e in top) + f" [{card}]", flush=True)
    return {"ms_per_step": ms, "busy": dev_s / wall_p}


def phase_train(dev, card: str) -> None:
    """CALC training on the card: (a) the shipped weights' operating point
    through the port, (b) one step card vs CPU, (c) a training run cut in
    depth, timed, (d) the npz round trip."""
    from stereoslam_tpu_torch.models import calc
    from stereoslam_tpu_torch.models import train_calc as tc

    script = train_script()
    t_part = [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        t_part.append(time.perf_counter())
        print(f"train: {name} took {t_part[-1] - t_part[-2]:.1f} s", flush=True)

    # (a) The shipped weights on tests/test_descriptor_precision.py's set
    # (seed 555, 120x188) against its bars, and on the held-out set of
    # evaluate_operating_point (seed 999) at both geometries.
    shipped = calc.DescriptorModel.default()
    if shipped.params is None:
        fail("train", "weights", f"the shipped CALC weights were not found at {calc.DEFAULT_WEIGHTS}")
    A_ci, B_ci = tc.render_corpus_pairs(n_places=48, n_scenes=4, h=120, w=188, fx=160.0, seed=555,
                                        device=dev)
    op = script.similarity_stats(script.encode(shipped, A_ci), script.encode(shipped, B_ci))
    print(f"train: (a) shipped weights on the card, seed 555 at 120x188 ({op['n_pairs']} pairs): "
          f"revisit median {op['pos_median']:.4f}, >= 0.94 {op['pos_ge_high']:.3f}; different "
          f"place median {op['neg_median']:.4f}, >= 0.92 {op['neg_ge_low']:.4f}; anchors with <= 3 "
          f"suspects {op['suspects_le3']:.3f} [{card}]", flush=True)
    missed = script.bars_missed(op)
    if missed:
        fail("train", "shipped operating point",
             f"tests/test_descriptor_precision.py's bars missed on the card: {missed}")
    for hw, (h, w, fx) in (("240x376", (240, 376, 320.0)), ("120x188", (120, 188, 160.0))):
        op = script.evaluate_operating_point(shipped, seed=999, h=h, w=w, fx=fx, device=dev)
        print(f"train: (a) shipped weights, held-out seed 999 at {hw} ({op['n_pairs']} pairs): "
              f"revisit median {op['pos_median']:.4f} (the JAX run: {JAX_RUN_MEDIANS[hw]}), p10 "
              f"{op['pos_p10']:.4f}, >= 0.94 {op['pos_ge_high']:.3f}; different place median "
              f"{op['neg_median']:.4f}, p99 {op['neg_p99']:.4f}, >= 0.92 {op['neg_ge_low']:.4f}",
              flush=True)
    part("(a)")

    # The cut corpus: scripts/torch_train_calc_default.py's two geometries.
    A_hi, B_hi = tc.render_corpus_pairs(n_places=TRAIN_PLACES, n_scenes=TRAIN_SCENES, seed=0,
                                        h=240, w=376, fx=320.0, device=dev)
    A_lo, B_lo = tc.render_corpus_pairs(n_places=TRAIN_PLACES, n_scenes=TRAIN_SCENES, seed=1,
                                        h=120, w=188, fx=160.0, device=dev)
    corpA = tc.preprocess_corpus([A_hi, A_lo], dev)
    corpB = tc.preprocess_corpus([B_hi, B_lo], dev)
    part(f"rendering 2 x {TRAIN_PLACES} pairs")

    # (b) One step, card vs CPU, on a batch of the corpus.
    sel = torch.from_numpy(np.random.default_rng(0).choice(len(corpA), TRAIN_BATCH,
                                                           replace=False)).to(dev)
    check_train_step(dev, tc, corpA.index_select(0, sel).cpu(), corpB.index_select(0, sel).cpu(),
                     card)
    part("(b)")

    # (c) The training run, cut in depth.
    scores = []
    probe_fn = script.make_probe(dev, scores)
    enc0, _ = tc.init_modules(0, dev)
    with torch.no_grad():
        score0 = probe_fn(enc0)
    scores.clear()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = tc.train_encoder_pairs(
        [A_hi, A_lo], [B_hi, B_lo], steps=TRAIN_STEPS, batch=TRAIN_BATCH, seed=0,
        weight_decay=3e-4, log_every=TRAIN_LOG_EVERY, probe_fn=probe_fn,
        probe_every=TRAIN_PROBE_EVERY, device=dev, **TRAIN_LOSS_KW)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    lk_launches = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters()}
    model = calc.DescriptorModel(params)
    za, zb = script.encode(model, A_ci), script.encode(model, B_ci)
    norms = torch.linalg.norm(za, dim=1)
    op = script.similarity_stats(za, zb)
    h = np.asarray(hist)
    print(f"train: (c) train_encoder_pairs on 2 x {TRAIN_PLACES} card-rendered pairs, batch "
          f"{TRAIN_BATCH}, {TRAIN_STEPS} steps in {train_s:.1f} s (probes included); total "
          f"{h[0, 0]:.4f} -> {h[-1, 0]:.4f} (recon {h[0, 1]:.4f} -> {h[-1, 1]:.4f}, contrast "
          f"{h[0, 2]:.4f} -> {h[-1, 2]:.4f}, hinge {h[0, 3]:.4f} -> {h[-1, 3]:.4f}); probe "
          f"{', '.join(f'{s:.4f}' for s in scores)} against the untrained {score0:.4f}; held-out "
          f"seed 555: revisit mean {op['pos_mean']:.4f}, median {op['pos_median']:.4f}, different "
          f"place mean {op['neg_mean']:.4f}; kernel launches on this path {lk_launches} [{card}]",
          flush=True)
    if not np.isfinite(h).all():
        fail("train", "finite", f"a logged loss is not finite: {hist}")
    if not h[-1, 0] <= TRAIN_MAX_DROP * h[0, 0]:
        fail("train", "loss", f"last logged total {h[-1, 0]:.4f} above {TRAIN_MAX_DROP}x the first "
             f"{h[0, 0]:.4f}")
    if not (scores and max(scores) > score0):
        fail("train", "probe", f"best probe {max(scores, default=float('nan')):.4f} not above the "
             f"untrained encoder's {score0:.4f}")
    if not float((norms - 1).abs().max()) <= 1e-3:
        fail("train", "unit norm", f"descriptor norms {float(norms.min())}..{float(norms.max())}")
    if not op["pos_mean"] > op["neg_mean"] + TRAIN_SEPARATION:
        fail("train", "separation", f"held-out revisit mean {op['pos_mean']:.4f} not above the "
             f"different-place mean {op['neg_mean']:.4f} + {TRAIN_SEPARATION}")
    part("(c)")
    time_train_steps(dev, tc, corpA, corpB, card)
    part("(c), the timed steps")

    # (d) The float16 npz both packages load, back into a DescriptorModel.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        path = os.path.join(d, "calc_weights.npz")
        calc.save_params_npz(path, params)
        loaded = calc.DescriptorModel(calc.load_params_npz(path))
        zl = script.encode(loaded, A_ci)
    dot = float((zl * za).sum(1).min())
    print(f"train: (d) npz round trip: min descriptor dot {dot:.6f} against the in-memory encoder "
          f"on {len(za)} images", flush=True)
    if not dot >= TRAIN_NPZ_DOT:
        fail("train", "npz round trip", f"min dot {dot:.6f} < {TRAIN_NPZ_DOT}")


def phase_loop(dev, card: str) -> None:
    """Loop closing on the card over the closed KITTI-geometry circuit."""
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.models.calc import DescriptorModel
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    t0 = time.perf_counter()
    seq = loop_sequence()
    print(f"loop: data {len(seq.left)} frames 376x1241 ({LOOP_CIRCUIT}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = loop_config(seq)
    slam = StereoSlam(cfg, device=dev, enable_loop=True, descriptor_model=DescriptorModel())
    closer = slam._loop_closer
    closer.stage_times = True
    state_mb = sum(t.numel() * t.element_size() for t in slam.loop) / 1e6
    print(f"loop: LoopState {state_mb:.1f} MB on {slam.loop.orb_desc.device} (orb_desc "
          f"{tuple(slam.loop.orb_desc.shape)} {slam.loop.orb_desc.dtype}), map "
          f"{cfg.map.max_keyframes} KF rows x {cfg.map.max_landmarks} landmark rows", flush=True)
    n = len(seq.left)
    L.lk_pyramid.launches = 0
    K.lk_level.launches = 0
    K.lk_final_error.launches = 0
    t_start = time.perf_counter()
    for t in range(n):
        if not slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]):
            fail("loop", "LOST", f"tracking LOST at frame {t}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = L.lk_pyramid.launches
    edges = slam.loop_edges
    n_kf = int(slam.map.n_kf)
    ids, T = slam.frame_trajectory()
    gt = np.linalg.inv(seq.T_cw.astype(np.float64))
    ate = ate_rmse(np.linalg.inv(T.astype(np.float64)), gt[ids], align=False)
    fid = slam.map.kf_frame_id[:n_kf].cpu().numpy()
    gaps = [(c, lp, c - lp, float(np.linalg.norm(gt[fid[c]][:3, 3] - gt[fid[lp]][:3, 3])))
            for c, lp in edges]
    times = closer.times

    def med_ms(key):
        v = times.get(key, [])
        return f"{np.median(v) * 1e3:.2f} ms (n={len(v)})" if v else "none"

    print(f"loop: {n} frames in {wall:.1f} s, {n / wall:.2f} FPS (stage timing syncs the card "
          f"after each loop stage) [{card}]", flush=True)
    gated, fired = rescue_launches(cfg, n - 1), slam.rescues["retry"] + slam.rescues["deep"]
    print(f"loop: n_kf {n_kf}, loop edges (cur, loop, id gap, ground-truth m) {gaps}, frame ATE "
          f"{ate:.4f} m (align=False), lk_pyramid launches {launches} "
          f"({launches / (n - 1):.2f}/tracked frame; {gated} gated rescue launches, {fired} on, "
          f"{gated - fired} off), per-level launches "
          f"{K.lk_level.launches + K.lk_final_error.launches}", flush=True)
    print(f"loop: median host wall time per keyframe stage: process_keyframe "
          f"{med_ms('process_keyframe')}, detect {med_ms('detect')}, verify {med_ms('verify')}, "
          f"correct {med_ms('correct')}; PGO GN iterations {times.get('pgo_gn', [])}, CG "
          f"iterations {times.get('pgo_cg', [])} [{card}]", flush=True)
    if not edges:
        fail("loop", "edges", "no loop edge")
    for c, lp, gap, dist in gaps:
        if gap < cfg.loop.id_gap or dist >= MAX_LOOP_GT_M:
            fail("loop", "edges", f"edge {c}->{lp} has id gap {gap} or ground-truth distance "
                 f"{dist:.2f} m")
    if not ate <= MAX_LOOP_ATE_M:
        fail("loop", "ATE", f"frame ATE {ate:.4f} m exceeds {MAX_LOOP_ATE_M} m")
    if launches < n - 1:
        fail("loop", "launches", f"the main path bypassed the LK kernel ({launches} launches)")
    check_correction(slam, edges[-1], card)
    run = (n_kf, len(edges), round(ate, 4))
    if run != EXPECTED_LOOP_RUN:
        fail("loop", "repeat", f"(KFs, edges, ATE) = {run}, expected {EXPECTED_LOOP_RUN}: the run "
             f"repeats bit for bit, so the code's arithmetic changed")


def check_correction(slam, edge, card: str) -> None:
    """The correction stage (landmark merge and pose-graph optimization over
    the full 1536-row keyframe table) on the run's final state at its last
    loop edge, on the card and on a CPU copy of the same inputs.  The run's
    own verified loops were close enough not to need one, so the stage is
    applied here whether or not the pose error asks for it."""
    from stereoslam_tpu_torch.core.loopclosing import LoopCloser
    from stereoslam_tpu_torch.core.state import LoopState, MapState

    closer = slam._loop_closer
    kf, loop_kf = edge
    verify, packed, m_v = closer._verify_impl(slam.map, slam.loop, kf, loop_kf)
    T, pairs = verify.T_corrected, verify.match_loop_feat
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_card, _, remap_card, c_card = closer._correct_impl(m_v, slam.loop, kf, loop_kf, T, pairs)
    c_card = c_card.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    cpu_closer = LoopCloser(slam.cfg, closer.intr, "cpu", descriptor_model=closer.model)
    m_cpu, _, remap_cpu, c_cpu = cpu_closer._correct_impl(
        MapState(*(t.cpu() for t in m_v)), LoopState(*(t.cpu() for t in slam.loop)), kf, loop_kf,
        T.cpu(), pairs.cpu())
    d_pose = (m_card.kf_T_cw.cpu() - m_cpu.kf_T_cw).abs().max().item()
    d_pos = (m_card.lm_pos.cpu() - m_cpu.lm_pos)[m_cpu.lm_valid].abs().max().item()
    same_merge = torch.equal(remap_card.cpu(), remap_cpu) and torch.equal(
        m_card.kf_feat_lm.cpu(), m_cpu.kf_feat_lm)
    print(f"loop: correction at edge {kf}->{loop_kf} on the final state ({int(pairs.ge(0).sum())} "
          f"merged pairs, verify pose error {float(packed[2]):.3f} m): applied {bool(c_card[0])}, "
          f"mean edge residual {c_card[1]:.2e} (bound {c_card[2]:.2e}), {ms:.1f} ms host wall "
          f"time, PGO GN/CG iterations {closer.times['pgo_gn'][-1]}/{closer.times['pgo_cg'][-1]} "
          f"(CPU: {cpu_closer.times['pgo_gn'][-1]}/{cpu_closer.times['pgo_cg'][-1]}); card vs "
          f"CPU max |d pose| {d_pose:.2e}, max |d landmark| {d_pos:.2e} m, merge "
          f"{'identical' if same_merge else 'DIFFERS'} [{card}]", flush=True)
    if not (bool(c_card[0]) == bool(c_cpu[0]) and same_merge and d_pose <= 2e-3 and d_pos <= 2e-2):
        fail("loop", "correction card vs CPU", "the correction on the card disagrees with the CPU")


def check_world_lk(cfg, seq, dev) -> float:
    """lk_pyramid at the world path's shapes: the FAST corners of frame 0
    tracked into frame 1 and matched into the right image with the world
    configuration's LK settings and pyramid depths (240x376 down to 60x94,
    and the deeper stereo and rescue pyramids), plus the border case."""
    from stereoslam_tpu_torch.core.frontend import _max_pyramid_depth
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops.fast import detect_keypoints

    t = cfg.tracking
    a, b, right = (x.to(dev, torch.uint8).float() for x in (seq.left[0], seq.left[1], seq.right[0]))
    kps = detect_keypoints(a, cfg.features.max_features)
    pts = kps.xy[kps.valid].contiguous()
    if pts.shape[0] < cfg.features.num_features_init_good:
        fail("world", "corners", f"{pts.shape[0]} FAST corners on frame 0, fewer than the "
             f"{cfg.features.num_features_init_good} that initialization needs")
    max_depth = _max_pyramid_depth(*a.shape, t.lk_window)
    n_stereo = min(t.lk_stereo_levels or t.lk_levels, max_depth)
    n_deep = min(t.lk_levels + t.lk_rescue_extra_levels, max_depth)
    cases, _, _ = pyramid_cases(t, a, b, right, pts, n_stereo, n_deep)
    return max(check_pyramid_case(L, *case, phase="world") for case in cases)


def check_render(seq, card: str) -> None:
    """Frames of the canonical sequence rendered on the card against the same
    frames rendered on the CPU, left and right."""
    from stereoslam_tpu_torch.utils import world as W

    scene = W.make_city_circuit(WORLD_LENGTH, WORLD_WIDTH, seed=WORLD_SEED)
    T_wc = W.circuit_poses(WORLD_FRAMES, WORLD_STEP, WORLD_LENGTH, WORLD_WIDTH, 14.0)
    ts = np.array(WORLD_CHECK_FRAMES)
    h, w = seq.left.shape[1:]
    for cam, card_imgs, off, parity in (("left", seq.left, 0.0, 0),
                                        ("right", seq.right, seq.baseline, 1)):
        keys = W.prng_keys(WORLD_SEED * 1000003 + 2 * ts + parity)
        cpu = W.render_frames(torch.as_tensor(T_wc[ts], dtype=torch.float32), scene.quads, seq.fx,
                              seq.fy, seq.cx, seq.cy, h, w, cam_offset_x=off, noise_keys=keys)
        got = card_imgs[list(WORLD_CHECK_FRAMES)].cpu()
        d = (got - cpu).abs()
        med, near = d.median().item(), (d <= RENDER_NEAR).float().mean().item()
        u8 = (got.to(torch.uint8) == cpu.to(torch.uint8)).float().mean().item()
        print(f"world: render {cam} frames {WORLD_CHECK_FRAMES}, card vs CPU: median |d| "
              f"{med:.2e}, {near:.5f} within {RENDER_NEAR}, uint8 equal {u8:.5f}, max |d| "
              f"{d.max().item():.2e} [{card}]", flush=True)
        if not (med <= RENDER_MEDIAN and near >= RENDER_NEAR_SHARE and u8 >= RENDER_U8_SHARE):
            fail("world", "render card vs CPU",
                 f"the {cam} render on the card disagrees with the CPU")


def check_feed(seq, dev) -> None:
    """DeviceFeed from host frames delivers every frame bit for bit."""
    from stereoslam_tpu_torch.utils.feed import DeviceFeed

    n = min(50, len(seq.left))
    left = seq.left[:n].cpu().numpy()
    right = seq.right[:n].cpu().numpy()
    want = torch.stack([seq.left[:n], seq.right[:n]], 1).to(torch.uint8)
    got = [(lr.clone(), ts) for lr, ts in
           DeviceFeed(((left[t], right[t], seq.timestamps[t]) for t in range(n)), depth=3,
                      device=dev)]
    torch.cuda.synchronize()
    same = len(got) == n and all(torch.equal(lr, want[t]) and ts == float(seq.timestamps[t])
                                 for t, (lr, ts) in enumerate(got))
    print(f"world: DeviceFeed at depth 3 delivered {len(got)} of {n} host frames, "
          f"{'bit for bit' if same else 'WITH DIFFERENCES'}", flush=True)
    if not same:
        fail("world", "DeviceFeed", "the feed did not deliver every frame bit for bit")


def check_checkpoint(slam, card: str) -> None:
    """The final loop-ON state through a checkpoint into a fresh StereoSlam."""
    from stereoslam_tpu_torch.core.system import StereoSlam

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "world.npz")
        t0 = time.perf_counter()
        slam.save_checkpoint(path)
        t_save = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        fresh = StereoSlam(slam.cfg, device=slam.device)
        t0 = time.perf_counter()
        fresh.load_checkpoint(path)
        t_load = time.perf_counter() - t0
    a, b = slam, fresh
    status = torch.tensor(a.status, dtype=torch.int32, device=a.device)
    pairs = [(f"frontend.{k}", v, getattr(b.fs, k)) for k, v in
             a.fs._replace(status=status)._asdict().items() if k != "tracks"]
    pairs += [(f"frontend.tracks.{k}", v, getattr(b.fs.tracks, k))
              for k, v in a.fs.tracks._asdict().items()]
    pairs += [(f"map.{k}", v, getattr(b.map, k)) for k, v in a.map._asdict().items()]
    pairs += [(f"loop.{k}", v, getattr(b.loop, k)) for k, v in a.loop._asdict().items()]
    pairs += [(f"pyr.{i}", x, y) for i, (x, y) in enumerate(zip(a._pyr_prev, b._pyr_prev))]
    differ = [k for k, x, y in pairs if x.dtype != y.dtype or not torch.equal(x, y)]
    ka, kb = a.keyframe_trajectory(), b.keyframe_trajectory()
    same_traj = all(np.array_equal(x, y) for x, y in zip(ka, kb))
    same_edges = a.loop_edges == b.loop_edges
    print(f"world: checkpoint of the final loop-ON state: {len(pairs)} fields, {size_mb:.1f} MB, "
          f"saved in {t_save:.1f} s, loaded in {t_load:.1f} s; fields that differ {differ}; "
          f"keyframe trajectory {'equal' if same_traj else 'DIFFERS'}, loop edges "
          f"{'equal' if same_edges else 'DIFFER'} [{card}]", flush=True)
    if differ or not same_traj or not same_edges or len(a._pyr_prev) != len(b._pyr_prev):
        fail("world", "checkpoint round trip", "the loaded state differs from the saved one")


REFUSAL = re.compile(r"loop candidate KF (\d+) -> (\d+) not verified: (\d+) pairs, (\d+) pose "
                     r"inliers, pose_err ([\d.]+) m \(odo ([\d.]+) m\)")


def summarize_refusals(lines, loop_cfg, card: str, prefix: str = "world") -> None:
    """The loop-ON run's refused verifications (core/loopclosing.py logs
    each: pairs, pose inliers, pose error, odometry since the loop KF), held
    to the verification's guards: pairs >= min_matches, pose inliers >=
    min_inliers (and a PnP solution, which the line does not show), inliers
    >= min_inlier_ratio x pairs, pose error <= min(max_correction_frac x
    odometry, max_correction_cap) + max_correction_abs.  Prints how many each
    guard refused (a candidate can fail several) and how many it alone
    refused; the logged numbers are rounded (2 decimals for the error, 1 for
    the odometry)."""
    c = loop_cfg
    rows = [tuple(float(v) for v in m.groups()) for m in map(REFUSAL.search, lines) if m]
    guards = {
        f"pairs < min_matches {c.min_matches}": lambda p, i, e, o: p < c.min_matches,
        f"pose inliers < min_inliers {c.min_inliers} (or no PnP pose)":
            lambda p, i, e, o: i < c.min_inliers,
        f"pose inliers < {c.min_inlier_ratio} x pairs":
            lambda p, i, e, o: i < c.min_inlier_ratio * max(p, 1),
        f"pose_err > min({c.max_correction_frac} x odo, {c.max_correction_cap} m) + "
        f"{c.max_correction_abs} m":
            lambda p, i, e, o: e > min(c.max_correction_frac * o, c.max_correction_cap)
            + c.max_correction_abs,
    }
    hits = {name: [g(*r[2:]) for r in rows] for name, g in guards.items()}
    alone = {name: sum(h and sum(hits[k][j] for k in hits) == 1 for j, h in enumerate(v))
             for name, v in hits.items()}
    unexplained = sum(not any(hits[k][j] for k in hits) for j in range(len(rows)))
    print(f"{prefix}: {len(rows)} refused verifications in the loop-ON run; by guard (refused, "
          f"refused by it alone): " + "; ".join(f"{k}: {sum(v)}, {alone[k]}" for k, v in
                                                  hits.items())
          + f"; by no guard the line shows (PnP failed): {unexplained} [{card}]", flush=True)
    for r in rows:
        kf, lp, pairs, inl, err, odo = r
        allowed = min(c.max_correction_frac * odo, c.max_correction_cap) + c.max_correction_abs
        print(f"{prefix}: refused KF {int(kf)} -> {int(lp)}: {int(pairs)} pairs, {int(inl)} pose "
              f"inliers, pose_err {err:.2f} m against {allowed:.2f} m allowed (odo {odo:.1f} m)",
              flush=True)


def phase_world(dev, card: str):
    """The canonical world circuit: render on the card, run_world_eval with the
    trained CALC descriptor at the shipped thresholds, checkpoint round trip."""
    from stereoslam_tpu_torch import eval as E
    from stereoslam_tpu_torch.core.state import LOST
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.utils import world as W

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = W.generate_world_sequence(n_frames=WORLD_FRAMES, h=E.WORLD_H, w=E.WORLD_W, fx=320.0,
                                    seed=WORLD_SEED, step=WORLD_STEP, length=WORLD_LENGTH,
                                    width=WORLD_WIDTH, device=dev)
    torch.cuda.synchronize()
    print(f"world: rendered {WORLD_FRAMES} stereo frames {E.WORLD_H}x{E.WORLD_W} on the card in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if not (seq.left.shape == (WORLD_FRAMES, E.WORLD_H, E.WORLD_W)
            and bool(torch.isfinite(seq.left).all()) and bool(torch.isfinite(seq.right).all())):
        fail("world", "render", f"rendered frames have shape {tuple(seq.left.shape)} or are "
             "not finite")
    check_render(seq, card)
    check_feed(seq, dev)

    slams = []

    def keep(slam):
        if slam.enable_loop:
            slam._loop_closer.stage_times = True
        slams.append(slam)

    L.lk_pyramid.launches = 0
    K.lk_level.launches = 0
    K.lk_final_error.launches = 0
    loop_log = logging.getLogger("stereoslam_tpu_torch.core.loopclosing")
    log_lines = LogLines()
    loop_log.addHandler(log_lines)
    loop_log.setLevel(logging.INFO)
    try:
        rec = E.run_world_eval(n_frames=WORLD_FRAMES, seq=seq, device=dev, on_slam=keep)
    finally:
        loop_log.removeHandler(log_lines)
        loop_log.setLevel(logging.NOTSET)
    launches = L.lk_pyramid.launches
    per_level = K.lk_level.launches + K.lk_final_error.launches
    slam, slam_vo = slams
    closer = slam._loop_closer
    times = closer.times

    def med_ms(key):
        v = times.get(key, [])
        return f"{np.median(v) * 1e3:.2f} ms (n={len(v)})" if v else "none"

    edges = [(c, lp, c - lp, d) for (c, lp), d in zip(rec["loop_edges"], rec["edge_gt_dist_m"])]
    print(f"world: record {json.dumps(rec)}", flush=True)
    gated = rescue_launches(slam.cfg, WORLD_FRAMES - 1) * 2
    fired = sum(x.rescues["retry"] + x.rescues["deep"] for x in slams)
    print(f"world: lk_pyramid rescue launches over both runs: {gated} gated, {fired} on, "
          f"{gated - fired} off", flush=True)
    print(f"world: {rec['frames']} frames, {rec['fps']} FPS and p50 frame "
          f"{rec['latency_ms_p50']} ms after {E.EVAL_WARMUP} warm-up frames (stage timing syncs the card after each loop "
          f"stage); ATE loop ON {rec['ate_m']} m, loop OFF {rec['ate_vo_m']} m; loop edges (cur, "
          f"loop, id gap, ground-truth m) {edges}; {rec['n_kf']} KFs, kf_rate {rec['kf_rate']}; "
          f"lk_pyramid launches {launches} over both runs, per-level launches {per_level} "
          f"[{card}]", flush=True)
    print(f"world: median host wall time per keyframe stage: process_keyframe "
          f"{med_ms('process_keyframe')}, detect {med_ms('detect')}, verify {med_ms('verify')}, "
          f"correct {med_ms('correct')}; PGO GN iterations {times.get('pgo_gn', [])}, CG "
          f"iterations {times.get('pgo_cg', [])} [{card}]", flush=True)

    summarize_refusals(log_lines.lines, slam.cfg.loop, card)
    if closer.model.params is None:
        fail("world", "descriptor", "the trained CALC weights were not found: the run used HOG")
    if rec["frames"] != WORLD_FRAMES or rec["lost_at"] is not None:
        fail("world", "LOST", f"loop ON: {rec['frames']} frames, lost at {rec['lost_at']}")
    if slam_vo.status == LOST or rec["ate_vo_m"] is None:
        fail("world", "LOST", "loop OFF: tracking was lost")
    for c, lp, gap, dist in edges:
        if gap < slam.cfg.loop.id_gap or not dist < WORLD_MAX_EDGE_GT_M:
            fail("world", "edges", f"edge {c}->{lp} has id gap {gap} or ground-truth distance "
                 f"{dist} m")
    if not (rec["ate_m"] <= WORLD_MAX_ATE_M and rec["ate_m"] <= rec["ate_vo_m"]):
        fail("world", "ATE", f"ATE loop ON {rec['ate_m']} m against the bound {WORLD_MAX_ATE_M} m "
             f"and loop OFF {rec['ate_vo_m']} m")
    if not abs(rec["kf_rate"] - WORLD_KF_RATE) < WORLD_KF_RATE_TOL:
        fail("world", "kf_rate", f"kf_rate {rec['kf_rate']} is not within {WORLD_KF_RATE_TOL} of "
             f"{WORLD_KF_RATE}")
    tracked = 2 * (WORLD_FRAMES - 1)
    if launches < tracked or per_level:
        fail("world", "launches", f"{launches} lk_pyramid launches for {tracked} tracked frames, "
             f"{per_level} per-level launches")
    worst = check_world_lk(slam.cfg, seq, dev)
    check_checkpoint(slam, card)
    run = (rec["n_kf"], len(edges), rec["ate_m"])
    if run != EXPECTED_WORLD_RUN:
        fail("world", "repeat", f"(KFs, edges, ATE) = {run}, expected {EXPECTED_WORLD_RUN}: the "
             f"run repeats bit for bit, so the code's arithmetic changed")
    return worst


# ---------------------------------------------------------------------------
# Phase undistort: bench.py's undistortion-ON configuration
# ---------------------------------------------------------------------------

# bench.py:125-140: KITTI-raw-magnitude radial distortion (about 25 px at the
# image edge) on both cameras, p1 = p2 = 0, on phase main's frames.
UNDIST_K1, UNDIST_K2 = -0.28, 0.07
UNDIST_REMAP_TOL = 1e-3            # gray levels, the card's remap against the plain CPU remap
UNDIST_CHECK_FRAMES = (13, 14, 15)  # replays held to the eager track_frame
# The JAX package on a CPU over the same 100 frames (scripts/jax_undistort_run.py):
# no LOST, 15 keyframes, 881 landmarks, frame ATE 0.6291 m (undistortion OFF:
# 15, 877, 0.0905 m; the synthetic frames carry no distortion, so the remap
# bends straight edges).  With 15 keyframes either way, the band is phase
# main's.
UNDIST_JAX_KF = 15
UNDIST_KF_BAND = KF_BAND
# The run as the port produces it on the card, bit for bit in every call:
# (keyframes, landmarks, frame ATE in m).
EXPECTED_UNDIST_RUN = (15, 853, 0.5633)


def undistort_config(seq):
    cfg = kitti_config(seq)
    return cfg.replace(camera=dataclasses.replace(
        cfg.camera, need_undistortion=True, k1=UNDIST_K1, k2=UNDIST_K2, k1_right=UNDIST_K1,
        k2_right=UNDIST_K2))


def timed_run(slam, seq, phase: str):
    """``process_frame`` over the sequence, the card synchronized after each
    frame: (FPS after WARMUP frames, p50 frame ms after them)."""
    times, t_warm = [], None
    for t in range(len(seq.left)):
        t0 = time.perf_counter()
        ok = slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not ok:
            fail(phase, "LOST", f"tracking LOST at frame {t}")
        if t == WARMUP - 1:
            t_warm = time.perf_counter()
    fps = (len(seq.left) - WARMUP) / (time.perf_counter() - t_warm)
    return fps, float(np.median(times[WARMUP:])) * 1e3


def frame_ate(slam, seq) -> float:
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    ids, T = slam.frame_trajectory()
    gt = np.linalg.inv(seq.T_cw[ids].astype(np.float64))
    return float(ate_rmse(np.linalg.inv(T.astype(np.float64)), gt, align=False))


def replay_equals_eager(graph) -> bool:
    """The last replay's outputs against the eager frame on the same static
    inputs (launches made for the comparison do not count)."""
    from stereoslam_tpu_torch.core.graphs import _flat

    with KeepCounters():
        eager = graph._fn(*graph._inputs)
        torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(_flat(eager), _flat(graph._outputs)))


def phase_undistort(dev, seq, card: str):
    """Undistortion ON on phase main's frames: the remap on the card against
    the CPU's, a timed run against phase main's configuration back to back,
    launches and replays, the band and the pin, then a checking run (host
    reads, replay against eager, the repeat)."""
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.ops.camera import undistort_image, undistortion_map

    cfg = undistort_config(seq)
    n, h, w = len(seq.left), cfg.image_height, cfg.image_width
    tracked = n - 1

    # The remapped pair on the card against the plain remap on the CPU.
    slam = StereoSlam(cfg, device=dev, enable_loop=False)
    lr = torch.from_numpy(np.stack([seq.left[0], seq.right[0]]).astype(np.uint8))
    lr_dev = lr.to(dev)
    c = cfg.camera
    worst, shift = 0.0, 0.0
    for i, (pre, intr, dist) in enumerate(((slam._pre_left, slam.intr_left, (c.k1, c.k2, c.p1, c.p2)),
                                           (slam._pre_right, slam.intr_right,
                                            (c.k1_right, c.k2_right, c.p1_right, c.p2_right)))):
        src = undistortion_map(h, w, intr, torch.tensor(dist))
        ref = undistort_image(lr[i].to(torch.float32), src)
        worst = max(worst, (pre(lr_dev[i]).cpu() - ref).abs().max().item())
        grid = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(h), indexing="xy"), -1)
        shift = max(shift, (src - grid).norm(dim=-1).max().item())
    t_remap = device_ms(lambda: slam._pre_left(lr_dev[0]), launches=50)
    t_widen = device_ms(lambda: lr_dev[0].to(torch.float32), launches=50)
    print(f"undistort: {h}x{w}, k1 {UNDIST_K1}, k2 {UNDIST_K2} on both cameras (largest source "
          f"shift {shift:.1f} px): remapped pair on the card against the plain CPU remap max |d| "
          f"{worst:.2e} gray levels; device time per image: widen + remap {t_remap * 1e3:.2f} us, "
          f"widen alone {t_widen * 1e3:.2f} us [{card}]", flush=True)
    if not worst <= UNDIST_REMAP_TOL:
        fail("undistort", "remap card vs CPU", f"max |d| {worst:.2e} > {UNDIST_REMAP_TOL}")

    # The timed run, then phase main's configuration on the same frames.
    reset_counters()
    fps, p50 = timed_run(slam, seq, "undistort")
    launches = {"lk_pyramid": L.lk_pyramid.launches,
                "per_level": K.lk_level.launches + K.lk_final_error.launches}
    with KeepCounters():
        fps_off, p50_off = timed_run(StereoSlam(kitti_config(seq), device=dev, enable_loop=False),
                                     seq, "undistort")
    n_kf, n_lm, ate = int(slam.map.n_kf), int(slam.map.n_lm), frame_ate(slam, seq)
    print(f"undistort: {n} frames: {fps:.2f} FPS, p50 {p50:.2f} ms with undistortion; phase main's "
          f"configuration right after, same process: {fps_off:.2f} FPS, p50 {p50_off:.2f} ms "
          f"(after {WARMUP} warm-up frames) [{card}]", flush=True)
    print(f"undistort: n_kf {n_kf}, n_lm {n_lm}, frame ATE {ate:.4f} m (align=False; the JAX "
          f"package on a CPU: {UNDIST_JAX_KF} KFs, band {UNDIST_KF_BAND}); lk_pyramid launches "
          f"{launches['lk_pyramid']} ({launches['lk_pyramid'] / tracked:.2f}/tracked frame), "
          f"per-level {launches['per_level']}; {slam.track_graph.replays} graph replays", flush=True)
    if slam.track_graph.replays != tracked:
        fail("undistort", "graph", f"{slam.track_graph.replays} replays for {tracked} tracked frames")
    if launches["lk_pyramid"] < tracked or launches["per_level"]:
        fail("undistort", "launches", f"{launches} for {tracked} tracked frames")
    if not UNDIST_KF_BAND[0] <= n_kf <= UNDIST_KF_BAND[1]:
        fail("undistort", "keyframes", f"{n_kf} keyframes outside {UNDIST_KF_BAND}")
    run = (n_kf, n_lm, round(ate, 4))
    if run != EXPECTED_UNDIST_RUN:
        fail("undistort", "repeat", f"(KFs, landmarks, ATE) = {run}, expected "
             f"{EXPECTED_UNDIST_RUN}: the run repeats bit for bit, so the code's arithmetic changed")

    # The checking run: frames staged in advance, host reads per frame,
    # replays against the eager frame, the same run again.
    staged = [torch.from_numpy(np.stack([seq.left[t], seq.right[t]]).astype(np.uint8)).to(dev)
              for t in range(n)]
    chk = StereoSlam(cfg, device=dev, enable_loop=False)
    plain, differ = [], []
    with KeepCounters():
        for t in range(n):
            before = (int(chk.map.n_kf), int(chk.map.n_lm))
            reads = chk.outcome_reads
            torch.cuda.synchronize()
            with SyncCount() as sc:
                chk.process_staged(staged[t], seq.timestamps[t])
            kind = frame_kind(before, (int(chk.map.n_kf), int(chk.map.n_lm)))
            if t >= 2 and kind == "plain":
                plain.append((sc.n, chk.outcome_reads - reads))
            if t in UNDIST_CHECK_FRAMES and not replay_equals_eager(chk.track_graph):
                differ.append(t)
    same = all(np.array_equal(a, b) for a, b in zip(chk.frame_trajectory(), slam.frame_trajectory()))
    arr = np.asarray(plain)
    print(f"undistort: checking run: replay against the eager track_frame at frames "
          f"{UNDIST_CHECK_FRAMES}: {'bit-identical' if not differ else f'DIFFER at {differ}'}; "
          f"{len(plain)} keyframe-free frames: other syncs max {arr[:, 0].max()}, outcome reads "
          f"{sorted(set(arr[:, 1].tolist()))}; frame trajectory "
          f"{'bit-identical to' if same else 'DIFFERS from'} the timed run's", flush=True)
    if differ:
        fail("undistort", "replay vs eager", f"replay differs from the eager frame at {differ}")
    if len(plain) == 0 or not (arr[:, 0] == 0).all() or not (arr[:, 1] == 1).all():
        fail("undistort", "syncs", f"a keyframe-free frame made other than one host read: {plain}")
    if not same:
        fail("undistort", "repeat", "the checking run's trajectory differs from the timed run's")
    return launches["lk_pyramid"]


# ---------------------------------------------------------------------------
# Phase caffe: the reference's CALC model files through the importer
# ---------------------------------------------------------------------------

CAFFE_SEED = 9
CAFFE_FRAMES = 40


def caffe_net_writer():
    """tests/_caffe_net.py: the protobuf writer and the CALC-shaped net."""
    path = Path(__file__).resolve().parent / "tests" / "_caffe_net.py"
    spec = importlib.util.spec_from_file_location("_caffe_net", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_caffe(dev, seq, card: str):
    """A CALC-shaped Caffe net (deploy.prototxt + calc.caffemodel written
    from a seed): the runner on the card against the CPU, then StereoSlam
    with the files in its config over phase main's first frames, loop
    closing on, and every stored keyframe descriptor against the runner."""
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.models.calc import preprocess
    from stereoslam_tpu_torch.models.import_caffe import CaffeNetRunner
    from stereoslam_tpu_torch.ops import lk as L

    with tempfile.TemporaryDirectory(prefix="chip_smoke_caffe_") as work:
        proto, model = caffe_net_writer().write_calc_shaped(work, seed=CAFFE_SEED)
        on_cpu = CaffeNetRunner.from_files(proto, model)
        on_card = CaffeNetRunner.from_files(proto, model).to(dev)
        cfg = kitti_config(seq)
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, caffe_prototxt=proto,
                                                   caffe_weights=model))
        slam = StereoSlam(cfg, device=dev)
    layers = [f"{l.type}" for l in on_cpu.net.layers]
    img = preprocess(torch.from_numpy(seq.left[0].astype(np.uint8)).to(torch.float32))
    img_dev = img.to(dev)
    got, ref = on_card.descriptor(img_dev).cpu(), on_cpu.descriptor(img)
    err, dot = (got - ref).abs().max().item(), float(got @ ref)
    ms = device_ms(lambda: on_card.descriptor(img_dev), launches=20)
    print(f"caffe: CALC-shaped net (seed {CAFFE_SEED}, input {on_cpu.net.input_shape}, layers "
          f"{layers}): descriptor {tuple(got.shape)} on the card against the CPU max |d| "
          f"{err:.2e}, dot {dot:.7f}; device time {ms:.4f} ms per call [{card}]", flush=True)
    if not (got.shape == (1064,) and err <= CALC_MAX_ABS and dot >= CALC_MIN_DOT):
        fail("caffe", "card vs CPU", f"the Caffe runner on the card disagrees with the CPU "
             f"(shape {tuple(got.shape)}, max |d| {err:.2e}, dot {dot:.7f})")

    runner = slam._loop_closer.model._caffe
    if runner is None:
        fail("caffe", "wiring", "cfg.loop.caffe_weights did not select the Caffe runner")
    reset_counters()
    for t in range(CAFFE_FRAMES):
        if not slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]):
            fail("caffe", "LOST", f"tracking LOST at frame {t}")
    torch.cuda.synchronize()
    launches = L.lk_pyramid.launches
    n_kf = int(slam.map.n_kf)
    fid = slam.map.kf_frame_id[:n_kf].cpu().numpy()
    worst, exact = 0.0, True
    for k in range(n_kf):
        left = slam._pre_left(torch.from_numpy(seq.left[fid[k]].astype(np.uint8)).to(dev))
        want = runner.descriptor(preprocess(left))
        have = slam.loop.deep_db[k]
        exact &= torch.equal(have, want)
        worst = max(worst, (have - want).abs().max().item())
    print(f"caffe: StereoSlam with cfg.loop.caffe_prototxt/caffe_weights, loop closing on, "
          f"{CAFFE_FRAMES} frames of phase main: no LOST, {n_kf} keyframes; stored descriptors "
          f"against the runner on each keyframe's preprocessed left image: "
          f"{'bit-identical' if exact else f'max |d| {worst:.2e}'}; lk_pyramid launches "
          f"{launches} [{card}]", flush=True)
    if not exact:
        fail("caffe", "descriptors", f"stored keyframe descriptors differ from the runner's "
             f"(max |d| {worst:.2e})")
    if launches < CAFFE_FRAMES - 1:
        fail("caffe", "launches", f"{launches} lk_pyramid launches for {CAFFE_FRAMES - 1} frames")


# ---------------------------------------------------------------------------
# Phase endurance: the reference-scale run, cut in depth, and live compaction
# ---------------------------------------------------------------------------

# (a) run_endurance cut from 10.8 laps to 2 (843 of 4,557 frames); the full
# run is scripts/torch_endurance.py's.  (b) The first 548 frames (the world
# circuit's 1.3 laps) with the landmark table cut from 49,152 rows to
# ENDUR_B_MAX_LANDMARKS, so that its 90% threshold (8,294) is crossed at least
# twice: on the card the first compaction fires at frame 329 (1,350 rows
# freed), the next at frame 444, and then at nearly every keyframe, each
# freeing fewer rows, until the table fills at frame 539.
ENDUR_LAPS = 2.0
# The JAX package on a CPU over the CPU render of the same 843 frames
# (scripts/jax_world_trace.py run) goes LOST at frame 678, in the second lap's
# slow corner, loop closing ON and OFF alike, with no loop edge: it does not
# reach the end of (a) itself.  As phase world's ATE band is the JAX CPU run's,
# (a) holds the port to tracking at least as far as that run.
ENDUR_JAX_CPU_LOST_AT = 678
ENDUR_B_FRAMES = 548
ENDUR_B_MAX_LANDMARKS = 9216
ENDUR_MIN_COMPACTIONS = 2
ENDUR_MAX_EDGE_GT_M = 5.0


def phase_endurance(dev, card: str):
    from stereoslam_tpu_torch import eval as E
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.utils import world as W

    n_full = int(W.frames_per_lap(E.WORLD_STEP, E.WORLD_LENGTH, E.WORLD_WIDTH) * E.ENDURANCE_LAPS)
    n = int(W.frames_per_lap(E.WORLD_STEP, E.WORLD_LENGTH, E.WORLD_WIDTH) * ENDUR_LAPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = W.generate_world_sequence(n_frames=n, h=E.WORLD_H, w=E.WORLD_W, fx=320.0,
                                    seed=E.WORLD_SEED, step=E.WORLD_STEP, length=E.WORLD_LENGTH,
                                    width=E.WORLD_WIDTH, device=dev)
    torch.cuda.synchronize()
    print(f"endurance: (a) run_endurance cut in depth from {E.ENDURANCE_LAPS} laps ({n_full} "
          f"frames) to {ENDUR_LAPS} laps ({n} frames), rendered on the card in "
          f"{time.perf_counter() - t0:.1f} s; table {E.ENDURANCE_MAX_LANDMARKS} landmark rows "
          f"[{card}]", flush=True)
    reset_counters()
    rec = E.run_endurance(laps=ENDUR_LAPS, seq=seq, device=dev)
    launches = L.lk_pyramid.launches
    per_level = K.lk_level.launches + K.lk_final_error.launches
    print(f"endurance: (a) record {json.dumps(rec)}", flush=True)
    edges = [(c, lp, c - lp, d) for (c, lp), d in zip(rec["loop_edges"], rec["edge_gt_dist_m"])]
    print(f"endurance: (a) {rec['frames']} frames, {rec['fps']} FPS, p50 frame "
          f"{rec['frame_ms_p50_first800']} ms (first 800) / {rec['frame_ms_p50_last800']} ms (last "
          f"800), detection scan at {rec['n_kf']} KFs {rec['db_scan_ms_final']} ms, full-graph PGO "
          f"{rec['pgo_ms_final_fullgraph']} ms; ATE {rec['ate_m']} m, {rec['true_revisit_edges']} "
          f"true of {len(edges)} edges (cur, loop, id gap, ground-truth m) {edges}, "
          f"{rec['compactions']} compactions; lk_pyramid launches {launches} "
          f"({launches / max(rec['frames'] - 1, 1):.2f}/tracked frame), per-level {per_level} "
          f"[{card}]", flush=True)
    if rec["lost_at"] is not None:
        print(f"endurance: (a) LOST at frame {rec['lost_at']} of {n} (the JAX package on a CPU: "
              f"LOST at frame {ENDUR_JAX_CPU_LOST_AT} of the same frames)", flush=True)
    if rec["lost_at"] is not None and rec["lost_at"] < ENDUR_JAX_CPU_LOST_AT:
        fail("endurance", "LOST", f"(a): LOST at frame {rec['lost_at']}, before the JAX "
             f"package's CPU run of the same frames ({ENDUR_JAX_CPU_LOST_AT})")
    for c, lp, gap, dist in edges:
        if gap < 20 or not dist < ENDUR_MAX_EDGE_GT_M:
            fail("endurance", "edges", f"(a): edge {c}->{lp} has id gap {gap} or ground-truth "
                 f"distance {dist} m")
    if launches < rec["frames"] - 1 or per_level:
        fail("endurance", "launches", f"(a): {launches} lk_pyramid launches for "
             f"{rec['frames'] - 1} tracked frames, {per_level} per-level")

    # (b) Live compaction at the world circuit's width.
    cfg = E.endurance_config(seq, E.WORLD_H, E.WORLD_W, max_landmarks=ENDUR_B_MAX_LANDMARKS)
    slam = StereoSlam(cfg, device=dev)
    log_lines = LogLines()
    sys_log = logging.getLogger("stereoslam_tpu_torch.core.system")
    sys_log.addHandler(log_lines)
    sys_log.setLevel(logging.INFO)
    reset_counters()
    events, bad_links, differ, pending = [], [], [], None
    t0 = time.perf_counter()
    try:
        for t in range(ENDUR_B_FRAMES):
            lr = torch.stack([seq.left[t], seq.right[t]]).to(torch.uint8)
            before = slam.compaction_count
            if not slam.process_staged(lr, float(seq.timestamps[t])):
                fail("endurance", "LOST", f"(b): tracking LOST at frame {t}")
            if pending is not None:
                if not replay_equals_eager(slam.track_graph):
                    differ.append(t)
                pending = None
            if slam.compaction_count > before:
                tr, m = slam.fs.tracks, slam.map
                n_lm = int(m.n_lm)
                linked = tr.valid & (tr.lm_idx >= 0)
                idx = tr.lm_idx.long().clamp(min=0)
                stale = linked & ((tr.lm_idx >= n_lm) | ~m.lm_valid[idx])
                events.append((t, n_lm, int(linked.sum())))
                if bool(stale.any()):
                    bad_links.append((t, int(stale.sum())))
                pending = t
    finally:
        sys_log.removeHandler(log_lines)
        sys_log.setLevel(logging.NOTSET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_b = L.lk_pyramid.launches
    compacted = [s for s in log_lines.lines if "compacted" in s or "exhausted" in s]
    checked = len(events) - (pending is not None)
    print(f"endurance: (b) {ENDUR_B_FRAMES} frames, landmark table cut from "
          f"{E.ENDURANCE_MAX_LANDMARKS} to {ENDUR_B_MAX_LANDMARKS} rows (threshold "
          f"{int(0.9 * ENDUR_B_MAX_LANDMARKS)}): {slam.compaction_count} live compactions "
          f"(frame, n_lm after, linked tracks) {events}; {len(compacted)} log lines {compacted[:6]}; "
          f"final n_lm {int(slam.map.n_lm)}, {int(slam.map.n_kf)} KFs, "
          f"{len(slam.loop_edges)} loop edges; {ENDUR_B_FRAMES / wall:.2f} FPS with the checks; "
          f"lk_pyramid launches {launches_b} [{card}]", flush=True)
    print(f"endurance: (b) the tracked frame after each compaction: replay against the eager "
          f"track_frame {'bit-identical' if not differ else f'DIFFERS at {differ}'} ({checked} "
          f"checked); live tracks pointing at a freed or dead row: {bad_links or 'none'}",
          flush=True)
    if slam.compaction_count < ENDUR_MIN_COMPACTIONS:
        fail("endurance", "compactions", f"(b): {slam.compaction_count} live compactions, "
             f"expected >= {ENDUR_MIN_COMPACTIONS}")
    if differ:
        fail("endurance", "replay vs eager", f"(b): replay differs after compaction at {differ}")
    if checked < ENDUR_MIN_COMPACTIONS:
        fail("endurance", "replay vs eager", f"(b): only {checked} compactions were followed by a "
             f"tracked frame")
    if bad_links:
        fail("endurance", "freed rows", f"(b): live tracks point at freed rows: {bad_links}")
    if launches_b < ENDUR_B_FRAMES - 1:
        fail("endurance", "launches", f"(b): {launches_b} lk_pyramid launches")
    return launches


# ---------------------------------------------------------------------------
# Phase multiseq: the batched multi-sequence mode
# ---------------------------------------------------------------------------

# bench.py Phase M (bench.py:430-468): B=8 sequences at 240x376, seeds
# 20-27, 2000 points, forward at 0.6 m/frame, fx 320, baseline 0.54, 72
# frames of which 16 warm up, SlamConfig defaults, MultiSeqVO defaults.
MS_BATCH, MS_FRAMES, MS_WARMUP, MS_SEED0 = 8, 72, 16, 20
MS_MIN_KF = 3
MS_GATE = (True, False, True, True, False, True, False, True)
MS_CHECK_STEPS = (2, 7, 8)      # steps held to the eager and the single-sequence step
MS_CHECK_FRAMES = 32            # frames of the checking run (staged in advance)
MS_REPLAYS = 20                 # replays of one step's graph, timed
# The batched step against track_frame on the card: vmap turns each
# sequence's reductions and 4x4 products into batched kernels that round
# differently from the single ones, so LK's seeds and the LM's accept tests
# differ in their last bits.  Flags must be equal, the tracks within the
# kernel-vs-plain tolerances, T_rk within MS_TRK_TOL (the largest seen in
# a run on an NVIDIA H100 80GB HBM3: 2.0e-4).
MS_TRK_TOL = 1e-3
# The port's Phase M run repeats bit for bit on the card, so (KFs, ATE m)
# per sequence are pinned from a run on an NVIDIA H100 80GB HBM3.
EXPECTED_MULTISEQ_RUN = ((11, 0.3997), (11, 0.4172), (11, 0.1277), (11, 0.3209), (10, 0.0627),
                         (10, 0.3781), (10, 0.244), (10, 0.2496))
# The MULTISEQ_LOOP.json experiment: B=2 world circuits, seeds 1 and 2.
MS_WORLD_BATCH = 2
MS_ATE_SLACK_M = 1e-3


def multiseq_sequence(b: int):
    from stereoslam_tpu_torch.utils.synthetic import generate_sequence

    return generate_sequence(n_frames=MS_FRAMES, h=240, w=376, fx=320.0, baseline=0.54,
                             n_points=2000, trajectory="forward", speed=0.6, seed=MS_SEED0 + b)


@functools.lru_cache(maxsize=None)
def multiseq_sequences():
    """The B sequences, made in parallel processes (the generator splats
    each point in a Python loop)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=min(MS_BATCH, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(multiseq_sequence, range(MS_BATCH)))


def multiseq_config():
    from stereoslam_tpu_torch.config import CameraConfig, SlamConfig

    return SlamConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=188.0, cy=120.0, fx_right=320.0,
                            fy_right=320.0, cx_right=188.0, cy_right=120.0, bf=320.0 * 0.54),
        image_height=240, image_width=376,
    )


def multiseq_world_script():
    """scripts/torch_multiseq_world.py, the port's MULTISEQ_LOOP experiment."""
    path = Path(__file__).resolve().parent / "scripts" / "torch_multiseq_world.py"
    spec = importlib.util.spec_from_file_location("torch_multiseq_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counters():
    """The kernel wrappers' launch counters, as (wrapper, attribute) pairs."""
    from stereoslam_tpu_torch.core.graphs import _kernel_counters

    return _kernel_counters()


def reset_counters() -> None:
    for fn, attr in counters():
        setattr(fn, attr, 0)


class KeepCounters:
    """Leaves the launch counters as they were: launches made to compare a
    kernel or a step with another version do not count."""

    def __enter__(self):
        self.saved = [getattr(fn, attr) for fn, attr in counters()]

    def __exit__(self, *exc):
        for (fn, attr), v in zip(counters(), self.saved):
            setattr(fn, attr, v)


def check_batched_kernel(dev, seqs, cfg, card: str):
    """(a) One batched lk_pyramid launch at the Phase M shapes (B=8,
    240x376, 3 levels, 400 FAST corners a sequence from frame 0 into frame
    1, the temporal call's settings) against 8 single launches (bit for
    bit), gated by a mixed vector, against the batched plain version, and
    timed against the 8 single launches."""
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.ops.fast import detect_keypoints
    from stereoslam_tpu_torch.ops.image import build_lk_pyramid

    t = cfg.tracking
    N = cfg.features.max_features
    A = torch.stack([torch.from_numpy(q.left[0].astype(np.uint8)) for q in seqs]).to(dev).float()
    Bn = torch.stack([torch.from_numpy(q.left[1].astype(np.uint8)) for q in seqs]).to(dev).float()
    # All N slots, as the step's temporal call takes them: the corners and,
    # where a frame has fewer than N, empty slots at (0, 0).
    kps = [detect_keypoints(A[b], N) for b in range(len(seqs))]
    n_corners = [int(k.valid.sum()) for k in kps]
    if min(n_corners) < cfg.features.num_features_init_good:
        fail("multiseq", "corners", f"FAST corners per sequence {n_corners}, fewer than the "
             f"{cfg.features.num_features_init_good} that initialization needs")
    P = torch.stack([k.xy for k in kps]).contiguous()
    gen = torch.Generator().manual_seed(0)
    init = (P + (torch.rand(P.shape, generator=gen) * 16.0 - 8.0).to(dev)).contiguous()
    lk_kw = dict(window=t.lk_window, iters=t.lk_iters, eps=t.lk_eps, max_error=30.0,
                 forward_backward=t.lk_forward_backward, fb_iters=t.lk_fb_iters,
                 fb_levels=t.lk_fb_levels)
    pa, pb = build_lk_pyramid(A, t.lk_levels), build_lk_pyramid(Bn, t.lk_levels)
    views = [([x[b] for x in pa], [y[b] for y in pb], P[b], init[b]) for b in range(len(seqs))]
    gate = torch.tensor(MS_GATE, device=dev)
    n0 = (L.lk_pyramid.launches, L.lk_pyramid.batched_launches)
    got = L.lk_pyramid(pa, pb, P, init, **lk_kw)
    gated = L.lk_pyramid(pa, pb, P, init, gate=gate, **lk_kw)
    n1 = (L.lk_pyramid.launches, L.lk_pyramid.batched_launches)
    single = [L.lk_pyramid(*v, **lk_kw) for v in views]
    plain = L.lk_pyramid_plain(pa, pb, P, init, **lk_kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x[b], y) for b in range(len(seqs)) for x, y in zip(got, single[b]))
    gate_ok = all(
        all(torch.equal(x[b], y) for x, y in zip(gated, single[b])) if on else
        (not bool(gated.status[b].any()) and torch.equal(gated.points[b], init[b])
         and not bool(gated.error[b].any()))
        for b, on in enumerate(MS_GATE))
    agree = (got.status == plain.status).float().mean().item()
    both = got.status & plain.status
    d = (got.points - plain.points).norm(dim=-1)[both]
    med, p99 = d.median().item(), d.quantile(0.99).item()
    worst = (got.points - plain.points).abs()[both].max().item()
    print(f"multiseq: lk_pyramid batched, B={len(seqs)} x N={N} slots (FAST corners "
          f"{n_corners}) at {tuple(pa[0].shape[1:])} -> "
          f"{tuple(pa[-1].shape[1:])}, {int(got.status.sum())} kept: against {len(seqs)} single "
          f"launches {'bit-identical' if same else 'DIFFER'} (points, status, error); gate "
          f"{list(MS_GATE)}: {'on bit-identical, off no track kept' if gate_ok else 'WRONG'}; "
          f"against the batched plain version: status agree {agree:.4f}, |dpoint| median "
          f"{med:.2e} p99 {p99:.2e} px; {n1[0] - n0[0]} counted launches for 2 batched calls, "
          f"{n1[1] - n0[1]} batched", flush=True)
    if not same:
        fail("multiseq", "batched vs single launches",
             "a sequence of the batched launch differs from its own single launch")
    if not gate_ok:
        fail("multiseq", "batched gate", "a gated-on sequence differs from the ungated launch, or "
             "a gated-off sequence keeps a track")
    if n1 != (n0[0] + 2, n0[1] + 2):
        fail("multiseq", "batched launch count", f"launch counters moved by "
             f"{(n1[0] - n0[0], n1[1] - n0[1])} for 2 batched calls")
    if not (agree >= TOL_GOOD_AGREE and med < TOL_MEDIAN_PX and p99 < TOL_P99_PX):
        fail("multiseq", "batched vs plain", "the batched launch disagrees with the batched plain "
             "version")

    # Time: the batched launch and the 8 single launches, each a CUDA graph
    # of back-to-back launches, in turns (batched, single, single, batched).
    def eight():
        for v in views:
            L.lk_pyramid(*v, **lk_kw)

    t_b1 = device_ms(lambda: L.lk_pyramid(pa, pb, P, init, **lk_kw))
    t_s1 = device_ms(eight, launches=25)
    t_s2 = device_ms(eight, launches=25)
    t_b2 = device_ms(lambda: L.lk_pyramid(pa, pb, P, init, **lk_kw))
    t_plain = device_ms(lambda: L.lk_pyramid_plain(pa, pb, P, init, **lk_kw), launches=1,
                        warmup=1)
    work = [lk_work(K, *v, t.lk_iters, t.lk_eps, lk_kw["forward_backward"], lk_kw["fb_iters"])
            for v in views]
    bnd = bound(sum(w[0] for w in work), sum(w[1] for w in work))
    t_b = min(t_b1, t_b2)
    print(f"multiseq: device time lk_pyramid batched (B={len(seqs)}): {t_b1 * 1e3:.3f}, "
          f"{t_b2 * 1e3:.3f} us per launch; the same 8 calls as single launches {t_s1 * 1e3:.3f}, "
          f"{t_s2 * 1e3:.3f} us; plain {t_plain:.3f} ms; bound {bnd[0] * 1e3:.3f} us by {bnd[1]} "
          f"({bnd[2]}), {bnd[0] / t_b:.1%} of it reached [{card}]", flush=True)
    return {"max_abs_err": worst, "ms": t_b, "plain_ms": t_plain, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def check_multiseq_steps(dev, seqs, cfg, card: str) -> None:
    """A second Phase M run over MS_CHECK_FRAMES frames staged in advance:
    host reads per step by kind under the sync-debug mode, replays against
    the eager batched step (bit for bit), each sequence's batched step
    against the single-sequence track_frame with the hoisted config (flags
    equal, the tracks within the kernel-vs-plain tolerances, T_rk within
    MS_TRK_TOL), and the device busy share of the steps after the warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stereoslam_tpu_torch.core import frontend as F
    from stereoslam_tpu_torch.core.graphs import _clone, _flat
    from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO, OUTCOME_COLUMNS, _take

    B = len(seqs)
    vo = MultiSeqVO(cfg, batch=B, device=dev)
    g = vo.graph
    stack = lambda t, f: np.stack([getattr(q, f)[t] for q in seqs])  # noqa: E731
    vo.initialize(stack(0, "left"), stack(0, "right"), np.zeros(B))
    staged = [torch.from_numpy(np.stack([stack(t, "left"), stack(t, "right")], 1).astype(
        np.uint8)).to(dev) for t in range(MS_CHECK_FRAMES)]
    torch.cuda.synchronize()
    col = {c: i for i, c in enumerate(OUTCOME_COLUMNS)}
    single_col = {"num_inliers": 0, "num_tracked": 1, "status": 2, "make_kf": 3, "retry": 8,
                  "deep": 9}  # frontend.track_frame's packed outcome
    reads = {"plain": [], "keyframe": []}
    replay_differ, seq_report, d_xy, agree = [], [], [], []
    for t in range(1, MS_CHECK_FRAMES):
        if t in MS_CHECK_STEPS:
            # The step's replay, kept before keyframe service writes into
            # its outputs, against the eager step and each sequence's
            # single step on the same inputs; process_staged then replays
            # the same inputs again.
            with KeepCounters():
                left, fs2, _, packed = replayed = _clone(
                    g.run(staged[t], vo._pyr_prev, vo.fs, vo.maps))
                g.replays -= 1
                lr, pyr_prev, fs, tmap = g._inputs
                eager = g._fn(lr, pyr_prev, fs, tmap)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(_flat(eager), _flat(replayed))):
                    replay_differ.append(t)
                for b in range(B):
                    sfs, _, spk = F.track_frame(lr[b, 0].to(torch.float32),
                                                tuple(p[b] for p in pyr_prev), _take(fs, b),
                                                _take(tmap, b), vo.intr, vo._run_cfg)
                    flags = all(float(packed[b, col[k]]) == float(spk[i]) for k, i in
                                single_col.items())
                    va, vb = fs2.tracks.valid[b], sfs.tracks.valid
                    lk_same = torch.equal(fs2.tracks.xy[b], sfs.tracks.xy) and torch.equal(va, vb)
                    d_xy.append((fs2.tracks.xy[b] - sfs.tracks.xy).norm(dim=-1)[va & vb])
                    agree.append((va == vb).float().mean().item())
                    d_trk = (fs2.T_rk[b] - sfs.T_rk).abs().max().item()
                    seq_report.append((t, b, flags, lk_same, d_trk))
        if t == MS_WARMUP:
            break
        before = (vo.outcome_reads, vo.reads.counts["detect"], vo.keyframes_serviced)
        torch.cuda.synchronize()
        with SyncCount() as sc:
            vo.process_staged(staged[t], np.full(B, t * 0.1, np.float32))
        outcome, detect = vo.outcome_reads - before[0], vo.reads.counts["detect"] - before[1]
        kind = "keyframe" if (vo.keyframes_serviced > before[2] or detect) else "plain"
        if t >= 2:
            reads[kind].append((sc.n, outcome, detect))

    # The device busy share and the host stages of the steps after the
    # warm-up, under the profiler.
    vo.drain()
    torch.cuda.synchronize()
    n_stage = len(vo.stage_s["track"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(MS_WARMUP, MS_CHECK_FRAMES):
            vo.process_staged(staged[t], np.full(B, t * 0.1, np.float32))
        vo.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in kern) / 1e6
    lk = [e for e in kern if "lk_pyramid" in e.key]
    n_steps = MS_CHECK_FRAMES - MS_WARMUP
    stage = {k: np.asarray(v[n_stage:]) * 1e3 for k, v in vo.stage_s.items()}
    print(f"multiseq: check run, {MS_CHECK_FRAMES} frames staged in advance: graph replay "
          f"against the eager batched step at steps {MS_CHECK_STEPS}: "
          f"{'bit-identical' if not replay_differ else f'DIFFER at {replay_differ}'}; "
          f"{g.replays} replays for {MS_CHECK_FRAMES - 1} steps", flush=True)
    print(f"multiseq: host wall ms a step by stage over the {n_steps} steps after the warm-up: "
          + "; ".join(f"{k} mean {v.mean():.2f}, p50 {np.median(v):.2f}, max {v.max():.2f}"
                      for k, v in stage.items()) + f" [{card}]", flush=True)
    print(f"multiseq: the same {n_steps} steps under the profiler: wall {wall * 1e3:.1f} ms, "
          f"device kernel time {dev_s * 1e3:.1f} ms, device busy {dev_s / wall:.1%}; "
          f"{sum(e.count for e in kern)} kernel launches ({sum(e.count for e in kern) / n_steps:.0f} "
          f"a step); lk_pyramid kernel {sum(e.self_device_time_total for e in lk) / 1e3:.2f} ms in "
          f"{sum(e.count for e in lk)} launches [{card}]", flush=True)
    bad = [r for r in seq_report if not (r[2] and r[4] <= MS_TRK_TOL)]
    d = torch.cat(d_xy)
    med, p99 = d.median().item(), d.quantile(0.99).item()
    trk = sorted(r[4] for r in seq_report)
    print(f"multiseq: each sequence's batched step against track_frame (hoisted config) at "
          f"steps {MS_CHECK_STEPS}, {len(seq_report)} cases: flags equal in "
          f"{sum(r[2] for r in seq_report)}; tracks bit for bit in {sum(r[3] for r in seq_report)}, "
          f"valid agreement min {min(agree):.4f}, |d xy| median {med:.2e} p99 {p99:.2e} max "
          f"{d.max().item():.2e} px; |d T_rk| median {trk[len(trk) // 2]:.2e} max {trk[-1]:.2e} "
          f"(bound {MS_TRK_TOL}); failing (step, seq, flags equal, tracks bit for bit, |d T_rk|): "
          f"{bad}", flush=True)
    for kind, v in reads.items():
        if v:
            a = np.asarray(v)
            print(f"multiseq: host reads per {kind} step (lag {vo.readback_lag}): sync-debug "
                  f"reports {a[:, 0].mean():.2f} (max {a[:, 0].max()}), outcome reads "
                  f"{a[:, 1].mean():.2f}, detection reads {a[:, 2].mean():.2f}, over {len(v)} "
                  f"steps", flush=True)
    if replay_differ:
        fail("multiseq", "replay vs eager", f"graph replay differs from the eager batched step at "
             f"steps {replay_differ}")
    if g.replays != MS_CHECK_FRAMES - 1:
        fail("multiseq", "graph", f"{g.replays} replays for {MS_CHECK_FRAMES - 1} steps")
    if bad or not (min(agree) >= TOL_GOOD_AGREE and med < TOL_MEDIAN_PX and p99 < TOL_P99_PX):
        fail("multiseq", "batched vs single step", f"(step, seq, flags equal, tracks bit for bit, "
             f"|d T_rk|) {bad}; valid agreement {min(agree):.4f}, |d xy| median {med:.2e} p99 "
             f"{p99:.2e} px")
    plain = np.asarray(reads["plain"])
    if len(plain) == 0 or not ((plain[:, 0] == 0).all() and (plain[:, 1] == 1).all()
                               and (plain[:, 2] == 0).all()):
        fail("multiseq", "syncs", f"a keyframe-free step made other than one device-to-host "
             f"read: (sync-debug reports, outcome reads, detection reads) {reads['plain']}")

    # The last step, copy-in and replay, as the batched graph against each
    # sequence's slice of the same inputs through a single-sequence graph
    # (StereoSlam's TrackGraph): CUDA events around back-to-back calls, in
    # turns (batched, single, single, batched).
    from stereoslam_tpu_torch.core.graphs import TrackGraph

    lr, pyr_prev, fs, tmap = inputs = _clone(g._inputs)
    single = TrackGraph(vo._run_cfg, vo.intr, dev)
    slices = [(lr[b], tuple(p[b] for p in pyr_prev), _take(fs, b), _take(tmap, b))
              for b in range(B)]

    def replays(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(MS_REPLAYS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / MS_REPLAYS

    def all_singles():
        for sl in slices:
            single.run(*sl)

    def batched():
        g.run(*inputs)

    with KeepCounters():
        t_rep = [replays(batched), replays(all_singles), replays(all_singles), replays(batched)]
    print(f"multiseq: one tracked step of the last inputs, copy-in and replay: the batched graph "
          f"{t_rep[0]:.3f}, {t_rep[3]:.3f} ms for {B} sequences; the single-sequence graph "
          f"(StereoSlam's) on each of the {B} slices {t_rep[1]:.3f}, {t_rep[2]:.3f} ms (CUDA "
          f"events, {MS_REPLAYS} back to back) [{card}]", flush=True)


def check_multiseq_world(dev, ms, card: str) -> None:
    """(c) The MULTISEQ_LOOP.json experiment (``ms``, the loaded
    scripts/torch_multiseq_world.py): B=2 world circuits (seeds 1 and 2,
    548 frames) loop ON (verify_loops=True, kf_sub=2) and OFF."""
    from stereoslam_tpu_torch.parallel import multiseq as M

    lines = LogLines()
    ms_log = logging.getLogger(M.__name__)
    ms_log.addHandler(lines)
    ms_log.setLevel(logging.INFO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rec, vo_on, vo_off, seqs = ms.experiment(MS_WORLD_BATCH, WORLD_FRAMES, dev)
    finally:
        ms_log.removeHandler(lines)
        ms_log.setLevel(logging.NOTSET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path = Path(__file__).resolve().parent / "MULTISEQ_LOOP.json"
    tpu = json.loads(path.read_text()) if path.exists() else None
    print(f"multiseq: world record {json.dumps(rec)} ({wall:.1f} s for rendering and both "
          f"runs) [{card}]", flush=True)
    for b, r in enumerate(rec["per_seq"]):
        jr = tpu["per_seq"][b] if tpu and b < len(tpu["per_seq"]) else None
        jtxt = (f"; TPU record (MULTISEQ_LOOP.json, the JAX package): ATE ON {jr['ate_loop_on_m']}"
                f" m, OFF {jr['ate_loop_off_m']} m, {jr['n_kf']} KFs, {len(jr['detected_edges'])}"
                f" edges, {len(jr['applied_corrections'])} applied" if jr else "")
        print(f"multiseq: world seed {r['seed']}: ATE loop ON {r['ate_loop_on_m']} m, OFF "
              f"{r['ate_loop_off_m']} m, {r['n_kf']} KFs, edges {r['detected_edges']}, applied "
              f"corrections {r['applied_corrections']}{jtxt}", flush=True)
        if not r["applied_corrections"]:
            print(f"multiseq: world seed {r['seed']}: no applied correction (queue 3)", flush=True)
        summarize_refusals([x for x in lines.lines if x.startswith(f"seq {b}:")],
                           vo_on._vcfg.loop, card, prefix=f"multiseq: world seed {r['seed']}")
    id_gap = vo_on.cfg.loop.id_gap
    for name, vo in (("loop ON", vo_on), ("loop OFF", vo_off)):
        if not vo.alive.all():
            fail("multiseq", "world LOST", f"{name}: sequences lost {np.nonzero(~vo.alive)[0]}")
    for b, r in enumerate(rec["per_seq"]):
        fid = vo_on.maps.kf_frame_id[b].cpu().numpy()
        pos = np.linalg.inv(np.asarray(seqs[b].T_cw).astype(np.float64))[:, :3, 3]
        for kind in ("detected_edges", "applied_corrections"):
            for kf, lp in r[kind]:
                dist = float(np.linalg.norm(pos[fid[kf]] - pos[fid[lp]]))
                if kf - lp < id_gap or not dist < WORLD_MAX_EDGE_GT_M:
                    fail("multiseq", "world edges", f"seed {r['seed']}: {kind} {kf}->{lp} has id "
                         f"gap {kf - lp} or ground-truth distance {dist:.2f} m")
        if not r["ate_loop_on_m"] <= r["ate_loop_off_m"] + MS_ATE_SLACK_M:
            fail("multiseq", "world ATE", f"seed {r['seed']}: ATE loop ON {r['ate_loop_on_m']} m "
                 f"above loop OFF {r['ate_loop_off_m']} m")


def check_multiseq_service(dev, seqs, cfg, card: str) -> None:
    """(b) Phase M's keyframe service with its BA through the eager
    early-exit BA and through the BA graph, one run each in one process:
    aggregate FPS and the host's ms a step in the keyframe stage after the
    warm-up, and the runs bit for bit."""
    from stereoslam_tpu_torch.core import backend as B
    from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO

    stack = lambda t, f: np.stack([getattr(q, f)[t] for q in seqs])  # noqa: E731

    def run(kind: str):
        vo = MultiSeqVO(cfg, batch=MS_BATCH, device=dev)
        if kind == "eager early exit":
            vo._ba = functools.partial(B.optimize_active_map, intr=vo.intr, cfg=vo._run_cfg,
                                       host_exit=True)
        vo.initialize(stack(0, "left"), stack(0, "right"), np.zeros(MS_BATCH))
        for t in range(1, MS_FRAMES):
            if t == MS_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            vo.process_frames(stack(t, "left"), stack(t, "right"), np.full(MS_BATCH, t * 0.1))
        vo.drain()
        torch.cuda.synchronize()
        fps = MS_BATCH * (MS_FRAMES - MS_WARMUP) / (time.perf_counter() - t0)
        ms = np.asarray(vo.stage_s["keyframes"][MS_WARMUP - 1:]) * 1e3
        return vo.maps, ms, vo.keyframes_serviced, fps

    with KeepCounters():
        runs = [(kind, run(kind)) for kind in ("eager early exit", "graph")]
    ref = runs[0][1][0]
    same = all(all(torch.equal(x, y) for x, y in zip(maps, ref)) for _, (maps, _, _, _) in runs)
    for kind, (_, ms, n, fps) in runs:
        print(f"multiseq: (b) keyframe service with the BA through the {kind}: {fps:.2f} "
              f"aggregate FPS after the warm-up (host frames, process_frames); host ms a step "
              f"in the keyframe stage after the warm-up: mean {ms.mean():.2f}, p50 "
              f"{np.median(ms):.2f}, max {ms.max():.2f} over {len(ms)} steps; {n} keyframes "
              f"serviced in the run [{card}]", flush=True)
    print(f"multiseq: (b) the two runs' batched maps {'bit-identical' if same else 'DIFFER'}",
          flush=True)
    if not same:
        fail("multiseq", "(b) service", "the BA graph and the eager early exit give other maps")


def phase_multiseq(dev, card: str):
    """The batched multi-sequence mode: (a) the batched LK launch, (b) bench.py
    Phase M's workload through MultiSeqVO fed by BatchFeed, with the checking
    run, and (c) the MULTISEQ_LOOP.json experiment."""
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO
    from stereoslam_tpu_torch.utils.feed import BatchFeed

    t_part = [time.perf_counter()]

    def part(name):
        t_part.append(time.perf_counter())
        print(f"multiseq: {name} took {t_part[-1] - t_part[-2]:.1f} s", flush=True)

    seqs = multiseq_sequences()
    cfg = multiseq_config()
    numbers = check_batched_kernel(dev, seqs, cfg, card)
    part("(a), the batched kernel")

    # (b) Phase M: warm-up through process_frames, then BatchFeed.
    B = MS_BATCH
    stack = lambda t, f: np.stack([getattr(q, f)[t] for q in seqs])  # noqa: E731
    vo = MultiSeqVO(cfg, batch=B, device=dev)
    vo.initialize(stack(0, "left"), stack(0, "right"), np.zeros(B))
    reset_counters()
    per_step, step_ms = [], []
    for t in range(1, MS_WARMUP):
        k0 = vo.keyframes_serviced
        vo.process_frames(stack(t, "left"), stack(t, "right"), np.full(B, t * 0.1))
        per_step.append(vo.keyframes_serviced - k0)
    vo.drain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed = BatchFeed(((stack(t, "left"), stack(t, "right"), np.full(B, t * 0.1))
                      for t in range(MS_WARMUP, MS_FRAMES)), device=dev)
    for lr, ts in feed:
        k0, s0 = vo.keyframes_serviced, time.perf_counter()
        vo.process_staged(lr, ts)
        step_ms.append((time.perf_counter() - s0) * 1e3)
        per_step.append(vo.keyframes_serviced - k0)
    vo.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lk_pyramid": L.lk_pyramid.launches,
                "lk_pyramid_batched": L.lk_pyramid.batched_launches}
    steps = MS_FRAMES - 1
    fps = B * (MS_FRAMES - MS_WARMUP) / wall
    n_kf = vo.maps.n_kf.cpu().numpy()
    ms = multiseq_world_script()
    ate = [round(ms.kf_ate(vo, b, seqs[b]), 4) for b in range(B)]
    run = tuple((int(n_kf[b]), ate[b]) for b in range(B))
    print(f"multiseq: Phase M, B={B} x {MS_FRAMES} frames 240x376: {fps:.2f} aggregate FPS, "
          f"{fps * 240 * 376 / 1e6:.2f} Mpx/s after {MS_WARMUP} warm-up frames (BatchFeed), p50 "
          f"step {np.median(step_ms):.2f} ms (host, process_staged), {vo.graph.replays} graph "
          f"replays for {steps} steps, {vo.keyframes_serviced} keyframes serviced (at most "
          f"{max(per_step)} a step, kf_sub {vo.kf_sub}), lk_pyramid launches {launches} "
          f"[{card}]", flush=True)
    print(f"multiseq: Phase M per sequence (KFs, keyframe ATE m): {run}; alive {vo.alive.tolist()}",
          flush=True)
    if not vo.alive.all():
        fail("multiseq", "LOST", f"sequences lost: {np.nonzero(~vo.alive)[0].tolist()}")
    if (n_kf < MS_MIN_KF).any():
        fail("multiseq", "keyframes", f"fewer than {MS_MIN_KF} keyframes: {n_kf.tolist()}")
    if max(per_step) > vo.kf_sub:
        fail("multiseq", "kf_sub", f"{max(per_step)} keyframes in one step, kf_sub {vo.kf_sub}")
    if vo.graph.replays != steps:
        fail("multiseq", "graph", f"{vo.graph.replays} graph replays for {steps} steps")
    if launches["lk_pyramid_batched"] < steps:
        fail("multiseq", "launches", f"the batched step bypassed the batched LK launch: {launches}")
    if EXPECTED_MULTISEQ_RUN is not None and run != EXPECTED_MULTISEQ_RUN:
        fail("multiseq", "repeat", f"(KFs, ATE) per sequence = {run}, expected "
             f"{EXPECTED_MULTISEQ_RUN}: the run repeats bit for bit, so the arithmetic changed")
    part("(b), Phase M")
    check_multiseq_service(dev, seqs, cfg, card)
    part("(b), the keyframe service's BA")
    check_multiseq_steps(dev, seqs, cfg, card)
    part("(b), the check run")
    check_multiseq_world(dev, ms, card)
    part("(c), the world circuits")
    return numbers, launches["lk_pyramid_batched"]


# ---------------------------------------------------------------------------
# Phase dist: multi-device (parallel/), one rank on the card, two Gloo ranks
# on the card, and the mesh= facades.
# ---------------------------------------------------------------------------

# (a)/(b) inputs: the loop database at its full size (1536 keyframe rows of
# 1064-float CALC descriptors), a pose graph of the endurance run's size
# (195 valid vertices in 1536 rows, 1.25 laps of a 30 m circle with 3 loop
# edges; PR 9's run had 195 KFs), and a BA window at the backend's shapes
# (W=7 keyframes, N=400 feature slots, C=W*N landmark slots), each laid out
# for two shards.
DIST_K, DIST_D, DIST_QUERY, DIST_REVISIT, DIST_GAP = 1536, 1064, 1200, 300, 20
DIST_PGO_VERTICES, DIST_PGO_GN, DIST_PGO_CG = 195, 3, 512
DIST_BA_W, DIST_BA_N = 7, 400
DIST_RANKS = 2
# Two Gloo ranks against one rank on NCCL: the CPU tests' tolerances against
# JAX (tests/test_torch_parallel.py): scores 1e-5, poses 2e-3.
DIST_SCORE_TOL, DIST_POSE_TOL, DIST_BA_GT_TOL = 1e-5, 2e-3, 5e-3
DIST_RANK_TIMEOUT_S = 300
# (c) StereoSlam(mesh=make_mesh()) over phase loop's circuit runs the
# asynchronous BA (inline_ba=False), so it is another run than phase loop's
# (79, 2, 0.129): (keyframes, loop edges, frame ATE in m), pinned from a run
# on an NVIDIA H100 80GB HBM3; it repeats bit for bit, as phase loop's does.
# Its frames track the pre-BA map until the BA is swapped in, so it moved
# from the synchronous BA at retire's (82, 2, 0.1703).
DIST_MIN_EDGE_GAP = 20
EXPECTED_DIST_LOOP_RUN = (83, 2, 0.2338)


def dist_pose_graph(seed: int = 0) -> dict:
    """A drifted circle of DIST_PGO_VERTICES keyframes over 1.25 laps in
    DIST_K rows: odometry edges with 0.01 noise, loop edges from three late
    keyframes to the ones they revisit (ground truth), KF 0 and the last 7
    (the active window) fixed; numpy arrays of a PoseGraph."""
    from stereoslam_tpu_torch.ops import se3

    rng = np.random.default_rng(seed)
    n, K = DIST_PGO_VERTICES, DIST_K
    per_lap = n / 1.25
    gt = []
    for i in range(n):
        c, s = np.cos(2 * np.pi * i / per_lap), np.sin(2 * np.pi * i / per_lap)
        T_wc = np.eye(4)
        T_wc[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T_wc[:3, 3] = [30.0 * (1 - c), 0, 30.0 * s]
        gt.append(np.linalg.inv(T_wc))
    gt = np.stack(gt).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    meas = np.tile(np.eye(4, dtype=np.float32), (2 * K, 1, 1))
    edge_i = np.concatenate([np.arange(K), np.arange(K)]).astype(np.int32)
    edge_j = np.zeros(2 * K, np.int32)
    edge_valid = np.zeros(2 * K, bool)
    poses[0] = gt[0]
    for i in range(1, n):
        noise = se3.exp(torch.from_numpy((rng.standard_normal(6) * 0.01).astype(np.float32)))
        meas[i] = noise.numpy() @ gt[i] @ np.linalg.inv(gt[i - 1])
        poses[i] = meas[i] @ poses[i - 1]
        edge_j[i], edge_valid[i] = i - 1, True
    for i in (160, 175, 190):
        j = int(round(i - per_lap))
        meas[K + i] = gt[i] @ np.linalg.inv(gt[j])
        edge_j[K + i], edge_valid[K + i] = j, True
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fixed[n - 7:] = True
    return dict(poses=poses, vertex_valid=np.arange(K) < n, fixed=fixed, edge_i=edge_i,
                edge_j=edge_j, edge_meas=meas, edge_valid=edge_valid)


def dist_ba_problem(seed: int = 0):
    """tests/test_parallel.py's make_ba_problem at the window's shapes, laid
    out for DIST_RANKS shards (observation column block s references
    landmark block s): numpy arrays of a BAProblem, the true poses, and the
    intrinsics (fx, fy, cx, cy)."""
    from stereoslam_tpu_torch.ops import se3
    from stereoslam_tpu_torch.ops.camera import Intrinsics, world2pixel

    rng = np.random.default_rng(seed)
    W, N = DIST_BA_W, DIST_BA_N
    C = W * N
    intr = (400.0, 400.0, 320.0, 160.0)
    Cl, Nl = C // DIST_RANKS, N // DIST_RANKS
    xi = np.zeros((W, 6), np.float32)
    xi[:, 2] = -np.arange(W) * 0.4
    cam_gt = se3.exp(torch.from_numpy(xi)).numpy()
    X_gt = rng.uniform([-6, -3, 5], [6, 3, 25], (C, 3)).astype(np.float32)
    obs_lm = np.zeros((W, N), np.int32)
    for s in range(DIST_RANKS):
        obs_lm[:, s * Nl:(s + 1) * Nl] = rng.integers(s * Cl, (s + 1) * Cl, (W, Nl))
    px = np.stack([world2pixel(torch.from_numpy(X_gt[obs_lm[w]]), torch.from_numpy(cam_gt[w]),
                               Intrinsics.create(*intr)).numpy() for w in range(W)])
    valid = (px[..., 0] > 0) & (px[..., 0] < 640) & (px[..., 1] > 0) & (px[..., 1] < 320)
    dxi = (rng.standard_normal((W, 6)) * 0.01).astype(np.float32)
    dxi[0] = 0
    cam0 = (se3.exp(torch.from_numpy(dxi)) @ torch.from_numpy(cam_gt)).numpy()
    X0 = X_gt + rng.normal(0, 0.03, X_gt.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[::7] = True
    X0[fixed] = X_gt[fixed]
    prob = dict(cam_T=cam0, cam_valid=np.ones(W, bool), cam_fixed=np.zeros(W, bool), lm_pos=X0,
                lm_valid=np.ones(C, bool), lm_fixed=fixed, obs_px=px.astype(np.float32),
                obs_lm=obs_lm, obs_valid=valid)
    return prob, cam_gt, intr


def dist_search_inputs() -> dict:
    """The full-size database: unit rows, a revisit of the query at
    DIST_REVISIT, rows inserted up to the query."""
    g = torch.Generator().manual_seed(5)
    db = torch.randn(DIST_K, DIST_D, generator=g)
    db[DIST_REVISIT] = db[DIST_QUERY] + 0.3 * torch.randn(DIST_D, generator=g)
    db = db / db.norm(dim=1, keepdim=True)
    return dict(db=db.numpy(), valid=(np.arange(DIST_K) <= DIST_QUERY),
                q=db[DIST_QUERY].numpy().copy())


def dist_ops(mesh, dev, inputs: dict) -> dict:
    """The three sharded ops on this rank's mesh; results as numpy."""
    from stereoslam_tpu_torch import bridge
    from stereoslam_tpu_torch.ops.camera import Intrinsics
    from stereoslam_tpu_torch.parallel.dist_ba import solve_window_ba_sharded
    from stereoslam_tpu_torch.parallel.dist_lcd import sharded_descriptor_search
    from stereoslam_tpu_torch.parallel.dist_pgo import optimize_pose_graph_sharded

    s = inputs["search"]
    r = sharded_descriptor_search(torch.from_numpy(s["db"]).to(dev),
                                  torch.from_numpy(s["valid"]).to(dev),
                                  torch.from_numpy(s["q"]).to(dev), DIST_QUERY - DIST_GAP + 1,
                                  0.05, mesh)
    graph = bridge.pose_graph_from_numpy(inputs["pgo"], dev)
    poses = optimize_pose_graph_sharded(graph, mesh, gn_iters=DIST_PGO_GN, cg_iters=DIST_PGO_CG)
    prob = bridge.ba_problem_from_numpy(inputs["ba"], dev)
    ba = solve_window_ba_sharded(prob, Intrinsics.create(*inputs["intr"]), mesh)
    return {"search": np.array([float(r.best_id), float(r.best_score), float(r.n_suspect)]),
            "pgo": poses.cpu().numpy(), "ba": ba.cam_T.cpu().numpy()}


def dist_gloo_rank(rank: int, store: str, inputs_path: str, out_path: str) -> None:
    """(b) One of DIST_RANKS ranks on the one card over Gloo (NCCL refuses
    two ranks on one device): the same ops on the same inputs, saved."""
    from stereoslam_tpu_torch.parallel.distributed import initialize
    from stereoslam_tpu_torch.parallel.mesh import make_mesh

    initialize(init_method=f"file://{store}", world_size=DIST_RANKS, rank=rank,
               backend="gloo", device="cuda")
    mesh = make_mesh()
    with np.load(inputs_path, allow_pickle=True) as f:
        inputs = f["inputs"].item()
    out = dist_ops(mesh, torch.device("cuda", torch.cuda.current_device()), inputs)
    torch.cuda.synchronize()
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


def ba_gt_err(cam_T: np.ndarray, cam_gt: np.ndarray) -> float:
    from stereoslam_tpu_torch.ops import se3

    return float(se3.log(torch.from_numpy(cam_T.astype(np.float64))
                         @ se3.inv(torch.from_numpy(cam_gt.astype(np.float64)))).abs().max())


def events_ms(fn) -> float:
    """Milliseconds of one call between two CUDA events after a warm-up
    call: the device's time where the call reads nothing back (its enqueue,
    where the host is slower)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def check_dist_one_rank(dev, mesh, inputs: dict, card: str) -> dict:
    """(a) One rank, NCCL: each sharded op against its dense twin."""
    from stereoslam_tpu_torch import bridge
    from stereoslam_tpu_torch.ops.pgo import optimize_pose_graph
    from stereoslam_tpu_torch.parallel.mesh import axis_size

    if axis_size(mesh, "model") != 1 or torch.distributed.get_backend() != "nccl":
        fail("dist", "(a) mesh", f"{mesh} on {torch.distributed.get_backend()}")
    out = dist_ops(mesh, dev, inputs)
    s = inputs["search"]
    db, q = torch.from_numpy(s["db"]).to(dev), torch.from_numpy(s["q"]).to(dev)
    valid = torch.from_numpy(s["valid"]).to(dev)
    ids = torch.arange(DIST_K, device=dev)

    def dense_scan():
        scores = db @ q
        scores = torch.where(valid & ((DIST_QUERY - ids) >= DIST_GAP), scores,
                             torch.full_like(scores, -1.0))
        best = torch.argmax(scores)
        return best, scores[best], (scores > 0.05).to(torch.int32).sum()

    best, score, n_sus = dense_scan()
    dense = np.array([float(best), float(score), float(n_sus)])
    if not (np.array_equal(out["search"], dense) and int(best) == DIST_REVISIT):
        fail("dist", "(a) search", f"sharded (id, score, suspects) {out['search'].tolist()} against "
             f"the dense scan's {dense.tolist()} (planted revisit {DIST_REVISIT})")
    graph = bridge.pose_graph_from_numpy(inputs["pgo"], dev)
    dense_pgo = optimize_pose_graph(graph, gn_iters=DIST_PGO_GN, cg_iters=DIST_PGO_CG,
                                    cg_rtol=1e-12, gn_xtol=-1).cpu().numpy()
    if not np.array_equal(out["pgo"], dense_pgo):
        fail("dist", "(a) pgo", f"sharded PGO differs from optimize_pose_graph(cg_rtol=1e-12, "
             f"gn_xtol=-1) by {np.abs(out['pgo'] - dense_pgo).max():.3e}")
    err = ba_gt_err(out["ba"], inputs["cam_gt"])
    if not err < DIST_BA_GT_TOL:
        fail("dist", "(a) ba", f"sharded BA's cameras {err:.3e} from the truth (< {DIST_BA_GT_TOL})")

    from stereoslam_tpu_torch.ops.camera import Intrinsics
    from stereoslam_tpu_torch.parallel.dist_ba import solve_window_ba_sharded
    from stereoslam_tpu_torch.parallel.dist_lcd import sharded_descriptor_search
    from stereoslam_tpu_torch.parallel.dist_pgo import optimize_pose_graph_sharded

    prob = bridge.ba_problem_from_numpy(inputs["ba"], dev)
    intr = Intrinsics.create(*inputs["intr"])
    times = {
        "search": eager_ms(lambda: sharded_descriptor_search(
            db, valid, q, DIST_QUERY - DIST_GAP + 1, 0.05, mesh), launches=50),
        "dense scan": eager_ms(dense_scan, launches=50),
        "pgo": events_ms(lambda: optimize_pose_graph_sharded(
            graph, mesh, gn_iters=DIST_PGO_GN, cg_iters=DIST_PGO_CG)),
        "ba": events_ms(lambda: solve_window_ba_sharded(prob, intr, mesh)),
    }
    t0 = time.perf_counter()
    optimize_pose_graph(graph, gn_iters=DIST_PGO_GN, cg_iters=DIST_PGO_CG, cg_rtol=1e-12,
                        gn_xtol=-1)
    torch.cuda.synchronize()
    times["dense pgo (host wall)"] = (time.perf_counter() - t0) * 1e3
    print(f"dist: (a) one rank, NCCL: search over {DIST_K}x{DIST_D} (id {int(out['search'][0])}, "
          f"score {out['search'][1]:.6f}, {int(out['search'][2])} suspects) equal to the dense "
          f"scan; sharded PGO ({DIST_PGO_VERTICES} vertices in {DIST_K} rows, {2 * DIST_K} edge "
          f"rows, {DIST_PGO_GN} GN x {DIST_PGO_CG} CG) bit for bit the dense solver's; sharded "
          f"BA (W={DIST_BA_W}, N={DIST_BA_N}, 5x10 iterations) cameras {err:.2e} from the truth; "
          "ms: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) +
          f" (search and scan: CUDA events over 50 eager calls; pgo, ba: one call) [{card}]",
          flush=True)
    return out


def check_dist_gloo(one: dict, inputs: dict, card: str) -> None:
    """(b) DIST_RANKS ranks on the one card over Gloo, in processes of their
    own, held to (a) within the CPU tests' tolerances."""
    import multiprocessing

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    d = Path(work.name)
    np.savez(d / "inputs.npz", inputs=np.array(inputs, dtype=object))
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dist_gloo_rank, args=(r, str(d / "store"), str(d / "inputs.npz"),
                                                      str(d / f"out{r}.npz")))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_RANK_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if alive:
        fail("dist", "(b) gloo", f"ranks {alive} still running after {DIST_RANK_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        fail("dist", "(b) gloo", f"rank exit codes {codes}")
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(DIST_RANKS)]
    work.cleanup()
    wall = time.perf_counter() - t0
    worst = {}
    for r, o in enumerate(outs):
        if not (o["search"][0] == one["search"][0] and o["search"][2] == one["search"][2]
                and abs(o["search"][1] - one["search"][1]) <= DIST_SCORE_TOL):
            fail("dist", "(b) search", f"rank {r}: {o['search'].tolist()} against one rank's "
                 f"{one['search'].tolist()}")
        for k in ("pgo", "ba"):
            worst[k] = max(worst.get(k, 0.0), float(np.abs(o[k] - one[k]).max()))
        if not np.array_equal(o["pgo"], outs[0]["pgo"]) or not np.array_equal(o["ba"], outs[0]["ba"]):
            fail("dist", "(b) replicated", f"rank {r}'s result differs from rank 0's")
    if not (worst["pgo"] <= DIST_POSE_TOL and worst["ba"] <= DIST_POSE_TOL):
        fail("dist", "(b) tolerance", f"max |d| against one rank: {worst} (<= {DIST_POSE_TOL})")
    print(f"dist: (b) {DIST_RANKS} Gloo ranks on one card: search equal, PGO max |d pose| "
          f"{worst['pgo']:.3e}, BA max |d cam_T| {worst['ba']:.3e} against one rank; ranks' "
          f"results identical; {wall:.1f} s with the ranks' start-up [{card}]", flush=True)


def check_dist_slam(dev, card: str) -> int:
    """(c) StereoSlam(mesh=make_mesh()) over phase loop's circuit."""
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.models.calc import DescriptorModel
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.parallel.mesh import make_mesh
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    seq = loop_sequence()
    cfg = loop_config(seq)
    slam = StereoSlam(cfg, device=dev, enable_loop=True, descriptor_model=DescriptorModel(),
                      mesh=make_mesh())
    if slam.inline_ba:
        fail("dist", "(c) inline_ba", "a mesh must move the BA to retire")
    closer = slam._loop_closer
    closer.stage_times = True
    n = len(seq.left)
    reset_counters()
    t0 = time.perf_counter()
    for t in range(n):
        if not slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]):
            fail("dist", "(c) LOST", f"tracking LOST at frame {t}")
    edges = slam.loop_edges
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = L.lk_pyramid.launches
    per_level = K.lk_level.launches + K.lk_final_error.launches
    n_kf = int(slam.map.n_kf)
    ids, T = slam.frame_trajectory()
    gt = np.linalg.inv(seq.T_cw.astype(np.float64))
    ate = ate_rmse(np.linalg.inv(T.astype(np.float64)), gt[ids], align=False)
    fid = slam.map.kf_frame_id[:n_kf].cpu().numpy()
    gaps = [(c, lp, c - lp, float(np.linalg.norm(gt[fid[c]][:3, 3] - gt[fid[lp]][:3, 3])))
            for c, lp in edges]
    times = closer.times
    run = (n_kf, len(edges), round(ate, 4))
    print(f"dist: (c) StereoSlam(mesh=make_mesh()) over the loop circuit ({n} frames 1241x376): "
          f"{n / wall:.2f} FPS, (KFs, edges, ATE) {run}, edges (cur, loop, id gap, ground-truth m) "
          f"{gaps}, lk_pyramid launches {launches} ({launches / (n - 1):.2f}/tracked frame), "
          f"per-level {per_level}; corrections (host wall ms, sharded PGO GN/CG): "
          f"{[round(v * 1e3, 1) for v in times.get('correct', [])]}, "
          f"{list(zip(times.get('pgo_gn', []), times.get('pgo_cg', [])))}; detect median "
          f"{np.median(times['detect']) * 1e3 if times.get('detect') else float('nan'):.2f} ms "
          f"[{card}]", flush=True)
    if not edges:
        fail("dist", "(c) edges", "no loop edge")
    for c, lp, gap, dist in gaps:
        if gap < DIST_MIN_EDGE_GAP or dist >= MAX_LOOP_GT_M:
            fail("dist", "(c) edges", f"edge {c}->{lp}: id gap {gap}, ground truth {dist:.2f} m")
    if not ate <= MAX_LOOP_ATE_M:
        fail("dist", "(c) ATE", f"frame ATE {ate:.4f} m exceeds {MAX_LOOP_ATE_M} m")
    if launches < n - 1 or per_level:
        fail("dist", "(c) launches", f"lk_pyramid {launches} for {n - 1} tracked frames, "
             f"per-level {per_level}")
    if run != EXPECTED_DIST_LOOP_RUN:
        fail("dist", "(c) repeat", f"(KFs, edges, ATE) = {run}, expected {EXPECTED_DIST_LOOP_RUN}")
    check_dist_correction(slam, edges[-1], card)
    return launches


def check_dist_correction(slam, edge, card: str) -> None:
    """(c) The run's verified loops needed no correction, so, as phase loop's
    check_correction does, the correction stage is applied at the last edge
    on the final state: through the mesh closer (the sharded PGO, the
    config's 30 GN x 512 CG steps in full) and through a mesh-less closer
    (the dense PGO with its early exits), same verdict and merge, poses
    within phase loop's card-vs-CPU bounds."""
    from stereoslam_tpu_torch.core.loopclosing import LoopCloser

    closer = slam._loop_closer
    kf, loop_kf = edge
    verify, _, m_v = closer._verify_impl(slam.map, slam.loop, kf, loop_kf)
    T, pairs = verify.T_corrected, verify.match_loop_feat
    dense_closer = LoopCloser(slam.cfg, closer.intr, slam.device, descriptor_model=closer.model)
    out = {}
    for name, c in (("sharded", closer), ("dense", dense_closer)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, _, remap, packed = c._correct_impl(m_v, slam.loop, kf, loop_kf, T, pairs)
        packed = packed.cpu().numpy()
        out[name] = (m, remap, packed, (time.perf_counter() - t0) * 1e3,
                     c.times["pgo_gn"][-1], c.times["pgo_cg"][-1])
    (ms, rs, ps, ts, gs, cs), (md, rd, pd, td, gd, cd) = out["sharded"], out["dense"]
    d_pose = (ms.kf_T_cw - md.kf_T_cw).abs().max().item()
    d_pos = (ms.lm_pos - md.lm_pos)[md.lm_valid].abs().max().item()
    same_merge = torch.equal(rs, rd) and torch.equal(ms.kf_feat_lm, md.kf_feat_lm)
    print(f"dist: (c) correction at edge {kf}->{loop_kf} on the final state: sharded PGO "
          f"{gs} GN / {cs} CG, {ts:.1f} ms host wall, applied {bool(ps[0])}, mean edge residual "
          f"{ps[1]:.2e}; dense PGO {gd} GN / {cd} CG, {td:.1f} ms, applied {bool(pd[0])}; max |d "
          f"pose| {d_pose:.2e}, max |d landmark| {d_pos:.2e} m, merge "
          f"{'identical' if same_merge else 'DIFFERS'} [{card}]", flush=True)
    if not (bool(ps[0]) and bool(pd[0]) and same_merge and d_pose <= 2e-3 and d_pos <= 2e-2):
        fail("dist", "(c) correction", "the sharded correction disagrees with the dense one")


def check_dist_multiseq(dev, card: str) -> int:
    """(d) MultiSeqVO(mesh=make_mesh(dp=1)) at bench.py Phase M: every
    sequence as in phase multiseq's pinned run, one replay a step."""
    from stereoslam_tpu_torch.ops import lk as L
    from stereoslam_tpu_torch.parallel.mesh import make_mesh
    from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO
    from stereoslam_tpu_torch.utils.feed import BatchFeed

    seqs = multiseq_sequences()
    cfg = multiseq_config()
    B = MS_BATCH
    stack = lambda t, f: np.stack([getattr(q, f)[t] for q in seqs])  # noqa: E731
    vo = MultiSeqVO(cfg, batch=B, device=dev, mesh=make_mesh(dp=1))
    vo.initialize(stack(0, "left"), stack(0, "right"), np.zeros(B))
    reset_counters()
    t0 = time.perf_counter()
    for t in range(1, MS_WARMUP):
        vo.process_frames(stack(t, "left"), stack(t, "right"), np.full(B, t * 0.1))
    feed = BatchFeed(((stack(t, "left"), stack(t, "right"), np.full(B, t * 0.1))
                      for t in range(MS_WARMUP, MS_FRAMES)), device=dev)
    for lr, ts in feed:
        vo.process_staged(lr, ts)
    vo.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batched = L.lk_pyramid.batched_launches
    steps = MS_FRAMES - 1
    n_kf = vo.maps.n_kf.cpu().numpy()
    ms = multiseq_world_script()
    run = tuple((int(n_kf[b]), round(ms.kf_ate(vo, b, seqs[b]), 4)) for b in range(B))
    print(f"dist: (d) MultiSeqVO(mesh=make_mesh(dp=1)), Phase M B={B} x {MS_FRAMES} frames: "
          f"{B * steps / wall:.2f} aggregate FPS, {vo.graph.replays} replays for {steps} steps, "
          f"batched lk_pyramid launches {batched}; (KFs, ATE) {run} [{card}]", flush=True)
    if vo.graph.replays != steps:
        fail("dist", "(d) graph", f"{vo.graph.replays} graph replays for {steps} steps")
    if run != EXPECTED_MULTISEQ_RUN:
        fail("dist", "(d) repeat", f"(KFs, ATE) per sequence = {run}, expected the unsharded "
             f"run's {EXPECTED_MULTISEQ_RUN}")
    return batched


def phase_dist(dev, card: str):
    """Multi-device on the card: (a) the sharded ops on one NCCL rank against
    their dense twins, (b) two Gloo ranks on the card against (a), (c)
    StereoSlam(mesh=...) over the loop circuit, (d) MultiSeqVO(mesh=...) at
    Phase M."""
    from stereoslam_tpu_torch.parallel.mesh import make_mesh

    prob, cam_gt, intr = dist_ba_problem()
    inputs = {"search": dist_search_inputs(), "pgo": dist_pose_graph(), "ba": prob,
              "cam_gt": cam_gt, "intr": intr}
    t_part = [time.perf_counter()]

    def part(name):
        t_part.append(time.perf_counter())
        print(f"dist: {name} took {t_part[-1] - t_part[-2]:.1f} s", flush=True)

    one = check_dist_one_rank(dev, make_mesh(), inputs, card)
    part("(a)")
    check_dist_gloo(one, inputs, card)
    part("(b)")
    launches = check_dist_slam(dev, card)
    part("(c)")
    batched = check_dist_multiseq(dev, card)
    part("(d)")
    # The card's world of one ends with the phase, after the graphs that
    # captured its NCCL sums are freed (the facades hold reference cycles).
    gc.collect()
    torch.cuda.synchronize()
    torch.distributed.destroy_process_group()
    return launches, batched


def phase_profile(dev, seq, n_frames: int, card: str) -> None:
    """Device busy share and the top CUDA kernels over frames
    [WARMUP, WARMUP + n_frames) of a second run of the main path."""
    from torch.profiler import ProfilerActivity, profile

    from stereoslam_tpu_torch.core.system import StereoSlam

    slam = StereoSlam(kitti_config(seq), device=dev, enable_loop=False)
    for t in range(WARMUP):
        slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(WARMUP, WARMUP + n_frames):
            slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile: {n_frames} frames, wall {wall * 1e3:.1f} ms under the profiler, device "
          f"kernel time {dev_ms:.1f} ms ({dev_ms / n_frames:.2f} ms/frame), {len(kernels)} distinct "
          f"kernels, {sum(e.count for e in kernels)} launches [{card}]", flush=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=25), flush=True)
    for e in kernels:
        if "lk_" in e.key:
            print(f"profile: {e.key}: {e.count} launches, self device time "
                  f"{e.self_device_time_total / max(e.count, 1):.2f} us/launch", flush=True)

    # Host syncs per frame, by the frame's kind: the sync-debug mode's
    # reports plus the facade's outcome reads (an event wait, which the mode
    # does not see).  The frames are staged before the count.
    t_end = min(WARMUP + 2 * n_frames, len(seq.left))
    by_kind = {}
    for t in range(WARMUP + n_frames, t_end):
        lr = torch.from_numpy(np.stack([seq.left[t], seq.right[t]]).astype(np.uint8)).to(dev)
        before = (int(slam.map.n_kf), int(slam.map.n_lm))
        reads = slam.outcome_reads
        torch.cuda.synchronize()
        with SyncCount() as sc:
            slam.process_staged(lr, seq.timestamps[t])
        kind = frame_kind(before, (int(slam.map.n_kf), int(slam.map.n_lm)))
        by_kind.setdefault(kind, []).append(sc.n + slam.outcome_reads - reads)
    print("profile: host syncs per frame: " + "; ".join(
        f"{kind} frames {np.mean(v):.1f} over {len(v)}" for kind, v in sorted(by_kind.items())),
        flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    ap.add_argument("--phases", default="", metavar="A,B",
                    help="run only these phases after kernels and main (a check of a few "
                         "phases: it prints no result lines)")
    args = ap.parse_args()
    only = set(args.phases.split(",")) if args.phases else None

    def phase(name: str, fn, *a):
        return run_phase(name, fn, *a) if only is None or name in only else None

    if not torch.cuda.is_available():
        fail("device", "CUDA", "no CUDA device: the port's smoke run needs an NVIDIA GPU")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: "
          f"{card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    import stereoslam_tpu_torch  # noqa: F401  (pins fp32 matmuls)
    from stereoslam_tpu_torch.ops import lk_level as K

    t0 = time.perf_counter()
    lib = K.build_library()
    K._library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    seq = kitti_sequence()
    print(f"data: {N_FRAMES} synthetic frames 376x1241 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    numbers = run_phase("kernels", phase_kernels, dev, seq, card)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    launches, main_slam = run_phase("main", phase_main, dev, seq, Path(work.name), card)
    phase("pipeline", phase_pipeline, dev, seq, main_slam, card)
    ba_launches = phase("ba", phase_ba, dev, seq, main_slam, card)
    phase("cli", phase_cli, dev, seq, main_slam, Path(work.name), card)
    del main_slam
    work.cleanup()
    undistort_launches = phase("undistort", phase_undistort, dev, seq, card)
    phase("calc", phase_calc, dev, seq.left[0], card)
    phase("train", phase_train, dev, card)
    phase("caffe", phase_caffe, dev, seq, card)
    phase("loop", phase_loop, dev, card)
    worst_world = phase("world", phase_world, dev, card)
    endurance_launches = phase("endurance", phase_endurance, dev, card)
    batched = phase("multiseq", phase_multiseq, dev, card)
    dist_launches = phase("dist", phase_dist, dev, card)
    if args.profile:
        run_phase("profile", phase_profile, dev, seq, min(args.profile, len(seq.left) - WARMUP),
                  card)
    if only is not None:
        print(f"phases {sorted(only)} after kernels and main: done (no result lines)", flush=True)
        return
    numbers["lk_pyramid"]["max_abs_err"] = max(numbers["lk_pyramid"]["max_abs_err"], worst_world)
    numbers["lk_pyramid_batched"], launches["lk_pyramid_batched"] = batched

    kernels = [
        {"name": name, "route": "cuda", "source": "stereoslam_tpu_torch/csrc/lk_level.cu",
         "replaces": replaces,
         "launches": launches[name], **numbers[name]}
        for name, replaces in (("lk_pyramid", "stereoslam_tpu/ops/lk_pallas.py:185"),
                               ("lk_level", "stereoslam_tpu/ops/lk_pallas.py:185"),
                               ("lk_final_error", "stereoslam_tpu/ops/lk_batched.py:137"),
                               ("lk_pyramid_batched", "stereoslam_tpu/ops/lk_pallas.py:185"))
    ]
    print(f"launches: lk_pyramid on phase main {launches['lk_pyramid']}, ba (b) {ba_launches}, "
          f"undistort "
          f"{undistort_launches}, endurance (a) {endurance_launches}, dist (c) "
          f"{dist_launches[0]}, lk_pyramid_batched on dist (d) {dist_launches[1]}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
