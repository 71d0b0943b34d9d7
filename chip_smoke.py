"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # the full run: 100 KITTI-geometry frames
    python3 chip_smoke.py --profile 20   # also profile 20 more frames (torch.profiler)

Phases, each printing one line and stopping the run with a non-zero exit on
failure:

1. device  — a CUDA device must be present (there is no CPU fallback); prints
             the ``nvidia-smi`` name and power limit.
2. build   — compiles ``stereoslam_tpu_torch/csrc/lk_level.cu`` for sm_90a.
3. kernels — each kernel against its plain PyTorch version on the card, at the
             main path's shapes (400 FAST corners of a 376x1241 frame, the 4
             pyramid levels; 20 iterations from a zero flow and 10 from a
             seeded one, eps 0.01), with CUDA-event timings of both.
4. main    — ``StereoSlam(cfg, device="cuda", enable_loop=False)`` with inline
             BA over the synthetic KITTI-00-geometry sequence of ``bench.py``
             Phase A; checks no LOST, the keyframe/landmark counts, the
             trajectory error against ground truth, and that every tracked
             frame went through the LK kernel.

The second-to-last line is a JSON object of per-kernel numbers; the last line
is ``{"ok": true, "device": {...}}``.  Only torch, numpy and the port are
imported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

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
N_FRAMES = 100
WARMUP = 12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def phase_kernels(dev, seq, card: str):
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.ops.fast import detect_keypoints
    from stereoslam_tpu_torch.ops.image import build_lk_pyramid

    cfg = kitti_config(seq)
    a = torch.from_numpy(seq.left[0].astype(np.uint8)).to(dev).float()
    b = torch.from_numpy(seq.left[1].astype(np.uint8)).to(dev).float()
    kps = detect_keypoints(a, cfg.features.max_features)
    pts = kps.xy[kps.valid].contiguous()
    if pts.shape[0] != cfg.features.max_features:
        fail(f"expected {cfg.features.max_features} FAST corners, got {pts.shape[0]}")
    # The main path's calls: forward and stereo from a zero flow with lk_iters
    # (stereo and deep rescue reach the 4th level), and forward-backward
    # checks with lk_fb_iters from a non-zero seed, here clamped to 11 px, near
    # the kernel's 12 px clip.
    n_lvl = cfg.tracking.lk_stereo_levels
    pa, pb = build_lk_pyramid(a, n_lvl), build_lk_pyramid(b, n_lvl)
    iters, eps = cfg.tracking.lk_iters, cfg.tracking.lk_eps
    cases = [(lvl, iters, 0.0) for lvl in range(n_lvl)]
    cases += [(lvl, cfg.tracking.lk_fb_iters, 4.0) for lvl in range(n_lvl)]
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
            fail(f"lk_level disagrees with its plain version at level {lvl}, {n_it} iters")
    fk, _ = K.lk_level(pa[0], pb[0], pts, torch.zeros_like(pts), iters, eps)
    ek = K.lk_final_error(pa[0], pb[0], pts, fk)
    ep = K.lk_final_error_plain(pa[0], pb[0], pts, fk)
    err_final = (ek - ep).abs().max().item()
    print(f"kernels: lk_final_error max |d| {err_final:.2e}", flush=True)
    if not err_final < TOL_FINAL_ERROR:
        fail("lk_final_error disagrees with its plain version")

    z = torch.zeros_like(pts)
    t_k = cuda_ms(lambda: K.lk_level(pa[0], pb[0], pts, z, iters, eps))
    t_p = cuda_ms(lambda: K.lk_level_plain(pa[0], pb[0], pts, z, iters, eps))
    t_ek = cuda_ms(lambda: K.lk_final_error(pa[0], pb[0], pts, fk))
    t_ep = cuda_ms(lambda: K.lk_final_error_plain(pa[0], pb[0], pts, fk))
    print(f"kernels: one level 376x1241 x {pts.shape[0]} features, {iters} iters: kernel "
          f"{t_k:.4f} ms, plain {t_p:.4f} ms; final error kernel {t_ek:.4f} ms, plain "
          f"{t_ep:.4f} ms [{card}]", flush=True)
    return {
        "lk_level": {"max_abs_err": worst, "ms": t_k, "plain_ms": t_p},
        "lk_final_error": {"max_abs_err": err_final, "ms": t_ek, "plain_ms": t_ep},
    }


def phase_main(dev, seq, card: str):
    from stereoslam_tpu_torch.core.system import StereoSlam
    from stereoslam_tpu_torch.ops import lk_level as K
    from stereoslam_tpu_torch.utils.metrics import ate_rmse

    cfg = kitti_config(seq)
    slam = StereoSlam(cfg, device=dev, enable_loop=False)
    n = len(seq.left)
    K.lk_level.launches = 0
    K.lk_final_error.launches = 0
    times = []
    t_warm = None
    for t in range(n):
        t0 = time.perf_counter()
        ok = slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not ok:
            fail(f"tracking LOST at frame {t}")
        if t == WARMUP - 1:
            t_warm = time.perf_counter()
    t_end = time.perf_counter()
    launches = {"lk_level": K.lk_level.launches, "lk_final_error": K.lk_final_error.launches}

    n_kf, n_lm = int(slam.map.n_kf), int(slam.map.n_lm)
    ids, T = slam.frame_trajectory()
    if T.shape != (n, 4, 4) or not np.isfinite(T).all():
        fail(f"frame trajectory has shape {T.shape} or non-finite poses")
    gt = np.linalg.inv(seq.T_cw[ids].astype(np.float64))
    ate = ate_rmse(np.linalg.inv(T.astype(np.float64)), gt, align=False)
    tracked = n - 1  # every frame after the stereo-init frame
    fps = (n - WARMUP) / (t_end - t_warm)
    p50 = float(np.median(times[WARMUP:])) * 1e3
    print(f"main: {n} frames 376x1241: {fps:.2f} FPS after {WARMUP} warmup frames, p50 frame "
          f"{p50:.2f} ms [{card}]", flush=True)
    print(f"main: n_kf {n_kf}, n_lm {n_lm}, frame ATE {ate:.4f} m (align=False; the JAX package "
          f"on a CPU at 100 frames: 0.0905 m, 15 KFs), median inliers "
          f"{int(np.median(slam.metrics['num_inliers']))}, lk_level launches {launches['lk_level']}"
          f" ({launches['lk_level'] / tracked:.1f}/tracked frame), lk_final_error launches "
          f"{launches['lk_final_error']}", flush=True)
    if n_kf < 2 or n_lm <= 0:
        fail(f"map did not grow: n_kf {n_kf}, n_lm {n_lm}")
    if launches["lk_level"] < 6 * tracked or launches["lk_final_error"] < 2 * tracked:
        fail(f"the main path bypassed the LK kernel: {launches}")
    if not ate <= MAX_ATE_M:
        fail(f"frame ATE {ate:.4f} m exceeds {MAX_ATE_M} m")
    if not KF_BAND[0] <= n_kf <= KF_BAND[1]:
        fail(f"{n_kf} keyframes outside {KF_BAND}")
    return launches


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

    # Host syncs: torch warns once per synchronizing call in sync-debug mode.
    import warnings

    t_end = min(WARMUP + 2 * n_frames, len(seq.left))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for t in range(WARMUP + n_frames, t_end):
                slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    n_sync_frames = max(t_end - WARMUP - n_frames, 1)
    print(f"profile: {syncs} host syncs over {n_sync_frames} frames "
          f"({syncs / n_sync_frames:.1f}/frame)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs an NVIDIA GPU")
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
    numbers = phase_kernels(dev, seq, card)
    launches = phase_main(dev, seq, card)
    if args.profile:
        phase_profile(dev, seq, min(args.profile, len(seq.left) - WARMUP), card)

    kernels = [
        {"name": name, "route": "cuda", "source": "stereoslam_tpu_torch/csrc/lk_level.cu",
         "replaces": replaces, "launches": launches[name], **numbers[name]}
        for name, replaces in (("lk_level", "stereoslam_tpu/ops/lk_pallas.py:185"),
                               ("lk_final_error", "stereoslam_tpu/ops/lk_batched.py:137"))
    ]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
