"""Cells small enough for a CPU test run: the repository's cell, and an
online ``StereoSlam`` cell on its configuration (``ONLINE``: the benchmark
has no such cell yet, and its drive is tested here), with the world, the
image and the windows shrunk (120x188 images, a 40 x 24 m block, 3 m a
frame, a BA on every keyframe, no replenishment), the limits kept."""

from __future__ import annotations

import copy
import dataclasses

from slambench import spec

TINY_WORLD = dict(length=40.0, width=24.0, street_half=5.0, corner_radius=8.0, step=3.0)


def _tiny_slam(slam: dict) -> dict:
    from stereoslam_tpu_torch.config import SlamConfig

    from slambench.harness import slam_config

    cfg = slam_config({"slam": slam})
    cam = dataclasses.replace(cfg.camera, fx=160.0, fy=160.0, fx_right=160.0, fy_right=160.0,
                              cx=94.0, cy=60.0, cx_right=94.0, cy_right=60.0, bf=160.0 * 0.54)
    cfg = SlamConfig(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                        "camera": cam, "image_height": 120, "image_width": 188})
    return dataclasses.asdict(cfg.scaled_for_resolution())


ONLINE = "tiny-stereo.online"


def _online():
    """One vehicle through ``StereoSlam`` on the fleet's configuration: each
    frame synchronised before the next, lag 0, inline BA."""
    cfg = copy.deepcopy(spec.config("fleet-b8"))
    cfg.update(name="tiny-stereo", system="StereoSlam",
               system_args=dict(enable_loop=False, inline_ba=True))
    c = dict(name=ONLINE, config="tiny-stereo", traffic="online", why="tests",
             drive=dict(loop="closed", streams=1, start=0.0, readback_lag=0,
                        warmup_frames_min=8, warmup_frames_max=80),
             check=dict(track_span=40, track_samples=6, ba_span=12, ba_samples=4,
                        limits=dict(track_pose_gap_m=0.002, ba_pose_gap_m=0.001,
                                    ba_point_gap_m=0.01, tri_gap=0.001)))
    return c, cfg


def cell(name: str):
    """(BENCHMARK.json, the cell's file, its configuration's file), shrunk."""
    bench = spec.benchmark()
    if name == ONLINE:
        c, cfg = _online()
        bench["workloads"].append(dict(name=ONLINE, config=c["config"], traffic=c["traffic"],
                                       chips=1, why=c["why"]))
    else:
        c = copy.deepcopy(spec.workload(name))
        cfg = copy.deepcopy(spec.config(c["config"]))
    cfg["world"].update(TINY_WORLD)
    cfg["slam"] = _tiny_slam(cfg["slam"])
    cfg["slam"]["backend"]["ba_min_frame_spacing"] = 1  # a BA on every keyframe
    # No replenishment: the shrunk drive loses its track before one comes.
    cfg["slam"]["tracking"]["replenish_min_inliers"] = 0
    c["drive"].update(warmup_frames_min=2, warmup_frames_max=40)
    if cfg["system"] == "MultiSeqVO":
        # Four streams, one keyframe served a step: every step compares at
        # least one stream of each half of the batch.
        c["drive"]["streams"] = 4
        cfg["system_args"]["kf_sub"] = 1
        # Short drives: a window of a few steps starts new ones.
        c["drive"]["drive_frames"] = 5
    c["check"].update(track_span=2, track_samples=2, ba_span=2, ba_samples=2)
    return bench, c, cfg
