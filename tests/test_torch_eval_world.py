"""The port's world evaluation, device feed and checkpoints on the CPU.

- ``run_world_eval(n_frames=60, device="cpu")`` passes the bands of the JAX
  package's plumbing test (tests/test_eval_world.py: at least 55 frames, no
  LOST, ATE under 1 m, kf_rate in [0.05, 0.3], the shipped 0.94 threshold)
  and returns the JAX record's keys and thresholds (those of the committed
  ``EVAL_WORLD.json``).  It skips the loop-OFF pass, which the card run of
  ``chip_smoke.py`` makes, to keep the file's time down.
- From the map that entered that run's third windowed BA (KF 0-2, no fixed
  landmark, so the window's scale is barely observed), the port's BA stays
  within 0.5 m of the JAX package's float32 BA and of the ground truth.
- ``_traj_ate`` and the edge ground-truth distance equal the JAX package's on
  the same arrays.
- A checkpoint of a short JAX run loads into the port field for field, and a
  port checkpoint loads into the JAX package the same way.
- A port run resumed from its own checkpoint continues exactly as the run
  that wrote it.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu import config as jconfig  # noqa: E402
from stereoslam_tpu import eval as jeval  # noqa: E402
from stereoslam_tpu.core import backend as jbackend  # noqa: E402
from stereoslam_tpu.core.state import MapState as JMapState  # noqa: E402
from stereoslam_tpu.core.system import StereoSlam as JaxSlam  # noqa: E402
from stereoslam_tpu.ops.camera import Intrinsics as JIntr  # noqa: E402
from stereoslam_tpu.utils import checkpoint as jckpt  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch import eval as peval  # noqa: E402
from stereoslam_tpu_torch.core import backend as pbackend  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.utils import world as pworld  # noqa: E402
from stereoslam_tpu_torch.utils import checkpoint as pckpt  # noqa: E402
from stereoslam_tpu_torch.utils.feed import DeviceFeed  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402

RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "EVAL_WORLD.json")


@pytest.fixture(scope="module")
def world60():
    """The 60-frame world evaluation, with the map that went into each
    windowed BA of its loop-ON run."""
    ba_inputs = []

    def capture(slam):
        ba = slam._ba

        def wrapped(m):
            ba_inputs.append(bridge.map_state_to_numpy(m))
            return ba(m)

        slam._ba = wrapped

    rec = peval.run_world_eval(n_frames=60, device="cpu", vo_baseline=False, on_slam=capture)
    return rec, ba_inputs


def test_world_eval_plumbing_small(world60):
    rec, _ = world60
    assert rec["frames"] >= 55 and rec["lost_at"] is None
    assert rec["ate_m"] < 1.0
    assert 0.05 <= rec["kf_rate"] <= 0.3
    assert rec["thresholds"]["similarity_high"] == 0.94
    with open(RECORD) as f:
        want = json.load(f)
    assert set(rec) == set(want)
    assert rec["thresholds"] == want["thresholds"]
    assert rec["params"] == dict(want["params"], frames=60)
    assert rec["ate_vo_m"] is None and len(rec["edge_gt_dist_m"]) == len(rec["loop_edges"])


def test_startup_window_ba_holds_scale_as_jax_float32(world60):
    """The windowed BA of the third keyframe (frame 13): the window holds
    KF 0-2 and no fixed landmark, so only KF 0 anchors the gauge and the
    scale is barely observed.  From the same map, the port's BA keeps every
    window keyframe within 0.5 m of the JAX package's float32 BA and of the
    ground truth (a float64 solve with the damping let down to 1e-8, as the
    JAX package's under x64, moves KF 2 by metres)."""
    _, ba_inputs = world60
    m_np = next(m for m in ba_inputs if int(m["n_kf"]) == 3)
    win = m_np["active_kf"][m_np["active_kf"] >= 0]
    assert win.tolist() == [0, 1, 2]

    def cfg(mod):
        cam = mod.CameraConfig(fx=320.0, fy=320.0, cx=188.0, cy=120.0, fx_right=320.0,
                               fy_right=320.0, cx_right=188.0, cy_right=120.0, bf=320.0 * 0.54)
        return mod.SlamConfig(camera=cam, image_height=240, image_width=376).scaled_for_resolution()

    jcfg, pcfg = cfg(jconfig), cfg(pconfig)
    jintr = JIntr.create(320.0, 320.0, 188.0, 120.0)
    mj = jax.jit(lambda m: jbackend.optimize_active_map(m, jintr, jcfg))(
        JMapState(**{k: jnp.asarray(v) for k, v in m_np.items()}))
    intr, _ = bridge.intrinsics_from_config(pcfg)
    mp = pbackend.optimize_active_map(bridge.map_state_from_numpy(m_np, "cpu"), intr, pcfg)

    def centers(T):
        return np.linalg.inv(np.asarray(T, np.float64)[win])[:, :3, 3]

    T_wc = pworld.circuit_poses(60, peval.WORLD_STEP, peval.WORLD_LENGTH, peval.WORLD_WIDTH, 14.0)
    gt = (np.linalg.inv(T_wc[0]) @ T_wc)[m_np["kf_frame_id"][win]][:, :3, 3]
    c_jax, c_port = centers(mj.kf_T_cw), centers(mp.kf_T_cw.numpy())
    assert np.linalg.norm(c_jax - gt, axis=1).max() < 0.5
    assert np.linalg.norm(c_port - c_jax, axis=1).max() < 0.5
    assert np.linalg.norm(c_port - gt, axis=1).max() < 0.5


def test_traj_ate_and_edge_distance_match_jax(rng):
    n = 40
    seq = SimpleNamespace(T_cw=np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)))
    seq.T_cw[:, :3, 3] = rng.normal(size=(n, 3)) * 5.0
    fids = np.sort(rng.choice(n, size=25, replace=False))
    est = seq.T_cw[fids].astype(np.float64).copy()
    est[:, :3, 3] += rng.normal(size=(len(fids), 3)) * 0.3
    slam = SimpleNamespace(frame_trajectory=lambda: (fids, est))
    assert peval._traj_ate(slam, seq) == jeval._traj_ate(slam, seq)

    kf_frame_id = np.sort(rng.choice(n, size=12, replace=False)).astype(np.int32)
    edges = [(11, 0), (9, 2), (5, 5)]
    # The JAX package computes the distances inline in run_world_eval
    # (stereoslam_tpu/eval.py:166-170); this is that code.
    want = []
    for cur, loop in edges:
        g1 = np.linalg.inv(seq.T_cw[kf_frame_id[cur]].astype(np.float64))[:3, 3]
        g2 = np.linalg.inv(seq.T_cw[kf_frame_id[loop]].astype(np.float64))[:3, 3]
        want.append(float(np.linalg.norm(g1 - g2)))
    assert peval._edge_gt_dist(seq.T_cw, kf_frame_id, edges) == want


@pytest.fixture(scope="module")
def small_seq():
    return generate_sequence(n_frames=14, h=120, w=188, n_points=400, seed=3, speed=0.3)


def small_cfg(mod, seq):
    return mod.SlamConfig(
        camera=mod.CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                                fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                                bf=seq.fx * seq.baseline),
        features=mod.FeatureConfig(n_init_features=100, n_new_features=50, max_features=128,
                                   num_features_init_good=20, num_features_tracking_good=20,
                                   num_features_tracking_bad=5),
        map=mod.MapConfig(max_keyframes=32, max_landmarks=2048),
        image_height=120, image_width=188,
    )


def port_run(seq, frames, slam=None):
    slam = slam or StereoSlam(small_cfg(pconfig, seq), device="cpu")
    for t in frames:
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t]), f"LOST at {t}"
    return slam


def state_dict(fs, m, lp, pyr):
    """Flat {checkpoint key: numpy array} of a state, uint32 descriptor words."""
    out = {}
    fs = fs._asdict() if hasattr(fs, "_asdict") else fs
    for k, v in fs.items():
        if k == "tracks":
            tr = v._asdict() if hasattr(v, "_asdict") else v
            out.update({f"frontend.tracks.{j}": np.asarray(x) for j, x in tr.items()})
        else:
            out[f"frontend.{k}"] = np.asarray(v)
    m = m._asdict() if hasattr(m, "_asdict") else m
    lp = lp._asdict() if hasattr(lp, "_asdict") else lp
    out.update({f"map.{k}": np.asarray(v) for k, v in m.items()})
    out.update({f"loop.{k}": np.asarray(v) for k, v in lp.items()})
    out["loop.orb_desc"] = out["loop.orb_desc"].view(np.uint32)
    out.update({f"pyr.{i}": np.asarray(x) for i, x in enumerate(pyr)})
    return out


def assert_same_fields(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path, small_seq):
    seq = small_seq
    jslam = JaxSlam(small_cfg(jconfig, seq), enable_loop=True)
    for t in range(3):
        assert jslam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    jpath = jslam.save_checkpoint(str(tmp_path / "jax.npz"))
    with np.load(jpath) as z:
        jax_file = {k: z[k] for k in z.files}
    assert int(jax_file["map.n_kf"]) >= 1 and jax_file["loop.orb_desc"].any()

    fs, m, lp, pyr, extra = pckpt.load_checkpoint(jpath, "cpu")
    assert extra == {}
    assert lp.orb_desc.dtype == torch.int32
    assert_same_fields(state_dict(bridge.frontend_state_to_numpy(fs), bridge.map_state_to_numpy(m),
                                  bridge.loop_state_to_numpy(lp), bridge.pyramid_to_numpy(pyr)),
                       jax_file)

    # The port writes the same file back, and the JAX package reads it.
    ppath = pckpt.save_checkpoint(str(tmp_path / "port.npz"), fs, m, lp, pyr=pyr)
    with np.load(ppath) as z:
        assert_same_fields({k: z[k] for k in z.files}, jax_file)
    jfs, jm, jlp, jpyr = jckpt.load_checkpoint(ppath)
    assert_same_fields(state_dict(jfs, jm, jlp, jpyr), jax_file)

    # A missing field raises, as in the JAX package.
    del jax_file["map.kf_loop"]
    np.savez(str(tmp_path / "cut.npz"), **jax_file)
    with pytest.raises(KeyError):
        pckpt.load_checkpoint(str(tmp_path / "cut.npz"), "cpu")


def test_port_checkpoint_loads_into_jax(tmp_path, small_seq):
    slam = port_run(small_seq, range(6))
    path = slam.save_checkpoint(str(tmp_path / "port.npz"))
    jfs, jm, jlp, jpyr = jckpt.load_checkpoint(path)
    want = state_dict(bridge.frontend_state_to_numpy(slam.fs), bridge.map_state_to_numpy(slam.map),
                      bridge.loop_state_to_numpy(slam.loop),
                      bridge.pyramid_to_numpy(slam._pyr_prev))
    assert_same_fields(state_dict(jfs, jm, jlp, jpyr), want)
    assert int(jm.n_kf) >= 1


def test_resumed_run_continues_as_the_original(tmp_path, small_seq):
    seq = small_seq
    a = port_run(seq, range(7))
    path = a.save_checkpoint(str(tmp_path / "mid.npz"))
    b = StereoSlam(small_cfg(pconfig, seq), device="cpu")
    b.load_checkpoint(path)
    assert b.status == a.status and b.loop_edges == a.loop_edges
    for x, y in zip(a.keyframe_trajectory(), b.keyframe_trajectory()):
        np.testing.assert_array_equal(x, y)
    port_run(seq, range(7, len(seq.left)), a)
    port_run(seq, range(7, len(seq.left)), b)
    assert_same_fields(
        state_dict(bridge.frontend_state_to_numpy(b.fs), bridge.map_state_to_numpy(b.map),
                   bridge.loop_state_to_numpy(b.loop), bridge.pyramid_to_numpy(b._pyr_prev)),
        state_dict(bridge.frontend_state_to_numpy(a.fs), bridge.map_state_to_numpy(a.map),
                   bridge.loop_state_to_numpy(a.loop), bridge.pyramid_to_numpy(a._pyr_prev)))
    for x, y in zip(a.keyframe_trajectory(), b.keyframe_trajectory()):
        np.testing.assert_array_equal(x, y)
    assert len(a.frame_latency_ms) == len(seq.left) and all(v > 0 for v in a.frame_latency_ms)


def test_device_feed_on_the_cpu_is_a_plain_iterator(small_seq):
    seq = small_seq
    got = list(DeviceFeed(((seq.left[t], seq.right[t], seq.timestamps[t]) for t in range(5)),
                          device="cpu"))
    assert len(got) == 5
    for t, (lr, ts) in enumerate(got):
        assert lr.dtype == torch.uint8 and lr.shape == (2, 120, 188) and lr.device.type == "cpu"
        np.testing.assert_array_equal(lr.numpy(), np.stack([seq.left[t], seq.right[t]]).astype(
            np.uint8))
        assert ts == float(seq.timestamps[t])


def test_entry_points_default_to_the_card(monkeypatch, small_seq):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFeed(iter(()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peval.run_world_eval(n_frames=2, h=120, w=188)
