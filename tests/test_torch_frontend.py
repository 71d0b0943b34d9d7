"""One frame step, stereo init and the backend BA of the torch port, each
seeded from a bridged JAX state.

A JAX ``StereoSlam`` runs a few frames into ``generate_sequence(n_frames=40,
trajectory="forward", seed=3)`` (the config of tests/test_system_vo.py); the
state it held before a frame goes through ``stereoslam_tpu_torch.bridge`` into
the torch step, and both steps' outputs are compared: equal counts with
``num_inliers`` within +-2, ``T_rk`` within 1e-4, ``tracks.valid`` agreement
>= 99%.  Per-frame poses over a long run are never compared: they diverge
chaotically across backends (PARITY.json).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu import config as jconfig  # noqa: E402
from stereoslam_tpu.core import backend as jbackend  # noqa: E402
from stereoslam_tpu.core.system import StereoSlam as JaxSlam  # noqa: E402
from stereoslam_tpu.ops.camera import Intrinsics as JIntr  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core import backend as pbackend  # noqa: E402
from stereoslam_tpu_torch.core import frontend as pfrontend  # noqa: E402
from stereoslam_tpu_torch.ops.image import build_lk_pyramid  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402

N_RUN = 16  # frames the JAX run covers


def make_cfg(mod, seq):
    """tests/test_system_vo.py make_cfg, for either package's config module."""
    return mod.SlamConfig(
        camera=mod.CameraConfig(
            fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy,
            fx_right=seq.fx, fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
            bf=seq.fx * seq.baseline,
        ),
        features=mod.FeatureConfig(
            n_init_features=200, n_new_features=100, max_features=256,
            num_features_init_good=50, num_features_tracking_good=50,
            num_features_tracking_bad=10,
        ),
        map=mod.MapConfig(max_keyframes=256, max_landmarks=20000),
        image_height=seq.left.shape[1],
        image_width=seq.left.shape[2],
    )


def _np_tree(nt):
    return {k: (_np_tree(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def run():
    """The JAX run: per-frame snapshots (state before the frame) and outputs."""
    seq = generate_sequence(n_frames=40, trajectory="forward", seed=3)
    slam = JaxSlam(make_cfg(jconfig, seq), enable_loop=False)
    init_state = (_np_tree(slam.fs), _np_tree(slam.map))
    assert slam.process_frame(seq.left[0], seq.right[0], seq.timestamps[0])
    before, packed = {}, {}
    for t in range(1, N_RUN):
        before[t] = (_np_tree(slam.fs), _np_tree(slam.map), [np.asarray(p) for p in slam._pyr_prev])
        lr = jnp.asarray(np.stack([seq.left[t], seq.right[t]]).astype(np.uint8))
        packed[t] = np.asarray(slam._jit_frame(slam.fs, slam.map, slam._pyr_prev, lr,
                                               jnp.float32(seq.timestamps[t]))[3])
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    before[N_RUN] = (_np_tree(slam.fs), _np_tree(slam.map), None)
    return dict(seq=seq, slam=slam, before=before, packed=packed, init_state=init_state)


def _torch_frame(run, t, cfg=None):
    seq = run["seq"]
    cfg = cfg or make_cfg(pconfig, seq)
    fs_np, m_np, pyr_np = run["before"][t]
    intr_l, intr_r = bridge.intrinsics_from_config(cfg)
    lr = torch.from_numpy(np.stack([seq.left[t], seq.right[t]]).astype(np.uint8))
    ba = functools.partial(pbackend.optimize_active_map, intr=intr_l, cfg=cfg)
    return pfrontend.frame_step(
        lr[0].float(), lambda: lr[1].float(), bridge.pyramid_from_numpy(pyr_np),
        bridge.frontend_state_from_numpy(fs_np), bridge.map_state_from_numpy(m_np),
        intr_l, intr_r, cfg.camera.baseline, torch.tensor(seq.timestamps[t], dtype=torch.float32),
        cfg, ba_fn=ba,
    )


@pytest.mark.parametrize("kind", ["plain", "kf"])
def test_frame_step_from_bridged_state(run, kind):
    frames = [t for t, p in run["packed"].items() if (p[3] >= 0) == (kind == "kf")]
    assert frames, f"no {kind} frame in the first {N_RUN} frames"
    t = frames[0]
    fs_p, m_p, _, counts_p = _torch_frame(run, t)
    fs_j, m_j, _ = run["before"][t + 1]
    cj = run["packed"][t][:6].astype(int)
    cp = counts_p.numpy()
    assert abs(int(cp[0]) - int(cj[0])) <= 2, (cp, cj)          # num_inliers
    np.testing.assert_array_equal(cp[1:], cj[1:])               # tracked/status/kf/ref/n_lm
    np.testing.assert_allclose(fs_p.T_rk.numpy(), fs_j["T_rk"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(fs_p.T_vel.numpy(), fs_j["T_vel"], atol=1e-4, rtol=0)
    assert (fs_p.tracks.valid.numpy() == fs_j["tracks"]["valid"]).mean() >= 0.99
    both = fs_p.tracks.valid.numpy() & fs_j["tracks"]["valid"]
    d = np.linalg.norm(fs_p.tracks.xy.numpy()[both] - fs_j["tracks"]["xy"][both], axis=1)
    assert np.median(d) < 1e-3
    assert int(m_p.n_kf) == int(m_j["n_kf"]) and int(m_p.n_lm) == int(m_j["n_lm"])
    np.testing.assert_array_equal(m_p.active_kf.numpy(), m_j["active_kf"])


def test_replenish_branch_from_bridged_state(run):
    """The sequence never sags below the replenish floor, so raise the floor:
    the frame then stereo-matches its unlinked pool without a keyframe."""
    import dataclasses

    cfg = make_cfg(pconfig, run["seq"])
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, replenish_min_inliers=10_000,
                                                   replenish_min_pool=1))
    t = next(t for t, p in run["packed"].items() if p[3] < 0 and p[2] == 1)
    fs_np, m_np, _ = run["before"][t]
    fs_p, m_p, _, counts = _torch_frame(run, t, cfg)
    assert counts[3] == -1 and int(m_p.n_kf) == int(m_np["n_kf"])
    assert int(m_p.n_lm) > int(m_np["n_lm"])
    new = np.arange(int(m_np["n_lm"]), int(m_p.n_lm))
    np.testing.assert_array_equal(m_p.lm_first_kf.numpy()[new], int(fs_np["ref_kf"]))
    tr = fs_p.tracks
    assert bool((tr.lm_idx[tr.valid] >= 0).all())  # unlinked survivors dropped
    assert set(new) <= set(tr.lm_idx[tr.valid].tolist())


def test_stereo_init_from_bridged_state(run):
    seq = run["seq"]
    cfg = make_cfg(pconfig, seq)
    intr_l, intr_r = bridge.intrinsics_from_config(cfg)
    fs0, m0 = run["init_state"]
    left = torch.from_numpy(seq.left[0].astype(np.uint8)).float()
    right = torch.from_numpy(seq.right[0].astype(np.uint8)).float()
    fs, m, kf_id, n_lm = pfrontend.stereo_init_step(
        left, build_lk_pyramid(left, 3), build_lk_pyramid(right, 3),
        bridge.frontend_state_from_numpy(fs0), bridge.map_state_from_numpy(m0),
        intr_l, intr_r, cfg.camera.baseline, torch.tensor(0.0), cfg)
    # The JAX init keyframe's map before its host-side BA is not kept, so
    # compare what BA does not touch: tracks, landmark count and KF row.
    fs_j, m_j, _ = run["before"][1]
    assert int(kf_id) == 0 and int(n_lm) == int(m_j["n_lm"])
    np.testing.assert_array_equal(fs.tracks.valid.numpy(), fs_j["tracks"]["valid"])
    np.testing.assert_array_equal(fs.tracks.xy.numpy(), fs_j["tracks"]["xy"])
    np.testing.assert_array_equal(fs.tracks.lm_idx.numpy(), fs_j["tracks"]["lm_idx"])
    np.testing.assert_array_equal(m.kf_feat_valid.numpy()[0], m_j["kf_feat_valid"][0])
    np.testing.assert_array_equal(m.lm_first_kf.numpy(), m_j["lm_first_kf"])
    np.testing.assert_array_equal(m.active_kf.numpy(), m_j["active_kf"])


@pytest.mark.parametrize("window", ["all", "last3"])
def test_backend_ba_from_bridged_map(run, window):
    """``optimize_active_map`` on the JAX run's latest map.  ``last3`` keeps
    only the newest three keyframes active, so landmarks first seen by older
    keyframes are held fixed and pin the scale gauge."""
    seq = run["seq"]
    cfg = make_cfg(pconfig, seq)
    m_np = dict(run["before"][N_RUN][1])
    n_kf = int(m_np["n_kf"])
    assert n_kf >= 3
    if window == "last3":
        active = np.full_like(m_np["active_kf"], -1)
        active[:3] = np.arange(n_kf - 3, n_kf)
        m_np["active_kf"], m_np["n_active"] = active, np.int32(3)
    # The JAX package's own float32 BA (the port's solve runs in float64).
    jintr = JIntr.create(seq.fx, seq.fy, seq.cx, seq.cy)
    jcfg = make_cfg(jconfig, seq)
    mj = jax.jit(lambda m: jbackend.optimize_active_map(m, jintr, jcfg))(
        type(run["slam"].map)(**{k: jnp.asarray(v) for k, v in m_np.items()}))
    mj = type(mj)(*(np.asarray(v) for v in mj))
    intr_l, _ = bridge.intrinsics_from_config(cfg)
    mp = pbackend.optimize_active_map(bridge.map_state_from_numpy(m_np), intr_l, cfg)
    win = m_np["active_kf"][m_np["active_kf"] >= 0]
    np.testing.assert_allclose(mp.kf_T_cw.numpy()[win], np.asarray(mj.kf_T_cw)[win], atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(mp.kf_feat_lm.numpy(), np.asarray(mj.kf_feat_lm))
    np.testing.assert_array_equal(mp.lm_outlier.numpy(), np.asarray(mj.lm_outlier))
    np.testing.assert_array_equal(mp.lm_obs_count.numpy(), np.asarray(mj.lm_obs_count))
    # Landmarks: 1e-3 m plus 1e-3 relative.  A far landmark's depth is
    # ill-conditioned (a 1e-7 relative perturbation of the JAX input alone
    # moves JAX's own result by ~3 mm at 50 m), and one more or one fewer
    # LM step on a threshold tie moves it by centimetres.
    n_lm = int(m_np["n_lm"])
    np.testing.assert_allclose(mp.lm_pos.numpy()[:n_lm], np.asarray(mj.lm_pos)[:n_lm], atol=1e-3,
                               rtol=1e-3)
