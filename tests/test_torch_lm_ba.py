"""Pose-only LM, windowed Schur BA and landmark compaction: the torch port
against the JAX package on the same numpy inputs.

LM: pose within 1e-4 and identical inlier sets.  BA (the port solves in
float64, see ``stereoslam_tpu_torch/ops/schur.py``): poses within 1e-4,
landmarks within 1e-3 m, identical inlier sets, against the JAX package's
float32 solve where fixed landmarks pin the gauge, and against the JAX solve
under ``jax.enable_x64`` where only the damping holds the map's scale (there
the float32 solve itself lies up to 6e-4 from its exact answer on the poses).
Compaction: exact.
(The BA of a map bridged from a JAX run lives in test_torch_frontend.py,
beside the JAX run it needs.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.core import maintenance as jmaint  # noqa: E402
from stereoslam_tpu.core import state as jstate  # noqa: E402
from stereoslam_tpu.ops import se3 as jse3  # noqa: E402
from stereoslam_tpu.ops.camera import Intrinsics as JIntr, world2pixel  # noqa: E402
from stereoslam_tpu.ops.lm import optimize_pose as j_optimize_pose  # noqa: E402
from stereoslam_tpu.ops.schur import BAProblem as JProblem, solve_window_ba as j_solve  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch.config import MapConfig, SlamConfig  # noqa: E402
from stereoslam_tpu_torch.core import maintenance as pmaint  # noqa: E402
from stereoslam_tpu_torch.ops import lm as plm  # noqa: E402
from stereoslam_tpu_torch.ops.camera import Intrinsics as PIntr  # noqa: E402
from stereoslam_tpu_torch.ops.lm import optimize_pose as p_optimize_pose  # noqa: E402
from stereoslam_tpu_torch.ops.schur import BAProblem as PProblem, solve_window_ba as p_solve  # noqa: E402

K_ARGS = (718.856, 718.856, 607.1928, 185.2157)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n_out,n_invalid,noise_px", [
    pytest.param(0, 0, 0.5, id="0-0"), pytest.param(40, 0, 0.5, id="40-0"),
    pytest.param(30, 25, 0.5, id="30-25"), pytest.param(0, 0, 0.0, id="done-in-round-0")])
def test_optimize_pose_matches(rng, monkeypatch, n_out, n_invalid, noise_px):
    n = 200
    X = rng.uniform([-10, -5, 4], [10, 5, 50], (n, 3)).astype(np.float32)
    T_true = jse3.exp(jnp.asarray([0.3, -0.1, 0.8, 0.02, -0.04, 0.01], jnp.float32))
    px = np.asarray(world2pixel(jnp.asarray(X), T_true, JIntr.create(*K_ARGS))).copy()
    px += rng.normal(0, noise_px, px.shape).astype(np.float32)
    px[:n_out] += (rng.uniform(20, 80, (n_out, 2)) * np.sign(rng.standard_normal((n_out, 2))))
    px = px.astype(np.float32)
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    T0 = np.asarray(jse3.left_update(T_true, jnp.asarray([0.05, 0.0, 0.05, 0.005, 0.01, 0.0],
                                                         jnp.float32)))
    rj = jax.jit(j_optimize_pose)(
        jnp.asarray(T0), jnp.asarray(X), jnp.asarray(px), jnp.asarray(valid), JIntr.create(*K_ARGS))
    rp = p_optimize_pose(_t(T0), _t(X), _t(px), _t(valid), PIntr.create(*K_ARGS))
    np.testing.assert_allclose(np.asarray(rj.T_cw), rp.T_cw.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.asarray(rj.inlier), rp.inlier.numpy())
    assert int(rj.num_inliers) == int(rp.num_inliers)
    np.testing.assert_allclose(np.asarray(rj.chi2), rp.chi2.numpy(), atol=1e-2, rtol=1e-3)
    # The fixed loop that the card runs (no host read, frozen once done)
    # gives the host's early exit bit for bit.
    fixed = p_optimize_pose(_t(T0), _t(X), _t(px), _t(valid), PIntr.create(*K_ARGS),
                            host_exit=False)
    assert all(torch.equal(a, b) for a, b in zip(rp, fixed))
    if noise_px == 0.0:
        # Exact observations: round 0 converges, and exits, before its 10th step.
        calls = []
        real = plm.solve6
        monkeypatch.setattr(plm, "solve6", lambda *a: (calls.append(1), real(*a))[1])
        p_optimize_pose(_t(T0), _t(X), _t(px), _t(valid), PIntr.create(*K_ARGS), rounds=1)
        assert len(calls) < 10


def _ba_problem(rng, W=5, C=120, noise_px=0.5, pose_noise=0.005, lm_noise=0.02,
                n_outliers=15, n_fixed=30, empty_slot=False):
    """Every camera sees every landmark (in its own slot order) with a
    sideways baseline, so every landmark is well conditioned.  A landmark
    seen once has a depth only the damping pins; there C^-1 reaches
    1/damping and amplifies each framework's float32 rounding differently."""
    intr = JIntr.create(400.0, 400.0, 320.0, 160.0)
    xi = np.zeros((W, 6), np.float32)
    xi[:, 0] = -np.arange(W) * 0.5
    cam_gt = np.asarray(jse3.exp(jnp.asarray(xi)))
    X_gt = rng.uniform([-2, -2, 8], [4, 2, 20], (C, 3)).astype(np.float32)
    obs_lm = np.stack([rng.permutation(C) for _ in range(W)]).astype(np.int32)
    px = np.stack([np.asarray(world2pixel(jnp.asarray(X_gt[obs_lm[w]]), jnp.asarray(cam_gt[w]), intr))
                   for w in range(W)])
    valid = (px[..., 0] > 5) & (px[..., 0] < 635) & (px[..., 1] > 5) & (px[..., 1] < 315)
    px = (px + rng.normal(0, noise_px, px.shape)).astype(np.float32)
    ww, nn = rng.integers(0, W, n_outliers), rng.integers(0, C, n_outliers)
    px[ww, nn] += rng.uniform(30, 90, (n_outliers, 2)).astype(np.float32)
    dx = rng.normal(0, pose_noise, (W, 6)).astype(np.float32)
    cam0 = np.asarray(jse3.exp(jnp.asarray(dx)) @ jnp.asarray(cam_gt))
    X0 = (X_gt + rng.normal(0, lm_noise, X_gt.shape)).astype(np.float32)
    lm_fixed = np.zeros(C, bool)
    lm_fixed[:n_fixed] = True  # anchors at ground truth pin the gauge
    X0[lm_fixed] = X_gt[lm_fixed]
    cam_valid = np.ones(W, bool)
    if empty_slot:
        cam_valid[-1] = False
    cam_fixed = np.zeros(W, bool)
    cam_fixed[0] = True
    return dict(cam_T=cam0, cam_valid=cam_valid, cam_fixed=cam_fixed, lm_pos=X0,
                lm_valid=np.arange(C) < C - 10, lm_fixed=lm_fixed, obs_px=px, obs_lm=obs_lm,
                obs_valid=valid)


def jax_solve(p, x64):
    """The JAX solve on the float32 inputs, or on float64 copies of them."""
    with jax.enable_x64(x64):
        prob = JProblem(**{k: jnp.asarray(v.astype(np.float64) if x64 and v.dtype == np.float32 else v)
                           for k, v in p.items()})
        r = jax.jit(j_solve)(prob, JIntr.create(400.0, 400.0, 320.0, 160.0))
        return type(r)(*(np.asarray(v) for v in r))


@pytest.mark.parametrize("empty_slot,n_fixed,x64", [(False, 30, False), (True, 30, False),
                                                    (False, 0, True)])
def test_solve_window_ba_matches(rng, empty_slot, n_fixed, x64):
    """``n_fixed=0`` leaves the map's scale free (only camera 0 is fixed):
    the reduced system is then singular up to the damping."""
    p = _ba_problem(rng, empty_slot=empty_slot, n_fixed=n_fixed)
    rj = jax_solve(p, x64)
    rp = p_solve(PProblem(**{k: _t(v) for k, v in p.items()}), PIntr.create(400.0, 400.0, 320.0, 160.0))
    assert rp.cam_T.dtype == torch.float32 and rp.lm_pos.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(rj.cam_T), rp.cam_T.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.asarray(rj.obs_inlier), rp.obs_inlier.numpy())
    # Landmarks left with fewer than two inlier observations are pinned by
    # the damping alone (see _ba_problem); hold the others to 1e-3 m.
    n_obs = np.bincount(p["obs_lm"][np.asarray(rj.obs_inlier)], minlength=len(p["lm_pos"]))
    posed = n_obs >= 2
    assert posed[p["lm_valid"]].mean() > 0.9
    np.testing.assert_allclose(np.asarray(rj.lm_pos)[posed], rp.lm_pos.numpy()[posed], atol=1e-3,
                               rtol=0)
    assert np.isfinite(rp.lm_pos.numpy()).all()


def test_compact_landmarks_matches(rng):
    cfg = SlamConfig(map=MapConfig(max_keyframes=8, max_landmarks=64))
    from stereoslam_tpu.config import MapConfig as JMap, SlamConfig as JCfg

    m = jstate.init_map_state(JCfg(map=JMap(max_keyframes=8, max_landmarks=64)))
    n_lm = 50
    m = m._replace(
        lm_pos=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)),
        lm_valid=jnp.arange(64) < n_lm,
        lm_outlier=jnp.asarray(rng.uniform(size=64) < 0.3),
        lm_first_kf=jnp.asarray(rng.integers(0, 8, 64).astype(np.int32)),
        lm_obs_count=jnp.asarray(rng.integers(0, 4, 64).astype(np.int32)),
        n_lm=jnp.int32(n_lm),
        kf_feat_lm=jnp.asarray(rng.integers(-1, n_lm, (8, cfg.features.max_features)).astype(np.int32)),
    )
    tr = jstate.init_track_state(JCfg())._replace(
        lm_idx=jnp.asarray(rng.integers(-1, n_lm, cfg.features.max_features).astype(np.int32)))
    mj, tj, fj = jmaint.compact_landmarks(m, tr)
    mp, tp, fp = pmaint.compact_landmarks(
        bridge.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()}, "cpu"),
        bridge.frontend_state_from_numpy(dict(
            {k: np.asarray(v) for k, v in jstate.init_frontend_state(JCfg())._asdict().items()
             if k != "tracks"}, tracks={k: np.asarray(v) for k, v in tr._asdict().items()}),
            "cpu").tracks,
    )
    for k, v in bridge.map_state_to_numpy(mp).items():
        np.testing.assert_array_equal(np.asarray(getattr(mj, k)), v, err_msg=k)
    np.testing.assert_array_equal(np.asarray(tj.lm_idx), tp.lm_idx.numpy())
    assert int(fj) == int(fp)
