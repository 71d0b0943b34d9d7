"""Undistortion in the torch port, against the JAX package on the CPU.

- ``undistortion_map``, ``undistort_image`` and ``undistort_points`` against
  their JAX twins (map and points within 1e-4 px, image within 1e-3 gray
  levels);
- the port's exact remap against JAX's banded remap, within
  tests/test_camera.py's interior bounds (max < 1.5, mean < 0.05);
- the facade with ``need_undistortion=True`` on raw frames, bit for bit
  against ``frontend.frame_step`` with undistortion off on frames the port
  remapped first, from the same state (a keyframe-free and a keyframe frame);
- the same remapped frames through JAX's ``frame_step`` from the same
  bridged state, within tests/test_torch_frontend.py's tolerances.

The states come from the port's facade with undistortion on bench.py's
coefficients (k1 -0.28, k2 0.07) over tests/test_system_vo.py's sequence.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu import config as jconfig  # noqa: E402
from stereoslam_tpu.core import backend as jbackend  # noqa: E402
from stereoslam_tpu.core import frontend as jfrontend  # noqa: E402
from stereoslam_tpu.core.state import FrontendState as JFS, MapState as JMS  # noqa: E402
from stereoslam_tpu.core.state import TrackState as JTS  # noqa: E402
from stereoslam_tpu.ops import camera as jcam  # noqa: E402
from stereoslam_tpu.ops.image import gaussian_blur as jblur  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core import backend as pbackend  # noqa: E402
from stereoslam_tpu_torch.core import frontend as pfrontend  # noqa: E402
from stereoslam_tpu_torch.core.graphs import _flat  # noqa: E402
from stereoslam_tpu_torch.core.state import TRACKING_GOOD  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.ops import camera as pcam  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402

DIST = (-0.28, 0.07, 0.0, 0.0)  # bench.py's undistortion-ON coefficients (k1, k2, p1, p2)
N_RUN = 10  # frames of the facade run: a keyframe-free frame and a keyframe frame


def make_cfg(mod, seq):
    """tests/test_system_vo.py's config with undistortion on."""
    return mod.SlamConfig(
        camera=mod.CameraConfig(
            fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy,
            fx_right=seq.fx, fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
            bf=seq.fx * seq.baseline, need_undistortion=True,
            k1=DIST[0], k2=DIST[1], k1_right=DIST[0], k2_right=DIST[1],
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


def _blurred(rng, h, w):
    img = rng.standard_normal((h, w)).astype(np.float32)
    return np.asarray(jblur(jnp.asarray(img), sigma=1.5, radius=4)) * 60 + 128


def test_undistortion_ops_match_jax(rng):
    h, w = 120, 188
    pi, ji = pcam.Intrinsics.create(180.0, 182.0, 93.5, 60.25), jcam.Intrinsics.create(
        180.0, 182.0, 93.5, 60.25)
    dist = (-0.28, 0.07, 1e-3, -5e-4)
    pm = pcam.undistortion_map(h, w, pi, torch.tensor(dist))
    jm = np.asarray(jcam.undistortion_map(h, w, ji, jnp.asarray(dist)))
    assert pm.shape == (h, w, 2) and pm.dtype == torch.float32
    np.testing.assert_allclose(pm.numpy(), jm, atol=1e-4, rtol=0)
    assert np.abs(jm - np.indices((h, w))[::-1].transpose(1, 2, 0)).max() > 5  # a real warp

    img = _blurred(rng, h, w)
    np.testing.assert_allclose(
        pcam.undistort_image(torch.from_numpy(img), pm).numpy(),
        np.asarray(jcam.undistort_image(jnp.asarray(img), jnp.asarray(jm))), atol=1e-3, rtol=0)

    px = (rng.random((300, 2)) * [w - 1, h - 1]).astype(np.float32)
    pp = pcam.undistort_points(torch.from_numpy(px), pi, dist)
    jp = np.asarray(jcam.undistort_points(jnp.asarray(px), ji, jnp.asarray(dist)))
    np.testing.assert_allclose(pp.numpy(), jp, atol=1e-4, rtol=0)
    # A distorted point maps back to its undistorted source pixel.
    src = pm[37, 101]
    back = pcam.undistort_points(src[None], pi, dist, iters=20)[0]
    np.testing.assert_allclose(back.numpy(), [101.0, 37.0], atol=1e-2)


def test_exact_remap_against_jax_banded_remap(rng):
    """tests/test_camera.py's warp and image: the port's exact remap
    against the JAX package's banded remap, within that test's bounds."""
    H, W = 94, 310
    ji, pi = jcam.Intrinsics.create(180.0, 180.0, W / 2, H / 2), pcam.Intrinsics.create(
        180.0, 180.0, W / 2, H / 2)
    dist = (-0.28, 0.07, 1e-3, -5e-4)
    plan = jcam.banded_remap_plan(jcam.undistortion_map(H, W, ji, jnp.asarray(dist)))
    img = _blurred(rng, H, W)
    fast = np.asarray(jcam.banded_remap(jnp.asarray(img), plan))
    exact = pcam.undistort_image(torch.from_numpy(img),
                                 pcam.undistortion_map(H, W, pi, torch.tensor(dist))).numpy()
    interior = np.abs(exact - fast)[4:-4, 4:-4]
    assert interior.max() < 1.5, interior.max()
    assert interior.mean() < 0.05, interior.mean()


def _np_tree(nt):
    return {k: (_np_tree(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in nt._asdict().items()}


def _jax_tree(d, cls):
    return cls(**{k: (_jax_tree(v, JTS) if isinstance(v, dict) else jnp.asarray(v))
                  for k, v in d.items()})


@pytest.fixture(scope="module")
def run():
    """The port's facade with undistortion on over the raw frames: the state
    before each frame and whether the frame made a keyframe."""
    seq = generate_sequence(n_frames=40, trajectory="forward", seed=3)
    slam = StereoSlam(make_cfg(pconfig, seq), device="cpu", enable_loop=False)
    assert slam.undistortion_maps is not None
    assert slam.process_frame(seq.left[0], seq.right[0], seq.timestamps[0])
    before, kf = {}, {}
    for t in range(1, N_RUN):
        # A copy: on the CPU the arrays share the state's (reused) buffers.
        before[t] = copy.deepcopy((bridge.frontend_state_to_numpy(slam.fs),
                                   bridge.map_state_to_numpy(slam.map),
                                   bridge.pyramid_to_numpy(slam._pyr_prev)))
        n_kf = int(slam.map.n_kf)
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        kf[t] = int(slam.map.n_kf) > n_kf
    return dict(seq=seq, before=before, kf=kf)


@pytest.fixture(scope="module")
def jax_frame_step(run):
    """JAX's frame_step with inline BA, jitted once for both cases."""
    jcfg = make_cfg(jconfig, run["seq"])
    c = jcfg.camera
    ji_l = jcam.Intrinsics.create(c.fx, c.fy, c.cx, c.cy)
    ji_r = jcam.Intrinsics.create(c.fx_right, c.fy_right, c.cx_right, c.cy_right)
    return jax.jit(lambda l, r, p, f, mm, ts: jfrontend.frame_step(
        l, lambda: r, p, f, mm, ji_l, ji_r, c.baseline, ts, jcfg,
        ba_fn=lambda x: jbackend.optimize_active_map(x, ji_l, jcfg)))


def _frame_of(run, kind):
    frames = [t for t, k in run["kf"].items() if k == (kind == "kf") and t >= 3]
    assert frames, f"no {kind} frame in the first {N_RUN} frames"
    return frames[0]


def _pre_remapped(seq, cfg, t):
    """Frame t's pair remapped by the port: (left, right) float32."""
    il, ir = bridge.intrinsics_from_config(cfg)
    c = cfg.camera
    out = []
    for img, intr, dist in ((seq.left[t], il, (c.k1, c.k2, c.p1, c.p2)),
                            (seq.right[t], ir, (c.k1_right, c.k2_right, c.p1_right, c.p2_right))):
        m = pcam.undistortion_map(cfg.image_height, cfg.image_width, intr, torch.tensor(dist))
        out.append(pcam.undistort_image(torch.from_numpy(img.astype(np.uint8)).float(), m))
    return out


def _torch_state(run, t):
    fs_np, m_np, pyr_np = run["before"][t]
    return (bridge.frontend_state_from_numpy(fs_np, "cpu"), bridge.map_state_from_numpy(m_np, "cpu"),
            bridge.pyramid_from_numpy(pyr_np, "cpu"))


@pytest.mark.parametrize("kind", ["plain", "kf"])
def test_facade_undistortion_equals_pre_remapped_frame_step(run, kind):
    seq = run["seq"]
    t = _frame_of(run, kind)
    cfg = make_cfg(pconfig, seq)
    left, right = _pre_remapped(seq, cfg, t)
    intr_l, intr_r = bridge.intrinsics_from_config(cfg)
    fs, m, pyr = _torch_state(run, t)
    off = cfg.replace(camera=dataclasses.replace(cfg.camera, need_undistortion=False))
    ref_fs, ref_m, ref_pyr, counts = pfrontend.frame_step(
        left, lambda: right, pyr, fs, m, intr_l, intr_r, cfg.camera.baseline,
        torch.tensor(seq.timestamps[t], dtype=torch.float32), off,
        ba_fn=lambda mm: pbackend.optimize_active_map(mm, intr_l, off))

    slam = StereoSlam(cfg, device="cpu", enable_loop=False)
    assert slam.undistortion_maps is not None
    slam.fs, slam.map, slam._pyr_prev = _torch_state(run, t)
    slam._status, slam._frame_count = TRACKING_GOOD, t
    assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    assert (int(counts[3]) >= 0) == (kind == "kf")
    for name, a, b in (("fs", slam.fs, ref_fs), ("map", slam.map, ref_m),
                       ("pyramid", slam._pyr_prev, ref_pyr)):
        assert all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b))), name


@pytest.mark.parametrize("kind", ["plain", "kf"])
def test_pre_remapped_frame_step_against_jax(run, jax_frame_step, kind):
    seq = run["seq"]
    t = _frame_of(run, kind)
    cfg = make_cfg(pconfig, seq)
    left, right = _pre_remapped(seq, cfg, t)
    intr_l, intr_r = bridge.intrinsics_from_config(cfg)
    fs, m, pyr = _torch_state(run, t)
    fs_p, m_p, _, counts_p = pfrontend.frame_step(
        left, lambda: right, pyr, fs, m, intr_l, intr_r, cfg.camera.baseline,
        torch.tensor(seq.timestamps[t], dtype=torch.float32), cfg,
        ba_fn=lambda mm: pbackend.optimize_active_map(mm, intr_l, cfg))

    fs_np, m_np, pyr_np = run["before"][t]
    fs_j, m_j, _, counts_j = jax_frame_step(
        jnp.asarray(left.numpy()), jnp.asarray(right.numpy()),
        tuple(jnp.asarray(p) for p in pyr_np), _jax_tree(fs_np, JFS), _jax_tree(m_np, JMS),
        jnp.float32(seq.timestamps[t]))
    cj, cp = np.asarray(counts_j).astype(int), counts_p.numpy()
    assert (cp[3] >= 0) == (kind == "kf")
    assert abs(int(cp[0]) - int(cj[0])) <= 2, (cp, cj)          # num_inliers
    np.testing.assert_array_equal(cp[1:], cj[1:])               # tracked/status/kf/ref/n_lm
    np.testing.assert_allclose(fs_p.T_rk.numpy(), np.asarray(fs_j.T_rk), atol=1e-4, rtol=0)
    valid_j = np.asarray(fs_j.tracks.valid)
    assert (fs_p.tracks.valid.numpy() == valid_j).mean() >= 0.99
    both = fs_p.tracks.valid.numpy() & valid_j
    d = np.linalg.norm(fs_p.tracks.xy.numpy()[both] - np.asarray(fs_j.tracks.xy)[both], axis=1)
    assert np.median(d) < 1e-3
    assert int(m_p.n_kf) == int(m_j.n_kf) and int(m_p.n_lm) == int(m_j.n_lm)
