"""SE(3), camera and triangulation: the torch port against the JAX package
on the same numpy inputs, to atol 1e-5 (float32 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.ops import camera as jcam  # noqa: E402
from stereoslam_tpu.ops import se3 as jse3  # noqa: E402
from stereoslam_tpu.ops import triangulate as jtri  # noqa: E402
from stereoslam_tpu_torch.ops import camera as pcam  # noqa: E402
from stereoslam_tpu_torch.ops import se3 as pse3  # noqa: E402
from stereoslam_tpu_torch.ops import triangulate as ptri  # noqa: E402

ATOL = 1e-5


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if torch.is_tensor(b) else b, atol=atol, rtol=0)


def _twists(rng, n=64):
    xi = rng.normal(scale=0.5, size=(n, 6)).astype(np.float32)
    xi[:4] *= 1e-5                      # near-identity Taylor branches
    xi[4, 3:] = [np.pi - 1e-4, 0.0, 0.0]  # near-pi rotation
    return xi


def test_hat_vee_exp_log(rng):
    xi = _twists(rng)
    _close(jse3.hat(_j(xi[:, 3:])), pse3.hat(_t(xi[:, 3:])))
    _close(jse3.vee(jse3.hat(_j(xi[:, 3:]))), pse3.vee(pse3.hat(_t(xi[:, 3:]))))
    Tj, Tp = jse3.exp(_j(xi)), pse3.exp(_t(xi))
    _close(Tj, Tp)
    _close(jse3.log(Tj), pse3.log(_t(np.asarray(Tj))), atol=2e-5)


def test_inv_act_left_update_orthonormalize_quaternion(rng):
    xi = _twists(rng)
    T = np.asarray(jse3.exp(_j(xi)))
    p = rng.normal(scale=5.0, size=(64, 3)).astype(np.float32)
    _close(jse3.inv(_j(T)), pse3.inv(_t(T)))
    _close(jse3.act(_j(T), _j(p)), pse3.act(_t(T), _t(p)), atol=2e-5)
    dx = rng.normal(scale=0.1, size=(64, 6)).astype(np.float32)
    _close(jse3.left_update(_j(T), _j(dx)), pse3.left_update(_t(T), _t(dx)))
    noisy = T + rng.normal(scale=1e-3, size=T.shape).astype(np.float32) * np.array(
        [1, 1, 1, 0], np.float32)[:, None]
    _close(jse3.orthonormalize(_j(noisy)), pse3.orthonormalize(_t(noisy)))
    qj, qp = np.asarray(jse3.to_quaternion(_j(T))), pse3.to_quaternion(_t(T)).numpy()
    # q and -q are the same rotation; both sides pick the same pivot, so equal.
    np.testing.assert_allclose(qj, qp, atol=ATOL)


def test_camera_ops(rng):
    intr_j = jcam.Intrinsics.create(718.856, 718.856, 607.1928, 185.2157)
    intr_p = pcam.Intrinsics.create(718.856, 718.856, 607.1928, 185.2157)
    T = np.asarray(jse3.exp(_j(rng.normal(scale=0.2, size=(6,)).astype(np.float32))))
    p_w = np.concatenate([rng.uniform(-10, 10, (50, 2)), rng.uniform(2, 40, (50, 1))], 1)
    p_w = p_w.astype(np.float32)
    _close(jcam.world2pixel(_j(p_w), _j(T), intr_j), pcam.world2pixel(_t(p_w), _t(T), intr_p),
           atol=2e-3)  # pixels: 1e-5 relative at |px| ~ 1e3
    _close(jcam.world2camera(_j(p_w), _j(T)), pcam.world2camera(_t(p_w), _t(T)), atol=2e-5)
    px = rng.uniform(0, 1000, (50, 2)).astype(np.float32)
    _close(jcam.pixel2camera(_j(px), intr_j), pcam.pixel2camera(_t(px), intr_p))
    _close(jcam.pixel2world(_j(px), _j(T), intr_j, 3.0), pcam.pixel2world(_t(px), _t(T), intr_p, 3.0),
           atol=2e-5)
    _close(jcam.depth_of(_j(p_w), _j(T)), pcam.depth_of(_t(p_w), _t(T)), atol=2e-5)
    _close(jcam.stereo_right_pose(0.537), pcam.stereo_right_pose(0.537))


@pytest.mark.parametrize("depth", [(2.0, 6.0), (8.0, 30.0)], ids=["near", "far"])
def test_triangulate_stereo(rng, depth):
    fx, cx, cy, b = 320.0, 188.0, 120.0, 0.54
    intr_j = jcam.Intrinsics.create(fx, fx, cx, cy)
    intr_p = pcam.Intrinsics.create(fx, fx, cx, cy)
    T = np.asarray(jse3.exp(_j(np.array([0.3, -0.1, 0.5, 0.02, -0.05, 0.01], np.float32))))
    T_r = np.asarray(jcam.stereo_right_pose(b) @ _j(T))
    p_c = np.concatenate([rng.uniform(-3, 3, (80, 2)), rng.uniform(*depth, (80, 1))], 1)
    p_w = np.asarray(jse3.act(jse3.inv(_j(T)), _j(p_c.astype(np.float32))))
    px_l = np.asarray(jcam.world2pixel(_j(p_w), _j(T), intr_j))
    px_r = np.asarray(jcam.world2pixel(_j(p_w), _j(T_r), intr_j))
    pj, gj = jtri.triangulate_stereo(_j(px_l), _j(px_r), _j(T), _j(T_r), intr_j, intr_j)
    pp, gp = ptri.triangulate_stereo(_t(px_l), _t(px_r), _t(T), _t(T_r), intr_p, intr_p)
    np.testing.assert_array_equal(np.asarray(gj), gp.numpy())
    assert gp.all()
    # The float32 eigh null vector carries relative noise of ~1e-5 times
    # depth/baseline on both sides (the JAX result sits that far from the
    # exact point too), so points agree to atol 1e-5 plus 1e-4 relative.
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(pp.numpy(), p_w, atol=ATOL, rtol=1e-4)
