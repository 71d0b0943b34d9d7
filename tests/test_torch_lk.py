"""The LK level and the pyramidal driver: the torch port against the JAX package.

- ``lk_level_plain`` vs ``track_level_batched`` (both float32 on the CPU):
  equal ``good`` flags, median |d flow| < 1e-4 px.
- vs ``lk_level_pallas(..., interpret=True)`` on interior features: median
  < 1e-3 px (the Pallas kernel clips at +-10 px, the shipped path at +-12).
- whole ``pyramidal_lk`` with forward-backward: status agreement >= 99%.
- the CUDA kernel against the plain version: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.ops import fast as jfast  # noqa: E402
from stereoslam_tpu.ops.image import build_lk_pyramid as j_pyramid  # noqa: E402
from stereoslam_tpu.ops.lk import pyramidal_lk as j_pyramidal_lk  # noqa: E402
from stereoslam_tpu.ops.lk_batched import final_error_batched, track_level_batched  # noqa: E402
from stereoslam_tpu.ops.lk_pallas import lk_level_pallas  # noqa: E402
from stereoslam_tpu_torch.ops import lk_level as plk  # noqa: E402
from stereoslam_tpu_torch.ops.image import build_lk_pyramid as p_pyramid  # noqa: E402
from stereoslam_tpu_torch.ops.lk import pyramidal_lk as p_pyramidal_lk  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    seq = generate_sequence(n_frames=3, h=240, w=376, n_points=900, speed=0.5, seed=4)
    a = seq.left[1].astype(np.uint8).astype(np.float32)
    b = seq.left[2].astype(np.uint8).astype(np.float32)
    kps = jfast.detect_keypoints(jnp.asarray(a), 200)
    pts = np.asarray(kps.xy)[np.asarray(kps.valid)]
    return a, b, pts


def _t(x):
    return torch.from_numpy(np.array(x))


def _flow_seed(rng, n, scale):
    return rng.normal(scale=scale, size=(n, 2)).astype(np.float32)


@pytest.mark.parametrize("iters,seed_scale", [(20, 0.0), (10, 1.5), (20, 4.0)])
def test_level_plain_matches_batched(rng, pair, iters, seed_scale):
    a, b, pts = pair
    flow0 = _flow_seed(rng, len(pts), seed_scale)
    fj, gj = track_level_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts),
                                 jnp.asarray(flow0), 11, iters, 0.01)
    fp, gp = plk.lk_level_plain(_t(a), _t(b), _t(pts), _t(flow0), iters, 0.01)
    np.testing.assert_array_equal(np.asarray(gj), gp.numpy())
    d = np.linalg.norm(np.asarray(fj) - fp.numpy(), axis=1)
    assert np.median(d) < 1e-4, np.median(d)
    assert (d < 1e-2).mean() > 0.98


def test_level_plain_matches_pallas_interpret(pair):
    a, b, pts = pair
    h, w = a.shape
    interior = pts[(pts[:, 0] > 40) & (pts[:, 0] < w - 40) & (pts[:, 1] > 40) & (pts[:, 1] < h - 40)]
    z = np.zeros((len(interior), 2), np.float32)
    fj, gj = lk_level_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(interior), jnp.asarray(z),
                             iters=20, eps=0.01, interpret=True)
    fp, gp = plk.lk_level_plain(_t(a), _t(b), _t(interior), _t(z), 20, 0.01)
    np.testing.assert_array_equal(np.asarray(gj), gp.numpy())
    d = np.linalg.norm(np.asarray(fj) - fp.numpy(), axis=1)
    assert len(interior) > 30
    assert np.median(d) < 1e-3, np.median(d)


def test_final_error_matches_batched(rng, pair):
    a, b, pts = pair
    flow = _flow_seed(rng, len(pts), 2.0)
    ej = final_error_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts), jnp.asarray(flow), 11)
    ep = plk.lk_final_error_plain(_t(a), _t(b), _t(pts), _t(flow))
    np.testing.assert_allclose(np.asarray(ej), ep.numpy(), atol=1e-3, rtol=1e-5)


def test_level_handles_border_features(rng, pair):
    a, b, _ = pair
    h, w = a.shape
    pts = np.array([[0.3, 0.2], [w - 1.2, 2.5], [3.0, h - 1.5], [w - 0.5, h - 0.5],
                    [w / 2, h / 2]], np.float32)
    flow0 = np.array([[-3, -2], [4, 0], [0, 5], [9, 9], [1, 1]], np.float32)
    fj, gj = track_level_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts),
                                 jnp.asarray(flow0), 11, 20, 0.01)
    fp, gp = plk.lk_level_plain(_t(a), _t(b), _t(pts), _t(flow0), 20, 0.01)
    np.testing.assert_array_equal(np.asarray(gj), gp.numpy())
    np.testing.assert_allclose(np.asarray(fj), fp.numpy(), atol=1e-3)
    assert np.isfinite(fp.numpy()).all()


@pytest.mark.parametrize("levels,fb", [(3, 2.0), (4, 0.0)])
def test_pyramidal_lk_status_agreement(pair, levels, fb):
    a, b, pts = pair
    init = pts + np.array([2.0, -1.0], np.float32)
    res_j = j_pyramidal_lk(j_pyramid(jnp.asarray(a), levels), j_pyramid(jnp.asarray(b), levels),
                           jnp.asarray(pts), jnp.asarray(init), iters=20, forward_backward=fb)
    res_p = p_pyramidal_lk(p_pyramid(_t(a), levels), p_pyramid(_t(b), levels), _t(pts), _t(init),
                           iters=20, forward_backward=fb)
    sj, sp = np.asarray(res_j.status), res_p.status.numpy()
    assert (sj == sp).mean() >= 0.99
    both = sj & sp
    assert both.sum() > 0.5 * len(pts)
    d = np.linalg.norm(np.asarray(res_j.points)[both] - res_p.points.numpy()[both], axis=1)
    assert np.median(d) < 1e-3


def test_cpu_tensors_take_the_plain_version(pair):
    a, b, pts = pair
    before = plk.lk_level.launches, plk.lk_final_error.launches
    z = torch.zeros((len(pts), 2))
    f1, g1 = plk.lk_level(_t(a), _t(b), _t(pts), z, 20, 0.01)
    f2, g2 = plk.lk_level_plain(_t(a), _t(b), _t(pts), z, 20, 0.01)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
    plk.lk_final_error(_t(a), _t(b), _t(pts), f1)
    assert (plk.lk_level.launches, plk.lk_final_error.launches) == before
    with pytest.raises(ValueError):
        plk.lk_level(_t(a).to("meta"), _t(b).to("meta"), _t(pts).to("meta"), z.to("meta"), 20, 0.01)

