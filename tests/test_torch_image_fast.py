"""Image pyramid and FAST detection: the torch port against the JAX package.

Pyramid levels agree to atol 1e-4 (float32 sums in another order); FAST
keypoint sets and forbid masks are exactly equal, at 240x376.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.ops import fast as jfast  # noqa: E402
from stereoslam_tpu.ops import image as jimage  # noqa: E402
from stereoslam_tpu_torch.ops import fast as pfast  # noqa: E402
from stereoslam_tpu_torch.ops import image as pimage  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402


@pytest.fixture(scope="module")
def frame():
    seq = generate_sequence(n_frames=2, h=240, w=376, n_points=900, seed=7)
    return seq.left[1].astype(np.uint8).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", [(240, 376), (237, 375)])
def test_lk_pyramid_matches(rng, shape):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    pj = jimage.build_lk_pyramid(jnp.asarray(img), 4)
    pp = pimage.build_lk_pyramid(_t(img), 4)
    for a, b in zip(pj, pp):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=0)


def test_bilinear_sample_matches(rng, frame):
    xy = rng.uniform(-5, 400, (500, 2)).astype(np.float32)
    a = jimage.bilinear_sample(jnp.asarray(frame), jnp.asarray(xy))
    b = pimage.bilinear_sample(_t(frame), _t(xy))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_response_exact(frame, threshold):
    cj, sj = jfast.fast_response(jnp.asarray(frame), threshold)
    cp, sp = pfast.fast_response(_t(frame), threshold)
    np.testing.assert_array_equal(np.asarray(cj), cp.numpy())
    np.testing.assert_array_equal(np.asarray(sj), sp.numpy())
    assert cp.sum() > 50


@pytest.mark.parametrize("n_features,with_forbid", [(300, False), (100, True), (400, True)])
def test_detect_keypoints_exact(rng, frame, n_features, with_forbid):
    h, w = frame.shape
    forbid_j = forbid_p = None
    if with_forbid:
        pts = rng.uniform(0, [w, h], (120, 2)).astype(np.float32)
        valid = rng.uniform(size=120) > 0.3
        forbid_j = jfast.forbid_mask_from_points(h, w, jnp.asarray(pts), jnp.asarray(valid), 10)
        forbid_p = pfast.forbid_mask_from_points(h, w, _t(pts), _t(valid), 10)
        np.testing.assert_array_equal(np.asarray(forbid_j), forbid_p.numpy())
    kj = jfast.detect_keypoints(jnp.asarray(frame), n_features, forbid_mask=forbid_j)
    kp = pfast.detect_keypoints(_t(frame), n_features, forbid_mask=forbid_p)
    np.testing.assert_array_equal(np.asarray(kj.valid), kp.valid.numpy())
    np.testing.assert_array_equal(np.asarray(kj.xy), kp.xy.numpy())
    np.testing.assert_array_equal(np.asarray(kj.score), kp.score.numpy())
    assert kp.valid.sum() > 50


def test_detect_keypoints_small_image_multi_per_cell(rng):
    """At 120x188 the per-cell top-M path engages (M > 1)."""
    seq = generate_sequence(n_frames=1, h=120, w=188, fx=160.0, n_points=500, seed=2)
    img = seq.left[0].astype(np.uint8).astype(np.float32)
    kj = jfast.detect_keypoints(jnp.asarray(img), 200, cell_size=8, border=12)
    kp = pfast.detect_keypoints(_t(img), 200, cell_size=8, border=12)
    np.testing.assert_array_equal(np.asarray(kj.xy), kp.xy.numpy())
    np.testing.assert_array_equal(np.asarray(kj.valid), kp.valid.numpy())


def test_forbid_mask_borders_exact(rng):
    h, w = 240, 376
    pts = np.array([[0, 0], [w - 1, h - 1], [3.5, 200.5], [2.5, 100], [w / 2, h / 2]], np.float32)
    pts = np.concatenate([pts, rng.uniform(-5, [w + 5, h + 5], (200, 2)).astype(np.float32)])
    valid = np.ones(len(pts), bool)
    valid[5::7] = False
    a = jfast.forbid_mask_from_points(h, w, jnp.asarray(pts), jnp.asarray(valid), 10)
    b = pfast.forbid_mask_from_points(h, w, _t(pts), _t(valid), 10)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
