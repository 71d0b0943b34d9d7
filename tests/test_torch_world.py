"""The port's world renderer against the JAX package's on the same inputs.

- ``_hash01`` and ``_value_noise`` are bit-equal to JAX (evaluated op by
  op) on random inputs, negative and large lattice cells included.
- ``normal_from_keys`` is within 1e-5 of ``jax.random.normal`` for the same
  raw keys (the noise differs only in the inverse error function).
- ``render_frame`` at 120x188 for a straight, a corner and a revisit pose,
  with noise off and on, and ``generate_world_sequence`` for 4 frames, hold
  JAX's images to: median |d| <= 1e-3, at least 99.9% of pixels within 0.05
  intensity, uint8 equal on at least 99.5% of pixels (a float32 difference in
  the last place can move a pixel across an integer boundary).
- A batch of frames renders bit for bit as each frame alone does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu.utils import world as jw  # noqa: E402
from stereoslam_tpu_torch.utils import world as pw  # noqa: E402

H, W, FX = 120, 188, 160.0
MEDIAN_TOL, NEAR, NEAR_SHARE, U8_SHARE = 1e-3, 0.05, 0.999, 0.995
NOISE_TOL = 1e-5


def assert_images_close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert np.median(d) <= MEDIAN_TOL, np.median(d)
    assert (d <= NEAR).mean() >= NEAR_SHARE, (d <= NEAR).mean()
    assert (a.astype(np.uint8) == b.astype(np.uint8)).mean() >= U8_SHARE


def test_hash_and_value_noise_bit_equal(rng):
    n = 4096
    ix = rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32)
    iy = rng.integers(-2**31, 2**31 - 1, size=n).astype(np.int32)
    ix[:4] = [-1, 0, 2**31 - 1, -2**31]
    salt = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    salt_t = torch.from_numpy(salt.astype(np.int64))
    want = np.asarray(jw._hash01(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(salt)))
    got = pw._hash01(torch.from_numpy(ix), torch.from_numpy(iy), salt_t).numpy()
    np.testing.assert_array_equal(got, want)
    # Lattice coordinates from small to beyond 2**24 (where float32 spacing
    # exceeds one cell), both signs.
    scale = np.float32(10.0) ** rng.uniform(-1, 7.5, size=n).astype(np.float32)
    u = (rng.uniform(-1, 1, size=n).astype(np.float32) * scale).astype(np.float32)
    v = (rng.uniform(-1, 1, size=n).astype(np.float32) * scale[::-1]).astype(np.float32)
    want = np.asarray(jw._value_noise(jnp.asarray(u), jnp.asarray(v), jnp.asarray(salt)))
    got = pw._value_noise(torch.from_numpy(u), torch.from_numpy(v), salt_t).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", [(7, 5), (64, 33), (120, 188)])
def test_normal_from_keys_matches_jax(h, w):
    seeds = np.array([0, 1, 1000003 + 7, 2**32 - 1, 123456789])
    keys = jw.prng_keys(seeds)
    np.testing.assert_array_equal(pw.prng_keys(seeds), keys)
    got = pw.normal_from_keys(keys, h, w, "cpu").numpy()
    want = np.stack([np.asarray(jax.random.normal(jnp.asarray(k), (h, w))) for k in keys])
    assert got.shape == want.shape == (len(seeds), h, w)
    assert np.abs(got - want).max() <= NOISE_TOL


@pytest.fixture(scope="module")
def scenes():
    return jw.make_city_circuit(90.0, 50.0, seed=3), pw.make_city_circuit(90.0, 50.0, seed=3)


@pytest.fixture(scope="module")
def jax_render(scenes):
    quads = scenes[0].quads

    def render(T, key=None, off=0.0):
        return jw.render_frame(T, quads, FX, FX, W / 2, H / 2, H, W, cam_offset_x=off,
                               noise_key=key)

    return jax.jit(render), jax.jit(lambda T, k: render(T, k, off=0.54))


POSES = jw.circuit_poses(460, 0.8, 90.0, 50.0, 14.0)
# Frame 20 on the first straight, 100 inside the first corner arc, 440 past
# the end of the 422-frame lap (the revisit of the start).
CASES = [("straight", 20), ("corner", 100), ("revisit", 440)]


@pytest.mark.parametrize("noise", [False, True], ids=["clean", "noise"])
@pytest.mark.parametrize("name,t", CASES, ids=[c[0] for c in CASES])
def test_render_frame_matches_jax(scenes, jax_render, name, t, noise):
    T = POSES[t].astype(np.float32)
    key = jw.prng_keys(np.array([1000 + t]))[0] if noise else None
    left, right = jax_render
    want = left(jnp.asarray(T), None if key is None else jnp.asarray(key))
    got = pw.render_frame(torch.from_numpy(T), scenes[1].quads, FX, FX, W / 2, H / 2, H, W,
                          noise_key=key)
    assert_images_close(got.numpy(), want)
    if noise:  # the right camera of the stereo pair
        want_r = right(jnp.asarray(T), jnp.asarray(key))
        got_r = pw.render_frame(torch.from_numpy(T), scenes[1].quads, FX, FX, W / 2, H / 2, H, W,
                                cam_offset_x=0.54, noise_key=key)
        assert_images_close(got_r.numpy(), want_r)


def test_render_depth_matches_jax(scenes):
    T = POSES[60].astype(np.float32)
    _, want = jax.jit(lambda T: jw.render_frame(T, scenes[0].quads, FX, FX, W / 2, H / 2, H, W,
                                                return_depth=True))(jnp.asarray(T))
    _, got = pw.render_frame(torch.from_numpy(T), scenes[1].quads, FX, FX, W / 2, H / 2, H, W,
                             return_depth=True)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.median(np.abs(got[fin] - want[fin]) / want[fin]) <= 1e-6


def test_batched_render_equals_single_frames(scenes):
    q = pw._quads_on(scenes[1].quads, "cpu")
    T = torch.from_numpy(POSES[[5, 100, 200, 300, 440]].astype(np.float32))
    keys = pw.prng_keys(np.arange(5))
    batch = pw.render_frames(T, q, FX, FX, W / 2, H / 2, H, W, cam_offset_x=0.54, noise_keys=keys)
    for b in range(len(T)):
        one = pw.render_frame(T[b], q, FX, FX, W / 2, H / 2, H, W, cam_offset_x=0.54,
                              noise_key=keys[b])
        assert torch.equal(batch[b], one)


def test_generate_world_sequence_matches_jax():
    kw = dict(n_frames=4, h=H, w=W, fx=FX, seed=2)
    want = jw.generate_world_sequence(**kw)
    got = pw.generate_world_sequence(device="cpu", **kw)
    assert got.left.dtype == torch.float32 and got.left.device.type == "cpu"
    for name in ("left", "right"):
        for t in range(4):
            assert_images_close(getattr(got, name)[t].numpy(), getattr(want, name)[t])
    np.testing.assert_array_equal(got.T_cw, want.T_cw)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    for f in ("baseline", "fx", "fy", "cx", "cy"):
        assert getattr(got, f) == getattr(want, f)


def test_world_renders_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pw.generate_world_sequence(n_frames=1, h=H, w=W, fx=FX)
