"""The LK level and the pyramidal driver: the torch port against the JAX package.

- ``lk_level_plain`` vs ``track_level_batched`` (both float32 on the CPU):
  equal ``good`` flags, median |d flow| < 1e-4 px.
- vs ``lk_level_pallas(..., interpret=True)`` on interior features: median
  < 1e-3 px (the Pallas kernel clips at +-10 px, the shipped path at +-12).
- whole ``pyramidal_lk`` with forward-backward: status agreement >= 99%.
- ``lk_pyramid_plain`` (what ``pyramidal_lk`` runs on the CPU) equals, bit
  for bit, the per-level composition the port shipped before the fused
  kernel, kept below as ``_pyramidal_lk_by_levels``.
- the shared-memory windows of the kernel (``window_plan``) cover every tap
  the plain version reads, for hypothesis-drawn points and seeds.
- the CUDA kernel against the plain version: tests/test_torch_cuda.py.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

torch.set_num_threads(2)

from stereoslam_tpu.ops import fast as jfast  # noqa: E402
from stereoslam_tpu.ops.image import build_lk_pyramid as j_pyramid  # noqa: E402
from stereoslam_tpu.ops.lk import pyramidal_lk as j_pyramidal_lk  # noqa: E402
from stereoslam_tpu.ops.lk_batched import final_error_batched, track_level_batched  # noqa: E402
from stereoslam_tpu.ops.lk_pallas import lk_level_pallas  # noqa: E402
from stereoslam_tpu_torch.ops import lk as plk_pyramid  # noqa: E402
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
    before = plk.lk_level.launches, plk.lk_final_error.launches, plk_pyramid.lk_pyramid.launches
    z = torch.zeros((len(pts), 2))
    f1, g1 = plk.lk_level(_t(a), _t(b), _t(pts), z, 20, 0.01)
    f2, g2 = plk.lk_level_plain(_t(a), _t(b), _t(pts), z, 20, 0.01)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
    plk.lk_final_error(_t(a), _t(b), _t(pts), f1)
    pyr_a, pyr_b = p_pyramid(_t(a), 3), p_pyramid(_t(b), 3)
    r1 = plk_pyramid.lk_pyramid(pyr_a, pyr_b, _t(pts), _t(pts), iters=20, forward_backward=2.0)
    r2 = plk_pyramid.lk_pyramid_plain(pyr_a, pyr_b, _t(pts), _t(pts), iters=20,
                                   forward_backward=2.0)
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))
    assert (plk.lk_level.launches, plk.lk_final_error.launches,
            plk_pyramid.lk_pyramid.launches) == before
    with pytest.raises(ValueError):
        plk.lk_level(_t(a).to("meta"), _t(b).to("meta"), _t(pts).to("meta"), z.to("meta"), 20, 0.01)
    with pytest.raises(ValueError):
        plk_pyramid.lk_pyramid([x.to("meta") for x in pyr_a], [x.to("meta") for x in pyr_b],
                       _t(pts).to("meta"), _t(pts).to("meta"))


def _pyramidal_lk_by_levels(pyr_prev, pyr_next, pts_prev, pts_init, window=11, iters=30,
                            eps=0.01, max_error=30.0, forward_backward=0.0, fb_iters=10,
                            fb_levels=0):
    """The port's pyramidal_lk as it was before the fused kernel: one
    lk_level call per level and one lk_final_error call, kept verbatim as the
    reference that lk_pyramid_plain must equal bit for bit."""
    n_levels = len(pyr_prev)
    flow = (pts_init - pts_prev) / float(2 ** (n_levels - 1))
    good_all = torch.ones(pts_prev.shape[0], dtype=torch.bool, device=pts_prev.device)
    for lvl in range(n_levels - 1, -1, -1):
        pts_l = (pts_prev / float(2 ** lvl)).contiguous()
        flow, good = plk.lk_level(pyr_prev[lvl], pyr_next[lvl], pts_l, flow.contiguous(),
                                  iters=iters, eps=eps, window=window)
        if lvl == 0:
            good_all = good_all & good
        else:
            flow = flow * 2.0

    pts_next = pts_prev + flow
    h, w = pyr_next[0].shape
    margin = window // 2
    in_bounds = (
        (pts_next[:, 0] >= margin) & (pts_next[:, 0] < w - margin)
        & (pts_next[:, 1] >= margin) & (pts_next[:, 1] < h - margin)
    )
    err = plk.lk_final_error(pyr_prev[0], pyr_next[0], pts_prev.contiguous(), flow.contiguous(),
                             window=window)
    status = good_all & in_bounds & (err < max_error)

    if forward_backward > 0.0:
        fb_next = pyr_next[:fb_levels] if fb_levels > 0 else pyr_next
        fb_prev = pyr_prev[:fb_levels] if fb_levels > 0 else pyr_prev
        back = _pyramidal_lk_by_levels(fb_next, fb_prev, pts_next, pts_next, window=window,
                                       iters=fb_iters, eps=eps, max_error=max_error)
        round_trip = torch.linalg.norm(back.points - pts_prev, dim=-1)
        status = status & back.status & (round_trip <= forward_backward)
    return plk_pyramid.FlowResult(points=pts_next, status=status, error=err)



@pytest.mark.parametrize("open_gate", [True, False], ids=["on", "off"])
def test_lk_pyramid_gate_on_the_cpu(pair, open_gate):
    """A gate that is on changes nothing; one that is off keeps no track:
    status all false, points at the seeds, error 0 (the kernel's gated-off
    launch writes the same)."""
    a, b, pts = pair
    pyr_a, pyr_b = p_pyramid(_t(a), 3), p_pyramid(_t(b), 3)
    init = _t(pts) + 1.5
    kw = dict(iters=20, forward_backward=2.0)
    gate = torch.tensor(open_gate)
    got = plk_pyramid.lk_pyramid(pyr_a, pyr_b, _t(pts), init, gate=gate, **kw)
    if open_gate:
        ungated = plk_pyramid.lk_pyramid(pyr_a, pyr_b, _t(pts), init, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, ungated))
        assert bool(got.status.any())
    else:
        assert not bool(got.status.any()) and got.status.shape == (len(pts),)
        assert torch.equal(got.points, init) and not bool(got.error.any())
    with pytest.raises(ValueError, match="gate"):
        plk_pyramid.lk_pyramid(pyr_a, pyr_b, _t(pts), init, gate=gate.reshape(1), **kw)


@pytest.mark.parametrize("levels,fb,fb_levels", [(3, 2.0, 0), (3, 0.0, 0), (4, 2.0, 2),
                                                 (4, 0.0, 0)])
def test_lk_pyramid_plain_equals_the_per_level_composition(rng, pair, levels, fb, fb_levels):
    a, b, pts = pair
    init = pts + rng.uniform(-8.0, 8.0, size=pts.shape).astype(np.float32)
    pa, pb = p_pyramid(_t(a), levels), p_pyramid(_t(b), levels)
    kw = dict(iters=20, forward_backward=fb, fb_iters=10, fb_levels=fb_levels)
    ref = _pyramidal_lk_by_levels(pa, pb, _t(pts), _t(init), **kw)
    got = p_pyramidal_lk(pa, pb, _t(pts), _t(init), **kw)
    for name, x, y in zip(ref._fields, got, ref):
        assert torch.equal(x, y), name
    assert int(got.status.sum()) > len(pts) // 2


_coord = st.one_of(st.floats(-30.0, 80.0, width=32), st.sampled_from([-1e4, 1e4, -64.7, 0.0, 47.5]))
_seed = st.one_of(st.floats(-15.0, 15.0, width=32), st.sampled_from([12.0, -12.0, 1e4, -1e4]))


@settings(max_examples=30, deadline=None)
@given(data=st.data(), image_seed=st.integers(0, 2 ** 16))
def test_window_plan_covers_every_tap_the_plain_version_reads(data, image_seed):
    """Noise images drive steps to the +-12 px clip; points and seeds reach
    past every edge and far outside, where the bases clamp."""
    n = 6
    pts = torch.tensor(data.draw(st.lists(st.tuples(_coord, _coord), min_size=n, max_size=n)),
                       dtype=torch.float32)
    flow0 = torch.tensor(data.draw(st.lists(st.tuples(_seed, _seed), min_size=n, max_size=n)),
                         dtype=torch.float32)
    gen = np.random.default_rng(image_seed)
    prev = torch.from_numpy(gen.uniform(0, 255, (40, 48)).astype(np.float32))
    nxt = torch.from_numpy(gen.uniform(0, 255, (40, 48)).astype(np.float32))
    plan = plk.window_plan()
    t_org, s_org = plk.window_origins(pts, flow0)
    reads = []

    def recording_sample(img, by, bx, fy, fx):
        reads.append((img, by, bx))
        return sample(img, by, bx, fy, fx)

    sample = plk._sample
    with mock.patch.object(plk, "_sample", recording_sample):
        flow, _ = plk.lk_level_plain(prev, nxt, pts, flow0, 10, 0.01)
        plk.lk_final_error_plain(prev, nxt, pts, flow)
        for sx in (-1e6, 1e6):  # the clip's extremes
            for sy in (-1e6, 1e6):
                step = torch.tensor([[sx, sy]], dtype=torch.float32)
                clipped = torch.minimum(torch.maximum(flow0 + step, flow0 - plk.BOUND),
                                        flow0 + plk.BOUND)
                plk._warp(nxt, pts, clipped, plk.WINDOW)
    assert len(reads) > 20
    for img, by, bx in reads:
        org, side = (t_org, plan.template_side) if img is prev else (s_org, plan.search_side)
        # A bilinear sample at base (by, bx) reads rows by, by + 1 and columns bx, bx + 1.
        for base, o in ((by, org[:, 1:2]), (bx, org[:, 0:1])):
            assert bool((base >= o).all()) and bool((base + 1 < o + side).all())


def test_window_plan_sizes():
    plan = plk.window_plan()
    assert (plan.template_side, plan.search_side) == (14, 38)
    assert plan.pitch >= plan.search_side and plan.pitch % 32 == plk.WINDOW
    assert plan.bytes_per_feature == 4 * (14 + 38) * plan.pitch
    # The four features of a block fit the 48 KB of dynamic shared memory a
    # launch takes without raising the kernel's cap.
    assert plk.MAX_LEVELS >= 5 and 4 * plan.bytes_per_feature <= 48 * 1024


def test_level_plain_visit_sees_the_iterations_that_run(rng, pair):
    """``visit`` gets each iteration's flow and the features that run it,
    and changes nothing the level returns."""
    a, b, pts = pair
    flow0 = _t(_flow_seed(rng, len(pts), 3.0))
    seen = []
    f1, g1 = plk.lk_level_plain(_t(a), _t(b), _t(pts), flow0, 20, 0.01,
                                visit=lambda f, active: seen.append((f.clone(), active.clone())))
    f2, g2 = plk.lk_level_plain(_t(a), _t(b), _t(pts), flow0, 20, 0.01)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
    assert len(seen) == 20 and torch.equal(seen[0][0], flow0) and torch.equal(seen[0][1], g1)
    runs = [int(active.sum()) for _, active in seen]
    assert runs == sorted(runs, reverse=True) and 0 < runs[-1] < runs[0]
    # A feature that stopped keeps its flow through the later iterations.
    for (f, active), (f_next, _) in zip(seen, seen[1:]):
        assert torch.equal(f[~active], f_next[~active])

