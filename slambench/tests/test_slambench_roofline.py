"""The frozen LK work count on small cases, and the frozen plain LK
against the program's plain version."""

import torch

from slambench.reference import lk as K
from slambench.roofline import lk_work as R


def _box(h, w, x0, y0, side):
    m = torch.zeros((h, w), dtype=torch.bool)
    m[max(y0, 0):min(y0 + side, h), max(x0, 0):min(x0 + side, w)] = True
    return m


def test_a_flat_image_runs_no_iteration():
    img = torch.full((40, 60), 100.0)
    pts = torch.tensor([[30.25, 20.5]])
    nbytes, flops = R.lk_work([img], [img.clone()], pts, pts.clone(), iters=20, eps=0.01)
    # The gate refuses a flat window: the template and the final error only.
    assert flops == R.FLOPS_TEMPLATE + R.FLOPS_ERROR
    plan = K.window_plan()
    tmpl = _box(40, 60, 30 - plan.template_pad, 20 - plan.template_pad, plan.template_side)
    taps = _box(40, 60, 30 - K.WINDOW // 2, 20 - K.WINDOW // 2, K.WINDOW + 1)
    assert nbytes == 4 * (int(tmpl.sum()) + int(taps.sum())) + R.POINT_BYTES


def test_iterations_are_counted_as_the_data_runs():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((64, 96), generator=g) * 255
    b = torch.roll(a, shifts=(1, 2), dims=(0, 1))
    pts = torch.tensor([[40.0, 30.0], [50.5, 33.25]])
    runs = []
    K.lk_level_plain(a, b, pts, torch.zeros_like(pts), 20, 0.01,
                     visit=lambda f, act: runs.append(int(act.sum())))
    nbytes, flops = R.lk_work([a], [b], pts, pts.clone(), iters=20, eps=0.01)
    assert flops == 2 * R.FLOPS_TEMPLATE + sum(runs) * R.FLOPS_ITER + 2 * R.FLOPS_ERROR
    assert 0 < sum(runs) < 40
    fb_bytes, fb_flops = R.lk_work([a], [b], pts, pts.clone(), iters=20, eps=0.01, fb=2.0,
                                   fb_iters=10)
    assert fb_flops > flops and fb_bytes > nbytes
    least, by = R.bound_ms(nbytes, flops)
    assert least > 0 and by in ("bytes", "operations")


def test_frozen_plain_lk_equals_the_programs():
    from stereoslam_tpu_torch.ops.image import build_lk_pyramid
    from stereoslam_tpu_torch.ops.lk import lk_pyramid_plain

    g = torch.Generator().manual_seed(1)
    a = torch.rand((96, 128), generator=g) * 255
    b = torch.roll(a, shifts=(2, -3), dims=(0, 1))
    pa, pb = build_lk_pyramid(a, 3), build_lk_pyramid(b, 3)
    pts = torch.rand((16, 2), generator=g) * torch.tensor([100.0, 70.0]) + 14
    kw = dict(window=11, iters=20, eps=0.01, forward_backward=2.0, fb_iters=10)
    ours = K.pyramidal_lk(pa, pb, pts, pts + 1.0, **kw)
    theirs = lk_pyramid_plain(pa, pb, pts, pts + 1.0, **kw)
    for x, y in zip(ours, theirs):
        assert torch.equal(x, y)
