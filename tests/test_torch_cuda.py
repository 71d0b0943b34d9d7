"""The LK kernel on the card against its plain PyTorch version, and the fused
pyramidal call against the same call composed of per-level launches.

CUDA C++ has no CPU mode, so these tests skip where no NVIDIA GPU is.  The
file imports torch, numpy and the port only (no JAX, which the machine with
the card lacks); run it there without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: a different summation order can shift one convergence step,
which moves a flow by up to the eps scale (0.01 px), so the median |d flow|
is held to 1e-3 px, the 99th percentile to 2e-2 px, and ``good`` to 99.5%
agreement.  ``lk_pyramid`` runs the per-level device code, so it equals the
composition of per-level launches bit for bit; only the round-trip norm
(``sqrtf`` in the kernel, ``torch.linalg.norm`` in the composition) may round
differently, so a status may differ there for a round trip within 1e-5 px of
the threshold.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch.ops import lk as plk_pyramid  # noqa: E402
from stereoslam_tpu_torch.ops import lk_level as plk  # noqa: E402
from stereoslam_tpu_torch.ops.fast import detect_keypoints  # noqa: E402
from stereoslam_tpu_torch.ops.image import build_lk_pyramid  # noqa: E402
from stereoslam_tpu_torch.ops.lk import pyramidal_lk  # noqa: E402
from stereoslam_tpu_torch.ops.schur import _sum_by_slot  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the LK kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames(dev):
    seq = generate_sequence(n_frames=3, h=240, w=376, n_points=900, speed=0.5, seed=4)
    a = torch.from_numpy(seq.left[1].astype(np.uint8)).to(dev).float()
    b = torch.from_numpy(seq.left[2].astype(np.uint8)).to(dev).float()
    kps = detect_keypoints(a, 200)
    return a, b, kps.xy[kps.valid].contiguous()


@pytest.mark.parametrize("level,iters,seed_px", [(0, 20, 0.0), (1, 10, 1.5), (2, 20, 4.0)])
def test_lk_level_kernel_matches_plain(frames, level, iters, seed_px):
    a, b, pts = frames
    pa, pb = build_lk_pyramid(a, 3)[level], build_lk_pyramid(b, 3)[level]
    p = (pts / 2.0 ** level).contiguous()
    gen = torch.Generator().manual_seed(level)
    flow0 = (torch.randn(p.shape, generator=gen) * seed_px).to(p.device)
    n0 = plk.lk_level.launches
    fk, gk = plk.lk_level(pa, pb, p, flow0, iters, 0.01)
    fp, gp = plk.lk_level_plain(pa, pb, p, flow0, iters, 0.01)
    torch.cuda.synchronize()
    assert plk.lk_level.launches == n0 + 1
    assert (gk == gp).float().mean().item() >= 0.995
    d = (fk - fp).norm(dim=1)[gk & gp]
    assert d.median().item() < 1e-3 and d.quantile(0.99).item() < 2e-2


def test_lk_final_error_kernel_matches_plain(frames):
    a, b, pts = frames
    flow = torch.full_like(pts, 1.25)
    n0 = plk.lk_final_error.launches
    ek = plk.lk_final_error(a, b, pts, flow)
    ep = plk.lk_final_error_plain(a, b, pts, flow)
    torch.cuda.synchronize()
    assert plk.lk_final_error.launches == n0 + 1
    assert (ek - ep).abs().max().item() < 1e-3


def test_lk_level_wrapper_rejects_what_the_kernel_does_not_take(frames):
    a, b, pts = frames
    z = torch.zeros_like(pts)
    with pytest.raises(TypeError):
        plk.lk_level(a.double(), b.double(), pts, z, 20, 0.01)
    with pytest.raises(ValueError):
        plk.lk_level(a, b, pts.t().contiguous().t(), z, 20, 0.01)  # not contiguous
    with pytest.raises(ValueError):
        plk.lk_level(a, b[:-1], pts, z, 20, 0.01)  # images of two shapes
    with pytest.raises(ValueError):
        plk.lk_level(a, b, pts, z.cpu(), 20, 0.01)  # flow on another device


def test_ba_slot_sums_repeat_bit_for_bit(dev):
    """The BA's landmark reductions add each slot's rows in a fixed order on
    the card, so a run repeats exactly (``index_add_`` would race atomics)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn((2800, 18), device=dev, generator=gen, dtype=torch.float64)
    slot = torch.randint(0, 400, (2800,), device=dev, generator=gen)
    first = _sum_by_slot(vals, slot, 400)
    for _ in range(10):
        assert torch.equal(_sum_by_slot(vals, slot, 400), first)
    ref = torch.zeros((400, 18), dtype=torch.float64).index_add_(0, slot.cpu(), vals.cpu())
    torch.testing.assert_close(first.cpu(), ref, rtol=0, atol=1e-12)


def _round_trip_ties(pa, pb, pts, res, fb, fb_iters, fb_levels):
    """Tracks whose round trip in the per-level composition lies within
    1e-5 px of the forward-backward threshold."""
    nb = fb_levels or len(pa)
    back = plk_pyramid.lk_pyramid_levels(pb[:nb], pa[:nb], res.points, res.points, iters=fb_iters)
    return (torch.linalg.norm(back.points - pts, dim=-1) - fb).abs() < 1e-5


def _border_case(pts, h, w):
    """Points at every edge and far outside, seeded past the edges."""
    edge = torch.tensor([[0.3, 0.2], [w - 1.2, 2.5], [3.0, h - 1.5], [w - 0.5, h - 0.5],
                         [-1e4, 50.0], [50.0, 1e4], [1e4, -1e4], [w / 2, h / 2]],
                        device=pts.device)
    seed = torch.tensor([[-20.0, -20.0], [30.0, 0.0], [0.0, 30.0], [25.0, 25.0], [0.0, 0.0],
                         [-1e4, 0.0], [1e4, 1e4], [0.0, -1e4]], device=pts.device)
    p = torch.cat([pts, edge])
    return p, p + torch.cat([torch.zeros_like(pts), seed])


@pytest.mark.parametrize("case", ["temporal_fb", "stereo", "border"])
def test_lk_pyramid_equals_per_level_launches_and_plain(frames, case):
    a, b, pts = frames
    gen = torch.Generator().manual_seed(7)
    if case == "temporal_fb":
        levels, kw = 3, dict(iters=20, forward_backward=2.0, fb_iters=10)
        init = pts + (torch.rand(pts.shape, generator=gen) * 16.0 - 8.0).to(pts.device)
    elif case == "stereo":
        levels, kw = 4, dict(iters=20)
        init = pts
    else:
        levels, kw = 3, dict(iters=20, forward_backward=2.0, fb_iters=10)
        pts, init = _border_case(pts, *a.shape)
    pa, pb = build_lk_pyramid(a, levels), build_lk_pyramid(b, levels)
    got = plk_pyramid.lk_pyramid(pa, pb, pts, init, **kw)
    ref = plk_pyramid.lk_pyramid_levels(pa, pb, pts, init, **kw)
    plain = plk_pyramid.lk_pyramid_plain(pa, pb, pts, init, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.points, ref.points) and torch.equal(got.error, ref.error)
    differ = got.status != ref.status
    if kw.get("forward_backward", 0.0) > 0.0:
        differ &= ~_round_trip_ties(pa, pb, pts, ref, 2.0, 10, 0)
    assert not bool(differ.any())
    assert (got.status == plain.status).float().mean().item() >= 0.995
    d = (got.points - plain.points).norm(dim=1)[got.status & plain.status]
    assert d.median().item() < 1e-3 and d.quantile(0.99).item() < 2e-2


def test_pyramidal_lk_is_one_launch_per_call(frames):
    a, b, pts = frames
    pa, pb = build_lk_pyramid(a, 3), build_lk_pyramid(b, 3)
    def counts():
        return plk_pyramid.lk_pyramid.launches, plk.lk_level.launches, plk.lk_final_error.launches

    before = counts()
    pyramidal_lk(pa, pb, pts, pts + 1.0, iters=20, forward_backward=2.0, fb_iters=10)
    assert counts() == (before[0] + 1, before[1], before[2])


def test_lk_pyramid_wrapper_rejects_what_the_kernel_does_not_take(frames):
    a, b, pts = frames
    pa, pb = list(build_lk_pyramid(a, 3)), list(build_lk_pyramid(b, 3))
    with pytest.raises(ValueError):  # level shapes differ between the pyramids
        plk_pyramid.lk_pyramid(pa, pb[:1] + [pb[1][:-1].contiguous()] + pb[2:], pts, pts)
    with pytest.raises(TypeError):  # a level that is not float32
        plk_pyramid.lk_pyramid(pa[:2] + [pa[2].double()], pb, pts, pts)
    with pytest.raises(ValueError):  # deeper than the kernel takes
        plk_pyramid.lk_pyramid([a] * (plk.MAX_LEVELS + 1), [b] * (plk.MAX_LEVELS + 1), pts, pts)
    with pytest.raises(ValueError):  # pyramids of two depths
        plk_pyramid.lk_pyramid(pa, pb[:2], pts, pts)
