"""The LK kernel on the card against its plain PyTorch version.

CUDA C++ has no CPU mode, so these tests skip where no NVIDIA GPU is.  The
file imports torch, numpy and the port only (no JAX, which the machine with
the card lacks); run it there without the JAX test harness:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: a different summation order can shift one convergence step,
which moves a flow by up to the eps scale (0.01 px), so the median |d flow|
is held to 1e-3 px, the 99th percentile to 2e-2 px, and ``good`` to 99.5%
agreement.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch.ops import lk_level as plk  # noqa: E402
from stereoslam_tpu_torch.ops.fast import detect_keypoints  # noqa: E402
from stereoslam_tpu_torch.ops.image import build_lk_pyramid  # noqa: E402
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
