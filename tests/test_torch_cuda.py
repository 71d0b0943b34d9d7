"""The LK kernel on the card against its plain PyTorch version, the fused
pyramidal call against the same call composed of per-level launches, and the
loop-closing modules on the card against the CPU, and the tracked frame's
CUDA graph against the eager frame.

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
the threshold.  The CALC encoder on the card is held to the CPU within 1e-5
(float32, TF32 off), descriptor matching exactly.  The world renderer on the
card is held to the CPU by the CPU tests' tolerances against JAX (median
|d| <= 1e-3, 99.9% within 0.05, uint8 equal on 99.5%); the device feed and a
checkpoint round trip must be exact.  A replay of the tracked frame's graph
runs the same kernels on the same inputs as the eager frame, so it equals
it bit for bit; the eager frame makes no host sync; ``lk_pyramid`` gated on
equals the ungated call bit for bit.  A batched ``lk_pyramid`` launch gives
each sequence the bits of its own single launch, gated or not, and a replay
of the batched multi-sequence step's graph equals the eager batched step
bit for bit.  The float64 SVD equals ``torch.linalg.svd`` bit for bit; a
replay of the windowed BA's fixed-step graph equals the eager BA bit for bit
and reads nothing back; the stepped BA equals the eager early exit bit for
bit and reads only its exit tests; the asynchronous BA replays on a side
stream.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.models import calc as pcalc  # noqa: E402
from stereoslam_tpu_torch.ops import hamming as pham  # noqa: E402
from stereoslam_tpu_torch.ops import lk as plk_pyramid  # noqa: E402
from stereoslam_tpu_torch.ops import lk_level as plk  # noqa: E402
from stereoslam_tpu_torch.ops.fast import detect_keypoints  # noqa: E402
from stereoslam_tpu_torch.ops.image import build_lk_pyramid  # noqa: E402
from stereoslam_tpu_torch.ops.lk import pyramidal_lk  # noqa: E402
from stereoslam_tpu_torch.ops.schur import _sum_by_slot  # noqa: E402
from stereoslam_tpu_torch.utils import world as pworld  # noqa: E402
from stereoslam_tpu_torch.utils.feed import DeviceFeed  # noqa: E402
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


def test_lk_pyramid_gate_on_the_card(frames):
    """Gated on, the launch equals the ungated one bit for bit; gated off it
    keeps no track (status all false, points at the seeds, error 0).  Both
    are one counted launch."""
    a, b, pts = frames
    pa, pb = build_lk_pyramid(a, 3), build_lk_pyramid(b, 3)
    init = pts + 1.5
    kw = dict(iters=20, forward_backward=2.0, fb_iters=10)
    n0 = plk_pyramid.lk_pyramid.launches
    ungated = plk_pyramid.lk_pyramid(pa, pb, pts, init, **kw)
    on = plk_pyramid.lk_pyramid(pa, pb, pts, init, gate=torch.ones((), dtype=torch.bool,
                                                                     device=a.device), **kw)
    off = plk_pyramid.lk_pyramid(pa, pb, pts, init, gate=torch.zeros((), dtype=torch.bool,
                                                                      device=a.device), **kw)
    torch.cuda.synchronize()
    assert plk_pyramid.lk_pyramid.launches == n0 + 3
    assert all(torch.equal(x, y) for x, y in zip(on, ungated)) and bool(on.status.any())
    assert not bool(off.status.any()) and torch.equal(off.points, init)
    assert not bool(off.error.any())


def test_svd_on_the_card_equals_torch_linalg_svd(dev):
    """ops/svd.py calls cuSOLVER's batched Jacobi SVD with torch's parameters
    and no host read: the same bits as torch.linalg.svd, and the same
    layouts (U column-major, Vh row-major)."""
    from stereoslam_tpu_torch.ops.svd import svd

    gen = torch.Generator(device=dev).manual_seed(1)
    q, _ = torch.linalg.qr(torch.randn(64, 3, 3, device=dev, generator=gen))
    mats = q + 1e-6 * torch.randn(64, 3, 3, device=dev, generator=gen)
    for batch in (mats[0], mats):
        got, want = svd(batch), torch.linalg.svd(batch)
        for x, y in zip(got, want):
            assert torch.equal(x, y) and x.stride() == y.stride()


def test_float64_svd_on_the_card_equals_torch_linalg_svd(dev):
    """The windowed BA's float64 rotation blocks: cuSOLVER's Dgesvdj with
    float64's epsilon gives torch.linalg.svd's bits, one at a time and in
    the window's batch of 7."""
    from stereoslam_tpu_torch.ops.svd import svd

    gen = torch.Generator(device=dev).manual_seed(2)
    q, _ = torch.linalg.qr(torch.randn(21, 3, 3, device=dev, dtype=torch.float64, generator=gen))
    mats = q + 1e-9 * torch.randn(21, 3, 3, device=dev, dtype=torch.float64, generator=gen)
    for batch in (mats[0], mats[:7], mats):
        got, want = svd(batch), torch.linalg.svd(batch)
        for x, y in zip(got, want):
            assert x.dtype == torch.float64 and torch.equal(x, y) and x.stride() == y.stride()


def test_ba_replay_equals_eager_without_a_host_read(dev):
    """The BA graph's replay against the eager optimize_active_map (every
    output field, bit for bit), the eager fixed steps against the early
    exit, and no host read in a replay nor in the eager fixed-step BA."""
    from stereoslam_tpu_torch.core import backend as pbackend
    from stereoslam_tpu_torch.core.graphs import BAGraph

    seq, slam = _vo_slam(dev)
    for t in range(len(seq.left)):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    m, intr, cfg = slam.map, slam.intr_left, slam.cfg
    early = pbackend.optimize_active_map(m, intr, cfg, host_exit=True)
    g = BAGraph(cfg, intr, dev)
    g(m)  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fixed = pbackend.optimize_active_map(m, intr, cfg)
        replay = g(m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for f in pbackend.BA_OUTPUTS:
        assert torch.equal(getattr(fixed, f), getattr(early, f)), f
        assert torch.equal(getattr(replay, f), getattr(fixed, f)), f


def test_stepped_ba_equals_the_early_exit_reading_only_its_exit_tests(dev, monkeypatch):
    """The stepped BA (the inline BA's and the fleet's) on the final map:
    every output field bit for bit as the eager early exit, the same LM
    steps, fewer than ``rounds x iters``, and under sync-debug "error" no
    sync but its counted ``ba.exit`` reads (event waits, which the mode
    does not report): one a step and one a round."""
    from stereoslam_tpu_torch.core import backend as pbackend
    from stereoslam_tpu_torch.core.graphs import SteppedBA
    from stereoslam_tpu_torch.ops import schur as pschur
    from stereoslam_tpu_torch.utils.prof import HostReads

    seq, slam = _vo_slam(dev)
    assert isinstance(slam._ba, SteppedBA)
    for t in range(len(seq.left)):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    assert slam._ba.steps  # the run's keyframes ran it
    m, intr, cfg = slam.map, slam.intr_left, slam.cfg
    steps = []
    step = pschur._lm_step
    monkeypatch.setattr(pschur, "_lm_step", lambda *a: (steps.append(1), step(*a))[1])
    early = pbackend.optimize_active_map(m, intr, cfg, host_exit=True)
    monkeypatch.setattr(pschur, "_lm_step", step)
    reads = HostReads()
    g = SteppedBA(cfg, intr, dev, reads=reads)
    g(m)  # the captures
    torch.cuda.synchronize()
    n0 = reads.n
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay = g(m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for f in pbackend.BA_OUTPUTS:
        assert torch.equal(getattr(replay, f), getattr(early, f)), f
    b = cfg.backend
    assert g.steps == [len(steps)] * 2 and len(steps) < b.ba_rounds * b.ba_iters
    assert len(steps) < reads.n - n0 <= 2 * len(steps)
    assert set(reads.counts) == {"ba.exit"}


def test_async_ba_replays_on_a_side_stream(dev):
    """StereoSlam(inline_ba=False) replays its BA graph on a stream other
    than the current one, and the run repeats bit for bit."""
    runs = []
    for _ in range(2):
        seq, slam = _vo_slam(dev)
        slam = StereoSlam(slam.cfg, device=dev, enable_loop=False, inline_ba=False)
        streams = []
        run = slam._ba.run

        def traced(*a, _run=run, _streams=streams):
            _streams.append(torch.cuda.current_stream(dev))
            return _run(*a)

        slam._ba.run = traced
        for t in range(len(seq.left)):
            assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        main = torch.cuda.current_stream(dev)
        assert streams and all(s != main for s in streams)
        assert slam._ba.replays == len(streams) >= 2
        runs.append(slam.keyframe_trajectory())
    for x, y in zip(*runs):
        assert np.array_equal(x, y)


def _vo_slam(dev, n_frames=12):
    seq = generate_sequence(n_frames=n_frames, trajectory="forward", seed=3)
    cfg = pconfig.SlamConfig(
        camera=pconfig.CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                                    fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                                    bf=seq.fx * seq.baseline),
        features=pconfig.FeatureConfig(n_init_features=200, n_new_features=100, max_features=256,
                                       num_features_init_good=50, num_features_tracking_good=50,
                                       num_features_tracking_bad=10),
        map=pconfig.MapConfig(max_keyframes=256, max_landmarks=20000),
        image_height=seq.left.shape[1], image_width=seq.left.shape[2],
    )
    return seq, StereoSlam(cfg, device=dev, enable_loop=False)


def test_graph_replay_equals_eager_track_frame(dev):
    """Each replay of the tracked frame's CUDA graph against the eager
    track_frame on the same static inputs, bit for bit, over 10 frames
    (keyframe frames among them)."""
    from stereoslam_tpu_torch.core.graphs import _flat

    seq, slam = _vo_slam(dev)
    g = slam.track_graph
    for t in range(len(seq.left)):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
        if t < 2:
            continue
        eager = g._fn(*g._inputs)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(_flat(eager), _flat(g._outputs))), t
    assert g.replays == len(seq.left) - 1 and int(slam.map.n_kf) >= 2


def test_eager_track_frame_makes_no_host_sync(dev):
    from stereoslam_tpu_torch.core import frontend as pfrontend

    seq, slam = _vo_slam(dev, n_frames=3)
    for t in range(2):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    lr = torch.from_numpy(np.stack([seq.left[2], seq.right[2]]).astype(np.uint8)).to(dev)
    track_map = pfrontend.TrackMap.of(slam.map)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pfrontend.track_frame(lr[0].float(), slam._pyr_prev, slam.fs, track_map,
                                    slam.intr_left, slam.cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out[2].shape == (pfrontend.OUTCOME_SIZE,)


def test_lk_pyramid_batched_launch_equals_single_launches(frames):
    """One launch for three sequences (the frames shifted apart) against
    three single launches, bit for bit; gated off, a sequence keeps no
    track; one counted launch, one batched."""
    a, b, pts = frames
    A = torch.stack([a, a.roll(3, 1), a.flip(1)])
    Bn = torch.stack([b, b.roll(3, 1), b.flip(1)])
    pa, pb = build_lk_pyramid(A, 3), build_lk_pyramid(Bn, 3)
    P = torch.stack([pts, pts + torch.tensor([3.0, 0.0], device=a.device),
                     torch.stack([a.shape[1] - 1 - pts[:, 0], pts[:, 1]], 1)])
    init = P + 1.5
    kw = dict(iters=20, forward_backward=2.0, fb_iters=10)
    single = [plk_pyramid.lk_pyramid([x[s] for x in pa], [y[s] for y in pb], P[s], init[s], **kw)
              for s in range(3)]
    n0 = (plk_pyramid.lk_pyramid.launches, plk_pyramid.lk_pyramid.batched_launches)
    gate = torch.tensor([True, False, True], device=a.device)
    ungated = plk_pyramid.lk_pyramid(pa, pb, P, init, **kw)
    gated = plk_pyramid.lk_pyramid(pa, pb, P, init, gate=gate, **kw)
    torch.cuda.synchronize()
    assert (plk_pyramid.lk_pyramid.launches, plk_pyramid.lk_pyramid.batched_launches) == (
        n0[0] + 2, n0[1] + 2)
    for s in range(3):
        assert all(torch.equal(x[s], y) for x, y in zip(ungated, single[s])), s
        if gate[s]:
            assert all(torch.equal(x[s], y) for x, y in zip(gated, single[s])), s
        else:
            assert not bool(gated.status[s].any()) and torch.equal(gated.points[s], init[s])
            assert not bool(gated.error[s].any())


def test_multiseq_graph_replay_equals_eager_step(dev):
    """Each replay of the batched step's CUDA graph against the eager
    batched step on the same static inputs, bit for bit, over 10 steps of
    two sequences (keyframe steps among them), each replay kept before
    keyframe service writes into the graph's outputs; the eager step makes
    no host sync; one replay a step."""
    from stereoslam_tpu_torch.core.graphs import _clone, _flat
    from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO

    seqs = [generate_sequence(n_frames=12, trajectory="forward", seed=s) for s in (3, 5)]
    seq0 = seqs[0]
    cfg = pconfig.SlamConfig(
        camera=pconfig.CameraConfig(fx=seq0.fx, fy=seq0.fy, cx=seq0.cx, cy=seq0.cy,
                                    fx_right=seq0.fx, fy_right=seq0.fy, cx_right=seq0.cx,
                                    cy_right=seq0.cy, bf=seq0.fx * seq0.baseline),
        features=pconfig.FeatureConfig(n_init_features=200, n_new_features=100, max_features=256,
                                       num_features_init_good=50, num_features_tracking_good=50,
                                       num_features_tracking_bad=10),
        map=pconfig.MapConfig(max_keyframes=256, max_landmarks=20000),
        image_height=seq0.left.shape[1], image_width=seq0.left.shape[2],
    )
    vo = MultiSeqVO(cfg, batch=2, device=dev)
    stack = lambda t, f: np.stack([getattr(q, f)[t] for q in seqs])  # noqa: E731
    vo.initialize(stack(0, "left"), stack(0, "right"), np.zeros(2))
    g = vo.graph
    for t in range(1, 12):
        lr = vo._stack(stack(t, "left"), stack(t, "right"))
        if t >= 2:  # the graph exists: replay this step's inputs, then the eager step
            replayed = _clone(g.run(lr, vo._pyr_prev, vo.fs, vo.maps))
            g.replays -= 1
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = g._fn(*g._inputs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(_flat(eager), _flat(replayed))), t
        vo.process_staged(lr, np.full(2, t * 0.1))
    vo.drain()
    assert g.replays == 11 and vo.alive.all() and (vo.maps.n_kf.cpu().numpy() >= 2).all()


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


def test_calc_encoder_on_card_matches_cpu(dev, frames):
    a = frames[0].cpu()
    card, cpu = pcalc.DescriptorModel.default(), pcalc.DescriptorModel.default()
    assert card.params is not None, "the shipped CALC weights are missing"
    got, ref = card(a.to(dev)).cpu(), cpu(a)
    assert (got - ref).abs().max().item() <= 1e-5 and float(got @ ref) >= 0.99999
    hog = pcalc.hog_descriptor(a.to(dev)).cpu()
    assert (hog - pcalc.hog_descriptor(a)).abs().max().item() <= 1e-5


def test_match_descriptors_on_card_matches_cpu(dev):
    gen = torch.Generator().manual_seed(3)
    M, N = 3200, 400
    a = torch.randint(-2 ** 31, 2 ** 31 - 1, (M, 8), generator=gen, dtype=torch.int32)
    b = torch.cat([a[:1600], torch.randint(-2 ** 31, 2 ** 31 - 1, (M - 1600, 8), generator=gen,
                                           dtype=torch.int32)])
    b[:1600, 0] ^= 1 << 7
    va, vb = torch.rand(M, generator=gen) > 0.2, torch.rand(M, generator=gen) > 0.2
    cls = torch.arange(M, dtype=torch.int32) % N
    ref = pham.match_descriptors(a, va, b, vb, cls, cls, N)
    got = pham.match_descriptors(a.to(dev), va.to(dev), b.to(dev), vb.to(dev), cls.to(dev),
                                 cls.to(dev), N)
    for x, y in zip(got, ref):
        assert torch.equal(x.cpu(), y)
    assert int(ref.accepted.sum()) > 100


def test_short_loop_run_builds_loop_state_on_card(dev):
    seq = generate_sequence(n_frames=24, loop_frames=120, trajectory="loop", speed=0.35, seed=7,
                            n_points=900)
    cfg = pconfig.SlamConfig(
        camera=pconfig.CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                                    fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                                    bf=seq.fx * seq.baseline),
        features=pconfig.FeatureConfig(n_init_features=200, n_new_features=100, max_features=256,
                                       num_features_init_good=50, num_features_tracking_good=50,
                                       num_features_tracking_bad=10),
        image_height=seq.left.shape[1], image_width=seq.left.shape[2],
    )
    slam = StereoSlam(cfg, device=dev, enable_loop=True, descriptor_model=pcalc.DescriptorModel())
    for t in range(len(seq.left)):
        assert slam.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    slam.keyframe_trajectory()
    assert all(t.device.type == "cuda" for t in slam.loop)
    assert slam.loop.orb_desc.shape == (cfg.map.max_keyframes, 256 * 8, 8)
    n_db = int(slam.loop.db_valid.sum())
    assert n_db >= 2 and bool(slam.loop.orb_valid[0].any())
    assert float(slam.loop.deep_db[0].norm()) == pytest.approx(1.0, abs=1e-5)


def test_world_render_on_card_matches_cpu(dev):
    kw = dict(n_frames=6, h=120, w=188, fx=160.0, seed=4)
    card = pworld.generate_world_sequence(device=dev, **kw)
    cpu = pworld.generate_world_sequence(device="cpu", **kw)
    assert card.left.device.type == "cuda"
    for a, b in ((card.left, cpu.left), (card.right, cpu.right)):
        d = (a.cpu() - b).abs()
        assert d.median().item() <= 1e-3 and (d <= 0.05).float().mean().item() >= 0.999
        assert (a.cpu().to(torch.uint8) == b.to(torch.uint8)).float().mean().item() >= 0.995
    keys = pworld.prng_keys(np.arange(3))
    np.testing.assert_allclose(pworld.normal_from_keys(keys, 64, 96, dev).cpu().numpy(),
                               pworld.normal_from_keys(keys, 64, 96, "cpu").numpy(), atol=1e-5,
                               rtol=0)


def test_device_feed_delivers_every_frame_bit_for_bit(dev):
    rng = np.random.default_rng(0)
    n = 50
    frames = [(rng.uniform(0, 255, (120, 188)).astype(np.float32),
               rng.uniform(0, 255, (120, 188)).astype(np.float32), 0.1 * t) for t in range(n)]
    got = []
    for lr, ts in DeviceFeed(iter(frames), depth=3, device=dev):
        assert lr.device.type == "cuda" and lr.dtype == torch.uint8
        got.append((lr.float().sum(), lr.clone(), ts))  # work queued on the consumer stream
    torch.cuda.synchronize()
    assert len(got) == n
    for (left, right, ts), (_, lr, ts_got) in zip(frames, got):
        want = np.stack([left, right]).astype(np.uint8)
        assert np.array_equal(lr.cpu().numpy(), want) and ts_got == ts


def test_batch_feed_delivers_every_batch_bit_for_bit(dev):
    from stereoslam_tpu_torch.utils.feed import BatchFeed

    rng = np.random.default_rng(1)
    n, b = 20, 3
    batches = [(rng.uniform(0, 255, (b, 120, 188)), rng.uniform(0, 255, (b, 120, 188)),
                np.full(b, 0.1 * t)) for t in range(n)]
    got = []
    for lr, ts in BatchFeed(iter(batches), depth=3, device=dev):
        assert lr.device.type == "cuda" and lr.dtype == torch.uint8 and lr.shape == (b, 2, 120, 188)
        assert ts.shape == (b,) and ts.dtype == np.float32
        got.append((lr.float().sum(), lr.clone(), ts))  # work queued on the consumer stream
    torch.cuda.synchronize()
    assert len(got) == n
    for (left, right, ts), (_, lr, ts_got) in zip(batches, got):
        want = np.stack([left, right], axis=1).astype(np.uint8)
        assert np.array_equal(lr.cpu().numpy(), want)
        np.testing.assert_array_equal(ts_got, ts.astype(np.float32))


def test_batch_feed_lifecycle_on_the_card(dev):
    """tests/test_feed.py's lifecycle for the staging thread: a slow
    consumer still sees the end, an early break stops the producer, and a
    producer error reaches the consumer after the batches before it."""
    import threading
    import time

    from stereoslam_tpu_torch.utils.feed import BatchFeed

    def batches(n):
        for t in range(n):
            yield np.full((2, 8, 12), t), np.full((2, 8, 12), t), np.full(2, float(t))

    feed = BatchFeed(batches(10), depth=2, device=dev)
    seen = []
    for lr, ts in feed:
        time.sleep(0.01)
        seen.append(int(ts[0]))
    assert seen == list(range(10))
    feed._thread.join(timeout=5.0)
    assert not feed._thread.is_alive()

    n_before = threading.active_count()
    feed = BatchFeed(batches(100), depth=2, device=dev)
    for i, _ in enumerate(feed):
        if i == 3:
            break
    feed.close()
    assert not feed._thread.is_alive() and threading.active_count() <= n_before + 1

    def bad():
        yield from batches(2)
        raise RuntimeError("disk died")

    got = []
    with pytest.raises(RuntimeError, match="disk died"):
        for _, ts in BatchFeed(bad(), depth=2, device=dev):
            got.append(ts)
    assert len(got) == 2


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    seq = generate_sequence(n_frames=10, h=120, w=188, n_points=400, seed=3, speed=0.3)
    cfg = pconfig.SlamConfig(
        camera=pconfig.CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, fx_right=seq.fx,
                                    fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
                                    bf=seq.fx * seq.baseline),
        features=pconfig.FeatureConfig(n_init_features=100, n_new_features=50, max_features=128,
                                       num_features_init_good=20, num_features_tracking_good=20,
                                       num_features_tracking_bad=5),
        map=pconfig.MapConfig(max_keyframes=32, max_landmarks=2048),
        image_height=120, image_width=188,
    )
    a = StereoSlam(cfg, device=dev)
    for t in range(len(seq.left)):
        assert a.process_frame(seq.left[t], seq.right[t], seq.timestamps[t])
    path = a.save_checkpoint(str(tmp_path / "ck.npz"))
    b = StereoSlam(cfg, device=dev)
    b.load_checkpoint(path)
    for x, y in zip((*a.fs[1:], *a.fs.tracks, *a.map, *a.loop, *a._pyr_prev),
                    (*b.fs[1:], *b.fs.tracks, *b.map, *b.loop, *b._pyr_prev)):
        assert y.device.type == "cuda" and x.dtype == y.dtype
        assert torch.equal(x, y)
    for x, y in zip(a.keyframe_trajectory(), b.keyframe_trajectory()):
        assert np.array_equal(x, y)
    assert a.loop_edges == b.loop_edges


def test_calc_training_step_on_card_matches_cpu(dev):
    """One step of CALC training's pair loss from the same init (seed 0),
    batch and augmentation on the card and on the CPU: the loss terms within
    1e-4 relative (the bfloat16 decoder's reconstruction within 1e-2), every
    encoder gradient at cosine >= 0.9999 and decoder gradient at >= 0.999."""
    from stereoslam_tpu_torch.models import train_calc as tc

    A, B = tc.render_corpus_pairs(n_places=16, n_scenes=2, h=120, w=188, fx=160.0, seed=3,
                                  device="cpu")
    a, b = tc.preprocess_corpus(A, "cpu"), tc.preprocess_corpus(B, "cpu")
    aug = tc.draw_augment(torch.Generator().manual_seed(0), len(a))
    out = []
    for d in (dev, torch.device("cpu")):
        enc, dec = tc.init_modules(0, d)
        total, aux = tc.pair_loss(enc, dec, a.to(d), b.to(d), aug.to(d), margin_pos=0.97)
        total.backward()
        grads = {k: p.grad.cpu().double().ravel()
                 for k, p in [*enc.named_parameters(), *dec.named_parameters()]}
        out.append(([float(x.detach()) for x in (total, *aux)], grads))
    (got, g_card), (ref, g_cpu) = out
    for i, tol in ((1, 1e-2), (2, 1e-4), (3, 1e-4)):
        assert abs(got[i] - ref[i]) <= tol * abs(ref[i]), (i, got, ref)
    assert abs(got[0] - ref[0]) <= 1e-4 * abs(ref[0]) + 1e-2 * abs(ref[1])
    for k, g in g_cpu.items():
        cos = float(g_card[k] @ g / (g_card[k].norm() * g.norm()))
        assert cos >= (0.999 if k.startswith("dense") else 0.9999), (k, cos)


# ---------------------------------------------------------------------------
# Multi-device at world size 1 on the card (parallel/)
# ---------------------------------------------------------------------------

def test_mesh_constructors_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a card, ``make_mesh()`` and ``initialize()`` on the card raise,
    and so do the facades given a CPU mesh but no device; a CPU mesh works.
    It runs before the tests below make the card's world of one."""
    import torch.distributed as dist

    from stereoslam_tpu_torch.parallel import distributed
    from stereoslam_tpu_torch.parallel.mesh import make_mesh
    from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize("file:///nonexistent/store", world_size=2, rank=0)
    assert not distributed.initialize()   # one process: nothing to join
    cfg = pconfig.SlamConfig(image_height=240, image_width=376)
    m = make_mesh(device_type="cpu")
    try:
        for make in (lambda: StereoSlam(cfg, mesh=m), lambda: MultiSeqVO(cfg, batch=2, mesh=m)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        assert StereoSlam(cfg, device="cpu", enable_loop=False, mesh=m).inline_ba is False
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh(dev):
    """A mesh of the card alone: NCCL over a world of one."""
    import torch.distributed as dist

    from stereoslam_tpu_torch.parallel.mesh import make_mesh

    created = not dist.is_initialized()
    m = make_mesh()
    yield m
    if created:
        dist.destroy_process_group()


def test_sharded_search_on_the_card_equals_the_dense_scan(mesh, dev):
    """The search over a 1536 x 1064 database: the same id, score bits and
    suspect count as the loop closer's dense scan."""
    from stereoslam_tpu_torch.parallel.dist_lcd import sharded_descriptor_search

    g = torch.Generator().manual_seed(5)
    db = torch.randn(1536, 1064, generator=g)
    db[300] = db[1200] + 0.3 * torch.randn(1064, generator=g)
    db = (db / db.norm(dim=1, keepdim=True)).to(dev)
    valid = (torch.arange(1536) <= 1200).to(dev)
    res = sharded_descriptor_search(db, valid, db[1200], 1200 - 20 + 1, 0.05, mesh)
    scores = db @ db[1200]
    ids = torch.arange(1536, device=dev)
    scores = torch.where(valid & ((1200 - ids) >= 20), scores, torch.full_like(scores, -1.0))
    best = torch.argmax(scores)
    assert int(res.best_id) == int(best) == 300
    assert torch.equal(res.best_score, scores[best])
    assert int(res.n_suspect) == int((scores > 0.05).sum())


def _circle_graph_numpy(seed: int = 0):
    """tests/test_parallel.py:182's drifted circle (40 vertices in 48 rows,
    96 edge rows), its odometry noise drawn with the port's se3."""
    from stereoslam_tpu_torch.ops import se3

    rng = np.random.default_rng(seed)
    K, n = 48, 40
    gt = []
    for i in range(n):
        c, s = np.cos(2 * np.pi * i / n), np.sin(2 * np.pi * i / n)
        T_wc = np.eye(4)
        T_wc[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T_wc[:3, 3] = [5.0 * (1 - c), 0, 5.0 * s]
        gt.append(np.linalg.inv(T_wc))
    gt = np.stack(gt).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    E = 2 * K
    edge_i, edge_j = np.zeros(E, np.int32), np.zeros(E, np.int32)
    meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    edge_valid = np.zeros(E, bool)
    poses[0] = gt[0]
    for i in range(1, n):
        noise = se3.exp(torch.from_numpy((rng.standard_normal(6) * 0.01).astype(np.float32)))
        meas[i] = noise.numpy() @ gt[i] @ np.linalg.inv(gt[i - 1])
        poses[i] = meas[i] @ poses[i - 1]
        edge_i[i], edge_j[i], edge_valid[i] = i, i - 1, True
    edge_i[n], edge_j[n], edge_valid[n] = n - 1, 0, True
    meas[n] = gt[n - 1] @ np.linalg.inv(gt[0])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fixed[n:] = True
    return dict(poses=poses, vertex_valid=np.arange(K) < n, fixed=fixed, edge_i=edge_i,
                edge_j=edge_j, edge_meas=meas, edge_valid=edge_valid)


def test_sharded_pgo_on_the_card_equals_the_dense_solver(mesh, dev):
    """World size 1: the sharded solver (fixed CG steps frozen by a device
    flag, no host read per iteration) equals ``optimize_pose_graph`` with the
    sharded exit rules bit for bit."""
    from stereoslam_tpu_torch import bridge
    from stereoslam_tpu_torch.ops.pgo import optimize_pose_graph
    from stereoslam_tpu_torch.parallel.dist_pgo import optimize_pose_graph_sharded

    graph = bridge.pose_graph_from_numpy(_circle_graph_numpy(), dev)
    sharded = optimize_pose_graph_sharded(graph, mesh, gn_iters=4)
    dense = optimize_pose_graph(graph, gn_iters=4, cg_rtol=1e-12, gn_xtol=-1)
    assert torch.equal(sharded, dense)
