"""The port's batched multi-sequence mode against the JAX package's, on the CPU.

Sequences and config are tests/test_parallel.py's (``generate_sequence(
n_frames=12, trajectory="forward", seed=3/5)``, tests/test_system_vo.py's
``make_cfg``).  One JAX ``MultiSeqVO`` run of B=2 is shared: its batched
state before a step goes through ``stereoslam_tpu_torch.bridge`` into the
port's ``batched_track_step``, held per sequence to the JAX step with
tests/test_torch_frontend.py's tolerances (inliers +-2, the other counts
equal, ``T_rk`` within 1e-4, valid agreement >= 99%, median track distance
< 1e-3 px); the port's whole run is held to its keyframes exactly and to
its final positions within 0.1 m (long-horizon poses are not compared:
PARITY.json).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import _fleet  # noqa: E402
from stereoslam_tpu import config as jconfig  # noqa: E402
from stereoslam_tpu.core import state as jstate  # noqa: E402
from stereoslam_tpu.ops.camera import Intrinsics as JIntr  # noqa: E402
from stereoslam_tpu.parallel import multiseq as jms  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core import frontend as pfrontend  # noqa: E402
from stereoslam_tpu_torch.ops import lk as L  # noqa: E402
from stereoslam_tpu_torch.ops import se3  # noqa: E402
from stereoslam_tpu_torch.ops.image import build_lk_pyramid  # noqa: E402
from stereoslam_tpu_torch.parallel import multiseq as pms  # noqa: E402
from stereoslam_tpu_torch.utils.feed import BatchFeed  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402

N_FRAMES = 12
SNAPSHOTS = (3, 7)  # a keyframe-free step and the motion clock's keyframe step


make_cfg = _fleet.make_cfg
_stack = _fleet.stack


def _final_positions(fs_T_rk, ref_kf, kf_T_cw):
    """Each sequence's camera position from its T_rk and reference KF."""
    out = []
    for b in range(len(ref_kf)):
        est = np.asarray(fs_T_rk[b], np.float64) @ np.asarray(kf_T_cw[b][int(ref_kf[b])], np.float64)
        out.append(np.linalg.inv(est)[:3, 3])
    return np.stack(out)


def _gt_position(seq, t):
    return np.linalg.inv(seq.T_cw[t].astype(np.float64))[:3, 3]


@pytest.fixture(scope="module")
def seqs():
    return _fleet.sequences(N_FRAMES)


@pytest.fixture(scope="module")
def jax_run(seqs):
    """The JAX MultiSeqVO run of B=2: state snapshots before the SNAPSHOTS
    steps, keyframes and final positions."""
    cfg = make_cfg(jconfig, seqs[0])
    vo = jms.MultiSeqVO(cfg, batch=2)
    vo.initialize(_stack(seqs, 0, "left"), _stack(seqs, 0, "right"), np.zeros(2))
    snaps = {}
    for t in range(1, N_FRAMES):
        if t in SNAPSHOTS:
            snaps[t] = (bridge.unstack_numpy(vo.fs, 0), bridge.unstack_numpy(vo.fs, 1),
                        bridge.unstack_numpy(vo.maps, 0), bridge.unstack_numpy(vo.maps, 1))
        vo.process_frames(_stack(seqs, t, "left"), _stack(seqs, t, "right"), np.full(2, t * 0.1))
    vo.drain()
    n_kf = np.asarray(vo.maps.n_kf)
    kf_fid = [np.asarray(vo.maps.kf_frame_id[b])[:n_kf[b]] for b in range(2)]
    pos = _final_positions(np.asarray(vo.fs.T_rk), np.asarray(vo.fs.ref_kf),
                           np.asarray(vo.maps.kf_T_cw))
    return dict(cfg=cfg, run_cfg=vo._run_cfg, snaps=snaps, n_kf=n_kf, kf_fid=kf_fid, pos=pos)


def _torch_run_cfg(seqs):
    cfg = make_cfg(pconfig, seqs[0])
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, lk_retry_fail_frac=0.0,
                                                    replenish_min_inliers=0))


# ---------------------------------------------------------------------------
# K1 under a batch
# ---------------------------------------------------------------------------

def test_batched_plain_lk_equals_per_sequence_plain(seqs):
    """Batched plain lk_pyramid (one call for B=2, a mixed gate vector)
    equals per-sequence lk_pyramid_plain exactly; under torch.func.vmap too."""
    a = torch.from_numpy(_stack(seqs, 0, "left").astype(np.uint8)).float()
    b = torch.from_numpy(_stack(seqs, 1, "left").astype(np.uint8)).float()
    pa, pb = build_lk_pyramid(a, 3), build_lk_pyramid(b, 3)
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand((2, 64, 2), generator=gen) * torch.tensor([330.0, 180.0]) + 20.0
    init = pts + torch.rand((2, 64, 2), generator=gen) * 4.0 - 2.0
    kw = dict(iters=20, eps=0.01, forward_backward=0.5, fb_iters=10, fb_levels=2)
    for gate in ([True, False], [False, True], [True, True]):
        g = torch.tensor(gate)
        got = L.lk_pyramid(pa, pb, pts, init, gate=g, **kw)
        mapped = torch.func.vmap(lambda x0, x1, x2, y0, y1, y2, p, i, gi: tuple(L.lk_pyramid(
            (x0, x1, x2), (y0, y1, y2), p, i, gate=gi, **kw)))(*pa, *pb, pts, init, g)
        for s in range(2):
            want = L.lk_pyramid_plain([x[s] for x in pa], [y[s] for y in pb], pts[s], init[s],
                                      gate=g[s], **kw)
            for x, m, y in zip(got, mapped, want):
                assert torch.equal(x[s], y) and torch.equal(m[s], y)
            if not gate[s]:
                assert not bool(want.status.any()) and torch.equal(want.points, init[s])
        assert bool(got.status[0].any()) == gate[0]


# ---------------------------------------------------------------------------
# The batched tracked step from a bridged JAX state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", SNAPSHOTS)
def test_batched_track_step_matches_jax(seqs, jax_run, t):
    fs0, fs1, m0, m1 = jax_run["snaps"][t]
    cam = jax_run["cfg"].camera
    jintr = JIntr.create(cam.fx, cam.fy, cam.cx, cam.cy)
    jstep = jax.jit(functools.partial(jms.batched_track_step, intr=jintr, cfg=jax_run["run_cfg"]))
    fs_np, m_np = bridge.stack_numpy([fs0, fs1]), bridge.stack_numpy([m0, m1])
    jfs = jstate.FrontendState(
        tracks=jstate.TrackState(**{k: jnp.asarray(v) for k, v in fs_np["tracks"].items()}),
        **{k: jnp.asarray(v) for k, v in fs_np.items() if k != "tracks"})
    jm = jstate.MapState(**{k: jnp.asarray(v) for k, v in m_np.items()})
    prev = _stack(seqs, t - 1, "left").astype(np.uint8).astype(np.float32)
    cur = _stack(seqs, t, "left").astype(np.uint8).astype(np.float32)
    jout = jstep(jfs, jm, jnp.asarray(prev), jnp.asarray(cur))

    cfg = _torch_run_cfg(seqs)
    intr, _ = bridge.intrinsics_from_config(cfg)
    pfs = bridge.frontend_state_from_numpy(fs_np, "cpu")
    pm = bridge.map_state_from_numpy(m_np, "cpu")
    pout = pms.batched_track_step(pfs, pm, torch.from_numpy(prev), torch.from_numpy(cur), intr,
                                  cfg)
    for s in range(2):
        assert abs(int(pout.num_inliers[s]) - int(jout.num_inliers[s])) <= 2
        assert int(pout.num_tracked[s]) == int(jout.num_tracked[s])
        js, ps = bridge.unstack_numpy(jout.state, s), bridge.unstack_numpy(pout.state, s)
        assert int(ps["frame_id"]) == int(js["frame_id"]) and int(ps["ref_kf"]) == int(js["ref_kf"])
        np.testing.assert_allclose(ps["T_rk"], js["T_rk"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps["T_vel"], js["T_vel"], atol=1e-4, rtol=0)
        vp, vj = ps["tracks"]["valid"], js["tracks"]["valid"]
        assert (vp == vj).mean() >= 0.99
        d = np.linalg.norm(ps["tracks"]["xy"][vp & vj] - js["tracks"]["xy"][vp & vj], axis=1)
        assert np.median(d) < 1e-3


def test_batched_step_without_hoisting_equals_single_track_frame(seqs):
    """hoist_branches=False keeps the rescue passes, batched with a (B,)
    gate: seq 1's velocity prior is turned by 0.05 rad (16 px at fx 320)
    so its rescue fires while seq 0's does not; each sequence's batched step
    equals the single-sequence track_frame on the same state, with the full
    config."""
    cfg = make_cfg(pconfig, seqs[0])
    vo = pms.MultiSeqVO(cfg, batch=2, hoist_branches=False, enable_loop=False, device="cpu")
    vo.initialize(_stack(seqs, 0, "left"), _stack(seqs, 0, "right"), np.zeros(2))
    for t in (1, 2):
        vo.process_frames(_stack(seqs, t, "left"), _stack(seqs, t, "right"), np.full(2, t * 0.1))
    vel = vo.fs.T_vel.clone()
    vel[1] = se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.05, 0.0])) @ vel[1]
    fs = vo.fs._replace(T_vel=vel)
    lr = torch.from_numpy(np.stack([_stack(seqs, 3, "left"), _stack(seqs, 3, "right")],
                                   1).astype(np.uint8))
    left = lr[:, 0].float()
    intr, _ = bridge.intrinsics_from_config(cfg)
    tmap = pfrontend.TrackMap.of(vo.maps)
    fs2, pyr, packed = pms.batched_track_frame(left, vo._pyr_prev, fs, tmap, intr, cfg, kf_sub=2)
    col = {c: i for i, c in enumerate(pms.OUTCOME_COLUMNS)}
    single = {"num_inliers": 0, "num_tracked": 1, "status": 2, "make_kf": 3, "retry": 8,
              "deep": 9}  # frontend.track_frame's packed outcome
    assert packed[:, col["retry"]].tolist() == [0.0, 1.0]
    for s in range(2):
        sfs, spyr, spk = pfrontend.track_frame(
            left[s], tuple(p[s] for p in vo._pyr_prev), pms._take(fs, s), pms._take(tmap, s),
            intr, cfg)
        for name, i in single.items():
            assert packed[s, col[name]] == spk[i], name
        assert all(torch.equal(p[s], q) for p, q in zip(pyr, spyr))
        np.testing.assert_allclose(fs2.T_rk[s].numpy(), sfs.T_rk.numpy(), atol=1e-5, rtol=0)
        # LK bit for bit: the tracks are the LK call's points and status.
        assert torch.equal(fs2.tracks.valid[s], sfs.tracks.valid)
        assert torch.equal(fs2.tracks.xy[s], sfs.tracks.xy)


# ---------------------------------------------------------------------------
# Loop detection over the batch
# ---------------------------------------------------------------------------

def _detect_case(name, rng):
    """tests/test_parallel.py:314's three sequences (a true revisit, a match
    inside the id gap, a revisit in cooldown), or a random batch."""
    B, K, D = 3, 128, 16
    db = rng.standard_normal((B, K, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    valid = np.zeros((B, K), bool)
    if name == "rules":
        valid[:, :60] = True
        new_kf = np.array([70, 70, 70], np.int32)
        q = np.stack([db[0, 7], db[1, 55], db[2, 7]])
        last = np.array([-(10 ** 6), -(10 ** 6), 68], np.int32)
        make = np.ones(B, bool)
    else:
        valid[:, :rng.integers(40, 100)] = True
        new_kf = rng.integers(-1, 110, B).astype(np.int32)
        q = db[np.arange(B), rng.integers(0, 40, B)] + 0.1 * rng.standard_normal((B, D))
        q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
        last = rng.integers(-(10 ** 6), 100, B).astype(np.int32)
        make = new_kf >= 0
    return dict(deep_db=db, db_valid=valid, loop_with=np.full((B, K), -1, np.int32),
                loop_score=np.zeros((B, K), np.float32), last_closed=last), q, make, new_kf


@pytest.mark.parametrize("name,seed", [("rules", 0), ("random", 3), ("random", 4)])
def test_batched_loop_detect_matches_jax(name, seed):
    rng = np.random.default_rng(seed)
    ldb, q, make, new_kf = _detect_case(name, rng)
    cfg = jconfig.SlamConfig()
    if name == "random":  # thresholds the random similarities reach
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, similarity_high=0.9,
                                                   similarity_low=0.8, database_min_size=30))
    pcfg = pconfig.SlamConfig().replace(loop=pconfig.LoopClosingConfig(
        **dataclasses.asdict(cfg.loop)))
    jl, jf, jk = jax.jit(lambda l, d, m, n: jms.batched_loop_detect(l, d, m, n, cfg))(
        jms.BatchLoopDB(**{k: jnp.asarray(v) for k, v in ldb.items()}), jnp.asarray(q),
        jnp.asarray(make), jnp.asarray(new_kf))
    p_in = bridge.batch_loop_db_from_numpy(ldb, "cpu")
    pl, pf, pk = pms.batched_loop_detect(p_in, torch.from_numpy(q), torch.from_numpy(make),
                                         torch.from_numpy(new_kf), pcfg)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    for k in ("db_valid", "loop_with", "deep_db"):
        np.testing.assert_array_equal(getattr(pl, k).numpy(), np.asarray(getattr(jl, k)))
    np.testing.assert_allclose(pl.loop_score.numpy(), np.asarray(jl.loop_score), atol=1e-6,
                               rtol=0)
    if name == "rules":
        assert pf.tolist() == [True, False, False] and int(pk[0]) == 7
    for k, v in bridge.batch_loop_db_to_numpy(p_in).items():  # the input is left untouched
        assert v is None if ldb.get(k) is None else np.array_equal(v, ldb[k])


# ---------------------------------------------------------------------------
# MultiSeqVO
# ---------------------------------------------------------------------------

def test_multiseq_matches_jax(seqs, jax_run):
    cfg = make_cfg(pconfig, seqs[0])
    vo = pms.MultiSeqVO(cfg, batch=2, device="cpu")
    n_lm = vo.initialize(_stack(seqs, 0, "left"), _stack(seqs, 0, "right"), np.zeros(2))
    assert (n_lm > cfg.features.num_features_init_good).all()
    for t in range(1, N_FRAMES):
        inl = vo.process_frames(_stack(seqs, t, "left"), _stack(seqs, t, "right"),
                                np.full(2, t * 0.1))
        assert (inl > cfg.features.num_features_tracking_bad).all()
    vo.drain()
    assert vo.alive.all() and vo.graph.replays == 0 and vo.outcome_reads == N_FRAMES - 1
    n_kf = vo.maps.n_kf.numpy()
    np.testing.assert_array_equal(n_kf, jax_run["n_kf"])
    for b in range(2):
        np.testing.assert_array_equal(vo.maps.kf_frame_id[b, :n_kf[b]].numpy(),
                                      jax_run["kf_fid"][b])
    pos = _final_positions(vo.fs.T_rk.numpy(), vo.fs.ref_kf.numpy(), vo.maps.kf_T_cw.numpy())
    for b, seq in enumerate(seqs):
        assert np.linalg.norm(pos[b] - jax_run["pos"][b]) < 0.1
        assert np.linalg.norm(pos[b] - _gt_position(seq, N_FRAMES - 1)) < 0.3


def test_multiseq_full_pipeline_runs_ba_and_loopdb(seqs):
    """tests/test_parallel.py:268 on the port, fed by BatchFeed: BA per
    keyframe, per-sequence loop-database insertions, poses on the truth."""
    cfg = make_cfg(pconfig, seqs[0])
    vo = pms.MultiSeqVO(cfg, batch=2, enable_backend=True, enable_loop=True, device="cpu")
    vo.initialize(_stack(seqs, 0, "left"), _stack(seqs, 0, "right"), np.zeros(2))
    feed = BatchFeed(((_stack(seqs, t, "left"), _stack(seqs, t, "right"), np.full(2, t * 0.1))
                      for t in range(1, N_FRAMES)), device="cpu")
    for lr, ts in feed:
        assert lr.dtype == torch.uint8 and tuple(lr.shape[:2]) == (2, 2)
        inl = vo.process_staged(lr, ts)
        assert (inl > cfg.features.num_features_tracking_bad).all()
    vo.drain()
    assert bool(torch.isfinite(vo.maps.kf_T_cw).all())
    assert (vo.maps.n_kf.numpy() >= 2).all()
    assert (vo.loopdb.db_valid.sum(1).numpy() >= 1).all()
    pos = _final_positions(vo.fs.T_rk.numpy(), vo.fs.ref_kf.numpy(), vo.maps.kf_T_cw.numpy())
    for b, seq in enumerate(seqs):
        assert np.linalg.norm(pos[b] - _gt_position(seq, N_FRAMES - 1)) < 0.35


def test_multiseq_kf_sub_batch_defers_and_services_all():
    """tests/test_parallel.py:357 on the port: kf_sub=1 over three
    phase-aligned sequences keyframes at most one a step and still
    services every sequence."""
    trio = [generate_sequence(n_frames=20, trajectory="forward", seed=s) for s in (3, 5, 9)]
    cfg = make_cfg(pconfig, trio[0])
    vo = pms.MultiSeqVO(cfg, batch=3, kf_sub=1, verify_loops=False, device="cpu")
    vo.initialize(_stack(trio, 0, "left"), _stack(trio, 0, "right"), np.zeros(3))
    per_step = []
    prev = vo.maps.n_kf.numpy().copy()
    for t in range(1, 20):
        inl = vo.process_frames(_stack(trio, t, "left"), _stack(trio, t, "right"),
                                np.full(3, t * 0.1))
        assert (inl > cfg.features.num_features_tracking_bad).all()
        now = vo.maps.n_kf.numpy()
        per_step.append(int((now - prev).sum()))
        prev = now.copy()
    vo.drain()
    assert max(per_step) <= 1
    assert (vo.maps.n_kf.numpy() >= 3).all()
    assert sum(per_step) >= 6 and vo.keyframes_serviced == sum(per_step)


def test_multiseq_verify_store_populated(seqs):
    """tests/test_parallel.py:399 on the port: every post-init keyframe row
    carries reduced-pyramid ORB descriptors."""
    cfg = make_cfg(pconfig, seqs[0])
    vo = pms.MultiSeqVO(cfg, batch=2, kf_sub=2, verify_loops=True, orb_levels=2, device="cpu")
    vo.initialize(_stack(seqs, 0, "left"), _stack(seqs, 0, "right"), np.zeros(2))
    for t in range(1, 10):
        vo.process_frames(_stack(seqs, t, "left"), _stack(seqs, t, "right"), np.full(2, t * 0.1))
    vo.drain()
    n_kf = vo.maps.n_kf.numpy()
    assert (n_kf >= 2).all()
    assert vo.loopdb.orb_desc.shape[2] == 2 * cfg.features.max_features
    for b in range(2):
        for k in range(1, int(n_kf[b])):
            assert int(vo.loopdb.orb_valid[b, k].sum()) > 0, f"seq {b} KF {k} has no ORB rows"
    assert vo.loop_edges(0) == [] and vo.keyframe_trajectory(1)[1].shape == (int(n_kf[1]), 3)


def test_bridge_round_trips_a_batched_state(jax_run):
    fs0, fs1, m0, m1 = jax_run["snaps"][SNAPSHOTS[0]]
    fs = bridge.frontend_state_from_numpy(bridge.stack_numpy([fs0, fs1]), "cpu")
    m = bridge.map_state_from_numpy(bridge.stack_numpy([m0, m1]), "cpu")
    for b, (f, mm) in enumerate(((fs0, m0), (fs1, m1))):
        back_f, back_m = bridge.unstack_numpy(fs, b), bridge.unstack_numpy(m, b)
        for k, v in mm.items():
            np.testing.assert_array_equal(back_m[k], v)
        for k, v in f["tracks"].items():
            np.testing.assert_array_equal(back_f["tracks"][k], v)
        np.testing.assert_array_equal(back_f["T_rk"], f["T_rk"])
    assert fs.tracks.xy.shape[0] == 2 and m.lm_pos.shape[0] == 2


def test_multiseq_needs_the_card_or_the_cpu(seqs, monkeypatch):
    cfg = make_cfg(pconfig, seqs[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pms.MultiSeqVO(cfg, batch=2)
    # With a mesh (parallel/mesh.py) too; a CPU mesh over a world of one.
    import torch.distributed as dist

    from stereoslam_tpu_torch.parallel.mesh import make_mesh

    created = not dist.is_initialized()
    mesh = make_mesh(device_type="cpu")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pms.MultiSeqVO(cfg, batch=2, mesh=mesh)
        assert pms.MultiSeqVO(cfg, batch=2, mesh=mesh, device="cpu").rows == range(2)
    finally:
        if created:
            dist.destroy_process_group()
