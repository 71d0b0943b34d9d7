"""The port's multi-device modules against the JAX package's sharded twins, on
the CPU.

``tests/_torch_dist_worker.py`` (JAX-free) runs once for this module as two
Gloo ranks joined through a file store under ``tmp_path``; it reads the
seeded numpy inputs written here and writes each rank's results to an npz.
This process computes the JAX package's sharded twins on a 2-device mesh
(``make_mesh(dp=1, mp=2, devices=jax.devices()[:2])``, from conftest's 8
virtual CPU devices) on the same inputs, while the ranks run.  Mirrors
``tests/test_parallel.py`` (line numbers there):

- mesh construction (``:22``), and ``host_local_array``;
- the search against JAX and the dense scan: id and count equal, score
  within 1e-5 (``:29``), the id gate (``:50``), a tie across the two shards
  going to the lower id;
- BA on ``make_ba_problem(n_shards=2)``: ``cam_T`` within 2e-3 of JAX's
  sharded result, both within 5e-3 of the ground truth (``:102``); the port
  keeps its float64 solve and damping floor;
- ``shard_problem`` equal to JAX's (``:120``);
- PGO on ``:182``'s circle within 2e-3 of JAX's sharded result;
- at world size 1 (a group of one in this process) the sharded search and
  PGO equal their dense twins bit for bit;
- ``LoopCloser(mesh=...)`` detection on a bridged ``LoopState`` equal to the
  mesh-less closer's; ``StereoSlam(mesh=...)`` defaults to ``inline_ba=False``;
- ``MultiSeqVO(mesh=...)`` at B=2 over ``:144``'s two 12-frame sequences,
  one sequence a rank: each step's status and keyframe flags equal to the
  unsharded port's, ``T_rk`` within 1e-3, each sequence within 0.3 m of the
  ground truth; ``make_data_parallel_step`` gives the rank's rows of the
  whole step.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(2)

from stereoslam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from stereoslam_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from stereoslam_tpu.config import MapConfig as JMapConfig  # noqa: E402
from stereoslam_tpu.core.state import init_loop_state  # noqa: E402
from stereoslam_tpu.ops import se3 as jse3  # noqa: E402
from stereoslam_tpu.ops.pgo import PoseGraph as JPoseGraph  # noqa: E402
from stereoslam_tpu.parallel import dist_ba as jdist_ba  # noqa: E402
from stereoslam_tpu.parallel import dist_lcd as jdist_lcd  # noqa: E402
from stereoslam_tpu.parallel import dist_pgo as jdist_pgo  # noqa: E402
from stereoslam_tpu.parallel import mesh as jmesh  # noqa: E402
from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.core.loopclosing import LoopCloser  # noqa: E402
from stereoslam_tpu_torch.core.system import StereoSlam  # noqa: E402
from stereoslam_tpu_torch.models.calc import DescriptorModel  # noqa: E402
from stereoslam_tpu_torch.ops.camera import Intrinsics  # noqa: E402
from stereoslam_tpu_torch.ops.pgo import optimize_pose_graph  # noqa: E402
from stereoslam_tpu_torch.parallel import dist_ba as pdist_ba  # noqa: E402
from stereoslam_tpu_torch.parallel.dist_lcd import sharded_descriptor_search  # noqa: E402
from stereoslam_tpu_torch.parallel.dist_pgo import optimize_pose_graph_sharded  # noqa: E402
from stereoslam_tpu_torch.parallel.mesh import axis_size, make_mesh  # noqa: E402
from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402
from tests.test_parallel import INTR, make_ba_problem  # noqa: E402
from tests.test_torch_multiseq import make_cfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
N_FRAMES = 12
WORKER_TIMEOUT_S = 300
K_LOOP, KF_LOOP = 64, 60
INTR_P = Intrinsics.create(INTR.fx, INTR.fy, INTR.cx, INTR.cy)


# ---------------------------------------------------------------------------
# Inputs, both packages
# ---------------------------------------------------------------------------

def _search_inputs():
    rng = np.random.default_rng(0)
    K, D = 64, 128
    db = rng.standard_normal((K, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[17] + rng.standard_normal(D).astype(np.float32) * 0.05
    q /= np.linalg.norm(q)
    valid = np.ones(K, bool)
    valid[40:44] = False
    dense = dict(db=db, valid=valid, q=q, eligible_max_id=np.int32(K), low=np.float32(0.5))
    K, D = 64, 32
    db = rng.standard_normal((K, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    gate = dict(db=db, valid=np.ones(K, bool), q=db[60].copy(), eligible_max_id=np.int32(40),
                low=np.float32(0.9))
    return {"search_dense": dense, "search_gate": gate}


def _circle_graph(rng):
    """tests/test_parallel.py:182's drifted circle: 40 vertices in 48 rows,
    odometry with 0.01 noise and one loop edge, 96 edge rows."""
    K, n = 48, 40
    poses_gt = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        c, s = np.cos(ang), np.sin(ang)
        T_wc = np.eye(4)
        T_wc[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T_wc[:3, 3] = [5.0 * (1 - c), 0, 5.0 * s]
        poses_gt.append(np.linalg.inv(T_wc))
    poses_gt = np.stack(poses_gt).astype(np.float32)
    rel_meas, est = [], [poses_gt[0]]
    for i in range(1, n):
        rel = poses_gt[i] @ np.linalg.inv(poses_gt[i - 1])
        noise = np.asarray(jse3.exp(jnp.asarray((rng.standard_normal(6) * 0.01).astype(np.float32))))
        rel_meas.append(noise @ rel)
        est.append(rel_meas[-1] @ est[-1])
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:n] = np.stack(est)
    vertex_valid = np.zeros(K, bool)
    vertex_valid[:n] = True
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fixed[n:] = True
    E = 2 * K
    edge_i, edge_j = np.zeros(E, np.int32), np.zeros(E, np.int32)
    edge_meas = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    edge_valid = np.zeros(E, bool)
    for i in range(1, n):
        edge_i[i], edge_j[i], edge_meas[i], edge_valid[i] = i, i - 1, rel_meas[i - 1], True
    edge_i[n], edge_j[n] = n - 1, 0
    edge_meas[n] = poses_gt[n - 1] @ np.linalg.inv(poses_gt[0])
    edge_valid[n] = True
    return dict(poses=poses, vertex_valid=vertex_valid, fixed=fixed, edge_i=edge_i, edge_j=edge_j,
                edge_meas=edge_meas.astype(np.float32), edge_valid=edge_valid)


def _loop_state():
    """A JAX LoopState of 64 rows: random unit descriptors, KF 60 the query,
    its near-copies at rows 12 and 40 (one on each shard, an exact tie; both
    outside the 20-id gap)."""
    cfg = JSlamConfig(features=JFeatureConfig(max_features=8, n_levels=1),
                      map=JMapConfig(max_keyframes=K_LOOP))
    st = {k: np.asarray(v) for k, v in init_loop_state(cfg)._asdict().items()}
    rng = np.random.default_rng(11)
    D = st["deep_db"].shape[1]
    db = rng.standard_normal((K_LOOP, D)).astype(np.float32)
    near = db[KF_LOOP] + rng.standard_normal(D).astype(np.float32) * 0.3
    db[12] = db[40] = near
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    st["deep_db"] = db
    st["db_valid"] = np.arange(K_LOOP) <= KF_LOOP
    return st


@pytest.fixture(scope="module")
def seqs():
    return [generate_sequence(n_frames=N_FRAMES, trajectory="forward", seed=s) for s in (3, 5)]


@pytest.fixture(scope="module")
def inputs(seqs):
    rng = np.random.default_rng(0)
    prob, cam_gt, X_gt = make_ba_problem(rng, n_shards=WORLD)
    out = dict(_search_inputs())
    out["ba"] = {k: np.asarray(v) for k, v in prob._asdict().items()}
    out["pgo"] = _circle_graph(np.random.default_rng(0))
    out["loop"] = dict(_loop_state(), kf_id=np.int32(KF_LOOP))
    s = seqs[0]
    out["seq"] = dict(left=np.stack([q.left for q in seqs], 1), right=np.stack([q.right for q in seqs], 1),
                      fx=s.fx, fy=s.fy, cx=s.cx, cy=s.cy, bf=s.fx * s.baseline)
    return out, prob, cam_gt


class Ranks:
    """The worker processes, started at once and read on first use."""

    def __init__(self, tmp, flat: dict):
        self.tmp = tmp
        np.savez(tmp / "inputs.npz", **flat)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"), str(r),
             str(WORLD), str(tmp / "store"), str(tmp / "inputs.npz"), str(tmp / f"out{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
        self._out = None

    def out(self):
        if self._out is None:
            deadline = time.monotonic() + WORKER_TIMEOUT_S
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
                except subprocess.TimeoutExpired:
                    self.kill()
                    raise
            failed = [r for r, p in enumerate(self.procs) if p.returncode != 0]
            assert not failed, "\n".join(f"rank {r}:\n{logs[r].decode(errors='replace')[-3000:]}"
                                         for r in failed)
            self._out = [dict(np.load(self.tmp / f"out{r}.npz")) for r in range(WORLD)]
        return self._out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    flat = {f"{group}/{k}": np.asarray(v) for group, d in inputs[0].items() for k, v in d.items()}
    flat["ba/intr"] = np.array([INTR.fx, INTR.fy, INTR.cx, INTR.cy], np.float32)
    r = Ranks(tmp_path_factory.mktemp("dist"), flat)
    yield r
    r.kill()


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(dp=1, mp=WORLD, devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def mesh1(ranks):
    """A mesh over a world of one (this process).  It asks for ``ranks`` so
    that the worker ranks run while this process does its own work."""
    created = not dist.is_initialized()
    mesh = make_mesh(device_type="cpu")
    yield mesh
    if created:
        dist.destroy_process_group()


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# World size 1: the sharded ops are their dense twins
# ---------------------------------------------------------------------------

def test_world_size_one_search_equals_the_dense_scan(mesh1):
    loop = bridge.loop_state_from_numpy(_loop_state(), "cpu")
    cfg = pconfig.SlamConfig()
    packed = [LoopCloser(cfg, INTR_P, "cpu", descriptor_model=DescriptorModel(), mesh=m)
              ._detect_impl(loop, KF_LOOP)[1] for m in (mesh1, None)]
    assert torch.equal(packed[0], packed[1])
    d = _search_inputs()["search_dense"]
    res = sharded_descriptor_search(_t(d["db"]), _t(d["valid"]), _t(d["q"]), 64, 0.5, mesh1)
    scores = _t(d["db"]) @ _t(d["q"])
    scores = torch.where(_t(d["valid"]), scores, torch.full_like(scores, -1.0))
    assert int(res.best_id) == int(torch.argmax(scores))
    assert torch.equal(res.best_score, scores[torch.argmax(scores)])


def test_world_size_one_pgo_equals_the_dense_solver(mesh1):
    graph = bridge.pose_graph_from_numpy(_circle_graph(np.random.default_rng(0)), "cpu")
    stats_s, stats_d = {}, {}
    sharded = optimize_pose_graph_sharded(graph, mesh1, gn_iters=8, stats=stats_s)
    dense = optimize_pose_graph(graph, gn_iters=8, cg_rtol=1e-12, gn_xtol=-1, stats=stats_d)
    assert torch.equal(sharded, dense)
    assert stats_s == stats_d


def test_world_size_one_ba_matches_the_truth(mesh1, inputs):
    _, prob, cam_gt = inputs
    out = pdist_ba.solve_window_ba_sharded(bridge.ba_problem_from_numpy(prob, "cpu"), INTR_P,
                                           mesh1, rounds=2, iters=8)
    err = np.asarray(jax.vmap(lambda a, b: jse3.log(a @ jse3.inv(b)))(
        jnp.asarray(out.cam_T.numpy()), jnp.asarray(cam_gt)))
    assert np.abs(err).max() < 5e-3


def test_stereoslam_with_a_mesh_runs_ba_at_retire(mesh1, seqs):
    cfg = make_cfg(pconfig, seqs[0])
    assert not StereoSlam(cfg, device="cpu", enable_loop=False, mesh=mesh1).inline_ba
    assert StereoSlam(cfg, device="cpu", enable_loop=False).inline_ba
    assert StereoSlam(cfg, device="cpu", enable_loop=False, mesh=mesh1, inline_ba=True).inline_ba
    slam = StereoSlam(cfg, device="cpu", mesh=mesh1, descriptor_model=DescriptorModel())
    assert slam._loop_closer.mesh is mesh1


# ---------------------------------------------------------------------------
# Two ranks against JAX
# ---------------------------------------------------------------------------

def test_mesh_constructor_matches_jax_shapes(mesh1):
    """tests/test_parallel.py:22 in one process: every device on the model axis."""
    assert axis_size(mesh1, "model") == 1 and axis_size(mesh1, "data") == 1
    assert dict(jmesh.make_mesh(devices=jax.devices()[:WORLD]).shape) == {"data": 1, "model": WORLD}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(dp=2, device_type="cpu")


@pytest.mark.parametrize("case", ["search_dense", "search_gate"])
def test_sharded_search_matches_jax_and_the_dense_scan(ranks, inputs, jax_mesh, case):
    d = inputs[0][case]
    j = jdist_lcd.sharded_descriptor_search(jnp.asarray(d["db"]), jnp.asarray(d["valid"]),
                                            jnp.asarray(d["q"]), jnp.int32(d["eligible_max_id"]),
                                            float(d["low"]), jax_mesh)
    scores = d["db"] @ d["q"]
    ok = d["valid"] & (np.arange(len(scores)) < d["eligible_max_id"])
    scores = np.where(ok, scores, -1.0)
    for out in ranks.out():
        best_id, best_score, n_sus = out[f"{case}/result"]
        assert int(best_id) == int(j.best_id) == int(np.argmax(scores))
        assert int(n_sus) == int(j.n_suspect) == int((scores > d["low"]).sum())
        assert abs(best_score - float(j.best_score)) <= 1e-5
        np.testing.assert_allclose(best_score, scores.max(), rtol=1e-5)
    if case == "search_gate":
        assert int(best_id) < 40   # the perfect match at 60 is too recent


def test_sharded_ba_matches_jax_and_the_truth(ranks, inputs, jax_mesh):
    _, prob, cam_gt = inputs
    j = np.asarray(jdist_ba.solve_window_ba_sharded(prob, INTR, jax_mesh, rounds=2, iters=8).cam_T)

    def gt_err(T):
        return np.abs(np.asarray(jax.vmap(lambda a, b: jse3.log(a @ jse3.inv(b)))(
            jnp.asarray(T), jnp.asarray(cam_gt)))).max()

    assert gt_err(j) < 5e-3
    outs = ranks.out()
    for out in outs:
        assert np.abs(out["ba/cam_T"] - j).max() <= 2e-3
        assert gt_err(out["ba/cam_T"]) < 5e-3
        assert out["ba/cam_T"].dtype == np.float32
    # Every rank returns the whole, identical result.
    for k in ("cam_T", "lm_pos", "inlier", "chi2"):
        np.testing.assert_array_equal(outs[0][f"ba/{k}"], outs[1][f"ba/{k}"])


def test_shard_problem_equals_jax(inputs):
    """tests/test_parallel.py:120: a scrambled observation layout re-sharded."""
    _, prob, _ = inputs
    rng = np.random.default_rng(1)
    perm = rng.permutation(prob.obs_valid.shape[1])
    scrambled = prob._replace(obs_lm=prob.obs_lm[:, perm], obs_px=prob.obs_px[:, perm],
                              obs_valid=prob.obs_valid[:, perm])
    j = jdist_ba.shard_problem(scrambled, WORLD)
    p = pdist_ba.shard_problem(bridge.ba_problem_from_numpy(scrambled, "cpu"), WORLD)
    for k in ("obs_lm", "obs_px", "obs_valid"):
        np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(getattr(j, k)))
    C, N = prob.lm_pos.shape[0], prob.obs_valid.shape[1]
    lm, valid = p.obs_lm.numpy(), p.obs_valid.numpy()
    for s in range(WORLD):
        cols = slice(s * N // WORLD, (s + 1) * N // WORLD)
        assert ((lm[:, cols][valid[:, cols]] // (C // WORLD)) == s).all()


def test_sharded_pgo_matches_jax(ranks, inputs, jax_mesh):
    g = inputs[0]["pgo"]
    j = np.asarray(jdist_pgo.optimize_pose_graph_sharded(
        JPoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}), jax_mesh, gn_iters=8))
    outs = ranks.out()
    worst = max(np.abs(out["pgo/poses"] - j).max() for out in outs)
    print(f"sharded PGO, 2 Gloo ranks against JAX's 2-device shard_map: max |d pose| {worst:.3e}, "
          f"CG iterations {int(outs[0]['pgo/cg_iters'])}")
    assert worst <= 2e-3
    np.testing.assert_array_equal(outs[0]["pgo/poses"], outs[1]["pgo/poses"])
    fixed = g["fixed"] | ~g["vertex_valid"]
    np.testing.assert_array_equal(outs[0]["pgo/poses"][fixed], g["poses"][fixed])


def test_mesh_loop_closer_detects_as_the_mesh_less_one(ranks):
    for out in ranks.out():
        np.testing.assert_array_equal(out["loop/mesh"], out["loop/plain"])
        found, loop_kf, _ = out["loop/mesh"]
        assert found == 1 and int(loop_kf) == 12   # the tie goes to the lower id




def test_two_ranks_join_and_build_meshes(ranks):
    for r, out in enumerate(ranks.out()):
        assert bool(out["initialized"]) and int(out["process_count"]) == WORLD
        assert int(out["process_index"]) == r
        assert out["mesh_default"].tolist() == [1, WORLD]   # every rank on the model axis
        assert out["mesh_dp"].tolist() == [WORLD, 1]
        assert bool(out["mesh_bad_raised"])
        # host_local_array: rank r's two rows of r, in rank order, on both ranks.
        np.testing.assert_array_equal(out["host_local"], np.repeat(np.arange(WORLD), 2)[:, None]
                                      * np.ones((1, 3), np.float32))


# ---------------------------------------------------------------------------
# MultiSeqVO over the data axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded(seqs):
    """The port's MultiSeqVO over both sequences in one process, no mesh."""
    cfg = make_cfg(pconfig, seqs[0])
    vo = MultiSeqVO(cfg, batch=2, device="cpu")
    vo.initialize(*(np.stack([getattr(q, f)[0] for q in seqs]) for f in ("left", "right")),
                  np.zeros(2))
    counts = []
    for t in range(1, N_FRAMES):
        vo.process_frames(np.stack([q.left[t] for q in seqs]), np.stack([q.right[t] for q in seqs]),
                          np.full(2, t * 0.1))
        counts.append(vo._last_counts.copy())
    vo.drain()
    return dict(counts=np.stack(counts), T_rk=vo.fs.T_rk.numpy())


def _position(T_rk, ref, kf_T_cw):
    return np.linalg.inv(T_rk.astype(np.float64) @ kf_T_cw[int(ref)].astype(np.float64))[:3, 3]


def test_multiseq_over_a_mesh_matches_the_unsharded_port(ranks, unsharded, seqs):
    for r, out in enumerate(ranks.out()):
        lo, hi = out["multiseq/rows"].tolist()
        assert (lo, hi) == (r, r + 1)
        c, u = out["multiseq/counts"], unsharded["counts"]
        # Every rank sees every sequence's status; its own keyframes are the
        # unsharded run's, so the global kf_sub selection was the same.
        np.testing.assert_array_equal(c[:, :, 2], u[:, :, 2])
        np.testing.assert_array_equal(c[:, lo:hi, 3], u[:, lo:hi, 3])
        assert np.abs(c[:, :, 0] - u[:, :, 0]).max() <= 2
        assert out["multiseq/alive"].all() and int(out["multiseq/outcome_reads"]) == N_FRAMES - 1
        assert np.abs(out["multiseq/T_rk"][0] - unsharded["T_rk"][r]).max() <= 1e-3
        pos = _position(out["multiseq/T_rk"][0], out["multiseq/ref_kf"][0],
                        out["multiseq/kf_T_cw"][0])
        gt = np.linalg.inv(seqs[r].T_cw[N_FRAMES - 1].astype(np.float64))[:3, 3]
        assert np.linalg.norm(pos - gt) < 0.3


def test_data_parallel_step_gives_the_ranks_rows(ranks):
    for r, out in enumerate(ranks.out()):
        np.testing.assert_array_equal(out["step/mine_inliers"], out["step/full_inliers"][r:r + 1])
        np.testing.assert_allclose(out["step/mine_T_rk"], out["step/full_T_rk"][r:r + 1], atol=1e-5)
        np.testing.assert_allclose(out["step/mine_xy"], out["step/full_xy"][r:r + 1], atol=1e-3)
