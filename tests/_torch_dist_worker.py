"""One rank of the port's multi-process CPU run (``tests/test_torch_parallel.py``).

    python tests/_torch_dist_worker.py RANK WORLD_SIZE STORE INPUTS OUT

Joins a Gloo process group of WORLD_SIZE ranks through the file store STORE,
reads the seeded numpy inputs that the test wrote to INPUTS (an npz), runs
the port's sharded ops, the mesh-sharded loop closer and ``MultiSeqVO`` over
a mesh of all ranks, and writes this rank's results to OUT (an npz).  It
imports torch, numpy and the port only, never JAX.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stereoslam_tpu_torch import bridge  # noqa: E402
from stereoslam_tpu_torch.config import (CameraConfig, FeatureConfig, MapConfig,  # noqa: E402
                                         SlamConfig)
from stereoslam_tpu_torch.core.loopclosing import LoopCloser  # noqa: E402
from stereoslam_tpu_torch.models.calc import DescriptorModel  # noqa: E402
from stereoslam_tpu_torch.ops.camera import Intrinsics  # noqa: E402
from stereoslam_tpu_torch.parallel import distributed  # noqa: E402
from stereoslam_tpu_torch.parallel.dist_ba import solve_window_ba_sharded  # noqa: E402
from stereoslam_tpu_torch.parallel.dist_lcd import sharded_descriptor_search  # noqa: E402
from stereoslam_tpu_torch.parallel.dist_pgo import optimize_pose_graph_sharded  # noqa: E402
from stereoslam_tpu_torch.parallel.mesh import axis_size, make_mesh  # noqa: E402
from stereoslam_tpu_torch.parallel.multiseq import MultiSeqVO, make_data_parallel_step  # noqa: E402


def sub(inputs, prefix: str) -> dict:
    """The inputs under ``prefix/``, as a dict of numpy arrays."""
    return {k[len(prefix) + 1:]: inputs[k] for k in inputs.files if k.startswith(prefix + "/")}


def multiseq_config(seq: dict) -> SlamConfig:
    """tests/test_system_vo.py's make_cfg for the sequences' camera."""
    fx, fy, cx, cy, bf = (float(seq[k]) for k in ("fx", "fy", "cx", "cy", "bf"))
    h, w = seq["left"].shape[-2:]
    return SlamConfig(
        camera=CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, fx_right=fx, fy_right=fy, cx_right=cx,
                            cy_right=cy, bf=bf),
        features=FeatureConfig(n_init_features=200, n_new_features=100, max_features=256,
                               num_features_init_good=50, num_features_tracking_good=50,
                               num_features_tracking_bad=10),
        map=MapConfig(max_keyframes=256, max_landmarks=20000),
        image_height=int(h), image_width=int(w))


def run_multiseq(seq: dict, mesh) -> dict:
    """MultiSeqVO over the two sequences, the batch sharded over the data axis."""
    cfg = multiseq_config(seq)
    left, right = seq["left"], seq["right"]            # (T, B, H, W)
    B = left.shape[1]
    vo = MultiSeqVO(cfg, batch=B, mesh=mesh, device="cpu")
    n_lm = vo.initialize(left[0], right[0], np.zeros(B))
    counts = []
    for t in range(1, left.shape[0]):
        vo.process_frames(left[t], right[t], np.full(B, t * 0.1))
        counts.append(vo._last_counts.copy())
    vo.drain()
    return {"rows": np.array([vo.rows.start, vo.rows.stop]), "n_lm": n_lm,
            "counts": np.stack(counts), "alive": vo.alive, "T_rk": vo.fs.T_rk.numpy(),
            "ref_kf": vo.fs.ref_kf.numpy(), "kf_T_cw": vo.maps.kf_T_cw.numpy(),
            "n_kf": vo.maps.n_kf.numpy(), "outcome_reads": np.array(vo.outcome_reads)}


def run_data_parallel_step(seq: dict, mesh) -> dict:
    """make_data_parallel_step on the state after stereo initialization: the
    rank's rows of the whole step against the step on the rank's rows."""
    cfg = multiseq_config(seq)
    left, right = seq["left"], seq["right"]
    B = left.shape[1]
    vo = MultiSeqVO(cfg, batch=B, device="cpu")
    vo.initialize(left[0], right[0], np.zeros(B))
    step, shard_batch = make_data_parallel_step(mesh, vo.intr, vo._run_cfg)
    prev = torch.from_numpy(left[0]).float()
    cur = torch.from_numpy(left[1]).float()
    full = step(vo.fs, vo.maps, prev, cur)
    mine = step(*shard_batch((vo.fs, vo.maps, prev, cur)))
    return {"full_inliers": full.num_inliers.numpy(), "full_T_rk": full.state.T_rk.numpy(),
            "full_xy": full.state.tracks.xy.numpy(),
            "mine_inliers": mine.num_inliers.numpy(), "mine_T_rk": mine.state.T_rk.numpy(),
            "mine_xy": mine.state.tracks.xy.numpy()}


def main() -> None:
    rank, world, store, inputs_path, out = sys.argv[1:6]
    up = distributed.initialize(init_method=f"file://{store}", world_size=int(world),
                                rank=int(rank), device="cpu")
    inputs = np.load(inputs_path)
    res = {"initialized": np.array(up), "process_count": np.array(distributed.process_count()),
           "process_index": np.array(distributed.process_index())}

    mesh = make_mesh(device_type="cpu")
    res["mesh_default"] = np.array([axis_size(mesh, "data"), axis_size(mesh, "model")])
    mesh_dp = make_mesh(dp=int(world), device_type="cpu")
    res["mesh_dp"] = np.array([axis_size(mesh_dp, "data"), axis_size(mesh_dp, "model")])
    try:
        make_mesh(dp=int(world) + 1, device_type="cpu")
        res["mesh_bad_raised"] = np.array(False)
    except ValueError:
        res["mesh_bad_raised"] = np.array(True)
    res["host_local"] = distributed.host_local_array(
        mesh, "model", np.full((2, 3), int(rank), np.float32)).numpy()

    for case in ("search_dense", "search_gate"):
        d = sub(inputs, case)
        r = sharded_descriptor_search(torch.from_numpy(d["db"]), torch.from_numpy(d["valid"]),
                                      torch.from_numpy(d["q"]), int(d["eligible_max_id"]),
                                      float(d["low"]), mesh)
        res[f"{case}/result"] = np.array([float(r.best_id), float(r.best_score),
                                          float(r.n_suspect)])

    ba = sub(inputs, "ba")
    intr = Intrinsics.create(*(float(v) for v in ba.pop("intr")))
    out_ba = solve_window_ba_sharded(bridge.ba_problem_from_numpy(ba, "cpu"), intr, mesh,
                                     rounds=2, iters=8)
    res["ba/cam_T"], res["ba/lm_pos"] = out_ba.cam_T.numpy(), out_ba.lm_pos.numpy()
    res["ba/inlier"], res["ba/chi2"] = out_ba.obs_inlier.numpy(), out_ba.chi2.numpy()

    graph = bridge.pose_graph_from_numpy(sub(inputs, "pgo"), "cpu")
    stats: dict = {}
    res["pgo/poses"] = optimize_pose_graph_sharded(graph, mesh, gn_iters=8, stats=stats).numpy()
    res["pgo/cg_iters"] = np.array(stats["cg_iters"])

    lc = sub(inputs, "loop")
    kf_id = int(lc.pop("kf_id"))
    loop = bridge.loop_state_from_numpy(lc, "cpu")
    cfg = SlamConfig()
    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, similarity_high=0.8,
                                               similarity_low=0.5, max_above_low=8))
    intr_lc = Intrinsics.create(400.0, 400.0, 320.0, 160.0)
    for name, m in (("mesh", mesh), ("plain", None)):
        closer = LoopCloser(cfg, intr_lc, "cpu", descriptor_model=DescriptorModel(), mesh=m)
        res[f"loop/{name}"] = closer._detect_impl(loop, kf_id)[1].numpy()

    seq = sub(inputs, "seq")
    for k, v in run_multiseq(seq, mesh_dp).items():
        res[f"multiseq/{k}"] = v
    for k, v in run_data_parallel_step(seq, mesh_dp).items():
        res[f"step/{k}"] = v
    np.savez(out, **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
