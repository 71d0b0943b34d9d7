"""The PyTorch port's copies of framework-free modules equal their JAX
originals, and the port and ``chip_smoke.py`` import with jax blocked."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from stereoslam_tpu import config as jax_config  # noqa: E402
from stereoslam_tpu.utils import kitti as jax_kitti  # noqa: E402
from stereoslam_tpu.utils import metrics as jax_metrics  # noqa: E402
from stereoslam_tpu.utils import prof as jax_prof  # noqa: E402
from stereoslam_tpu.utils import synthetic as jax_synthetic  # noqa: E402
from stereoslam_tpu.utils import trajectory as jax_trajectory  # noqa: E402
from stereoslam_tpu.utils import viewer as jax_viewer  # noqa: E402
from stereoslam_tpu.utils import world as jax_world  # noqa: E402
from stereoslam_tpu_torch import config as pt_config  # noqa: E402
from stereoslam_tpu_torch.utils import kitti as pt_kitti  # noqa: E402
from stereoslam_tpu_torch.utils import metrics as pt_metrics  # noqa: E402
from stereoslam_tpu_torch.utils import prof as pt_prof  # noqa: E402
from stereoslam_tpu_torch.utils import synthetic as pt_synthetic  # noqa: E402
from stereoslam_tpu_torch.utils import trajectory as pt_trajectory  # noqa: E402
from stereoslam_tpu_torch.utils import viewer as pt_viewer  # noqa: E402
from stereoslam_tpu_torch.utils import world as pt_world  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "config").glob("KITTI*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_config_copy_loads_identically(path):
    assert len(CONFIGS) == 3
    a = dataclasses.asdict(jax_config.load_config(str(path)))
    b = dataclasses.asdict(pt_config.load_config(str(path)))
    assert a == b
    text = path.read_text()
    assert jax_config.parse_opencv_yaml(text) == pt_config.parse_opencv_yaml(text)


def test_config_copy_defaults_and_validation():
    assert dataclasses.asdict(jax_config.SlamConfig()) == dataclasses.asdict(pt_config.SlamConfig())
    for mod in (jax_config, pt_config):
        with pytest.raises(ValueError):
            mod.CameraConfig(bf=-1.0).validate()
    small = pt_config.SlamConfig(image_height=120, image_width=188).scaled_for_resolution()
    ref = jax_config.SlamConfig(image_height=120, image_width=188).scaled_for_resolution()
    assert dataclasses.asdict(small) == dataclasses.asdict(ref)


@pytest.mark.parametrize("trajectory", ["forward", "loop"])
def test_synthetic_copy_is_bit_equal(trajectory):
    kw = dict(n_frames=6, h=96, w=160, n_points=300, trajectory=trajectory, seed=5, speed=0.4)
    a = jax_synthetic.generate_sequence(**kw)
    b = pt_synthetic.generate_sequence(**kw)
    for f in ("left", "right", "T_cw", "timestamps"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("baseline", "fx", "fy", "cx", "cy"):
        assert getattr(a, f) == getattr(b, f)


@pytest.mark.parametrize("seed,length,width,radius", [(1, 90.0, 50.0, 14.0), (5, 48.0, 32.0, 10.0)])
def test_world_scene_and_trajectory_copies_are_equal(seed, length, width, radius):
    a = jax_world.make_city_circuit(length, width, corner_radius=radius, seed=seed)
    b = pt_world.make_city_circuit(length, width, corner_radius=radius, seed=seed)
    assert a.quads._fields == b.quads._fields
    for name, x, y in zip(a.quads._fields, a.quads, b.quads):
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape == (128,) + x.shape[1:], name
        np.testing.assert_array_equal(x, y, err_msg=name)
    np.testing.assert_array_equal(a.centerline, b.centerline)
    assert a.perimeter == b.perimeter
    for step in (0.8, 0.9):
        assert jax_world.frames_per_lap(step, length, width, radius) == pt_world.frames_per_lap(
            step, length, width, radius)
        kw = dict(n_frames=700, step=step, length=length, width=width, corner_radius=radius)
        np.testing.assert_array_equal(jax_world.circuit_poses(**kw), pt_world.circuit_poses(**kw))
    s = np.linspace(-10.0, 400.0, 997)
    np.testing.assert_array_equal(jax_world._corner_speed(s, length, width, radius, 0.55, 4.0),
                                  pt_world._corner_speed(s, length, width, radius, 0.55, 4.0))
    for x, y in zip(jax_world._rounded_rect_pose(s, length, width, radius),
                    pt_world._rounded_rect_pose(s, length, width, radius)):
        np.testing.assert_array_equal(x, y)
    assert [f.name for f in dataclasses.fields(jax_world.WorldSequence)] == [
        f.name for f in dataclasses.fields(pt_world.WorldSequence)]


def test_metrics_copy_agrees(rng):
    def poses(n):
        T = np.tile(np.eye(4), (n, 1, 1))
        T[:, :3, 3] = np.cumsum(rng.normal(size=(n, 3)), axis=0)
        return T

    est, gt = poses(30), poses(30)
    for align in (False, True):
        assert jax_metrics.ate_rmse(est, gt, align=align) == pt_metrics.ate_rmse(est, gt, align=align)
    assert jax_metrics.rpe(est, gt, delta=2) == pt_metrics.rpe(est, gt, delta=2)


def test_trajectory_writer_matches(tmp_path, rng):
    from stereoslam_tpu.ops import se3 as jse3
    import jax.numpy as jnp

    xi = rng.normal(scale=0.8, size=(6, 6)).astype(np.float32)
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    ids, ts = np.arange(6), np.arange(6) * 0.1
    jax_trajectory.save_trajectory(str(tmp_path / "a.txt"), ids, ts, T)
    pt_trajectory.save_trajectory(str(tmp_path / "b.txt"), ids, ts, T)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    _, _, Ta = jax_trajectory.load_trajectory(str(tmp_path / "a.txt"))
    _, _, Tb = pt_trajectory.load_trajectory(str(tmp_path / "a.txt"))
    np.testing.assert_allclose(Ta, Tb, atol=1e-6)


def drive_profiler(mod, monkeypatch):
    """The same calls on a Profiler of ``mod`` under a fake clock that steps
    1.5 ms a read; returns what each public method gives."""
    clock = iter(np.arange(200) * 1.5e-3)
    monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(clock)))
    p = mod.Profiler()
    with p.stage("load"):  # outside a frame: counted, recorded nowhere
        pass
    for f in range(6):
        rec = p.start_frame(f, 0.1 * f)
        with p.stage("track"):
            pass
        if f % 2:
            with p.stage("ba"):
                with p.stage("track"):
                    pass
            rec.keyframe_id = f // 2
        if f == 5:
            rec.loop_closed_with = 0
        rec.status = 1
        p.end_frame()
    p.end_frame()  # no current frame: nothing recorded
    return [dataclasses.asdict(r) for r in p.frames], p.summary(), [r.to_json() for r in p.frames]


def test_profiler_copy_behaves_the_same(monkeypatch, tmp_path):
    a = drive_profiler(jax_prof, monkeypatch)
    b = drive_profiler(pt_prof, monkeypatch)
    assert a == b
    assert len(a[0]) == 6 and a[1]["track"]["count"] == 9
    assert [f.name for f in dataclasses.fields(jax_prof.FrameRecord)] == [
        f.name for f in dataclasses.fields(pt_prof.FrameRecord)]
    for mod in (jax_prof, pt_prof):
        p = mod.Profiler()
        p.start_frame(3, 0.25).status = 2
        p.end_frame()
        p.dump_jsonl(str(tmp_path / f"{mod.__name__}.jsonl"))
    assert (tmp_path / "stereoslam_tpu.utils.prof.jsonl").read_text() == (
        tmp_path / "stereoslam_tpu_torch.utils.prof.jsonl").read_text()


def test_kitti_copy_reads_paths_and_poses_identically(tmp_path, rng):
    (tmp_path / "times.txt").write_text("".join(f"{float(t)!r}\n" for t in np.cumsum(rng.random(7))) + "\n")
    poses = rng.normal(size=(7, 12))
    np.savetxt(tmp_path / "poses.txt", poses)
    a = jax_kitti.load_image_paths(str(tmp_path))
    b = pt_kitti.load_image_paths(str(tmp_path))
    assert a[0] == b[0] and a[1] == b[1] and len(a[0]) == 7
    np.testing.assert_array_equal(a[2], b[2])
    ga = jax_kitti.load_gt_poses(str(tmp_path / "poses.txt"))
    gb = pt_kitti.load_gt_poses(str(tmp_path / "poses.txt"))
    assert ga.dtype == gb.dtype and ga.shape == gb.shape == (7, 4, 4)
    np.testing.assert_array_equal(ga, gb)


def map_scene(rng):
    """tests/test_cli.py's map: 12 KFs on a forward path, 300 landmarks."""
    n_kf, n_lm = 12, 300
    kf_T = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    kf_T[:, 2, 3] = -1.5 * np.arange(n_kf)
    lm = rng.uniform([-10, -2, 0], [10, 2, 20], (n_lm, 3)).astype(np.float32)
    valid = np.ones(n_lm, bool)
    valid[::7] = False
    return kf_T, lm, valid, [(10, 2)]


def test_viewer_copy_exports_the_same_ply_and_draws(tmp_path, rng):
    kf_T, lm, valid, edges = map_scene(rng)
    a = jax_viewer.export_ply(kf_T, lm, valid, edges, out_path=str(tmp_path / "a.ply"))
    b = pt_viewer.export_ply(kf_T, lm, valid, edges, out_path=str(tmp_path / "b.ply"))
    assert open(a).read() == open(b).read()
    assert f"element vertex {int(valid.sum()) + 12}" in open(b).read()
    png = pt_viewer.plot_map_3d(kf_T, lm, valid, edges, out_path=str(tmp_path / "map3d.png"))
    assert os.path.getsize(png) > 10_000


CAFFE_PARSERS = ("_read_varint", "parse_message", "_packed_floats", "_packed_varints",
                 "_parse_blob", "_first_int", "_spatial_pair", "LayerSpec", "_parse_layer",
                 "CaffeNet", "load_caffemodel", "_tokenize_prototxt", "_parse_block",
                 "parse_prototxt", "_proto_int", "_proto_pair", "_spec_from_prototxt",
                 "load_prototxt_net", "_caffe_pool_out")


@pytest.mark.parametrize("name", CAFFE_PARSERS)
def test_caffe_parsers_are_copies(name):
    """The host-side Caffe parsers (protobuf wire format, prototxt) are the
    JAX package's, character for character."""
    import inspect

    from stereoslam_tpu.models import import_caffe as jax_caffe
    from stereoslam_tpu_torch.models import import_caffe as pt_caffe

    assert inspect.getsource(getattr(pt_caffe, name)) == inspect.getsource(getattr(jax_caffe, name))
    assert pt_caffe._V1_TYPE_NAMES == jax_caffe._V1_TYPE_NAMES


def test_jittered_pose_is_a_copy():
    """The corpus renderer's viewpoint jitter is the JAX package's function,
    character for character, and draws the same poses from the same rng."""
    import inspect

    from stereoslam_tpu.models import train_calc as jax_train
    from stereoslam_tpu_torch.models import train_calc as pt_train

    assert inspect.getsource(pt_train._jittered_pose) == inspect.getsource(jax_train._jittered_pose)
    T = np.eye(4)
    T[:3, 3] = (3.0, 0.0, -7.0)
    np.testing.assert_array_equal(pt_train._jittered_pose(T, np.random.default_rng(4)),
                                  jax_train._jittered_pose(T, np.random.default_rng(4)))


def test_native_loader_source_is_a_byte_copy():
    assert (REPO / "stereoslam_tpu_torch/native/dataloader.cpp").read_bytes() == (
        REPO / "stereoslam_tpu/native/dataloader.cpp").read_bytes()
    # The port builds its libraries at first use; none lies beside the source.
    assert [p for p in (REPO / "stereoslam_tpu_torch").rglob("*.so") if "_build" not in p.parts] == []


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['stereoslam_tpu'] = None\n"
        "import stereoslam_tpu_torch, stereoslam_tpu_torch.bridge\n"
        "import stereoslam_tpu_torch.core.system, stereoslam_tpu_torch.ops.lk_level, chip_smoke\n"
        "import stereoslam_tpu_torch.eval, stereoslam_tpu_torch.utils.world\n"
        "import stereoslam_tpu_torch.utils.feed, stereoslam_tpu_torch.utils.checkpoint\n"
        "import stereoslam_tpu_torch.run, stereoslam_tpu_torch.utils.kitti\n"
        "import stereoslam_tpu_torch.utils.prof, stereoslam_tpu_torch.utils.viewer\n"
        "import stereoslam_tpu_torch.native.dataloader, stereoslam_tpu_torch.parallel.multiseq\n"
        "import stereoslam_tpu_torch.models.import_caffe, stereoslam_tpu_torch.models.train_calc\n"
        "import importlib.util as u\n"
        "spec = u.spec_from_file_location('train_default', 'scripts/torch_train_calc_default.py')\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
