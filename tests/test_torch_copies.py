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
from stereoslam_tpu.utils import metrics as jax_metrics  # noqa: E402
from stereoslam_tpu.utils import synthetic as jax_synthetic  # noqa: E402
from stereoslam_tpu.utils import trajectory as jax_trajectory  # noqa: E402
from stereoslam_tpu_torch import config as pt_config  # noqa: E402
from stereoslam_tpu_torch.utils import metrics as pt_metrics  # noqa: E402
from stereoslam_tpu_torch.utils import synthetic as pt_synthetic  # noqa: E402
from stereoslam_tpu_torch.utils import trajectory as pt_trajectory  # noqa: E402

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


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['stereoslam_tpu'] = None\n"
        "import stereoslam_tpu_torch, stereoslam_tpu_torch.bridge\n"
        "import stereoslam_tpu_torch.core.system, stereoslam_tpu_torch.ops.lk_level, chip_smoke\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
