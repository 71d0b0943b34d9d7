"""The batched multi-sequence mode with a distorted camera config, on the CPU.

The JAX package's ``MultiSeqVO`` reads only the pinhole intrinsics of
``cfg.camera`` (``stereoslam_tpu/parallel/multiseq.py:218-220``) and tracks
distorted frames as they are.  The port does the same: a config with
``need_undistortion`` and non-zero k1..p2 runs, bit for bit as the same
config with the coefficients zeroed, and logs once that the batched mode
does not undistort.  Sequences and config are ``tests/test_parallel.py``'s
(two forward sequences, seeds 3 and 5, ``make_cfg``), cut to 6 frames.
"""

import dataclasses
import logging

import numpy as np
import torch

torch.set_num_threads(2)

from stereoslam_tpu_torch import config as pconfig  # noqa: E402
from stereoslam_tpu_torch.parallel import multiseq as pms  # noqa: E402
from stereoslam_tpu_torch.utils.synthetic import generate_sequence  # noqa: E402
from tests.test_torch_multiseq import make_cfg  # noqa: E402

N_FRAMES = 6
# bench.py:125-140's undistortion-ON coefficients, with tangential terms.
DISTORTION = dict(k1=-0.28, k2=0.07, p1=1e-3, p2=-5e-4, k1_right=-0.28, k2_right=0.07,
                  p1_right=1e-3, p2_right=-5e-4)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for item in tree for t in _leaves(item)]


def _run(cfg, seqs):
    vo = pms.MultiSeqVO(cfg, batch=2, device="cpu")
    vo.initialize(np.stack([s.left[0] for s in seqs]), np.stack([s.right[0] for s in seqs]),
                  np.zeros(2))
    counts = []
    for t in range(1, N_FRAMES):
        counts.append(vo.process_frames(np.stack([s.left[t] for s in seqs]),
                                        np.stack([s.right[t] for s in seqs]), np.full(2, t * 0.1)))
    vo.drain()
    return vo, np.stack(counts)


def test_multiseq_runs_a_distorted_config_on_the_pinhole_intrinsics(caplog):
    seqs = [generate_sequence(n_frames=N_FRAMES, trajectory="forward", seed=s) for s in (3, 5)]
    base = make_cfg(pconfig, seqs[0])
    distorted = base.replace(camera=dataclasses.replace(base.camera, need_undistortion=True,
                                                        **DISTORTION))
    zeroed = base.replace(camera=dataclasses.replace(
        base.camera, need_undistortion=True, **{k: 0.0 for k in DISTORTION}))
    with caplog.at_level(logging.WARNING, logger=pms.__name__):
        vo_d, counts_d = _run(distorted, seqs)
    warnings = [r for r in caplog.records if "does not undistort" in r.getMessage()]
    assert len(warnings) == 1
    vo_z, counts_z = _run(zeroed, seqs)
    np.testing.assert_array_equal(counts_d, counts_z)
    assert vo_d.alive.all()
    for a, b in ((vo_d.fs, vo_z.fs), (vo_d.maps, vo_z.maps)):
        for x, y in zip(_leaves(a), _leaves(b)):
            assert torch.equal(x, y)
