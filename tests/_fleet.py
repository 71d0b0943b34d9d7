"""The batched mode's small fleet, for tests with or without JAX: the
sequences of tests/test_parallel.py (``generate_sequence(trajectory=
"forward")``, seeds 3 and 5) and the config of tests/test_system_vo.py's
``make_cfg``, for either package's config module."""

import numpy as np

from stereoslam_tpu_torch.utils.synthetic import generate_sequence

SEEDS = (3, 5)


def sequences(n_frames: int, seeds=SEEDS):
    return [generate_sequence(n_frames=n_frames, trajectory="forward", seed=s) for s in seeds]


def make_cfg(mod, seq):
    """tests/test_system_vo.py make_cfg, for either package's config module."""
    return mod.SlamConfig(
        camera=mod.CameraConfig(
            fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy,
            fx_right=seq.fx, fy_right=seq.fy, cx_right=seq.cx, cy_right=seq.cy,
            bf=seq.fx * seq.baseline,
        ),
        features=mod.FeatureConfig(
            n_init_features=200, n_new_features=100, max_features=256,
            num_features_init_good=50, num_features_tracking_good=50,
            num_features_tracking_bad=10,
        ),
        map=mod.MapConfig(max_keyframes=256, max_landmarks=20000),
        image_height=seq.left.shape[1],
        image_width=seq.left.shape[2],
    )


def stack(seqs, t, field):
    """Frame ``t``'s ``field`` ("left" or "right") of every sequence, (B, H, W)."""
    return np.stack([getattr(s, field)[t] for s in seqs])
