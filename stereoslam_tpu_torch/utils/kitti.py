"""KITTI odometry sequence IO (port of ``stereoslam_tpu/utils/kitti.py``).

Replaces the reference's driver-side loader (reference
app/run_kitti_stereo.cpp:114-144: reads ``times.txt`` and builds
``image_0/%06d.png`` / ``image_1/%06d.png`` file lists).  Decoding uses
OpenCV when available and PIL otherwise; the native prefetcher
(stereoslam_tpu_torch/native) overlaps decode with device compute.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from stereoslam_tpu_torch.native import dataloader as native_loader

log = logging.getLogger(__name__)


def load_image_paths(sequence_dir: str) -> Tuple[List[str], List[str], np.ndarray]:
    """(left_paths, right_paths, timestamps) for a KITTI sequence directory."""
    times_path = os.path.join(sequence_dir, "times.txt")
    with open(times_path) as f:
        timestamps = np.asarray([float(line) for line in f if line.strip()])
    left = [
        os.path.join(sequence_dir, "image_0", f"{i:06d}.png")
        for i in range(len(timestamps))
    ]
    right = [
        os.path.join(sequence_dir, "image_1", f"{i:06d}.png")
        for i in range(len(timestamps))
    ]
    return left, right, timestamps


def read_gray(path: str) -> np.ndarray:
    """Read a grayscale image as (H, W) uint8."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(f"failed to read {path}")
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))


def frames(sequence_dir: str, prefetch: int = 4) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yield (left, right, timestamp), decoding ahead of the consumer.

    Prefers the C++ prefetching loader (stereoslam_tpu_torch.native); falls
    back to a Python thread pool of :func:`read_gray` where the loader cannot
    be built, and logs once, at INFO, which decoder it uses and why.
    """
    left_paths, right_paths, timestamps = load_image_paths(sequence_dir)
    try:
        native_loader.library()
    except (OSError, RuntimeError) as e:
        decoder = "cv2" if importlib.util.find_spec("cv2") else "PIL"
        log.info("decoding %s with a thread pool of read_gray (%s): the native loader is "
                 "unavailable: %s", sequence_dir, decoder, e)
    else:
        log.info("decoding %s with the native libpng loader", sequence_dir)
        yield from native_loader.stream_pairs(left_paths, right_paths, timestamps, prefetch)
        return

    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = []
        for i in range(len(left_paths)):
            futures.append(
                (pool.submit(read_gray, left_paths[i]), pool.submit(read_gray, right_paths[i]), timestamps[i])
            )
            if len(futures) > prefetch:
                fl, fr, ts = futures.pop(0)
                yield fl.result(), fr.result(), ts
        for fl, fr, ts in futures:
            yield fl.result(), fr.result(), ts


def load_gt_poses(poses_file: str) -> np.ndarray:
    """KITTI ground-truth poses file -> (N, 4, 4) T_wc matrices."""
    rows = np.loadtxt(poses_file).reshape(-1, 3, 4)
    n = len(rows)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :] = rows
    return T
