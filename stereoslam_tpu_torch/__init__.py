"""stereoslam_tpu_torch — the PyTorch/CUDA port of ``stereoslam_tpu``.

Stereo visual odometry with inline windowed bundle adjustment, written as
plain functions on torch tensors with an explicit device everywhere.  Module
names mirror the JAX package so each function's counterpart is easy to find:

- ``ops/``    SE(3), pinhole camera, triangulation, LK pyramid, the LK level
              (a hand-written CUDA kernel, ``csrc/lk_level.cu``, with its
              plain PyTorch version), pose-only LM, FAST, Schur-complement BA.
- ``core/``   state containers, the frontend frame step, backend BA, landmark
              compaction and the ``StereoSlam`` facade.
- ``utils/``  numpy-only trajectory export, metrics and the synthetic
              sequence generator.
- ``bridge``  numpy <-> torch state converters, used by the parity tests.

The package never imports jax: it has to run where JAX is not installed.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry correctness: TF32 keeps ~10 mantissa bits, which costs about an
# order of magnitude in triangulation/BA accuracy.  The JAX package pins
# matmul precision to "highest" for the same reason; pin full fp32 here.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from stereoslam_tpu_torch.config import SlamConfig  # noqa: E402,F401
