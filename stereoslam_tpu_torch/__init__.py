"""stereoslam_tpu_torch — the PyTorch/CUDA port of ``stereoslam_tpu``.

Stereo SLAM with inline windowed bundle adjustment and deep loop closing,
written as plain functions on torch tensors with an explicit device
everywhere.  Module names mirror the JAX package so each function's
counterpart is easy to find:

- ``ops/``    SE(3), pinhole camera, triangulation, image pyramids, pyramidal
              LK (one launch of a hand-written CUDA kernel per call,
              ``csrc/lk_level.cu``, with its plain PyTorch version),
              pose-only LM, FAST, Schur-complement BA; for loop closing,
              orientation, BRIEF, pyramid ORB, Hamming matching, P3P,
              PnP-RANSAC and pose-graph optimization.
- ``models/`` the CALC encoder and the HOG place descriptor, the Caffe
              importer, and CALC training (``train_calc``).
- ``core/``   state containers, the frontend frame step, backend BA, landmark
              compaction, the loop closer and the ``StereoSlam`` facade (on
              the card unless the caller passes ``device="cpu"``).
- ``utils/``  numpy-only trajectory export, metrics and the synthetic
              sequence generator; the ray-cast world renderer, the device
              feed and checkpoints.
- ``parallel/`` the batched multi-sequence mode (``MultiSeqVO``) and
              multi-device: ``torch.distributed`` meshes, the sharded
              descriptor search, pose graph and Schur BA.
- ``eval``    the world-circuit evaluation (``run_world_eval``).
- ``bridge``  numpy <-> torch state and CALC-weight converters.

The package never imports jax: it has to run where JAX is not installed.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry correctness: TF32 keeps ~10 mantissa bits, which costs about an
# order of magnitude in triangulation/BA accuracy.  The JAX package pins
# matmul precision to "highest" for the same reason; pin full fp32 here.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# The CALC training head computes in bfloat16 with float32 accumulation, as
# the JAX package's; cuBLAS may otherwise reduce split sums in bfloat16.
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from stereoslam_tpu_torch.config import SlamConfig  # noqa: E402,F401
