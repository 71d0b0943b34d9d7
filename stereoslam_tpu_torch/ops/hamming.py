"""Brute-force Hamming descriptor matching (port of
``stereoslam_tpu/ops/hamming.py``; reference ``cv::BFMatcher(NORM_HAMMING)``,
loopclosing.cpp:172, with its gate ``d <= max(2 min_d, 30)`` (:183) and the
class-id dedup of pyramid clones (:184-193)).

Descriptors are (M, 8) int32 words holding 256-bit patterns.  Torch has no
popcount: the XOR of two words is widened to int64, masked to its 32 bits and
counted with the SWAR bit count.  The (Ma, Mb) distances are built in row
blocks, so the (rows, Mb, 8) temporaries stay small at M = 3200.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Elements of one block's (rows, Mb, 8) int64 temporaries.
_BLOCK_ELEMS = 1 << 24
BIG = 1 << 20


class MatchResult(NamedTuple):
    # Per query descriptor (row of a):
    best_idx: torch.Tensor   # (Ma,) int32 — best match in b
    best_dist: torch.Tensor  # (Ma,) int32
    accepted: torch.Tensor   # (Ma,) bool — passed the distance gate and the dedup


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word's 32-bit pattern, as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Ma, 8) x (Mb, 8) int32 words -> (Ma, Mb) int32 Hamming distances."""
    rows = max(1, _BLOCK_ELEMS // max(1, desc_b.shape[0] * desc_b.shape[1]))
    out = [popcount32(blk[:, None, :] ^ desc_b[None, :, :]).sum(-1).to(torch.int32)
           for blk in desc_a.split(rows)]
    return torch.cat(out) if out else desc_a.new_zeros((0, desc_b.shape[0]))


def segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_min`` of int32 ``vals`` into ``n`` segments: an empty
    segment holds the int32 maximum."""
    init = torch.full((n,), torch.iinfo(torch.int32).max, dtype=vals.dtype, device=vals.device)
    return init.scatter_reduce(0, seg.long(), vals, "amin", include_self=False)


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    class_a: torch.Tensor,
    class_b: torch.Tensor,
    max_features: int,
    floor: int = 30,
) -> MatchResult:
    """Match each descriptor of a to its nearest valid one in b (the first
    index on ties), gate the distances, and keep per ``class_a`` only the
    closest clone (the lowest index among equals).  ``best_idx`` indexes b's
    rows; ``class_b[best_idx]`` gives the feature-level pairing."""
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_b[None, :], d, torch.full_like(d, BIG))
    best_idx = torch.argmin(d, dim=1)
    best_dist = d.gather(1, best_idx[:, None])[:, 0]
    best_idx = best_idx.to(torch.int32)
    best_dist = torch.where(valid_a, best_dist, torch.full_like(best_dist, BIG))

    gate = torch.clamp(2 * best_dist.min(), min=floor)
    ok = valid_a & (best_dist <= gate)

    M = max_features
    cls = torch.where(ok, class_a, torch.full_like(class_a, M))   # invalid -> overflow bucket
    cls_safe = torch.clamp(cls, max=M).long()
    per_class_best = segment_min(torch.where(ok, best_dist, torch.full_like(best_dist, BIG)),
                                 cls, M + 1)
    is_class_best = ok & (best_dist <= per_class_best[cls_safe])
    Ma = desc_a.shape[0]
    idx = torch.arange(Ma, dtype=torch.int32, device=desc_a.device)
    first_at_best = segment_min(torch.where(is_class_best, idx, torch.full_like(idx, Ma)), cls, M + 1)
    accepted = is_class_best & (idx == first_at_best[cls_safe])
    return MatchResult(best_idx=best_idx, best_dist=best_dist, accepted=accepted)
