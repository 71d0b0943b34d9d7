"""Batched pyramidal Lucas-Kanade optical flow (port of ``stereoslam_tpu/ops/lk.py``).

Replaces ``cv::calcOpticalFlowPyrLK`` as the reference uses it (reference
src/frontend.cpp:150-153, 355-360; OPTFLOW_USE_INITIAL_FLOW).  All N tracks
advance together through :func:`lk_pyramid` (also named
:func:`pyramidal_lk`): on a card one launch of ``csrc/lk_level.cu`` per call
(every level, the final error, the status and the forward-backward check);
on the CPU :func:`lk_pyramid_plain`, the same call composed of the plain
per-level functions of ``ops/lk_level.py``.  The JAX package's three-way
``STEREOSLAM_LK`` switch is gone: the port has one implementation.

**A batch of sequences** (the JAX package's ``jax.vmap`` of the call, in the
batched multi-sequence mode): :func:`lk_pyramid` takes levels of shape
(B, H, W), points (B, N, 2) and a (B,) gate as one launch for B independent
calls, each sequence's result bit for bit that of its own launch.  Under
``torch.func.vmap`` the call reaches the same batched launch: it goes
through the custom op ``stereoslam::lk_pyramid``, whose batching rule moves
the vmapped dimension to the front.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor

from stereoslam_tpu_torch.ops.lk_level import (
    MAX_LEVELS,
    MIN_EIG,
    WINDOW,
    _check_launch,
    _check_tensor,
    _launch_stream,
    _library,
    _on_cuda,
    lk_final_error,
    lk_final_error_plain,
    lk_level,
    lk_level_plain,
    window_plan,
)

__all__ = ["FlowResult", "gated_off", "lk_pyramid", "lk_pyramid_plain", "pyramidal_lk"]


class FlowResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked positions in the next image
    status: torch.Tensor  # (N,) bool — track considered successful
    error: torch.Tensor   # (N,) float32 mean |residual| over the window


def _compose(
    level_fn: Callable,
    error_fn: Callable,
    pyr_prev: Sequence[torch.Tensor],
    pyr_next: Sequence[torch.Tensor],
    pts_prev: torch.Tensor,
    pts_init: torch.Tensor,
    window: int = WINDOW,
    iters: int = 30,
    eps: float = 0.01,
    max_error: float = 30.0,
    forward_backward: float = 0.0,
    fb_iters: int = 10,
    fb_levels: int = 0,
) -> FlowResult:
    """A pyramidal-LK call composed of one ``level_fn`` call per level and
    one ``error_fn`` call."""
    n_levels = len(pyr_prev)
    flow = (pts_init - pts_prev) / float(2 ** (n_levels - 1))
    good_all = torch.ones(pts_prev.shape[0], dtype=torch.bool, device=pts_prev.device)
    for lvl in range(n_levels - 1, -1, -1):
        pts_l = (pts_prev / float(2 ** lvl)).contiguous()
        flow, good = level_fn(pyr_prev[lvl], pyr_next[lvl], pts_l, flow.contiguous(),
                              iters=iters, eps=eps, window=window)
        if lvl == 0:
            good_all = good_all & good
        else:
            flow = flow * 2.0

    pts_next = pts_prev + flow
    h, w = pyr_next[0].shape
    margin = window // 2
    in_bounds = (
        (pts_next[:, 0] >= margin) & (pts_next[:, 0] < w - margin)
        & (pts_next[:, 1] >= margin) & (pts_next[:, 1] < h - margin)
    )
    err = error_fn(pyr_prev[0], pyr_next[0], pts_prev.contiguous(), flow.contiguous(),
                   window=window)
    status = good_all & in_bounds & (err < max_error)

    if forward_backward > 0.0:
        fb_next = pyr_next[:fb_levels] if fb_levels > 0 else pyr_next
        fb_prev = pyr_prev[:fb_levels] if fb_levels > 0 else pyr_prev
        back = _compose(level_fn, error_fn, fb_next, fb_prev, pts_next, pts_next, window=window,
                        iters=fb_iters, eps=eps, max_error=max_error)
        round_trip = torch.linalg.norm(back.points - pts_prev, dim=-1)
        status = status & back.status & (round_trip <= forward_backward)
    return FlowResult(points=pts_next, status=status, error=err)


def gated_off(pts_init: torch.Tensor) -> FlowResult:
    """What a call gated off returns: no track kept, points at the seeds."""
    n = pts_init.shape[0]
    return FlowResult(points=pts_init.clone(),
                      status=torch.zeros((n,), dtype=torch.bool, device=pts_init.device),
                      error=torch.zeros((n,), dtype=torch.float32, device=pts_init.device))


def lk_pyramid_plain(pyr_prev, pyr_next, pts_prev, pts_init, gate=None, **kw) -> FlowResult:
    """The plain version of :func:`lk_pyramid`: the per-level plain functions
    composed level by level, the gate read on the host.  Batched operands
    (points (B, N, 2)) run one such call per sequence."""
    if pts_prev.dim() == 3:
        per_seq = [lk_pyramid_plain([lvl[b] for lvl in pyr_prev], [lvl[b] for lvl in pyr_next],
                                    pts_prev[b], pts_init[b],
                                    None if gate is None else gate[b], **kw)
                   for b in range(pts_prev.shape[0])]
        return FlowResult(*(torch.stack(x) for x in zip(*per_seq)))
    if gate is not None and not bool(gate):
        return gated_off(pts_init)
    return _compose(lk_level_plain, lk_final_error_plain, pyr_prev, pyr_next, pts_prev,
                    pts_init, **kw)


def lk_pyramid_levels(pyr_prev, pyr_next, pts_prev, pts_init, **kw) -> FlowResult:
    """:func:`lk_pyramid` composed of ``lk_level`` and ``lk_final_error``
    calls, which launch one kernel each on a card."""
    return _compose(lk_level, lk_final_error, pyr_prev, pyr_next, pts_prev, pts_init, **kw)


def lk_pyramid(
    pyr_prev: Sequence[torch.Tensor],
    pyr_next: Sequence[torch.Tensor],
    pts_prev: torch.Tensor,
    pts_init: torch.Tensor,
    window: int = WINDOW,
    iters: int = 30,
    eps: float = 0.01,
    max_error: float = 30.0,
    forward_backward: float = 0.0,
    fb_iters: int = 10,
    fb_levels: int = 0,
    gate: Optional[torch.Tensor] = None,
) -> FlowResult:
    """Track ``pts_prev`` (N, 2) from ``pyr_prev`` to ``pyr_next`` (finest
    level first), seeded at ``pts_init``.

    Conditioning (``good``) gates only at the finest level, as in OpenCV.
    ``forward_backward`` > 0 re-tracks the result back (seeded at zero
    flow, ``fb_iters`` iterations, the finest ``fb_levels`` levels, 0 = all)
    and rejects tracks whose round trip misses the start by more than that
    many pixels — the guard against ghost locks from biased seeds.

    ``gate``, a 0-dim bool tensor on the images' device, makes the call
    conditional without a host read (JAX: ``lax.cond`` around the call):
    where it is false the call keeps no track (status all false, points at
    ``pts_init``, error 0); where it is true, or absent, the call is as
    without it.

    Batched operands (levels (B, H, W), points (B, N, 2), ``gate`` (B,)) are
    B independent calls; so is a call under ``torch.func.vmap``.

    On CUDA tensors the whole call is one kernel launch, gated or not,
    batched or not, counted in ``lk_pyramid.launches`` (a batched launch
    also in ``lk_pyramid.batched_launches``); on CPU tensors it runs
    :func:`lk_pyramid_plain`, which reads the gate on the host.
    """
    batched = pts_prev.dim() == 3
    want = (pts_prev.shape[0],) if batched else ()
    if gate is not None and (tuple(gate.shape) != want or gate.dtype != torch.bool
                             or gate.device != pyr_prev[0].device):
        raise ValueError(f"gate must be a {len(want)}-dim bool tensor of shape {want} on "
                         f"{pyr_prev[0].device}, got {tuple(gate.shape)} {gate.dtype} on "
                         f"{gate.device}")
    _on_cuda("lk_pyramid", pyr_prev[0])  # CPU or CUDA tensors, else ValueError
    args = (list(pyr_prev), list(pyr_next), pts_prev, pts_init, gate, int(window), int(iters),
            float(eps), float(max_error), float(forward_backward), int(fb_iters), int(fb_levels))
    if batched:
        return _lk_pyramid_batched(*args)
    return FlowResult(*_lk_pyramid_op(*args))


def _kw(window, iters, eps, max_error, forward_backward, fb_iters, fb_levels) -> dict:
    return dict(window=window, iters=iters, eps=eps, max_error=max_error,
                forward_backward=forward_backward, fb_iters=fb_iters, fb_levels=fb_levels)


def _check_call(pyr_prev, pyr_next, pts_prev, pts_init, window, lead: int) -> None:
    """The kernel's contract on CUDA operands with ``lead`` leading batch
    dims (0 or 1)."""
    dev = pyr_prev[0].device
    n_levels = len(pyr_prev)
    if window != WINDOW:
        raise ValueError(f"the LK kernel is compiled for a {WINDOW}x{WINDOW} window, got {window}")
    if len(pyr_next) != n_levels or not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"pyramids of {n_levels} and {len(pyr_next)} levels: the kernel takes "
                         f"two of one depth, 1 to {MAX_LEVELS}")
    batch = tuple(pts_prev.shape[:lead])
    for lvl, (a, b) in enumerate(zip(pyr_prev, pyr_next)):
        _check_tensor(f"pyr_prev[{lvl}]", a, dev)
        _check_tensor(f"pyr_next[{lvl}]", b, dev)
        if a.dim() != 2 + lead or b.shape != a.shape or tuple(a.shape[:lead]) != batch:
            raise ValueError(f"level {lvl}: images must share one {'(B, ' if lead else '('}H, W) "
                             f"shape: {tuple(a.shape)} vs {tuple(b.shape)}")
    _check_tensor("pts_prev", pts_prev, dev)
    _check_tensor("pts_init", pts_init, dev)
    if pts_prev.dim() != 2 + lead or pts_prev.shape[-1] != 2 or pts_init.shape != pts_prev.shape:
        raise ValueError(f"pts_prev and pts_init must be {'(B, ' if lead else '('}N, 2): "
                         f"{tuple(pts_prev.shape)} vs {tuple(pts_init.shape)}")


def _launch(pyr_prev, pyr_next, pts_prev, pts_init, gate, B: int, iters, eps, max_error,
            forward_backward, fb_iters, fb_levels) -> FlowResult:
    """One launch of the kernel for B sequences (B = 1: a single call)."""
    lib = _library()
    dev = pyr_prev[0].device
    n_levels = len(pyr_prev)
    N = pts_prev.shape[-2]
    points = torch.empty_like(pts_prev)
    status = torch.empty(pts_prev.shape[:-1], dtype=torch.bool, device=dev)
    error = torch.empty(pts_prev.shape[:-1], dtype=torch.float32, device=dev)
    ptrs = ctypes.c_void_p * n_levels
    dims = ctypes.c_int * n_levels
    with torch.cuda.device(dev):
        err = lib.lk_pyramid_launch(
            ptrs(*(a.data_ptr() for a in pyr_prev)), ptrs(*(b.data_ptr() for b in pyr_next)),
            dims(*(a.shape[-2] for a in pyr_prev)), dims(*(a.shape[-1] for a in pyr_prev)),
            n_levels, int(fb_levels), pts_prev.data_ptr(), pts_init.data_ptr(), B, N, int(iters),
            int(fb_iters), float(eps * eps), MIN_EIG, float(max_error), float(forward_backward),
            None if gate is None else gate.data_ptr(),
            points.data_ptr(), status.data_ptr(), error.data_ptr(),
            window_plan().bytes_per_feature, _launch_stream(dev),
        )
    _check_launch(err, "lk_pyramid")
    lk_pyramid.launches += 1
    return FlowResult(points=points, status=status, error=error)


@torch.library.custom_op("stereoslam::lk_pyramid", mutates_args=())
def _lk_pyramid_op(pyr_prev: List[Tensor], pyr_next: List[Tensor], pts_prev: Tensor,
                   pts_init: Tensor, gate: Optional[Tensor], window: int, iters: int, eps: float,
                   max_error: float, forward_backward: float, fb_iters: int,
                   fb_levels: int) -> Tuple[Tensor, Tensor, Tensor]:
    """One call (points (N, 2)): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    kw = _kw(window, iters, eps, max_error, forward_backward, fb_iters, fb_levels)
    if not _on_cuda("lk_pyramid", pyr_prev[0]):
        return tuple(lk_pyramid_plain(pyr_prev, pyr_next, pts_prev, pts_init, gate=gate, **kw))
    pts_prev, pts_init = pts_prev.contiguous(), pts_init.contiguous()
    _check_call(pyr_prev, pyr_next, pts_prev, pts_init, window, lead=0)
    del kw["window"]
    return tuple(_launch(pyr_prev, pyr_next, pts_prev, pts_init, gate, 1, **kw))


def _lk_pyramid_batched(pyr_prev, pyr_next, pts_prev, pts_init, gate, window, iters, eps,
                        max_error, forward_backward, fb_iters, fb_levels) -> FlowResult:
    """B calls (points (B, N, 2)) in one launch on CUDA tensors; on CPU
    tensors one plain call per sequence."""
    kw = _kw(window, iters, eps, max_error, forward_backward, fb_iters, fb_levels)
    if not _on_cuda("lk_pyramid", pyr_prev[0]):
        return lk_pyramid_plain(pyr_prev, pyr_next, pts_prev, pts_init, gate=gate, **kw)
    pyr_prev = [a.contiguous() for a in pyr_prev]
    pyr_next = [b.contiguous() for b in pyr_next]
    pts_prev, pts_init = pts_prev.contiguous(), pts_init.contiguous()
    _check_call(pyr_prev, pyr_next, pts_prev, pts_init, window, lead=1)
    del kw["window"]
    out = _launch(pyr_prev, pyr_next, pts_prev, pts_init,
                  None if gate is None else gate.contiguous(), pts_prev.shape[0], **kw)
    lk_pyramid.batched_launches += 1
    return out


@_lk_pyramid_op.register_vmap
def _lk_pyramid_vmap(info, in_dims, pyr_prev, pyr_next, pts_prev, pts_init, gate, *scalars):
    """``torch.func.vmap`` of a call: the batched launch, the vmapped
    dimension moved to the front (an operand the map does not batch is
    expanded to every sequence)."""
    B = info.batch_size
    d_prev, d_next, d_pts, d_init, d_gate = in_dims[:5]

    def front(x, d):
        return x.movedim(d, 0) if d is not None else x.expand((B,) + tuple(x.shape))

    out = _lk_pyramid_batched(
        [front(a, d) for a, d in zip(pyr_prev, d_prev or [None] * len(pyr_prev))],
        [front(b, d) for b, d in zip(pyr_next, d_next or [None] * len(pyr_next))],
        front(pts_prev, d_pts), front(pts_init, d_init),
        None if gate is None else front(gate, d_gate), *scalars)
    return tuple(out), (0, 0, 0)


lk_pyramid.launches = 0
lk_pyramid.batched_launches = 0
pyramidal_lk = lk_pyramid
