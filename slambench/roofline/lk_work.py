"""What a pyramidal-LK kernel launch has to do, counted from its inputs,
and the least time the card could take for it.

Bytes: the pixels the call taps, each read once (a mask per image, so a
pixel that two features, levels or passes tap counts once), the points read
and the results written once.  Operations: float32 operations of the LK
arithmetic for the iterations the data runs, counted through the frozen
plain level's ``visit`` hook (``reference/lk.py``), so the count is the same
whatever implements the kernel.  Peaks: NVIDIA's H100 SXM data sheet, dense,
at a 700 W power limit.
"""

from __future__ import annotations

import subprocess
from typing import Sequence, Tuple

import torch

from slambench.reference import lk as K

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# Float32 operations, counted from the arithmetic: a bilinear sample is 13
# (two weights, eight products, three sums) and a window has 121 samples.
# A Gauss-Newton iteration: a sample, the residual and two multiply-adds per
# sample (18), two 31-add sums, about 20 for the update.  A level's
# template: five samples and six gradient-product terms per sample.  The
# final error: one sample, a difference and a sum per sample.
FLOPS_ITER = 121 * 18 + 2 * 31 + 20
FLOPS_TEMPLATE = 121 * (5 * 13 + 2 + 6)
FLOPS_ERROR = 121 * (13 + 2)
POINT_BYTES = 16 + 13  # a point and its seed read; point, status and error written


class Work:
    """Pixels tapped (a mask per image) and float32 operations of one call."""

    def __init__(self):
        self.masks, self.flops = {}, 0

    def _mark(self, img, x0, y0, side: int) -> None:
        mask = self.masks.setdefault(img.data_ptr(), torch.zeros(img.shape, dtype=torch.bool,
                                                                 device=img.device))
        h, w = mask.shape
        ar = torch.arange(side, device=mask.device)
        ys = (y0[:, None] + ar).clamp(0, h - 1)
        xs = (x0[:, None] + ar).clamp(0, w - 1)
        mask[ys[:, :, None].expand(-1, -1, side), xs[:, None, :].expand(-1, side, -1)] = True

    def template(self, img, pts) -> None:
        org, _ = K.window_origins(pts, torch.zeros_like(pts))
        self._mark(img, org[:, 0], org[:, 1], K.window_plan().template_side)

    def taps(self, img, at) -> None:
        base = torch.stack([K.split(at[:, i])[0] for i in (0, 1)], dim=-1) - K.WINDOW // 2
        self._mark(img, base[:, 0], base[:, 1], K.WINDOW + 1)

    def level(self, prev, nxt, pts, flow, iters: int, eps: float):
        self.template(prev, pts)
        self.flops += pts.shape[0] * FLOPS_TEMPLATE

        def visit(f, active):
            self.flops += int(active.sum()) * FLOPS_ITER
            self.taps(nxt, (pts + f)[active])

        flow, _ = K.lk_level_plain(prev, nxt, pts, flow, iters, eps, visit=visit)
        return flow

    def nbytes(self) -> int:
        return 4 * sum(int(m.sum()) for m in self.masks.values())


def lk_work(pa: Sequence[torch.Tensor], pb: Sequence[torch.Tensor], pts: torch.Tensor,
            init: torch.Tensor, iters: int, eps: float, fb: float = 0.0,
            fb_iters: int = 0) -> Tuple[int, int]:
    """(bytes, float32 operations) of one pyramidal-LK call on these inputs:
    the forward pass, and the backward pass where ``fb`` > 0."""
    work = Work()

    def one_pass(pyr_a, pyr_b, p, seed, n_iters):
        flow = (seed - p) / float(2 ** (len(pyr_a) - 1))
        for lvl in range(len(pyr_a) - 1, -1, -1):
            flow = work.level(pyr_a[lvl], pyr_b[lvl], p / float(2 ** lvl), flow, n_iters, eps)
            if lvl:
                flow = flow * 2.0
        work.taps(pyr_b[0], p + flow)
        work.flops += p.shape[0] * FLOPS_ERROR
        return p + flow

    q = one_pass(pa, pb, pts, init, iters)
    if fb > 0.0:
        one_pass(pb, pa, q, q, fb_iters)
    return work.nbytes() + pts.shape[0] * POINT_BYTES, work.flops


def bound_ms(nbytes: int, flops: int) -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations": which peak bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, launches: int = 200, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured in
    one CUDA graph, timed by CUDA events around one replay after a warm-up
    replay, so the host's per-call work stays out of the gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / launches
    del graph
    return ms


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unread"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unread"
