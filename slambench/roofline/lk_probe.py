"""K1's share of its roofline at a cell's shapes: the program's
``lk_pyramid`` on the inputs the drive kept (``Run.probe``), timed on the
card, against the least time of the frozen work count."""

from __future__ import annotations

from typing import Optional

import torch

from slambench.reference.image import build_lk_pyramid
from slambench.roofline import lk_work


def _kw(tracking: dict) -> dict:
    return dict(window=tracking["lk_window"], iters=tracking["lk_iters"],
                eps=tracking["lk_eps"], forward_backward=tracking["lk_forward_backward"],
                fb_iters=tracking["lk_fb_iters"], fb_levels=tracking["lk_fb_levels"])


def roofline_pct(run, key: str) -> Optional[float]:
    """Percent of the roofline one launch reaches on ``run.probe[key]``:
    ``prev``/``cur`` (H, W) or (B, H, W) uint8 images, ``pts`` (N, 2) or
    (B, N, 2) in ``prev``; zero-flow seeds."""
    probe = run.probe.get(key)
    if probe is None or run.device.type != "cuda":
        return None
    from stereoslam_tpu_torch.ops.lk import lk_pyramid

    t = run.config["slam"]["tracking"]
    kw = _kw(t)
    if kw["fb_levels"]:
        return None  # the frozen count runs the backward pass over every level
    levels = t["lk_levels"]
    pa = build_lk_pyramid(probe["prev"].to(torch.float32), levels)
    pb = build_lk_pyramid(probe["cur"].to(torch.float32), levels)
    pa = [x.contiguous() for x in pa]
    pb = [x.contiguous() for x in pb]
    pts = probe["pts"].contiguous()
    init = pts.clone()
    ms = lk_work.device_ms(lambda: lk_pyramid(pa, pb, pts, init, **kw))
    batched = pts.dim() == 3
    nbytes = flops = 0
    for b in range(pts.shape[0] if batched else 1):
        pick = (lambda x: x[b]) if batched else (lambda x: x)
        nb, fl = lk_work.lk_work([pick(x) for x in pa], [pick(x) for x in pb], pick(pts),
                                 pick(init), kw["iters"], kw["eps"], kw["forward_backward"],
                                 kw["fb_iters"])
        nbytes, flops = nbytes + nb, flops + fl
    least_ms, by = lk_work.bound_ms(nbytes, flops)
    run.notes.setdefault("roofline", {})[key] = dict(device_us=ms * 1e3, bound_us=least_ms * 1e3,
                                                      bound_by=by, bytes=nbytes, flops=flops)
    return 100.0 * least_ms / ms
