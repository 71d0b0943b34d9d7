"""K1's share of its roofline in the fleet's batched launch: one
``lk_pyramid`` launch for every stream at the fleet's shapes (the last
step's tracks, its images to the drive's next), events around a CUDA graph
of launches after the window, against the frozen count
(``slambench/roofline/``)."""

from slambench.roofline import lk_probe


def read(run):
    return lk_probe.roofline_pct(run, "lk_batched")
