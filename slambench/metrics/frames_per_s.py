"""Stereo frames tracked in the window over its seconds (in the fleet, the
sequence-frames of all streams): every frame handed in and not failed has
retired by the window's end."""


def read(run):
    return (run.attempted - run.failed) / run.window_s if run.window_s > 0 else None
