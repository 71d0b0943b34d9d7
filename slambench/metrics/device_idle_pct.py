"""Share of the traced window with no kernel, copy or set on the card."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
