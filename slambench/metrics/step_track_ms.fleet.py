"""Mean host milliseconds a fleet step spends in its tracked step
(``MultiSeqVO.stage_s["track"]``: copy-in, the graph's replay, the
outcome read)."""


def read(run):
    v = run.stage_s.get("track", [])
    return 1e3 * sum(v) / len(v) if v else None
