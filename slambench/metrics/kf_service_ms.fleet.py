"""Mean host milliseconds of keyframe service over the fleet steps that
served one (``MultiSeqVO.stage_s["keyframes"]``: the keyframe branch and
the BA graph's replay for each served stream)."""


def read(run):
    v = run.stage_s.get("keyframes", [])
    served = [ms for ms, s in zip(v, run.frames("step")) if s.serviced > 0]
    return 1e3 * sum(served) / len(served) if served else None
