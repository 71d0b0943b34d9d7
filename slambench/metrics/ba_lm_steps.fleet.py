"""Mean LM steps a served windowed BA (``MultiSeqVO.ba_steps``: the
program's count of the steps each BA of its keyframe service ran before its
exit rule passed), over the window's served BAs: the last
``sum(s.serviced for s in run.frames("step"))`` entries.  None, never 0,
where the program keeps no such list or the window served no BA."""


def read(run):
    v = getattr(run.facade, "ba_steps", None)
    n = sum(s.serviced for s in run.frames("step"))
    if not v or n == 0 or len(v) < n:
        return None
    return sum(v[-n:]) / n
