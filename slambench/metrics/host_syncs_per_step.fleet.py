"""Mean blocking device-to-host reads a fleet step (``MultiSeqVO.step_reads``:
the program's read counter, ``utils/prof.py`` ``HostReads``, each step's
count over every read site), over the window's steps: the last
``len(run.frames("step"))`` entries.  None, never 0, where the program keeps
no such list or the window has no step."""


def read(run):
    v = getattr(run.facade, "step_reads", None)
    n = len(run.frames("step"))
    if not v or n == 0 or len(v) < n:
        return None
    return sum(v[-n:]) / n
