"""One CUDA graph of the tracked frame per ``StereoSlam`` (and of the
batched tracked step per ``MultiSeqVO``), and the windowed BA's graphs per
facade: the port's counterparts of the JAX package's jitted frame and BA
programs.  Each is a :class:`CapturedGraph`: a function that reads nothing
back and takes its shapes from the config, captured once and replayed on
static input buffers.

:func:`~stereoslam_tpu_torch.core.frontend.track_frame` (the pyramid, LK
with its gated rescue passes, the pose LM, the status and the branch flags)
reads nothing back and takes its shapes from the config, so
:class:`TrackGraph` captures it once, at the first tracked frame, and
replays it on every tracked frame after: one graph launch in place of the
several thousand kernel launches of the eager frame.

**Capture.**  A warm-up call on a side stream comes first, as
``torch.cuda.graphs`` requires: it loads the LK library's kernel and
PyTorch's, and creates the cuBLAS and cuSOLVER handles.  It is the eager
frame on the same inputs and its results are discarded, so it does not
advance the state.  The capture then runs in ``thread_local`` mode, so a
feed thread that stages the next frames meanwhile does not break it, on a
capture stream of its own: cuBLAS keeps its workspace per stream, so two
graphs captured on torch's shared capture stream would share one and race
when they replay on two streams at once, as the asynchronous BA does (two
such runs of phase main's frames differed).  Python's cyclic garbage
collector is held off during the capture: a facade and its graphs form
reference cycles (a graph's function is a bound method of its owner), so a
dropped facade's graphs are freed whenever the collector next runs, and a
graph torn down inside another's capture (``cudaGraphExecDestroy``, its
memory pool released) invalidates that capture.  A failed capture raises; a
CUDA tensor never falls back to the eager frame.

**Inputs: copied in before every replay.**  The graph owns a static buffer
for every input: the stereo pair ``lr_u8``, the previous frame's pyramid,
the frontend state (tracks, ``T_rk``, ``T_vel``, ``ref_kf``, ``status``,
``frame_id``) and the map fields the frame reads (``TrackMap``: ``lm_pos``,
``lm_valid``, ``lm_outlier``, ``kf_T_cw``, ``kf_frame_id``,
``last_ba_frame``, ``n_lm``).  Every one is copied in before every replay;
nothing tracks which fields a keyframe, BA, replenishment, loop correction,
compaction or ``load_checkpoint`` replaced, so a stale map cannot reach
the graph.  At KITTI geometry (1241x376, 400 features) with the full-size
state (131,072 landmark rows, 1536 keyframe rows) that is about 5.3 MB a
frame: the landmark fields 1.8 MB, the previous pyramid 2.45 MB, ``lr_u8``
0.93 MB, the rest under 0.1 MB.  Each byte is read once and written once,
so at 3.35 TB/s the copies take about 3 us of the card's time.  The
timestamp is not an input: only the keyframe branch, outside the graph,
reads it.

**The left image's preprocessing** (``pre_left``: the uint8 image to the
float32 one the frame tracks) is the first step of the graph: a widening,
and with undistortion on, the bilinear remap through the left camera's
(H, W, 2) source grid.  The grid is built once by the facade and never
written after, so it is a static input of the graph that needs no copy-in:
the replay reads it where the capture found it.

**Outputs** (the frame's float32 left image, its frontend state, its
pyramid, its packed outcome) live in the graph's memory and are overwritten
by the next replay.  A caller that keeps one across frames keeps a copy.

**Launch counts.**  A replay runs no Python, so no wrapper counts its
launch.  The capture records each kernel wrapper's count before and after
(the capture itself launches nothing, so the counts are set back), and
every replay adds that difference: ``lk_pyramid.launches`` stays the
number of launches the card ran.

**On the CPU** the same runner copies the inputs into the same static
buffers, calls ``track_frame`` on them and copies the results into static
outputs, without a graph, so the CPU tests run the copy-in and copy-out
plumbing and the aliasing rules above.

**Another frame function.**  ``frame_fn`` replaces ``track_frame`` with any
function of the same inputs (the stereo pair, the previous pyramid, the
frontend state, the ``TrackMap``) that reads nothing back: the batched
multi-sequence mode passes its tracked step over B sequences
(``parallel/multiseq.py``), whose inputs carry a leading B and whose
copy-in is reckoned there.  Capture, copy-in and launch counts are the
same.

**The windowed BA** comes in two runners over ``core/backend.py``
``optimize_active_map`` (the window's gather and landmark compaction, the
float64 Schur LM of ``ops/schur.py``, the write-back), whose shapes come
from the config (W, N, C = W * N, the map's capacities); both capture at
the facade's first BA, with the same warm-up, ``thread_local`` capture and
launch counts.  Their inputs are the map fields the BA reads (``BAMap``),
copied in before every BA: at KITTI geometry with the full-size state
(1536 keyframe rows of 400 features, 131,072 landmark rows, W = 7) 11.07 MB,
of which the keyframe feature tables are 7.99 MB (1536 x 400 x (8 + 4 + 1)
bytes) and the landmark fields 2.88 MB: about 6.6 us of the card's time at
3.35 TB/s.  Their six outputs (``kf_T_cw``, ``kf_rel_prev``, ``lm_pos``,
``kf_feat_lm``, ``lm_obs_count``, ``lm_outlier``; 4.88 MB, about 2.9 us) are
copied out of the graphs' memory before they become the map's fields,
since the next BA overwrites them.  A BA runs on the caller's current
stream.  A call is a host span, ``ba_launch`` (copy-in, the replays, the
exit reads of the stepped runner, the six copies out), added to ``record``
where the owner gives one.

- :class:`SteppedBA`, for a caller that waits for the result (the inline
  BA and the batched keyframe service): a prologue graph (gather,
  compaction, the float64 window and the first carry, into static
  buffers), then one replay of a one-step LM graph a step and one of a
  round-end graph a round, each writing the carry in place, the host
  reading each exit test (``ba.exit``: the flag copied to pinned memory
  by the graph's last node, an event waited on) with ``ops/schur.py``
  ``_early_exit``'s control flow, then an epilogue graph
  (``orthonormalize``, the final chi2, the write-back).  It stops at the
  exit rule, as the JAX package's ``while_loop``s do, and ``steps`` keeps
  each BA's LM steps: on the fleet's windows 6-10 of the 50 (``PERF.md``).
- :class:`BAGraph`, for the asynchronous BA, which must read nothing back:
  one graph of every ``rounds x iters`` step, the exit tests frozen on the
  device.  A replay computes the frozen steps too: on phase main's final
  map 88.0-88.8 ms of the card's time, where the early exit stops after 2
  steps and 3.9 ms (NVIDIA H100 80GB HBM3, 700.00 W; ``chip_smoke.py``
  phase ba); it runs on a side stream (``core/system.py``).
"""

from __future__ import annotations

import gc
from functools import partial
from typing import Callable, List, MutableMapping, NamedTuple, Optional, Tuple

import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core import backend as backend_mod
from stereoslam_tpu_torch.core import frontend as frontend_mod
from stereoslam_tpu_torch.core.state import FrontendState
from stereoslam_tpu_torch.ops import schur
from stereoslam_tpu_torch.ops.camera import Intrinsics
from stereoslam_tpu_torch.utils.prof import HostReads, host_read, span


def _flat(tree) -> List[torch.Tensor]:
    """The tensors of a nested tuple (NamedTuples included), in order; other
    leaves (a Python float) are constants and hold no buffer."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if not isinstance(tree, (tuple, list)):
        return []
    return [t for item in tree for t in _flat(item)]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if not isinstance(tree, (tuple, list)):
        return tree
    items = [_clone(item) for item in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _copy_into(dst, src) -> None:
    d, s = _flat(dst), _flat(src)
    if len(d) != len(s):
        raise ValueError(f"{len(s)} tensors for {len(d)} static buffers")
    for a, b in zip(d, s):
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            raise ValueError(f"input {tuple(b.shape)} {b.dtype} on {b.device} does not fit its "
                             f"static buffer {tuple(a.shape)} {a.dtype} on {a.device}")
        a.copy_(b)


def _kernel_counters():
    """The kernel wrappers' counters that the tracked frame can move, as
    (wrapper, attribute) pairs."""
    from stereoslam_tpu_torch.ops import lk, lk_level

    return ((lk.lk_pyramid, "launches"), (lk.lk_pyramid, "batched_launches"),
            (lk_level.lk_level, "launches"), (lk_level.lk_final_error, "launches"))


def _single_frame(cfg: SlamConfig, intr: Intrinsics, pre_left: Callable, lr_u8, pyr_prev, fs,
                  track_map):
    left = pre_left(lr_u8[0])
    fs2, pyr, packed = frontend_mod.track_frame(left, pyr_prev, fs, track_map, intr, cfg)
    return left, fs2, pyr, packed


class CapturedGraph:
    """``fn(*inputs)`` replayed as one CUDA graph on static input buffers (on
    the CPU: called on the same buffers, without a graph)."""

    def __init__(self, device, fn: Callable):
        self.device = torch.device(device)
        self._fn = fn
        self.graph = None
        self._inputs = None
        self._outputs = None
        self._launch_deltas: Tuple[int, ...] = ()
        self.replays = 0

    def _load(self, src) -> None:
        if self._inputs is None:
            self._inputs = _clone(src)
        else:
            _copy_into(self._inputs, src)

    def run(self, *src):
        """Copy every input into its static buffer, replay (or call, on the
        CPU), and return the static outputs, valid until the next call."""
        self._load(src)
        if self.device.type == "cpu":
            out = self._fn(*self._inputs)
            if self._outputs is None:
                self._outputs = _clone(out)
            else:
                _copy_into(self._outputs, out)
            return self._outputs
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        for (fn, attr), delta in zip(_kernel_counters(), self._launch_deltas):
            setattr(fn, attr, getattr(fn, attr) + delta)
        return self._outputs

    def capture(self, *src) -> None:
        """Copy the inputs in, warm up and capture, without a replay."""
        self._load(src)
        self._capture()

    def _capture(self) -> None:
        counters = _kernel_counters()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._fn(*self._inputs)  # warm-up: the eager call, results discarded
        stream.wait_stream(side)
        warm = [getattr(fn, attr) for fn, attr in counters]
        graph = torch.cuda.CUDAGraph()
        # No dead graph may be torn down inside the capture (module docstring).
        collecting = gc.isenabled()
        gc.disable()
        try:
            # A capture stream of its own, so a cuBLAS workspace of its own.
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.device),
                                  capture_error_mode="thread_local"):
                self._outputs = self._fn(*self._inputs)
        finally:
            if collecting:
                gc.enable()
        self._launch_deltas = tuple(getattr(fn, attr) - w for (fn, attr), w in zip(counters, warm))
        for (fn, attr), w in zip(counters, warm):
            setattr(fn, attr, w)
        self.graph = graph


class TrackGraph(CapturedGraph):
    """Runs ``track_frame`` (or ``frame_fn``) as one replayed CUDA graph (on
    the CPU: on the same static buffers, without a graph)."""

    def __init__(self, cfg: SlamConfig, intr_left: Intrinsics, device,
                 frame_fn: Optional[Callable] = None, pre_left: Optional[Callable] = None):
        pre_left = pre_left or (lambda u8: u8.to(torch.float32))
        super().__init__(device, frame_fn or partial(_single_frame, cfg, intr_left, pre_left))

    def run(self, lr_u8: torch.Tensor, pyr_prev, fs: FrontendState, map_state
            ) -> Tuple[torch.Tensor, FrontendState, Tuple[torch.Tensor, ...], torch.Tensor]:
        """One tracked frame: the static outputs (left_f32, fs, pyr, packed
        outcome), valid until the next call."""
        return super().run(lr_u8, tuple(pyr_prev), fs, frontend_mod.TrackMap.of(map_state))


def _window_ba(cfg: SlamConfig, intr: Intrinsics, ba_map: backend_mod.BAMap):
    m = backend_mod.optimize_active_map(ba_map, intr, cfg)
    return tuple(getattr(m, f) for f in backend_mod.BA_OUTPUTS)


class BAGraph(CapturedGraph):
    """Runs ``optimize_active_map`` as one replayed CUDA graph of the fixed
    steps (on the CPU: on the same static buffers, without a graph).
    Calling it with a map returns the map after the BA, its six BA fields
    copied out of the graph's memory.  ``record``: a mapping to which each
    call adds its host seconds under ``ba_launch``."""

    def __init__(self, cfg: SlamConfig, intr: Intrinsics, device,
                 record: Optional[MutableMapping[str, float]] = None):
        super().__init__(device, partial(_window_ba, cfg, intr))
        self.record = record

    def _solve(self, ba_map: backend_mod.BAMap) -> Tuple[torch.Tensor, ...]:
        """The six BA fields after the BA, in the graphs' memory."""
        return self.run(ba_map)

    def __call__(self, map_state):
        with span("ba_launch", into=self.record):
            out = self._solve(backend_mod.BAMap.of(map_state))
            return map_state._replace(**{f: t.clone()
                                         for f, t in zip(backend_mod.BA_OUTPUTS, out)})


class _BAState(NamedTuple):
    """The stepped BA's static state, shared by its graphs."""

    gathered: backend_mod.Gathered
    win: "schur._Window"
    n_base: torch.Tensor
    carry: "schur._Carry"


def _ba_open(cfg: SlamConfig, intr: Intrinsics, ba_map: backend_mod.BAMap) -> _BAState:
    prob, gathered = backend_mod.gather_window(ba_map, cfg)
    win, n_base, carry = schur._start(prob, intr, cfg.backend.chi2_threshold, schur.DAMPING0)
    return _BAState(gathered, win, n_base, schur._Carry(*(t.clone() for t in carry)))


class SteppedBA(BAGraph):
    """Runs ``optimize_active_map`` for a caller that waits for its result,
    stopping at the exit rule: its own graph is the prologue (gather,
    compaction, the float64 window and the first carry); then one replay of
    a one-step LM graph a step and one of a round-end graph a round, the
    host reading each exit test, as ``ops/schur.py`` ``_early_exit`` runs
    them; then an epilogue graph (``orthonormalize``, the final chi2, the
    write-back).  On the CPU: the same functions on the same static
    buffers, without graphs.  Called as :class:`BAGraph`; ``steps`` gains
    the LM steps each BA ran, and ``reads`` (a ``HostReads``), where given,
    counts each exit read under ``ba.exit``."""

    def __init__(self, cfg: SlamConfig, intr: Intrinsics, device,
                 record: Optional[MutableMapping[str, float]] = None,
                 reads: Optional[HostReads] = None):
        CapturedGraph.__init__(self, device, partial(_ba_open, cfg, intr))  # the prologue
        self.record, self.reads = record, reads
        self._rounds, self._iters = cfg.backend.ba_rounds, cfg.backend.ba_iters
        self._chi2 = cfg.backend.chi2_threshold
        self._step = CapturedGraph(device, self._lm_step)
        self._round = CapturedGraph(device, self._end_round)
        self._close = CapturedGraph(device, self._write_back)
        self._state: Optional[_BAState] = None
        self.steps: List[int] = []
        # Where each exit test lands on the host: a copy captured at the end
        # of the step's and the round's graphs, waited for through an event.
        if self.device.type == "cuda":
            self._exit_host = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self._exit_landed = torch.cuda.Event()
        else:
            self._exit_host = None

    def _land(self, flag: torch.Tensor) -> torch.Tensor:
        if self._exit_host is not None:
            self._exit_host.copy_(flag, non_blocking=True)
        return flag

    def _lm_step(self) -> torch.Tensor:
        st = self._state
        return self._land(schur._step_in_place(st.win, st.carry))

    def _end_round(self) -> torch.Tensor:
        st = self._state
        return self._land(schur._end_round_in_place(st.win, st.carry, st.n_base, self._chi2))

    def _write_back(self) -> Tuple[torch.Tensor, ...]:
        st, (ba_map,) = self._state, self._inputs
        c = st.carry
        res = schur._finish(st.win, c.cam_T, c.lm_pos, c.inlier, ba_map.kf_T_cw.dtype)
        m = backend_mod.write_back(ba_map, st.gathered, res)
        return tuple(getattr(m, f) for f in backend_mod.BA_OUTPUTS)

    def _read(self, graph: CapturedGraph) -> bool:
        """Run ``graph`` and read its exit test on the host."""
        out = graph.run()
        with host_read(self.reads, "ba.exit"):
            if self._exit_host is not None:
                self._exit_landed.record()
                self._exit_landed.synchronize()
                out = self._exit_host
            return bool(out)

    def _solve(self, ba_map: backend_mod.BAMap) -> Tuple[torch.Tensor, ...]:
        if self.device.type == "cuda" and self._close.graph is None:
            # The warm-ups of the step and the round advance the carry:
            # capture every graph before the prologue's replay below.
            self._state = self.run(ba_map)
            for g in (self._step, self._round, self._close):
                g.capture()
        self._state = self.run(ba_map)
        self.steps.append(schur._early_exit(lambda: self._read(self._step),
                                            lambda: self._read(self._round),
                                            self._rounds, self._iters))
        return self._close.run()
