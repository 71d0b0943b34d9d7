"""One CUDA graph of the tracked frame per ``StereoSlam`` (and of the
batched tracked step per ``MultiSeqVO``), and one of the windowed BA per
facade: the port's counterparts of the JAX package's jitted frame and BA
programs.  Both are a :class:`CapturedGraph`: a function that reads nothing
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
such runs of phase main's frames differed).  A failed capture raises; a
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

**The windowed BA** (:class:`BAGraph`): ``core/backend.py``
``optimize_active_map`` (the window's gather and landmark compaction, the
float64 Schur LM of ``ops/schur.py`` with every one of its ``rounds x
iters`` steps run and its exit tests frozen on the device, the write-back)
reads nothing back, and its shapes come from the config (W, N, C = W * N,
the map's capacities), so it is captured at the facade's first BA, with the
same warm-up, ``thread_local`` capture and launch counts.  Its inputs are
the map fields the BA reads (``BAMap``), copied in before every replay: at
KITTI geometry with the full-size state (1536 keyframe rows of 400
features, 131,072 landmark rows, W = 7) 11.07 MB, of which the keyframe
feature tables are 7.99 MB (1536 x 400 x (8 + 4 + 1) bytes) and the
landmark fields 2.88 MB: about 6.6 us of the card's time at 3.35 TB/s.
Its six outputs (``kf_T_cw``, ``kf_rel_prev``, ``lm_pos``, ``kf_feat_lm``,
``lm_obs_count``, ``lm_outlier``; 4.88 MB, about 2.9 us) are copied out of
the graph's memory before they become the map's fields, since the next
replay overwrites them.  A replay computes all ``rounds x iters`` steps, the
frozen ones too: on phase main's final map 88.0-88.8 ms of the card's time,
where the host-read early exit stops after 2 steps and 3.9 ms (NVIDIA H100
80GB HBM3, 700.00 W; ``chip_smoke.py`` phase ba).  A replay runs on the
caller's current stream: the facade's own stream for the inline BA and the
batched keyframe service, a side stream for the asynchronous BA
(``core/system.py``).  A call is a host span, ``ba_launch`` (copy-in,
replay, the six copies out), added to ``record`` where the owner gives one.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, MutableMapping, Optional, Tuple

import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core import backend as backend_mod
from stereoslam_tpu_torch.core import frontend as frontend_mod
from stereoslam_tpu_torch.core.state import FrontendState
from stereoslam_tpu_torch.ops.camera import Intrinsics
from stereoslam_tpu_torch.utils.prof import span


def _flat(tree) -> List[torch.Tensor]:
    """The tensors of a nested tuple (NamedTuples included), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for item in tree for t in _flat(item)]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
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

    def run(self, *src):
        """Copy every input into its static buffer, replay (or call, on the
        CPU), and return the static outputs, valid until the next call."""
        if self._inputs is None:
            self._inputs = _clone(src)
        else:
            _copy_into(self._inputs, src)
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
        # A capture stream of its own, so a cuBLAS workspace of its own.
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.device),
                              capture_error_mode="thread_local"):
            self._outputs = self._fn(*self._inputs)
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
    """Runs ``optimize_active_map`` as one replayed CUDA graph (on the CPU:
    on the same static buffers, without a graph).  Calling it with a map
    returns the map after the BA, its six BA fields copied out of the
    graph's memory.  ``record``: a mapping to which each call adds its host
    seconds under ``ba_launch``."""

    def __init__(self, cfg: SlamConfig, intr: Intrinsics, device,
                 record: Optional[MutableMapping[str, float]] = None):
        super().__init__(device, partial(_window_ba, cfg, intr))
        self.record = record

    def __call__(self, map_state):
        with span("ba_launch", into=self.record):
            out = self.run(backend_mod.BAMap.of(map_state))
            return map_state._replace(**{f: t.clone()
                                         for f, t in zip(backend_mod.BA_OUTPUTS, out)})
