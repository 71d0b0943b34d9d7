"""One CUDA graph of the tracked frame per ``StereoSlam`` (and of the
batched tracked step per ``MultiSeqVO``): the port's counterpart of the JAX
package's jitted frame program.

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
feed thread that stages the next frames meanwhile does not break it.  A
failed capture raises; a CUDA tensor never falls back to the eager frame.

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
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional, Tuple

import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core import frontend as frontend_mod
from stereoslam_tpu_torch.core.state import FrontendState
from stereoslam_tpu_torch.ops.camera import Intrinsics


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


class TrackGraph:
    """Runs ``track_frame`` (or ``frame_fn``) as one replayed CUDA graph (on
    the CPU: on the same static buffers, without a graph)."""

    def __init__(self, cfg: SlamConfig, intr_left: Intrinsics, device,
                 frame_fn: Optional[Callable] = None, pre_left: Optional[Callable] = None):
        self.device = torch.device(device)
        pre_left = pre_left or (lambda u8: u8.to(torch.float32))
        self._frame = frame_fn or partial(_single_frame, cfg, intr_left, pre_left)
        self.graph = None
        self._inputs = None
        self._outputs = None
        self._launch_deltas: Tuple[int, ...] = ()
        self.replays = 0

    def run(self, lr_u8: torch.Tensor, pyr_prev, fs: FrontendState, map_state
            ) -> Tuple[torch.Tensor, FrontendState, Tuple[torch.Tensor, ...], torch.Tensor]:
        """One tracked frame: copy every input into its static buffer, replay
        (or call, on the CPU), and return the static outputs (left_f32, fs,
        pyr, packed outcome), valid until the next call."""
        src = (lr_u8, tuple(pyr_prev), fs, frontend_mod.TrackMap.of(map_state))
        if self._inputs is None:
            self._inputs = _clone(src)
        else:
            _copy_into(self._inputs, src)
        if self.device.type == "cpu":
            out = self._frame(*self._inputs)
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
            self._frame(*self._inputs)  # warm-up: the eager frame, results discarded
        stream.wait_stream(side)
        warm = [getattr(fn, attr) for fn, attr in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._outputs = self._frame(*self._inputs)
        self._launch_deltas = tuple(getattr(fn, attr) - w for (fn, attr), w in zip(counters, warm))
        for (fn, attr), w in zip(counters, warm):
            setattr(fn, attr, w)
        self.graph = graph
