"""Batched multi-sequence mode: B independent stereo sequences a step
(port of ``stereoslam_tpu/parallel/multiseq.py``).

A batch of B sequences runs the whole per-sequence pipeline: LK tracking,
the pose LM, the keyframe decision, per-sequence windowed BA and verified,
applied loop closing.  A step is

1. **the batched tracked step**, :func:`batched_track_frame`: the B left
   pyramids, :func:`~stereoslam_tpu_torch.core.frontend.track_step` over
   the batch by ``torch.func.vmap``, the status, the motion clock
   (``since``, ``force``, ``make_kf``), the keyframe priority and the
   top-``kf_sub`` selection, and one packed (B, 7) outcome.  It reads
   nothing back, so :class:`MultiSeqVO` replays it as one CUDA graph
   (``core/graphs.py`` ``TrackGraph`` with this step as its frame
   function).  The two kernels that vmap cannot trace through, K1's
   ``lk_pyramid`` and ``ops/svd.py``'s cuSOLVER call, are custom ops whose
   batching rules go to their batched launches: one ``lk_pyramid`` launch
   for the B sequences' temporal calls;
2. **one read of the packed outcome** on the host;
3. **keyframe service** for the selected sequences (at most ``kf_sub``,
   most overdue first, BAD status outranking the motion clock; the rest
   stay eligible and win a later step): ``make_keyframe_step``, the
   windowed BA (one replayed CUDA graph, ``core/graphs.py`` ``BAGraph``),
   the descriptor of the left image and the reduced-pyramid
   ORB rows, each written into the batched state in place, then
   :func:`batched_loop_detect` over the whole batch.  The serviced
   sequences are looped over from the host, as the keyframe branch of
   ``StereoSlam`` is;
4. **retire**, ``readback_lag`` steps later: liveness, and each detected
   loop verified and corrected through the single-sequence stages of
   ``core/loopclosing.py`` on that sequence's slice.

**The keyframe rule is the JAX batched mode's** (``multiseq.py:298-340``),
not the single-sequence facade's: no ``kf_min_interval`` and no BA spacing;
every serviced keyframe runs a BA.

**hoist_branches** (default True, as in JAX): the run config sets
``lk_retry_fail_frac=0`` and ``replenish_min_inliers=0``, so the LK rescue
passes never run.  Replenishment is not on this path in either package:
the batched step calls ``track_step``, not the single-sequence frame step,
so the replenish branch never fires, whatever the config.  With
``hoist_branches=False`` the two rescue calls run batched, each gated by a
(B,) device bool.

**The copy-in of the graph.**  Every replay copies its inputs into the
graph's static buffers (``core/graphs.py``): at bench.py Phase M's shapes
(B=8, 240x376, 3 LK levels, 400 features, 131,072 landmark rows and 1536
keyframe rows a sequence) that is the previous pyramids, 8 x 240 x 376 x 4 B
x 1.3125 = 3.79 MB, the landmark fields the step reads (``lm_pos``,
``lm_valid``, ``lm_outlier``), 8 x 131,072 x 14 B = 14.7 MB, the stereo
stack 1.44 MB, and under 0.2 MB of keyframe poses and tracks: about 20 MB
a step, about 6 us of the card's memory time.  The loop database is not an
input of the step and is not copied.

**mesh** (``parallel/mesh.py``): the batch is sharded over the mesh's data
axis, as JAX shards it (``multiseq.py:278-286``).  Rank r of that axis owns
sequences ``[r B/dp, (r+1) B/dp)``: it holds their state, captures its own
graph over them and serves their keyframes and loops.  ``initialize``,
``process_frames`` and ``process_staged`` take the whole (B, ...) batch on
every rank, as JAX's do.  Inside the step one sum over the axis
(``distributed.host_local_array``) gives every rank the outcome rows of all
B sequences, the keyframe priorities among them, so the top-``kf_sub``
selection is the unsharded run's (JAX's is global too); NCCL's sum is
captured in the graph, Gloo's runs on the CPU, where there is no graph.
:func:`make_data_parallel_step` is JAX's (step, shard_batch) pair.

**What a step records** (``utils/prof.py``).  ``stage_s[key]`` holds one
entry a step for every key, 0 where the step had none of it: host seconds
of ``track`` (copy-in, the replay, the outcome read), ``keyframes`` (the
keyframe service), ``retire``, and inside the service ``kf_branch`` (each
served sequence's right pyramid and ``make_keyframe_step``) and
``ba_launch`` (each ``BAGraph`` call: copy-in, replay, copies out);
and ``host_wait``, the seconds blocked in the step's host reads.  A graph
replay's device time is not recorded here: a trace of the card holds it.
``reads`` (a ``HostReads``) counts every blocking host sync by site
(``outcome``; ``kf.n_kf``, ``stereo.*`` and ``insert.*`` inside
``make_keyframe_step``; ``service.kf_id``; ``detect`` at a retire), and
``step_reads`` holds each step's count; ``outcome`` and ``detect`` wait on
an event (``EVENT_READ_SITES``), the others on a synchronizing call.  Every
stage is a ``slam.*`` span on the profiler's timeline while it records.

**Undistortion.**  As in JAX (``multiseq.py:218-220``), the batched mode reads
only the pinhole intrinsics of ``cfg.camera`` and tracks distorted frames
as they are; a config with ``need_undistortion`` logs that once.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core import frontend as frontend_mod
from stereoslam_tpu_torch.core.graphs import BAGraph, TrackGraph
from stereoslam_tpu_torch.core.loopclosing import LoopCloser, post_correction_unlink
from stereoslam_tpu_torch.core.state import (LOST, TRACKING_BAD, TRACKING_GOOD, LoopState,
                                             TrackState, init_frontend_state, init_map_state)
from stereoslam_tpu_torch.models import calc
from stereoslam_tpu_torch.ops.camera import Intrinsics
from stereoslam_tpu_torch.ops.image import build_lk_pyramid
from stereoslam_tpu_torch.ops.orb import pyramid_orb
from stereoslam_tpu_torch.parallel.distributed import host_local_array
from stereoslam_tpu_torch.parallel.mesh import axis_index, axis_size
from stereoslam_tpu_torch.utils.prof import HostReads, host_read, span

log = logging.getLogger(__name__)

# Columns of the batched step's packed float32 outcome (B, OUTCOME_COLUMNS).
OUTCOME_COLUMNS = ("num_inliers", "num_tracked", "status", "make_kf", "serviced", "retry",
                   "deep")
# The per-step keys of ``MultiSeqVO.stage_s``: host seconds.
STEP_KEYS = ("track", "keyframes", "retire", "kf_branch", "ba_launch", "host_wait")
# Read sites that wait on an event (not a synchronizing call).
EVENT_READ_SITES = ("outcome", "detect")


def _take(tree, b: int):
    """Sequence ``b``'s slice of a batched NamedTuple (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    return type(tree)(*(_take(x, b) for x in tree))


def _put(tree, b: int, new) -> None:
    """Write ``new`` into sequence ``b``'s slice of ``tree`` in place;
    a field that is still the slice itself is left alone."""
    if isinstance(tree, torch.Tensor):
        dst = tree[b]
        if new.data_ptr() != dst.data_ptr() or new.stride() != dst.stride():
            dst.copy_(new)
        return
    for x, y in zip(tree, new):
        _put(x, b, y)


def _broadcast(tree, batch: int):
    if isinstance(tree, torch.Tensor):
        return tree[None].expand((batch,) + tuple(tree.shape)).clone()
    return type(tree)(*(_broadcast(x, batch) for x in tree))


@contextmanager
def _cusolver(device: torch.device):
    """cuSOLVER for the batched small factorizations and solves on the card:
    by default PyTorch sends a batched ``cholesky_solve`` to MAGMA, which
    allocates on the host and cannot be captured in a CUDA graph."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _track_pyramids(fs, map_state, pyr_prev: Sequence[torch.Tensor],
                    pyr_cur: Sequence[torch.Tensor], intr: Intrinsics, cfg: SlamConfig):
    """``track_step`` vmapped over the leading dim of every operand."""

    def one(fs_i, map_i, p0, p1):
        return frontend_mod.track_step(fs_i, map_i, p0, p1, intr, cfg, host_exit=False)

    with _cusolver(pyr_prev[0].device):
        return torch.func.vmap(one)(fs, map_state, tuple(pyr_prev), tuple(pyr_cur))


def batched_track_step(fs, map_state, prev_left: torch.Tensor, cur_left: torch.Tensor,
                       intr: Intrinsics, cfg: SlamConfig) -> frontend_mod.TrackOutput:
    """One tracking step for B sequences at once (the vmapped frontend):
    ``fs`` and ``map_state`` carry a leading B on every field, the images
    are (B, H, W) float32."""
    levels = cfg.tracking.lk_levels
    return _track_pyramids(fs, map_state, build_lk_pyramid(prev_left, levels),
                           build_lk_pyramid(cur_left, levels), intr, cfg)


def make_data_parallel_step(mesh, intr: Intrinsics, cfg: SlamConfig, data_axis: str = "data"):
    """JAX's data-parallel batched step: ``shard_batch`` takes this rank's
    rows ``[r B/dp, (r+1) B/dp)`` along the data axis of every leaf of a
    batched tree (tensors with a leading B), and ``step`` is
    :func:`batched_track_step` on them."""
    n, r = axis_size(mesh, data_axis), axis_index(mesh, data_axis)

    def shard_batch(tree):
        if isinstance(tree, torch.Tensor):
            if tree.shape[0] % n:
                raise ValueError(f"a batch of {tree.shape[0]} does not split over {n} ranks")
            rows = tree.shape[0] // n
            return tree[r * rows:(r + 1) * rows]
        items = [shard_batch(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)

    def step(fs, map_state, prev_left, cur_left):
        return batched_track_step(fs, map_state, prev_left, cur_left, intr, cfg)

    return step, shard_batch


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def batched_track_frame(left: torch.Tensor, pyr_prev: Sequence[torch.Tensor], fs, map_state,
                        intr: Intrinsics, cfg: SlamConfig, kf_sub: int,
                        share: Callable[[torch.Tensor], torch.Tensor] = _identity):
    """The batched tracked step up to keyframe service (JAX ``fused`` up to
    its ``lax.cond``): the pyramids of ``left`` (B, H, W), the vmapped
    ``track_step``, the status, the motion clock, the priority and the
    top-``kf_sub`` selection.  Reads nothing back.  ``map_state`` may be a
    :class:`~stereoslam_tpu_torch.core.frontend.TrackMap`.  ``share`` turns
    the outcome rows of this call's sequences (the priority in the
    ``serviced`` column) into those of the whole batch (a sum over the
    ranks of a mesh's data axis), before the selection.

    Returns (fs with each sequence's status, the (B, ...) pyramid, the
    packed float32 outcome of the whole batch (B, len(OUTCOME_COLUMNS)):
    num_inliers, num_tracked, status, make_kf, serviced, retry, deep)."""
    f = cfg.features
    dev = left.device
    pyr = build_lk_pyramid(left, cfg.tracking.lk_levels)
    out = _track_pyramids(fs, map_state, pyr_prev, pyr, intr, cfg)
    n_inl = out.num_inliers

    def const(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    status = torch.where(n_inl > f.num_features_tracking_good, const(TRACKING_GOOD),
                         torch.where(n_inl > f.num_features_tracking_bad, const(TRACKING_BAD),
                                     const(LOST)))
    fs2 = out.state._replace(status=status)
    ref = torch.clamp(fs2.ref_kf, min=0).long()
    since = fs2.frame_id - map_state.kf_frame_id.gather(1, ref[:, None])[:, 0]
    interval = cfg.tracking.kf_max_interval
    force = ((status == TRACKING_GOOD) & (since >= interval) if interval > 0
             else torch.zeros_like(status, dtype=torch.bool))
    make_kf = (status == TRACKING_BAD) | force
    # Most overdue first; BAD tracking outranks the motion clock.  A stable
    # descending sort gives ties to the lower index, as lax.top_k does.
    prio = torch.where(make_kf, since + 10000 * (status == TRACKING_BAD).to(torch.int32),
                       torch.full_like(since, -1))
    packed = share(torch.stack([n_inl, out.num_tracked, status, make_kf, prio, out.retry,
                                out.deep], dim=1).to(torch.float32))
    col = OUTCOME_COLUMNS.index("serviced")
    # The priorities are small integers, exact in float32.
    sub_idx = torch.sort(packed[:, col], descending=True, stable=True).indices[:kf_sub]
    make_all = packed[:, OUTCOME_COLUMNS.index("make_kf")]
    serviced = torch.zeros_like(make_all).index_copy(0, sub_idx, make_all.index_select(0, sub_idx))
    packed = torch.cat([packed[:, :col], serviced[:, None], packed[:, col + 1:]], dim=1)
    return fs2, pyr, packed


class BatchLoopDB(NamedTuple):
    """Per-sequence loop-closing database: deep descriptors for detection
    plus reduced-pyramid ORB descriptors for verification (the batched
    counterpart of ``LoopState``).  ``orb_desc`` holds the JAX package's
    uint32 words as int32 with the same bits."""

    deep_db: torch.Tensor      # (B, K, D) f32, L2-normalized descriptors
    db_valid: torch.Tensor     # (B, K) bool
    loop_with: torch.Tensor    # (B, K) i32, detected loop partner KF or -1
    loop_score: torch.Tensor   # (B, K) f32, similarity of the detection
    last_closed: torch.Tensor  # (B,) i32, cooldown anchor (loopclosing.cpp:674)
    # Verification store (None in detection-only mode).
    orb_desc: Optional[torch.Tensor] = None   # (B, K, M, 8) i32
    orb_xy: Optional[torch.Tensor] = None     # (B, K, M, 2) f32
    orb_class: Optional[torch.Tensor] = None  # (B, K, M) i32, source feature slot
    orb_valid: Optional[torch.Tensor] = None  # (B, K, M) bool


def batched_loop_detect(ldb: BatchLoopDB, desc: torch.Tensor, make_kf: torch.Tensor,
                        new_kf: torch.Tensor, cfg: SlamConfig):
    """Per-sequence deep loop detection and database bookkeeping, vectorized
    over the batch (the rules of loopclosing.cpp:124-161: id gap, warm-up
    size, high/low thresholds, max suspects, insertion cooldown).  ``desc``
    (B, D), ``make_kf`` (B,) bool, ``new_kf`` (B,) i32 (negative where no KF).
    Returns (ldb', found (B,) bool, loop_kf (B,) i32, -1 where not found);
    ``ldb`` is left untouched."""
    lc = cfg.loop
    B, K = ldb.db_valid.shape
    dev = desc.device
    kfi = torch.clamp(new_kf, min=0).long()
    bidx = torch.arange(B, device=dev)
    ids = torch.arange(K, device=dev)[None, :]
    eligible = ldb.db_valid & ((kfi[:, None] - ids) >= lc.id_gap)
    scores = torch.einsum("bkd,bd->bk", ldb.deep_db, desc)
    scores = torch.where(eligible, scores, torch.full_like(scores, -1.0))
    best = torch.argmax(scores, dim=1)
    max_score = scores[bidx, best]
    n_suspect = (scores > lc.similarity_low).to(torch.int32).sum(1)
    db_size = ldb.db_valid.to(torch.int32).sum(1)
    in_cooldown = (kfi - ldb.last_closed) <= lc.insertion_cooldown
    found = (make_kf & ~in_cooldown & (db_size > lc.database_min_size)
             & (max_score >= lc.similarity_high) & (n_suspect <= lc.max_above_low))

    def row_set(x, v):
        out = x.clone()
        out[bidx, kfi] = v
        return out

    best32 = best.to(torch.int32)
    loop_with = row_set(ldb.loop_with, torch.where(found, best32, ldb.loop_with[bidx, kfi]))
    loop_score = row_set(ldb.loop_score, torch.where(found, max_score, ldb.loop_score[bidx, kfi]))
    # Insertion, skipped during the cooldown (loopclosing.cpp:674-679).
    do_insert = make_kf & ~in_cooldown
    deep_db = row_set(ldb.deep_db, torch.where(do_insert[:, None], desc, ldb.deep_db[bidx, kfi]))
    db_valid = row_set(ldb.db_valid, ldb.db_valid[bidx, kfi] | do_insert)
    return (ldb._replace(deep_db=deep_db, db_valid=db_valid, loop_with=loop_with,
                         loop_score=loop_score),
            found, torch.where(found, best32, torch.full_like(best32, -1)))


class _Entry(NamedTuple):
    """A step waiting to retire."""

    counts: np.ndarray  # (B, 6) int64: n_inl, n_tracked, status, kf_id, found, loop_kf
    # A keyframe step's detection (B, 2) i32 (found, loop_kf), copied to the
    # host without a wait, and the event that marks its landing (None on the
    # CPU); None on other steps.
    detect: Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event]]]


class MultiSeqVO:
    """Batched full-pipeline stereo SLAM over B independent sequences.

    The tracked step of the whole batch is one replayed CUDA graph and one
    read of its outcome; keyframe work runs for at most ``kf_sub`` sequences
    a step (see the module docstring).  Outcomes retire ``readback_lag``
    steps late; detected loops are verified and corrected per sequence
    through the single-sequence stages.

    With a ``mesh`` this rank holds the sequences ``self.rows`` of the
    batch: ``fs``, ``maps`` and ``loopdb`` carry ``len(self.rows)`` on their
    leading dim, while ``alive``, the returned counts and the sequence
    arguments of the accessors are over all ``batch`` sequences.
    """

    def __init__(self, cfg: SlamConfig, batch: int, mesh=None, readback_lag: Optional[int] = None,
                 enable_backend: bool = True, enable_loop: bool = True, descriptor_model=None,
                 kf_sub: int = 2, verify_loops: bool = True, orb_levels: int = 2,
                 hoist_branches: bool = True, device="cuda"):
        """``device``: the card unless the caller asks for ``"cpu"`` (which
        runs the plain versions of the kernels and the step without a
        graph).  ``readback_lag``: steps between a step and its retire
        (default 0 on the CPU, 4 on the card, as in JAX).  ``mesh``: a
        ``DeviceMesh`` whose data axis shards the batch (``batch`` must be a
        multiple of its size; see the module docstring)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MultiSeqVO runs on the card by default and no CUDA device is "
                               "available: pass device='cpu' to run on the CPU")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a MultiSeqVO on {self.device}")
        if cfg.camera.need_undistortion:
            log.warning("MultiSeqVO reads only the pinhole intrinsics of cfg.camera: the batched "
                        "mode does not undistort, as the JAX package's does not")
        cfg.validate()
        self.cfg = cfg
        self.batch = int(batch)
        self.mesh = mesh
        dp = 1 if mesh is None else axis_size(mesh, "data")
        if self.batch % dp:
            raise ValueError(f"a batch of {self.batch} does not split over the mesh's {dp} data "
                             f"ranks")
        lo = 0 if mesh is None else axis_index(mesh, "data") * (self.batch // dp)
        self.rows = range(lo, lo + self.batch // dp)
        self.enable_backend = enable_backend
        self.enable_loop = enable_loop
        self.verify_loops = bool(verify_loops and enable_loop)
        self.kf_sub = max(1, min(int(kf_sub), self.batch))
        if hoist_branches:
            # Under vmap JAX runs both sides of the rescue and replenish
            # lax.cond for every sequence; the batched mode therefore runs
            # the reference-parity frontend (KF-time triangulation only).
            cfg = cfg.replace(tracking=dataclasses.replace(
                cfg.tracking, lk_retry_fail_frac=0.0, replenish_min_inliers=0))
        self._run_cfg = cfg
        cam = cfg.camera
        self.intr = Intrinsics.create(cam.fx, cam.fy, cam.cx, cam.cy)
        self.intr_right = Intrinsics.create(cam.fx_right, cam.fy_right, cam.cx_right,
                                            cam.cy_right)
        if readback_lag is None:
            readback_lag = 0 if self.device.type == "cpu" else 4
        self.readback_lag = int(readback_lag)
        if self.readback_lag < 0:
            raise ValueError(f"readback_lag must be >= 0, got {readback_lag}")
        self._inflight: List[_Entry] = []
        self.model = descriptor_model or calc.DescriptorModel.default()
        # Reduced-pyramid config of the batched ORB store: the single
        # sequence's full 8-level set would cost 4x the memory (B x K x M rows).
        self._vcfg = cfg.replace(features=dataclasses.replace(cfg.features,
                                                              n_levels=max(1, orb_levels)))
        dev = self.device
        B = len(self.rows)
        self.fs = _broadcast(init_frontend_state(cfg, dev), B)
        self.maps = _broadcast(init_map_state(cfg, dev), B)
        K, D = cfg.map.max_keyframes, cfg.loop.descriptor_dim
        M = cfg.features.max_features * self._vcfg.features.n_levels
        if enable_loop:
            v = self.verify_loops
            self.loopdb = BatchLoopDB(
                deep_db=torch.zeros((B, K, D), dtype=torch.float32, device=dev),
                db_valid=torch.zeros((B, K), dtype=torch.bool, device=dev),
                loop_with=torch.full((B, K), -1, dtype=torch.int32, device=dev),
                loop_score=torch.zeros((B, K), dtype=torch.float32, device=dev),
                last_closed=torch.full((B,), -(10 ** 6), dtype=torch.int32, device=dev),
                orb_desc=torch.zeros((B, K, M, 8), dtype=torch.int32, device=dev) if v else None,
                orb_xy=torch.zeros((B, K, M, 2), dtype=torch.float32, device=dev) if v else None,
                orb_class=torch.full((B, K, M), -1, dtype=torch.int32, device=dev) if v else None,
                orb_valid=torch.zeros((B, K, M), dtype=torch.bool, device=dev) if v else None,
            )
        else:
            self.loopdb = None
        if self.verify_loops:
            # The single-sequence verification and correction stages, with
            # the reduced-pyramid config and the batched detector's model.
            self._lc = LoopCloser(self._vcfg, self.intr, dev, descriptor_model=self.model)
            self._lc.generator = torch.Generator(device=dev).manual_seed(23)
        self.alive = np.ones(self.batch, bool)
        self.loop_closures: List[List[Tuple[int, int]]] = [[] for _ in range(self.batch)]
        self._pyr_prev = None
        self._last_counts: Optional[np.ndarray] = None
        self._bad = cfg.features.num_features_tracking_bad
        self.graph = TrackGraph(cfg, self.intr, dev, frame_fn=self._frame)
        # The step in progress: seconds by key (see the module docstring).
        self._rec = defaultdict(float)
        # The windowed BA of a serviced keyframe, one sequence's map at a
        # time: one replayed CUDA graph (core/graphs.py).
        self._ba = BAGraph(self._run_cfg, self.intr, dev, record=self._rec)
        if dev.type == "cuda":
            self._host_outcome = torch.empty((self.batch, len(OUTCOME_COLUMNS)),
                                             dtype=torch.float32, pin_memory=True)
            self._outcome_landed = torch.cuda.Event()
        else:
            self._host_outcome = None
        # Blocking host syncs by site, and each step's count.
        self.reads = HostReads()
        self.step_reads: List[int] = []
        self.steps = 0
        self.keyframes_serviced = 0
        # One entry a step for every key of STEP_KEYS: seconds.
        self.stage_s = defaultdict(list)

    @property
    def outcome_reads(self) -> int:
        """Reads of step outcomes: one a step."""
        return self.reads.counts["outcome"]

    def _share(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's per-sequence rows -> the whole batch's (one sum over
        the mesh's data axis; the rows themselves without a mesh)."""
        return rows if self.mesh is None else host_local_array(self.mesh, "data", rows)

    def _frame(self, lr_u8, pyr_prev, fs, track_map):
        """The graph's frame function: the batched tracked step."""
        left = lr_u8[:, 0].to(torch.float32)
        fs2, pyr, packed = batched_track_frame(left, pyr_prev, fs, track_map, self.intr,
                                               self._run_cfg, self.kf_sub, share=self._share)
        return left, fs2, pyr, packed

    def _local(self, seq: int) -> int:
        """This rank's index of sequence ``seq`` of the batch."""
        if seq not in self.rows:
            raise ValueError(f"sequence {seq} is held by another rank (this one holds "
                             f"{self.rows.start}..{self.rows.stop - 1})")
        return seq - self.rows.start

    # ------------------------------------------------------------------
    def _stack(self, left: np.ndarray, right: np.ndarray) -> torch.Tensor:
        """This rank's rows of a host (B, H, W) stereo batch, stacked on the device."""
        rows = slice(self.rows.start, self.rows.stop)
        lr = np.stack([np.asarray(left)[rows], np.asarray(right)[rows]], axis=1).astype(np.uint8)
        return torch.from_numpy(lr).to(self.device)

    def initialize(self, left: np.ndarray, right: np.ndarray, ts) -> np.ndarray:
        """Stereo-init every sequence on its first frame ((B, H, W) images,
        B timestamps).  Returns the per-sequence landmark counts.  The
        initialization keyframe runs no BA and enters no loop database, as
        in JAX."""
        lr = self._stack(left, right)
        ts = np.asarray(ts)[self.rows.start:self.rows.stop]
        left_f = lr[:, 0].to(torch.float32)
        right_f = lr[:, 1].to(torch.float32)
        levels = self._run_cfg.tracking.lk_levels
        n_lm = torch.zeros(len(self.rows), dtype=torch.float32, device=self.device)
        for b in range(len(self.rows)):
            t = torch.full((), float(ts[b]), dtype=torch.float32, device=self.device)
            fs_b, m_b, _, n = frontend_mod.stereo_init_step(
                left_f[b], build_lk_pyramid(left_f[b], levels),
                build_lk_pyramid(right_f[b], levels), _take(self.fs, b), _take(self.maps, b),
                self.intr, self.intr_right, self._run_cfg.camera.baseline, t, self._run_cfg)
            _put(self.fs, b, fs_b)
            _put(self.maps, b, m_b)
            n_lm[b] = n
        self._pyr_prev = build_lk_pyramid(left_f, levels)
        return self._share(n_lm).cpu().numpy().astype(np.int64)

    def process_frames(self, left: np.ndarray, right: np.ndarray, ts) -> np.ndarray:
        """One step of the whole batch from host (B, H, W) images; see
        :meth:`process_staged` (a :class:`~stereoslam_tpu_torch.utils.feed.BatchFeed`
        stages the stacks ahead instead).  With a mesh, only this rank's rows
        go to the device."""
        return self._step(self._stack(left, right), np.asarray(ts)[self.rows.start:self.rows.stop])

    def process_staged(self, lr_u8: torch.Tensor, ts) -> np.ndarray:
        """One step whose (B, 2, H, W) uint8 stack already lies on the
        device; ``ts``: B timestamps on the host.  With a mesh, only this
        rank's rows of the stack are read.

        Returns the most recently retired per-sequence inlier counts: under
        lag N they describe step t-N (with lag 0 they are exactly current);
        before anything retired, counts above the BAD threshold."""
        if self.mesh is not None:
            lr_u8 = lr_u8[self.rows.start:self.rows.stop]
            ts = np.asarray(ts)[self.rows.start:self.rows.stop]
        return self._step(lr_u8, ts)

    def _step(self, lr_u8: torch.Tensor, ts) -> np.ndarray:
        """One step of this rank's sequences: their (B, 2, H, W) stack on the
        device and their timestamps."""
        if self._pyr_prev is None:
            raise RuntimeError("MultiSeqVO.initialize must run before the first step")
        rec, reads = self._rec, self.reads
        rec.clear()
        n0, s0 = reads.n, reads.s
        with span("track", into=rec):
            left, fs, pyr, packed = self.graph.run(lr_u8, self._pyr_prev, self.fs, self.maps)
            if self._host_outcome is not None:
                self._host_outcome.copy_(packed, non_blocking=True)
                self._outcome_landed.record()
            self.fs, self._pyr_prev = fs, pyr
            self.steps += 1
        # Older steps retire while the card runs this one.
        with span("retire", into=rec):
            self._retire_beyond(self.readback_lag - 1)
        with span("track", into=rec):
            o = self._read_outcome(packed)
            counts = np.zeros((self.batch, 6), np.int64)
            counts[:, :3] = o[:, :3]
            counts[:, 3] = -1
            detect = None
            serviced = np.nonzero(o[self.rows.start:self.rows.stop,
                                    OUTCOME_COLUMNS.index("serviced")])[0]
        with span("keyframes", into=rec):
            if serviced.size:
                kf_ids, detect = self._service_keyframes(serviced, lr_u8, left, pyr, ts)
                counts[self.rows.start:self.rows.stop, 3] = kf_ids
            self._inflight.append(_Entry(counts, detect))
        with span("retire", into=rec):
            self._retire_beyond(self.readback_lag)
        rec["host_wait"] = reads.s - s0
        for key in STEP_KEYS:
            self.stage_s[key].append(rec.get(key, 0.0))
        self.step_reads.append(reads.n - n0)
        if self._last_counts is None:
            return np.full(self.batch, self._bad + 1, np.int64)
        return self._last_counts[:, 0]

    def _read_outcome(self, packed: torch.Tensor) -> np.ndarray:
        """The step's one device-to-host read."""
        with host_read(self.reads, "outcome"):
            if self._host_outcome is not None:
                self._outcome_landed.synchronize()
                packed = self._host_outcome
            return packed.numpy().astype(np.int64)

    def _service_keyframes(self, serviced: np.ndarray, lr_u8, left, pyr, ts):
        """Keyframe work of the selected sequences (JAX ``kf_service``; this
        rank's indices), written into the batched state in place, then loop
        detection over this rank's sequences.  Returns (kf id per sequence,
        -1 where none; the detection (B, 2) on the device, or None without
        loop closing)."""
        cfg, dev = self._run_cfg, self.device
        B = len(self.rows)
        kf_ids = np.full(B, -1, np.int64)
        desc = torch.zeros((B, cfg.loop.descriptor_dim), dtype=torch.float32, device=dev)
        for b in serviced.tolist():
            with span("kf_branch", into=self._rec):
                right = lr_u8[b, 1].to(torch.float32)
                t = torch.full((), float(ts[b]), dtype=torch.float32, device=dev)
                fs_b, m_b, kf = frontend_mod.make_keyframe_step(
                    left[b], tuple(p[b] for p in pyr),
                    build_lk_pyramid(right, cfg.tracking.lk_levels), _take(self.fs, b),
                    _take(self.maps, b), self.intr, self.intr_right, cfg.camera.baseline, t, cfg,
                    reads=self.reads)
            if self.enable_backend:
                # The batched mode runs a BA on every serviced keyframe.
                m_b = self._ba(m_b)
            # The wait for the keyframe's id is the wait for its BA.
            with host_read(self.reads, "service.kf_id"):
                kf = int(kf)
            kf_ids[b] = kf
            if self.enable_loop:
                desc[b] = self.model(left[b])
            if self.verify_loops and kf >= 0:
                orb = pyramid_orb(left[b], m_b.kf_feat_xy[kf], m_b.kf_feat_valid[kf], self._vcfg)
                ldb = self.loopdb
                for store, rows in ((ldb.orb_desc, orb.desc), (ldb.orb_xy, orb.xy),
                                    (ldb.orb_class, orb.cls), (ldb.orb_valid, orb.valid)):
                    store[b, kf].copy_(rows)
            _put(self.fs, b, fs_b)
            _put(self.maps, b, m_b)
        self.keyframes_serviced += int(serviced.size)
        if not self.enable_loop:
            return kf_ids, None
        new_kf = torch.from_numpy(kf_ids.astype(np.int32)).to(dev)
        self.loopdb, found, loop_kf = batched_loop_detect(self.loopdb, desc, new_kf >= 0, new_kf,
                                                          cfg)
        detect = torch.stack([found.to(torch.int32), loop_kf], dim=1)
        if dev.type != "cuda":
            return kf_ids, (detect, None)
        host = torch.empty(detect.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(detect, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record()
        return kf_ids, (host, landed)

    # ------------------------------------------------------------------
    def _retire_beyond(self, depth: int) -> None:
        while len(self._inflight) > max(depth, 0):
            self._retire(self._inflight.pop(0))

    def _retire(self, entry: _Entry) -> None:
        c = entry.counts
        if entry.detect is not None:
            detect, landed = entry.detect
            with host_read(self.reads, "detect"):
                if landed is not None:
                    landed.synchronize()
                c[self.rows.start:self.rows.stop, 4:] = detect.numpy()
        self._last_counts = c
        self.alive &= c[:, 0] > self._bad
        if self.verify_loops:
            mine = c[self.rows.start:self.rows.stop]
            for b in np.nonzero(mine[:, 4] > 0)[0]:
                self._service_loop_event(int(b), int(mine[b, 3]), int(mine[b, 5]))

    def _loop_state(self, b: int) -> LoopState:
        """Sequence ``b``'s loop database as a single-sequence LoopState."""
        ldb = self.loopdb
        return LoopState(deep_db=ldb.deep_db[b], db_valid=ldb.db_valid[b],
                         orb_desc=ldb.orb_desc[b], orb_xy=ldb.orb_xy[b],
                         orb_class=ldb.orb_class[b], orb_valid=ldb.orb_valid[b],
                         last_closed_kf=ldb.last_closed[b])

    def _service_loop_event(self, b: int, kf_id: int, loop_kf: int) -> None:
        """Verify and correct a detected loop of this rank's sequence ``b``
        through the single-sequence stages (JAX ``_service_loop_event``)."""
        lc = self._lc
        lp_b = self._loop_state(b)
        verify, packed, m_b = lc._verify_impl(_take(self.maps, b), lp_b, kf_id, loop_kf)
        vp = packed.cpu().numpy()
        if not bool(vp[0]):
            # Not verified: the loop_with record stays for diagnostics.
            log.info("seq %d: loop candidate KF %d -> %d not verified: %d pairs, %d pose "
                     "inliers, pose_err %.2f m (odo %.1f m)", b, kf_id, loop_kf, vp[4], vp[5],
                     vp[2], vp[3])
            _put(self.maps, b, m_b)
            return
        if bool(vp[1]):
            m_b, _, remap, cpk = lc._correct_impl(m_b, lp_b, kf_id, loop_kf, verify.T_corrected,
                                                  verify.match_loop_feat)
            if not bool(cpk[0].item()):
                log.warning("multiseq loop correction ROLLED BACK (seq %d, KF %d -> %d)",
                            b, kf_id, loop_kf)
                _put(self.maps, b, m_b)
                return
            # The landmark merge reaches the live tracks, and links the
            # correction left grossly inconsistent are dropped.
            lm = self.fs.tracks.lm_idx[b]
            lm_row = torch.where(lm >= 0, remap[lm.clamp(min=0).long()], lm)
            tr_b = TrackState(xy=self.fs.tracks.xy[b], lm_idx=lm_row,
                              valid=self.fs.tracks.valid[b])
            tr_b, _ = post_correction_unlink(tr_b, self.fs.T_rk[b], self.fs.ref_kf[b], m_b,
                                             self.intr)
            self.fs.tracks.lm_idx[b].copy_(tr_b.lm_idx)
        _put(self.maps, b, m_b)
        self.loopdb.last_closed[b] = kf_id
        self.loop_closures[self.rows.start + b].append((kf_id, loop_kf))

    def drain(self) -> None:
        """Retire every in-flight step (call before reading state)."""
        self._retire_beyond(0)

    # ------------------------------------------------------------------
    def loop_edges(self, seq: int) -> List[Tuple[int, int]]:
        """Detected loop pairs [(kf_id, loop_kf), ...] of sequence ``seq``
        (drain first for exact results; with a mesh, one of ``self.rows``)."""
        b = self._local(seq)
        if self.loopdb is None:
            return []
        lw = self.loopdb.loop_with[b].cpu().numpy()
        return [(int(i), int(lw[i])) for i in np.nonzero(lw >= 0)[0]]

    def keyframe_trajectory(self, seq: int) -> Tuple[np.ndarray, np.ndarray]:
        """(kf_ids, positions (n, 3)) of sequence ``seq``'s keyframes (with
        a mesh, one of ``self.rows``)."""
        b = self._local(seq)
        n_kf = int(self.maps.n_kf[b])
        T = self.maps.kf_T_cw[b][:n_kf].cpu().numpy().astype(np.float64)
        pos = np.stack([np.linalg.inv(t)[:3, 3] for t in T]) if n_kf else np.zeros((0, 3))
        return np.arange(n_kf), pos
