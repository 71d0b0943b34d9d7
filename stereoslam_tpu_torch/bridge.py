"""State and weights carried between frameworks as numpy arrays.

The parity tests seed a torch step from exactly the state a JAX step saw:
``{k: np.asarray(v) for k, v in jax_state._asdict().items()}`` goes in, a
torch container comes out on the ``device`` the caller names, and the
``*_to_numpy`` inverses go back.  Batched states (the multi-sequence mode:
every field with a leading B) load through the same functions;
:func:`stack_numpy` and :func:`unstack_numpy` build and split them per
sequence.  Keys are the JAX package's field names; a
``FrontendState``'s ``tracks`` entry is itself such a dict (or the JAX
``TrackState``).  The JAX package's uint32 descriptor words become the
port's int32 words by reinterpreting their bits (``.view``), never by a
cast.  The main path uses :func:`calc_params_from_flax`, to load the
shipped CALC weights, and checkpoints (``utils/checkpoint.py``) go through
the state converters; CALC training (``models/train_calc.py``) returns its
encoder through :func:`calc_params_to_flax` and takes a Flax init through
the encoder and decoder converters.  Pose graphs and BA problems cross the
same way, for the sharded solvers' tests.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core.state import FrontendState, LoopState, MapState, TrackState
from stereoslam_tpu_torch.ops.camera import Intrinsics


def _tensor(v, device) -> torch.Tensor:
    a = np.array(v, copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _fields(d: Any) -> Mapping[str, Any]:
    return d._asdict() if hasattr(d, "_asdict") else d


def frontend_state_from_numpy(d: Mapping[str, Any], device) -> FrontendState:
    d = _fields(d)
    tracks = _fields(d["tracks"])
    return FrontendState(
        tracks=TrackState(**{k: _tensor(tracks[k], device) for k in TrackState._fields}),
        **{k: _tensor(d[k], device) for k in FrontendState._fields if k != "tracks"},
    )


def frontend_state_to_numpy(fs: FrontendState) -> Dict[str, Any]:
    out: Dict[str, Any] = {k: v.cpu().numpy() for k, v in fs._asdict().items() if k != "tracks"}
    out["tracks"] = {k: v.cpu().numpy() for k, v in fs.tracks._asdict().items()}
    return out


def map_state_from_numpy(d: Mapping[str, Any], device) -> MapState:
    d = _fields(d)
    return MapState(**{k: _tensor(d[k], device) for k in MapState._fields})


def map_state_to_numpy(m: MapState) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in m._asdict().items()}


def loop_state_from_numpy(d: Mapping[str, Any], device) -> LoopState:
    d = _fields(d)
    return LoopState(**{k: _tensor(d[k], device) for k in LoopState._fields})


def loop_state_to_numpy(lp: LoopState) -> Dict[str, np.ndarray]:
    """``orb_desc`` comes back as the port's int32 words; ``.view(np.uint32)``
    gives the JAX package's words."""
    return {k: v.cpu().numpy() for k, v in lp._asdict().items()}


def pose_graph_from_numpy(d: Mapping[str, Any], device):
    """A JAX ``PoseGraph`` (or its numpy dict) -> the port's."""
    from stereoslam_tpu_torch.ops.pgo import PoseGraph

    d = _fields(d)
    return PoseGraph(**{k: _tensor(d[k], device) for k in PoseGraph._fields})


def pose_graph_to_numpy(graph) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in graph._asdict().items()}


def ba_problem_from_numpy(d: Mapping[str, Any], device):
    """A JAX ``BAProblem`` (or its numpy dict) -> the port's."""
    from stereoslam_tpu_torch.ops.schur import BAProblem

    d = _fields(d)
    return BAProblem(**{k: _tensor(d[k], device) for k in BAProblem._fields})


def ba_problem_to_numpy(prob) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in prob._asdict().items()}


def calc_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax ``CalcEncoder`` variables dict (``{"params": {"conv1":
    {"kernel", "bias"}, ...}}``, numpy or JAX leaves) -> the port's
    ``CalcEncoder`` state dict: HWIO kernels become OIHW, the (in, out) dense
    kernel becomes the (out, in) ``Linear`` weight; the flatten before it is
    NHWC in both."""
    p = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2", "conv3"):
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p[name]["kernel"], np.float32).transpose(3, 2, 0, 1)))
        out[f"{name}.bias"] = torch.from_numpy(np.asarray(p[name]["bias"], np.float32).copy())
    out["proj.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["proj"]["kernel"], np.float32).T))
    return out


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def calc_params_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`calc_params_from_flax`: a ``CalcEncoder`` state
    dict (any device) -> the Flax variables dict ``{"params": {...}}`` with
    float32 numpy leaves, which ``DescriptorModel``, ``save_params_npz`` and
    the JAX package all take."""
    p: Dict[str, Any] = {}
    for name in ("conv1", "conv2", "conv3"):
        p[name] = {"kernel": np.ascontiguousarray(
                       _numpy(state_dict[f"{name}.weight"]).astype(np.float32).transpose(2, 3, 1, 0)),
                   "bias": _numpy(state_dict[f"{name}.bias"]).astype(np.float32).copy()}
    p["proj"] = {"kernel": np.ascontiguousarray(_numpy(state_dict["proj.weight"]).astype(np.float32).T)}
    return {"params": p}


# The training head's two Dense layers, by the names Flax gives them.
_DECODER_LAYERS = (("Dense_0", "dense0"), ("Dense_1", "dense1"))


def decoder_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``train_calc._Decoder`` variables -> the port's
    ``_Decoder`` state dict: each (in, out) Dense kernel becomes the (out, in)
    ``Linear`` weight."""
    p = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}
    for flax_name, name in _DECODER_LAYERS:
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p[flax_name]["kernel"], np.float32).T))
        out[f"{name}.bias"] = torch.from_numpy(np.asarray(p[flax_name]["bias"], np.float32).copy())
    return out


def decoder_params_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`decoder_params_from_flax`, float32 numpy leaves."""
    return {"params": {flax_name: {
        "kernel": np.ascontiguousarray(_numpy(state_dict[f"{name}.weight"]).astype(np.float32).T),
        "bias": _numpy(state_dict[f"{name}.bias"]).astype(np.float32).copy()}
        for flax_name, name in _DECODER_LAYERS}}


def stack_numpy(trees: Sequence[Any]) -> Dict[str, Any]:
    """Per-sequence states (NamedTuples or nested dicts of arrays, one per
    sequence) -> one batched nested dict, each leaf stacked on a new
    leading dim.  The ``*_from_numpy`` loaders take it as it is: every
    field then carries the batch dim of the batched multi-sequence mode."""
    first = _fields(trees[0])
    return {k: (stack_numpy([_fields(t)[k] for t in trees])
                if hasattr(first[k], "_asdict") or isinstance(first[k], Mapping)
                else np.stack([np.asarray(_fields(t)[k]) for t in trees]))
            for k in first}


def unstack_numpy(tree: Any, b: int) -> Dict[str, Any]:
    """Sequence ``b`` of a batched state (NamedTuple or nested dict, numpy,
    JAX or torch leaves) as a nested dict of numpy arrays."""
    out = {}
    for k, v in _fields(tree).items():
        if v is None:
            out[k] = None
        elif hasattr(v, "_asdict") or isinstance(v, Mapping):
            out[k] = unstack_numpy(v, b)
        else:
            out[k] = (v[b].cpu().numpy() if isinstance(v, torch.Tensor) else np.array(v[b]))
    return out


def batch_loop_db_from_numpy(d: Mapping[str, Any], device):
    """A JAX ``BatchLoopDB`` (or its numpy dict) -> the port's; the uint32
    ORB words become int32 with the same bits; absent store fields stay None."""
    from stereoslam_tpu_torch.parallel.multiseq import BatchLoopDB

    d = _fields(d)
    return BatchLoopDB(**{k: None if d.get(k) is None else _tensor(d[k], device)
                          for k in BatchLoopDB._fields})


def batch_loop_db_to_numpy(ldb) -> Dict[str, Any]:
    """``orb_desc`` comes back as the port's int32 words."""
    return {k: None if v is None else v.cpu().numpy() for k, v in ldb._asdict().items()}


def pyramid_from_numpy(levels: Sequence[Any], device) -> Tuple[torch.Tensor, ...]:
    return tuple(_tensor(lvl, device) for lvl in levels)


def pyramid_to_numpy(pyr: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    return tuple(lvl.cpu().numpy() for lvl in pyr)


def intrinsics_from_config(cfg: SlamConfig) -> Tuple[Intrinsics, Intrinsics]:
    """(left, right) intrinsics of a config's stereo camera."""
    cam = cfg.camera
    return (Intrinsics.create(cam.fx, cam.fy, cam.cx, cam.cy),
            Intrinsics.create(cam.fx_right, cam.fy_right, cam.cx_right, cam.cy_right))
