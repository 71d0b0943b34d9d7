"""State carried between frameworks as numpy arrays.

The parity tests seed a torch step from exactly the state a JAX step saw:
``{k: np.asarray(v) for k, v in jax_state._asdict().items()}`` goes in, a
torch container comes out, and the ``*_to_numpy`` inverses go back.  Keys
are the JAX package's field names; a ``FrontendState``'s ``tracks`` entry is
itself such a dict (or the JAX ``TrackState``).  The main path does not use
this module.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from stereoslam_tpu_torch.config import SlamConfig
from stereoslam_tpu_torch.core.state import FrontendState, MapState, TrackState
from stereoslam_tpu_torch.ops.camera import Intrinsics


def _tensor(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(v, copy=True)).to(device)


def _fields(d: Any) -> Mapping[str, Any]:
    return d._asdict() if hasattr(d, "_asdict") else d


def frontend_state_from_numpy(d: Mapping[str, Any], device="cpu") -> FrontendState:
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


def map_state_from_numpy(d: Mapping[str, Any], device="cpu") -> MapState:
    d = _fields(d)
    return MapState(**{k: _tensor(d[k], device) for k in MapState._fields})


def map_state_to_numpy(m: MapState) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in m._asdict().items()}


def pyramid_from_numpy(levels: Sequence[Any], device="cpu") -> Tuple[torch.Tensor, ...]:
    return tuple(_tensor(lvl, device) for lvl in levels)


def pyramid_to_numpy(pyr: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    return tuple(lvl.cpu().numpy() for lvl in pyr)


def intrinsics_from_config(cfg: SlamConfig) -> Tuple[Intrinsics, Intrinsics]:
    """(left, right) intrinsics of a config's stereo camera."""
    cam = cfg.camera
    return (Intrinsics.create(cam.fx, cam.fy, cam.cx, cam.cy),
            Intrinsics.create(cam.fx_right, cam.fy_right, cam.cx_right, cam.cy_right))
