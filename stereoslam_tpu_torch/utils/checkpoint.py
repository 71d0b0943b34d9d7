"""Map checkpoint / resume (port of ``stereoslam_tpu/utils/checkpoint.py``).

The whole SLAM state is a set of fixed-shape tensors, so a checkpoint is
complete: every keyframe, landmark, descriptor row, pose-graph edge and
frontend track survives a round trip.  The file is the JAX package's
``.npz`` layout, one flat array per state field (``frontend.*`` with
``frontend.tracks.*``, ``map.*``, ``loop.*``, and ``pyr.<i>`` for the
previous frame's LK pyramid), with the JAX package's dtypes: the port's int32
descriptor words are written as the uint32 words they hold and read back
through :mod:`stereoslam_tpu_torch.bridge`.  So a checkpoint of either
package loads into the other, field for field; a missing field raises
``KeyError``, as in the JAX package.  Arrays under other keys (the facade
adds ``facade.*``) ride along and are returned to the caller; the JAX
package ignores them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from stereoslam_tpu_torch import bridge
from stereoslam_tpu_torch.core.state import FrontendState, LoopState, MapState

_PREFIXES = ("frontend.", "map.", "loop.", "pyr.")


def _flatten(prefix: str, tree: dict, out: dict) -> dict:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flatten(f"{prefix}.{name}", leaf, out)
        else:
            out[f"{prefix}.{name}"] = leaf
    return out


def _unflatten(prefix: str, data: dict) -> dict:
    """The nested ``{field: array}`` dict under ``prefix`` (``tracks`` nests)."""
    out: dict = {}
    for key, arr in data.items():
        if key.startswith(prefix + "."):
            *parents, leaf = key[len(prefix) + 1:].split(".")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return out


def save_checkpoint(path: str, fs: FrontendState, map_state: MapState, loop: LoopState,
                    pyr: Optional[Sequence[torch.Tensor]] = None,
                    extra: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Write the full SLAM state to ``path`` (.npz archive).

    ``pyr`` (optional): the previous frame's LK pyramid, so tracking can
    continue seamlessly after resume.  ``extra``: more arrays to store under
    their own keys (outside the state's prefixes)."""
    data: dict = {}
    _flatten("frontend", bridge.frontend_state_to_numpy(fs), data)
    _flatten("map", bridge.map_state_to_numpy(map_state), data)
    loop_np = bridge.loop_state_to_numpy(loop)
    loop_np["orb_desc"] = loop_np["orb_desc"].view(np.uint32)
    _flatten("loop", loop_np, data)
    if pyr is not None:
        for i, lvl in enumerate(bridge.pyramid_to_numpy(pyr)):
            data[f"pyr.{i}"] = lvl
    for key, arr in (extra or {}).items():
        if key.startswith(_PREFIXES):
            raise ValueError(f"extra key {key!r} collides with the state layout")
        data[key] = np.asarray(arr)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **data)
    return path


def load_checkpoint(path: str, device=None) -> Tuple[FrontendState, MapState, LoopState,
                                                     Optional[Tuple[torch.Tensor, ...]],
                                                     Dict[str, np.ndarray]]:
    """Restore (frontend, map, loop, pyramid or None, extra arrays) from a
    checkpoint, onto ``device`` (the card unless the caller asks for
    ``"cpu"``)."""
    dev = torch.device(device or "cuda")
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    fs = bridge.frontend_state_from_numpy(_unflatten("frontend", data), dev)
    map_state = bridge.map_state_from_numpy(_unflatten("map", data), dev)
    loop = bridge.loop_state_from_numpy(_unflatten("loop", data), dev)
    pyr_keys = sorted((k for k in data if k.startswith("pyr.")), key=lambda k: int(k.split(".")[1]))
    pyr = bridge.pyramid_from_numpy([data[k] for k in pyr_keys], dev) if pyr_keys else None
    extra = {k: v for k, v in data.items() if not k.startswith(_PREFIXES)}
    return fs, map_state, loop, pyr, extra
