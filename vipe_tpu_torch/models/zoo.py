"""Local weight registry (port of ``vipe_tpu/models/zoo.py``, as far as the
port's modules go): ``geocalib_pinhole|distorted``, ``unidepth_s|b|l``,
``dav2_vits|vitb|vitl``, ``vda_vits|vitl``, ``metric3d_small|large``,
``priorda`` (PriorDA's coarse DAv2), ``priorda_fine`` (its conditioned
DAv2) and TrackAnything's
``sam_vit_b|vit_l|vit_h``, ``gdino`` (Swin-T and BERT-base) and ``deaot``
(R50-DeAOT-L).

Weights are read from ``$VIPE_WEIGHTS_DIR`` (default
``~/.cache/vipe_weights``), nothing is downloaded.  Per family the first of
these files found is used:

* ``<family>.npz``: the JAX package's flax tree (keys '/'-joined),
  converted by this port's flax → torch converter;
* ``<family>.pth`` / ``.pt`` / ``.ckpt`` / ``.bin``: a ViPE state dict,
  loaded as is (``weights_only=True``).

No file → ``load_state_dict`` returns None and the model is random-initialised
from a seed (``load_net``); ``has_weights`` says whether a family has a
file.  A name outside these families raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import pathlib
from typing import Optional

import numpy as np
import torch

_EXTS = (".npz", ".pth", ".pt", ".ckpt", ".bin")
FAMILIES = ("geocalib_pinhole", "geocalib_distorted", "unidepth_s", "unidepth_b", "unidepth_l",
            "dav2_vits", "dav2_vitb", "dav2_vitl", "vda_vits", "vda_vitl", "metric3d_small",
            "metric3d_large", "priorda", "priorda_fine", "sam_vit_b", "sam_vit_l", "sam_vit_h",
            "gdino", "deaot")


def weights_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("VIPE_WEIGHTS_DIR",
                                       os.path.expanduser("~/.cache/vipe_weights")))


def _find(family: str) -> Optional[pathlib.Path]:
    d = weights_dir()
    for ext in _EXTS:
        p = d / f"{family}{ext}"
        if p.is_file():
            return p
    return None


def has_weights(family: str) -> bool:
    """Whether the weights directory holds a file for ``family``."""
    return _find(family) is not None


def _unflatten(flat) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def load_state_dict(family: str) -> Optional[dict]:
    """The port's state dict for ``family``, or None when no weight file is
    present."""
    if family not in FAMILIES:
        raise NotImplementedError(f"weight family {family!r} has no module in the port yet")
    path = _find(family)
    if path is None:
        return None
    if path.suffix == ".npz":
        from . import convert

        from_flax = {"unidepth": convert.unidepth_state_dict_from_flax,
                     "geocalib": convert.geocalib_state_dict_from_flax,
                     "dav2": convert.dav2_state_dict_from_flax,
                     "priorda": convert.dav2_state_dict_from_flax,
                     "vda": convert.vda_state_dict_from_flax,
                     "metric3d": convert.metric3d_state_dict_from_flax,
                     "sam": convert.sam_state_dict_from_flax,
                     "gdino": convert.gdino_state_dict_from_flax,
                     "deaot": convert.deaot_state_dict_from_flax}[family.split("_")[0]]
        with np.load(path) as z:
            return from_flax(_unflatten({k: z[k] for k in z.files}))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "model_state_dict", "module"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return {k.removeprefix("module."): v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_net(net: torch.nn.Module, state_dict=None, seed: int = 0,
             init=None) -> torch.nn.Module:
    """A net built on the meta device, on the CPU with ``state_dict`` (keys
    the net does not hold, such as DINOv2's mask token, dropped; every key
    it holds required) or, when None, random weights from ``init(net,
    seed)`` (default ``models.vit.init_seeded_``); frozen."""
    from .vit import init_seeded_

    net = net.to_empty(device="cpu")
    if state_dict is None:
        (init or init_seeded_)(net, seed)
    else:
        own = net.state_dict()
        net.load_state_dict({k: v for k, v in state_dict.items() if k in own}, strict=True)
    return net.eval().requires_grad_(False)
