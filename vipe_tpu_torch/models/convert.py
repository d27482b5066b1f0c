"""Flax → PyTorch weight conversion for DroidNet.

``droidnet_state_dict_from_flax`` is the inverse of
``vipe_tpu.models.convert.convert_droidnet``: it turns the JAX package's
param tree (given as numpy arrays) into this port's state dict, so both
packages can run the same weights.  Conv kernels go from flax
``(kh, kw, I, O)`` to torch ``(O, I, kh, kw)``.
"""

from __future__ import annotations

import numpy as np
import torch

# flax UpdateModule entry → torch module path
_UPDATE = {
    "corr_enc1": "update.corr_encoder.0",
    "corr_enc2": "update.corr_encoder.2",
    "flow_enc1": "update.flow_encoder.0",
    "flow_enc2": "update.flow_encoder.2",
    "weight1": "update.weight.0",
    "weight2": "update.weight.2",
    "delta1": "update.delta.0",
    "delta2": "update.delta.2",
}
_AGG = {"conv1": "update.agg.conv1", "conv2": "update.agg.conv2", "eta": "update.agg.eta.0"}
_GRU = ("convz", "convr", "convq", "w", "convz_glo", "convr_glo", "convq_glo")


def _put(sd: dict, key: str, entry: dict):
    k = np.asarray(entry["kernel"], np.float32)
    sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    sd[f"{key}.bias"] = torch.from_numpy(np.asarray(entry["bias"], np.float32).copy())


def _encoder(sd: dict, prefix: str, tree: dict):
    _put(sd, f"{prefix}.conv1", tree["conv1"])
    for stage in (1, 2, 3):
        for blk in (0, 1):
            t = tree[f"layer{stage}_{blk}"]
            p = f"{prefix}.layer{stage}.{blk}"
            _put(sd, f"{p}.conv1", t["conv1"])
            _put(sd, f"{p}.conv2", t["conv2"])
            if "downsample" in t:
                _put(sd, f"{p}.downsample.0", t["downsample"])
    _put(sd, f"{prefix}.conv2", tree["conv2"])


def droidnet_state_dict_from_flax(params) -> dict:
    """``{"params": {"fnet", "cnet", "update"}}`` (numpy leaves) → the
    port's ``DroidNet`` state dict (f32 tensors)."""
    p = params["params"] if "params" in params else params
    sd: dict = {}
    _encoder(sd, "fnet", p["fnet"])
    _encoder(sd, "cnet", p["cnet"])
    upd = p["update"]
    for name, key in _UPDATE.items():
        _put(sd, key, upd[name])
    for name in _GRU:
        _put(sd, f"update.gru.{name}", upd["gru"][name])
    for name, key in _AGG.items():
        _put(sd, key, upd["agg"][name])
    return sd
