"""DeAOT mask propagation (port of
``vipe_tpu/priors/track_anything/deaot/__init__.py``): ``add_reference``
stores a (frame, instance map) pair in the long- and short-term memories,
``propagate`` tracks the next frame from them.

ViPE runs R50-DeAOT-L with ``long_term_mem_gap`` 9999, so the long-term
memory grows only at reference (detection) frames, each new reference
prepended; the short-term memory is refreshed every tracked frame from the
frame's own prediction at the model's resolution (the arg-max of the
logits resized to the model input), except on detection frames, which
track without a memory update.  The long-term tokens are concatenated as
they are, with no padding and so no masked key.

Objects live in ``max_obj_num`` slots: instance ids map to slots in order of
appearance and ids past the last slot are dropped (one engine, as the JAX
package; the reference spawns another engine per 10 objects).  Frames are
resized on the device (uint8, as ``cv2.resize``), instance maps with
nearest-neighbour sampling (``cv2.INTER_NEAREST``); the net runs in f32
(TF32 off).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ....models import zoo
from ....ops.resize import resize_align_corners, resize_u8_linear
from ....utils import profiling
from ....utils.device import resolve_device, true_f32
from .network import DeAOTConfig, DeAOTNet, init_deaot_

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def build_deaot(cfg: Optional[DeAOTConfig] = None, state_dict=None, seed: int = 0,
                device="cpu") -> DeAOTNet:
    with torch.device("meta"):
        net = DeAOTNet(cfg)
    return zoo.load_net(net, state_dict, seed, init=init_deaot_).to(device)


def model_hw(h: int, w: int, max_long_edge: int):
    """The model grid of an (h, w) frame: the long side at most
    ``max_long_edge``, each side a multiple of 16."""
    s = min(1.0, max_long_edge / max(h, w))
    return max(16, int(round(h * s / 16)) * 16), max(16, int(round(w * s / 16)) * 16)


def resize_nearest(instance: np.ndarray, size_hw) -> np.ndarray:
    """An integer map resized as ``cv2.resize(..., INTER_NEAREST)``: output
    pixel i takes input floor(i · n_in / n_out)."""
    inst = np.asarray(instance)
    if inst.shape == tuple(size_hw):
        return inst.astype(np.int64)
    t = torch.as_tensor(inst.astype(np.float64))[None, None]
    return F.interpolate(t, size=tuple(size_hw), mode="nearest")[0, 0].numpy().astype(np.int64)


class DeAOTTracker:
    """``add_reference(rgb, instance)`` and ``propagate(rgb) -> instance``
    on one device.  ``state_dict`` None reads the zoo's ``deaot``, else
    seeded random weights."""

    def __init__(self, cfg: Optional[DeAOTConfig] = None, state_dict=None,
                 max_long_edge: int = 1040, seed: int = 0, device=None):
        self.cfg = cfg or DeAOTConfig()
        self.device = resolve_device(device)
        self.max_long_edge = max_long_edge
        if state_dict is None:
            state_dict = zoo.load_state_dict("deaot")
        self.net = build_deaot(self.cfg, state_dict, seed, self.device)
        # per layer: the reference frames' (K, V, ID_V) token blocks, newest
        # first, and their concatenation (made again after a new reference)
        self.long_memory: Optional[List[List[tuple]]] = None
        self._long_cat = None
        self.short_memory = None     # per layer (local_K, local_V, local_ID_V)
        self.id_to_slot: Dict[int, int] = {}
        self.slot_to_id: Dict[int, int] = {}

    # ------------------------------------------------------------ helpers

    def preprocess(self, rgb) -> torch.Tensor:
        """(1, 3, h1, w1) ImageNet-normalised frame on the model grid."""
        a = np.asarray(rgb)
        if a.dtype != np.uint8:
            a = np.clip(a * 255.0 if a.max() <= 1.5 else a, 0, 255).astype(np.uint8)
        h1, w1 = model_hw(*a.shape[:2], self.max_long_edge)
        x = torch.as_tensor(a, device=self.device).permute(2, 0, 1)[None]
        x = resize_u8_linear(x, (h1, w1)) / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=self.device)[:, None, None]
        return (x - mean) / std

    def slots(self, instance: np.ndarray, size_hw) -> torch.Tensor:
        """Instance ids → the (1, H, W) slot map on the device, giving new
        ids the free slots in order (ids past the last slot dropped)."""
        inst = resize_nearest(instance, size_hw)
        ids = np.unique(inst)
        free = iter(s for s in range(1, self.cfg.max_obj_num + 1) if s not in self.slot_to_id)
        for oid in ids:
            if oid == 0 or oid in self.id_to_slot:
                continue
            s = next(free, None)
            if s is None:
                continue
            self.id_to_slot[int(oid)] = s
            self.slot_to_id[s] = int(oid)
        lut = np.zeros(int(ids.max()) + 1 if len(ids) else 1, np.int64)
        for oid, s in self.id_to_slot.items():
            if oid < len(lut):
                lut[oid] = s
        return torch.as_tensor(lut[inst], device=self.device)[None]

    def _one_hot(self, slots: torch.Tensor) -> torch.Tensor:
        return F.one_hot(slots, self.cfg.max_obj_num + 1).permute(0, 3, 1, 2).float()

    def _slots_to_ids(self, slot_map: np.ndarray) -> np.ndarray:
        lut = np.zeros(self.cfg.max_obj_num + 1, np.int32)
        for s, oid in self.slot_to_id.items():
            lut[s] = oid
        return lut[slot_map]

    @staticmethod
    def _planes(tokens, h, w):
        return tuple(x.permute(1, 2, 0).reshape(x.shape[1], -1, h, w) for x in tokens)

    # ---------------------------------------------------------------- API

    def restart(self):
        self.long_memory = None
        self._long_cat = None
        self.short_memory = None
        self.id_to_slot.clear()
        self.slot_to_id.clear()

    def reference_memories(self, img, slots):
        """The reference step: per layer, the (K, V, ID_V) tokens of a frame
        matched with itself."""
        with torch.no_grad(), true_f32():
            enc = self.net.encode_image(img)
            h, w = enc[-1].shape[-2:]
            _, mems = self.net.lstt_forward(enc, None, self.net.get_id_emb(self._one_hot(slots)),
                                            (h, w))
        return [(m["global_K"], m["global_V"], m["global_ID_V"]) for m in mems], (h, w)

    def add_reference(self, rgb, instance: np.ndarray):
        img = self.preprocess(rgb)
        slots = self.slots(instance, img.shape[-2:])
        mems, (h, w) = self.reference_memories(img, slots)
        if self.long_memory is None:
            self.long_memory = [[m] for m in mems]
        else:
            for layer_mem, m in zip(self.long_memory, mems):
                layer_mem.insert(0, m)
        self.short_memory = [self._planes(m, h, w) for m in mems]
        self._long_cat = None

    def propagate_logits(self, img):
        """The propagation step on a preprocessed frame: its logits at 1/4 of
        the model grid and each layer's current (K, V, ID_V)."""
        if self._long_cat is None:
            self._long_cat = [tuple(torch.cat([m[j] for m in layer_mem]) for j in range(3))
                              for layer_mem in self.long_memory]
        memories = [dict(global_K=g[0], global_V=g[1], global_ID_V=g[2], local_K=s[0],
                         local_V=s[1], local_ID_V=s[2])
                    for g, s in zip(self._long_cat, self.short_memory)]
        with torch.no_grad(), true_f32():
            enc = self.net.encode_image(img)
            hw = tuple(enc[-1].shape[-2:])
            out, mems = self.net.lstt_forward(enc, memories, None, hw)
            logits = self.net.decode_logits(out, enc, hw)
        return logits, [(m["curr_K"], m["curr_V"], m["curr_ID_V"]) for m in mems], hw

    def short_memory_update(self, currs, slots, hw):
        """The short-term memory of a tracked frame from its slot map."""
        with torch.no_grad(), true_f32():
            id_emb = self.net.get_id_emb(self._one_hot(slots))
            return [self._planes((K, V, layer.fuse_key_value_id(IDV, id_emb)), *hw)
                    for layer, (K, V, IDV) in zip(self.net.LSTT.layers, currs)]

    def propagate(self, rgb, update_memory: bool = True) -> np.ndarray:
        """Track one frame: (H, W) int32 instance ids at the frame's size."""
        if self.long_memory is None:
            return np.zeros(np.asarray(rgb).shape[:2], np.int32)
        h0, w0 = np.asarray(rgb).shape[:2]
        with profiling.stage("ta_preprocess"):
            img = self.preprocess(rgb)
        with profiling.stage("ta_prop_dispatch"):
            logits, currs, hw = self.propagate_logits(img)
            slot_full = torch.argmax(resize_align_corners(logits, (h0, w0))[0], 0)
            if update_memory:
                slot_small = torch.argmax(resize_align_corners(logits, img.shape[-2:]), 1)
                self.short_memory = self.short_memory_update(currs, slot_small, hw)
        with profiling.stage("ta_readback"):
            slot_np = slot_full.cpu().numpy()
        return self._slots_to_ids(slot_np)
