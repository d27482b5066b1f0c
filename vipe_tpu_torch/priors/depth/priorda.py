"""PriorDA: prompted depth completion (port of
``vipe_tpu/priors/depth/priorda.py``).

The projected SLAM map is a sparse metric prompt.  A Depth Anything v2 net
predicts a relative disparity; the coarse stage fits it to the prompt, a
global scale and shift (host, f64) and then, per pixel, a scale and shift
weighted by inverse distance over its K = 5 nearest prompt pixels
(``ops/knn.py`` and a closed-form 2×2 solve, f32 on the device).  The fine
stage (when its weights exist) runs a conditioned DAv2 on the image and a
3-channel condition [uncertainty, global-aligned disparity, completed
disparity], normalised by the prompt's depth range.  Everything runs in
f32, TF32 off, as the JAX package computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models import zoo
from ...ops.knn import knn
from ...ops.resize import resize_align_corners
from ...utils.device import resolve_device, true_f32
from .base import DepthEstimationModel, DepthType
from .dav2 import build_dav2_net, preprocess, variant_of


def global_scale_shift(pred, sparse, mask):
    """Least-squares (scale, shift) with scale·pred + shift ≈ sparse on the
    masked points, f64; (1, 0) with fewer than 2."""
    m = np.asarray(mask, bool)
    x = np.asarray(pred, np.float64)[m]
    y = np.asarray(sparse, np.float64)[m]
    if len(x) < 2:
        return 1.0, 0.0
    A = np.stack([x, np.ones_like(x)], -1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    return float(sol[0]), float(sol[1])


def knn_scale_shift_completion(pred_disp, sparse_disp, sparse_mask, K: int = 5) -> torch.Tensor:
    """Per pixel, the inverse-distance-weighted least-squares scale and
    shift of ``pred`` onto the prompt over its K nearest prompt pixels
    (image-plane L2), applied to its own prediction; prompt pixels keep
    their prompt value.  ``pred_disp``: (H, W) f32, a tensor (the work
    runs on its device) or numpy (on the CPU); ``sparse_disp``: (H, W)
    f32; ``sparse_mask``: (H, W) bool numpy.  Returns (H, W) f32."""
    device = pred_disp.device if torch.is_tensor(pred_disp) else "cpu"
    pred = torch.as_tensor(pred_disp, dtype=torch.float32, device=device)
    sparse = torch.as_tensor(sparse_disp, dtype=torch.float32, device=device)
    mask = np.asarray(sparse_mask, bool)
    mask_t = torch.as_tensor(mask, device=device)
    H, W = pred.shape

    vy, vx = np.nonzero(mask)
    if len(vy) < K:
        s, b = global_scale_shift(pred.cpu().numpy(), sparse.cpu().numpy(), mask)
        return torch.where(mask_t, sparse, pred * s + b)

    pts = torch.as_tensor(np.stack([vx, vy], -1), dtype=torch.float32, device=device)
    qy, qx = torch.meshgrid(torch.arange(H, device=device), torch.arange(W, device=device),
                            indexing="ij")
    queries = torch.stack([qx.reshape(-1), qy.reshape(-1)], -1).float()
    d2, idx = knn(queries, pts, K)  # (HW, K)

    vy_t = torch.as_tensor(vy, device=device)
    vx_t = torch.as_tensor(vx, device=device)
    sp_vals = sparse[vy_t, vx_t][idx]
    pr_vals = pred[vy_t, vx_t][idx]
    # a tiny jitter keeps the system regular when the neighbours share one value
    pr_vals = pr_vals + 1e-5 * torch.arange(1, K + 1, dtype=torch.float32, device=device)[None, :]

    w = 1.0 / torch.sqrt(torch.clamp(d2, min=1e-8))
    w = w / torch.sum(w, dim=1, keepdim=True)
    # the weighted 2×2 normal equations of each pixel
    a00 = torch.sum(w * pr_vals * pr_vals, 1)
    a01 = torch.sum(w * pr_vals, 1)
    a11 = torch.sum(w, 1)
    b0 = torch.sum(w * pr_vals * sp_vals, 1)
    b1 = torch.sum(w * sp_vals, 1)
    det = a00 * a11 - a01 * a01
    safe = torch.abs(det) > 1e-10
    den = torch.where(safe, det, 1.0)
    scale = torch.where(safe, (a11 * b0 - a01 * b1) / den, 1.0)
    shift = torch.where(safe, (-a01 * b0 + a00 * b1) / den, 0.0)

    out = (pred.reshape(-1) * scale + shift).reshape(H, W)
    return torch.where(mask_t, sparse, out)


def _depth2disp(depth):
    """Guarded reciprocal: 0 where the input is not positive."""
    return np.where(depth > 0, 1.0 / np.maximum(depth, 1e-8), 0.0)


class PriorDAModel(DepthEstimationModel):
    """Prompted completion.  ``coarse_only=False`` runs the conditioned
    refinement too.  ``state_dict`` / ``fine_state_dict`` None read the
    zoo's ``priorda`` / ``priorda_fine`` (the ViT size taken from the
    weights), else seeded random weights."""

    depth_type = DepthType.METRIC_DEPTH

    def __init__(self, variant: str = "vitb", input_size: int = 518, K: int = 5,
                 state_dict=None, coarse_only: bool = False, fine_state_dict=None,
                 fine_variant: str = "vitb", seed: int = 0, device=None):
        self.device = resolve_device(device)
        if state_dict is None:
            state_dict = zoo.load_state_dict("priorda")
        self.net = build_dav2_net(variant_of(state_dict, variant), state_dict, seed, self.device)
        self.coarse_only = coarse_only
        self.fine_net = None
        if not coarse_only:
            if fine_state_dict is None:
                fine_state_dict = zoo.load_state_dict("priorda_fine")
            self.fine_net = build_dav2_net(variant_of(fine_state_dict, fine_variant),
                                           fine_state_dict, seed, self.device, cond_dim=3)
        self.input_size = input_size
        self.K = K

    def _fine_inputs(self, rgb, global_disp, comp_disp, sparse_depth, sparse_mask):
        """The conditioned net's inputs for one frame: image (1, 3, nh, nw),
        condition (1, 3, nh, nw) on the device, and the prompt's depth
        minimum and range that un-normalise its output."""
        # uncertainty |completed − global| / global where global > 0, min-max normalised
        cal = global_disp > 0.0
        uctn = np.where(cal, np.abs(comp_disp - global_disp) / np.maximum(global_disp, 1e-8), 0.0)
        rng_u = uctn.max() - uctn.min()
        if rng_u > 0:
            uctn = (uctn - uctn.min()) / rng_u
        # depths normalised by the prompt's range
        vals = sparse_depth[sparse_mask]
        masked_min = float(vals.min())
        denom = float(vals.max() - vals.min()) or 1.0

        def norm_cond(disp):
            return _depth2disp((_depth2disp(disp) - masked_min) / denom)

        condition = np.stack([uctn, norm_cond(global_disp), norm_cond(comp_disp)],
                             axis=-1).astype(np.float32)
        img = preprocess(np.asarray(rgb, np.float32)[None], self.input_size, self.device)
        cond = torch.as_tensor(condition, device=self.device).permute(2, 0, 1)[None]
        return img, resize_align_corners(cond, tuple(img.shape[-2:])), masked_min, denom

    def _fine_forward_batch(self, imgs, conds, norms, out_hw):
        """One conditioned forward for the chunk, then each frame
        un-normalised by its own prompt range."""
        with true_f32():
            disp = self.fine_net(torch.cat(imgs), torch.cat(conds))
        disp = resize_align_corners(disp[:, None], tuple(out_hw))[:, 0].cpu().numpy()
        return [(_depth2disp(d) * denom + masked_min).astype(np.float32)
                for d, (masked_min, denom) in zip(disp, norms)]

    def _coarse_align(self, pred_disp: torch.Tensor, prompt_depth, out_hw):
        """Global, then KNN scale/shift of one frame's predicted disparity
        to its prompt → (coarse depth, NaN where the prompt has < 2 points;
        the fine stage's inputs or None)."""
        h, w = out_hw
        prompt = np.asarray(prompt_depth, np.float32)
        sparse_mask = prompt > 0
        sparse_disp = np.where(sparse_mask, 1.0 / np.maximum(prompt, 1e-6), 0.0)
        if sparse_mask.sum() < 2:
            return np.full((h, w), np.nan, np.float32), None
        mask_t = torch.as_tensor(sparse_mask, device=pred_disp.device)
        s, b = global_scale_shift(pred_disp[mask_t].cpu().numpy(), sparse_disp[sparse_mask],
                                  np.ones(int(sparse_mask.sum()), bool))
        global_disp = pred_disp * s + b
        completed = knn_scale_shift_completion(global_disp, sparse_disp, sparse_mask, self.K)
        completed = torch.clamp(completed, min=1e-4)
        coarse = (1.0 / completed).cpu().numpy()
        if self.coarse_only:
            return coarse, None
        return coarse, (global_disp.cpu().numpy(), completed.cpu().numpy(), prompt, sparse_mask)

    @torch.no_grad()
    def complete_batch(self, rgbs, prompt_depths):
        """rgbs: (H, W, 3) frames in [0, 1]; prompt_depths: (H, W) metric
        depths, 0 = empty → completed metric depths (H, W), NaN for a prompt
        of fewer than 2 points.  One stacked coarse forward for
        same-shaped frames (and one fine forward); the alignment is per
        frame.  Mixed shapes run one by one."""
        if len({np.asarray(r).shape for r in rgbs}) != 1:
            return [d for r, p in zip(rgbs, prompt_depths) for d in self.complete_batch([r], [p])]
        h, w = np.asarray(rgbs[0]).shape[:2]
        x = preprocess(np.stack([np.asarray(r, np.float32) for r in rgbs]), self.input_size,
                       self.device)
        with true_f32():
            pred = self.net(x)
        pred_disps = resize_align_corners(pred[:, None], (h, w))[:, 0]
        out: list = [None] * len(rgbs)
        fine_idx, fine_imgs, fine_conds, fine_norms = [], [], [], []
        for i, (rgb, prompt_depth) in enumerate(zip(rgbs, prompt_depths)):
            out[i], fine_args = self._coarse_align(pred_disps[i], prompt_depth, (h, w))
            if fine_args is not None:
                img, cond, mmin, den = self._fine_inputs(rgb, *fine_args)
                fine_idx.append(i)
                fine_imgs.append(img)
                fine_conds.append(cond)
                fine_norms.append((mmin, den))
        if fine_idx:
            refined = self._fine_forward_batch(fine_imgs, fine_conds, fine_norms, (h, w))
            for i, d in zip(fine_idx, refined):
                out[i] = d
        return out

    def estimate(self, inp):
        raise RuntimeError("PriorDA is a prompted completion model; call "
                           "complete_batch(rgbs, prompt_depths) with a projected SLAM-map prompt")
