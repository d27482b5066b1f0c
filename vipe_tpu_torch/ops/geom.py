"""Dense projective geometry over the keyframe graph (port of
``vipe_tpu/ops/geom.py``).

Conventions (same as the JAX package):
  * ``poses``: (N, 7) SE3 world-to-camera;
  * ``disps``: (N, H, W) disparity at the 1/8-res SLAM grid;
  * edges ``ii, jj``: (E,) frame indices; ``Gij = poses[jj] ∘ poses[ii]⁻¹``;
  * homogeneous points ``[X, Y, Z, d]`` (see ``ops.cameras``).
"""

from __future__ import annotations

import torch

from . import cameras as cam
from . import lie

MIN_DEPTH = 0.25


def pixel_grid(ht: int, wd: int, dtype=torch.float32, device=None):
    """(H, W) u and v coordinate fields (u = x = column)."""
    v, u = torch.meshgrid(
        torch.arange(ht, dtype=dtype, device=device),
        torch.arange(wd, dtype=dtype, device=device),
        indexing="ij",
    )
    return u, v


def coords_grid(ht: int, wd: int, device=None):
    """(H, W, 2) pixel-centre ``(u, v)`` grid."""
    u, v = pixel_grid(ht, wd, device=device)
    return torch.stack([u, v], dim=-1)


def act_homog(X, pts):
    """SE3 action on homogeneous ``[X, Y, Z, d]`` points: ``[R p + t d, d]``."""
    p = pts[..., :3]
    d = pts[..., 3:4]
    return torch.cat([lie.quat_rotate(X[..., 3:7], p) + X[..., :3] * d, d], dim=-1)


def iproj_i_proj_j_disp(Gij, disps_i, intrinsics_i, intrinsics_j,
                        camera_type: cam.CameraType):
    """Pixels of frame i → coords in frame j over the full grid.

    ``Gij`` (E, 7); ``disps_i`` (E, H, W); intrinsics (E, D).
    Returns coords (E, H, W, 2) and valid (E, H, W): target depth above
    ``MIN_DEPTH``, or for the panorama, which sees every direction, target
    range above it (``|xyz| > MIN_DEPTH·d`` in homogeneous form)."""
    u, v = pixel_grid(disps_i.shape[-2], disps_i.shape[-1], disps_i.dtype,
                      disps_i.device)
    pts_i = cam.iproj_disp(camera_type, intrinsics_i, u, v, disps_i)
    pts_j = act_homog(Gij[:, None, None, :], pts_i)
    coords = cam.proj_points(camera_type, intrinsics_j, pts_j)
    if camera_type == cam.CameraType.PANORAMA:
        return coords, torch.linalg.norm(pts_j[..., :3], dim=-1) > MIN_DEPTH * pts_j[..., 3]
    return coords, pts_j[..., 2] > MIN_DEPTH


def reproject(poses, disps, intrinsics, camera_type, ii, jj):
    """Reproject the dense grid of every edge.  ``intrinsics``: (D,) shared
    or (N, D) per frame.  Returns coords (E, H, W, 2) and valid (E, H, W)."""
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    intr = (intrinsics.expand(poses.shape[0], intrinsics.shape[-1])
            if intrinsics.dim() == 1 else intrinsics)
    return iproj_i_proj_j_disp(Gij, disps[ii], intr[ii], intr[jj], camera_type)


def reproject_mv(poses, rig, disps, intrinsics, camera_type, pi, qi, di, pj, qj):
    """Rig reprojection: the pixels of (frame ``pi``, view ``qi``), at the
    disparities of slot ``di``, → coords in (frame ``pj``, view ``qj``),
    through ``rig_qj⁻¹·T_pj·T_pi⁻¹·rig_qi``.  poses (N, 7), rig (V, 7),
    disps (N·V, H, W) slot-flattened (frame·V + view), intrinsics (V, D).
    Returns coords (E, H, W, 2) and valid (E, H, W)."""
    Gij = lie.se3_mul(lie.se3_inv(rig[qj]),
                      lie.se3_mul(poses[pj], lie.se3_mul(lie.se3_inv(poses[pi]), rig[qi])))
    return iproj_i_proj_j_disp(Gij, disps[di], intrinsics[qi], intrinsics[qj], camera_type)


def induced_flow(poses, disps, intrinsics, camera_type, ii, jj):
    """Flow field + validity induced by geometry (coords − grid)."""
    coords, valid = reproject(poses, disps, intrinsics, camera_type, ii, jj)
    ht, wd = disps.shape[-2:]
    return coords - coords_grid(ht, wd, disps.device), valid


def frame_distance(poses, disps, intrinsics, ii, jj, di=None,
                   beta: float = 0.3):
    """Mean induced optical flow between frame pairs (one direction per
    edge, i→j with the disparity of frame ``di``, default ``ii``).

    Weighted sum of the full-SE3 flow (``beta``) and the translation-only
    flow (``1 − beta``) over pixels whose transformed depth exceeds
    ``MIN_DEPTH``; saturates at 1000 when fewer than 75 % are valid.
    ``intrinsics``: (4,) or (N, 4) pinhole-equivalent, at grid scale (a
    distorted or panoramic camera goes in as its ``pinhole_equivalent``)."""
    intr = (intrinsics[:4].expand(poses.shape[0], 4)
            if intrinsics.dim() == 1 else intrinsics[..., :4])
    if di is None:
        di = ii
    return _frame_distance_impl(poses[ii], poses[jj], disps[di], intr[ii], intr[jj], beta)


def frame_distance_mv(poses, rig, disps, intrinsics, pi, qi, di, pj, qj,
                      beta: float = 0.3):
    """``frame_distance`` over expanded (frame, view) edges of a rig: each
    view's camera pose is ``rig[q]⁻¹·poses[p]``.  ``intrinsics``: (4,) or
    (V, 4) pinhole-equivalent at grid scale."""
    V = rig.shape[0]
    intr = (intrinsics[:4].expand(V, 4) if intrinsics.dim() == 1 else intrinsics[..., :4])
    pose_i = lie.se3_mul(lie.se3_inv(rig[qi]), poses[pi])
    pose_j = lie.se3_mul(lie.se3_inv(rig[qj]), poses[pj])
    return _frame_distance_impl(pose_i, pose_j, disps[di], intr[qi], intr[qj], beta)


def _frame_distance_impl(pose_i, pose_j, disp, intr_i, intr_j, beta: float):
    """Per-edge poses (E, 7), disparities (E, h, w), intrinsics (E, 4)."""
    ht, wd = disp.shape[-2:]
    u, v = pixel_grid(ht, wd, disp.dtype, disp.device)
    Gij = lie.se3_mul(pose_j, lie.se3_inv(pose_i))       # (E, 7)
    fx, fy, cx, cy = (t[:, None, None] for t in intr_i.unbind(-1))
    fxj, fyj, cxj, cyj = (t[:, None, None] for t in intr_j.unbind(-1))
    X = (u - cx) / fx
    Y = (v - cy) / fy
    X, Y = torch.broadcast_tensors(X, Y)
    pts = torch.stack([X, Y, torch.ones_like(disp), disp], dim=-1)

    def flow_mag(pts_j):
        z = pts_j[..., 2]
        safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
        du = fxj * pts_j[..., 0] / safe_z + cxj - u
        dv = fyj * pts_j[..., 1] / safe_z + cyj - v
        return torch.sqrt(du * du + dv * dv), z > MIN_DEPTH

    d_full, ok_full = flow_mag(act_homog(Gij[:, None, None, :], pts))
    tij = Gij[:, None, None, :3]
    pts_trans = torch.cat([pts[..., :3] + pts[..., 3:4] * tij, pts[..., 3:4]],
                          dim=-1)
    d_tr, ok_tr = flow_mag(pts_trans)
    zero = torch.zeros_like(d_full)
    accum = beta * torch.where(ok_full, d_full, zero).sum((1, 2)) + (
        1 - beta
    ) * torch.where(ok_tr, d_tr, zero).sum((1, 2))
    valid = beta * ok_full.sum((1, 2)) + (1 - beta) * ok_tr.sum((1, 2))
    total = float(ht * wd)
    return torch.where(
        valid / (total + 1e-8) < 0.75,
        torch.full_like(accum, 1000.0),
        accum / torch.clamp(valid, min=1e-8),
    )


def bilinear_sample(img, coords):
    """Bilinear sample ``img`` (H, W[, C]) at ``coords`` (..., 2) in (u, v).
    Out-of-range coords clamp to the border."""
    ht, wd = img.shape[0], img.shape[1]
    u = coords[..., 0]
    v = coords[..., 1]
    u0 = torch.clamp(torch.floor(u), 0, wd - 2)
    v0 = torch.clamp(torch.floor(v), 0, ht - 2)
    wu = torch.clamp(u - u0, 0.0, 1.0)
    wv = torch.clamp(v - v0, 0.0, 1.0)
    u0 = u0.long()
    v0 = v0.long()
    if img.dim() == 3:
        wu = wu[..., None]
        wv = wv[..., None]
    g00 = img[v0, u0]
    g01 = img[v0, u0 + 1]
    g10 = img[v0 + 1, u0]
    g11 = img[v0 + 1, u0 + 1]
    return (1 - wv) * ((1 - wu) * g00 + wu * g01) + wv * (
        (1 - wu) * g10 + wu * g11
    )


def depth_filter(poses, disps, intrinsics, inds, thresh):
    """Multi-view depth consistency counter: for each frame ``inds[b]`` and
    each of its 6 temporal neighbours (±1, ±2, ±3), reproject every pixel and
    count +1 if ANY of the 4 integer-corner disparities of the neighbour
    agrees in depth within ``thresh[b]``.  Neighbours outside ``[0, N)`` do
    not count.  ``intrinsics``: (4,) pinhole at grid scale.
    Returns (B, H, W) float32."""
    num, ht, wd = disps.shape
    fx, fy, cx, cy = intrinsics[:4].unbind(-1)
    u, v = pixel_grid(ht, wd, disps.dtype, disps.device)
    offsets = torch.tensor([-1, -2, -3, 1, 2, 3], device=disps.device)
    ix = inds[:, None].expand(-1, 6).reshape(-1)          # (B·6,)
    jx = (inds[:, None] + offsets).reshape(-1)
    t = thresh[:, None].expand(-1, 6).reshape(-1, 1, 1)
    ok_frame = ((jx >= 0) & (jx < num))[:, None, None]
    jx_c = torch.clamp(jx, 0, num - 1)
    Gij = lie.se3_mul(poses[jx_c], lie.se3_inv(poses[ix]))
    di = disps[ix]
    X = (u - cx) / fx
    Y = (v - cy) / fy
    X, Y, di_b = torch.broadcast_tensors(X, Y, di)
    pts = torch.stack([X, Y, torch.ones_like(di_b), di_b], dim=-1)
    pj = act_homog(Gij[:, None, None, :], pts)
    z = pj[..., 2]
    safe_z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    uj = fx * pj[..., 0] / safe_z + cx
    vj = fy * pj[..., 1] / safe_z + cy
    dj = pj[..., 3] / safe_z
    u0 = torch.floor(uj)
    v0 = torch.floor(vj)
    inb = (u0 >= 0) & (v0 >= 0) & (u0 < wd - 1) & (v0 < ht - 1)
    u0c = torch.clamp(u0, 0, wd - 2).long()
    v0c = torch.clamp(v0, 0, ht - 2).long()
    dn = disps[jx_c].reshape(len(jx_c), -1)
    depth_proj = 1.0 / torch.where(dj.abs() < 1e-8, torch.full_like(dj, 1e-8), dj)
    agree = torch.zeros_like(inb)
    for dv_, du_ in ((0, 0), (0, 1), (1, 0), (1, 1)):
        flat = ((v0c + dv_) * wd + (u0c + du_)).reshape(len(jx_c), -1)
        dnk = torch.gather(dn, 1, flat).reshape(dj.shape)
        depth_n = 1.0 / torch.clamp(dnk, min=1e-8)
        agree = agree | ((depth_proj - depth_n).abs() < t)
    count = (inb & agree & ok_frame).to(torch.float32)
    return count.reshape(len(inds), 6, ht, wd).sum(1)
