"""Dense bundle adjustment (port of ``vipe_tpu/slam/ba.py``, single view).

One Gauss-Newton iteration assembles residuals and Jacobians for every
edge, eliminates the per-pixel disparities (a diagonal block) by a Schur
complement grouped per source frame, solves the reduced pose (+ shared
intrinsics) system with a dense f32 Cholesky and back-substitutes.

Jacobians come from ``torch.func.jacfwd`` (which vmaps over the tangent
basis) over the compact tangent ``[ξi(6), ξj(6), δd(1), δf(kf)]``, shared
by every edge and pixel: edge e's residual depends only on its own poses,
and pixel p's only on d_p, so one broadcast ("ones") tangent gives every
edge's and pixel's derivative at once.

Damping, weighting and retraction follow the JAX package (and the
reference's ``buffer.bundle_adjustment``): pose ``H += damping·diag + ep·I``;
disparity ``C += damping + disp_ep`` (+ ``alpha`` where a sensor prior
exists); intrinsics ``1e-6·diag + 1e-6·I``; retraction ``pose ← exp(dx)·pose``,
``disp += dx`` (steps > 10 rejected), shared focal ``+= df``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jacfwd

from ..ops import cameras as cam
from ..ops import lie

_PROJ_MIN_DEPTH = 0.1  # cameras.MIN_DEPTH: the valid-mask threshold of the terms


@dataclass(frozen=True)
class BAConfig:
    camera_type: cam.CameraType = cam.CameraType.PINHOLE
    ht: int = 48
    wd: int = 64
    intrinsics_factor: float = 8.0
    optimize_intrinsics: bool = False
    disp_ep: float = 1e-7
    alpha: float = 0.001          # disp_sens regularisation weight
    max_edges_per_frame: int = 24  # slot width M

    @property
    def kf(self) -> int:
        """Intrinsics dof: shared focal + distortion params."""
        if not self.optimize_intrinsics:
            return 0
        return 1 + self.camera_type.n_distortion


def build_edge_slots(ii, n_frames: int, max_edges_per_frame: int) -> np.ndarray:
    """Group edges by source frame into fixed-width slots: (N, M) edge
    indices, ``E`` marking an empty slot."""
    ii = np.asarray(ii)
    E = len(ii)
    M = max_edges_per_frame
    slot_edge = np.full((n_frames, M), E, dtype=np.int64)
    fill = np.zeros(n_frames, dtype=np.int64)
    for e, i in enumerate(ii):
        if i < 0 or i >= n_frames:
            continue
        if fill[i] >= M:
            raise ValueError(
                f"frame {i} has more than {M} outgoing edges; raise max_edges_per_frame"
            )
        slot_edge[i, fill[i]] = e
        fill[i] += 1
    return slot_edge


def _expand_intr_delta(cfg: BAConfig, intr, df):
    """Apply the intrinsics tangent (shared focal) to a full-res vector."""
    if cfg.kf == 0:
        return intr
    return torch.cat([intr[:2] + df[0], intr[2:]])


def edge_residuals_and_jacobians(cfg: BAConfig, poses, disps, intrinsics,
                                 target, ii, jj):
    """Per-edge residuals r (E, P, 2), valid (E, P) and Jacobians Ji, Jj
    (E, P, 2, 6), Jz (E, P, 2), Jf (E, P, 2, kf) or None."""
    cam.require_pinhole(cfg.camera_type)
    P = cfg.ht * cfg.wd
    dev = poses.device
    v, u = torch.meshgrid(
        torch.arange(cfg.ht, dtype=torch.float32, device=dev),
        torch.arange(cfg.wd, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    u = u.reshape(P)
    v = v.reshape(P)
    kf = cfg.kf
    ndof = 13 + kf

    def coords_of(pose_i, pose_j, disp_i, intr):
        """Edges (E, 7), (E, 7), (E, P) → coords (E, P, 2), valid (E, P)."""
        intr_s = cam.scaled_intrinsics(cfg.camera_type, intr, 1.0 / cfg.intrinsics_factor)
        Gij = lie.se3_mul(pose_j, lie.se3_inv(pose_i))[:, None, :]
        pts = cam.iproj_disp(cfg.camera_type, intr_s, u, v, disp_i)
        pjh = torch.cat(
            [lie.quat_rotate(Gij[..., 3:7], pts[..., :3]) + Gij[..., :3] * pts[..., 3:4],
             pts[..., 3:4]],
            dim=-1,
        )
        return cam.proj_points(cfg.camera_type, intr_s, pjh), pjh[..., 2] > _PROJ_MIN_DEPTH

    pose_i, pose_j, disp_i = poses[ii], poses[jj], disps[ii]

    def f(dx):
        # one tangent shared by every edge: edge e's coords depend only on
        # its own poses and disparities, so d coords[e] / d dx is edge e's
        # Jacobian (the ones-tangent trick, over edges as over pixels)
        p_i = lie.se3_retr(pose_i, dx[0:6])
        p_j = lie.se3_retr(pose_j, dx[6:12])
        intr = _expand_intr_delta(cfg, intrinsics, dx[13:13 + kf])
        return coords_of(p_i, p_j, disp_i + dx[12], intr)[0]

    coords0, valid = coords_of(pose_i, pose_j, disp_i, intrinsics)
    J = jacfwd(f)(torch.zeros(ndof, dtype=torch.float32, device=dev))  # (E, P, 2, ndof)
    r = coords0 - target
    Jf = J[..., 13:] if kf else None
    return r, valid, J[..., 0:6], J[..., 6:12], J[..., 12], Jf


def _seg(x, idx, n):
    """Segment sum of ``x`` rows by ``idx`` into ``n`` rows."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def _blk(Ja, w, Jb):
    """Σ_p,c Ja[e,p,c,i]·w[e,p,c]·Jb[e,p,c,j] → (E, a, b)."""
    E = Ja.shape[0]
    return torch.bmm((Ja * w[..., None]).reshape(E, -1, Ja.shape[-1]).transpose(1, 2),
                     Jb.reshape(E, -1, Jb.shape[-1]))


def assemble_system(cfg: BAConfig, poses, disps, intrinsics, target, weight,
                    ii, jj, edge_valid, slot_edge, pose_mask, disp_mask,
                    disp_damping, disp_sens, sens_mask, pose_damping, pose_ep):
    """Schur-reduced dense (6N + kf) system for one Gauss-Newton iteration.

    poses (N, 7), disps (N, P), intrinsics (D,), target/weight (E, P, 2),
    ii/jj/edge_valid (E,), slot_edge (N, M), pose_mask/disp_mask (N,),
    disp_damping/disp_sens (N, P), sens_mask (N,).  Returns (Hd, bd, aux)."""
    N, P = disps.shape
    E = ii.shape[0]
    M = slot_edge.shape[1]
    kf = cfg.kf
    dev = poses.device

    r, valid, Ji, Jj, Jz, Jf = edge_residuals_and_jacobians(
        cfg, poses, disps, intrinsics, target, ii, jj
    )
    w = weight * valid[..., None] * edge_valid[:, None, None]   # (E, P, 2)

    Bii = _blk(Ji, w, Ji)
    Bij = _blk(Ji, w, Jj)
    Bjj = _blk(Jj, w, Jj)
    wr = w * r
    vi = -torch.einsum("epci,epc->ei", Ji, wr)
    vj = -torch.einsum("epci,epc->ei", Jj, wr)
    wz = w * Jz
    Ei_blk = torch.einsum("epci,epc->eip", Ji, wz)  # (E, 6, P)
    Ej_blk = torch.einsum("epci,epc->eip", Jj, wz)
    C_edge = (Jz * wz).sum(-1)
    bz_edge = -(Jz * wr).sum(-1)
    if kf:
        Bff_e = _blk(Jf, w, Jf)
        Bfi_e = _blk(Jf, w, Ji)  # (E, kf, 6)
        Bfj_e = _blk(Jf, w, Jj)
        vf_e = -torch.einsum("epci,epc->ei", Jf, wr)
        Ef_blk = torch.einsum("epci,epc->eip", Jf, wz)

    # disparity diagonal, per source frame
    C = _seg(C_edge, ii, N) + disp_damping + cfg.disp_ep
    b_disp = _seg(bz_edge, ii, N)
    sensw = cfg.alpha * sens_mask[:, None]
    C = C + sensw
    b_disp = b_disp - sensw * (disps - disp_sens)
    Cinv = torch.where(disp_mask[:, None], 1.0 / C, torch.zeros_like(C))

    # per-frame Schur grouping: rows [own pose (6)] + M × [pose jj (6)] + [tail]
    Ei_sum = _seg(Ei_blk, ii, N)                                   # (N, 6, P)
    slot_valid = slot_edge < E
    Ej_pad = torch.cat([Ej_blk, torch.zeros((1, 6, P), device=dev)], 0)
    G_j = Ej_pad[torch.clamp(slot_edge, max=E)]                    # (N, M, 6, P)
    jj_slot = jj[torch.clamp(slot_edge, max=E - 1)]
    fvar = torch.cat(
        [torch.arange(N, device=dev)[:, None],
         torch.where(slot_valid, jj_slot, torch.full_like(jj_slot, N))],
        dim=1,
    )                                                              # (N, 1+M), N = trash
    R6 = (1 + M) * 6
    G = torch.cat([Ei_sum[:, None], G_j], dim=1).reshape(N, R6, P)
    if kf:
        G = torch.cat([G, _seg(Ef_blk, ii, N)], dim=1)            # (N, R6+kf, P)
    GC = G * Cinv[:, None, :]
    S = torch.bmm(GC, G.transpose(1, 2))                          # (N, R, R)
    b_schur_rows = torch.bmm(GC, b_disp[:, :, None])[..., 0]      # (N, R)

    # dense pose Hessian with a trash frame N
    NV = N + 1
    iiv = torch.where(edge_valid, ii, torch.full_like(ii, N))
    jjv = torch.where(edge_valid, jj, torch.full_like(jj, N))
    pair_idx = torch.cat([iiv * NV + iiv, iiv * NV + jjv, jjv * NV + iiv, jjv * NV + jjv])
    pair_blk = torch.cat([Bii, Bij, Bij.transpose(1, 2), Bjj]).reshape(4 * E, 36)
    H_pose = _seg(pair_blk, pair_idx, NV * NV).reshape(NV, NV, 6, 6)
    Spp = S[:, :R6, :R6].reshape(N, 1 + M, 6, 1 + M, 6).permute(0, 1, 3, 2, 4)
    corr_idx = (fvar[:, :, None] * NV + fvar[:, None, :]).reshape(-1)
    H_pose = H_pose - _seg(Spp.reshape(-1, 36), corr_idx, NV * NV).reshape(NV, NV, 6, 6)

    b_pose = _seg(torch.cat([vi, vj]), torch.cat([iiv, jjv]), NV)
    b_pose = b_pose - _seg(b_schur_rows[:, :R6].reshape(N * (1 + M), 6), fvar.reshape(-1), NV)

    ev = edge_valid.float()
    if kf:
        H_ff = (Bff_e * ev[:, None, None]).sum(0) - S[:, R6:, R6:].sum(0)
        Hpf_direct = _seg(
            torch.cat([Bfi_e.transpose(1, 2), Bfj_e.transpose(1, 2)]),
            torch.cat([iiv, jjv]), NV,
        )                                                          # (NV, 6, kf)
        Spf = S[:, :R6, R6:].reshape(N * (1 + M), 6, kf)
        H_pf = Hpf_direct - _seg(Spf, fvar.reshape(-1), NV)
        b_f = (vf_e * ev[:, None]).sum(0) - b_schur_rows[:, R6:].sum(0)
        eye_f = torch.eye(kf, device=dev)
        H_ff = H_ff + 1e-6 * torch.diag(torch.diagonal(H_ff)) + 1e-6 * eye_f

    # damping + fixing
    eye6 = torch.eye(6, device=dev)
    Hp = H_pose[:N, :N]
    ar = torch.arange(N, device=dev)
    diag_blocks = Hp[ar, ar]
    Hp = Hp.clone()
    Hp[ar, ar] = diag_blocks + pose_damping * diag_blocks * eye6 + pose_ep * eye6
    pm = pose_mask.float()
    Hp = Hp * pm[:, None, None, None] * pm[None, :, None, None]
    Hp[ar, ar] = Hp[ar, ar] + eye6 * (1.0 - pm)[:, None, None]

    D = 6 * N + kf
    Hd = torch.zeros((D, D), device=dev)
    Hd[: 6 * N, : 6 * N] = Hp.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    bd = torch.zeros((D,), device=dev)
    bd[: 6 * N] = (b_pose[:N] * pm[:, None]).reshape(-1)
    if kf:
        Hpf_m = (H_pf[:N] * pm[:, None, None]).reshape(6 * N, kf)
        Hd[: 6 * N, 6 * N:] = Hpf_m
        Hd[6 * N:, : 6 * N] = Hpf_m.T
        Hd[6 * N:, 6 * N:] = H_ff
        bd[6 * N:] = b_f
    aux = dict(Cinv=Cinv, b_disp=b_disp, G=G, fvar=fvar, pm=pm, w=w, r=r)
    return Hd, bd, aux


def ba_iteration(cfg: BAConfig, poses, disps, intrinsics, target, weight,
                 ii, jj, edge_valid, slot_edge, pose_mask, disp_mask,
                 disp_damping, disp_sens, sens_mask,
                 pose_damping=1e-3, pose_ep=0.1):
    """One Gauss-Newton iteration: assemble, solve, back-substitute, retract.
    Returns (poses, disps, intrinsics)."""
    N, P = disps.shape
    M = slot_edge.shape[1]
    R6 = (1 + M) * 6
    kf = cfg.kf
    Hd, bd, aux = assemble_system(
        cfg, poses, disps, intrinsics, target, weight, ii, jj, edge_valid,
        slot_edge, pose_mask, disp_mask, disp_damping, disp_sens, sens_mask,
        pose_damping, pose_ep,
    )
    D = Hd.shape[0]
    # symmetrise: accumulation order leaves ~1e-5 relative asymmetry in f32
    Hd = 0.5 * (Hd + Hd.T) + 1e-8 * torch.eye(D, device=Hd.device)
    L, info = torch.linalg.cholesky_ex(Hd)
    dx = torch.cholesky_solve(bd[:, None], L)[:, 0]
    # a failed factorisation yields NaN steps (JAX's cho_factor), never raises
    dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))

    pm = aux["pm"]
    dx_pose = dx[: 6 * N].reshape(N, 6) * pm[:, None]
    dx_f = dx[6 * N:]

    # back-substitute disparities
    dx_pose_pad = torch.cat([dx_pose, torch.zeros((1, 6), device=dx.device)], 0)
    dx_rows = dx_pose_pad[aux["fvar"]].reshape(N, R6)
    if kf:
        dx_rows = torch.cat([dx_rows, dx_f.expand(N, kf)], dim=1)
    G = aux["G"]
    dx_disp = aux["Cinv"] * (aux["b_disp"] - torch.bmm(dx_rows[:, None, :], G)[:, 0])

    poses_new = torch.where(pose_mask[:, None], lie.se3_retr(poses, dx_pose), poses)
    dx_disp = torch.where(dx_disp > 10.0, torch.zeros_like(dx_disp), dx_disp)
    disps_new = disps + torch.where(disp_mask[:, None], dx_disp, torch.zeros_like(dx_disp))
    intr_new = intrinsics
    if kf:
        intr_new = torch.cat([intrinsics[:2] + dx_f[0], intrinsics[2:]])
    return poses_new, disps_new, intr_new


def ba_solve(cfg: BAConfig, poses, disps, intrinsics, target, weight, ii, jj,
             edge_valid, slot_edge, pose_mask, disp_mask, disp_damping,
             disp_sens, sens_mask, n_iters: int, pose_damping, pose_ep):
    """``n_iters`` Gauss-Newton iterations, then the final ``disp ≥ 0.001``
    clamp.  Returns (poses, disps, intrinsics)."""
    for _ in range(n_iters):
        poses, disps, intrinsics = ba_iteration(
            cfg, poses, disps, intrinsics, target, weight, ii, jj, edge_valid,
            slot_edge, pose_mask, disp_mask, disp_damping, disp_sens,
            sens_mask, pose_damping, pose_ep,
        )
    return poses, torch.clamp(disps, min=0.001), intrinsics
