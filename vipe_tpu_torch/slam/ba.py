"""Dense bundle adjustment (port of ``vipe_tpu/slam/ba.py``).

One Gauss-Newton iteration assembles residuals and Jacobians for every
edge, eliminates the per-pixel disparities (a diagonal block) by a Schur
complement grouped per source disparity variable, solves the reduced pose
(+ shared intrinsics, + rig) system with a dense f32 Cholesky and
back-substitutes.

A V-view rig (``ba_solve_mv``) runs the full chain
``proj[rig_qj⁻¹·T_pj·T_pi⁻¹·rig_qi·iproj(d_di, K_qi), K_qj]`` over edges
expanded per (frame, view): poses are per frame, disparities per
(frame, view) slot ``di = frame·V + view``, intrinsics per view, with the
focal step shared by every view.  ``optimize_rig`` adds the rig's 6V
columns to the global tail: view 0 held fixed, rotation-only retraction.
The single-view entry ``ba_solve`` runs the chain without a rig.

Jacobians come from ``torch.func.jacfwd`` (which vmaps over the tangent
basis) over the compact tangent ``[ξi(6), ξj(6), δd(1), δf(kf)]``, shared
by every edge and pixel: edge e's residual depends only on its own poses,
and pixel p's only on d_p, so one broadcast ("ones") tangent gives every
edge's and pixel's derivative at once.

Damping, weighting and retraction follow the JAX package (and the
reference's ``buffer.bundle_adjustment``): pose ``H += damping·diag + ep·I``;
disparity ``C += damping + disp_ep`` (+ ``alpha`` where a sensor prior
exists); intrinsics ``1e-6·diag + 1e-6·I``; retraction ``pose ← exp(dx)·pose``,
``disp += dx`` (steps > 10 rejected), shared focal ``+= df``, MEI's
distortion ``k1 += 0.01·dk``.  The camera model enters only through
``cameras.iproj_disp``/``proj_points``, which ``jacfwd`` differentiates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jacfwd

from ..ops import cameras as cam
from ..ops import lie
from ..ops.segment import segment_sum

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
    n_views: int = 1              # rig views V; disparity variables per (frame, view)
    optimize_rig: bool = False    # the rig's rotation group (view 0 fixed)

    @property
    def kf(self) -> int:
        """Intrinsics dof: shared focal + distortion params."""
        if not self.optimize_intrinsics:
            return 0
        return 1 + self.camera_type.n_distortion

    @property
    def kr(self) -> int:
        """Rig dof in the global tail: 6 per view (the translation steps
        are dropped at the retraction)."""
        return 6 * self.n_views if self.optimize_rig else 0

    @property
    def kt(self) -> int:
        """Global tail size: intrinsics, then rig."""
        return self.kf + self.kr


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
    """Apply the intrinsics tangent ``[d focal, d distortion...]`` to
    full-res (..., D) intrinsics."""
    if cfg.kf == 0:
        return intr
    return torch.cat([intr[..., :2] + df[0], intr[..., 2:4], intr[..., 4:] + df[1:]], dim=-1)


def edge_residuals_and_jacobians(cfg: BAConfig, poses, disps, intrinsics,
                                 target, ii, jj, rig=None, qi=None, di=None, qj=None):
    """Per-edge residuals r (E, P, 2), valid (E, P) and Jacobians Ji, Jj
    (E, P, 2, 6), Jz (E, P, 2), Jt (E, P, 2, kt) or None.

    Single view (``rig`` None): ``ii``/``jj`` index the frames and the
    disparities, ``intrinsics`` is (D,).  A rig gives ``rig`` (V, 7), the
    source and target views ``qi``/``qj``, the source slots ``di`` of the
    (N·V, P) disparities and (V, D) intrinsics; ``Jt`` then holds the
    intrinsics columns and the rig columns of views ``qi``/``qj``."""
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
    kr_edge = 12 if cfg.kr else 0  # [ξ rig_qi, ξ rig_qj] per edge
    ndof = 13 + kf + kr_edge

    def coords_of(pose_i, pose_j, disp_i, intr_i, intr_j, u, v, rig_i=None, rig_j=None):
        """Edges (E, 7), (E, 7), (E, P) → coords (E, P, 2), valid (E, P)."""
        scale = 1.0 / cfg.intrinsics_factor
        intr_si = cam.scaled_intrinsics(cfg.camera_type, intr_i, scale)
        intr_sj = intr_si if intr_j is None else cam.scaled_intrinsics(
            cfg.camera_type, intr_j, scale)
        if rig_i is None:
            Gij = lie.se3_mul(pose_j, lie.se3_inv(pose_i))
        else:
            Gij = lie.se3_mul(lie.se3_inv(rig_j),
                              lie.se3_mul(pose_j, lie.se3_mul(lie.se3_inv(pose_i), rig_i)))
        Gij = Gij[:, None, :]
        pts = cam.iproj_disp(cfg.camera_type, intr_si, u, v, disp_i)
        pjh = torch.cat(
            [lie.quat_rotate(Gij[..., 3:7], pts[..., :3]) + Gij[..., :3] * pts[..., 3:4],
             pts[..., 3:4]],
            dim=-1,
        )
        return cam.proj_points(cfg.camera_type, intr_sj, pjh), pjh[..., 2] > _PROJ_MIN_DEPTH

    pose_i, pose_j = poses[ii], poses[jj]
    if rig is None:
        disp_i = disps[ii]
        edge = (intrinsics, None)
    else:
        disp_i = disps[di]
        edge = (intrinsics[qi], intrinsics[qj], rig[qi], rig[qj])

    def f(dx):
        # one tangent shared by every edge: edge e's coords depend only on
        # its own poses and disparities, so d coords[e] / d dx is edge e's
        # Jacobian (the ones-tangent trick, over edges as over pixels)
        # operations that mix a dual tensor with a plain tensor or a python
        # number take a slow path under forward-mode AD; a dual zero added
        # to the plain inputs keeps the whole chain dual
        z = dx[0] - dx[0]
        p_i = _retr_linear(pose_i + z, dx[0:6])
        p_j = _retr_linear(pose_j + z, dx[6:12])
        df = dx[13:13 + kf]
        intr_i = _expand_intr_delta(cfg, edge[0] + z, df)
        if rig is None:
            return coords_of(p_i, p_j, disp_i + dx[12], intr_i, None, u + z, v + z)[0]
        intr_j = _expand_intr_delta(cfg, edge[1] + z, df)
        r_i, r_j = edge[2] + z, edge[3] + z
        if kr_edge:
            r_i = _retr_linear(r_i, dx[13 + kf:19 + kf])
            r_j = _retr_linear(r_j, dx[19 + kf:25 + kf])
        return coords_of(p_i, p_j, disp_i + dx[12], intr_i, intr_j, u + z, v + z, r_i, r_j)[0]

    coords0, valid = coords_of(pose_i, pose_j, disp_i, *edge[:2], u, v, *edge[2:])
    J = jacfwd(f)(torch.zeros(ndof, dtype=torch.float32, device=dev))  # (E, P, 2, ndof)
    r = coords0 - target
    Jt = J[..., 13:13 + kf] if kf else None
    if kr_edge:
        # the rig columns of each edge land in its views' 6-column blocks
        oh_i = torch.nn.functional.one_hot(qi, cfg.n_views).float()
        oh_j = torch.nn.functional.one_hot(qj, cfg.n_views).float()
        Jr = (torch.einsum("epcd,ev->epcvd", J[..., 13 + kf:19 + kf], oh_i)
              + torch.einsum("epcd,ev->epcvd", J[..., 19 + kf:25 + kf], oh_j))
        Jr = Jr.reshape(J.shape[:-1] + (cfg.kr,))
        Jt = Jr if Jt is None else torch.cat([Jt, Jr], dim=-1)
    return r, valid, J[..., 0:6], J[..., 6:12], J[..., 12], Jt


def _retr_linear(X, xi):
    """``exp(xi)·X`` to first order in ``xi``: the same value and the same
    first derivative at ``xi = 0``, which is all ``jacfwd`` at 0 reads."""
    half = torch.ops.aten.mul.Scalar(xi[3:6], 0.5)
    q = torch.cat([half, torch.ones_like(half[:1])])
    return lie.se3_mul(torch.cat([xi[0:3], q]), X)


def _blk(Ja, w, Jb):
    """Σ_p,c Ja[e,p,c,i]·w[e,p,c]·Jb[e,p,c,j] → (E, a, b)."""
    E = Ja.shape[0]
    return torch.bmm((Ja * w[..., None]).reshape(E, -1, Ja.shape[-1]).transpose(1, 2),
                     Jb.reshape(E, -1, Jb.shape[-1]))


def assemble_system(cfg: BAConfig, poses, disps, intrinsics, target, weight,
                    ii, jj, edge_valid, slot_edge, pose_mask, disp_mask,
                    disp_damping, disp_sens, sens_mask, pose_damping, pose_ep,
                    rig=None, qi=None, di=None, qj=None):
    """Schur-reduced dense (6N + kt) system for one Gauss-Newton iteration.

    poses (N, 7), disps (ND, P), target/weight (E, P, 2), ii/jj/edge_valid
    (E,) (source and target frames), slot_edge (ND, M) grouping the edges
    by source disparity variable, pose_mask (N,), disp_mask (ND,),
    disp_damping/disp_sens (ND, P), sens_mask (ND,).  Single view: ND = N,
    intrinsics (D,); a rig passes ``rig``, ``qi``, ``di``, ``qj`` as in
    ``edge_residuals_and_jacobians``, ND = N·V.  Returns (Hd, bd, aux)."""
    ND, P = disps.shape
    N = poses.shape[0]
    E = ii.shape[0]
    M = slot_edge.shape[1]
    kt = cfg.kt
    dev = poses.device
    if di is None:
        di = ii

    r, valid, Ji, Jj, Jz, Jt = edge_residuals_and_jacobians(
        cfg, poses, disps, intrinsics, target, ii, jj, rig, qi, di, qj
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
    if kt:
        Bff_e = _blk(Jt, w, Jt)
        Bfi_e = _blk(Jt, w, Ji)  # (E, kt, 6)
        Bfj_e = _blk(Jt, w, Jj)
        vf_e = -torch.einsum("epci,epc->ei", Jt, wr)
        Ef_blk = torch.einsum("epci,epc->eip", Jt, wz)

    # disparity diagonal, per source disparity variable
    C = segment_sum(C_edge, di, ND) + disp_damping + cfg.disp_ep
    b_disp = segment_sum(bz_edge, di, ND)
    sensw = cfg.alpha * sens_mask[:, None]
    C = C + sensw
    b_disp = b_disp - sensw * (disps - disp_sens)
    Cinv = torch.where(disp_mask[:, None], 1.0 / C, torch.zeros_like(C))

    # per-variable Schur grouping: rows [own frame's pose (6)] + M × [pose
    # jj (6)] + [tail]
    Ei_sum = segment_sum(Ei_blk, di, ND)                           # (ND, 6, P)
    slot_valid = slot_edge < E
    Ej_pad = torch.cat([Ej_blk, torch.zeros((1, 6, P), device=dev)], 0)
    G_j = Ej_pad[torch.clamp(slot_edge, max=E)]                    # (ND, M, 6, P)
    jj_slot = jj[torch.clamp(slot_edge, max=E - 1)]
    fvar = torch.cat(
        [(torch.arange(ND, device=dev) // cfg.n_views)[:, None],
         torch.where(slot_valid, jj_slot, torch.full_like(jj_slot, N))],
        dim=1,
    )                                                              # (ND, 1+M), N = trash
    R6 = (1 + M) * 6
    G = torch.cat([Ei_sum[:, None], G_j], dim=1).reshape(ND, R6, P)
    if kt:
        G = torch.cat([G, segment_sum(Ef_blk, di, ND)], dim=1)    # (ND, R6+kt, P)
    GC = G * Cinv[:, None, :]
    S = torch.bmm(GC, G.transpose(1, 2))                          # (ND, R, R)
    b_schur_rows = torch.bmm(GC, b_disp[:, :, None])[..., 0]      # (ND, R)

    # dense pose Hessian with a trash frame N
    NV = N + 1
    iiv = torch.where(edge_valid, ii, torch.full_like(ii, N))
    jjv = torch.where(edge_valid, jj, torch.full_like(jj, N))
    pair_idx = torch.cat([iiv * NV + iiv, iiv * NV + jjv, jjv * NV + iiv, jjv * NV + jjv])
    pair_blk = torch.cat([Bii, Bij, Bij.transpose(1, 2), Bjj]).reshape(4 * E, 36)
    H_pose = segment_sum(pair_blk, pair_idx, NV * NV).reshape(NV, NV, 6, 6)
    Spp = S[:, :R6, :R6].reshape(ND, 1 + M, 6, 1 + M, 6).permute(0, 1, 3, 2, 4)
    corr_idx = (fvar[:, :, None] * NV + fvar[:, None, :]).reshape(-1)
    H_pose = H_pose - segment_sum(Spp.reshape(-1, 36), corr_idx,
                                  NV * NV).reshape(NV, NV, 6, 6)

    b_pose = segment_sum(torch.cat([vi, vj]), torch.cat([iiv, jjv]), NV)
    b_pose = b_pose - segment_sum(b_schur_rows[:, :R6].reshape(ND * (1 + M), 6),
                                  fvar.reshape(-1), NV)

    ev = edge_valid.float()
    if kt:
        H_ff = (Bff_e * ev[:, None, None]).sum(0) - S[:, R6:, R6:].sum(0)
        Hpf_direct = segment_sum(
            torch.cat([Bfi_e.transpose(1, 2), Bfj_e.transpose(1, 2)]),
            torch.cat([iiv, jjv]), NV,
        )                                                          # (NV, 6, kt)
        Spf = S[:, :R6, R6:].reshape(ND * (1 + M), 6, kt)
        H_pf = Hpf_direct - segment_sum(Spf, fvar.reshape(-1), NV)
        b_f = (vf_e * ev[:, None]).sum(0) - b_schur_rows[:, R6:].sum(0)
        if cfg.kr:
            # intrinsics damped 1e-6, the rig 1e-4; the rig of view 0 fixed
            damp = torch.cat([torch.full((cfg.kf,), 1e-6, device=dev),
                              torch.full((cfg.kr,), 1e-4, device=dev)])
            H_ff = H_ff + damp * torch.diag(torch.diagonal(H_ff)) + torch.diag(damp)
            tmask = torch.ones(kt, device=dev)
            tmask[cfg.kf:cfg.kf + 6] = 0.0
            H_ff = H_ff * tmask[:, None] * tmask[None, :] + torch.diag(1.0 - tmask)
            H_pf = H_pf * tmask
            b_f = b_f * tmask
        else:
            eye_f = torch.eye(kt, device=dev)
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

    D = 6 * N + kt
    Hd = torch.zeros((D, D), device=dev)
    Hd[: 6 * N, : 6 * N] = Hp.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    bd = torch.zeros((D,), device=dev)
    bd[: 6 * N] = (b_pose[:N] * pm[:, None]).reshape(-1)
    if kt:
        Hpf_m = (H_pf[:N] * pm[:, None, None]).reshape(6 * N, kt)
        Hd[: 6 * N, 6 * N:] = Hpf_m
        Hd[6 * N:, : 6 * N] = Hpf_m.T
        Hd[6 * N:, 6 * N:] = H_ff
        bd[6 * N:] = b_f
    aux = dict(Cinv=Cinv, b_disp=b_disp, G=G, fvar=fvar, pm=pm, w=w, r=r)
    return Hd, bd, aux


def _iteration(cfg: BAConfig, poses, disps, intrinsics, target, weight, ii, jj,
               edge_valid, slot_edge, pose_mask, disp_mask, disp_damping,
               disp_sens, sens_mask, pose_damping, pose_ep, rig=None, qi=None,
               di=None, qj=None):
    """One Gauss-Newton iteration: assemble, solve, back-substitute,
    retract.  Returns (poses, disps, intrinsics, rig)."""
    ND, P = disps.shape
    N = poses.shape[0]
    M = slot_edge.shape[1]
    R6 = (1 + M) * 6
    kf, kt = cfg.kf, cfg.kt
    Hd, bd, aux = assemble_system(
        cfg, poses, disps, intrinsics, target, weight, ii, jj, edge_valid,
        slot_edge, pose_mask, disp_mask, disp_damping, disp_sens, sens_mask,
        pose_damping, pose_ep, rig, qi, di, qj,
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
    dx_rows = dx_pose_pad[aux["fvar"]].reshape(ND, R6)
    if kt:
        dx_rows = torch.cat([dx_rows, dx_f.expand(ND, kt)], dim=1)
    G = aux["G"]
    dx_disp = aux["Cinv"] * (aux["b_disp"] - torch.bmm(dx_rows[:, None, :], G)[:, 0])

    poses_new = torch.where(pose_mask[:, None], lie.se3_retr(poses, dx_pose), poses)
    dx_disp = torch.where(dx_disp > 10.0, torch.zeros_like(dx_disp), dx_disp)
    disps_new = disps + torch.where(disp_mask[:, None], dx_disp, torch.zeros_like(dx_disp))
    intr_new = intrinsics
    if kf:
        # shared focal (every view); distortion steps at a 0.01 learning rate
        intr_new = torch.cat([intrinsics[..., :2] + dx_f[0], intrinsics[..., 2:4],
                              intrinsics[..., 4:] + 0.01 * dx_f[1:kf]], dim=-1)
    rig_new = rig
    if cfg.kr:
        # rotation only: the translation steps are dropped
        dx_rig = dx_f[kf:].reshape(cfg.n_views, 6).clone()
        dx_rig[:, :3] = 0.0
        rig_new = lie.se3_retr(rig, dx_rig)
    return poses_new, disps_new, intr_new, rig_new


def ba_iteration(cfg: BAConfig, poses, disps, intrinsics, target, weight,
                 ii, jj, edge_valid, slot_edge, pose_mask, disp_mask,
                 disp_damping, disp_sens, sens_mask,
                 pose_damping=1e-3, pose_ep=0.1):
    """One single-view Gauss-Newton iteration.  Returns (poses, disps,
    intrinsics)."""
    return _iteration(cfg, poses, disps, intrinsics, target, weight, ii, jj,
                      edge_valid, slot_edge, pose_mask, disp_mask, disp_damping,
                      disp_sens, sens_mask, pose_damping, pose_ep)[:3]


def ba_solve(cfg: BAConfig, poses, disps, intrinsics, target, weight, ii, jj,
             edge_valid, slot_edge, pose_mask, disp_mask, disp_damping,
             disp_sens, sens_mask, n_iters: int, pose_damping, pose_ep):
    """``n_iters`` single-view Gauss-Newton iterations, then the final
    ``disp ≥ 0.001`` clamp.  Returns (poses, disps, intrinsics)."""
    for _ in range(n_iters):
        poses, disps, intrinsics = ba_iteration(
            cfg, poses, disps, intrinsics, target, weight, ii, jj, edge_valid,
            slot_edge, pose_mask, disp_mask, disp_damping, disp_sens,
            sens_mask, pose_damping, pose_ep,
        )
    return poses, torch.clamp(disps, min=0.001), intrinsics


def ba_solve_mv(cfg: BAConfig, poses, rig, disps, intrinsics, target, weight,
                pi, qi, di, pj, qj, edge_valid, slot_edge, pose_mask, disp_mask,
                disp_damping, disp_sens, sens_mask, n_iters: int, pose_damping,
                pose_ep):
    """``n_iters`` Gauss-Newton iterations over a V-view rig: poses (N, 7),
    rig (V, 7), disps (N·V, P), intrinsics (V, D), expanded edges
    ``pi, qi, di, pj, qj`` (E,), slot_edge (N·V, M) over ``di``.  Then the
    ``disp ≥ 0.001`` clamp.  Returns (poses, rig, disps, intrinsics)."""
    for _ in range(n_iters):
        poses, disps, intrinsics, rig = _iteration(
            cfg, poses, disps, intrinsics, target, weight, pi, pj, edge_valid,
            slot_edge, pose_mask, disp_mask, disp_damping, disp_sens, sens_mask,
            pose_damping, pose_ep, rig, qi, di, qj,
        )
    return poses, rig, torch.clamp(disps, min=0.001), intrinsics
