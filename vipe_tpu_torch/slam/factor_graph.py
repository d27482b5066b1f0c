"""Factor graph: host-side edge topology + GRU/BA updates (port of the
sequential path of ``vipe_tpu/slam/factor_graph.py``).

Per-edge device state (targets, weights, hidden states, correlation
pyramids) holds exactly the active edges, in the JAX package's row order:
new edges append, removals compact the kept rows in order.  The learned
update operator is injected as ``update_fn(net, inp, corr, motn, ii, jj,
num_frames) -> (net, delta, weight, eta)``, so tests can swap DroidNet for
a geometric oracle.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import corr as corr_ops
from ..ops import geom
from . import ba

CORR_LEVELS = 4
CORR_RADIUS = 3
BACKEND_CHUNK = 32  # edges per backend corr chunk (soft cap, frame-aligned)
ADD_CHUNK = 16      # edges per corr-volume build (bounds transient memory)
WEIGHT_DENSE_DISP = 0.001  # flow-term weight of the BA (reference buffer.py:396)


class FactorGraph:
    def __init__(self, buffer, update_fn: Callable, max_factors: int,
                 incremental: bool, optimize_intrinsics: bool = False,
                 corr_mode: str = "volume", corr_dtype: str = "bf16"):
        if corr_mode != "volume":
            raise NotImplementedError(f"corr_mode={corr_mode!r} is not ported yet (volume only)")
        if corr_dtype != "bf16":
            raise NotImplementedError(f"corr_dtype={corr_dtype!r} is not ported yet (bf16 only)")
        self.buffer = buffer
        self.update_fn = update_fn
        self.max_factors = max_factors
        self.incremental = incremental
        self.optimize_intrinsics = optimize_intrinsics
        self.ht, self.wd = buffer.ht, buffer.wd
        dev = self.device = buffer.device
        ht, wd = self.ht, self.wd

        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)
        self.target = torch.zeros((0, ht, wd, 2), device=dev)
        self.weight = torch.zeros((0, ht, wd, 2), device=dev)
        self.f_net = torch.zeros((0, ht, wd, 128), device=dev)
        self.corr_pyr = None
        if incremental:
            self.corr_pyr = [
                torch.zeros((0, ht, wd) + corr_ops.level_dims(ht, wd, lvl),
                            dtype=torch.bfloat16, device=dev)
                for lvl in range(CORR_LEVELS)
            ]
        # per-frame GRU-predicted BA damping (not shifted on keyframe removal)
        self.damping = torch.full((buffer.buffer_size, ht, wd), 1e-6, device=dev)
        # inactive (stored) factors
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.target_inac = torch.zeros((0, ht, wd, 2), device=dev)
        self.weight_inac = torch.zeros((0, ht, wd, 2), device=dev)

    @property
    def n_edges(self) -> int:
        return len(self.ii)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    # ------------------------------------------------------------ edge admin

    def add_factors(self, ii, jj, remove: bool = False):
        """Add edges: dedup against active + inactive edges and earlier
        entries, optionally evict the oldest to respect ``max_factors``,
        build per-edge corr pyramids, init target from the current
        reprojection, weight 0, hidden state from the source frame."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        seen = set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist())
        )
        keep = []
        for k, e in enumerate(zip(ii.tolist(), jj.tolist())):
            if e not in seen:
                keep.append(k)
            seen.add(e)
        ii, jj = ii[keep], jj[keep]
        if len(ii) == 0:
            return

        if (self.max_factors > 0 and self.n_edges + len(ii) > self.max_factors
                and self.incremental and remove):
            n_remove = self.n_edges + len(ii) - self.max_factors
            order = np.argsort(-self.age, kind="stable")
            mask = np.zeros(self.n_edges, bool)
            mask[order[:n_remove]] = True
            self.rm_factors(mask, store=True)

        space = self.max_factors - self.n_edges
        ii, jj = ii[:space], jj[:space]
        if len(ii) == 0:
            return

        buf = self.buffer
        ii_t, jj_t = self._t(ii), self._t(jj)
        coords, _ = buf.reproject(ii, jj)
        self.target = torch.cat([self.target, coords])
        self.weight = torch.cat([self.weight, torch.zeros_like(coords)])
        self.f_net = torch.cat([self.f_net, buf.nets[ii_t].float()])
        if self.incremental:
            parts = [[] for _ in range(CORR_LEVELS)]
            for c0 in range(0, len(ii), ADD_CHUNK):
                sl = slice(c0, c0 + ADD_CHUNK)
                pyr = corr_ops.corr_pyramid(
                    buf.fmaps[ii_t[sl]].float(), buf.fmaps[jj_t[sl]].float(), CORR_LEVELS
                )
                for lvl in range(CORR_LEVELS):
                    parts[lvl].append(pyr[lvl])
            self.corr_pyr = [torch.cat([p] + q) for p, q in zip(self.corr_pyr, parts)]
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])

    def rm_factors(self, mask, store: bool = False):
        """Drop the masked edges, optionally storing them as inactive."""
        mask = np.asarray(mask, bool)[: self.n_edges]
        if not mask.any():
            return
        drop = np.where(mask)[0]
        keep = np.where(~mask)[0]
        if store:
            drop_t = self._t(drop)
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[drop]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[drop]])
            self.target_inac = torch.cat([self.target_inac, self.target[drop_t]])
            self.weight_inac = torch.cat([self.weight_inac, self.weight[drop_t]])
        keep_t = self._t(keep)
        self.ii, self.jj, self.age = self.ii[keep], self.jj[keep], self.age[keep]
        self.target = self.target[keep_t]
        self.weight = self.weight[keep_t]
        self.f_net = self.f_net[keep_t]
        if self.incremental:
            self.corr_pyr = [p[keep_t] for p in self.corr_pyr]

    def rm_keyframe(self, ix: int):
        """Remove keyframe ``ix`` from buffer and graph, shifting indices."""
        self.buffer.remove_slot(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac[self.ii_inac >= ix] -= 1
        self.jj_inac[self.jj_inac >= ix] -= 1
        if m.any():
            keep_t = self._t(np.where(~m)[0])
            self.ii_inac, self.jj_inac = self.ii_inac[~m], self.jj_inac[~m]
            self.target_inac = self.target_inac[keep_t]
            self.weight_inac = self.weight_inac[keep_t]
        m = (self.ii == ix) | (self.jj == ix)
        self.ii[self.ii >= ix] -= 1
        self.jj[self.jj >= ix] -= 1
        self.rm_factors(m, store=False)

    # ---------------------------------------------------------- edge proposal

    def add_neighborhood_factors(self, t0: int, t1: int, r: int = 3):
        """All ordered pairs within radius r."""
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1), indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def distance_matrix(self, w0: int, n: int, beta: float):
        """Bidirectional frame distances among frames [w0, n) as float64:
        0.5·(d(i→j, disp_i) + d(j→i, disp_j)), each direction saturating
        independently."""
        k = n - w0
        ii, jj = np.meshgrid(np.arange(w0, n), np.arange(w0, n), indexing="ij")
        buf = self.buffer
        d = geom.frame_distance(
            buf.poses, buf.disps, buf.pinhole_grid_intrinsics,
            self._t(ii.reshape(-1)), self._t(jj.reshape(-1)),
            di=self._t(ii.reshape(-1)), beta=beta,
        ).reshape(k, k)
        return (0.5 * (d + d.T)).cpu().numpy().astype(np.float64)

    def add_proximity_factors(self, t0: int = 0, t1: int = 0, rad: int = 2,
                              nms: int = 2, beta: float = 0.25,
                              thresh: float = 16.0, remove: bool = False):
        """Distance-thresholded NMS edge proposal: neighbourhood edges
        (i-rad-1..i-1 ↔ i) always; other pairs by ascending distance with
        an L1-ball suppression around accepted and existing edges."""
        t = self.buffer.n_frames
        if t - max(t0, t1) <= 0:
            return
        w0 = min(t0, t1)
        d_full = self.distance_matrix(w0, t, beta)
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        d = d_full[t0 - w0: t - w0, t1 - w0: t - w0].copy()

        def _suppress(i, j):
            if t0 <= i < t and t1 <= j < t:
                d[i - t0, j - t1] = np.inf

        def _suppress_nms(i, j):
            for di in range(-nms, nms + 1):
                for dj in range(-nms, nms + 1):
                    if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                        _suppress(i + di, j + dj)

        for i, j in zip(self.ii, self.jj):
            _suppress_nms(int(i), int(j))
        for i, j in zip(self.ii_inac, self.jj_inac):
            _suppress_nms(int(i), int(j))

        flat = d.reshape(-1)
        flat[(ii - rad < jj) | (flat > thresh)] = np.inf
        d_sorted = np.argsort(flat)

        es = []
        for i in range(t0, t):
            for j in range(max(i - rad - 1, 0), i):
                es.append((i, j))
                es.append((j, i))
                _suppress(i, j)
        for k in d_sorted:
            if flat[k] > thresh or not np.isfinite(d.reshape(-1)[k]):
                continue
            if self.max_factors > 0 and len(es) > self.max_factors:
                break
            i, j = int(ii[k]), int(jj[k])
            es.append((i, j))
            es.append((j, i))
            _suppress_nms(i, j)
        if es:
            es = np.asarray(es, np.int64)
            self.add_factors(es[:, 0], es[:, 1], remove)

    # ------------------------------------------------------------- GRU + BA

    def _run_update_fn(self, f_net, coords1, target_prev, ii, jj, corr_feat):
        """Motion features → update_fn → (net, target, weight, eta)."""
        buf = self.buffer
        grid = geom.coords_grid(self.ht, self.wd, self.device)
        motn = torch.cat([coords1 - grid, target_prev - coords1], dim=-1).clamp(-64.0, 64.0)
        ii_t, jj_t = self._t(ii), self._t(jj)
        inp = buf.inps[ii_t].float()
        net, delta, weight, eta = self.update_fn(
            f_net, inp, corr_feat, motn, ii_t, jj_t, buf.n_frames
        )
        weight = torch.where(buf.masks[ii_t][..., None], torch.zeros_like(weight), weight)
        return net, coords1 + delta, weight, eta

    def update(self, t0: Optional[int] = None, t1: Optional[int] = None,
               itrs: int = 3, use_inactive: bool = False,
               motion_only: bool = False, limited_disp: bool = False):
        """Frontend-style update: reproject → corr lookup → ConvGRU → dense
        BA with the GRU-predicted damping."""
        assert self.incremental and self.n_edges > 0
        if t0 is None:
            t0 = int(max(1, self.ii.min() + 1))
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max()) + 1)
        coords1, _ = self.buffer.reproject(self.ii, self.jj)
        corr_feat = corr_ops.corr_lookup_pyramid(self.corr_pyr, coords1, CORR_RADIUS)
        self.f_net, self.target, self.weight, eta = self._run_update_fn(
            self.f_net, coords1, self.target, self.ii, self.jj, corr_feat
        )
        src = self._t(np.unique(self.ii))
        self.damping[src] = eta[src]
        self._bundle_adjustment(
            t0, t1, itrs, use_inactive=use_inactive, motion_only=motion_only,
            limited_disp=limited_disp,
            pose_damping=1e-3, pose_ep=0.1,
            optimize_intrinsics=self.optimize_intrinsics and not motion_only,
        )
        self.age += 1

    def current_residual(self) -> float:
        """Σ w·(reproj − target)² over the active edges."""
        if self.n_edges == 0:
            return 0.0
        coords, valid = self.buffer.reproject(self.ii, self.jj)
        r = coords - self.target
        w = self.weight * valid[..., None]
        return float(torch.sum(w * r * r))

    def update_batch(self, itrs: int, steps: int, optimize_intrinsics: bool = False):
        """Backend-style batched update: per step, refresh every edge's
        target/weight chunk by chunk (corr pyramid built per chunk and
        dropped after its lookup), then one global BA."""
        if self.n_edges == 0:
            return
        t = self.buffer.n_frames
        # chunks of source-frame ranges of 8, soft-capped at BACKEND_CHUNK
        # edges and split only at frame boundaries, so each frame's damping
        # comes from exactly one chunk
        frame_chunks = []
        for i0 in range(0, t, 8):
            cur: list = []
            for f in range(i0, min(i0 + 8, t)):
                sel_f = np.where(self.ii == f)[0]
                if not len(sel_f):
                    continue
                if cur and len(cur) + len(sel_f) > BACKEND_CHUNK:
                    frame_chunks.append(np.asarray(cur))
                    cur = []
                cur.extend(sel_f.tolist())
            if cur:
                frame_chunks.append(np.asarray(cur))

        buf = self.buffer
        for _ in range(steps):
            coords1, _ = buf.reproject(self.ii, self.jj)
            for sel in frame_chunks:
                sel_t = self._t(sel)
                ii, jj = self.ii[sel], self.jj[sel]
                pyr = corr_ops.corr_pyramid(
                    buf.fmaps[self._t(ii)].float(), buf.fmaps[self._t(jj)].float(),
                    CORR_LEVELS,
                )
                c1 = coords1[sel_t]
                corr_feat = corr_ops.corr_lookup_pyramid(pyr, c1, CORR_RADIUS)
                del pyr
                net, target, weight, eta = self._run_update_fn(
                    self.f_net[sel_t], c1, self.target[sel_t], ii, jj, corr_feat
                )
                self.f_net[sel_t] = net
                self.target[sel_t] = target
                self.weight[sel_t] = weight
                src = self._t(np.unique(ii))
                self.damping[src] = eta[src]
            self._bundle_adjustment(
                1, t, itrs, use_inactive=False, motion_only=False, limited_disp=False,
                pose_damping=1e-5, pose_ep=1e-2,
                optimize_intrinsics=optimize_intrinsics,
            )

    def _bundle_adjustment(self, t0: int, t1: int, itrs: int, use_inactive: bool,
                           motion_only: bool, limited_disp: bool, pose_damping: float,
                           pose_ep: float, optimize_intrinsics: bool):
        """Dense BA over [selected inactive ++ active] edges and all
        ``n_frames`` keyframes (reference buffer.bundle_adjustment)."""
        buf = self.buffer
        N = buf.n_frames
        P = self.ht * self.wd
        if use_inactive:
            sel = np.where((self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3))[0]
        else:
            sel = np.zeros(0, np.int64)
        sel_t = self._t(sel)
        ii = np.concatenate([self.ii_inac[sel], self.ii])
        jj = np.concatenate([self.jj_inac[sel], self.jj])
        E = len(ii)
        target = torch.cat([self.target_inac[sel_t], self.target]).reshape(E, P, 2)
        weight = torch.cat([self.weight_inac[sel_t], self.weight]).reshape(E, P, 2)
        weight = weight * WEIGHT_DENSE_DISP

        fill_ct = np.bincount(ii, minlength=N)
        slot_edge = ba.build_edge_slots(ii, N, max(int(fill_ct.max()), 1))
        idx = np.arange(N)
        pose_mask = (idx >= t0) & (idx < t1)
        has_edge = fill_ct > 0
        if motion_only:
            disp_mask = np.zeros(N, bool)
        elif limited_disp:
            disp_mask = has_edge & (idx >= t0) & (idx < t1)
        else:
            disp_mask = has_edge

        sens = buf.disps_sens[:N].reshape(N, P)
        sens_mask = (sens.sum(1) > 0) & (not motion_only)
        cfg = ba.BAConfig(
            camera_type=buf.camera_type, ht=self.ht, wd=self.wd,
            optimize_intrinsics=optimize_intrinsics,
            alpha=buf.dense_disp_alpha, max_edges_per_frame=slot_edge.shape[1],
        )
        poses, disps, intr = ba.ba_solve(
            cfg, buf.poses[:N], buf.disps[:N].reshape(N, P), buf.intrinsics,
            target, weight, self._t(ii), self._t(jj),
            torch.ones(E, dtype=torch.bool, device=self.device),
            self._t(slot_edge),
            torch.as_tensor(pose_mask, device=self.device),
            torch.as_tensor(disp_mask, device=self.device),
            0.2 * self.damping[:N].reshape(N, P) + 1e-7,
            sens, sens_mask.float(), itrs, pose_damping, pose_ep,
        )
        buf.poses[:N] = poses
        buf.disps[:N] = disps.reshape(N, self.ht, self.wd)
        if optimize_intrinsics:
            buf.intrinsics = intr
