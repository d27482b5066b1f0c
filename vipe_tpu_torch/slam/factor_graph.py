"""Factor graph: host-side edge topology + GRU/BA updates (port of the
sequential path of ``vipe_tpu/slam/factor_graph.py``).

Per-edge device state (targets, weights, hidden states, correlation
state) holds exactly the active edges, in the JAX package's row order:
new edges append, removals compact the kept rows in order.  The
correlation state of an incremental graph is, per ``corr_mode`` and
``corr_dtype``:

* ``volume``/``bf16``: the 4-level bf16 volume pyramid (K1 lookups);
* ``volume``/``int8``: the same volumes quantised per edge and level, with
  their (E,) f32 scales in ``corr_scale`` (K1 lookups with scales);
* ``alt``: 5 packed bf16 feature rows, f1 and the pooled f2 per level
  (``corr_feat_pack``), whose dots K2 recomputes at every lookup;
  ``corr_dtype`` does not apply.

The learned update operator is injected as ``update_fn(net, inp, corr,
motn, ii, jj, num_frames) -> (net, delta, weight, eta)``, so tests can swap
DroidNet for a geometric oracle.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import corr as corr_ops
from ..ops import geom, lie
from . import ba

CORR_LEVELS = 4
CORR_RADIUS = 3
BACKEND_CHUNK = 32  # edges per backend corr chunk (soft cap, frame-aligned)
ADD_CHUNK = 16      # edges per corr-state build (bounds transient memory)
WEIGHT_DENSE_DISP = 0.001  # flow-term weight of the BA (reference buffer.py:396)


class FactorGraph:
    def __init__(self, buffer, update_fn: Callable, max_factors: int,
                 incremental: bool, optimize_intrinsics: bool = False,
                 corr_mode: str = "volume", corr_dtype: str = "bf16"):
        if corr_mode not in ("volume", "alt"):
            raise ValueError(f"corr_mode must be 'volume' or 'alt', got {corr_mode!r}")
        if corr_dtype not in ("bf16", "int8"):
            raise ValueError(f"corr_dtype must be 'bf16' or 'int8', got {corr_dtype!r}")
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
        self.corr_alt = corr_mode == "alt"
        # int8 volumes only where volumes are stored (JAX: volume mode only;
        # the backend's per-chunk volumes stay bf16)
        self.corr_q = corr_dtype == "int8" and not self.corr_alt and incremental
        self.corr_pyr = self.corr_scale = None
        if incremental and self.corr_alt:
            C = buffer.fmaps.shape[-1]
            dims = [(ht, wd)] + [corr_ops.level_dims(ht, wd, lvl) for lvl in range(CORR_LEVELS)]
            self.corr_pyr = [torch.zeros((0,) + d + (C,), dtype=torch.bfloat16, device=dev)
                             for d in dims]
        elif incremental:
            self.corr_pyr = [
                torch.zeros((0, ht, wd) + corr_ops.level_dims(ht, wd, lvl),
                            dtype=torch.int8 if self.corr_q else torch.bfloat16, device=dev)
                for lvl in range(CORR_LEVELS)
            ]
            if self.corr_q:
                self.corr_scale = [torch.zeros(0, device=dev) for _ in range(CORR_LEVELS)]
        # per-frame GRU-predicted BA damping (not shifted on keyframe removal)
        self.damping = torch.full((buffer.buffer_size, ht, wd), 1e-6, device=dev)
        # inactive (stored) factors
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.target_inac = torch.zeros((0, ht, wd, 2), device=dev)
        self.weight_inac = torch.zeros((0, ht, wd, 2), device=dev)
        self.host_waits = 0  # distance-matrix reads that waited for their copy

    @property
    def n_edges(self) -> int:
        return len(self.ii)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def _corr_state(self, ii_t, jj_t):
        """Correlation state of the edges ``ii_t → jj_t``: packed features
        in alt mode, else the volume pyramid (and, for int8, the quantised
        levels with their per-edge scales)."""
        f1 = self.buffer.fmaps[ii_t].float()
        f2 = self.buffer.fmaps[jj_t].float()
        if self.corr_alt:
            return corr_ops.corr_feat_pack(f1, f2, CORR_LEVELS), None
        pyr = corr_ops.corr_pyramid(f1, f2, CORR_LEVELS)
        if not self.corr_q:
            return pyr, None
        q, s = zip(*(corr_ops.quantize_volume(p) for p in pyr))
        return list(q), list(s)

    # ------------------------------------------------------------ edge admin

    def add_factors(self, ii, jj, remove: bool = False):
        """Add edges: dedup against active + inactive edges and earlier
        entries, optionally evict the oldest to respect ``max_factors``,
        build per-edge corr state, init target from the current
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
            parts = [[p] for p in self.corr_pyr]
            sparts = [[s] for s in self.corr_scale or []]
            for c0 in range(0, len(ii), ADD_CHUNK):
                sl = slice(c0, c0 + ADD_CHUNK)
                pyr, scales = self._corr_state(ii_t[sl], jj_t[sl])
                for part, p in zip(parts, pyr):
                    part.append(p)
                for part, s in zip(sparts, scales or []):
                    part.append(s)
            self.corr_pyr = [torch.cat(p) for p in parts]
            if self.corr_q:
                self.corr_scale = [torch.cat(s) for s in sparts]
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
            if self.corr_q:
                self.corr_scale = [s[keep_t] for s in self.corr_scale]

    def rm_keyframe(self, ix: int, top: Optional[int] = None):
        """Remove keyframe ``ix`` from buffer and graph, shifting indices.
        ``top``: see ``GraphBuffer.remove_slot`` (a late removal shifts the
        initialised next slot too)."""
        self.buffer.remove_slot(ix, top)
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

    def submit_distance_matrix(self, beta: float, n_frames: Optional[int] = None,
                               window: Optional[int] = None,
                               predict_slot: Optional[int] = None) -> "DistanceToken":
        """Start the bidirectional distance matrix among the last ``window``
        of the first ``n_frames`` frames on its way to the host; read it
        with ``add_proximity_factors(dist_token=...)``.  Entry (i, j) is
        0.5·(d(i→j, disp_i) + d(j→i, disp_j)), each direction saturating on
        its own.  ``predict_slot``: a frame whose row is taken as the next
        slot's initialisation (constant-velocity pose from the two frames
        below it, their upper one's mean disparity) instead of the
        buffer's row: the frontend submits before its step, from the state
        before the step."""
        buf = self.buffer
        n = buf.n_frames if n_frames is None else n_frames
        w0 = max(0, n - window) if window is not None else 0
        poses, disps = buf.poses[w0:n], buf.disps[w0:n]
        if predict_slot is not None and 2 <= predict_slot - w0 < n - w0:
            s = predict_slot - w0
            poses, disps = poses.clone(), disps.clone()
            p1, p2 = poses[s - 2], poses[s - 1]
            w = lie.se3_log(lie.se3_mul(p2, lie.se3_inv(p1))) * 0.5
            poses[s] = lie.se3_mul(lie.se3_exp(w), p2)
            disps[s] = disps[s - 1].mean()
        k = n - w0
        ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
        ii_t, jj_t = self._t(ii.reshape(-1)), self._t(jj.reshape(-1))
        d = geom.frame_distance(poses, disps, buf.pinhole_grid_intrinsics, ii_t, jj_t,
                                di=ii_t, beta=beta).reshape(k, k)
        return DistanceToken(w0, 0.5 * (d + d.T), self)

    def add_proximity_factors(self, t0: int = 0, t1: int = 0, rad: int = 2,
                              nms: int = 2, beta: float = 0.25,
                              thresh: float = 16.0, remove: bool = False,
                              dist_token: Optional["DistanceToken"] = None):
        """Distance-thresholded NMS edge proposal: neighbourhood edges
        (i-rad-1..i-1 ↔ i) always; other pairs by ascending distance with
        an L1-ball suppression around accepted and existing edges.  The
        distances come from ``dist_token`` where it covers the frames
        [min(t0, t1), n_frames), else from a matrix computed now."""
        t = self.buffer.n_frames
        if t - max(t0, t1) <= 0:
            return
        if dist_token is None or not dist_token.covers(min(t0, t1), t):
            dist_token = self.submit_distance_matrix(beta, window=t - min(t0, t1))
        w0 = dist_token.w0
        d_full = dist_token.read()
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
               motion_only: bool = False, fixed_motion: bool = False,
               limited_disp: bool = False):
        """Frontend-style update: reproject → corr lookup → ConvGRU → dense
        BA with the GRU-predicted damping.  ``fixed_motion``: the poses are
        given and stay fixed; ``motion_only``: the disparities do."""
        assert self.incremental and self.n_edges > 0
        if t0 is None:
            t0 = int(max(1, self.ii.min() + 1))
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max()) + 1)
        coords1, _ = self.buffer.reproject(self.ii, self.jj)
        corr_feat = corr_ops.corr_lookup_pyramid(self.corr_pyr, coords1, CORR_RADIUS,
                                                 scales=self.corr_scale)
        self.f_net, self.target, self.weight, eta = self._run_update_fn(
            self.f_net, coords1, self.target, self.ii, self.jj, corr_feat
        )
        src = self._t(np.unique(self.ii))
        self.damping[src] = eta[src]
        self._bundle_adjustment(
            t0, t1, itrs, use_inactive=use_inactive, motion_only=motion_only,
            fixed_motion=fixed_motion, limited_disp=limited_disp,
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
        target/weight chunk by chunk (corr pyramid, or packed features in
        alt mode, built per chunk and dropped after its lookup), then one
        global BA.  The backend graph stores no corr state, so
        ``corr_dtype`` does not apply, as in the JAX package."""
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
                pyr, _ = self._corr_state(self._t(ii), self._t(jj))
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
                1, t, itrs, use_inactive=False, motion_only=False, fixed_motion=False,
                limited_disp=False,
                pose_damping=1e-5, pose_ep=1e-2,
                optimize_intrinsics=optimize_intrinsics,
            )

    def _bundle_adjustment(self, t0: int, t1: int, itrs: int, use_inactive: bool,
                           motion_only: bool, fixed_motion: bool, limited_disp: bool,
                           pose_damping: float, pose_ep: float, optimize_intrinsics: bool):
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
        pose_mask = (idx >= t0) & (idx < t1) & (not fixed_motion)
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


class DistanceToken:
    """A frame-distance matrix over frames [w0, w0 + n) on its way to the
    host.  On the card it is copied into pinned host memory behind a CUDA
    event, so that the copy overlaps later work; ``read`` waits only when
    the copy has not landed yet, and counts such waits in the graph's
    ``host_waits``."""

    def __init__(self, w0: int, d: torch.Tensor, graph: FactorGraph):
        self.w0, self.n, self.graph = w0, d.shape[0], graph
        self.event = None
        if d.is_cuda:
            self.host = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
            self.host.copy_(d, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = d

    def covers(self, w: int, t: int) -> bool:
        return self.w0 <= w and self.w0 + self.n >= t

    def read(self) -> np.ndarray:
        if self.event is not None and not self.event.query():
            self.graph.host_waits += 1
            self.event.synchronize()
        return self.host.numpy().astype(np.float64)
