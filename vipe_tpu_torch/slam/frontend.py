"""SLAM frontend: keyframe-incremental tracking (port of
``vipe_tpu/slam/frontend.py``).

Initialises after ``warmup`` keyframes; then, per new keyframe: age out old
edges, propose proximity edges, ``iters1`` GRU/BA rounds, decide whether
the second-newest keyframe moved too little to keep (else ``iters2`` more
rounds), and initialise the next slot (constant-velocity pose unless the
stream gives poses, mean disparity).

Two orderings, as in the JAX package:

* the speculative one (``keyframe_spec_depth: 2``, the default): the
  removal decision of keyframe k is applied just before keyframe k+2 is
  appended, so keyframe k+1 is appended and optimised assuming k stays; a
  removal then comes late and shifts every row above, the initialised
  next slot included, and re-scores the younger decision against the
  pair that now precedes it.  ``keyframe_spec_depth: 1`` applies each
  decision before the very next append.  With ``proximity_spec: true``
  the distance matrix that the next keyframe's edge proposal reads is
  computed before the step, from the state before BA, with the next slot
  predicted; ``false`` computes it after the step.  The step itself
  follows the JAX package's fused step: the removal distance is taken
  after ``iters1`` rounds, and only the keep branch runs the ``iters2``
  rounds and the next-slot initialisation.  The branch is chosen by
  reading that distance on the host (one read per keyframe).
* the sequential, reference-exact one, taken whatever the two knobs say
  when the update function is marked ``host_only`` (an oracle that reads
  host state), as the JAX package takes it for update functions it cannot
  trace, and when sparse tracks are on, as the JAX package leaves its fused
  step for them.

A rig caps ``keyframe_spec_depth`` at 1 (a late removal is single-view
only) and submits its distance matrix after the step; a new slot's
disparity is the mean over the previous frame's V slots.
"""

from __future__ import annotations

from ..ops import lie
from .factor_graph import FactorGraph


class SLAMFrontend:
    def __init__(self, buffer, update_fn, config):
        c = config
        self.buffer = buffer
        self.graph = FactorGraph(
            buffer, update_fn, max_factors=48, incremental=True,
            optimize_intrinsics=c.get("optimize_intrinsics", False),
            corr_mode=c.get("corr_mode", "volume"),
            corr_dtype=c.get("corr_dtype", "bf16"),
        )
        self.t1 = 0
        self.is_initialized = False
        self.max_age = 25
        self.iters1 = 4
        self.iters2 = 2
        self.warmup = c.get("warmup", 8)
        self.beta = c.get("beta", 0.3)
        self.frontend_nms = c.get("frontend_nms", 1)
        self.keyframe_thresh = c.get("keyframe_thresh", 4.0)
        self.frontend_window = c.get("frontend_window", 25)
        self.frontend_thresh = c.get("frontend_thresh", 16.0)
        self.frontend_radius = c.get("frontend_radius", 2)
        self.seq_init = c.get("seq_init", True)
        self.has_init_pose = c.get("has_init_pose", False)
        self.spec_depth = c.get("keyframe_spec_depth", 2)
        self.prox_spec = c.get("proximity_spec", True)
        if buffer.n_views > 1:
            self.spec_depth = min(self.spec_depth, 1)
            self.prox_spec = False
        tracks = buffer.sparse_tracks
        self.speculative = not (getattr(update_fn, "host_only", False)
                                or (tracks is not None and tracks.enabled))
        self._dist_token = None
        # (removal distance, t1 when decided), oldest first, at most 2
        self._pending: list = []
        self.n_removals = 0
        self.late_removals = 0

    # ------------------------------------------------------------ helpers

    def _round(self, n: int):
        for _ in range(n):
            self.graph.update(use_inactive=True, fixed_motion=self.has_init_pose)

    def _slot_init(self):
        """Initialise the next slot t1: constant-velocity pose (unless the
        stream gives poses) and the previous keyframe's mean disparity."""
        buf, t1 = self.buffer, self.t1
        if not self.has_init_pose:
            p1, p2 = buf.poses[t1 - 2], buf.poses[t1 - 1]
            w = lie.se3_log(lie.se3_mul(p2, lie.se3_inv(p1))) * 0.5
            buf.poses[t1] = lie.se3_mul(lie.se3_exp(w), p2)
        self._disp_init(t1 - 1, t1)

    def _disp_init(self, lo: int, t1: int):
        """Slots of frame ``t1`` ← the mean disparity of frames [lo, t1)."""
        V = self.buffer.n_views
        disps = self.buffer.disps
        if V == 1:
            disps[t1] = (disps[lo] if lo == t1 - 1 else disps[lo:t1]).mean()
        else:
            disps[t1 * V:(t1 + 1) * V] = disps[lo * V:t1 * V].mean()

    def _removal_distance(self) -> float:
        d = self.buffer.frame_distance([self.t1 - 3], [self.t1 - 2], beta=self.beta)
        return float(d.max())

    def _submit_distance(self, pre_step: bool = False):
        if not self.has_init_pose:
            # +8: t0 = t1 - 5 may reach below the window's edge
            self._dist_token = self.graph.submit_distance_matrix(
                self.beta, n_frames=self.buffer.n_frames + 1,
                window=self.frontend_window + 8,
                predict_slot=self.t1 if pre_step else None,
            )

    def drop_cached_distance(self):
        self._dist_token = None

    # ------------------------------------------------- deferred decisions

    def resolve_pending(self, keep_newest: bool = False):
        """Apply the pending removal decisions.  ``keep_newest`` (before an
        append) leaves the newest one pending at depth 2.  Runs with
        ``keep_newest=False`` before every backend run and pass 2."""
        if self.spec_depth < 2:
            keep_newest = False
        while self._pending and (not keep_newest or len(self._pending) > 1):
            self._resolve_one()

    def _resolve_one(self):
        d, t1s = self._pending.pop(0)
        if d >= self.keyframe_thresh:
            return
        g = self.graph
        self.n_removals += 1
        if self.t1 == t1s:
            # no keyframe appended since: the reference ordering
            g.rm_keyframe(t1s - 2)
            self.t1 = t1s - 1
            self._slot_init()
            self._dist_token = None
            self._submit_distance()
            return
        # late: a younger keyframe was appended and optimised meanwhile
        assert self.t1 == t1s + 1, (self.t1, t1s)
        g.rm_keyframe(t1s - 2, top=self.t1)
        self.t1 -= 1
        self.late_removals += 1
        if self._pending:
            # the younger decision compared the removed keyframe; decide
            # again on the pair (t1-3, t1-2) that now precedes it
            d_old, _ = self._pending.pop(0)
            if self._removal_distance() < self.keyframe_thresh:
                self.n_removals += 1
                g.rm_keyframe(self.t1 - 2)
                self.t1 -= 1
                self._slot_init()
            elif d_old < self.keyframe_thresh:
                # its step took the remove branch: run the keep branch now
                if g.n_edges > 0:
                    self._round(self.iters2)
                    g.age -= self.iters2  # already counted at the step
                self._slot_init()
        self._dist_token = None
        self._submit_distance()

    # --------------------------------------------------------------- steps

    def _update(self):
        """Per-new-keyframe update."""
        assert len(self._pending) <= 1, "resolve_pending(keep_newest=True) runs before an append"
        self.t1 += 1
        g = self.graph
        if g.n_edges > 0:
            g.rm_factors(g.age > self.max_age, store=True)
        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - self.frontend_window, 0),
            rad=self.frontend_radius, nms=self.frontend_nms,
            thresh=self.frontend_thresh, beta=self.beta, remove=True,
            dist_token=self._dist_token,
        )
        self._dist_token = None
        if self.speculative:
            pre_spec = self.prox_spec and not self.has_init_pose
            if pre_spec:
                self._submit_distance(pre_step=True)
            self._round(self.iters1)
            d = self._removal_distance()
            if d >= self.keyframe_thresh:
                self._round(self.iters2)
                self._slot_init()
            elif self.spec_depth >= 2:
                # edges age as if kept: a younger keyframe's age-out may
                # run before this decision is applied
                g.age += self.iters2
            self._pending.append((d, self.t1))
            if pre_spec:
                return
        else:
            self._round(self.iters1)
            if self._removal_distance() < self.keyframe_thresh:
                self.n_removals += 1
                g.rm_keyframe(self.t1 - 2)
                self.t1 -= 1
            else:
                self._round(self.iters2)
            self._slot_init()
        self._submit_distance()

    def _initialize(self):
        """System initialisation over the first ``warmup`` keyframes."""
        g = self.graph
        buf = self.buffer
        self.t1 = buf.n_frames
        g.add_neighborhood_factors(0, self.t1, r=1 if self.seq_init else 3)
        for _ in range(8):
            g.update(t0=1, use_inactive=True, fixed_motion=self.has_init_pose)
        if not self.seq_init:
            g.add_proximity_factors(0, 0, rad=2, nms=2, thresh=self.frontend_thresh,
                                    remove=False)
            for _ in range(8):
                g.update(t0=1, use_inactive=True, fixed_motion=self.has_init_pose)
        t1 = self.t1
        if not self.has_init_pose:
            p1, p2 = buf.poses[t1 - 2], buf.poses[t1 - 1]
            w = lie.se3_log(lie.se3_mul(p2, lie.se3_inv(p1))) * 0.5
            buf.poses[t1] = lie.se3_mul(lie.se3_exp(w), p2)
        self._disp_init(t1 - 4, t1)
        self.is_initialized = True
        g.rm_factors(g.ii < self.warmup - 4, store=True)
        self._submit_distance()

    def run(self):
        if not self.is_initialized and self.buffer.n_frames == self.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.buffer.n_frames:
            self._update()
