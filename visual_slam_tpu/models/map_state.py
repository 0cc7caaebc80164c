"""SLAM map as fixed-capacity structure-of-arrays state.

Replacement for the reference's dict-of-objects data model —
`Map` (src/v2/map.py:6-131), `Frame` (src/v2/frame.py:51-125), `Point`
(src/v2/point.py:4-59). Dynamic dicts (`frames = {id: Frame}`,
`points_3d = {id: Point}`, per-point `frames = {frame_id: (frame, uv,
desc)}`) become preallocated arrays + validity masks; covisibility queries
(`GetPointsVisibleToFrames` map.py:17-24, `GetImagePointsWithFrameID`
map.py:28-44) become masked scans of a flat observation table; culling
(`DiscardOutlierMapPoints` map.py:124-131) becomes a masked write.

This class is host-side bookkeeping (NumPy): insertions and culls happen a
few times per keyframe, not per pixel. The heavy math consumes fixed-shape
device views via `to_ba_problem()` / `local_snapshot()`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from . import ba as ba_mod


@dataclass
class MapConfig:
    """Fixed capacities (compile-time shapes). Sized for a full ICL-NUIM
    sequence (~60 keyframes x ~400 observations); BA cost scales with these,
    so keep them close to the workload."""

    max_keyframes: int = 64
    max_points: int = 8192
    max_observations: int = 32768
    track_capacity: int = 2048  # local-snapshot padding (points per keyframe)


class SlamMap:
    """Keyframes + landmarks + observation table with fixed capacities."""

    def __init__(self, config: MapConfig | None = None):
        c = self.config = config or MapConfig()
        K, P, O = c.max_keyframes, c.max_points, c.max_observations
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))  # world->cam
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_frame_idx = np.full(K, -1, np.int64)  # source frame number
        # ||t_rel|| to the previous keyframe, captured at insertion time —
        # the scale-edge measurement (≙ AddScalingEdge, LocalBA.py:115-131).
        self.kf_scale_meas = np.zeros(K, np.float32)
        self.pt_xyz = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 8), np.uint32)  # latest descriptor
        self.pt_valid = np.zeros(P, bool)
        self.pt_views = np.zeros(P, np.int32)
        self.obs_cam = np.zeros(O, np.int32)
        self.obs_pt = np.zeros(O, np.int32)
        self.obs_uv = np.zeros((O, 2), np.float32)
        # Measured metric depth at the observation (RGB-D mode; 0 = none).
        # The reference loads depth images but never uses them (SURVEY.md
        # §2.1 #4) — this feeds the inverse-depth BA residual it lacks.
        self.obs_depth = np.zeros(O, np.float32)
        self.obs_valid = np.zeros(O, bool)
        self.n_kf = 0
        self.n_pt = 0
        self.n_obs = 0

    # -- insertion (≙ Map.AddFrame/AddParentAndPose map.py:9-14,114-118,
    #    Map.AddPoint3D map.py:74-80, Point.AddFrame point.py:25-26) --

    def _grow_keyframes(self) -> None:
        """Double keyframe capacity. Capacities are compile-time shapes for
        the BA problem, so growth costs one fresh XLA compile of the BA
        bucket — vs. the alternative of crashing mid-sequence (the round-2
        review flagged the RuntimeError walls as reachable on long runs)."""
        K = self.config.max_keyframes
        self.kf_R = np.concatenate(
            [self.kf_R, np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))]
        )
        self.kf_t = np.concatenate([self.kf_t, np.zeros((K, 3), np.float32)])
        self.kf_valid = np.concatenate([self.kf_valid, np.zeros(K, bool)])
        self.kf_frame_idx = np.concatenate(
            [self.kf_frame_idx, np.full(K, -1, np.int64)]
        )
        self.kf_scale_meas = np.concatenate(
            [self.kf_scale_meas, np.zeros(K, np.float32)]
        )
        self.config.max_keyframes = 2 * K

    def _grow_points(self) -> None:
        P = self.config.max_points
        self.pt_xyz = np.concatenate([self.pt_xyz, np.zeros((P, 3), np.float32)])
        self.pt_desc = np.concatenate([self.pt_desc, np.zeros((P, 8), np.uint32)])
        self.pt_valid = np.concatenate([self.pt_valid, np.zeros(P, bool)])
        self.pt_views = np.concatenate([self.pt_views, np.zeros(P, np.int32)])
        self.config.max_points = 2 * P

    def _grow_observations(self) -> None:
        O = self.config.max_observations
        self.obs_cam = np.concatenate([self.obs_cam, np.zeros(O, np.int32)])
        self.obs_pt = np.concatenate([self.obs_pt, np.zeros(O, np.int32)])
        self.obs_uv = np.concatenate([self.obs_uv, np.zeros((O, 2), np.float32)])
        self.obs_depth = np.concatenate([self.obs_depth, np.zeros(O, np.float32)])
        self.obs_valid = np.concatenate([self.obs_valid, np.zeros(O, bool)])
        self.config.max_observations = 2 * O

    def add_keyframe(self, R_cw: np.ndarray, t_cw: np.ndarray, frame_idx: int) -> int:
        k = self.n_kf
        if k >= self.config.max_keyframes:
            self._grow_keyframes()
        self.kf_R[k] = R_cw
        self.kf_t[k] = t_cw
        self.kf_valid[k] = True
        self.kf_frame_idx[k] = frame_idx
        if k > 0:
            R_rel = self.kf_R[k] @ self.kf_R[k - 1].T
            t_rel = self.kf_t[k] - R_rel @ self.kf_t[k - 1]
            self.kf_scale_meas[k] = np.linalg.norm(t_rel)
        self.n_kf += 1
        return k

    def add_points(self, xyz: np.ndarray, desc: np.ndarray) -> np.ndarray:
        """Insert N landmarks; returns their slot ids."""
        n = len(xyz)
        while self.n_pt + n > self.config.max_points:
            self._grow_points()
        ids = np.arange(self.n_pt, self.n_pt + n)
        self.pt_xyz[ids] = xyz
        self.pt_desc[ids] = desc
        self.pt_valid[ids] = True
        self.n_pt += n
        return ids

    def add_observations(
        self,
        kf_id: int,
        pt_ids: np.ndarray,
        uvs: np.ndarray,
        desc: np.ndarray | None = None,
        depth: np.ndarray | None = None,
    ) -> None:
        """≙ Map.AddPointToFrameCorrespondences (map.py:120-122).

        `depth`: optional (N,) measured metric depth per observation
        (<=0 = no measurement) for the RGB-D inverse-depth BA residual.
        """
        n = len(pt_ids)
        while self.n_obs + n > self.config.max_observations:
            self._grow_observations()
        sl = slice(self.n_obs, self.n_obs + n)
        self.obs_cam[sl] = kf_id
        self.obs_pt[sl] = pt_ids
        self.obs_uv[sl] = uvs
        if depth is not None:
            self.obs_depth[sl] = depth
        self.obs_valid[sl] = True
        self.pt_views[pt_ids] += 1
        if desc is not None:
            self.pt_desc[pt_ids] = desc  # keep the freshest descriptor
        self.n_obs += n

    # -- queries --

    def points_seen_by(self, kf_id: int):
        """(pt_ids, uvs) of valid landmarks observed by a keyframe.

        ≙ Map.GetImagePointsWithFrameID (map.py:28-44).
        """
        m = self.obs_valid & (self.obs_cam == kf_id) & self.pt_valid[self.obs_pt]
        return self.obs_pt[m], self.obs_uv[m]

    def local_snapshot(self, kf_id: int):
        """Fixed-shape tracking view of the landmarks a keyframe sees.

        ≙ the local-map rebuild at a new keyframe (src/v2/main.py:336-345 +
        map.py:60-69): arrays padded to `track_capacity` with a validity
        mask, ready to feed the jitted tracking step.

        Returns dict of jnp arrays: xyz (M,3), desc (M,8), uv (M,2),
        pt_ids (M,), valid (M,).
        """
        ids, uvs = self.points_seen_by(kf_id)
        M = self.config.track_capacity
        n = min(len(ids), M)
        xyz = np.zeros((M, 3), np.float32)
        desc = np.zeros((M, 8), np.uint32)
        uv = np.zeros((M, 2), np.float32)
        pid = np.zeros(M, np.int32)
        valid = np.zeros(M, bool)
        xyz[:n] = self.pt_xyz[ids[:n]]
        desc[:n] = self.pt_desc[ids[:n]]
        uv[:n] = uvs[:n]
        pid[:n] = ids[:n]
        valid[:n] = True
        return dict(
            xyz=jnp.asarray(xyz),
            desc=jnp.asarray(desc),
            uv=jnp.asarray(uv),
            pt_ids=jnp.asarray(pid),
            valid=jnp.asarray(valid),
            n_valid=n,  # host-side count: reading it must not cost a fetch
            pt_ids_np=pid,  # host copy: reading it must not cost a fetch
            uv_np=uv,  # host copy (viewer match overlay; no fetch)
        )

    def global_snapshot(self):
        """Fixed-shape view of the globally best-observed landmarks (for
        relocalization): same layout as `local_snapshot`, points ranked by
        observation count."""
        M = self.config.track_capacity
        valid_ids = np.where(self.pt_valid)[0]
        order = np.argsort(-self.pt_views[valid_ids])
        ids = valid_ids[order][:M]
        n = len(ids)
        xyz = np.zeros((M, 3), np.float32)
        desc = np.zeros((M, 8), np.uint32)
        pid = np.zeros(M, np.int32)
        valid = np.zeros(M, bool)
        xyz[:n] = self.pt_xyz[ids]
        desc[:n] = self.pt_desc[ids]
        pid[:n] = ids
        valid[:n] = True
        return dict(
            xyz=jnp.asarray(xyz),
            desc=jnp.asarray(desc),
            uv=jnp.zeros((M, 2), jnp.float32),
            pt_ids=jnp.asarray(pid),
            valid=jnp.asarray(valid),
            n_valid=n,
            pt_ids_np=pid,
            uv_np=np.zeros((M, 2), np.float32),
        )

    def refresh_scale_meas(self) -> None:
        """Re-capture scale-edge measurements from the current poses.

        Must be called after any gauge change (median-depth normalization
        divides every translation): stale measurements would make the next
        BA fight the new gauge and warp the map.
        """
        for k in range(1, self.n_kf):
            R_rel = self.kf_R[k] @ self.kf_R[k - 1].T
            t_rel = self.kf_t[k] - R_rel @ self.kf_t[k - 1]
            self.kf_scale_meas[k] = np.linalg.norm(t_rel)

    def cull_points(self, min_views: int = 3) -> int:
        """Drop landmarks seen by fewer than `min_views` keyframes.

        ≙ Map.DiscardOutlierMapPoints (map.py:124-131, called every 4th
        keyframe from main.py:234-235). Returns number culled.
        """
        weak = self.pt_valid & (self.pt_views < min_views)
        self.pt_valid[weak] = False
        self.obs_valid &= ~weak[self.obs_pt]
        return int(weak.sum())

    # -- BA interface --

    def to_ba_problem(
        self,
        intr: np.ndarray,
        fix_first: bool = True,
        scale_edge_weight: float = 10.0,
        depth_weight: float = 0.0,
    ) -> ba_mod.BAProblem:
        """Device view of the full map for bundle adjustment
        (≙ the graph build in localBundleAdjustement, LocalBA.py:153-172,
        including the parent->child scale-edge chain :159-162)."""
        cam_fixed = np.zeros(self.config.max_keyframes, bool)
        cam_fixed[~self.kf_valid] = True
        if fix_first:
            cam_fixed[0] = True
        w = (
            self.obs_valid
            & self.pt_valid[self.obs_pt]
            & self.kf_valid[self.obs_cam]
        ).astype(np.float32)
        K = self.config.max_keyframes
        se_i = np.arange(K - 1, dtype=np.int32)
        se_j = se_i + 1
        se_w = (
            self.kf_valid[se_i] & self.kf_valid[se_j]
        ).astype(np.float32) * scale_edge_weight
        se_meas = self.kf_scale_meas[1:K].astype(np.float32)
        # Planar packing: observations grouped by landmark into (P, Q)
        # slots, landmarks compacted, P/Q bucketed to powers of two (each
        # recompile on this backend's remote compile service costs seconds
        # to minutes, so at most a few shape buckets per run). The mapping
        # back to this map's indexing is kept in self.ba_meta.
        prob, meta = ba_mod.make_problem(
            R=self.kf_R,
            t=self.kf_t,
            X=self.pt_xyz,
            cam=self.obs_cam,
            pnt=self.obs_pt,
            uv=self.obs_uv,
            w=w,
            intr=intr,
            cam_fixed=cam_fixed,
            se_i=se_i,
            se_j=se_j,
            se_meas=se_meas,
            se_w=se_w,
            depth=self.obs_depth if depth_weight > 0 else None,
            depth_weight=depth_weight,
        )
        self.ba_meta = meta
        return prob

    def update_from_ba(self, p: ba_mod.BAProblem, meta=None) -> None:
        """Write back optimized poses/landmarks
        (≙ Map.UpdatePose/UpdatePoint3D, map.py:82-92)."""
        self.kf_R = np.array(p.R)
        self.kf_t = np.array(p.t)
        if meta is None:
            meta = self.ba_meta
        real = meta.pt_ids >= 0
        self.pt_xyz[meta.pt_ids[real]] = np.array(p.X)[real]

    def prune_obs_from_ba(self, bad_slots: np.ndarray, meta=None) -> int:
        """Invalidate map observations whose packed slot was flagged bad by
        the BA step. Returns the number pruned.

        pt_views is decremented for the pruned sightings so that
        `cull_points` compares the LIVE observation count against
        min_views — the reference's semantics (Point.GetNVisibleFrames,
        point.py:58-59, counts current observations, not lifetime ones)."""
        if meta is None:
            meta = self.ba_meta
        sel = bad_slots[: len(meta.slot_obs)] & (meta.slot_obs >= 0)
        rows = meta.slot_obs[sel]
        if len(rows) == 0:
            return 0
        # Guard against double-pruning (a slot can be flagged again if the
        # same problem meta is replayed): only live rows decrement views.
        rows = rows[self.obs_valid[rows]]
        if len(rows) == 0:
            return 0
        self.obs_valid[rows] = False
        np.subtract.at(self.pt_views, self.obs_pt[rows], 1)
        return len(rows)

    def compact_observations(self, min_dead_fraction: float = 0.25) -> int:
        """Rewrite the observation table without its dead rows.

        Pruned observations otherwise stay as zero-weight dead weight in
        every future BA pack (n_obs is monotonic). Call only at a safe
        point: row indices recorded in any in-flight ba_meta become stale.
        Returns the number of rows reclaimed (0 when below the threshold).
        """
        n = self.n_obs
        dead = n - int(self.obs_valid[:n].sum())
        if n == 0 or dead < min_dead_fraction * n:
            return 0
        keep = np.where(self.obs_valid[:n])[0]
        m = len(keep)
        for name in ("obs_cam", "obs_pt", "obs_uv", "obs_depth", "obs_valid"):
            a = getattr(self, name)
            a[:m] = a[keep]
            a[m:n] = 0
        self.n_obs = m
        return n - m
