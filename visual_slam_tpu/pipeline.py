"""End-to-end SLAM pipeline: initialization, PnP tracking, keyframing,
mapping, and bundle adjustment.

Accelerator re-architecture of the reference driver `src/v2/main.py:53-353`:
the same stage semantics and gates (SURVEY.md §3.1-3.4), but every per-frame
computation is a fixed-shape jitted function; the host loop only does
bookkeeping and keyframe-rate map management.

Stage map (reference -> here):
  map init (main.py:88-148)        -> Slam._try_initialize
  tracking loop (main.py:173-221)  -> Slam._track  (jitted _track_step)
  keyframe branch (main.py:221-345)-> Slam._insert_keyframe
  local BA (LocalBA.py:143-190)    -> models.ba.optimize via map.to_ba_problem
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .config import SlamConfig
from .models import ba as ba_mod
from .models import frontend
from .models import loop_closure as lc_mod
from .models.map_state import SlamMap
from .ops import lie, match, pnp, projection, triangulate, twoview
from .utils.profiling import StageTimers


def pose_graph_mod():
    """Lazy import: pose_graph is only needed at loop closures / sequence end."""
    from .models import pose_graph

    return pose_graph


@dataclass
class FrameResult:
    frame_idx: int
    R_cw: np.ndarray
    t_cw: np.ndarray
    n_tracked: int
    is_keyframe: bool
    # Keyframe the frame tracked against (-1 before init). Pose-graph
    # corrections move non-keyframe poses through this anchor: the frame's
    # pose RELATIVE to its reference keyframe is correction-invariant.
    ref_kf: int = -1


# ---------------------------------------------------------------- blob packing
#
# Each tracking step packs EVERYTHING the host could ever need for that
# frame — pose scalars, PnP inliers, match indices, and the frame's full
# feature arrays (any frame can become a keyframe) — into ONE flat f32 blob,
# so a frame costs one device->host copy however many fields it carries.
#
# Layout (M = snapshot track capacity, K = max features):
#   [0:16]                 header: R(9), t(3), n_inliers, is_kf, fail, pad
#   [16       : 16+M]      PnP inlier mask over snapshot slots (0/1)
#   [16+M     : 16+2M]     best-match feature index per snapshot slot
#   [16+2M    : 16+2M+2K]  feature uv (K,2 flattened)
#   [16+2M+2K : 16+2M+3K]  feature validity (0/1)
#   [16+2M+3K : 16+2M+11K] packed 256-bit descriptors, bitcast u32->f32

_BLOB_HEADER = 16


def _pack_blob(header, inliers, idx2, uv, valid, desc):
    """Device-side: flatten one frame's outputs into a single f32 vector."""
    return jnp.concatenate(
        [
            header.astype(jnp.float32),
            inliers.astype(jnp.float32),
            idx2.astype(jnp.float32),  # exact: indices < 2^24
            uv.reshape(-1).astype(jnp.float32),
            valid.astype(jnp.float32),
            jax.lax.bitcast_convert_type(desc, jnp.float32).reshape(-1),
        ]
    )


def _unpack_blob(row: np.ndarray, M: int, K: int):
    """Host-side inverse of _pack_blob for one fetched (TOT,) f32 row.

    Returns (inliers bool (M,), idx2 int32 (M,), host Features). The
    Features' score slot is zero-filled — nothing downstream of extraction
    consumes per-feature scores.
    """
    o = _BLOB_HEADER
    inl = row[o : o + M] > 0.5
    o += M
    idx2 = row[o : o + M].astype(np.int32)
    o += M
    uv = row[o : o + 2 * K].reshape(K, 2).copy()
    o += 2 * K
    valid = row[o : o + K] > 0.5
    o += K
    desc = np.ascontiguousarray(row[o : o + 8 * K]).view(np.uint32).reshape(K, 8)
    feats = frontend.Features(
        uv=uv, desc=desc, score=np.zeros(K, np.float32), valid=valid
    )
    return inl, idx2, feats


@partial(jax.jit, static_argnames=("n_hyps", "refine_iters", "cross_check"))
def _track_step(
    feats_desc,
    feats_uv,
    feats_valid,
    snap_desc,
    snap_xyz,
    snap_valid,
    prev_R,
    prev_t,
    intr,
    key,
    ratio,
    max_hamming,
    threshold_px,
    n_hyps: int,
    refine_iters: int,
    cross_check: bool = True,
):
    """One tracking step: match local map -> PnP-RANSAC -> GN refine.

    ≙ main.py:180-214 (match_features + solvePnPRansac with extrinsic guess
    + motionOnlyBundleAdjustement for the current frame).
    Returns (blob, R, t): the blob (see _pack_blob) is the single host-fetch
    payload; R/t are device arrays so the next frame's dispatch can seed its
    PnP from them without any host round trip (on-device pose threading —
    the key to running the loop at device rate).
    """
    idx2, dist, good = match.match_ratio_test(
        snap_desc, feats_desc, snap_valid, feats_valid, ratio=ratio,
        max_distance=max_hamming, cross_check=cross_check,
    )
    uv_cur = feats_uv[idx2]
    R, t, inliers, n_in = pnp.solve_pnp_tracked(
        key,
        snap_xyz,
        uv_cur,
        intr,
        good,
        guess_R=prev_R,
        guess_t=prev_t,
        n_hyps=n_hyps,
        threshold_px=threshold_px,
        refine_iters=refine_iters,
    )
    header = jnp.concatenate(
        [
            R.reshape(9),
            t,
            n_in[None].astype(R.dtype),
            jnp.zeros(3, R.dtype),
        ]
    )
    blob = _pack_blob(header, inliers, idx2, feats_uv, feats_valid, feats_desc)
    return blob, R, t


@partial(
    jax.jit,
    static_argnames=(
        "window", "max_features", "quality_level", "nms_radius",
        "n_hyps", "refine_iters", "cross_check", "min_track_pts",
        "xla_frontend",
    ),
)
def _track_window(
    grays,          # (W,H,Wd) uint8 or float32 — a whole window of frames
    snap_desc,
    snap_xyz,
    snap_valid,
    prev_R,
    prev_t,
    intr,
    keys,           # (W,2) PRNG keys, one per frame
    ratio,
    max_hamming,
    threshold_px,
    *,
    window: int,
    max_features: int,
    quality_level: float,
    nms_radius: int,
    n_hyps: int,
    refine_iters: int,
    cross_check: bool,
    min_track_pts: int,
    xla_frontend: bool = False,
):
    """A WINDOW of tracking steps as ONE device dispatch.

    The per-frame loop (extract -> match -> tiered PnP, ≙ main.py:173-214)
    runs as a lax.scan over the stacked frames with the pose threaded
    through the carry. The host fetches one (W, TOT) packed array per
    window instead of one per frame, cutting host<->device synchronizations
    ~W-fold.

    The keyframe rule (main.py:221) is evaluated by the HOST while walking
    the fetched rows (_walk_window): the host sees every row's inlier count
    anyway, host evaluation keeps one copy of the rule, and it frees the
    scan from carrying since-keyframe counters across windows. The pose
    carry is RETURNED as device arrays so the next window chains on device
    without any host round trip.

    Frames transfer as raw uint8 (grayscale conversion/normalization happens
    in the scan): 1/4 the H2D bytes of float32.

    Returns (blobs (W, TOT), R_last, t_last) — blobs is ONE array, ONE
    fetch; (R_last, t_last) seed the next window's dispatch.
    """

    def step(carry, inp):
        pR, pt = carry
        img, key = inp
        gray = frontend.to_gray(img)
        if xla_frontend:  # frontend.FRONTEND_BACKEND == "xla"
            feats = frontend.extract_fused(
                gray, max_features, quality_level, nms_radius
            )
        else:
            feats = frontend._extract_stencil_fused(
                gray, max_features, quality_level, nms_radius
            )
        idx2, dist, good = match.match_ratio_test(
            snap_desc, feats.desc, snap_valid, feats.valid, ratio=ratio,
            max_distance=max_hamming, cross_check=cross_check,
        )
        R, t, inliers, n_in = pnp.solve_pnp_tracked(
            key, snap_xyz, feats.uv[idx2], intr, good,
            guess_R=pR, guess_t=pt,
            n_hyps=n_hyps, threshold_px=threshold_px,
            refine_iters=refine_iters,
        )
        fail = n_in < min_track_pts
        # On failure hold the previous pose (the host relocalizes).
        Rn = jnp.where(fail, pR, R)
        tn = jnp.where(fail, pt, t)
        header = jnp.concatenate(
            [
                Rn.reshape(9),
                tn,
                n_in[None].astype(jnp.float32),
                jnp.zeros(1, jnp.float32),  # keyframe rule is host-side now
                fail[None].astype(jnp.float32),
                jnp.zeros(1, jnp.float32),
            ]
        )
        blob = _pack_blob(header, inliers, idx2, feats.uv, feats.valid,
                          feats.desc)
        return (Rn, tn), blob

    (R_last, t_last), blobs = jax.lax.scan(
        step, (prev_R, prev_t), (grays, keys), length=window
    )
    return blobs, R_last, t_last


@partial(
    jax.jit,
    static_argnames=(
        "window", "max_features", "quality_level", "nms_radius",
        "cross_check", "xla_frontend",
    ),
)
def _init_scan_window(
    grays,          # (W,H,Wd) uint8 or float32
    f0_desc,
    f0_uv,
    f0_valid,
    ratio,
    max_hamming,
    *,
    window: int,
    max_features: int,
    quality_level: float,
    nms_radius: int,
    cross_check: bool,
    xla_frontend: bool = False,
):
    """Cheap init-phase pre-screen for a WINDOW of frames in ONE dispatch.

    For each frame: extract, match against the ANCHOR frame's features, and
    report (match count, median flow magnitude of the matches) — the host
    then runs the expensive full init attempt (_init_step: 512-hypothesis
    essential RANSAC + cheirality + parallax) only on the most promising
    frame per window. Rationale: the reference runs its full init pipeline
    every frame (main.py:88-138) because OpenCV calls are cheap on host;
    here every per-frame attempt costs a device sync, and the binding
    accept gate (validFraction >= 0.9, main.py:113-114) is
    impossible at near-zero flow — measured on lr traj3: validFraction
    reaches 0.36 only at ~87 px median flow, so frames under a
    conservative flow floor cannot pass and need no attempt.

    Returns (W, 2) float32: [n_matches, median_flow_px] per frame.
    """

    def step(carry, img):
        gray = frontend.to_gray(img)
        if xla_frontend:  # see _track_window
            feats = frontend.extract_fused(
                gray, max_features, quality_level, nms_radius
            )
        else:
            feats = frontend._extract_stencil_fused(
                gray, max_features, quality_level, nms_radius
            )
        idx2, dist, good = match.match_ratio_test(
            f0_desc, feats.desc, f0_valid, feats.valid, ratio=ratio,
            max_distance=max_hamming, cross_check=cross_check,
        )
        flow = feats.uv[idx2] - f0_uv
        mag = jnp.sqrt(jnp.sum(flow * flow, axis=-1) + 1e-12)
        mag = jnp.where(good, mag, jnp.inf)
        n_match = jnp.sum(good)
        mag_sorted = jnp.sort(mag)
        med = mag_sorted[(jnp.maximum(n_match, 1) - 1) // 2]
        return carry, jnp.stack([n_match.astype(jnp.float32), med])

    _, scal = jax.lax.scan(step, None, grays, length=window)
    return scal  # (W, 2)


@partial(
    jax.jit,
    static_argnames=("n_hyps", "model_selection", "cross_check", "min_flow_px"),
)
def _init_step(
    f0_desc,
    f0_uv,
    f0_valid,
    f1_desc,
    f1_uv,
    f1_valid,
    intr,
    key,
    ratio,
    max_hamming,
    ess_threshold,
    distance_thresh,
    n_hyps: int,
    model_selection: bool = False,
    cross_check: bool = True,
    min_flow_px: float = 0.0,
):
    """Two-view initialization attempt as ONE jitted computation.

    ≙ the per-frame body of the reference init loop (main.py:96-114):
    match -> essential RANSAC -> cheirality pose recovery. Gates are
    evaluated by the host on the returned scalars. Keeping this fused in a
    single jit avoids dispatching the init body's hundreds of ops one by
    one.

    min_flow_px > 0 puts the expensive geometry (the n_hyps-hypothesis
    essential RANSAC + cheirality recovery) under lax.cond on the median
    match flow: below the floor the validFraction accept gate is
    physically unreachable (measured on lr traj3: validFraction 0.36 at
    ~87 px median flow; the gate needs 0.9), so the ~60 near-static frames
    the init search must sit through cost one descriptor match each
    instead of a full RANSAC (VERDICT r3 next #8 — the init phase was a
    silent third of the 200-frame bench).
    """
    idx2, dist, good = match.match_ratio_test(
        f0_desc, f1_desc, f0_valid, f1_valid, ratio=ratio,
        max_distance=max_hamming, cross_check=cross_check,
    )
    uv1 = f0_uv
    uv2 = f1_uv[idx2]
    flow = uv2 - uv1
    mag = jnp.sqrt(jnp.sum(flow * flow, axis=-1) + 1e-12)
    mag_sorted = jnp.sort(jnp.where(good, mag, jnp.inf))
    nm = jnp.maximum(jnp.sum(good), 1)
    flow_med = mag_sorted[(nm - 1) // 2]

    def heavy(_):
        if model_selection:
            # Homography-vs-essential selection (v1 slam_test.py:207-218).
            R, t, X1, cheir, frac, _ = twoview.estimate_relative_pose_auto(
                key, uv1, uv2, intr, good, distance_thresh=distance_thresh
            )
        else:
            E, inl, n_in = twoview.estimate_essential_ransac(
                key, uv1, uv2, intr, good, threshold=ess_threshold,
                n_hyps=n_hyps,
            )
            R, t, X1, cheir, frac = twoview.estimate_relative_pose(
                E, uv1, uv2, intr, inl, distance_thresh
            )
        return R, t, X1, cheir, frac

    def trivial(_):
        K = uv1.shape[0]
        return (
            jnp.eye(3, dtype=uv1.dtype),
            jnp.zeros(3, uv1.dtype),
            jnp.zeros((K, 3), uv1.dtype),
            jnp.zeros(K, bool),
            jnp.float32(-1.0),  # frac = -1 marks "skipped by flow floor"
        )

    if min_flow_px > 0:
        R, t, X1, cheir, frac = jax.lax.cond(
            flow_med >= min_flow_px, heavy, trivial, None
        )
    else:
        R, t, X1, cheir, frac = heavy(None)
    n_matches = jnp.sum(good)
    # Median triangulation parallax of the cheirality-good points (degrees).
    # A low-parallax pair can pass the validFraction gate by luck of the
    # cheirality vote; poor baselines make degenerate maps, so the host also
    # gates on this (the reference has no such gate and in practice relies
    # on validFraction noise — an accuracy hazard this framework closes).
    C2 = -jnp.einsum("ji,j->i", R, t)  # cam-2 centre in cam-1 frame
    r1 = X1 / (jnp.linalg.norm(X1, axis=-1, keepdims=True) + 1e-12)
    v2 = X1 - C2[None, :]
    r2 = v2 / (jnp.linalg.norm(v2, axis=-1, keepdims=True) + 1e-12)
    cosang = jnp.clip(jnp.sum(r1 * r2, axis=-1), -1.0, 1.0)
    ang = jnp.degrees(jnp.arccos(cosang))
    ang_sorted = jnp.sort(jnp.where(cheir, ang, jnp.inf))
    n_good = jnp.maximum(jnp.sum(cheir), 1)
    parallax_med = ang_sorted[(n_good - 1) // 2]
    scalars = jnp.stack(
        [n_matches.astype(jnp.float32), frac.astype(jnp.float32), parallax_med]
    )
    # ONE flat f32 blob per attempt (a single async device->host copy; the
    # init phase runs one attempt per frame). Layout:
    # [scalars(3) | R(9) | t(3) | idx2(K) | cheir(K) | X1(3K) |
    #  f1_uv(2K) | f1_valid(K) | f1_desc(8K)]
    return jnp.concatenate(
        [
            scalars,
            R.reshape(9),
            t,
            idx2.astype(jnp.float32),
            cheir.astype(jnp.float32),
            X1.reshape(-1).astype(jnp.float32),
            f1_uv.reshape(-1).astype(jnp.float32),
            f1_valid.astype(jnp.float32),
            jax.lax.bitcast_convert_type(f1_desc, jnp.float32).reshape(-1),
        ]
    )


def _unpack_init_blob(row: np.ndarray, K: int):
    """(scalars (3,), R (3,3), t (3,), idx2 int32 (K,), cheir bool (K,),
    X1 (K,3), f1 host Features)."""
    scalars = row[:3]
    R = row[3:12].reshape(3, 3).copy()
    t = row[12:15].copy()
    o = 15
    idx2 = row[o : o + K].astype(np.int32)
    o += K
    cheir = row[o : o + K] > 0.5
    o += K
    X1 = row[o : o + 3 * K].reshape(K, 3).copy()
    o += 3 * K
    uv = row[o : o + 2 * K].reshape(K, 2).copy()
    o += 2 * K
    valid = row[o : o + K] > 0.5
    o += K
    desc = np.ascontiguousarray(row[o : o + 8 * K]).view(np.uint32).reshape(K, 8)
    feats = frontend.Features(
        uv=uv, desc=desc, score=np.zeros(K, np.float32), valid=valid
    )
    return scalars, R, t, idx2, cheir, X1, feats


@partial(jax.jit, static_argnames=("cross_check",))
def _mine_step(
    prev_desc,
    prev_uv,
    prev_avail,
    cur_desc,
    cur_uv,
    cur_valid,
    R1,
    t1,
    R2,
    t2,
    intr,
    ratio,
    max_hamming,
    reproj_thresh_px,
    max_depth,
    min_parallax_deg,
    cross_check: bool = True,
):
    """New-landmark mining between two keyframes as one jitted computation.

    ≙ main.py:237-309: match unmapped features, DLT-triangulate, gate by
    cheirality/depth/reprojection — plus the parallax gate of the
    reference's validated `triangulation` helper (helper_functions.py:211-267,
    min_parallax): low-parallax points carry huge depth uncertainty and
    pollute long-run BA. Returns ONE flat f32 blob
    [idx2 (K) | keep (K) | keep_loose (K) | X (3K)] — a single fetch.
    """
    idx2, dist, good = match.match_ratio_test(
        prev_desc, cur_desc, prev_avail, cur_valid, ratio=ratio,
        max_distance=max_hamming, cross_check=cross_check,
    )
    T1 = lie.make_T(R1, t1)
    T2 = lie.make_T(R2, t2)
    P1 = projection.projection_matrix(T1, intr)
    P2 = projection.projection_matrix(T2, intr)
    uv1 = prev_uv
    uv2 = cur_uv[idx2]
    Xh = triangulate.triangulate_dlt(P1, P2, uv1, uv2)
    X = triangulate.dehomogenize(Xh)
    pr1, z1 = projection.project(R1, t1, X, intr)
    pr2, z2 = projection.project(R2, t2, X, intr)
    reproj_ok = (
        jnp.sum((pr1 - uv1) ** 2, -1) < reproj_thresh_px**2
    ) & (jnp.sum((pr2 - uv2) ** 2, -1) < reproj_thresh_px**2)
    depth_ok = (z1 > 0) & (z2 > 0) & (z1 < max_depth) & (z2 < max_depth)
    # Parallax gate (≙ helper_functions.py:243-252 min_parallax check):
    # angle between the two viewing rays at the triangulated point.
    C1 = -jnp.einsum("ji,j->i", R1, t1)
    C2 = -jnp.einsum("ji,j->i", R2, t2)
    r1 = X - C1[None, :]
    r2 = X - C2[None, :]
    r1 = r1 / (jnp.linalg.norm(r1, axis=-1, keepdims=True) + 1e-12)
    r2 = r2 / (jnp.linalg.norm(r2, axis=-1, keepdims=True) + 1e-12)
    cosang = jnp.clip(jnp.sum(r1 * r2, axis=-1), -1.0, 1.0)
    parallax_ok = jnp.degrees(jnp.arccos(cosang)) >= min_parallax_deg
    keep_loose = good & reproj_ok & depth_ok
    keep = keep_loose & parallax_ok
    # Both masks go back to the host: the strict gate improves short-run BA
    # (low-parallax points carry huge depth uncertainty) but in low-motion
    # segments it can mine ZERO points, starving the tracking snapshot into
    # a keyframe-every-frame death spiral (measured: ATE 0.28 + 59 tracking
    # failures over 600 frames gated vs 0.037 + 0 ungated). The caller falls
    # back to keep_loose when the strict yield is below a floor.
    return jnp.concatenate(
        [
            idx2.astype(jnp.float32),
            keep.astype(jnp.float32),
            keep_loose.astype(jnp.float32),
            X.reshape(-1).astype(jnp.float32),
        ]
    )


def _unpack_mine_blob(row: np.ndarray, K: int):
    """(idx2 int32 (K,), keep bool (K,), keep_loose bool (K,), X (K,3))."""
    idx2 = row[:K].astype(np.int32)
    keep = row[K : 2 * K] > 0.5
    keep_loose = row[2 * K : 3 * K] > 0.5
    X = row[3 * K : 6 * K].reshape(K, 3).copy()
    return idx2, keep, keep_loose, X


@partial(jax.jit, static_argnames=("n_iters", "cg_iters", "solver", "use_depth"))
def _ba_step(prob, n_iters: int, cg_iters: int, solver: str = "chol",
             use_depth: bool = False):
    """optimize + diagnostics in ONE computation: returns (optimized problem,
    diag [cost_before, cost_after, blown_fraction], bad-observation mask)."""
    cost_before = ba_mod._cost(prob, use_depth=use_depth)
    out, cost_after = ba_mod.optimize(
        prob, n_iters=n_iters, cg_iters=cg_iters, solver=solver,
        use_depth=use_depth,
    )
    err, w = ba_mod.reproj_errors(out)
    bad = (err > 3.0 * ba_mod.HUBER_DELTA) & (w > 0)
    n_obs = jnp.maximum(jnp.sum(w), 1.0)
    blown = jnp.sum(bad.astype(w.dtype) * w) / n_obs
    diag = jnp.stack([cost_before, cost_after, blown])
    # Bit-packed bad mask: the (N,) planar mask is mostly padding at big
    # map sizes (N = P*Q slots for ~0.15*N live obs) and its fetch rode
    # every BA consume — N/8 bytes instead of N (unpacked host-side in
    # _consume_pending_ba).
    return out, diag, jnp.packbits(bad)


def _fetch_async(*arrays) -> None:
    """Start device->host copies without blocking (no-op if unsupported).

    A copy started at dispatch time completes in the background, so the
    later np.asarray() finds the result already on the host."""
    for a in arrays:
        try:
            a.copy_to_host_async()
        except AttributeError:
            pass


def _spin_ready(arrays, timeout_s: float = 30.0) -> None:
    """Spin on is_ready so the blocking np.asarray that follows finds the
    results already landed (the blocking path polls for completion with a
    backoff, which can oversleep a long-finished result). Bounded: a
    wedged device program must not hang the pipeline forever."""
    import time as _time

    deadline = _time.perf_counter() + timeout_s
    for a in arrays:
        try:
            while not a.is_ready() and _time.perf_counter() < deadline:
                _time.sleep(0.001)
        except AttributeError:
            break


def _fetch_now(*arrays):
    """Fetch device arrays to host together.

    Issue the async copies together, spin on is_ready, then read: a bare
    np.asarray() per array would wait for each copy in turn.
    """
    _fetch_async(*arrays)
    _spin_ready(arrays, timeout_s=5.0)
    return [np.asarray(a) for a in arrays]


def _backproject_depth(uv: np.ndarray, depth: np.ndarray, intr: np.ndarray):
    """Backproject pixels through a metric depth map (camera frame).

    Returns (X (N,3) camera-frame points, ok (N,) valid-depth mask).
    Depth scale handling mirrors the TUM/ICL 16-bit convention already
    applied by the dataset reader (utils/dataset.py DEPTH_SCALE).
    """
    h, w = depth.shape
    xi = np.clip(uv[:, 0].astype(np.int32), 0, w - 1)
    yi = np.clip(uv[:, 1].astype(np.int32), 0, h - 1)
    z = depth[yi, xi]
    ok = (z > 0.05) & (z < 20.0)
    fx, fy, cx, cy = intr
    X = np.stack(
        [(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], axis=-1
    )
    return X.astype(np.float32), ok


def _sample_depth(uv: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Measured metric depth at pixel locations; 0 where invalid/out of range
    (feeds the RGB-D inverse-depth BA residual, models/ba._depth_terms)."""
    h, w = depth.shape
    xi = np.clip(uv[:, 0].astype(np.int32), 0, w - 1)
    yi = np.clip(uv[:, 1].astype(np.int32), 0, h - 1)
    z = depth[yi, xi]
    return np.where((z > 0.05) & (z < 20.0), z, 0.0).astype(np.float32)


class Slam:
    """The SLAM system. Feed frames via `process`; read `trajectory`."""

    def __init__(self, config: SlamConfig | None = None):
        self.cfg = config or SlamConfig()
        self.map = SlamMap(self.cfg.map)
        self.intr = jnp.asarray(self.cfg.intrinsics)
        self.key = jax.random.PRNGKey(self.cfg.seed)
        self.initialized = False
        self.trajectory: list[FrameResult] = []
        # init state
        self._init_feats = None
        self._init_frame_idx = None
        # Async init confirmation (run_pipelined): the candidate-pair
        # re-estimate is dispatched and consumed a fixed number of ticks
        # later instead of synchronously — a blocking confirm fetch would
        # wait out the ~40-deep init pipeline once per candidate
        # (candidates cluster once the flow gate opens). Serial/windowed
        # drivers keep the sync confirm.
        self._async_init_verify = False
        self._pending_init_verify = None
        # tracking state
        self._snapshot = None
        self._last_kf_id = None
        self._last_kf_feats = None  # full features of last keyframe
        self._last_kf_mapped = None  # bool per feature slot: already a landmark
        self._prev_R = None
        self._prev_t = None
        self._pose_dev = None  # device-side pose chain (see _dispatch_track)
        self._frames_since_kf = 0
        self._snap_epoch = 0  # bumped when keyframe insertion remaps the snapshot
        # Confirmation-veto cache: a stale-handle keyframe candidate is
        # re-tracked against the CURRENT map (one sync); when the fresh
        # rule vetoes it, the other IN-FLIGHT frames with stale handles
        # would re-confirm against the same state and re-veto (measured:
        # 163 vetoes / 600 frames). The cache suppresses re-confirms only
        # while BOTH hold: the confirmable state is unchanged (token — no
        # keyframe/mine/BA/loop since the veto) AND the candidate is
        # within a few frames of the vetoed one. The time bound is
        # LOAD-BEARING: the map decays as the camera moves, so a veto at
        # frame N says nothing about frame N+6 — an unbounded cache
        # measured ATE 0.0549 -> 0.374 on the full sequence (keyframes
        # suppressed exactly where tracking needed them).
        self._state_token = 0
        self._last_veto_token = -1
        self._last_veto_frame = -(10**9)
        self._veto_cache_frames = 3
        self._pending_ba = None  # (out, diag, bad, kf_id, scale_gauge)
        self._pending_mine = None  # deferred landmark-mining handle (dict)
        # loop closure state
        self._loop_db = lc_mod.KeyframeFeatureDB(
            self.cfg.map.max_keyframes, self.cfg.frontend.max_features
        )
        self._loop_edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self._last_loop_kf = -(10**9)
        self._pending_loop = None  # deferred place-recognition consume
        self._ba_followup = None  # keyframe needing a BA once the slot frees
        self._pending_loop_verify = None  # in-flight closure verification
        self.stats = {
            "ba_runs": 0, "keyframes": 0, "culled": 0, "init_frame": None,
            "fetch_timeouts": 0,
        }
        self.timers = StageTimers()
        # Background fetch workers for the keyframe-cadence results
        # (BA / mine / loop scores / loop verify): the blocking device->host
        # read releases the GIL, so a worker waits for the result while the
        # main thread keeps dispatching — the same pattern run_pipelined
        # uses for the per-frame track blobs. Two, because at keyframe time
        # a BA fetch and a mine fetch are routinely in flight together.
        from concurrent.futures import ThreadPoolExecutor

        self._fetch_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="slam-fetch"
        )

    def close(self):
        """Shut down the background fetch worker (ADVICE r4: the pool was
        never shut down — harmless for one Slam, thread accumulation for
        many). Idempotent; the Slam stays readable (trajectory, map,
        positions) but must not dispatch new async work."""
        self._fetch_pool.shutdown(wait=False)

    def __del__(self):  # best-effort backstop; close() is the real path
        try:
            self._fetch_pool.shutdown(wait=False)
        except Exception:
            pass

    def _bg_fetch(self, *arrays):
        """Start device->host copies and hand the blocking reads to the
        background worker. Returns a future resolving to [np.ndarray, ...];
        by apply time (2-3 frames later) it is usually already resolved,
        and the fetched values are cached on the jax arrays so any
        follow-up np.asarray on them is free."""
        _fetch_async(*arrays)
        return self._fetch_pool.submit(
            lambda arrs=arrays: [np.asarray(a) for a in arrs]
        )

    def _fetch_result(self, fut, timeout_s: float = 30.0):
        """Bounded wait on a background-fetch future: an unbounded
        fut.result() would let a wedged device program hang the pipeline.
        Returns the future's value, or None on timeout — every such drop is
        counted in stats["fetch_timeouts"], and callers treat None as a
        dropped/rejected result."""
        from concurrent.futures import TimeoutError as _FutTimeout

        try:
            return fut.result(timeout=timeout_s)
        except _FutTimeout:
            self.stats["fetch_timeouts"] += 1
            return None

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    # ------------------------------------------------------------------ init

    def process(self, frame_idx: int, gray: np.ndarray, depth: np.ndarray | None = None):
        """Process one frame: grayscale float32 (H,W) in [0,1], or RGB uint8
        (H,W,3) — the latter is converted on-device (cheaper transfer)."""
        with self.timers.time("extract"):
            # No block here: the single packed fetch in _track synchronizes
            # the frame.
            feats = frontend.extract(
                jnp.asarray(gray), self.cfg.frontend.max_features,
                self.cfg.frontend.quality_level, self.cfg.frontend.nms_radius,
            )
        if not self.initialized:
            with self.timers.time("initialize"):
                self._try_initialize(frame_idx, feats, depth)
        else:
            self._track(frame_idx, feats, depth)

    def _try_initialize(self, frame_idx, feats, depth):
        cfg = self.cfg
        if cfg.use_depth and depth is not None:
            self._initialize_rgbd(frame_idx, feats, depth)
            return
        h = self._dispatch_init(frame_idx, feats)
        if h is not None:
            self._consume_init(h)

    def _init_attempt_blob(self, f0, f1):
        cfg = self.cfg
        return _init_step(
            f0.desc, f0.uv, f0.valid,
            f1.desc, f1.uv, f1.valid,
            self.intr, self._next_key(),
            cfg.frontend.match_ratio,
            cfg.frontend.max_hamming,
            cfg.twoview.ess_threshold_factor / float(self.cfg.intrinsics[0]),
            cfg.twoview.distance_thresh,
            n_hyps=cfg.twoview.ransac_hypotheses,
            model_selection=cfg.twoview.use_model_selection,
            cross_check=cfg.frontend.cross_check,
            min_flow_px=cfg.twoview.min_flow_px,
        )

    def _dispatch_init(self, frame_idx, feats, anchor=None):
        """Dispatch one two-view init attempt without fetching (pipelining
        support — the init phase is otherwise one blocking fetch per
        frame). Returns a handle, or None for the anchor frame.

        Anchor RE-SEEDING (r5): attempts pair the anchor frame against each
        new frame; a pathological anchor (textureless view, or a segment
        whose motion relative to it never clears the flow/validFraction
        gates) previously starved init FOREVER — measured: a monocular
        sequence starting at dataset frame 200 never initialized in 600
        frames on any driver. After `reanchor_after` failed attempts the
        anchor slides to the current frame. Accept-time geometry binds the
        anchor INTO each handle, so attempts dispatched against the old
        anchor stay valid through a re-anchor."""
        cfg = self.cfg
        if anchor is not None:
            # Re-verification of a specific pair: use the attempt's bound
            # anchor (no counter tick, no anchor bookkeeping).
            f0, aidx = anchor
            blob = self._init_attempt_blob(f0, feats)
            _fetch_async(blob)
            return dict(
                frame_idx=frame_idx, feats=feats, blob=blob,
                anchor_feats=f0, anchor_idx=aidx,
            )
        if self._init_feats is None:
            self._init_feats = feats
            self._init_frame_idx = frame_idx
            self.trajectory.append(
                FrameResult(frame_idx, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0, True)
            )
            return None
        # Re-anchor on FRAME DISTANCE from the anchor, not attempt count,
        # and never while a candidate confirm is in flight: the pipelined
        # init queues ~40+ attempts past the eventual accept frame, so an
        # attempt counter crosses any threshold near the accept horizon
        # BEFORE the acceptance lands (measured: a spurious re-anchor at
        # frame ~101 on a frame-63 accept perturbed the PRNG stream and
        # the downstream run — ATE 0.074 -> 0.079, both closures lost).
        # The threshold must exceed accept-horizon (~63 frames of flow
        # accumulation) + the init pipeline's consume lag (~44 frames).
        if (
            frame_idx - self._init_frame_idx > cfg.twoview.reanchor_after
            and self._pending_init_verify is None
        ):
            # Slide the anchor to this frame. The old anchor's provisional
            # identity-pose trajectory entry is replaced by the new one.
            self._init_feats = feats
            self._init_frame_idx = frame_idx
            if self.trajectory and self.trajectory[-1].n_tracked == 0:
                self.trajectory.pop()
            self.trajectory.append(FrameResult(
                frame_idx, np.eye(3, dtype=np.float32),
                np.zeros(3, np.float32), 0, True,
            ))
            self.stats["init_reanchors"] = (
                self.stats.get("init_reanchors", 0) + 1
            )
            return None
        f0, f1 = self._init_feats, feats
        blob = self._init_attempt_blob(f0, f1)
        _fetch_async(blob)  # ONE async copy per init attempt
        return dict(
            frame_idx=frame_idx, feats=feats, blob=blob,
            # Bound at dispatch: accept-time geometry must use the anchor
            # this attempt was computed against, even after a re-anchor.
            anchor_feats=f0, anchor_idx=self._init_frame_idx,
        )

    def _consume_init(self, h, row=None) -> bool:
        """Gate + (on acceptance) build the initial map from a dispatched
        init attempt. Returns True when the system becomes initialized.
        `row`: optionally the already-fetched blob (chunk-stacked fetch
        in run_pipelined — one round trip per chunk, not per attempt)."""
        cfg = self.cfg
        frame_idx, feats = h["frame_idx"], h["feats"]
        # Anchor bound at dispatch time (see _dispatch_init re-anchoring):
        # an attempt stays valid against ITS anchor even after a re-anchor.
        f0 = h.get("anchor_feats")
        if f0 is None:
            f0 = self._init_feats
        anchor_idx = h.get("anchor_idx", self._init_frame_idx)
        if row is None:
            # ONE fetch: gates + full accept data (spin-then-read, see
            # _spin_ready).
            (row,) = _fetch_now(h["blob"])
        K = int(self.cfg.frontend.max_features)
        scalars_np, R1, t1, idx2_np, good_np, X_np, feats_host = (
            _unpack_init_blob(row, K)
        )
        n_matches = int(scalars_np[0])
        if n_matches < cfg.twoview.min_matches:  # ≙ main.py:97-98
            return False
        if scalars_np[1] < cfg.twoview.min_valid_fraction:  # ≙ main.py:113-114
            return False
        if scalars_np[2] < cfg.twoview.min_init_parallax_deg:
            return False
        if not h.get("reverified"):
            # validFraction is a HIGH-VARIANCE estimator (the RANSAC inlier
            # set jitters across seeds: measured 0.54 -> 0.96 on adjacent
            # near-identical frames), and the windowed init evaluates many
            # attempts per window — maximizing over that noise accepts
            # lucky borderline pairs (measured: a pair scoring 0.94 once
            # re-scores ~0.3, and seeding from it costs 2x the final ATE).
            # One independent re-estimate with a fresh seed must agree
            # before the pair may build the map.
            if self._async_init_verify:
                # Pipelined: dispatch the confirm and consume it at a fixed
                # tick age (_check_init_verify) — a synchronous fetch here
                # waits out the whole in-flight init queue. One confirm in
                # flight at a time; later candidates simply wait their turn
                # (candidates arrive every frame once the flow gate opens).
                if self._pending_init_verify is None:
                    h2 = self._dispatch_init(
                        frame_idx, feats, anchor=(f0, anchor_idx)
                    )
                    h2["reverified"] = True
                    h2["depth"] = h.get("depth")
                    h2["fut"] = self._bg_fetch(h2["blob"])
                    h2["age"] = 0
                    self._pending_init_verify = h2
                return False
            h2 = self._dispatch_init(frame_idx, feats, anchor=(f0, anchor_idx))
            h2["reverified"] = True
            if not self._consume_init(h2):
                self.stats["init_reverify_rejects"] = (
                    self.stats.get("init_reverify_rejects", 0) + 1
                )
                return False
            return True
        # Accepted (rare): the blob already carries everything except the
        # anchor frame's features — ONE grouped flush for those.
        uv0_np, d0_np, v0_np = _fetch_now(f0.uv, f0.desc, f0.valid)
        uv1 = uv0_np
        uv2_np = feats_host.uv[idx2_np]
        # Host Features for the new keyframe: downstream keyframe machinery
        # (mining, loop DB) reads these host-side, not with a device read
        # each.
        feats = feats_host
        # Frame0 = world origin keyframe, this frame = keyframe 1.
        R0 = np.eye(3, dtype=np.float32)
        t0 = np.zeros(3, np.float32)
        kf0 = self.map.add_keyframe(R0, t0, anchor_idx)
        kf1 = self.map.add_keyframe(R1, t1, frame_idx)
        # The provisional identity-pose trajectory entry must be the
        # ACCEPTED anchor's (a re-anchor may have replaced it since). The
        # popped entry's frame — the newer anchor, which got no init
        # handle of its own — would otherwise be a trajectory hole; it is
        # re-tracked against the fresh map after initialization below.
        orphan_idx = None
        if (
            self.trajectory
            and self.trajectory[-1].n_tracked == 0
            and self.trajectory[-1].frame_idx != anchor_idx
        ):
            orphan_idx = self.trajectory[-1].frame_idx
            orphan_feats = self._init_feats  # the replaced anchor's feats
            self.trajectory.pop()
            self.trajectory.append(FrameResult(
                anchor_idx, R0.copy(), t0.copy(), 0, True,
            ))
        sel = np.where(good_np)[0]
        pt_ids = self.map.add_points(X_np[sel], np.asarray(feats.desc)[idx2_np[sel]])
        self.map.add_observations(kf0, pt_ids, np.asarray(uv1)[sel])
        self.map.add_observations(kf1, pt_ids, uv2_np[sel])
        # Mark mapped features of the new keyframe (for new-point mining).
        mapped = np.zeros(self.cfg.frontend.max_features, bool)
        mapped[idx2_np[sel]] = True
        # Full BA with monocular median-depth gauge (≙ main.py:145-148).
        self._run_full_ba(scale_gauge=cfg.ba.scale_gauge_on_init)
        # Init quality gate (new; the reference accepts any pair passing the
        # match/cheirality gates, which occasionally seeds a degenerate map):
        # after BA the surviving map must reproject tightly, else roll back
        # and keep searching for a better pair.
        prob = self.map.to_ba_problem(self.cfg.intrinsics)
        err_d, w_d = ba_mod.reproj_errors(prob)
        err, w_np = _fetch_now(err_d, w_d)
        n_obs = max(float(w_np.sum()), 1.0)
        tight_frac = float(((err < 2.0) * w_np).sum() / n_obs)
        if tight_frac < 0.75 or n_obs < 2 * cfg.twoview.min_matches:
            self.map = SlamMap(self.cfg.map)  # rollback, retry next frames
            self.stats["init_rollbacks"] = self.stats.get("init_rollbacks", 0) + 1
            return False
        self._loop_db.add(kf0, d0_np, v0_np)
        self._loop_db.add(kf1, feats.desc, feats.valid)
        self._finish_keyframe(kf1, feats, mapped, frame_idx)
        self.initialized = True
        self.stats["init_frame"] = frame_idx
        self.trajectory.append(
            FrameResult(frame_idx, self.map.kf_R[kf1], self.map.kf_t[kf1], n_matches, True)
        )
        if orphan_idx is not None and orphan_idx > frame_idx:
            # Pose-only backfill of the superseded newer anchor (one sync
            # track per accept-after-reanchor — a rare event).
            snap = self._snapshot
            blob, _, _ = _track_step(
                orphan_feats.desc, orphan_feats.uv, orphan_feats.valid,
                snap["desc"], snap["xyz"], snap["valid"],
                jnp.asarray(self._prev_R), jnp.asarray(self._prev_t),
                self.intr, self._next_key(),
                cfg.frontend.match_ratio, cfg.frontend.max_hamming,
                cfg.tracking.pnp_threshold_px,
                n_hyps=cfg.tracking.pnp_hypotheses,
                refine_iters=cfg.tracking.refine_iters,
                cross_check=cfg.frontend.cross_check,
            )
            (ob,) = _fetch_now(blob)
            n_tr = int(ob[12])
            if n_tr >= cfg.tracking.min_tracked_points:
                Ro, to_ = ob[:9].reshape(3, 3).copy(), ob[9:12].copy()
            else:
                Ro, to_ = self._prev_R.copy(), self._prev_t.copy()
            self.trajectory.append(FrameResult(
                orphan_idx, Ro, to_, n_tr, False, ref_kf=kf1,
            ))
        return True

    def _check_init_verify(self, force: bool = False) -> bool:
        """Consume a pending async init confirmation at a DETERMINISTIC
        tick age (wall-clock readiness would make the accepted pair — and
        the whole trajectory — depend on device timing). Returns True when
        the confirm agreed and the system initialized."""
        h2 = self._pending_init_verify
        if h2 is None:
            return False
        if not force and h2["age"] < 4:
            h2["age"] += 1
            return False
        self._pending_init_verify = None
        res = self._fetch_result(h2["fut"])
        if res is None:  # wedged fetch: treat as a reject, keep searching
            self.stats["init_reverify_rejects"] = (
                self.stats.get("init_reverify_rejects", 0) + 1
            )
            return False
        (row,) = res
        if self._consume_init(h2, row):
            return True
        self.stats["init_reverify_rejects"] = (
            self.stats.get("init_reverify_rejects", 0) + 1
        )
        return False

    def _initialize_rgbd(self, frame_idx, feats, depth):
        """RGB-D initialization: backproject features through the metric
        depth map — the map is metric from frame one (config #1
        semantics; the reference loads depth but never uses it, see
        SURVEY.md §2.1 #4, so this is a capability the reference lacks)."""
        kf0 = self.map.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), frame_idx
        )
        uv = np.asarray(feats.uv)
        valid = np.array(feats.valid)
        X, ok = _backproject_depth(uv, depth, self.cfg.intrinsics)
        sel = np.where(valid & ok)[0]
        pt_ids = self.map.add_points(X[sel], np.asarray(feats.desc)[sel])
        self.map.add_observations(kf0, pt_ids, uv[sel], depth=X[sel, 2])
        mapped = np.zeros(self.cfg.frontend.max_features, bool)
        mapped[sel] = True
        self._loop_db.add(kf0, np.asarray(feats.desc), np.asarray(feats.valid))
        self._finish_keyframe(kf0, feats, mapped, frame_idx)
        self._last_kf_depth = depth
        self.initialized = True
        self.stats["init_frame"] = frame_idx
        self.trajectory.append(
            FrameResult(frame_idx, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), len(sel), True)
        )

    # ------------------------------------------------------------------ track

    def _track(self, frame_idx, feats, depth):
        self._apply_pending_ba()
        with self.timers.time("track"):
            h = self._dispatch_track(frame_idx, feats, depth)
            self._consume_track(h)

    def _dispatch_track(self, frame_idx, feats, depth):
        """Dispatch one tracking step without fetching (pipelining support).

        The PnP seed pose comes from the previous dispatch's DEVICE output
        (on-device pose threading): dispatching frame i+1 never waits for
        frame i's result to reach the host, so an arbitrarily deep pipeline
        of frames can be in flight while their fetches complete in the
        background. The chain is reseeded from the host pose
        after a tracking failure/relocalization.

        Returns a handle binding the frame to the snapshot its match indices
        refer to (the snapshot may be swapped by a keyframe before the
        handle is consumed)."""
        cfg = self.cfg
        snap = self._snapshot
        if self._pose_dev is not None:
            prev_R, prev_t = self._pose_dev
        else:
            prev_R = jnp.asarray(self._prev_R)
            prev_t = jnp.asarray(self._prev_t)
        blob, R_dev, t_dev = _track_step(
            feats.desc,
            feats.uv,
            feats.valid,
            snap["desc"],
            snap["xyz"],
            snap["valid"],
            prev_R,
            prev_t,
            self.intr,
            self._next_key(),
            cfg.frontend.match_ratio,
            cfg.frontend.max_hamming,
            cfg.tracking.pnp_threshold_px,
            n_hyps=cfg.tracking.pnp_hypotheses,
            refine_iters=cfg.tracking.refine_iters,
            cross_check=cfg.frontend.cross_check,
        )
        self._pose_dev = (R_dev, t_dev)
        # ONE async copy per frame. The blob carries the frame's feature
        # arrays too (any frame can become a keyframe), so a keyframe
        # needs no further fetch.
        _fetch_async(blob)
        return dict(
            frame_idx=frame_idx,
            feats=feats,
            depth=depth,
            snap=snap,
            snap_epoch=self._snap_epoch,
            # Dispatched against a pre-mine snapshot? Then the keyframe
            # rule's 0.9*n_local threshold is evaluated against a starved
            # local map — such frames must re-track before keyframing.
            mine_pending=self._pending_mine is not None,
            blob=blob,
        )

    def _dispatch_track_window(self, grays_np, carry_dev=None):
        """Dispatch a stacked window of frames as ONE device program
        (see _track_window). `carry_dev`, when given, is the (R, t) device
        output of the previous window — the pose chain then threads on
        device across windows with zero host round trips. Returns a handle
        with stacked device outputs and the new carry."""
        cfg = self.cfg
        snap = self._snapshot
        W = grays_np.shape[0]
        ks = jax.random.split(self.key, W + 1)
        self.key = ks[0]
        if carry_dev is not None:
            prev_R, prev_t = carry_dev
        else:
            prev_R = jnp.asarray(self._prev_R)
            prev_t = jnp.asarray(self._prev_t)
        blobs, R_last, t_last = _track_window(
            jax.device_put(np.ascontiguousarray(grays_np)),
            snap["desc"], snap["xyz"], snap["valid"],
            prev_R, prev_t,
            self.intr, ks[1:],
            cfg.frontend.match_ratio, cfg.frontend.max_hamming,
            cfg.tracking.pnp_threshold_px,
            window=W,
            max_features=cfg.frontend.max_features,
            quality_level=cfg.frontend.quality_level,
            nms_radius=cfg.frontend.nms_radius,
            n_hyps=cfg.tracking.pnp_hypotheses,
            refine_iters=cfg.tracking.refine_iters,
            cross_check=cfg.frontend.cross_check,
            min_track_pts=cfg.tracking.min_tracked_points,
            xla_frontend=frontend.FRONTEND_BACKEND == "xla",
        )
        _fetch_async(blobs)
        return dict(
            blobs=blobs, carry=(R_last, t_last), snap=snap,
            snap_epoch=self._snap_epoch,
            mine_pending=self._pending_mine is not None,
        )

    def _handle_track_failure(self, feats):
        """Shared tracking-failure path (the reference has no recovery,
        SURVEY.md §5): relocalize against the global map, else keep the
        previous pose (constant-position fallback). Reseeds the device pose
        chain — the threaded chain now carries the failed frame's
        garbage/fallback pose. Returns (relocalized, R_np, t_np, n)."""
        self.stats["track_failures"] = self.stats.get("track_failures", 0) + 1
        ok, R_np, t_np, _, _, n = self._relocalize(feats)
        self._pose_dev = None
        if not ok:
            R_np, t_np = self._prev_R.copy(), self._prev_t.copy()
        else:
            self.stats["relocalizations"] = (
                self.stats.get("relocalizations", 0) + 1
            )
            self._prev_R, self._prev_t = R_np, t_np
        return ok, R_np, t_np, n

    def _consume_track(self, h, blob_np=None):
        """Fetch a dispatched tracking step and run the host-side frame logic
        (pose bookkeeping, keyframe rule, keyframe insertion)."""
        cfg = self.cfg
        frame_idx, feats, depth = h["frame_idx"], h["feats"], h["depth"]
        snap = h["snap"]
        if blob_np is None:
            # Spin-then-read (see _fetch_now): a bare np.asarray pays the
            # blocking path's completion-poll backoff even for a landed
            # result.
            with self.timers.time("track_fetch"):
                (blob_np,) = _fetch_now(h["blob"])
        R = blob_np[:9].reshape(3, 3)
        t = blob_np[9:12]
        n_tracked = int(blob_np[12])
        if h.get("backfill", False):
            # Out-of-band init-window frame (see drain_init_to_tracking):
            # record its pose and nothing else — no keyframe candidacy, no
            # cadence counter, no failure recovery, no _prev pose update.
            if n_tracked >= cfg.tracking.min_tracked_points:
                R_np, t_np = R.copy(), t.copy()
            else:
                R_np, t_np = self._prev_R.copy(), self._prev_t.copy()
            self.trajectory.append(FrameResult(
                frame_idx, R_np, t_np, n_tracked, False,
                ref_kf=self._last_kf_id if self._last_kf_id is not None else -1,
            ))
            return
        relocalized = False
        if n_tracked < cfg.tracking.min_tracked_points:
            # Retry once against the CURRENT map (pending mine forced in)
            # before declaring failure — with chunked consumes the dispatch
            # snapshot lags 4-8 frames, and in fast-motion segments that
            # staleness masquerades as tracking failure (same fix the
            # windowed walk has; the failure cluster at ~frame 1075 was
            # exactly this).
            blob2, snap2 = self._retrack_candidate(
                feats, self._prev_R, self._prev_t
            )
            n2 = int(blob2[12])
            if n2 >= cfg.tracking.min_tracked_points:
                self.stats["fail_retried_ok"] = (
                    self.stats.get("fail_retried_ok", 0) + 1
                )
                blob_np, snap = blob2, snap2
                R_np = blob2[:9].reshape(3, 3).copy()
                t_np = blob2[9:12].copy()
                n_tracked = n2
                self._prev_R, self._prev_t = R_np, t_np
                self._pose_dev = None  # reseed the device chain from host
            else:
                relocalized, R_np, t_np, n_tracked = (
                    self._handle_track_failure(feats)
                )
        else:
            R_np, t_np = R.copy(), t.copy()
            self._prev_R, self._prev_t = R_np, t_np
        self._frames_since_kf += 1
        n_local = snap["n_valid"]  # host-cached: no device read
        is_kf = self._keyframe_rule(n_tracked, n_local)
        # A relocalized frame's match indices refer to the global snapshot,
        # not the tracking snapshot — never promote it in the same step.
        is_kf = is_kf and not relocalized
        # Pipelined consume: a frame dispatched against a snapshot that a
        # newer keyframe has since replaced may not insert with its STALE
        # match indices (they describe the superseded landmark set). But
        # dropping the candidate outright starves the map — with an L-frame
        # decision lag every keyframe vetoes the next L candidates (measured:
        # 45 vetoes vs 11 insertions at depth 6 on lr traj3). Instead,
        # re-track the frame against the CURRENT snapshot (one extra device
        # sync at keyframe cadence) and re-apply the keyframe rule
        # with the fresh indices. Frames dispatched while a mine was pending
        # take the same path: their snapshot was the starved pre-mine local
        # map, whose small n_local makes the 0.9 rule fire spuriously
        # (measured: 22 keyframes + ATE 0.032 vs 11 + 0.016 without this).
        if is_kf and (
            h.get("snap_epoch", self._snap_epoch) != self._snap_epoch
            or h.get("mine_pending", False)
        ):
            if (
                self._last_veto_token == self._state_token
                and frame_idx - self._last_veto_frame <= self._veto_cache_frames
            ):
                # A candidate a frame or two ago was already confirm-vetoed
                # against this exact map state; skip the sync (see
                # _state_token note — the time bound is load-bearing).
                is_kf = False
                self.stats["kf_veto_cached"] = (
                    self.stats.get("kf_veto_cached", 0) + 1
                )
            else:
                blob_np, snap = self._retrack_candidate(feats, R_np, t_np)
                n2 = int(blob_np[12])
                if self._keyframe_rule(n2, snap["n_valid"]):
                    R_np = blob_np[:9].reshape(3, 3).copy()
                    t_np = blob_np[9:12].copy()
                    self._prev_R, self._prev_t = R_np, t_np
                    n_tracked = n2
                    self.stats["kf_retracked"] = self.stats.get("kf_retracked", 0) + 1
                else:
                    is_kf = False
                    self._last_veto_token = self._state_token
                    self._last_veto_frame = frame_idx
                    self.stats["kf_vetoed_stale"] = (
                        self.stats.get("kf_vetoed_stale", 0) + 1
                    )
        if is_kf:
            M = int(snap["valid"].shape[0])
            K = int(feats.uv.shape[0])
            inl_np, idx2_np, feats_host = _unpack_blob(blob_np, M, K)
            self._insert_keyframe(
                frame_idx, feats_host, R_np, t_np, inl_np, idx2_np, depth,
                snap=snap,
            )
        self.trajectory.append(FrameResult(
            frame_idx, R_np, t_np, n_tracked, is_kf,
            ref_kf=self._last_kf_id if self._last_kf_id is not None else -1,
        ))

    def _keyframe_rule(self, n_tracked: int, n_local: int) -> bool:
        """Keyframe decision ≙ main.py:221, evaluated host-side.

        float32 threshold on purpose: historical parity with the on-device
        f32 evaluation — computing it in f64 could flip borderline frames.
        """
        cfg = self.cfg
        want = (
            self._frames_since_kf > cfg.keyframe.max_interval
            or n_tracked < cfg.keyframe.min_tracked
        ) and n_tracked < float(
            np.float32(cfg.keyframe.tracked_ratio) * np.float32(max(n_local, 1))
        )
        want = want and self._frames_since_kf >= cfg.keyframe.min_gap
        return want and n_tracked >= cfg.tracking.min_tracked_points

    def _retrack_candidate(self, feats, R_np, t_np):
        """Re-track a keyframe candidate against the CURRENT snapshot.

        Used when a candidate's dispatch-time snapshot went stale (a newer
        keyframe replaced it, or a landmark mine was pending): its match
        indices describe a superseded landmark set and the keyframe rule was
        evaluated against a starved local map. Forces the pending mine in
        first, then runs one synchronous tracking step. Returns
        (blob_np, snap) — the caller re-applies the keyframe rule.
        """
        cfg = self.cfg
        self._apply_pending_mine(force=True)
        snap = self._snapshot
        blob2, _, _ = _track_step(
            feats.desc, feats.uv, feats.valid,
            snap["desc"], snap["xyz"], snap["valid"],
            jnp.asarray(R_np), jnp.asarray(t_np),
            self.intr, self._next_key(),
            cfg.frontend.match_ratio, cfg.frontend.max_hamming,
            cfg.tracking.pnp_threshold_px,
            n_hyps=cfg.tracking.pnp_hypotheses,
            refine_iters=cfg.tracking.refine_iters,
            cross_check=cfg.frontend.cross_check,
        )
        with self.timers.time("retrack_sync"):
            (blob_np,) = _fetch_now(blob2)
        return blob_np, snap

    def _relocalize(self, feats):
        """Global-map PnP relocalization after a tracking failure.

        Matches the frame against the best-observed landmarks of the whole
        map and solves PnP with a full hypothesis budget. Same jitted
        _track_step (identical shapes — no recompile).
        """
        cfg = self.cfg
        snap = self.map.global_snapshot()
        blob, _, _ = _track_step(
            feats.desc,
            feats.uv,
            feats.valid,
            snap["desc"],
            snap["xyz"],
            snap["valid"],
            jnp.asarray(self._prev_R),
            jnp.asarray(self._prev_t),
            self.intr,
            self._next_key(),
            cfg.frontend.match_ratio,
            cfg.frontend.max_hamming,
            cfg.tracking.pnp_threshold_px,
            n_hyps=cfg.tracking.pnp_hypotheses,
            refine_iters=cfg.tracking.refine_iters,
            cross_check=cfg.frontend.cross_check,
        )
        (blob_np,) = _fetch_now(blob)
        n = int(blob_np[12])
        ok = n >= cfg.tracking.min_tracked_points
        M = int(snap["valid"].shape[0])
        K = int(feats.uv.shape[0])
        inliers, idx2, _ = _unpack_blob(blob_np, M, K)
        # The returned inliers/idx2 index the *global* snapshot, which is not
        # the tracking snapshot; a relocalized frame is never a keyframe in
        # the same step, so the caller only uses the pose and count.
        return ok, blob_np[:9].reshape(3, 3).copy(), blob_np[9:12].copy(), inliers, idx2, n

    # --------------------------------------------------------------- keyframe

    def _insert_keyframe(self, frame_idx, feats, R_np, t_np, inliers, idx2, depth=None, snap=None):
        """Insert a keyframe. `feats`, `inliers`, `idx2` are HOST data (the
        per-frame blob carries them — see _pack_blob; a cold device fetch
        here used to cost 130+ ms per keyframe)."""
        cfg = self.cfg
        with self.timers.time("kf_mine_wait"):
            # Land the previous keyframe's mine first: its landmarks must
            # exist before this keyframe's snapshot/mine bookkeeping
            # (dispatch_ba=False — the BA dispatched at the END of this
            # insertion covers the mined points plus this keyframe).
            self._apply_pending_mine(force=True, dispatch_ba=False)
        with self.timers.time("kf_ba_wait"):
            # A BA dispatched BEFORE this keyframe may not be applied AFTER
            # it: update_from_ba writes back the problem's full pose array,
            # which would overwrite this keyframe's slot with its dispatch-
            # time identity (and the inconsistent reprojections then get
            # pruned until the local map starves — measured in round 2:
            # n_valid 200 -> 10 by frame 180, ATE 0.016 -> 0.085). So the
            # pending BA is applied NOW if its result has landed — or
            # DROPPED if it hasn't: the fresh BA dispatched at the end of
            # this insertion covers a strict superset of its problem, so
            # the insertion never spins on an unfinished solve.
            # ≙ the reference's synchronous local BA before the next
            # keyframe (main.py:322-323), minus the synchronous wait.
            self._drop_or_apply_pending_ba()
        if snap is None:
            snap = self._snapshot
        kf_id = self.map.add_keyframe(R_np, t_np, frame_idx)
        self.stats["keyframes"] += 1
        # NOTE: use the handle-bound snapshot (`snap`), never re-read
        # self._snapshot here — the forced BA apply above may have pruned
        # observations and rebuilt the snapshot with a different slot order,
        # which would silently make inliers/idx2 select the wrong pt_ids.
        # The handle snapshot's pt_ids stay valid landmark ids regardless.
        inl_np = np.asarray(inliers)
        idx2_np = np.asarray(idx2)
        # Tracked landmarks gain an observation in the new keyframe
        # (≙ main.py:232).
        sel = np.where(inl_np)[0]
        pt_ids = snap["pt_ids_np"][sel]
        uv_cur = np.asarray(feats.uv)[idx2_np[sel]]
        desc_cur = np.asarray(feats.desc)[idx2_np[sel]]
        d_cur = (
            _sample_depth(uv_cur, depth)
            if (cfg.use_depth and depth is not None)
            else None
        )
        self.map.add_observations(kf_id, pt_ids, uv_cur, desc_cur, depth=d_cur)
        # Loop-closure place recognition: dispatch the keyframe-scoring
        # pass now so its result fetch overlaps with the mining step below.
        loop_scores = self._dispatch_loop_scores(kf_id, feats)
        mapped = np.zeros(cfg.frontend.max_features, bool)
        mapped[idx2_np[sel]] = True
        # Cull weak landmarks every 4th keyframe (≙ main.py:234-235).
        if kf_id >= cfg.keyframe.cull_after and kf_id % cfg.keyframe.cull_every == 0:
            self.stats["culled"] += self.map.cull_points(cfg.keyframe.cull_min_views)
        # Mine new landmarks (≙ main.py:237-318): depth backprojection in
        # RGB-D mode (host-only, synchronous), two-view triangulation in
        # monocular mode — DISPATCHED here, applied a couple of frames later
        # (_apply_pending_mine), exactly like the async BA, so the insertion
        # does not wait on the triangulation.
        with self.timers.time("kf_mine"):
            if self.cfg.use_depth and depth is not None:
                self._mine_depth_points(kf_id, feats, mapped, depth)
            else:
                self._dispatch_mine(kf_id, feats, mapped)
        with self.timers.time("kf_snapshot"):
            self._finish_keyframe(kf_id, feats, mapped, frame_idx)
        if loop_scores is not None:
            # Deferred consume (like the mine/BA): the scores' async fetch
            # lands while tracking continues instead of syncing here.
            self._pending_loop = dict(
                kf_id=kf_id, feats=feats, scores=loop_scores,
                fut=self._bg_fetch(loop_scores), age=0
            )
        # Full bundle adjustment over the map (≙ main.py:322-323),
        # dispatched async NOW — a full keyframe interval before the next
        # forced apply, so the force usually finds it long finished. This BA
        # covers everything up to
        # and including this keyframe's tracked observations; the points
        # this keyframe MINES join the next keyframe's BA.
        with self.timers.time("kf_dispatch_ba"):
            if kf_id % max(self.cfg.ba.every_n_kf, 1) != 0:
                # Scheduled skip (ba.every_n_kf > 1): this keyframe's
                # observations join the next scheduled keyframe's BA.
                self.stats["ba_skipped_interval"] = (
                    self.stats.get("ba_skipped_interval", 0) + 1
                )
            elif self._pending_ba is None:
                self._dispatch_ba(kf_id, scale_gauge=False)
            else:
                # BA slot occupied (previous keyframe's solve still in
                # flight): run a fresh BA over the map including this
                # keyframe as soon as the slot frees.
                self._ba_followup = kf_id

    def _dispatch_mine(self, kf_id, feats, mapped_cur):
        """Dispatch landmark mining between the previous and new keyframe
        without waiting (async mapping — the deferred-apply twin of
        _dispatch_ba). Triangulation runs on device while tracking resumes;
        _apply_pending_mine inserts the new landmarks a couple of frames
        later and then dispatches the keyframe's full BA."""
        cfg = self.cfg
        prev_feats = self._last_kf_feats
        prev_mapped = self._last_kf_mapped
        # Unmapped = detected in prev KF but not yet a landmark (≙ GetListDiff,
        # helper_functions.py:316-326).
        avail1 = np.asarray(prev_feats.valid) & ~prev_mapped
        prev_id = self._last_kf_id
        mine_blob = _mine_step(
            prev_feats.desc,
            prev_feats.uv,
            jnp.asarray(avail1),
            feats.desc,
            feats.uv,
            feats.valid,
            jnp.asarray(self.map.kf_R[prev_id]),
            jnp.asarray(self.map.kf_t[prev_id]),
            jnp.asarray(self.map.kf_R[kf_id]),
            jnp.asarray(self.map.kf_t[kf_id]),
            self.intr,
            cfg.frontend.match_ratio,
            cfg.frontend.max_hamming,
            cfg.keyframe.triangulation_reproj_px,
            cfg.keyframe.max_new_depth,
            cfg.keyframe.min_parallax_deg,
            cross_check=cfg.frontend.cross_check,
        )
        self._pending_mine = dict(
            fut=self._bg_fetch(mine_blob),
            blob=mine_blob,
            kf_id=kf_id,
            prev_id=prev_id,
            feats=feats,
            prev_uv=np.asarray(prev_feats.uv),
            mapped=mapped_cur,
            age=0,
        )

    def _apply_pending_mine(self, force: bool = False, dispatch_ba: bool = False) -> None:
        """Insert the landmarks of a dispatched mine once its result has
        landed (or immediately when force=True), then dispatch the
        keyframe's full BA. Mirrors _apply_pending_ba."""
        h = self._pending_mine
        if h is None:
            return
        # DETERMINISTIC apply age: wall-clock-gated applies (is_ready)
        # made the whole control flow — keyframe sets, veto decisions,
        # trajectories — depend on device timing (measured: the same
        # binary swung full-sequence ATE 0.05-0.14 run to run). Applying
        # at a FIXED tick age (spinning if the result hasn't landed)
        # makes runs reproducible.
        if not force and h["age"] < 2:
            h["age"] += 1
            return
        self._pending_mine = None
        cfg = self.cfg
        kf_id, prev_id, feats = h["kf_id"], h["prev_id"], h["feats"]
        mapped_cur = h["mapped"]
        with self.timers.time("mine_apply"):
            res = self._fetch_result(h["fut"])
        if res is None:  # wedged fetch: drop this mine, keep tracking
            self.stats["mine_dropped"] = self.stats.get("mine_dropped", 0) + 1
            return
        (mine_np,) = res
        K = int(h["prev_uv"].shape[0])
        idx2_np, keep, keep_loose_np, X_np = _unpack_mine_blob(mine_np, K)
        keep = keep.copy()
        # Don't re-map features already matched to existing landmarks.
        fresh = ~mapped_cur[idx2_np]
        keep &= fresh
        # Adaptive parallax gate: relax to the loose mask when the strict
        # yield would starve the map (see _mine_step docstring).
        if keep.sum() < cfg.keyframe.min_mined_points:
            keep = keep_loose_np & fresh
            self.stats["mine_relaxed"] = self.stats.get("mine_relaxed", 0) + 1
        sel = np.where(keep)[0]
        if len(sel) > 0:
            pt_ids = self.map.add_points(
                X_np[sel], np.asarray(feats.desc)[idx2_np[sel]]
            )
            self.map.add_observations(prev_id, pt_ids, h["prev_uv"][sel])
            self.map.add_observations(
                kf_id, pt_ids, np.asarray(feats.uv)[idx2_np[sel]]
            )
            # In-place on purpose: this is the same array _finish_keyframe
            # stored as _last_kf_mapped — the NEXT mine's availability mask.
            mapped_cur[idx2_np[sel]] = True
            # The mined landmarks join the tracking snapshot (only if this
            # keyframe is still the tracking anchor — a newer keyframe's
            # snapshot must not be clobbered with the older local map).
            if self._last_kf_id == kf_id:
                self._snapshot = self.map.local_snapshot(kf_id)
            self._state_token += 1  # confirmable state changed (see init)
        if dispatch_ba:
            # Legacy ride-along (kept for callers that need BA right after
            # the mine); production dispatches the keyframe BA at INSERTION
            # instead — see _insert_keyframe — so it has a full keyframe
            # interval to finish before the next forced apply. The mined
            # points join the NEXT keyframe's BA (one-interval polish
            # deferral; ≙ mining precedes local BA, main.py:237-322).
            if self._pending_ba is None:
                self._dispatch_ba(kf_id, scale_gauge=False)
            else:
                self._ba_followup = kf_id

    def _mine_depth_points(self, kf_id, feats, mapped_cur, depth):
        """Create metric landmarks for unmapped features from the depth map."""
        uv = np.asarray(feats.uv)
        valid = np.array(feats.valid) & ~mapped_cur
        Xc, ok = _backproject_depth(uv, depth, self.cfg.intrinsics)
        sel = np.where(valid & ok)[0]
        if len(sel) == 0:
            return
        # Camera -> world: X_w = R_cw^T (X_c - t_cw).
        R_cw = self.map.kf_R[kf_id]
        t_cw = self.map.kf_t[kf_id]
        Xw = (Xc[sel] - t_cw) @ R_cw
        pt_ids = self.map.add_points(Xw.astype(np.float32), np.asarray(feats.desc)[sel])
        self.map.add_observations(kf_id, pt_ids, uv[sel], depth=Xc[sel, 2])
        mapped_cur[sel] = True

    def _dispatch_ba(self, kf_id: int, scale_gauge: bool) -> None:
        """Dispatch the full BA without waiting (async local mapping).

        The result is applied a couple of frames later
        (_apply_pending_ba), by when the solve has usually finished, so
        tracking never waits on it. Tracking continues
        against the pre-BA snapshot, which matches the reference's frozen
        local-map-copy semantics (deepcopy at main.py:154,333)."""
        cfg = self.cfg
        use_depth = bool(cfg.use_depth and cfg.ba.depth_weight > 0)
        with self.timers.time("bundle_adjust"):
            with self.timers.time("ba_pack"):
                prob = self.map.to_ba_problem(
                    self.cfg.intrinsics,
                    depth_weight=cfg.ba.depth_weight if use_depth else 0.0,
                )
            with self.timers.time("ba_dispatch"):
                out, diag, bad = _ba_step(
                    prob, n_iters=cfg.ba.iters, cg_iters=cfg.ba.cg_iters,
                    solver=cfg.ba.solver, use_depth=use_depth,
                )
        # Start the result copies now AND hand the blocking reads to the
        # background worker: by apply time (a couple of frames later) the
        # future has resolved and the apply's fetches are ~free. The
        # packing meta is bound to the handle: slot->obs mapping must match
        # the dispatched problem even if the map changes before apply.
        fut = self._bg_fetch(out.R, out.t, out.X, diag, bad)
        self._pending_ba = (
            out, diag, bad, kf_id, scale_gauge, 0, self.map.ba_meta, fut
        )

    def _apply_pending_ba(self, force: bool = False,
                          force_loop: bool | None = None) -> None:
        # A pending mine precedes its keyframe's BA: tick it first so its
        # apply (which dispatches that BA) happens as soon as the result
        # lands. Every driver already calls _apply_pending_ba per frame, so
        # no driver changes are needed for the mine to drain.
        # dispatch_ba=True: the mined points get their polish BA as soon as
        # the slot frees (usually mid-interval, via _ba_followup — the
        # insertion-time BA occupies the slot). Without it the points wait a
        # whole keyframe interval (measured ATE 0.0161 -> 0.0198).
        # force_loop: keyframe insertion forces the mine+BA (their results
        # gate the new keyframe's geometry) but SKIPS the loop scoring/
        # verify consumes (False): spinning on a just-dispatched
        # verification would drain the device queue at every scored
        # keyframe, and a closure applied mid-insertion would rewrite the map under
        # the pose being inserted. Closures land at the between-window
        # ticks. End-of-run drains force everything.
        if force_loop is None:
            force_loop = force
        self._apply_pending_mine(force=force, dispatch_ba=True)
        if force_loop or not force:
            # force_loop=False + force=True (insertion) skips; otherwise
            # tick (non-forced) or force (end-of-run drain).
            self._apply_pending_loop(force=force_loop)
            self._apply_pending_loop_verify(force=force_loop)
        self._consume_pending_ba(force=force)
        # Follow-up BA (a keyframe arrived while the slot was occupied):
        # dispatch over the map as it stands now — it includes that
        # keyframe's observations and everything since. Forced drains (end
        # of run) apply it immediately so the final keyframes are optimized.
        if (
            self._ba_followup is not None
            and self._pending_ba is None
            and self._pending_mine is None
        ):
            kf = self._ba_followup
            self._ba_followup = None
            self._dispatch_ba(kf, scale_gauge=False)
            if force:
                self._consume_pending_ba(force=True)

    def _drop_or_apply_pending_ba(self) -> None:
        """Keyframe-insertion BA policy: apply the pending BA if it has had
        at least one frame of device time, else DISCARD it.

        Discarding is safe because the caller (_insert_keyframe) dispatches
        a fresh BA over the current map at the end of the insertion, whose
        problem is a strict superset of the dropped one's; the only loss is
        the dropped solve's device cycles and its deferred observation
        pruning, which the fresh solve redoes."""
        if self._pending_ba is None:
            return
        # DETERMINISTIC policy (see _apply_pending_mine): age >= 1 means
        # the solve has had at least one frame of device time — apply it
        # (spinning out the remainder); a younger solve is dropped. The
        # previous wall-clock readiness probe made the drop decision — and
        # therefore the map trajectory — depend on device timing.
        age = self._pending_ba[5]
        if age >= 1:
            self._consume_pending_ba(force=True)
        else:
            self._pending_ba = None
            self.stats["ba_dropped_stale"] = (
                self.stats.get("ba_dropped_stale", 0) + 1
            )

    def _consume_pending_ba(self, force: bool = False) -> None:
        if self._pending_ba is None:
            return
        out, diag, bad, kf_id, scale_gauge, age, meta, fut = self._pending_ba
        if not force and age < 3:
            # DETERMINISTIC apply age (see _apply_pending_mine): the BA
            # lands exactly 3 ticks after dispatch, waiting if needed.
            # (Probed on the 1200-frame sequence: age 2 -> ATE 0.120,
            # age 3 -> 0.092, age 5 -> 0.176.)
            self._pending_ba = (
                out, diag, bad, kf_id, scale_gauge, age + 1, meta, fut
            )
            return
        self._pending_ba = None
        with self.timers.time("bundle_adjust"), self.timers.time("ba_consume"):
            # The worker already waited for the copy; the fetched values are
            # cached on the device arrays, so the np.asarray reads below
            # (and in update_from_ba) are host-memory copies.
            if self._fetch_result(fut) is None:
                # Wedged fetch: treat like a diverged solve — drop it.
                self.stats["ba_rejected"] = (
                    self.stats.get("ba_rejected", 0) + 1
                )
                return
            diag_np = np.asarray(diag)
        cost_before, cost_after, blown = (float(v) for v in diag_np)
        # Failure detection (SURVEY.md §5 — the reference has none): reject a
        # BA result that diverged, went non-finite, or can no longer explain
        # a healthy fraction of its observations (a decreasing robust cost
        # can still mean the solution warped — Huber caps each bad residual's
        # contribution, so wholesale outlier-ification looks "cheap").
        if (
            not np.isfinite(cost_after)
            or (np.isfinite(cost_before) and cost_after > 2.0 * cost_before)
            or blown > 0.3
        ):
            self.stats["ba_rejected"] = self.stats.get("ba_rejected", 0) + 1
            return
        prob = out
        gauge_changed = False
        with self.timers.time("bundle_adjust"), self.timers.time("ba_apply"):
            if scale_gauge:
                prob = ba_mod.median_depth_normalize(prob)
                gauge_changed = True
            self.map.update_from_ba(prob, meta)
            if gauge_changed:
                self.map.refresh_scale_meas()
            # Prune observations the optimized map cannot explain (reproj
            # error beyond the Huber regime; ≙ the role of g2o robust
            # kernels, made permanent).
            bad_np = np.unpackbits(np.asarray(bad))[
                : len(meta.slot_obs)
            ].astype(bool)
            if bad_np.any():
                n = self.map.prune_obs_from_ba(bad_np, meta)
                self.stats["obs_pruned"] = self.stats.get("obs_pruned", 0) + n
            # Safe point for table compaction: the consumed BA's meta was
            # the only holder of observation-row indices, and no other BA
            # is in flight here (this method just cleared _pending_ba).
            reclaimed = self.map.compact_observations()
            if reclaimed:
                self.stats["obs_compacted"] = (
                    self.stats.get("obs_compacted", 0) + reclaimed
                )
            self.stats["ba_runs"] += 1
            # The optimized landmarks replace the tracking snapshot (pose
            # continuity kept: the tracker's prev pose is not rewritten).
            # No epoch bump: in-flight handles bind their dispatch-time
            # snapshot, whose pt_ids are global landmark ids that stay
            # valid across a BA apply (even when pruning reorders the
            # rebuilt snapshot's slots) — bumping here needlessly vetoed
            # every in-flight keyframe candidate after each BA apply,
            # halving the keyframe count in pipelined runs.
            if self._last_kf_id is not None:
                self._snapshot = self.map.local_snapshot(self._last_kf_id)
        self._state_token += 1  # confirmable state changed (see init)

    def _run_full_ba(self, scale_gauge: bool):
        """Synchronous BA (init path): dispatch + immediate apply."""
        self._dispatch_ba(
            self._last_kf_id if self._last_kf_id is not None else 0, scale_gauge
        )
        self._apply_pending_ba(force=True)

    def ba_iters_per_s(self) -> float:
        """BA iterations/s (a report metric)."""
        return self.timers.rate("bundle_adjust", self.stats["ba_runs"] * self.cfg.ba.iters)

    def _finish_keyframe(self, kf_id, feats, mapped, frame_idx):
        """Reset tracking state around a new keyframe (≙ main.py:330-345)."""
        self._last_kf_id = kf_id
        self._last_kf_feats = feats
        self._last_kf_mapped = mapped
        self._snap_epoch += 1
        self._state_token += 1
        self._snapshot = self.map.local_snapshot(kf_id)
        self._prev_R = self.map.kf_R[kf_id].copy()
        self._prev_t = self.map.kf_t[kf_id].copy()
        self._frames_since_kf = 0
        # Update the stored trajectory entry for this keyframe with the
        # BA-optimized pose.
        for fr in reversed(self.trajectory):
            if fr.frame_idx == frame_idx:
                fr.R_cw = self.map.kf_R[kf_id].copy()
                fr.t_cw = self.map.kf_t[kf_id].copy()
                break

    # ---------------------------------------------------------- loop closure

    def _dispatch_loop_scores(self, kf_id: int, feats):
        """Store the new keyframe's features and dispatch the matmul
        place-recognition scoring pass (models/loop_closure.py). Returns a
        device scores handle (fetch started) or None when not applicable."""
        cfg = self.cfg.loop
        self._loop_db.add(kf_id, np.asarray(feats.desc), np.asarray(feats.valid))
        if not cfg.enabled:
            return None
        if kf_id < cfg.min_gap or kf_id - self._last_loop_kf <= cfg.cooldown:
            return None
        db_desc, db_valid = self._loop_db.device_arrays()
        kf_mask = jnp.asarray(self.map.kf_valid)
        scores = lc_mod.score_keyframes(
            feats.desc, feats.valid, db_desc, db_valid, kf_mask,
            cfg.hamming_thresh,
        )
        _fetch_async(scores)
        return scores

    def _apply_pending_loop(self, force: bool = False) -> None:
        """Consume a deferred place-recognition scoring pass once its fetch
        has landed (or immediately when force=True). Mirrors
        _apply_pending_mine."""
        h = self._pending_loop
        if h is None:
            return
        if not force and h["age"] < 2:
            h["age"] += 1  # deterministic age (see _apply_pending_mine)
            return
        self._pending_loop = None
        with self.timers.time("kf_loop"):
            res = self._fetch_result(h["fut"])
            if res is None:  # wedged fetch: skip this scoring pass
                return
            (scores_np,) = res
            self._dispatch_loop_verify(h["kf_id"], h["feats"], scores_np)

    def _dispatch_loop_verify(self, kf_id: int, feats, scores_dev) -> None:
        """Consume the scoring pass; DISPATCH geometric verification of a
        detected candidate (PnP of the current keyframe's features against
        the candidate keyframe's landmark snapshot, seeded at the
        candidate's pose — the production tracking step, same jit). The
        result is consumed asynchronously (_apply_pending_loop_verify), off
        the tracking critical path."""
        if self._pending_loop_verify is not None:
            return  # one verification in flight at a time (cooldown-rare)
        cfg = self.cfg.loop
        if isinstance(scores_dev, np.ndarray):
            scores = scores_dev  # already fetched by the background worker
        else:
            (scores,) = _fetch_now(scores_dev)
        cand = lc_mod.find_candidate(scores, kf_id, cfg)
        if cand is None:
            return
        # Covisibility-disjointness gate: a genuine loop candidate shares
        # (almost) no LIVE landmarks with the current keyframe — shared
        # landmarks mean the two views are the same neighbourhood reached
        # by continuous tracking, and "closing" it adds a rigid edge for
        # geometry local BA already governs (measured: an accepted
        # kf15-vs-kf2 "closure" 163 frames apart bent the late trajectory,
        # full-seq ATE 0.064 -> 0.121). ORB-SLAM's analog: candidates must
        # be disconnected from the covisibility graph.
        cur_pts, _ = self.map.points_seen_by(kf_id)
        cand_pts, _ = self.map.points_seen_by(cand)
        if len(cur_pts) and len(cand_pts):
            overlap = np.isin(cand_pts, cur_pts).sum() / min(
                len(cur_pts), len(cand_pts)
            )
            if overlap > 0.05:
                self.stats["loop_rejected_covis"] = (
                    self.stats.get("loop_rejected_covis", 0) + 1
                )
                return
        tcfg = self.cfg.tracking
        fq = self.cfg.frontend
        snap = self.map.local_snapshot(cand)
        # Diagnostics: an empty candidate snapshot (culled/pruned points)
        # makes verification structurally impossible — record it.
        self.stats["loop_cand_nvalid_last"] = snap["n_valid"]
        blob, _, _ = _track_step(
            feats.desc, feats.uv, feats.valid,
            snap["desc"], snap["xyz"], snap["valid"],
            jnp.asarray(self.map.kf_R[cand]), jnp.asarray(self.map.kf_t[cand]),
            self.intr, self._next_key(),
            fq.match_ratio, fq.max_hamming, tcfg.pnp_threshold_px,
            n_hyps=tcfg.pnp_hypotheses, refine_iters=tcfg.refine_iters,
            cross_check=fq.cross_check,
        )
        self.stats["loop_candidates"] = self.stats.get("loop_candidates", 0) + 1
        self._pending_loop_verify = dict(
            kf_id=kf_id, cand=cand, feats=feats, blob=blob,
            fut=self._bg_fetch(blob), snap=snap, age=0
        )

    def _apply_pending_loop_verify(self, force: bool = False) -> None:
        """Consume a dispatched loop verification; on success run the
        (rare, inherently synchronous) closure: pose-graph correction +
        warp validation + fresh BA."""
        h = self._pending_loop_verify
        if h is None:
            return
        if not force and h["age"] < 2:
            h["age"] += 1  # deterministic age (see _apply_pending_mine)
            return
        self._pending_loop_verify = None
        with self.timers.time("kf_loop"):
            self._close_loop(h)

    def _close_loop(self, h: dict) -> None:
        cfg = self.cfg.loop
        kf_id, cand, feats, snap = h["kf_id"], h["cand"], h["feats"], h["snap"]
        res = self._fetch_result(h["fut"])
        if res is None:  # wedged fetch: count as a failed verification
            self.stats["loop_verify_fail"] = (
                self.stats.get("loop_verify_fail", 0) + 1
            )
            return
        (blob_np,) = res
        M = int(snap["valid"].shape[0])
        Kf = int(np.asarray(feats.uv).shape[0])
        inl_host, idx2_host, _ = _unpack_blob(blob_np, M, Kf)
        n_inl = int(blob_np[12])
        if n_inl < cfg.verify_min_inliers:
            self.stats["loop_verify_fail"] = (
                self.stats.get("loop_verify_fail", 0) + 1
            )
            # Best near-miss inlier count, for gate diagnostics.
            self.stats["loop_verify_best"] = max(
                self.stats.get("loop_verify_best", 0), n_inl
            )
            return
        # A verified closure rewrites poses and re-anchors landmarks below;
        # the in-flight mine (dispatched this keyframe) triangulated against
        # the PRE-correction poses, so land it first — its points then get
        # re-anchored consistently with everything else. Its BA dispatch is
        # suppressed, and any BA already in flight is DISCARDED: it
        # optimized the pre-correction geometry, and applying it after the
        # pose-graph correction would overwrite the corrected poses with
        # stale ones. A fresh BA over the corrected map is dispatched at the
        # end of this method instead.
        self._apply_pending_mine(force=True, dispatch_ba=False)
        if self._pending_ba is not None:
            self._pending_ba = None
            self.stats["ba_discarded_loop"] = (
                self.stats.get("ba_discarded_loop", 0) + 1
            )
        # Any queued follow-up BA is likewise superseded by the fresh
        # post-correction BA dispatched at the end of this method.
        self._ba_followup = None
        R_corr = blob_np[:9].reshape(3, 3).astype(np.float32)
        t_corr = blob_np[9:12].astype(np.float32)
        # Cross-observations: the verified matches are sightings of the OLD
        # landmarks in the NEW keyframe — global BA fuses the loop through
        # these reprojection constraints.
        sel = np.where(inl_host)[0]
        pt_ids = snap["pt_ids_np"][sel]
        # Dedup against the observations tracking already recorded for this
        # keyframe: on a small loop the candidate's and tracking snapshots
        # overlap, and a duplicated (kf, landmark) row double-weights that
        # reprojection residual in every later BA and inflates pt_views.
        m = self.map
        seen = m.obs_pt[: m.n_obs][
            m.obs_valid[: m.n_obs] & (m.obs_cam[: m.n_obs] == kf_id)
        ]
        fresh = ~np.isin(pt_ids, seen)
        sel, pt_ids = sel[fresh], pt_ids[fresh]
        # (The cross-observations are inserted AFTER the warp validation
        # below — on a rejected closure they would poison every later BA.)
        # Loop edge (≙ EdgeSE3 + RobustKernelDCS, LocalBA.py:97-113), plus
        # the measured RELATIVE SCALE for the monocular Sim3 graph: old
        # landmarks' median depth under the PnP-verified pose vs the
        # current keyframe's own landmarks' median depth — both medians
        # summarize the same visible scene, so their ratio is the local
        # map-scale drift the 7-DoF pose graph must absorb (an SE3-only
        # correction of a scale-drifted loop degrades reprojection and was
        # warp-rejected on every genuine lr-traj3 closure attempt).
        Z_R, Z_t = lc_mod.loop_edge_measurement(
            self.map.kf_R[cand], self.map.kf_t[cand], R_corr, t_corr
        )
        old_ids = snap["pt_ids_np"][np.where(inl_host)[0]]
        Xo = self.map.pt_xyz[old_ids]
        z_old = (Xo @ R_corr.T + t_corr)[:, 2]
        cur_ids, _ = self.map.points_seen_by(kf_id)
        Xc_ = self.map.pt_xyz[cur_ids]
        z_new = (
            Xc_ @ self.map.kf_R[kf_id].T + self.map.kf_t[kf_id]
        )[:, 2]
        z_old = z_old[z_old > 0.05]
        z_new = z_new[z_new > 0.05]
        if len(z_old) >= 5 and len(z_new) >= 5:
            s_m = float(np.clip(
                np.median(z_old) / np.median(z_new), 1.0 / 3.0, 3.0
            ))
        else:
            s_m = 1.0
        self._loop_edges_last_ls = np.log(s_m)
        self._loop_edges.append((cand, kf_id, Z_R, Z_t, np.log(s_m)))
        # Pose-graph correction + landmark re-anchoring — VALIDATED: a
        # false-positive closure that survives the inlier vote (30+ lucky
        # matches happen on repetitive synthetic texture; measured 2x ATE
        # when one fired on the non-revisiting 200-frame prefix) warps the
        # whole map, so the correction must not make the map reproject
        # WORSE. Snapshot the geometry, apply, re-measure; revert and drop
        # the edge if the blown-observation fraction grows.
        saved = (
            self.map.kf_R.copy(), self.map.kf_t.copy(),
            self.map.pt_xyz.copy(), self.map.kf_scale_meas.copy(),
        )
        R_new, t_new, s_new = self._optimize_pose_graph_arrays(cfg.pgo_iters)
        # Edge-satisfaction gate (r5): the DCS kernel can down-weight a
        # topologically-false edge to ~zero, making the "correction" a
        # smooth near-no-op that the warp validation below cannot catch —
        # the false closure would then be RECORDED (bogus edge + wrong
        # cross-observations) while correcting nothing. A genuine closure's
        # edge is SATISFIED by the optimized graph; an edge the graph
        # refused to move toward is a rejected hypothesis, not a closure.
        Rr = R_new[cand] @ R_new[kf_id].T  # realized cand<-cur rotation
        ang = float(np.degrees(np.arccos(np.clip(
            (np.trace(Z_R.T @ Rr) - 1.0) / 2.0, -1.0, 1.0
        ))))
        # Realized relative transform in the graph's own parametrization
        # (Sim3: S_i S_j^-1 has t_rel = t_i - (s_i/s_j) R_rel t_j).
        s_rel = (
            float(s_new[cand] / max(float(s_new[kf_id]), 1e-6))
            if s_new is not None else 1.0
        )
        t_hat = t_new[cand] - s_rel * (Rr @ t_new[kf_id])
        scene_scale = max(float(np.median(np.abs(z_old)))
                          if len(z_old) else 1.0, 1e-3)
        t_res = float(np.linalg.norm(Z_t - t_hat)) / scene_scale
        if ang > 5.0 or t_res > 0.15:
            self._loop_edges.pop()
            self.stats["loop_rejected_unsatisfied"] = (
                self.stats.get("loop_rejected_unsatisfied", 0) + 1
            )
            self.stats.setdefault("loop_rejected_detail", []).append(
                dict(kf=int(kf_id), cand=int(cand), n_inl=int(n_inl),
                     edge_rot_deg=round(ang, 2), edge_t_res=round(t_res, 3))
            )
            return
        # Pre-correction reprojection baseline, computed only once the
        # edge-satisfaction gate has passed (a gate-rejected closure used
        # to pay a full-map problem pack + device dispatch for nothing).
        prob0 = self.map.to_ba_problem(self.cfg.intrinsics)
        err0_d, w0_d = ba_mod.reproj_errors(prob0)
        lc_mod.apply_pose_graph_correction(
            self.map, R_new, t_new, s_new
        )
        prob1 = self.map.to_ba_problem(self.cfg.intrinsics)
        err1_d, w1_d = ba_mod.reproj_errors(prob1)
        err0, w0, err1, w1 = _fetch_now(err0_d, w0_d, err1_d, w1_d)
        thr = 3.0 * ba_mod.HUBER_DELTA
        n0 = max(float(w0.sum()), 1.0)
        blown0 = float(((err0 > thr) * w0).sum() / n0)
        blown1 = float(((err1 > thr) * w1).sum() / max(float(w1.sum()), 1.0))
        # Threshold calibrated across every observed closure attempt:
        # genuine revisits re-blow 0.004-0.067 of observations after the
        # Sim3 correction (the follow-up global BA pulls those back in),
        # while false/broken-scale corrections blow 0.17-0.22. The earlier
        # +0.02 allowance rejected real closures whose correction was
        # merely imperfect (measured: 6/6 genuine attempts rejected at
        # 0.04-0.067, costing the closure entirely).
        if blown1 > blown0 + 0.08:
            (self.map.kf_R, self.map.kf_t,
             self.map.pt_xyz, self.map.kf_scale_meas) = saved
            self._loop_edges.pop()
            self.stats["loop_rejected_warp"] = (
                self.stats.get("loop_rejected_warp", 0) + 1
            )
            self.stats.setdefault("loop_rejected_detail", []).append(
                dict(kf=int(kf_id), cand=int(cand), n_inl=int(n_inl),
                     blown_before=round(blown0, 4),
                     blown_after=round(blown1, 4),
                     log_s_m=round(float(self._loop_edges_last_ls), 4))
            )
            return
        if len(sel):
            self.map.add_observations(
                kf_id, pt_ids, np.asarray(feats.uv)[idx2_host[sel]]
            )
        self._rewrite_keyframe_trajectory(old_R=saved[0], old_t=saved[1])
        # Reset tracking around the corrected pose/map; in-flight pipelined
        # frames referenced the pre-correction world and must not keyframe.
        # Anchor on the LATEST keyframe: the async verify consume can land
        # after a newer keyframe was inserted, and rewinding the tracker to
        # the older closure keyframe would corrupt the pose chain.
        anchor = self._last_kf_id if self._last_kf_id is not None else kf_id
        self._snapshot = self.map.local_snapshot(anchor)
        self._snap_epoch += 1
        self._state_token += 1
        self._prev_R = self.map.kf_R[anchor].copy()
        self._prev_t = self.map.kf_t[anchor].copy()
        self._pose_dev = None
        self._last_loop_kf = kf_id
        self.stats["loop_closures"] = self.stats.get("loop_closures", 0) + 1
        # Acceptance record for offline diagnosis: which keyframe closed
        # against which candidate, with how many verified inliers, and the
        # blown-observation fractions the warp validation compared.
        self.stats.setdefault("loop_accepted", []).append(
            dict(kf=int(kf_id), cand=int(cand), n_inl=int(n_inl),
                 blown_before=round(blown0, 4), blown_after=round(blown1, 4))
        )
        # Fresh full BA over the corrected map (replaces the discarded one).
        self._dispatch_ba(kf_id, scale_gauge=False)

    def _padded_loop_edges(self):
        """Loop-edge arrays padded to an 8-edge bucket (each distinct edge
        count is a fresh XLA compile). Returns None when no edges."""
        E = len(self._loop_edges)
        if E == 0:
            return None
        cap = 8 * ((E + 7) // 8)
        e_i = np.zeros(cap, np.int32)
        e_j = np.zeros(cap, np.int32)
        Z_R = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
        Z_t = np.zeros((cap, 3), np.float32)
        Z_ls = np.zeros(cap, np.float32)
        w = np.zeros(cap, np.float32)
        for n, (i, j, zr, zt, ls) in enumerate(self._loop_edges):
            e_i[n], e_j[n] = i, j
            Z_R[n], Z_t[n] = zr, zt
            Z_ls[n] = ls
            w[n] = self.cfg.loop.edge_weight
        return e_i, e_j, Z_R, Z_t, Z_ls, w

    def _build_pose_graph(self, include_loops: bool = True):
        """SE3 keyframe chain + scale edges (+ accumulated loop edges).
        The scale edges carry INSERTION-TIME relative-translation norms
        (kf_scale_meas ≙ AddScalingEdge, LocalBA.py:115-131) — the
        drift-limiting anchors the monocular final pass depends on."""
        pg = pose_graph_mod()
        g = pg.from_keyframe_chain(
            jnp.asarray(self.map.kf_R),
            jnp.asarray(self.map.kf_t),
            jnp.asarray(self.map.kf_valid),
            scale_meas=jnp.asarray(self.map.kf_scale_meas[1:]),
        )
        edges = self._padded_loop_edges()
        if edges is None or not include_loops:
            return g
        e_i, e_j, Z_R, Z_t, _, w = edges
        return pg.add_edges(g, e_i, e_j, Z_R, Z_t, w)

    def _build_sim3_graph(self):
        """7-DoF (Sim3) keyframe chain + loop edges with measured relative
        scale — the monocular pose graph (config #4 scale-drift
        correction; see models/pose_graph.py Sim3 notes)."""
        pg = pose_graph_mod()
        g = pg.sim3_from_keyframe_chain(
            jnp.asarray(self.map.kf_R),
            jnp.asarray(self.map.kf_t),
            jnp.asarray(self.map.kf_valid),
        )
        edges = self._padded_loop_edges()
        if edges is None:
            return g
        e_i, e_j, Z_R, Z_t, Z_ls, w = edges
        return pg.sim3_add_edges(g, e_i, e_j, Z_R, Z_t, Z_ls, w)

    def _optimize_pose_graph_arrays(self, n_iters: int, final: bool = False):
        """Run the appropriate pose graph. Returns host arrays (R, t,
        s|None).

        Metric/RGB-D: SE3 chain + scale edges + loop edges.

        Monocular at a LOOP CLOSURE (final=False): the Sim3 graph — the
        only correction that survives scale drift (see pose_graph Sim3
        notes).

        Monocular FINAL pass (final=True): SE3 chain + scale edges
        WITHOUT loop edges FIRST. The scale edges carry insertion-time
        ||t_rel|| anchors that limit the gauge wander BA accumulates over
        hundreds of keyframes — dropping this pass (the round-4 Sim3
        switch briefly did: a no-loop Sim3 chain graph is measured from
        current poses and is a NO-OP) let the full-sequence raw scale
        drift explode to >3x and ATE to 0.58. Any accumulated loop edges
        then get a Sim3 polish on top (they were already applied in-run;
        this re-asserts them against the smoothed chain).
        """
        pg = pose_graph_mod()
        use_dcs = bool(self._loop_edges)
        if self.cfg.use_depth:
            g = self._build_pose_graph()
            R, t, _ = pg.optimize(g, n_iters=n_iters, use_dcs=use_dcs)
            return np.asarray(R), np.asarray(t), None
        if final:
            g = self._build_pose_graph(include_loops=False)
            R, t, _ = pg.optimize(g, n_iters=n_iters, use_dcs=False)
            if not self._loop_edges:
                return np.asarray(R), np.asarray(t), None
            # Apply the smoothing, then polish with the Sim3 loop graph.
            old_R, old_t = self.map.kf_R.copy(), self.map.kf_t.copy()
            lc_mod.apply_pose_graph_correction(
                self.map, np.asarray(R), np.asarray(t)
            )
            self._rewrite_keyframe_trajectory(old_R=old_R, old_t=old_t)
        g = self._build_sim3_graph()
        R, t, lam, _ = pg.optimize_sim3(g, n_iters=n_iters, use_dcs=use_dcs)
        s = np.exp(np.asarray(lam)).astype(np.float32)
        self.stats["pgo_max_abs_log_scale"] = round(
            float(np.max(np.abs(np.asarray(lam)))), 4
        )
        return np.asarray(R), np.asarray(t), s

    def _rewrite_keyframe_trajectory(
        self, old_R: np.ndarray | None = None, old_t: np.ndarray | None = None
    ) -> None:
        """Propagate a map correction (pose graph / loop closure) into the
        stored trajectory.

        Keyframe entries take their keyframe's corrected pose directly.
        When the PRE-correction keyframe poses are supplied, non-keyframe
        entries move through their reference keyframe: the frame's pose
        relative to that keyframe is correction-invariant, so
        T_frame_new = (T_frame_old ∘ T_kf_old⁻¹) ∘ T_kf_new. Without this,
        a large correction left ~90% of the trajectory (the tracking
        frames) in the pre-correction world — measured full-sequence mono:
        an accepted closure made ATE WORSE (0.064 no-loop vs 0.081-0.121
        with) because the evaluated trajectory mixed the two worlds.
        """
        kf_by_frame = {
            int(f): k
            for k, f in enumerate(self.map.kf_frame_idx)
            if self.map.kf_valid[k]
        }
        for fr in self.trajectory:
            k = kf_by_frame.get(fr.frame_idx)
            if k is not None:
                fr.R_cw = self.map.kf_R[k].copy()
                fr.t_cw = self.map.kf_t[k].copy()
            elif old_R is not None and 0 <= fr.ref_kf < len(old_R):
                a = fr.ref_kf
                if not self.map.kf_valid[a]:
                    continue
                R_rel = fr.R_cw @ old_R[a].T
                t_rel = fr.t_cw - R_rel @ old_t[a]
                fr.R_cw = (R_rel @ self.map.kf_R[a]).astype(np.float32)
                fr.t_cw = (R_rel @ self.map.kf_t[a] + t_rel).astype(np.float32)

    def _reproj_blown_fraction(self) -> float:
        """Weighted fraction of map observations beyond the Huber regime —
        the house map-consistency proxy (same metric the loop-closure warp
        validation uses)."""
        prob = self.map.to_ba_problem(self.cfg.intrinsics)
        e_d, w_d = ba_mod.reproj_errors(prob)
        e, w = _fetch_now(e_d, w_d)
        thr = 3.0 * ba_mod.HUBER_DELTA
        return float(((e > thr) * w).sum() / max(float(w.sum()), 1.0))

    def optimize_pose_graph(self, n_iters: int = 15) -> None:
        """Final keyframe pose-graph optimization with scale edges and any
        accumulated loop edges (config #4 scale-drift correction; ≙ the
        EdgeSE3/EdgeSBAScale chain the reference builds in LocalBA.py:97-131).
        Updates keyframe poses (landmarks re-anchored) and rewrites the
        whole trajectory (non-keyframe entries move through their
        reference keyframe — see _rewrite_keyframe_trajectory).

        FINAL-PASS POLICY (r5, measured): when loop closures were APPLIED
        in-run, the map is already loop-consistent — the in-run Sim3
        corrections consumed the loop information, and re-asserting the
        (gauge-stale) loop edges against a freshly smoothed chain INJECTS
        error (1200-frame mono, isolated on one run's end state: no final
        pass ATE 0.0566 / SE3-smoothing-only 0.0602 / full final pass
        0.0676, with the blown-observation fraction tracking the damage
        0.0 -> 0.0002 -> 0.0141). The final pass is therefore SKIPPED when
        closures were applied. Runs WITHOUT in-run closures keep the
        load-bearing scale-edge smoothing (dropping it measured raw scale
        drift >3x / ATE 0.58 in r4), warp-validated at +0.005 blown with
        revert — the same guard loop corrections carry."""
        # Land the deferred mine first WITH its BA (the final keyframe's
        # mined points would otherwise never be optimized), then everything
        # else still in flight.
        self._apply_pending_mine(force=True, dispatch_ba=True)
        self._apply_pending_ba(force=True)
        if self.stats.get("loop_closures", 0) > 0:
            self.stats["final_pass"] = "skipped_closures_applied"
            return
        saved = (
            self.map.kf_R.copy(), self.map.kf_t.copy(),
            self.map.pt_xyz.copy(), self.map.kf_scale_meas.copy(),
            [(f.R_cw.copy(), f.t_cw.copy()) for f in self.trajectory],
        )

        def restore():
            (self.map.kf_R, self.map.kf_t, self.map.pt_xyz,
             self.map.kf_scale_meas) = (
                saved[0].copy(), saved[1].copy(), saved[2].copy(),
                saved[3].copy(),
            )
            for f, (Rs, ts) in zip(self.trajectory, saved[4]):
                f.R_cw, f.t_cw = Rs.copy(), ts.copy()

        blown0 = self._reproj_blown_fraction()
        R, t, s = self._optimize_pose_graph_arrays(n_iters, final=True)
        old_R, old_t = self.map.kf_R.copy(), self.map.kf_t.copy()
        lc_mod.apply_pose_graph_correction(self.map, R, t, s)
        self._rewrite_keyframe_trajectory(old_R=old_R, old_t=old_t)
        if self._reproj_blown_fraction() <= blown0 + 0.005:
            self.stats["final_pass"] = "smooth"
            return
        restore()
        self.stats["final_pass"] = "reverted"
        # NO BA after the final correction: probed — a post-correction
        # global BA pulls keyframes back toward the reprojection optimum
        # of the still drift-scaled landmark field, undoing part of the
        # pose-graph correction (1200-frame mono ATE 0.075 -> 0.083).

    # ------------------------------------------------------------------ eval

    def positions(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame_indices (N,), camera centres (N,3)) of the trajectory."""
        idxs = np.array([f.frame_idx for f in self.trajectory])
        R = np.stack([f.R_cw for f in self.trajectory])
        t = np.stack([f.t_cw for f in self.trajectory])
        centres = -np.einsum("nji,nj->ni", R, t)
        return idxs, centres


def size_config_for(n_frames: int, config: SlamConfig | None = None) -> SlamConfig:
    """Size map capacities for an n-frame run (keyframe cadence is bounded
    below by the 20-frame rule, so ~n/10 keyframes is a safe ceiling)."""
    cfg = config or SlamConfig()
    need_kf = max(64, 2 ** int(np.ceil(np.log2(max(n_frames // 8, 1)))))
    if cfg.map.max_keyframes < need_kf:
        cfg.map.max_keyframes = need_kf
        cfg.map.max_points = max(cfg.map.max_points, need_kf * 128)
        cfg.map.max_observations = max(cfg.map.max_observations, need_kf * 512)
    if n_frames > 600 and cfg.ba.every_n_kf == 1:
        # Full-BA cadence on long monocular sequences, set by A/B on the
        # 1200-frame lr traj3 run (deterministic pipelined driver, final
        # pose graph): every keyframe ATE 0.0738 / every 2nd 0.0482 /
        # every 3rd 0.0404 / every 6th 0.0553 — per-keyframe global BA
        # over-drags the monocular gauge (each apply also churns the
        # snapshot/veto state), while starving BA (6) lets drift build.
        # 2 is the least deviation from the reference's every-keyframe
        # semantics (main.py:322-323) that sits on the good side of the
        # curve; short runs keep exact reference cadence.
        cfg.ba.every_n_kf = 2
    return cfg


def run_pipelined(
    slam: "Slam",
    frame_iter,
    pipeline_depth: int = 8,
    h2d_block: int = 4,
    prof: dict | None = None,
    on_frame=None,
):
    """Drive a Slam over (frame_idx, image_or_feats, depth) tuples with a
    `pipeline_depth`-deep in-flight window.

    h2d_block > 1 transfers host images in stacked blocks — one device_put
    per block, sliced on device (the default blocks 4 frames per
    transfer).
    Consumes run at the depth cap. Keyframe/failure logic therefore lags
    ~pipeline_depth frames; stale keyframe candidates are re-tracked
    against the current snapshot in _consume_track.
    `prof`: optional dict accumulating per-phase wall seconds.
    """
    import os as _os
    import time as _time
    from collections import deque

    cfg = slam.cfg
    slam._async_init_verify = True  # see _consume_init / _check_init_verify
    init_pending: deque = deque()
    depth_cap = pipeline_depth
    # Tracking consumes are CHUNKED: each chunk's blobs are jnp.stack'd
    # into ONE device array whose async copy starts a chunk ahead, and the
    # chunk lands with ONE fetch. Frames in flight =
    # chunk_depth*consume_chunk + partial. Chunk of 4: one fetch per 4
    # frames with a 4-8 frame decision lag — chunk 8 halved the fetch
    # count again but the 8-16 frame lag broke full-sequence geometry
    # (1200-frame mono ATE 0.055 -> 0.567, loop closure never fired).
    consume_chunk = 4
    chunk_depth = max(1, depth_cap // consume_chunk)
    cur: list = []  # dispatched handles awaiting stacking
    chunks: deque = deque()  # {fut (host fetch future), handles}
    # Background fetch threads: the blocking device->host read releases
    # the GIL, so a worker waits for each chunk while the main thread keeps
    # dispatching. Four workers, so one slow chunk does not hold back the
    # reads of the chunks behind it.
    from concurrent.futures import ThreadPoolExecutor

    fetch_pool = ThreadPoolExecutor(max_workers=4)

    def land_chunk(c):
        with slam.timers.time("track_fetch"):
            rows = c["fut"].result()
        for h2, row in zip(c["handles"], rows):
            slam._consume_track(h2, row)

    def push_track_handle(h):
        cur.append(h)
        if len(cur) == consume_chunk:
            stacked = jnp.stack([h2["blob"] for h2 in cur])
            _fetch_async(stacked)
            fut = fetch_pool.submit(np.asarray, stacked)
            chunks.append(dict(fut=fut, handles=cur.copy()))
            cur.clear()

    def drain_tracking(target_chunks):
        while len(chunks) > target_chunks:
            land_chunk(chunks.popleft())
    # Init attempts pipeline deeper than tracking: init dispatches are
    # cheap (the flow gate makes most attempts one descriptor match), so
    # up to 40 attempts stay in flight while their blobs land. Each
    # in-flight attempt is one ~65 KB blob + one feature set.
    init_cap = max(depth_cap, 40)
    init_prepared: list = []  # at most one pre-stacked init chunk in flight
    consume_chunk = 4  # frames per grouped consume flush (see below)
    # Handles consumed while an async init confirm was in flight (the
    # pending-verify branch of _consume_init returns False for them). On
    # acceptance these frames are NEWER than the accepted pair and must
    # become tracking frames — discarding them leaves a ~confirm-age hole
    # in the trajectory (ADVICE r4 medium). drain_init_to_tracking
    # converts them; frames at/before the accepted pair filter out there.
    verify_buffer: list = []

    def consume_init_buffered(h2, row=None):
        """_consume_init, but a handle rejected while a confirm was
        pending is kept for drain_init_to_tracking (see verify_buffer)."""
        was_pending = slam._pending_init_verify is not None
        ok = slam._consume_init(h2, row)
        if not ok and was_pending:
            h2["was_verify_buffered"] = True
            verify_buffer.append(h2)
            # Bounded: in a run that never accepts, confirms are in flight
            # most of the time and the buffer would otherwise pin device
            # blobs (~100 KB/frame) for the whole run. 64 comfortably
            # covers the init backlog (~44) + confirm window; frames
            # dropped beyond that predate any acceptable candidate.
            if len(verify_buffer) > 64:
                verify_buffer.pop(0)
        return ok

    def tick(key, t0):
        if prof is not None:
            prof[key] = prof.get(key, 0.0) + (_time.perf_counter() - t0)

    def drain_init_to_tracking():
        """On init acceptance, convert the in-flight init attempts (frames
        NEWER than the accepted pair) into tracking dispatches — their
        features are already on device, and dropping them would leave a
        pipeline-depth-sized hole in the trajectory. Prepared chunks are
        converted first (they hold the oldest in-flight frames), keeping
        the trajectory in frame order. Then consume down to the tracking
        depth: the init pipeline is much deeper (init_cap), and leaving
        its backlog in `pending` would lag every keyframe decision by
        init_cap frames for the rest of the run."""
        leftover = []
        # verify_buffer first: those frames were consumed from prepared
        # chunks and are the OLDEST in flight — keep the trajectory in
        # frame order.
        if _os.environ.get("VSLAM_VERIFY_BUFFER", "1") != "0":
            leftover.extend(verify_buffer)
        verify_buffer.clear()
        for _fut, head in init_prepared:
            leftover.extend(head)
        init_prepared.clear()
        leftover.extend(init_pending)
        init_pending.clear()
        _v = slam.stats.get("init_frame")
        accepted = -1 if _v is None else _v
        # Frames recovered from the confirm-in-flight window (the
        # verify_buffer prefix of `leftover`) get POSES — dropping them
        # left a hole in the trajectory (ADVICE r4 medium) — but stay
        # COMPLETELY outside the live tracking stream: no keyframe
        # candidacy, no cadence-counter ticks, no chunk-boundary shift,
        # and a SIDE pose chain (the main chain is saved and restored so
        # the live stream's seeds are bit-identical to the no-backfill
        # path). Measured: pushing them through the regular chunked
        # stream shifted every downstream consume tick and moved
        # 1200-frame mono ATE from 0.093 to 0.159 with an unchanged
        # keyframe policy.
        backfill: list = []
        pose_chain_save = slam._pose_dev
        key_save = slam.key  # PRNG stream must match the no-backfill path
        for h2 in leftover:
            if h2["frame_idx"] <= accepted or not h2.get("was_verify_buffered"):
                continue
            th = slam._dispatch_track(
                h2["frame_idx"], h2["feats"], h2.get("depth")
            )
            th["backfill"] = True
            backfill.append(th)
        slam._pose_dev = pose_chain_save
        slam.key = key_save
        for h2 in leftover:
            if h2["frame_idx"] <= accepted or h2.get("was_verify_buffered"):
                continue
            slam._apply_pending_ba()
            push_track_handle(
                slam._dispatch_track(
                    h2["frame_idx"], h2["feats"], h2.get("depth")
                )
            )
        if backfill:
            # One grouped flush (NOT a jnp.stack: a fresh N-way concatenate
            # shape costs a compile for a once-per-run fetch).
            rows = _fetch_now(*[th["blob"] for th in backfill])
            for th, row in zip(backfill, rows):
                slam._consume_track(th, row)
        drain_tracking(chunk_depth)

    def dispatch(i, feats, depth):
        if not slam.initialized:
            if cfg.use_depth and depth is not None:
                # RGB-D initializes immediately from the first frame's
                # depth — there is no two-view search to pipeline. (Without
                # this branch an RGB-D pipelined run silently initialized
                # MONOCULARLY: an arbitrary-scale map that the metric
                # inverse-depth BA residuals then fight every iteration.)
                slam._try_initialize(i, feats, depth)
                return
            t0 = _time.perf_counter()
            # Async candidate confirm (one per candidate pair; consumed at
            # a fixed tick age). On acceptance this frame falls through to
            # the tracking branch below.
            if slam._check_init_verify():
                tick("consume_init", t0)
                drain_init_to_tracking()
            else:
                _dispatch_init_attempt(i, feats, depth, t0)
                return
        init_pending.clear()  # drop superseded init attempts
        t0 = _time.perf_counter()
        slam._apply_pending_ba()
        tick("apply_ba", t0)
        t0 = _time.perf_counter()
        push_track_handle(slam._dispatch_track(i, feats, depth))
        tick("dispatch_track", t0)
        t0 = _time.perf_counter()
        # Land the oldest chunk once chunk_depth newer ones are in
        # flight; keyframe decisions lag <= (chunk_depth+1)*chunk
        # frames, which the stale-candidate re-track path absorbs.
        drain_tracking(chunk_depth)
        tick("consume_track", t0)

    def _dispatch_init_attempt(i, feats, depth, t0):
        h = slam._dispatch_init(i, feats)
        if h is not None:
            h["depth"] = depth
            init_pending.append(h)
        tick("dispatch_init", t0)
        t0 = _time.perf_counter()
        # Chunked init consume with one-frame prepare-ahead: the
        # chunk's blobs stack into ONE array (separate arrays do not
        # amortize) whose async copy gets a frame of head start
        # before the fetch.
        if init_prepared and (
            init_prepared[0][0].done() or len(init_prepared) >= 2
        ):
            fut, head = init_prepared.pop(0)
            t1 = _time.perf_counter()
            rows = fut.result()
            tick("init_fetch_wait", t1)
            t1 = _time.perf_counter()
            for r, h2 in enumerate(head):
                if slam.initialized:
                    # Frames after the accepted pair become tracking
                    # dispatches (their features are on device).
                    slam._apply_pending_ba()
                    push_track_handle(slam._dispatch_track(
                        h2["frame_idx"], h2["feats"], h2.get("depth")
                    ))
                elif consume_init_buffered(h2, rows[r]):
                    drain_init_to_tracking()
            tick("init_consume_host", t1)
        if len(init_prepared) < 2 and len(init_pending) > init_cap:
            k = min(consume_chunk, len(init_pending))
            head = [init_pending.popleft() for _ in range(k)]
            t1 = _time.perf_counter()
            stacked = jnp.stack([h2["blob"] for h2 in head])
            _fetch_async(stacked)
            init_prepared.append(
                (fetch_pool.submit(np.asarray, stacked), head)
            )
            tick("init_stack", t1)
        tick("consume_init", t0)

    def extract_dev(img_dev):
        t0 = _time.perf_counter()
        f = frontend.extract(
            img_dev, cfg.frontend.max_features,
            cfg.frontend.quality_level, cfg.frontend.nms_radius,
        )
        tick("extract", t0)
        return f

    block: list = []  # host-image frames awaiting one blocked H2D

    def flush_block():
        if not block:
            return
        t0 = _time.perf_counter()
        if len(block) == 1:
            devs = [jax.device_put(block[0][1])]
        else:
            stacked = jax.device_put(np.stack([b[1] for b in block]))
            devs = [stacked[k] for k in range(len(block))]
        tick("h2d", t0)
        for (i, _, depth), d in zip(block, devs):
            dispatch(i, extract_dev(d), depth)
        block.clear()

    # try/finally (ADVICE r4): an exception mid-run must not leave
    # _async_init_verify=True on the Slam object (subsequent serial
    # process_frame calls would dispatch confirms nothing consumes and
    # initialization could never succeed) or the fetch pool running.
    try:
        for i, img, depth in frame_iter:
            if isinstance(img, frontend.Features):
                flush_block()
                dispatch(i, img, depth)
            elif isinstance(img, np.ndarray):
                block.append((i, img, depth))
                if len(block) >= max(h2d_block, 1):
                    flush_block()
            else:  # already a device array
                flush_block()
                dispatch(i, extract_dev(jnp.asarray(img)), depth)
            if on_frame is not None:
                # Observability hook (≙ the reference viewer's per-frame
                # Queue feed, viewer.py:21-35). Map state lags
                # ~pipeline_depth frames.
                on_frame(slam, i)
        flush_block()
        while init_prepared:
            fut, head = init_prepared.pop(0)
            rows = fut.result()
            for r, h2 in enumerate(head):
                if slam.initialized:
                    slam._apply_pending_ba()
                    push_track_handle(slam._dispatch_track(
                        h2["frame_idx"], h2["feats"], h2.get("depth")
                    ))
                elif (
                    consume_init_buffered(h2, rows[r])
                    or slam._check_init_verify(force=True)
                ):
                    drain_init_to_tracking()
        while init_pending and not slam.initialized:
            if (
                consume_init_buffered(init_pending.popleft())
                or slam._check_init_verify(force=True)
            ):
                drain_init_to_tracking()
                break
        if not slam.initialized and slam._check_init_verify(force=True):
            drain_init_to_tracking()
        if cur:  # stack & land the trailing partial chunk too
            stacked = jnp.stack([h2["blob"] for h2 in cur])
            _fetch_async(stacked)
            chunks.append(dict(
                fut=fetch_pool.submit(np.asarray, stacked),
                handles=cur.copy(),
            ))
            cur.clear()
        drain_tracking(0)
        # Apply the BA dispatched at the final keyframe — nothing after the
        # stream end would otherwise force it, discarding the last
        # keyframe's optimization and observation pruning.
        slam._apply_pending_mine(force=True, dispatch_ba=True)
        slam._apply_pending_ba(force=True)
    finally:
        slam._async_init_verify = False
        slam._pending_init_verify = None
        fetch_pool.shutdown(wait=False)
    return slam


def run_windowed(
    slam: "Slam",
    frame_iter,
    window: int = 8,
    on_frame=None,
):
    """Drive a Slam with W-frame device-side tracking windows.

    Each window is ONE device dispatch + ONE packed fetch (_track_window:
    the extract->match->PnP loop runs on device via lax.scan; the keyframe
    rule is applied by the host while walking the fetched rows —
    _walk_window). Windows are speculatively double-buffered: window k+1
    is dispatched (pose carry chained on device) before window k's rows
    are walked, hiding each window's fetch under the next window's
    compute.

    Staleness discipline (the round-3 full-sequence collapse was here):
    keyframe candidates and failures observed in rows whose dispatch
    snapshot has been superseded are re-confirmed against the current map
    with one synchronous re-track (see _walk_window), and a pending mine
    is force-applied before each dispatch so the snapshot never lags
    mining by more than the one in-flight speculative window.

    The init phase uses the windowed pre-screen (one _init_scan_window
    dispatch per window, full init attempts only on flow-gated candidates).

    The per-frame pipelined loop (run_pipelined) is the production
    default; this driver is the maximum-device-rate variant whose scans
    also back the multi-sequence batched mode (multi.run_batched_windowed).
    """
    it = iter(frame_iter)
    carry: list = []  # frames to (re)process first: [(idx, gray, depth)]

    def next_frame():
        if carry:
            return carry.pop(0)
        try:
            return next(it)
        except StopIteration:
            return None

    if not slam.initialized:
        if slam.cfg.use_depth:
            # RGB-D initializes from the first frame's depth (no two-view
            # search): plain per-frame processing.
            while not slam.initialized:
                fr = next_frame()
                if fr is None:
                    return slam
                slam.process(fr[0], fr[1], fr[2])
                if on_frame is not None:
                    on_frame(slam, fr[0])
        else:
            # Monocular: windowed init — one cheap pre-screen dispatch per
            # window (_init_scan_window), then at most one full two-view
            # attempt on the best candidate. Frames after an accepted
            # candidate flow into the tracking phase below.
            cfg = slam.cfg
            while not slam.initialized:
                win = []
                while len(win) < window:
                    fr = next_frame()
                    if fr is None:
                        break
                    win.append(fr)
                if not win:
                    return slam
                if slam._init_feats is None:
                    feats0 = frontend.extract(
                        jnp.asarray(win[0][1]), cfg.frontend.max_features,
                        cfg.frontend.quality_level, cfg.frontend.nms_radius,
                    )
                    slam._dispatch_init(win[0][0], feats0)  # sets the anchor
                    if on_frame is not None:
                        on_frame(slam, win[0][0])
                    win = win[1:]
                    if not win:
                        continue
                f0 = slam._init_feats
                n_real = len(win)
                # Pad to the fixed window size: every distinct scan length
                # is a separate XLA compile.
                grays = np.stack(
                    [w[1] for w in win] + [win[-1][1]] * (window - n_real)
                )
                scal = _init_scan_window(
                    jax.device_put(np.ascontiguousarray(grays)),
                    f0.desc, f0.uv, f0.valid,
                    cfg.frontend.match_ratio, cfg.frontend.max_hamming,
                    window=window,
                    max_features=cfg.frontend.max_features,
                    quality_level=cfg.frontend.quality_level,
                    nms_radius=cfg.frontend.nms_radius,
                    cross_check=cfg.frontend.cross_check,
                    xla_frontend=frontend.FRONTEND_BACKEND == "xla",
                )
                (scal_np,) = _fetch_now(scal)
                scal_np = scal_np[:n_real]
                ok = (scal_np[:, 0] >= cfg.twoview.min_matches) & (
                    scal_np[:, 1] >= cfg.twoview.min_flow_px
                )
                cands = np.where(ok)[0]
                if len(cands) == 0:
                    continue
                # Up to 6 evenly spaced candidates, in frame order: the
                # accept band is narrow (early frames fail validFraction,
                # late frames lose matches to the widening baseline), so a
                # spread of full attempts brackets it. All attempts dispatch
                # async; their blobs land in ONE flush; _consume_init walks
                # them in order and the FIRST pair passing every gate
                # initializes — ≙ the reference's first-accepting-pair rule
                # (main.py:136-138) at window granularity.
                if len(cands) > 6:
                    # 6 is a balance: each attempt is a 512-hypothesis
                    # essential RANSAC, and the acceptance-reverification
                    # pass (below, in
                    # _consume_init) guards the quality that a denser
                    # spread used to buy.
                    cands = cands[np.round(np.linspace(0, len(cands) - 1, 6)).astype(int)]
                handles = []
                for c in cands:
                    idx, gray, depth = win[int(c)]
                    feats = frontend.extract(
                        jnp.asarray(gray), cfg.frontend.max_features,
                        cfg.frontend.quality_level, cfg.frontend.nms_radius,
                    )
                    h = slam._dispatch_init(idx, feats)
                    if h is None:
                        # Re-anchor fired: this frame IS the new anchor, and
                        # the remaining candidates were pre-screened against
                        # the OLD anchor — dispatching them against the new
                        # one (a few frames away, near-zero flow) would
                        # waste a full RANSAC attempt each.
                        break
                    h["win_pos"] = int(c)
                    handles.append(h)
                _fetch_now(*[h["blob"] for h in handles])
                for h in handles:
                    if slam._consume_init(h):
                        # Remaining frames of this window enter tracking.
                        carry[:0] = win[h["win_pos"] + 1 :]
                        if on_frame is not None:
                            on_frame(slam, h["frame_idx"])
                        break

    # Speculative double-buffering: window k+1 is DISPATCHED (pose carry
    # chained on device) before window k's results are walked, so k's
    # result fetch and the host walk hide under k+1's device
    # compute. Window k+1 legitimately runs against k's snapshot — that is
    # the reference's frozen local-map-copy semantics (main.py:154,333) —
    # and any keyframe candidate inside it re-tracks via the stale-window
    # path. Only a tracking FAILURE invalidates the speculation: the pose
    # chain is garbage, so the speculated window's frames are re-queued.
    carry_dev = None  # (R, t) device outputs of the last dispatched window
    inflight = None  # (handle, win) dispatched but not yet walked

    def assemble():
        win = []
        while len(win) < window:
            fr = next_frame()
            if fr is None:
                break
            win.append(fr)
        return win

    def dispatch(win):
        n_real = len(win)
        grays = [w[1] for w in win] + [win[-1][1]] * (window - n_real)
        return slam._dispatch_track_window(np.stack(grays), carry_dev)

    def walk(h, win):
        # ONE array, ONE fetch for the whole window's outputs (~1 MB);
        # its async copy has been landing while the next window computed.
        (blobs_np,) = _fetch_now(h["blobs"])
        return _walk_window(
            slam, win, blobs_np, h["snap"], on_frame,
            mine_pending=h["mine_pending"], snap_epoch=h["snap_epoch"],
        )

    while True:
        win = assemble()
        if not win:
            break
        # A pending mine here means the LAST walk inserted a keyframe: land
        # it now (forced) so this dispatch's snapshot carries the mined
        # landmarks. Unforced, the snapshot lagged mining by 2-3 windows
        # and the keyframe cadence locked to window boundaries against
        # perpetually starved maps (measured: keyframes at exact multiples
        # of the window size, adjacent-pair duplicates, fullseq ATE 0.17 vs
        # the pipelined driver's 0.03). The spin is bounded by the in-
        # flight window's remaining compute — at keyframe cadence, cheaper
        # than the staleness. The BA stays unforced: the insertion-time
        # drop policy (_drop_or_apply_pending_ba) keeps it consistent.
        slam._apply_pending_mine(force=slam._pending_mine is not None)
        slam._apply_pending_ba()
        h = dispatch(win)
        carry_dev = h["carry"]
        if inflight is not None:
            h_prev, win_prev = inflight
            replay = walk(h_prev, win_prev)
            if replay:
                # Tracking failure: the speculated window `win` rode the
                # garbage pose chain — abandon its results and re-queue
                # both the post-failure frames and the speculated frames.
                carry[:0] = replay + win
                carry_dev = None
                inflight = None
                slam.stats["windows_respeculated"] = (
                    slam.stats.get("windows_respeculated", 0) + 1
                )
                continue
        inflight = (h, win)
    if inflight is not None:
        replay = walk(*inflight)
        while replay:  # drain a trailing failure without speculation
            slam._apply_pending_mine()
            slam._apply_pending_ba()
            carry_dev = None
            carry[:0] = replay
            win = assemble()
            if not win:
                break
            h = dispatch(win)
            carry_dev = h["carry"]
            replay = walk(h, win)
    slam._apply_pending_mine(force=True, dispatch_ba=True)
    slam._apply_pending_ba(force=True)  # final keyframe's BA
    return slam


def _walk_window(slam, win, blobs_np, snap, on_frame=None,
                 mine_pending=False, snap_epoch=None):
    """Walk one window's FETCHED blob rows (W, TOT), applying the host-side
    keyframe rule (≙ main.py:221) to every row.

    Shared by run_windowed (single sequence) and multi.run_batched_windowed
    (one walk per sequence slice).

    The window's dispatch snapshot is AUTHORITATIVE for every row: the rule
    compares the row's inlier count against that same snapshot's landmark
    count (self-consistent, exactly the reference's frozen local-map-copy
    semantics, main.py:154,333 — at window granularity instead of keyframe
    granularity), and a keyframe row inserts directly with the snapshot's
    landmark ids (global ids, valid regardless of later snapshot rebuilds).
    A keyframe does NOT invalidate the remaining rows for TRACKING (their
    poses stand); only a tracking FAILURE breaks the pose chain, and the
    frames after it are returned for replay.

    Candidates that fire in a STALE window — the dispatch snapshot was
    superseded by a newer keyframe (epoch bump, including insertions made
    earlier in this same walk) or was missing a pending mine's landmarks —
    are RE-TRACKED synchronously against the current snapshot
    (slam._retrack_candidate, the same machinery the pipelined consume
    uses at pipeline.py `_consume_track`) and the keyframe rule re-applied
    with the fresh counts. This is what prevents the round-3 collapse:
    stale windows lag the map by 2-3 windows, their starved counts fire
    the rule spuriously, and inserting without confirmation floods the map
    with starved keyframes until tracking dies (BENCH_r03 fullseq: 651
    failures). One sync per candidate at keyframe cadence is the price
    of a correct cadence; after a VETOED retrack the
    remaining rows of the walk skip further candidate checks (the fresh
    map just proved tracking healthy — repeat retracks would re-veto).

    A FAILED row is likewise retried once against the refreshed snapshot
    before it is declared a failure: with window-lag staleness, "failure"
    is usually just the starved dispatch snapshot, and the retry converts
    it into a tracked frame instead of a relocalize + window replay."""
    n_real = len(win)
    M = int(snap["valid"].shape[0])
    K = int(slam.cfg.frontend.max_features)
    retrack_vetoed = False

    for r in range(n_real):
        idx = win[r][0]
        row = blobs_np[r]
        R_np = row[:9].reshape(3, 3).copy()
        t_np = row[9:12].copy()
        n_in = int(row[12])
        fail = row[14] > 0.5
        if fail:
            _, _, feats = _unpack_blob(row, M, K)
            # Retry against the CURRENT map (pending mine forced in) before
            # declaring failure: the row's snapshot may simply be stale.
            blob2, snap2 = slam._retrack_candidate(
                feats, slam._prev_R, slam._prev_t
            )
            n2 = int(blob2[12])
            if n2 >= slam.cfg.tracking.min_tracked_points:
                slam.stats["fail_retried_ok"] = (
                    slam.stats.get("fail_retried_ok", 0) + 1
                )
                R_np = blob2[:9].reshape(3, 3).copy()
                t_np = blob2[9:12].copy()
                slam._prev_R, slam._prev_t = R_np, t_np
                slam._frames_since_kf += 1
                slam.trajectory.append(FrameResult(
                    idx, R_np, t_np, n2, False,
                    ref_kf=slam._last_kf_id if slam._last_kf_id is not None else -1,
                ))
                if on_frame is not None:
                    on_frame(slam, idx)
                # The device pose chain held the last good pose on failure,
                # which is what the retry recovered: later rows remain valid.
                continue
            _, R_np, t_np, n_in = slam._handle_track_failure(feats)
            slam._frames_since_kf += 1
            slam.trajectory.append(FrameResult(
                idx, R_np, t_np, n_in, False,
                ref_kf=slam._last_kf_id if slam._last_kf_id is not None else -1,
            ))
            if on_frame is not None:
                on_frame(slam, idx)
            # Later rows tracked through the failed pose chain: replay.
            return win[r + 1 : n_real]
        slam._prev_R, slam._prev_t = R_np, t_np
        slam._frames_since_kf += 1
        is_kf = slam._keyframe_rule(n_in, snap["n_valid"])
        if is_kf and not retrack_vetoed and (
            mine_pending
            or (snap_epoch is not None and snap_epoch != slam._snap_epoch)
        ):
            _, _, feats = _unpack_blob(row, M, K)
            blob2, snap2 = slam._retrack_candidate(feats, R_np, t_np)
            n2 = int(blob2[12])
            if slam._keyframe_rule(n2, snap2["n_valid"]):
                R_np = blob2[:9].reshape(3, 3).copy()
                t_np = blob2[9:12].copy()
                slam._prev_R, slam._prev_t = R_np, t_np
                n_in = n2
                M2 = int(snap2["valid"].shape[0])
                inl, idx2, feats2 = _unpack_blob(blob2, M2, K)
                slam._insert_keyframe(
                    idx, feats2, R_np, t_np, inl, idx2, win[r][2], snap=snap2
                )
                slam.stats["kf_retracked"] = (
                    slam.stats.get("kf_retracked", 0) + 1
                )
            else:
                is_kf = False
                retrack_vetoed = True
                slam.stats["kf_vetoed_stale"] = (
                    slam.stats.get("kf_vetoed_stale", 0) + 1
                )
        elif is_kf and retrack_vetoed:
            is_kf = False
        elif is_kf:
            inl, idx2, feats = _unpack_blob(row, M, K)
            slam._insert_keyframe(
                idx, feats, R_np, t_np, inl, idx2, win[r][2], snap=snap
            )
        slam.trajectory.append(FrameResult(
            idx, R_np, t_np, n_in, is_kf,
            ref_kf=slam._last_kf_id if slam._last_kf_id is not None else -1,
        ))
        if on_frame is not None:
            if getattr(on_frame, "wants_image", False):
                # Live camera view + tracked-match overlay (≙ the match
                # image the reference viewer streams, update_image
                # viewer.py:30-35 fed from main.py:216): lines run from each
                # landmark's keyframe pixel to its current-frame pixel.
                o = _BLOB_HEADER
                inl_v = row[o : o + M] > 0.5
                idx2_v = row[o + M : o + 2 * M].astype(np.int32)
                uv_v = row[o + 2 * M : o + 2 * M + 2 * K].reshape(K, 2)
                on_frame(
                    slam, idx,
                    gray=win[r][1],
                    uv_prev=snap["uv_np"][inl_v],
                    uv_cur=uv_v[idx2_v[inl_v]],
                )
            else:
                on_frame(slam, idx)
    return []


def run_sequence(
    dataset,
    config: SlamConfig | None = None,
    start=0,
    stop=None,
    verbose=False,
    pipelined: bool = False,
    pipeline_depth: int = 8,
    windowed: bool = False,
    window: int = 8,
    on_frame=None,
    prof: dict | None = None,
):
    """Run SLAM over a dataset; returns the Slam object. When no config is
    given, map capacities are sized to the frame range.

    pipelined=True runs the deep software pipeline (see run_pipelined):
    device work for up to `pipeline_depth` frames stays in flight while
    their result fetches complete in the background.

    windowed=True runs `window`-frame device-side tracking windows instead
    (see run_windowed): one dispatch + one fetch per window.

    on_frame: optional per-frame observability callback `(slam, i) -> None`
    (e.g. utils.viz.LiveView — the reference viewer's headless analog).
    """
    if config is None:
        n = (stop if stop is not None else len(dataset)) - start
        config = size_config_for(n)
    slam = Slam(config)
    if windowed:
        return run_windowed(
            slam, dataset.frames(start, stop), window, on_frame=on_frame
        )
    if pipelined:
        return run_pipelined(
            slam, dataset.frames(start, stop), pipeline_depth,
            on_frame=on_frame, prof=prof,
        )
    for i, gray, depth in dataset.frames(start, stop):
        slam.process(i, gray, depth)
        if on_frame is not None:
            on_frame(slam, i)
        if verbose and i % 25 == 0:
            last = slam.trajectory[-1] if slam.trajectory else None
            print(
                f"frame {i}: tracked={getattr(last, 'n_tracked', 0)} "
                f"kf={slam.stats['keyframes']} pts={slam.map.n_pt} init={slam.initialized}"
            )
    return slam


def main():
    import argparse, json, time

    ap = argparse.ArgumentParser(description="Accelerator visual SLAM")
    ap.add_argument(
        "--data", default=None,
        help="ICL-NUIM sequence directory (default: the seeded generated "
        "stream, utils/scene.py)",
    )
    ap.add_argument("--seed", type=int, default=0, help="generated-stream seed")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--features", type=int, default=1024)
    ap.add_argument("--platform", default=None, help="cpu to force CPU")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--rgbd", action="store_true", help="metric RGB-D mode")
    ap.add_argument("--pose-graph", action="store_true", help="final pose-graph refinement")
    ap.add_argument(
        "--windowed", action="store_true",
        help="W-frame device-side tracking windows (one dispatch per window)",
    )
    ap.add_argument("--window", type=int, default=8, help="window size")
    ap.add_argument(
        "--live-dump",
        default=None,
        help="directory for incremental trajectory.png/map.ply/state.json "
        "during the run (headless live viewer)",
    )
    ap.add_argument("--live-every", type=int, default=25, help="live-dump period (frames)")
    ap.add_argument("--export-traj", default=None, help="PNG trajectory plot path")
    ap.add_argument("--export-ply", default=None, help="PLY map export path")
    ap.add_argument("--export-g2o", default=None, help="g2o graph export path")
    ap.add_argument("--checkpoint", default=None, help="npz map checkpoint path")
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils import compile_cache, evaluate

    compile_cache.enable()
    if args.data:
        from .utils.dataset import ICLNUIMDataset

        ds = ICLNUIMDataset(args.data)
    else:
        from .utils.scene import SceneDataset

        ds = SceneDataset(args.start + args.frames, seed=args.seed)
    cfg = size_config_for(args.frames)
    cfg.intrinsics = ds.intrinsics
    cfg.frontend.max_features = args.features
    cfg.use_depth = args.rgbd
    on_frame = None
    if args.live_dump:
        from .utils import viz

        gt_all = ds.ground_truth()
        on_frame = viz.LiveView(
            args.live_dump,
            every=args.live_every,
            gt_positions=gt_all[:, :3, 3] if gt_all is not None else None,
        )
    t0 = time.time()
    slam = run_sequence(
        ds, cfg, args.start, args.start + args.frames,
        verbose=args.verbose, on_frame=on_frame,
        windowed=args.windowed, window=args.window,
    )
    if args.pose_graph and slam.initialized:
        slam.optimize_pose_graph()
    dt = time.time() - t0
    idxs, est = slam.positions()
    out = {
        "frames": len(idxs),
        "fps": len(idxs) / dt,
        "keyframes": slam.stats["keyframes"],
        "points": int(slam.map.pt_valid.sum()),
        "init_frame": slam.stats["init_frame"],
    }
    gt = ds.ground_truth()
    if gt is not None:
        gt_pos = gt[np.clip(idxs, 0, len(gt) - 1), :3, 3]
        rmse, _ = evaluate.ate_rmse(est, gt_pos, align_scale=not args.rgbd)
        out["ate_rmse_m"] = rmse
    if args.export_traj:
        from .utils import viz

        gt_pos = gt[np.clip(idxs, 0, len(gt) - 1), :3, 3] if gt is not None else None
        viz.plot_trajectory(est, gt_pos, args.export_traj)
        out["trajectory_png"] = args.export_traj
    if args.export_ply:
        from .utils import viz

        viz.save_ply(args.export_ply, slam.map.pt_xyz, valid=slam.map.pt_valid)
        out["map_ply"] = args.export_ply
    if args.export_g2o:
        from .utils import g2o_io

        g2o_io.save_pose_graph(
            args.export_g2o,
            slam.map.kf_R,
            slam.map.kf_t,
            slam.map.kf_valid,
            points=slam.map.pt_xyz,
            point_valid=slam.map.pt_valid,
        )
        out["g2o"] = args.export_g2o
    if args.checkpoint:
        from .utils import checkpoint as ckpt

        ckpt.save_map(args.checkpoint, slam.map, est)
        out["checkpoint"] = args.checkpoint
    print(json.dumps(out))


if __name__ == "__main__":
    main()
