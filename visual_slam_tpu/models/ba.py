"""Bundle adjustment: Levenberg-Marquardt with Schur-complement landmark
elimination, in a planar data layout.

Replacement for the reference's g2o back-end
(src/v2/LocalBA.py:20-229): `localBundleAdjustement` (poses + landmarks,
landmarks marginalized via Schur — g2o's `VertexSBAPointXYZ.set_marginalized`
at LocalBA.py:72) and `motionOnlyBundleAdjustement` (:195-229, landmarks and
keyframes fixed). The robust kernel is Huber at sqrt(5.991) (LocalBA.py:82);
the optional median-depth gauge normalization mirrors LocalBA.py:179-190.

Data layout (the whole design):

  Per-observation tensors with tiny minor dimensions ((O,2,6) Jacobians,
  (O,) index gathers) ran ~200x off speed-of-light on the accelerator this
  was first written for — bad layouts plus per-op overhead dominate. So
  every per-observation quantity here is a PLANAR array (d..., N) with the
  observation axis N minor (contiguous), and N = P*Q: observations are grouped by landmark, point
  p owning the Q slots [p*Q, (p+1)*Q). Consequences:

  * point-side segment sums are `reshape(..., P, Q).sum(-1)` — no gather,
    no scatter, no index tables;
  * the landmark gather X[pnt] is a broadcast;
  * camera-side gathers (R[cam]) and segment sums become matmuls against a
    (K, N) one-hot matrix — matmul work, no gathers;
  * for the online problem size (K <= ~128) the reduced camera system
    S = U - W V^{-1} W^T is built EXPLICITLY with three einsums and solved
    with one dense (6K, 6K) Cholesky — no CG loop, ~10x fewer device ops.
    An implicit-matvec PCG path (solver="cg") remains for scales where S
    is too large to materialize.

Multi-device: the problem shards over the LANDMARK axis (each shard owns
P/n points and their N/n observation slots); camera-side reductions
(U, g_c, S, b) are psum-ed, the point-side (V, g_p, delta_p) never leaves
its shard. See parallel/sharded_ba.py.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lie

HUBER_DELTA = 2.4477  # sqrt(5.991), ≙ reference LocalBA.py:82
HI = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """A fixed-shape bundle-adjustment problem in point-major planar layout.

    Scale edges (se_*) pin the norms of relative translations between
    keyframe pairs — g2o's EdgeSBAScale as added per parent->child link by
    the reference on EVERY full BA (AddScalingEdge, LocalBA.py:115-131,
    :159-162). They are the monocular gauge stabilizer: without them a full
    BA can slide the newest keyframes along the scale direction while the
    reprojection cost still decreases.
    """

    R: jnp.ndarray  # (K,3,3) world->camera rotations
    t: jnp.ndarray  # (K,3) world->camera translations
    X: jnp.ndarray  # (P,3) landmarks (compacted; padding rows are zero)
    pt_valid: jnp.ndarray  # (P,) float32 1.0 for real landmarks
    cam: jnp.ndarray  # (N,) int32 camera index per slot, N = P*Q
    uv: jnp.ndarray  # (2,N) measured pixels (planar)
    w: jnp.ndarray  # (N,) slot weights (0 = empty slot)
    intr: jnp.ndarray  # (4,) fx fy cx cy
    cam_fixed: jnp.ndarray  # (K,) bool — poses held constant (gauge)
    se_i: jnp.ndarray  # (E,) int32 scale-edge first keyframe
    se_j: jnp.ndarray  # (E,) int32 scale-edge second keyframe
    se_meas: jnp.ndarray  # (E,) measured ||t_rel||
    se_w: jnp.ndarray  # (E,) scale-edge weights (0 = padding)
    # Optional RGB-D inverse-depth residual (a capability the reference
    # LACKS — it loads depth images but never uses them, SURVEY.md §2.1 #4).
    # Zero-weight slots make the residual vanish, so monocular problems are
    # unaffected; the math is additionally gated behind the static
    # `use_depth` flag of `optimize` so the monocular hot path pays nothing.
    dinv: jnp.ndarray  # (N,) measured inverse depth per slot (0 = none)
    dw: jnp.ndarray  # (N,) depth-residual weights (0 = no constraint)


class BAMeta(NamedTuple):
    """Host-side mapping from packed slots back to the caller's indexing."""

    slot_obs: np.ndarray  # (N,) original observation row per slot, -1 = empty
    pt_ids: np.ndarray  # (P,) original landmark index per packed row, -1 = pad


def _bucket(n: int, floor: int) -> int:
    q = floor
    while q < n:
        q *= 2
    return q


def _plan_layout(pnt, w, min_p=64, min_q=8):
    """Slot-layout planning shared by pack_planar (host scatter; kept for
    direct callers/tests) and make_problem (device scatter): group valid
    observations by landmark, bucket P/Q to powers of two, and assign each
    observation row its planar slot. Returns (rows, slot, used, P, Q)."""
    pnt = np.asarray(pnt)
    w = np.asarray(w, np.float32)
    valid = np.where(w > 0)[0]
    vp = pnt[valid]
    used = np.unique(vp)  # sorted original landmark ids with >=1 valid obs
    P = _bucket(max(len(used), 1), min_p)
    counts = np.bincount(np.searchsorted(used, vp), minlength=max(len(used), 1))
    Q = _bucket(int(counts.max()) if counts.size else 1, min_q)
    order = np.argsort(vp, kind="stable")
    rows = valid[order]
    dense_p = np.searchsorted(used, vp[order])
    first = np.searchsorted(dense_p, np.arange(len(used)), side="left")
    slot = (dense_p * Q + (np.arange(len(rows)) - first[dense_p])).astype(
        np.int32
    )
    return rows, slot, used, P, Q


def pack_planar(cam, pnt, uv, w, min_p=64, min_q=8):
    """Group O-indexed observations by landmark into the (P, Q) slot layout.

    Host-side NumPy. Landmarks with no valid observation are dropped
    (compaction); P and Q are bucketed to powers of two so the jitted solver
    recompiles at most a few times per run. Returns planar pieces + BAMeta.
    """
    cam = np.asarray(cam)
    uv = np.asarray(uv, np.float32)
    w = np.asarray(w, np.float32)
    rows, slot, used, P, Q = _plan_layout(pnt, w, min_p=min_p, min_q=min_q)
    N = P * Q
    cam_s = np.zeros(N, np.int32)
    uv_s = np.zeros((2, N), np.float32)
    w_s = np.zeros(N, np.float32)
    slot_obs = np.full(N, -1, np.int64)
    cam_s[slot] = cam[rows]
    uv_s[0, slot] = uv[rows, 0]
    uv_s[1, slot] = uv[rows, 1]
    w_s[slot] = w[rows]
    slot_obs[slot] = rows
    pt_ids = np.full(P, -1, np.int64)
    pt_ids[: len(used)] = used
    pt_valid = np.zeros(P, np.float32)
    pt_valid[: len(used)] = 1.0
    return cam_s, uv_s, w_s, pt_valid, pt_ids, BAMeta(slot_obs, pt_ids)


@partial(jax.jit, static_argnames=("N",))
def _scatter_planar(slot, cam_rows, uv_rows, w_rows, dinv_rows, dw_rows,
                    N: int):
    """Scatter compact observation rows into the (N,) planar slot arrays
    ON DEVICE. Padding rows carry slot == N (out of range) and are dropped
    by the scatter. This keeps host packing and H2D transfer O(live obs)
    instead of O(P*Q): at full-sequence map sizes the planar arrays are
    >80% padding, ~6 MB of mostly-zeros per BA dispatch."""
    cam_s = jnp.zeros(N, jnp.int32).at[slot].set(cam_rows, mode="drop")
    w_s = jnp.zeros(N, jnp.float32).at[slot].set(w_rows, mode="drop")
    uvN = jnp.zeros((N, 2), jnp.float32).at[slot].set(uv_rows, mode="drop")
    dinv_s = jnp.zeros(N, jnp.float32).at[slot].set(dinv_rows, mode="drop")
    dw_s = jnp.zeros(N, jnp.float32).at[slot].set(dw_rows, mode="drop")
    return cam_s, uvN.T, w_s, dinv_s, dw_s


def make_problem(R, t, X, cam, pnt, uv, w, intr, cam_fixed,
                 se_i=None, se_j=None, se_meas=None, se_w=None,
                 min_p=64, min_q=8, depth=None, depth_weight=1.0):
    """Build a planar BAProblem from O-indexed observation arrays.

    X is given in the caller's landmark indexing; it is compacted to the
    packed rows. Returns (problem, meta); meta maps results back.

    `depth` (O,) is an optional per-observation measured metric depth
    (<=0 or NaN = no measurement); it becomes the inverse-depth residual
    planes (dinv, dw) consumed when `optimize(..., use_depth=True)`.

    The planar (N,) arrays are built by a DEVICE scatter of the compact
    live-observation rows (_scatter_planar) — the host never allocates or
    transfers the padded layout.
    """
    R = np.asarray(R, np.float32)
    cam = np.asarray(cam)
    uv = np.asarray(uv, np.float32)
    w = np.asarray(w, np.float32)
    rows, slot, used, P, Q = _plan_layout(pnt, w, min_p=min_p, min_q=min_q)
    N = P * Q
    # Compact transfer rows, padded to a power-of-FOUR count (each NEW
    # (O2, N) pair is a fresh _scatter_planar compile on this backend's
    # remote compile service — seconds each; pow2 growth measured ~73 s of
    # compile-dominated BA dispatch over an RGB-D full sequence, where
    # depth mining grows the observation count across many pow2 buckets).
    # Padding rows scatter to slot N and are dropped on device.
    O2 = 2048
    while O2 < len(rows):
        O2 *= 4
    slot_pad = np.full(O2, N, np.int32)
    cam_rows = np.zeros(O2, np.int32)
    uv_rows = np.zeros((O2, 2), np.float32)
    w_rows = np.zeros(O2, np.float32)
    slot_pad[: len(rows)] = slot
    cam_rows[: len(rows)] = cam[rows]
    uv_rows[: len(rows)] = uv[rows]
    w_rows[: len(rows)] = w[rows]
    dinv_rows = np.zeros(O2, np.float32)
    dw_rows = np.zeros(O2, np.float32)
    if depth is not None and depth_weight > 0:
        depth = np.asarray(depth, np.float32)
        dvals = depth[rows]
        has_d = np.isfinite(dvals) & (dvals > 1e-3)
        dinv_rows[: len(rows)][has_d] = 1.0 / dvals[has_d]
        dw_rows[: len(rows)][has_d] = depth_weight
    cam_s, uv_s, w_s, dinv_s, dw_s = _scatter_planar(
        jnp.asarray(slot_pad), jnp.asarray(cam_rows), jnp.asarray(uv_rows),
        jnp.asarray(w_rows), jnp.asarray(dinv_rows), jnp.asarray(dw_rows),
        N=N,
    )
    # Host-side meta (slot -> original observation row; prune/write-back).
    slot_obs = np.full(N, -1, np.int64)
    slot_obs[slot] = rows
    pt_ids = np.full(P, -1, np.int64)
    pt_ids[: len(used)] = used
    pt_valid = np.zeros(P, np.float32)
    pt_valid[: len(used)] = 1.0
    meta = BAMeta(slot_obs, pt_ids)
    X = np.asarray(X, np.float32)
    Xp = np.zeros((P, 3), np.float32)
    real = pt_ids >= 0
    Xp[real] = X[pt_ids[real]]
    if se_i is None:
        se_i = np.zeros(1, np.int32)
        se_j = np.zeros(1, np.int32)
        se_meas = np.zeros(1, np.float32)
        se_w = np.zeros(1, np.float32)
    prob = BAProblem(
        R=jnp.asarray(R),
        t=jnp.asarray(t, dtype=jnp.float32),
        X=jnp.asarray(Xp),
        pt_valid=jnp.asarray(pt_valid),
        cam=cam_s,
        uv=uv_s,
        w=w_s,
        intr=jnp.asarray(intr, dtype=jnp.float32),
        cam_fixed=jnp.asarray(np.asarray(cam_fixed, bool)),
        se_i=jnp.asarray(np.asarray(se_i, np.int32)),
        se_j=jnp.asarray(np.asarray(se_j, np.int32)),
        se_meas=jnp.asarray(np.asarray(se_meas, np.float32)),
        se_w=jnp.asarray(np.asarray(se_w, np.float32)),
        dinv=dinv_s,
        dw=dw_s,
    )
    return prob, meta


def _onehot(p: BAProblem) -> jnp.ndarray:
    """(K, N) camera one-hot; column n selects camera cam[n]."""
    K = p.R.shape[0]
    return (
        jnp.arange(K, dtype=p.cam.dtype)[:, None] == p.cam[None, :]
    ).astype(p.R.dtype)


def _project_planar(p: BAProblem, C_T: jnp.ndarray):
    """Predicted pixels + the per-slot geometry planes every stage shares.

    Returns (r (2,N), Xc (3,N), Rg (3,3,N), iz (N,), w_irls (N,)).
    """
    P, Q = p.X.shape[0], p.cam.shape[0] // p.X.shape[0]
    N = p.cam.shape[0]
    fx, fy, cx, cy = p.intr[0], p.intr[1], p.intr[2], p.intr[3]
    # R[cam], t[cam] as one-hot matmuls -> planar (.., N).
    Rg = jnp.einsum("kab,kn->abn", p.R, C_T, precision=HI)  # (3,3,N)
    tg = jnp.einsum("ka,kn->an", p.t, C_T, precision=HI)  # (3,N)
    # X[pnt] is a broadcast: slot n belongs to point n // Q.
    Xg = jnp.broadcast_to(p.X.T[:, :, None], (3, P, Q)).reshape(3, N)
    Xc = jnp.einsum("abn,bn->an", Rg, Xg, precision=HI) + tg  # (3,N)
    z = Xc[2]
    z_safe = jnp.where(jnp.abs(z) > 1e-8, z, 1e-8)
    iz = 1.0 / z_safe
    pred = jnp.stack([fx * Xc[0] * iz + cx, fy * Xc[1] * iz + cy])
    r = pred - p.uv  # (2,N)
    rn = jnp.sqrt(jnp.sum(r * r, axis=0) + 1e-12)
    w_rob = jnp.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / rn)
    w_irls = p.w * w_rob * (z > 1e-6)
    return r, Xc, Rg, iz, w_irls


def _jacobians_planar(Xc, Rg, iz, intr):
    """Planar Jacobian planes: Jc (2,6,N) d r/d(cam se3, left-composed),
    Jp (2,3,N) d r/d(landmark). Hand-derived products of
    J_proj = [[a,0,b],[0,c,d]] with [-hat(Xc) | I] and R_cw."""
    fx, fy = intr[0], intr[1]
    x, y, z = Xc[0], Xc[1], Xc[2]
    a = fx * iz
    b = -fx * x * iz * iz
    c = fy * iz
    d = -fy * y * iz * iz
    zero = jnp.zeros_like(a)
    # Rotation part: J_proj @ (-hat(Xc)); translation part: J_proj itself.
    Jc = jnp.stack(
        [
            jnp.stack([b * y, a * z - b * x, -a * y, a, zero, b]),
            jnp.stack([-c * z + d * y, -d * x, c * x, zero, c, d]),
        ]
    )  # (2,6,N)
    J_proj = jnp.stack([jnp.stack([a, zero, b]), jnp.stack([zero, c, d])])
    Jp = jnp.einsum("rcn,cjn->rjn", J_proj, Rg, precision=HI)  # (2,3,N)
    return Jc, Jp


def _depth_terms(p: BAProblem, Xc, Rg, iz):
    """Inverse-depth residual planes (RGB-D mode).

    r_d = fx * (1/z_pred - 1/z_meas) — a pseudo-disparity (unit baseline),
    so the Huber threshold and the weighting live in the same pixel-like
    units as the reprojection rows. Returns (r_d (N,), Jd_c (6,N),
    Jd_p (3,N), wd (N,)) with wd already robust/validity weighted.
    """
    fx = p.intr[0]
    r_d = fx * (iz - p.dinv)
    s = -fx * iz * iz  # d r_d / d z
    x, y = Xc[0], Xc[1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    # d z / d(cam twist) = row 2 of [-hat(Xc) | I] = [y, -x, 0 | 0, 0, 1].
    Jd_c = s * jnp.stack([y, -x, zero, zero, zero, one])  # (6,N)
    Jd_p = s * Rg[2]  # d z / d X_w = third row of R_cw
    rn = jnp.abs(r_d)
    w_rob = jnp.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / jnp.maximum(rn, 1e-12))
    wd = p.dw * w_rob * (Xc[2] > 1e-6) * (p.dinv > 0)
    return r_d, Jd_c, Jd_p, wd


def _scale_edge_terms(p: BAProblem):
    """Closed-form scale-edge residuals and Jacobians (ops/lie.py)."""
    return lie.scale_edge_terms(p.R, p.t, p.se_i, p.se_j, p.se_meas)


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _cost(p: BAProblem, axis_name=None, C_T=None, use_depth: bool = False) -> jnp.ndarray:
    """Robust (Huber) total cost (psum-reduced over landmark shards)."""
    if C_T is None:
        C_T = _onehot(p)
    r, Xc, Rg, iz, _ = _project_planar(p, C_T)
    rn2 = jnp.sum(r * r, axis=0)
    rn = jnp.sqrt(rn2 + 1e-12)
    rho = jnp.where(rn <= HUBER_DELTA, rn2, 2.0 * HUBER_DELTA * rn - HUBER_DELTA**2)
    zmask = (Xc[2] > 1e-6).astype(p.w.dtype)
    cost = jnp.sum(p.w * zmask * rho)
    if use_depth:
        r_d, _, _, _ = _depth_terms(p, Xc, Rg, iz)
        rd_abs = jnp.abs(r_d)
        rho_d = jnp.where(
            rd_abs <= HUBER_DELTA, r_d * r_d,
            2.0 * HUBER_DELTA * rd_abs - HUBER_DELTA**2,
        )
        cost = cost + jnp.sum(p.dw * zmask * (p.dinv > 0) * rho_d)
    cost_obs = _psum(cost, axis_name)
    # Scale edges are replicated: identical on every shard, added after psum.
    r_s, _, _ = _scale_edge_terms(p)
    return cost_obs + jnp.sum(p.se_w * r_s * r_s)


def reproj_errors(p: BAProblem):
    """Per-slot reprojection error norms and weights: (err (N,), w (N,))."""
    C_T = _onehot(p)
    r, _, _, _, _ = _project_planar(p, C_T)
    return jnp.sqrt(jnp.sum(r * r, axis=0)), p.w


def _inv3_planar(V: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of (3,3,P) planar SPD blocks."""
    a, b, c = V[0, 0], V[0, 1], V[0, 2]
    d, e, f = V[1, 0], V[1, 1], V[1, 2]
    g, h, i = V[2, 0], V[2, 1], V[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    rows = jnp.stack(
        [jnp.stack([A, B, C]), jnp.stack([D, E, F]), jnp.stack([G, H, I])]
    )
    return rows / det


def _build_planar(p: BAProblem, lm_lambda, C_T, axis_name=None,
                  use_depth: bool = False):
    """All Hessian pieces in one pass over the slot planes.

    Returns U (K,6,6) damped+psum-ed (scale edges folded in), V_inv (3,3,P)
    local, g_c (K,6) psum-ed, g_p (3,P) local, W (6,3,K,P) local,
    H_ij (E,6,6) scale-edge cross blocks, and the (Jc, Jp, w_irls) planes.

    With `use_depth`, the inverse-depth residual row's rank-1 contributions
    are added to every plane BEFORE the one-hot contractions — the residual
    information stays block-diagonal per row (I2 reprojection + scalar
    depth), so no cross terms appear, exactly like the two pixel rows.
    """
    K = p.R.shape[0]
    P = p.X.shape[0]
    N = p.cam.shape[0]
    Q = N // P
    r, Xc, Rg, iz, w_irls = _project_planar(p, C_T)
    Jc, Jp = _jacobians_planar(Xc, Rg, iz, p.intr)
    wJc = Jc * w_irls
    wJp = Jp * w_irls
    UO = jnp.einsum("rin,rjn->ijn", wJc, Jc, precision=HI)  # (6,6,N)
    gcn = jnp.einsum("rin,rn->in", wJc, r, precision=HI)  # (6,N)
    VO = jnp.einsum("rin,rjn->ijn", wJp, Jp, precision=HI)  # (3,3,N)
    gpn = jnp.einsum("rin,rn->in", wJp, r, precision=HI)  # (3,N)
    WO = jnp.einsum("rin,rjn->ijn", wJc, Jp, precision=HI)  # (6,3,N)
    if use_depth:
        r_d, Jd_c, Jd_p, wd = _depth_terms(p, Xc, Rg, iz)
        wJd_c = Jd_c * wd  # (6,N)
        wJd_p = Jd_p * wd  # (3,N)
        UO = UO + wJd_c[:, None, :] * Jd_c[None, :, :]
        gcn = gcn + wJd_c * r_d
        VO = VO + wJd_p[:, None, :] * Jd_p[None, :, :]
        gpn = gpn + wJd_p * r_d
        WO = WO + wJd_c[:, None, :] * Jd_p[None, :, :]
    U = jnp.einsum("ijn,kn->kij", UO, C_T, precision=HI)  # (K,6,6)
    g_c = jnp.einsum("in,kn->ki", gcn, C_T, precision=HI)  # (K,6)
    V = VO.reshape(3, 3, P, Q).sum(-1)  # (3,3,P)
    g_p = gpn.reshape(3, P, Q).sum(-1)  # (3,P)
    W = jnp.einsum(
        "ijpq,kpq->ijkp", WO.reshape(6, 3, P, Q), C_T.reshape(K, P, Q),
        precision=HI,
    )  # (6,3,K,P)
    U = _psum(U, axis_name)
    g_c = _psum(g_c, axis_name)
    # Scale-edge contributions (replicated; added after psum).
    r_s, Ji, Jj = _scale_edge_terms(p)
    wJi = Ji * p.se_w[:, None]
    wJj = Jj * p.se_w[:, None]
    U = U.at[p.se_i].add(jnp.einsum("ek,el->ekl", wJi, Ji))
    U = U.at[p.se_j].add(jnp.einsum("ek,el->ekl", wJj, Jj))
    H_ij = jnp.einsum("ek,el->ekl", wJi, Jj)  # (E,6,6)
    g_c = g_c.at[p.se_i].add(wJi * r_s[:, None])
    g_c = g_c.at[p.se_j].add(wJj * r_s[:, None])
    eye6 = jnp.eye(6, dtype=U.dtype)
    U = U + lm_lambda * eye6[None]
    V = V + lm_lambda * jnp.eye(3, dtype=V.dtype)[:, :, None]
    V_inv = _inv3_planar(V)
    return U, V_inv, g_c, g_p, W, H_ij, (Jc, Jp, w_irls)


def _mask_cam(x: jnp.ndarray, cam_fixed: jnp.ndarray) -> jnp.ndarray:
    """Zero the 6-blocks of fixed cameras (gauge fixing, ≙ vertex.set_fixed)."""
    return x * (~cam_fixed)[:, None].astype(x.dtype)


def _solve_chol(p, U, V_inv, g_c, g_p, W, H_ij, axis_name):
    """Explicit reduced camera system + dense Cholesky (online path).

    S = U - W V^{-1} W^T materializes as (K,6,K,6): fine up to K ~ 128.
    """
    K = U.shape[0]
    Y = jnp.einsum("dcp,ackp->dakp", V_inv, W, precision=HI)  # (3,6,K,P)
    S_red = jnp.einsum("ackp,cblp->kalb", W, Y, precision=HI)  # (K,6,K,6)
    Vg = jnp.einsum("dcp,cp->dp", V_inv, g_p, precision=HI)  # (3,P)
    b_sub = jnp.einsum("ackp,cp->ka", W, Vg, precision=HI)  # (K,6)
    S_red = _psum(S_red, axis_name)
    b_sub = _psum(b_sub, axis_name)
    eyeK = jnp.eye(K, dtype=U.dtype)
    S = U[:, :, None, :] * eyeK[:, None, :, None] - S_red
    # Scale-edge cross blocks into S[i,:,j,:] (and transpose).
    S = S.at[p.se_i, :, p.se_j, :].add(H_ij)
    S = S.at[p.se_j, :, p.se_i, :].add(jnp.swapaxes(H_ij, -1, -2))
    b = -(g_c - b_sub)
    # Gauge: zero fixed cams' rows/cols, identity diagonal.
    m = (~p.cam_fixed).astype(U.dtype)
    S = S * m[:, None, None, None] * m[None, None, :, None]
    fix = 1.0 - m
    fix_blocks = fix[:, None, None] * jnp.eye(6, dtype=U.dtype)[None]  # (K,6,6)
    S = S + fix_blocks[:, :, None, :] * eyeK[:, None, :, None]
    b = b * m[:, None]
    D = 6 * K
    chol = jax.scipy.linalg.cho_factor(S.reshape(D, D), lower=True)
    delta_c = jax.scipy.linalg.cho_solve(chol, b.reshape(D)).reshape(K, 6)
    return _mask_cam(delta_c, p.cam_fixed)


def _schur_matvec_planar(x, p, U, V_inv, W, H_ij, axis_name):
    """y = S x applied implicitly (for solver="cg" at scales where S is
    too large to materialize). One W contraction each way."""
    x = _mask_cam(x, p.cam_fixed)
    y = jnp.einsum("kij,kj->ki", U, x)
    # W^T x is point-local under landmark sharding — no psum needed here.
    bp = jnp.einsum("ackp,ka->cp", W, x, precision=HI)  # (3,P)
    cp = jnp.einsum("dcp,cp->dp", V_inv, bp, precision=HI)
    y2 = jnp.einsum("ackp,cp->ka", W, cp, precision=HI)
    y = y - _psum(y2, axis_name)
    y = y.at[p.se_i].add(jnp.einsum("ekl,el->ek", H_ij, x[p.se_j]))
    y = y.at[p.se_j].add(jnp.einsum("elk,el->ek", H_ij, x[p.se_i]))
    return _mask_cam(y, p.cam_fixed)


def _inv6(M: jnp.ndarray) -> jnp.ndarray:
    """Batched 6x6 inverse via jnp.linalg.solve against identity."""
    eye = jnp.broadcast_to(jnp.eye(6, dtype=M.dtype), M.shape)
    return jnp.linalg.solve(M, eye)


def _pcg(matvec, precond, b, n_iters: int):
    """Preconditioned conjugate gradients, fixed iteration count (jit-safe)."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0

    def body(carry, _):
        x, r, z, pk = carry
        Ap = matvec(pk)
        rz = jnp.sum(r * z)
        denom = jnp.sum(pk * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)
        x = x + alpha * pk
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        beta = jnp.sum(r_new * z_new) / jnp.where(jnp.abs(rz) > 1e-20, rz, 1e-20)
        p_new = z_new + beta * pk
        return (x, r_new, z_new, p_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x0, r0, z0, p0), None, length=n_iters)
    return x


def _solve_cg(p, U, V_inv, g_c, g_p, W, H_ij, cg_iters, axis_name):
    Vg = jnp.einsum("dcp,cp->dp", V_inv, g_p, precision=HI)
    b_sub = _psum(jnp.einsum("ackp,cp->ka", W, Vg, precision=HI), axis_name)
    b = -(g_c - b_sub)
    b = _mask_cam(b, p.cam_fixed)
    U_inv = _inv6(U)

    def matvec(x):
        return _schur_matvec_planar(x, p, U, V_inv, W, H_ij, axis_name)

    def precond(x):
        return _mask_cam(jnp.einsum("kij,kj->ki", U_inv, x), p.cam_fixed)

    return _pcg(matvec, precond, b, cg_iters)


def _solve_delta(p: BAProblem, lm_lambda, cg_iters, points_fixed, C_T,
                 axis_name=None, solver="chol", use_depth: bool = False):
    """One damped normal-equation solve: (delta_c (K,6), delta_p (P,3))."""
    U, V_inv, g_c, g_p, W, H_ij, _ = _build_planar(
        p, lm_lambda, C_T, axis_name, use_depth=use_depth
    )
    g_c = _mask_cam(g_c, p.cam_fixed)

    if points_fixed:
        U_inv = _inv6(U)
        delta_c = -jnp.einsum("kij,kj->ki", U_inv, g_c)
        return _mask_cam(delta_c, p.cam_fixed), jnp.zeros_like(p.X)

    if solver == "chol":
        delta_c = _solve_chol(p, U, V_inv, g_c, g_p, W, H_ij, axis_name)
    else:
        delta_c = _solve_cg(p, U, V_inv, g_c, g_p, W, H_ij, cg_iters, axis_name)
    # Back-substitute landmarks: delta_p = -V^{-1} (g_p + W^T delta_c).
    back = jnp.einsum("ackp,ka->cp", W, delta_c, precision=HI)  # (3,P)
    dp = -jnp.einsum("dcp,cp->dp", V_inv, g_p + back, precision=HI)
    return delta_c, dp.T  # (P,3)


def _apply(p: BAProblem, delta_c, delta_p) -> BAProblem:
    dR, dt = lie.se3_exp(delta_c)  # (K,3,3),(K,3)
    R_new = dR @ p.R
    t_new = jnp.einsum("kij,kj->ki", dR, p.t) + dt
    return p._replace(R=R_new, t=t_new, X=p.X + delta_p)


@partial(
    jax.jit,
    static_argnames=(
        "n_iters", "cg_iters", "points_fixed", "axis_name", "solver", "use_depth"
    ),
)
def optimize(
    p: BAProblem,
    n_iters: int = 10,
    cg_iters: int = 12,
    points_fixed: bool = False,
    init_lambda: float = 1e-4,
    axis_name: str | None = None,
    solver: str = "chol",
    use_depth: bool = False,
) -> tuple[BAProblem, jnp.ndarray]:
    """Levenberg-Marquardt loop (≙ optimizer.optimize(10), LocalBA.py:39-42).

    Accept/reject with multiplicative damping updates, all inside jit via
    lax.scan on a fixed iteration count. Returns (optimized problem, cost).
    """
    C_T = _onehot(p)

    def step(carry, _):
        prob, lam, cost = carry
        delta_c, delta_p = _solve_delta(
            prob, lam, cg_iters, points_fixed, C_T, axis_name, solver,
            use_depth=use_depth,
        )
        cand = _apply(prob, delta_c, delta_p)
        new_cost = _cost(cand, axis_name, C_T, use_depth=use_depth)
        improved = new_cost < cost
        prob = jax.tree.map(lambda a, b: jnp.where(improved, a, b), cand, prob)
        cost = jnp.where(improved, new_cost, cost)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-8, 1e2)
        return (prob, lam, cost), cost

    cost0 = _cost(p, axis_name, C_T, use_depth=use_depth)
    (p_out, _, cost_out), _ = jax.lax.scan(
        step, (p, jnp.asarray(init_lambda, p.R.dtype), cost0), None, length=n_iters
    )
    return p_out, cost_out


def median_depth_normalize(p: BAProblem, point_valid=None) -> BAProblem:
    """Monocular gauge fix: divide translations and landmarks by the median
    landmark norm (≙ reference LocalBA.py:179-190)."""
    if point_valid is None:
        point_valid = p.pt_valid > 0
    norms = jnp.linalg.norm(p.X, axis=-1)
    n_valid = jnp.maximum(jnp.sum(point_valid), 1)
    sorted_norms = jnp.sort(jnp.where(point_valid, norms, jnp.inf))
    med = sorted_norms[(n_valid - 1) // 2]
    scale = jnp.where((med > 1e-8) & jnp.isfinite(med), med, 1.0)
    return p._replace(t=p.t / scale, X=p.X / scale)


# NOTE: the reference's per-frame motion-only BA (motionOnlyBundleAdjustement,
# LocalBA.py:195-229) is served in production by ops/pnp.pnp_gauss_newton —
# the identical math (landmarks fixed, Huber-weighted reprojection GN on one
# camera) fused into the tracking step. A whole-problem points_fixed solve
# remains available via optimize(p, points_fixed=True); there is no separate
# public wrapper (round-2 review: dead public surface hides the real contract).
