"""Large-map bundle adjustment: implicit Schur PCG in channel-major layout.

The online solver (models/ba.py) materializes the camera-point coupling
W as a dense (6,3,K,P) tensor and camera-side reductions as one-hot
(K,N) matmuls — right at the tracking scale (K<=~128, P<=~16k),
impossible at config #5 scale (~5k keyframes, ~1M
landmarks: dense W alone would be >100 GB). This module is the same
LM + marginalized-landmark Schur math (≙ g2o's
VertexSBAPointXYZ.set_marginalized, reference LocalBA.py:68-77) in a
memory-linear form:

  * every per-observation quantity is CHANNEL-MAJOR: residuals (2,N),
    pose Jacobians (12,N), point Jacobians (6,N), the coupling W (18,N)
    — the huge N axis is the contiguous one, so every per-slot op is a
    (C,N) stream.
  * slot->camera gathers (`cam_expand`, a `take`) and camera segment sums
    (`cam_reduce`, a scatter-add) are XLA's own gather and scatter.
  * point-side reductions stay dense: slots are grouped per landmark
    (N = P*Q), so they are (C,P,Q) reshape-sums.
  * the reduced camera system S = U - W V^{-1} W^T is NEVER formed:
    block-Jacobi PCG applies it as two per-slot contractions plus one
    camera expand + reduce per matvec.

Sharding: identical contract to models/ba.py — the landmark axis (and
its N = P*Q slots) shards over the mesh; camera-side partial sums
(U, g_c, every matvec's y) are `psum`-ed; the landmark side never
leaves its shard. parallel/sharded_ba.optimize_large_sharded wraps this
in shard_map; tests assert numerical identity with models/ba.py at
small scale and single-vs-8-device identity at large scale.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import ba as ba_mod
from .ba import BAProblem, HUBER_DELTA


def cam_expand(x_t: jnp.ndarray, cam: jnp.ndarray) -> jnp.ndarray:
    """(C,K) camera table -> (C,N) per-slot rows (a gather)."""
    return jnp.take(x_t, cam, axis=1)


def cam_reduce(d_t: jnp.ndarray, cam: jnp.ndarray, K: int) -> jnp.ndarray:
    """(C,N) per-slot rows -> (C,K) per-camera sums (a scatter-add; the
    summation order is the hardware's, so sums agree with an exact
    reference to float32 rounding, not bit for bit)."""
    return jnp.zeros((d_t.shape[0], K), d_t.dtype).at[:, cam].add(d_t)


def _point_sum(d_t: jnp.ndarray, P: int) -> jnp.ndarray:
    """(C,N) -> (C,P): slots are landmark-grouped (N = P*Q)."""
    C, N = d_t.shape
    return d_t.reshape(C, P, N // P).sum(-1)


def _point_expand(d_t: jnp.ndarray, N: int) -> jnp.ndarray:
    """(C,P) -> (C,N) by repeating each landmark's value over its Q slots."""
    C, P = d_t.shape
    return jnp.broadcast_to(d_t[:, :, None], (C, P, N // P)).reshape(C, N)


def _project(p: BAProblem):
    """Channel-major projection: returns r (2,N), Xc (3,N), Rn (9,N),
    iz (N,), w_irls (N,)."""
    P = p.X.shape[0]
    N = p.cam.shape[0]
    fx, fy, cx, cy = p.intr[0], p.intr[1], p.intr[2], p.intr[3]
    K = p.R.shape[0]
    # One fused expand for rotation rows + translation: (12,K) -> (12,N).
    Rt_t = jnp.concatenate(
        [p.R.reshape(K, 9).T, p.t.T], axis=0
    )  # (12,K)
    Rtn = cam_expand(Rt_t, p.cam)
    Rn, tn = Rtn[:9], Rtn[9:12]  # (9,N) rows R[i,j] at 3i+j; (3,N)
    Xn = _point_expand(p.X.T, N)  # (3,N)
    Xc = jnp.stack(
        [
            Rn[3 * i + 0] * Xn[0] + Rn[3 * i + 1] * Xn[1] + Rn[3 * i + 2] * Xn[2] + tn[i]
            for i in range(3)
        ]
    )  # (3,N)
    z = Xc[2]
    z_safe = jnp.where(jnp.abs(z) > 1e-8, z, 1e-8)
    iz = 1.0 / z_safe
    pred_u = fx * Xc[0] * iz + cx
    pred_v = fy * Xc[1] * iz + cy
    r = jnp.stack([pred_u, pred_v]) - p.uv  # (2,N)
    rn = jnp.sqrt(r[0] * r[0] + r[1] * r[1] + 1e-12)
    w_rob = jnp.where(rn <= HUBER_DELTA, 1.0, HUBER_DELTA / rn)
    w_irls = p.w * w_rob * (z > 1e-6)
    return r, Xc, Rn, iz, w_irls


def _jacobians(Xc, Rn, iz, intr):
    """Channel-major Jacobians: Jc (12,N) [row r*6+i], Jp (6,N) [row r*3+j]
    — same hand-derived products as ba._jacobians_planar."""
    fx, fy = intr[0], intr[1]
    x, y, z = Xc[0], Xc[1], Xc[2]
    a = fx * iz
    b = -fx * x * iz * iz
    c = fy * iz
    d = -fy * y * iz * iz
    zero = jnp.zeros_like(a)
    Jc = jnp.stack(
        [
            b * y, a * z - b * x, -a * y, a, zero, b,
            -c * z + d * y, -d * x, c * x, zero, c, d,
        ]
    )  # (12,N)
    # Jp[r*3+j] = sum_c J_proj[r,c] * Rn[c*3+j];  J_proj = [[a,0,b],[0,c,d]].
    Jp = jnp.stack(
        [a * Rn[0 + j] + b * Rn[6 + j] for j in range(3)]
        + [c * Rn[3 + j] + d * Rn[6 + j] for j in range(3)]
    )  # (6,N)
    return Jc, Jp


def _cost(p: BAProblem, axis_name=None) -> jnp.ndarray:
    r, Xc, _, _, _ = _project(p)
    rn2 = r[0] * r[0] + r[1] * r[1]
    rn = jnp.sqrt(rn2 + 1e-12)
    rho = jnp.where(
        rn <= HUBER_DELTA, rn2, 2.0 * HUBER_DELTA * rn - HUBER_DELTA**2
    )
    zmask = (Xc[2] > 1e-6).astype(p.w.dtype)
    cost_obs = ba_mod._psum(jnp.sum(p.w * zmask * rho), axis_name)
    r_s, _, _ = ba_mod._scale_edge_terms(p)
    return cost_obs + jnp.sum(p.se_w * r_s * r_s)


# Upper-triangle index pairs of a 6x6 block (21 entries).
_TRIU6 = [(i, j) for i in range(6) for j in range(i, 6)]


def _inv3_rows(V9: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of SPD 3x3 blocks stored as rows:
    (9,P) [i*3+j] -> (9,P). Elementwise — a LAPACK loop over 1M tiny
    blocks would dominate the build."""
    a, b, c, d, e, f, g, h, i = (V9[k] for k in range(9))
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
    return jnp.stack([A, B, C, D, E, F, G, H, I]) / det


def _build(p: BAProblem, lm_lambda, axis_name=None):
    """Hessian pieces, memory linear in N: U (K,6,6) psum-ed + damped,
    V_inv (9,P) local, g_c (K,6) psum-ed, g_p (3,P) local, WO (18,N)
    local, H_ij (E,6,6) scale-edge cross blocks."""
    K = p.R.shape[0]
    P = p.X.shape[0]
    r, Xc, Rn, iz, w_irls = _project(p)
    Jc, Jp = _jacobians(Xc, Rn, iz, p.intr)
    wJc = Jc * w_irls[None, :]  # (12,N)
    wJp = Jp * w_irls[None, :]  # (6,N)

    # Camera-side reductions in ONE scatter: 21 upper-triangle U entries
    # + 6 gradient rows, stacked (27,N).
    u_rows = [
        wJc[i] * Jc[j] + wJc[6 + i] * Jc[6 + j] for (i, j) in _TRIU6
    ]
    g_rows = [wJc[i] * r[0] + wJc[6 + i] * r[1] for i in range(6)]
    red = cam_reduce(jnp.stack(u_rows + g_rows), p.cam, K)  # (27,K)
    red = ba_mod._psum(red, axis_name)
    U = jnp.zeros((K, 6, 6), red.dtype)
    for idx, (i, j) in enumerate(_TRIU6):
        U = U.at[:, i, j].set(red[idx])
        if i != j:
            U = U.at[:, j, i].set(red[idx])
    g_c = red[21:27].T  # (K,6)

    # Point-side (local to the shard): V (9,P), g_p (3,P).
    v_rows = [
        wJp[j] * Jp[k] + wJp[3 + j] * Jp[3 + k]
        for j in range(3)
        for k in range(3)
    ]
    V9 = _point_sum(jnp.stack(v_rows), P)  # (9,P)
    g_p = _point_sum(
        jnp.stack([wJp[j] * r[0] + wJp[3 + j] * r[1] for j in range(3)]), P
    )  # (3,P)

    # Coupling, per-slot: WO[i*3+j] = sum_r wJc[r*6+i] * Jp[r*3+j].
    WO = jnp.stack(
        [
            wJc[i] * Jp[j] + wJc[6 + i] * Jp[3 + j]
            for i in range(6)
            for j in range(3)
        ]
    )  # (18,N)

    # Scale edges (replicated, added after psum; ≙ AddScalingEdge chain).
    r_s, Ji, Jj = ba_mod._scale_edge_terms(p)
    wJi = Ji * p.se_w[:, None]
    wJj = Jj * p.se_w[:, None]
    U = U.at[p.se_i].add(jnp.einsum("ek,el->ekl", wJi, Ji))
    U = U.at[p.se_j].add(jnp.einsum("ek,el->ekl", wJj, Jj))
    H_ij = jnp.einsum("ek,el->ekl", wJi, Jj)
    g_c = g_c.at[p.se_i].add(wJi * r_s[:, None])
    g_c = g_c.at[p.se_j].add(wJj * r_s[:, None])

    U = U + lm_lambda * jnp.eye(6, dtype=U.dtype)[None]
    diag = jnp.asarray([0, 4, 8])
    V9 = V9.at[diag].add(lm_lambda)  # + lambda*I per 3x3 block
    V_inv = _inv3_rows(V9)  # (9,P); padding rows are lambda*I -> invertible
    return U, V_inv, g_c, g_p, WO, H_ij


def _wt_apply(WO: jnp.ndarray, xc6: jnp.ndarray) -> jnp.ndarray:
    """t1[j] = sum_i WO[i*3+j] * xc6[i]: W^T x per slot, (6,N)->(3,N)."""
    return jnp.stack(
        [sum(WO[3 * i + j] * xc6[i] for i in range(6)) for j in range(3)]
    )


def _w_apply(WO: jnp.ndarray, t_n: jnp.ndarray) -> jnp.ndarray:
    """t3[i] = sum_j WO[i*3+j] * t[j]: W t per slot, (3,N)->(6,N)."""
    return jnp.stack(
        [sum(WO[3 * i + j] * t_n[j] for j in range(3)) for i in range(6)]
    )


def _vinv_apply(V_inv: jnp.ndarray, t_p: jnp.ndarray) -> jnp.ndarray:
    """(9,P) block-diag inverse applied to (3,P)."""
    return jnp.stack(
        [sum(V_inv[3 * i + j] * t_p[j] for j in range(3)) for i in range(3)]
    )


def _schur_matvec(x, p, U, V_inv, WO, H_ij, axis_name):
    """y = (U - W V^{-1} W^T) x without forming S: expand, two per-slot
    contractions, point reduce/expand, one camera reduce."""
    K = U.shape[0]
    P = V_inv.shape[1]
    N = WO.shape[1]
    x = ba_mod._mask_cam(x, p.cam_fixed)
    y = jnp.einsum("kij,kj->ki", U, x)
    xc6 = cam_expand(x.T, p.cam)  # (6,N)
    t1p = _point_sum(_wt_apply(WO, xc6), P)  # (3,P) landmark-local
    t2n = _point_expand(_vinv_apply(V_inv, t1p), N)  # (3,N)
    t3 = _w_apply(WO, t2n)  # (6,N)
    y2 = ba_mod._psum(cam_reduce(t3, p.cam, K), axis_name)  # (6,K)
    y = y - y2.T
    y = y.at[p.se_i].add(jnp.einsum("ekl,el->ek", H_ij, x[p.se_j]))
    y = y.at[p.se_j].add(jnp.einsum("elk,el->ek", H_ij, x[p.se_i]))
    return ba_mod._mask_cam(y, p.cam_fixed)


def _solve_delta(p, lm_lambda, cg_iters, points_fixed, axis_name=None):
    K = p.R.shape[0]
    P = p.X.shape[0]
    N = p.cam.shape[0]
    U, V_inv, g_c, g_p, WO, H_ij = _build(p, lm_lambda, axis_name)
    g_c = ba_mod._mask_cam(g_c, p.cam_fixed)
    U_inv = ba_mod._inv6(U)

    if points_fixed:
        delta_c = -jnp.einsum("kij,kj->ki", U_inv, g_c)
        return ba_mod._mask_cam(delta_c, p.cam_fixed), jnp.zeros_like(p.X)

    Vg_n = _point_expand(_vinv_apply(V_inv, g_p), N)  # (3,N)
    b_sub = ba_mod._psum(
        cam_reduce(_w_apply(WO, Vg_n), p.cam, K), axis_name
    )  # (6,K)
    b = ba_mod._mask_cam(-(g_c - b_sub.T), p.cam_fixed)

    def matvec(x):
        return _schur_matvec(x, p, U, V_inv, WO, H_ij, axis_name)

    def precond(x):
        return ba_mod._mask_cam(
            jnp.einsum("kij,kj->ki", U_inv, x), p.cam_fixed
        )

    delta_c = ba_mod._pcg(matvec, precond, b, cg_iters)
    # Back-substitute landmarks: delta_p = -V^{-1} (g_p + W^T delta_c).
    dcn = cam_expand(delta_c.T, p.cam)  # (6,N)
    back = _point_sum(_wt_apply(WO, dcn), P)  # (3,P)
    delta_p = -_vinv_apply(V_inv, g_p + back)  # (3,P)
    return delta_c, delta_p.T


@partial(
    jax.jit,
    static_argnames=("n_iters", "cg_iters", "points_fixed", "axis_name"),
)
def optimize(
    p: BAProblem,
    n_iters: int = 10,
    cg_iters: int = 12,
    points_fixed: bool = False,
    init_lambda: float = 1e-4,
    axis_name: str | None = None,
) -> tuple[BAProblem, jnp.ndarray]:
    """LM loop — same accept/reject structure as ba.optimize, large-map
    layout. Returns (optimized problem, final cost).
    """

    def step(carry, _):
        prob, lam, cost = carry
        delta_c, delta_p = _solve_delta(
            prob, lam, cg_iters, points_fixed, axis_name
        )
        cand = ba_mod._apply(prob, delta_c, delta_p)
        new_cost = _cost(cand, axis_name)
        improved = new_cost < cost
        prob = jax.tree.map(lambda a, b: jnp.where(improved, a, b), cand, prob)
        cost = jnp.where(improved, new_cost, cost)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-8, 1e2)
        return (prob, lam, cost), cost

    cost0 = _cost(p, axis_name)
    (p_out, _, cost_out), _ = jax.lax.scan(
        step,
        (p, jnp.asarray(init_lambda, p.R.dtype), cost0),
        None,
        length=n_iters,
    )
    return p_out, cost_out
