"""Pose-graph optimization: Gauss-Newton over SE(3) relative-pose edges and
scale edges, batched over the edge table.

Replacement for the reference's g2o pose-graph pieces:
`add_edge_between_poses` (EdgeSE3 with DCS robust kernel, LocalBA.py:97-113)
and `AddScalingEdge` (EdgeSBAScale measuring the relative-translation norm,
LocalBA.py:115-131), used to stabilize monocular scale across the keyframe
chain — the scale-drift correction mode of config #4 — and to
absorb loop-closure edges (config #2).

Residuals:
  SE3 edge (i,j) with measurement Z_ij (j-from-i):  r = [vee(Z^T R_rel -
    R_rel^T Z)/2, Z^T (t_rel - Z_t)] for world->camera poses T, where
    (R_rel, t_rel) = T_i T_j^{-1}. The chordal rotation residual is zero
    exactly where so3_log is, agrees to first order, and stays smooth at
    the identity where log's derivative blows up.
  Scale edge (i,j) with measurement s_ij:  r = ||t_rel|| - s_ij

Two solvers:
  * optimize(...)        — analytic per-edge 6x6 Jacobian blocks,
    block-sparse normal equations (scatter-assembled), block-Jacobi
    preconditioned CG, and a DCS robust kernel (≙ RobustKernelDCS,
    LocalBA.py:97). Scales to thousands of keyframes.
  * optimize_dense(...)  — the original jacfwd + dense 6Kx6K solve; kept as
    the small-graph oracle (tests assert the analytic path matches it).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lie


class PoseGraph(NamedTuple):
    R: jnp.ndarray  # (K,3,3) world->camera
    t: jnp.ndarray  # (K,3)
    e_i: jnp.ndarray  # (E,) int32 first vertex
    e_j: jnp.ndarray  # (E,) int32 second vertex
    Z_R: jnp.ndarray  # (E,3,3) measured relative rotation (cam_j -> cam_i)
    Z_t: jnp.ndarray  # (E,3) measured relative translation
    w: jnp.ndarray  # (E,) edge weights (0 = padding)
    s_i: jnp.ndarray  # (S,) scale-edge first vertex
    s_j: jnp.ndarray  # (S,) scale-edge second vertex
    s_meas: jnp.ndarray  # (S,) measured ||t_rel||
    s_w: jnp.ndarray  # (S,) scale-edge weights
    fixed: jnp.ndarray  # (K,) bool


# so3 generators: G[k] = d[w]x/dw_k.
_GEN = np.zeros((3, 3, 3), np.float32)
_GEN[0, 2, 1] = 1.0
_GEN[0, 1, 2] = -1.0
_GEN[1, 0, 2] = 1.0
_GEN[1, 2, 0] = -1.0
_GEN[2, 1, 0] = 1.0
_GEN[2, 0, 1] = -1.0


def _rel(R, t, i, j):
    """T_i T_j^{-1}: (R_rel, t_rel) mapping cam-j coords into cam-i."""
    Ri, ti = R[i], t[i]
    Rj, tj = R[j], t[j]
    R_rel = Ri @ Rj.swapaxes(-1, -2)
    t_rel = ti - jnp.einsum("...ij,...j->...i", R_rel, tj)
    return R_rel, t_rel


def _se3_residual(g: PoseGraph, R, t):
    R_rel, t_rel = _rel(R, t, g.e_i, g.e_j)
    dR = jnp.einsum("eji,ejk->eik", g.Z_R, R_rel)  # Z^T @ R_rel
    dt = jnp.einsum("eji,ej->ei", g.Z_R, t_rel - g.Z_t)
    r_rot = lie.vee(dR - jnp.swapaxes(dR, -1, -2)) * 0.5
    return jnp.concatenate([r_rot, dt], axis=-1)  # (E,6)


def _scale_residual(g: PoseGraph, R, t):
    _, t_rel = _rel(R, t, g.s_i, g.s_j)
    # Epsilon-safe norm: padded/identity edges sit at t_rel == 0, where the
    # norm's derivative is NaN under jacfwd even at weight 0.
    return jnp.sqrt(jnp.sum(t_rel * t_rel, axis=-1) + 1e-12) - g.s_meas  # (S,)


def _se3_edge_blocks(g: PoseGraph, R, t):
    """Analytic per-edge residuals and Jacobian blocks.

    For left-composed se3 deltas (w, dt) on each pose:
      d t_rel = [w_i]x t_rel + dt_i - R_rel dt_j          (w_j cancels)
      d R_rel = [w_i]x R_rel - R_rel [w_j]x
    giving closed-form 6x6 blocks J_i, J_j per edge — no autodiff.
    Returns r (E,6), J_i (E,6,6), J_j (E,6,6).
    """
    R_rel, t_rel = _rel(R, t, g.e_i, g.e_j)
    Zt = jnp.swapaxes(g.Z_R, -1, -2)  # (E,3,3) Z^T
    dRm = jnp.einsum("eab,ebc->eac", Zt, R_rel)  # Z^T R_rel
    r_rot = lie.vee(dRm - jnp.swapaxes(dRm, -1, -2)) * 0.5
    r_t = jnp.einsum("eab,eb->ea", Zt, t_rel - g.Z_t)
    r = jnp.concatenate([r_rot, r_t], axis=-1)  # (E,6)

    G = jnp.asarray(_GEN, R.dtype)
    # L_i[:, k] = vee(Z^T G_k R_rel + R_rel^T G_k Z) / 2
    Rt = jnp.swapaxes(R_rel, -1, -2)
    A1 = jnp.einsum("eab,kbc,ecd->ekad", Zt, G, R_rel)
    A2 = jnp.einsum("eab,kbc,ecd->ekad", Rt, G, g.Z_R)
    L_i = jnp.swapaxes(lie.vee(A1 + A2) * 0.5, -1, -2)  # (E,3,3): rows=res
    # L_j[:, k] = -vee(Z^T R_rel G_k + G_k R_rel^T Z) / 2
    B1 = jnp.einsum("eab,kbc->ekac", dRm, G)
    B2 = jnp.einsum("kab,ebc->ekac", G, jnp.einsum("eab,ebc->eac", Rt, g.Z_R))
    L_j = jnp.swapaxes(lie.vee(B1 + B2) * -0.5, -1, -2)

    # d r_t / d w_i = Z^T [w]x t_rel => column k is Z^T (G_k t_rel).
    Jt_wi = jnp.einsum("eab,kbc,ec->eak", Zt, G, t_rel)  # (E,3,3)
    zero3 = jnp.zeros_like(L_i)
    J_i = jnp.concatenate(
        [
            jnp.concatenate([L_i, zero3], axis=-1),  # rot rows
            jnp.concatenate([Jt_wi, Zt], axis=-1),  # trans rows
        ],
        axis=-2,
    )  # (E,6,6)
    ZtR = dRm  # Z^T R_rel
    J_j = jnp.concatenate(
        [
            jnp.concatenate([L_j, zero3], axis=-1),
            jnp.concatenate([zero3, -ZtR], axis=-1),
        ],
        axis=-2,
    )  # (E,6,6)
    return r, J_i, J_j


def _scale_edge_blocks(g: PoseGraph, R, t):
    """Closed-form scale-edge residual + Jacobians (ops/lie.py)."""
    return lie.scale_edge_terms(R, t, g.s_i, g.s_j, g.s_meas)


def _dcs_weight(chi2, phi):
    """Dynamic Covariance Scaling (Agarwal et al. 2013): s = min(1,
    2*phi/(phi+chi2)); the IRLS information scale is s^2. Keeps good edges
    at full weight and smoothly anneals gross outliers (bad loop edges)."""
    s = jnp.minimum(1.0, 2.0 * phi / (phi + chi2))
    return s * s


def _apply_delta(R, t, delta):
    dR, dt = lie.se3_exp(delta)
    return dR @ R, jnp.einsum("kij,kj->ki", dR, t) + dt


@partial(jax.jit, static_argnames=("n_iters", "cg_iters", "use_dcs", "axis_name"))
def optimize(
    g: PoseGraph,
    n_iters: int = 12,
    cg_iters: int = 32,
    damping: float = 1e-5,
    dcs_phi: float = 1.0,
    use_dcs: bool = True,
    axis_name: str | None = None,
):
    """Scalable pose-graph Gauss-Newton: analytic Jacobian blocks +
    block-Jacobi-preconditioned CG on the 6K normal system, with a DCS
    robust kernel on the SE3 edges. Returns (R, t, final cost).

    With `axis_name` set (inside shard_map / pjit over a Mesh — see
    parallel/sharded_pg.py), the EDGE tables are shard-local and the poses
    replicated: every edge-indexed accumulation (the block diagonal D, the
    gradient, and each CG matvec's off-diagonal term) is computed from the
    local edges and `jax.lax.psum`-combined over the mesh. Keyframes'
    normal-equation blocks are thus partitioned by edge ownership — the
    device-partitioned analog of the reference's g2o EdgeSE3/EdgeSBAScale
    chains (LocalBA.py:97-131). Comm per GN step: one (K,6,6)+(K,6) psum;
    per CG iteration: one (K,6) psum — K·24 bytes·cg_iters per step over
    the device interconnect."""
    K = g.R.shape[0]
    free = (~g.fixed).astype(g.R.dtype)

    def _allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def step(carry, _):
        R, t = carry
        r, J_i, J_j = _se3_edge_blocks(g, R, t)
        chi2 = g.w * jnp.sum(r * r, axis=-1)
        w_e = g.w * (_dcs_weight(chi2, dcs_phi) if use_dcs else 1.0)
        rs, Si, Sj = _scale_edge_blocks(g, R, t)

        wJi = J_i * w_e[:, None, None]
        wJj = J_j * w_e[:, None, None]
        H_ii = jnp.einsum("eri,erj->eij", wJi, J_i)  # (E,6,6)
        H_jj = jnp.einsum("eri,erj->eij", wJj, J_j)
        H_ij = jnp.einsum("eri,erj->eij", wJi, J_j)
        g_i = jnp.einsum("eri,er->ei", wJi, r)
        g_j = jnp.einsum("eri,er->ei", wJj, r)
        wSi = Si * g.s_w[:, None]
        wSj = Sj * g.s_w[:, None]

        # Block-diagonal accumulation (scatter-add over the LOCAL edge
        # shard; E-sized, runs where the pose graph runs — host CPU for big
        # graphs, the accelerator for small ones), psum'd over the mesh when
        # sharded.
        D = jnp.zeros((K, 6, 6), R.dtype)
        D = D.at[g.e_i].add(H_ii).at[g.e_j].add(H_jj)
        D = D.at[g.s_i].add(jnp.einsum("ei,ej->eij", wSi, Si))
        D = D.at[g.s_j].add(jnp.einsum("ei,ej->eij", wSj, Sj))
        D = _allsum(D) + damping * jnp.eye(6, dtype=R.dtype)[None]
        grad = jnp.zeros((K, 6), R.dtype)
        grad = grad.at[g.e_i].add(g_i).at[g.e_j].add(g_j)
        grad = grad.at[g.s_i].add(wSi * rs[:, None])
        grad = grad.at[g.s_j].add(wSj * rs[:, None])
        grad = _allsum(grad) * free[:, None]

        Hs_ij = jnp.einsum("ei,ej->eij", wSi, Sj)  # scale cross blocks

        D_inv = jnp.linalg.solve(
            D, jnp.broadcast_to(jnp.eye(6, dtype=R.dtype), D.shape)
        )

        def matvec(x):
            x = x * free[:, None]
            xi = x[g.e_i]
            xj = x[g.e_j]
            off = jnp.zeros_like(x)
            off = off.at[g.e_i].add(jnp.einsum("eij,ej->ei", H_ij, xj))
            off = off.at[g.e_j].add(jnp.einsum("eji,ej->ei", H_ij, xi))
            off = off.at[g.s_i].add(jnp.einsum("eij,ej->ei", Hs_ij, x[g.s_j]))
            off = off.at[g.s_j].add(jnp.einsum("eji,ej->ei", Hs_ij, x[g.s_i]))
            # D is already mesh-summed; only the off-diagonal term is local.
            y = jnp.einsum("kij,kj->ki", D, x) + _allsum(off)
            return y * free[:, None]

        def precond(x):
            return jnp.einsum("kij,kj->ki", D_inv, x) * free[:, None]

        # PCG on the 6K system.
        b = -grad
        x = jnp.zeros_like(b)
        rr = b
        z = precond(rr)
        p = z

        def cg_body(c, _):
            x, rr, z, p = c
            Ap = matvec(p)
            rz = jnp.sum(rr * z)
            denom = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)
            x = x + alpha * p
            r_new = rr - alpha * Ap
            z_new = precond(r_new)
            beta = jnp.sum(r_new * z_new) / jnp.where(jnp.abs(rz) > 1e-20, rz, 1e-20)
            return (x, r_new, z_new, z_new + beta * p), None

        (delta, _, _, _), _ = jax.lax.scan(
            cg_body, (x, rr, z, p), None, length=cg_iters
        )
        delta = delta * free[:, None]
        R_new, t_new = _apply_delta(R, t, delta)
        cost = _allsum(
            jnp.sum(w_e * jnp.sum(r * r, -1)) + jnp.sum(g.s_w * rs * rs)
        )
        return (R_new, t_new), cost

    (R_out, t_out), costs = jax.lax.scan(step, (g.R, g.t), None, length=n_iters)
    return R_out, t_out, costs[-1]


def _total_residuals(g: PoseGraph, delta):
    """Residual vector as a function of per-pose se3 deltas (K,6)."""
    R, t = _apply_delta(g.R, g.t, delta)
    r_se3 = _se3_residual(g, R, t) * jnp.sqrt(g.w)[:, None]
    r_s = _scale_residual(g, R, t) * jnp.sqrt(g.s_w)
    return jnp.concatenate([r_se3.reshape(-1), r_s])


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_dense(g: PoseGraph, n_iters: int = 10, damping: float = 1e-6):
    """Dense jacfwd Gauss-Newton (small-graph oracle for optimize)."""
    K = g.R.shape[0]
    free = (~g.fixed).astype(g.R.dtype)

    def step(carry, _):
        g_cur = carry

        def res_fn(delta):
            return _total_residuals(g_cur, delta.reshape(K, 6))

        d0 = jnp.zeros(K * 6, g.R.dtype)
        r = res_fn(d0)
        J = jax.jacfwd(res_fn)(d0)  # (R, 6K)
        mask = jnp.repeat(free, 6)
        J = J * mask[None, :]
        H = J.T @ J + damping * jnp.eye(K * 6, dtype=J.dtype)
        grad = J.T @ r
        delta = -jnp.linalg.solve(H, grad) * mask
        R_new, t_new = _apply_delta(g_cur.R, g_cur.t, delta.reshape(K, 6))
        return g_cur._replace(R=R_new, t=t_new), jnp.sum(r * r)

    g_out, costs = jax.lax.scan(step, g, None, length=n_iters)
    return g_out.R, g_out.t, costs[-1]


# --------------------------------------------------------------------- Sim(3)
#
# Monocular scale drift cannot be absorbed by an SE(3) pose graph: closing a
# genuine loop whose two ends disagree in scale forces a rigid correction
# that degrades reprojection everywhere (measured on lr traj3's real
# frame-~1100 revisit: every SE3 closure attempt was rejected by the warp
# validation). The 7-DoF graph gives each keyframe a log-scale and lets the
# optimizer distribute the loop's scale discrepancy smoothly along the
# chain — the ORB-SLAM monocular loop-correction semantics, and the full
# meaning of config #4 "scale-drift correction".
#
# Parameterization (world->cam): S_k = (s_k, R_k, t_k): x_cam = s_k R_k x_w
# + t_k. Relative: S_i S_j^-1 = (s_i/s_j, R_i R_j^T, t_i - (s_i/s_j) R_rel
# t_j). Left-composed delta (w, dt, dl) per node. The closed-form blocks
# extend the SE3 ones by one column/row:
#   d t_rel wrt node i = [w_i]x t_rel + dt_i + dl_i * t_rel
#   d t_rel wrt node j = -(s_i/s_j) R_rel dt_j      (w_j, dl_j cancel)
#   r_lam = (lam_i - lam_j) - log Z_s, d = dl_i - dl_j
# Chain edges carry Z_s = 1 (adjacent keyframes share local scale); loop
# edges carry the measured relative scale (median-depth ratio of the
# verified landmarks — pipeline._close_loop).


class Sim3Graph(NamedTuple):
    R: jnp.ndarray  # (K,3,3) world->camera
    t: jnp.ndarray  # (K,3)
    lam: jnp.ndarray  # (K,) log-scale
    e_i: jnp.ndarray  # (E,)
    e_j: jnp.ndarray  # (E,)
    Z_R: jnp.ndarray  # (E,3,3)
    Z_t: jnp.ndarray  # (E,3)
    Z_ls: jnp.ndarray  # (E,) log of measured relative scale s_i/s_j
    w: jnp.ndarray  # (E,) pose-row weights (0 = padding)
    w_lam: jnp.ndarray  # (E,) scale-row weights
    fixed: jnp.ndarray  # (K,) bool


def _sim3_edge_blocks(g: Sim3Graph, R, t, lam):
    """Analytic residuals + 7x7 Jacobian blocks per edge.

    Residual rows: [3 chordal rotation, 3 translation, 1 log-scale].
    Delta columns per node: [w(3), dt(3), dl(1)].
    """
    s = jnp.exp(lam)
    s_rel = s[g.e_i] / s[g.e_j]  # (E,)
    Ri, ti = R[g.e_i], t[g.e_i]
    Rj, tj = R[g.e_j], t[g.e_j]
    R_rel = jnp.einsum("eab,ecb->eac", Ri, Rj)  # R_i R_j^T
    t_rel = ti - s_rel[:, None] * jnp.einsum("eab,eb->ea", R_rel, tj)

    Zt = jnp.swapaxes(g.Z_R, -1, -2)
    dRm = jnp.einsum("eab,ebc->eac", Zt, R_rel)  # Z^T R_rel
    r_rot = lie.vee(dRm - jnp.swapaxes(dRm, -1, -2)) * 0.5
    r_t = jnp.einsum("eab,eb->ea", Zt, t_rel - g.Z_t)
    r_lam = lam[g.e_i] - lam[g.e_j] - g.Z_ls  # (E,)

    G = jnp.asarray(_GEN, R.dtype)
    Rt = jnp.swapaxes(R_rel, -1, -2)
    A1 = jnp.einsum("eab,kbc,ecd->ekad", Zt, G, R_rel)
    A2 = jnp.einsum("eab,kbc,ecd->ekad", Rt, G, g.Z_R)
    L_i = jnp.swapaxes(lie.vee(A1 + A2) * 0.5, -1, -2)  # (E,3,3)
    B1 = jnp.einsum("eab,kbc->ekac", dRm, G)
    B2 = jnp.einsum("kab,ebc->ekac", G, jnp.einsum("eab,ebc->eac", Rt, g.Z_R))
    L_j = jnp.swapaxes(lie.vee(B1 + B2) * -0.5, -1, -2)

    Jt_wi = jnp.einsum("eab,kbc,ec->eak", Zt, G, t_rel)  # (E,3,3)
    Jt_li = jnp.einsum("eab,eb->ea", Zt, t_rel)[..., None]  # (E,3,1)
    zero33 = jnp.zeros_like(L_i)
    zero31 = jnp.zeros_like(Jt_li)
    zero13 = jnp.zeros((L_i.shape[0], 1, 3), R.dtype)
    one11 = jnp.ones((L_i.shape[0], 1, 1), R.dtype)

    J_i = jnp.concatenate(
        [
            jnp.concatenate([L_i, zero33, zero31], axis=-1),
            jnp.concatenate([Jt_wi, Zt, Jt_li], axis=-1),
            jnp.concatenate([zero13, zero13, one11], axis=-1),
        ],
        axis=-2,
    )  # (E,7,7)
    ZtR = jnp.einsum("eab,ebc->eac", Zt, R_rel) * s_rel[:, None, None]
    J_j = jnp.concatenate(
        [
            jnp.concatenate([L_j, zero33, zero31], axis=-1),
            jnp.concatenate([zero33, -ZtR, zero31], axis=-1),
            jnp.concatenate([zero13, zero13, -one11], axis=-1),
        ],
        axis=-2,
    )  # (E,7,7)
    r = jnp.concatenate([r_rot, r_t, r_lam[:, None]], axis=-1)  # (E,7)
    return r, J_i, J_j


def _apply_sim3_delta(R, t, lam, delta):
    """delta (K,7) = [w, dt, dl], left-composed: S' = exp(delta) S."""
    dR, dt = lie.se3_exp(delta[:, :6])
    dl = delta[:, 6]
    s_d = jnp.exp(dl)
    R_new = dR @ R
    t_new = s_d[:, None] * jnp.einsum("kij,kj->ki", dR, t) + dt
    return R_new, t_new, lam + dl


@partial(jax.jit, static_argnames=("n_iters", "cg_iters", "use_dcs"))
def optimize_sim3(
    g: Sim3Graph,
    n_iters: int = 12,
    cg_iters: int = 32,
    damping: float = 1e-5,
    dcs_phi: float = 1.0,
    use_dcs: bool = True,
):
    """7-DoF pose-graph Gauss-Newton (analytic blocks + block-Jacobi PCG,
    DCS on the pose rows). Returns (R, t, lam, final cost)."""
    K = g.R.shape[0]
    free = (~g.fixed).astype(g.R.dtype)

    def step(carry, _):
        R, t, lam = carry
        r, J_i, J_j = _sim3_edge_blocks(g, R, t, lam)
        chi2 = g.w * jnp.sum(r[:, :6] * r[:, :6], axis=-1)
        dcs = _dcs_weight(chi2, dcs_phi) if use_dcs else 1.0
        row_w = jnp.concatenate(
            [
                jnp.broadcast_to((g.w * dcs)[:, None], (r.shape[0], 6)),
                (g.w_lam * dcs)[:, None],
            ],
            axis=-1,
        )  # (E,7)
        wJi = J_i * row_w[:, :, None]
        wJj = J_j * row_w[:, :, None]
        H_ii = jnp.einsum("eri,erj->eij", wJi, J_i)
        H_jj = jnp.einsum("eri,erj->eij", wJj, J_j)
        H_ij = jnp.einsum("eri,erj->eij", wJi, J_j)
        g_i = jnp.einsum("eri,er->ei", wJi, r)
        g_j = jnp.einsum("eri,er->ei", wJj, r)

        D = jnp.zeros((K, 7, 7), R.dtype)
        D = D.at[g.e_i].add(H_ii).at[g.e_j].add(H_jj)
        D = D + damping * jnp.eye(7, dtype=R.dtype)[None]
        grad = jnp.zeros((K, 7), R.dtype)
        grad = grad.at[g.e_i].add(g_i).at[g.e_j].add(g_j)
        grad = grad * free[:, None]
        D_inv = jnp.linalg.solve(
            D, jnp.broadcast_to(jnp.eye(7, dtype=R.dtype), D.shape)
        )

        def matvec(x):
            x = x * free[:, None]
            off = jnp.zeros_like(x)
            off = off.at[g.e_i].add(jnp.einsum("eij,ej->ei", H_ij, x[g.e_j]))
            off = off.at[g.e_j].add(jnp.einsum("eji,ej->ei", H_ij, x[g.e_i]))
            return (jnp.einsum("kij,kj->ki", D, x) + off) * free[:, None]

        def precond(x):
            return jnp.einsum("kij,kj->ki", D_inv, x) * free[:, None]

        b = -grad
        x = jnp.zeros_like(b)
        rr = b
        z = precond(rr)
        p = z

        def cg_body(c, _):
            x, rr, z, p = c
            Ap = matvec(p)
            rz = jnp.sum(rr * z)
            denom = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)
            x = x + alpha * p
            r_new = rr - alpha * Ap
            z_new = precond(r_new)
            beta = jnp.sum(r_new * z_new) / jnp.where(
                jnp.abs(rz) > 1e-20, rz, 1e-20
            )
            return (x, r_new, z_new, z_new + beta * p), None

        (delta, _, _, _), _ = jax.lax.scan(
            cg_body, (x, rr, z, p), None, length=cg_iters
        )
        delta = delta * free[:, None]
        R_new, t_new, lam_new = _apply_sim3_delta(R, t, lam, delta)
        cost = jnp.sum(row_w * r * r)
        return (R_new, t_new, lam_new), cost

    (R_out, t_out, lam_out), costs = jax.lax.scan(
        step, (g.R, g.t, g.lam), None, length=n_iters
    )
    return R_out, t_out, lam_out, costs[-1]


def sim3_from_keyframe_chain(
    R: jnp.ndarray, t: jnp.ndarray, valid: jnp.ndarray
) -> Sim3Graph:
    """Chain Sim3 graph: consecutive keyframes, Z from current relative
    poses, Z_s = 1 (adjacent keyframes share local scale), lam = 0."""
    K = R.shape[0]
    i = jnp.arange(K - 1)
    j = i + 1
    Z_R, Z_t = _rel(R, t, i, j)
    w = (valid[i] & valid[j]).astype(R.dtype)
    fixed = jnp.zeros(K, bool).at[0].set(True) | ~valid
    return Sim3Graph(
        R=R, t=t, lam=jnp.zeros(K, R.dtype),
        e_i=i, e_j=j, Z_R=Z_R, Z_t=Z_t,
        Z_ls=jnp.zeros(K - 1, R.dtype),
        w=w, w_lam=w, fixed=fixed,
    )


def sim3_add_edges(g: Sim3Graph, e_i, e_j, Z_R, Z_t, Z_ls, w) -> Sim3Graph:
    """Append Sim3 loop edges (log relative scale Z_ls per edge)."""
    w = jnp.asarray(w, g.w.dtype)
    return g._replace(
        e_i=jnp.concatenate([g.e_i, jnp.asarray(e_i, g.e_i.dtype)]),
        e_j=jnp.concatenate([g.e_j, jnp.asarray(e_j, g.e_j.dtype)]),
        Z_R=jnp.concatenate([g.Z_R, jnp.asarray(Z_R, g.Z_R.dtype)]),
        Z_t=jnp.concatenate([g.Z_t, jnp.asarray(Z_t, g.Z_t.dtype)]),
        Z_ls=jnp.concatenate([g.Z_ls, jnp.asarray(Z_ls, g.Z_ls.dtype)]),
        w=jnp.concatenate([g.w, w]),
        w_lam=jnp.concatenate([g.w_lam, w]),
    )


def from_keyframe_chain(
    R: jnp.ndarray,
    t: jnp.ndarray,
    valid: jnp.ndarray,
    scale_meas: jnp.ndarray | None = None,
) -> PoseGraph:
    """Build a chain pose graph from consecutive keyframes, with optional
    scale edges (≙ the parent->child AddScalingEdge chain, LocalBA.py:159-162
    and frame parent links frame.py:71-76)."""
    K = R.shape[0]
    i = jnp.arange(K - 1)
    j = i + 1
    Z_R, Z_t = _rel(R, t, i, j)
    w = (valid[i] & valid[j]).astype(R.dtype)
    if scale_meas is None:
        scale_meas = jnp.linalg.norm(Z_t, axis=-1)
    fixed = jnp.zeros(K, bool).at[0].set(True) | ~valid
    return PoseGraph(
        R=R,
        t=t,
        e_i=i,
        e_j=j,
        Z_R=Z_R,
        Z_t=Z_t,
        w=w,
        s_i=i,
        s_j=j,
        s_meas=scale_meas,
        s_w=w,
        fixed=fixed,
    )


def add_edges(g: PoseGraph, e_i, e_j, Z_R, Z_t, w) -> PoseGraph:
    """Append SE3 edges (e.g. verified loop closures) to the graph."""
    return g._replace(
        e_i=jnp.concatenate([g.e_i, jnp.asarray(e_i, g.e_i.dtype)]),
        e_j=jnp.concatenate([g.e_j, jnp.asarray(e_j, g.e_j.dtype)]),
        Z_R=jnp.concatenate([g.Z_R, jnp.asarray(Z_R, g.Z_R.dtype)]),
        Z_t=jnp.concatenate([g.Z_t, jnp.asarray(Z_t, g.Z_t.dtype)]),
        w=jnp.concatenate([g.w, jnp.asarray(w, g.w.dtype)]),
    )
