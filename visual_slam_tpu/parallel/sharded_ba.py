"""Distributed bundle adjustment: landmark-sharded Schur elimination over a
device mesh.

The north-star component: partition the LANDMARK axis (and
with it each landmark's observation slots — the planar (P, Q) layout keeps
a point's measurements contiguous) across devices/hosts. Each shard builds
its partial camera-side blocks (U, g_c, and the reduced camera system /
Schur matvec contributions) from its own landmarks; `jax.lax.psum` over the
mesh combines them. The landmark side (V, g_p, delta_p) is embarrassingly local: it
never crosses a shard boundary. The math lives in models/ba.py
(axis_name-aware); this module wraps it in shard_map over a Mesh.

Scaling semantics preserved from the reference (LocalBA.py:68-77
marginalized landmark blocks): the result is numerically identical to
single-device `ba.optimize` — sharding only changes where the reductions
run (test_parallel.py asserts this).
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models import ba as ba_mod


def problem_specs(axis: str) -> ba_mod.BAProblem:
    """PartitionSpecs for a landmark-sharded BAProblem over a 1-D mesh axis.

    Shared by the single-process shard_map wrapper below and the multi-host
    path (parallel/multihost.py), so the sharding contract has one source
    of truth.
    """
    rep = P()
    pts = P(axis)  # leading landmark axis
    slots = P(None, axis)  # (2, N) planar pixel planes: shard axis 1
    return ba_mod.BAProblem(
        R=rep, t=rep, X=pts, pt_valid=pts, cam=pts, uv=slots, w=pts,
        intr=rep, cam_fixed=rep, se_i=rep, se_j=rep, se_meas=rep, se_w=rep,
        dinv=pts, dw=pts,
    )


def optimize_sharded(
    p: ba_mod.BAProblem,
    mesh: Mesh,
    n_iters: int = 10,
    cg_iters: int = 12,
    points_fixed: bool = False,
    solver: str = "chol",
    use_depth: bool = False,
):
    """Run LM-Schur bundle adjustment with landmarks sharded over `mesh`
    (axis name taken from the mesh's single axis).

    The packed landmark count is a power of two >= 64 (ba.pack_planar), so
    it divides any power-of-two mesh; no repadding is needed.
    """
    (axis,) = mesh.axis_names
    n = mesh.devices.size
    if p.X.shape[0] % n:
        raise ValueError(
            f"landmark count {p.X.shape[0]} not divisible by mesh size {n}"
        )

    return _sharded_runner(
        mesh, n_iters, cg_iters, points_fixed, solver, use_depth
    )(p)


@lru_cache(maxsize=64)
def _sharded_runner(mesh, n_iters, cg_iters, points_fixed, solver, use_depth):
    """Build-and-cache the jitted shard_map runner.

    shard_map called OUTSIDE jit dispatches op-by-op, and a fresh closure
    per call re-traces the whole LM scan (seconds even on compile-cache
    hits) — so the jitted callable is cached per (mesh, static-params)."""
    axis = mesh.axis_names[0]
    in_specs = problem_specs(axis)
    out_specs = (in_specs, P())

    @partial(shard_map, mesh=mesh, in_specs=(in_specs,), out_specs=out_specs)
    def _run(prob):
        return ba_mod.optimize(
            prob,
            n_iters=n_iters,
            cg_iters=cg_iters,
            points_fixed=points_fixed,
            axis_name=axis,
            solver=solver,
            use_depth=use_depth,
        )

    return jax.jit(_run)


def optimize_large_sharded(
    p: ba_mod.BAProblem,
    mesh: Mesh,
    n_iters: int = 10,
    cg_iters: int = 12,
    points_fixed: bool = False,
    init_lambda: float = 1e-4,
):
    """Landmark-sharded LARGE-MAP bundle adjustment (config #5).

    Same sharding contract as optimize_sharded, but the per-shard solver is
    models/ba_large.py: channel-major (18,N) coupling, never (K,P)-dense,
    with camera gathers/reductions as XLA gather/scatter — memory linear in
    observations, the path that reaches ~5k keyframes x ~1M landmarks.
    """
    from ..models import ba_large

    (axis,) = mesh.axis_names
    n = mesh.devices.size
    if p.X.shape[0] % n:
        raise ValueError(
            f"landmark count {p.X.shape[0]} not divisible by mesh size {n}"
        )
    return _large_runner(mesh, n_iters, cg_iters, points_fixed, init_lambda)(p)


@lru_cache(maxsize=64)
def _large_runner(mesh, n_iters, cg_iters, points_fixed, init_lambda):
    """Cached jitted runner — see _sharded_runner for the why."""
    from ..models import ba_large

    axis = mesh.axis_names[0]
    in_specs = problem_specs(axis)
    out_specs = (in_specs, P())

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=out_specs,
        # Skip the varying-mesh-axes check (the sharding contract is
        # validated by the numeric-identity tests).
        check_vma=False,
    )
    def _run(prob):
        return ba_large.optimize(
            prob,
            n_iters=n_iters,
            cg_iters=cg_iters,
            points_fixed=points_fixed,
            init_lambda=init_lambda,
            axis_name=axis,
        )

    return jax.jit(_run)
