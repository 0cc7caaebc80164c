"""Device-partitioned pose-graph optimization: edge-sharded Gauss-Newton
over a device mesh.

SURVEY §2.3's "keyframe-partitioned pose graph" row: the EDGE table (SE3
relative-pose edges + scale edges, ≙ the reference's g2o EdgeSE3 /
EdgeSBAScale chains, LocalBA.py:97-131) is partitioned across devices;
poses stay replicated (a 5k-keyframe graph is 5k×(9+3) floats = 240 KB —
replication is free, the O(E) Jacobian/Hessian-block work is what scales).
Each shard scatter-accumulates its edges' contributions to the block
diagonal, the gradient, and every CG matvec; `jax.lax.psum` over the mesh
combines them — collectives stay within a host's device interconnect
where the mesh allows, crossing hosts only along a host axis.

Communication per LM/GN outer step (K keyframes, float32):
  one (K,6,6)+(K,6) psum  = K·168 bytes  (normal-equation assembly)
  cg_iters × (K,6) psum   = K·24·cg_iters bytes  (matvec off-diagonal)
At K=5 000, cg=32: ~4.7 MB/step — about 10 µs at NVLink's 450 GB/s each
way (H100 data sheet), vs the O(E/n · 6·6·…) per-shard einsum FLOPs it
buys back.

Numerically identical to single-device pose_graph.optimize (same psum'd
sums, same CG trajectory); tests/test_pose_graph.py asserts this on the
8-virtual-device mesh at 5k keyframes.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models import pose_graph as pg_mod


def pad_edges(g: pg_mod.PoseGraph, n: int) -> pg_mod.PoseGraph:
    """Pad the SE3 and scale edge tables to multiples of `n` with
    zero-weight identity edges at vertex 0 (w=0 edges contribute exactly
    zero to every accumulation — see _se3_edge_blocks weighting)."""

    def pad_to(x, m, fill=0):
        k = (-x.shape[0]) % m
        if k == 0:
            return x
        pad_width = [(0, k)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width, constant_values=fill)

    E_pad = (-g.e_i.shape[0]) % n
    Z_R = g.Z_R
    if E_pad:
        eye = jnp.broadcast_to(jnp.eye(3, dtype=Z_R.dtype), (E_pad, 3, 3))
        Z_R = jnp.concatenate([Z_R, eye])
    return g._replace(
        e_i=pad_to(g.e_i, n),
        e_j=pad_to(g.e_j, n),
        Z_R=Z_R,
        Z_t=pad_to(g.Z_t, n),
        w=pad_to(g.w, n),
        s_i=pad_to(g.s_i, n),
        s_j=pad_to(g.s_j, n),
        s_meas=pad_to(g.s_meas, n, fill=1),
        s_w=pad_to(g.s_w, n),
    )


def graph_specs(axis: str) -> pg_mod.PoseGraph:
    """PartitionSpecs for an edge-sharded PoseGraph over a 1-D mesh axis:
    poses replicated, every edge table sharded on its leading axis."""
    rep = P()
    edge = P(axis)
    return pg_mod.PoseGraph(
        R=rep, t=rep,
        e_i=edge, e_j=edge, Z_R=edge, Z_t=edge, w=edge,
        s_i=edge, s_j=edge, s_meas=edge, s_w=edge,
        fixed=rep,
    )


def optimize_sharded(
    g: pg_mod.PoseGraph,
    mesh: Mesh,
    n_iters: int = 12,
    cg_iters: int = 32,
    damping: float = 1e-5,
    dcs_phi: float = 1.0,
    use_dcs: bool = True,
):
    """Run pose-graph GN with edges sharded over `mesh` (single axis).
    Pads the edge tables to the mesh size and returns (R, t, cost)."""
    (axis,) = mesh.axis_names
    n = mesh.devices.size
    g = pad_edges(g, n)
    return _runner(mesh, n_iters, cg_iters, use_dcs)(
        g, jnp.float32(damping), jnp.float32(dcs_phi)
    )


@lru_cache(maxsize=64)
def _runner(mesh, n_iters, cg_iters, use_dcs):
    """Cached jitted shard_map runner (shard_map outside jit dispatches
    op-by-op; fresh closures re-trace — measured in sharded_ba.py)."""
    axis = mesh.axis_names[0]
    in_specs = (graph_specs(axis), P(), P())
    out_specs = (P(), P(), P())

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    def _run(graph, damping, dcs_phi):
        return pg_mod.optimize(
            graph,
            n_iters=n_iters,
            cg_iters=cg_iters,
            damping=damping,
            dcs_phi=dcs_phi,
            use_dcs=use_dcs,
            axis_name=axis,
        )

    return jax.jit(_run)
