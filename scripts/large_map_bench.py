"""config #5: large-map BA at ~5k keyframes / ~1M landmarks.

Builds a synthetic loop-trajectory map at full config-#5 scale, runs the
memory-linear large-map solver (models/ba_large.py) landmark-sharded over
an N-device mesh, verifies convergence (cost drop + pose recovery), and
reports LM iterations/s per mesh size.

Usage:
  python scripts/large_map_bench.py [--devices 8] [--kf 5000] [--pts 1048576]
      [--iters 3] [--platform cpu] [--sweep]

On this sandbox the multi-device mesh is 8 VIRTUAL CPU devices over 4
physical cores — the sweep demonstrates numerical identity and per-device
memory scaling, not wall-clock speedup (virtual devices timeshare cores).
"""
import argparse
import json
import os
import sys
import time

p = argparse.ArgumentParser()
p.add_argument("--devices", type=int, default=8)
p.add_argument("--kf", type=int, default=5000)
p.add_argument("--pts", type=int, default=1 << 20)
p.add_argument("--obs-per-pt", type=int, default=4)
p.add_argument("--iters", type=int, default=5)
p.add_argument("--cg-iters", type=int, default=8)
p.add_argument("--lm-lambda", type=float, default=1e-2)
p.add_argument("--platform", default="cpu")
p.add_argument("--sweep", action="store_true", help="sweep mesh sizes 1,2,4,8")
args = p.parse_args()

if args.platform == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

import numpy as np
import jax

if args.platform:
    jax.config.update("jax_platforms", args.platform)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
from visual_slam_tpu.models import ba, ba_large
from visual_slam_tpu.ops import lie
from visual_slam_tpu.parallel import sharded_ba
from visual_slam_tpu.utils.synthetic import build_loop_map
from jax.sharding import Mesh


def run(prob, mesh_n, gt):
    devs = jax.devices()[:mesh_n]
    mesh = Mesh(np.array(devs), ("pt",))
    t0 = time.perf_counter()
    out, cost = sharded_ba.optimize_large_sharded(
        prob, mesh, n_iters=args.iters, cg_iters=args.cg_iters,
        init_lambda=args.lm_lambda,
    )
    float(np.asarray(cost))  # sync: the fetch waits for the device
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, cost = sharded_ba.optimize_large_sharded(
        prob, mesh, n_iters=args.iters, cg_iters=args.cg_iters,
        init_lambda=args.lm_lambda,
    )
    float(np.asarray(cost))
    t_warm = time.perf_counter() - t0
    R_gt, t_gt, X_gt = gt
    t_err = float(np.abs(np.asarray(out.t) - t_gt).max())
    cost0 = float(np.asarray(ba_large._cost(prob)))
    return dict(
        mesh=mesh_n,
        iters_per_s=round(args.iters / t_warm, 3),
        wall_s_warm=round(t_warm, 2),
        wall_s_first=round(t_first, 2),
        cost_before=round(cost0, 1),
        cost_after=round(float(np.asarray(cost)), 1),
        max_t_err_m=round(t_err, 5),
    )


def main():
    K, P, Q = args.kf, args.pts, args.obs_per_pt
    print(
        f"building synthetic map: {K} keyframes, {P} landmarks, "
        f"{P*Q} observations",
        file=sys.stderr,
    )
    prob, gt = build_loop_map(K, P, Q)
    sizes = [1, 2, 4, 8] if args.sweep else [args.devices]
    sizes = [s for s in sizes if s <= len(jax.devices())]
    results = [run(prob, s, gt) for s in sizes]
    print(
        json.dumps(
            {
                "metric": "config#5 large-map BA (synthetic)",
                "keyframes": K,
                "landmarks": P,
                "observations": P * Q,
                "lm_iters": args.iters,
                "cg_iters": args.cg_iters,
                "backend": jax.default_backend(),
                "runs": results,
            }
        )
    )


if __name__ == "__main__":
    main()
