"""Weak-scaling sweep for the landmark-sharded large-map BA (VERDICT r2 #3).

Fixed landmarks-PER-DEVICE: mesh size n carries n x P_DEV landmarks
(Q observations each) over a FIXED keyframe count, so each shard's work is
constant while the psum'd camera-side payload stays K-sized. On this
sandbox the n "devices" are XLA virtual CPU devices timesharing 4 physical
cores — hardware does not grow with n, so ideal weak scaling here is
wall(n) = n * wall(1) (total FLOPs grow n-fold on fixed silicon).
Efficiency is therefore reported as n*t1/tn; comm/overhead shows up as
efficiency < 100%. On real n-chip hardware the same sharding gives
wall(n) ~ wall(1) + comm, and the analytic comm model below bounds comm.

Also prints the communication model: bytes psum'd per LM iteration
(U (K,6,6) + g_c (K,6) + b_sub (6,K) + cg_iters x y2 (6,K) + 2 cost
scalars, float32) vs per-shard FLOPs — the cross-host traffic estimate
for a 2-host deployment.

Usage: python scripts/weak_scaling.py [--pts-per-dev 131072] [--kf 512]
"""
import argparse
import json
import os
import sys
import time

p = argparse.ArgumentParser()
p.add_argument("--pts-per-dev", type=int, default=1 << 17)
p.add_argument("--kf", type=int, default=512)
p.add_argument("--obs-per-pt", type=int, default=4)
p.add_argument("--iters", type=int, default=3)
p.add_argument("--cg-iters", type=int, default=8)
p.add_argument("--sizes", default="1,2,4,8")
args = p.parse_args()

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from visual_slam_tpu.parallel import sharded_ba
from visual_slam_tpu.utils.synthetic import build_loop_map
from jax.sharding import Mesh

K, Q = args.kf, args.obs_per_pt
sizes = [int(s) for s in args.sizes.split(",")]
runs = []
for n in sizes:
    P = args.pts_per_dev * n
    prob, gt = build_loop_map(K, P, Q)
    mesh = Mesh(np.array(jax.devices()[:n]), ("pt",))

    def go():
        out, cost = sharded_ba.optimize_large_sharded(
            prob, mesh, n_iters=args.iters, cg_iters=args.cg_iters,
            init_lambda=1e-2,
        )
        return float(np.asarray(cost))

    go()  # compile + warm
    t0 = time.perf_counter()
    cost = go()
    t = time.perf_counter() - t0
    runs.append(dict(devices=n, landmarks=P, obs=P * Q,
                     wall_s=round(t, 3),
                     iters_per_s=round(args.iters / t, 3),
                     cost_after=round(cost, 1)))
    print(f"n={n}: {t:.2f}s  {args.iters/t:.3f} iters/s  P={P}",
          file=sys.stderr)

t1 = runs[0]["wall_s"]
for r in runs:
    r["weak_eff_pct"] = round(100.0 * r["devices"] * t1 / r["wall_s"], 1)

# Communication model (per LM iteration, float32).
cg = args.cg_iters
psum_bytes = 4 * (K * 36 + K * 6 + K * 6 + cg * K * 6 + 2)
flops_per_shard = args.pts_per_dev * Q * (cg * 260 + 700)  # coupling+build est.
print(json.dumps({
    "metric": "config#5 weak scaling (fixed landmarks/device, virtual CPU mesh)",
    "keyframes": K,
    "pts_per_device": args.pts_per_dev,
    "cg_iters": cg,
    "runs": runs,
    "comm_model": {
        "psum_bytes_per_lm_iter": psum_bytes,
        "psum_mb_per_lm_iter": round(psum_bytes / 1e6, 3),
        "approx_flops_per_shard_per_lm_iter": flops_per_shard,
        "dcn_2host_est_ms_per_lm_iter_at_10GBps": round(
            psum_bytes / 10e9 * 1e3, 3
        ),
    },
}))
