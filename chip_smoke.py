"""Chip smoke test: the SLAM main path once on one NVIDIA GPU.

Drives the system through the entry points a user calls (`run_sequence`
with the pipelined driver, `Slam.optimize_pose_graph`, `multi.run_batched`,
`models.ba_large.optimize`) on the seeded ICL-NUIM-shaped stream
(utils/scene.py) at the production widths (640x480, 1024 features), and
compares every translated op with its plain reference at real widths.

Phases (one process; any failure exits non-zero, nothing is skipped):
  device    jax version, device kind/count, `nvidia-smi` name + power limit,
            XLA_FLAGS and the compile-cache directory
  kernels   stencil detect+blur vs float64 NumPy; patch slices vs NumPy
            slicing; the whole front-end GPU vs CPU; camera segment
            reduce/expand at N=4,194,304 vs NumPy; one large-map LM
            iteration GPU vs CPU — each with its compiled memory analysis
            and device time from a profiler window
  main      450 monocular frames (one loop revisit) + final pose graph, and
            200 RGB-D frames; must initialize, track every frame, run BA,
            drop no fetched result, and hold its ATE bound
  batched   4 seeded sequences x 100 frames through multi.run_batched, each
            matching its own single-stream run
  large_map ba_large at config-#5 shape (5,000 keyframes, 1,048,576
            landmarks, 4 observations each), 3 LM iterations

`--four` runs only the 4-card phase instead: landmark-sharded BA (the
large-map and the online solver) and the 4-way sharded batched front-end,
each against the same problem on one card in the same process.

Usage:
  python chip_smoke.py          # one GPU
  python chip_smoke.py --four   # four GPUs of one host

The last stdout line is {"ok": true, "device": {...}} and is printed only
when every phase passed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# ATE bounds, fixed from a CPU rehearsal of the main phase (same stream,
# drivers and frame counts at 320x240 with 512 features) with a margin of
# about 3x: monocular 450 frames, Sim3-aligned 0.023 m -> bound 0.07 m;
# RGB-D 200 frames, SE3-aligned 0.0040 m -> bound 0.015 m.
MONO_ATE_BOUND_M = 0.07
RGBD_ATE_BOUND_M = 0.015
# Batched vs single-stream trajectories: tests/test_multi.py's tolerance.
BATCHED_ATOL_M = 2e-2
BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


class CompileClock:
    """Seconds XLA spent in backend compilation since construction."""

    def __init__(self):
        import jax

        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration_secs, **_):
        if event == BACKEND_COMPILE_EVENT:
            self.secs += duration_secs


def nvidia_smi() -> str:
    """Card name and power limit, from a child process that never imports
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def memory_line(fn, *args) -> str:
    """Compiled memory analysis of jit(fn)(*args)."""
    import jax

    m = jax.jit(fn).lower(*args).compile().memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k.replace('_size_in_bytes', '')}={getattr(m, k, None)}" for k in keys)


def device_ms(fn, *args, calls: int = 5):
    """Device-busy ms per call of fn(*args): the union of the event
    intervals on the GPU planes of a profiler trace around `calls`
    back-to-back calls. None off the GPU (no device planes)."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))  # compile + warm
    if jax.devices()[0].platform != "gpu":
        return None
    with tempfile.TemporaryDirectory(prefix="smoke_trace_") as d:
        with jax.profiler.trace(d):
            out = None
            for _ in range(calls):
                out = fn(*args)
            jax.block_until_ready(out)
        paths = glob.glob(os.path.join(d, "plugins", "profile", "*", "*.xplane.pb"))
        check(bool(paths), "profiler wrote no trace")
        iv = []
        for plane in ProfileData.from_file(paths[0]).planes:
            if plane.name.startswith("/device:GPU"):
                for line in plane.lines:
                    iv.extend((e.start_ns, e.start_ns + e.duration_ns) for e in line.events)
    check(bool(iv), "trace holds no GPU events")
    iv.sort()
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / calls / 1e6


def fmt_ms(ms) -> str:
    return "not measured (no GPU)" if ms is None else f"{ms:.4f} ms"


# ----------------------------------------------------------------- phases


def phase_device() -> str:
    import jax

    from visual_slam_tpu.utils import compile_cache

    devs = jax.devices()
    log(f"[device] jax {jax.__version__} platform={devs[0].platform} "
        f"kind={devs[0].device_kind!r} count={len(devs)}")
    smi = nvidia_smi()
    log(f"[device] nvidia-smi name,power.limit: {smi}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={compile_cache.enable()}")
    return smi


def phase_kernels(gray_u8: np.ndarray, K: int = 1024, seg_n: int = 4_194_304,
                  seg_k: int = 5000, seg_c: int = 27,
                  lm_map=(256, 16384, 4)) -> None:
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.models import ba_large, frontend
    from visual_slam_tpu.ops import descriptor_mxu, detect, reference
    from visual_slam_tpu.utils.synthetic import build_loop_map

    cpu = jax.devices("cpu")[0]
    gray = gray_u8.astype(np.float32) / np.float32(255.0)
    H, W = gray.shape

    # 1. Stencil detect + blur vs float64 NumPy.
    g = jnp.asarray(gray)
    peaks, blur = map(np.asarray, detect.corner_peaks_and_blur(g))
    rp, rb = reference.corner_peaks_and_blur_np(gray)
    strong = rp > 0.01 * rp[np.isfinite(rp)].max()
    dev_strong = peaks > 0.01 * rp[np.isfinite(rp)].max()
    check(np.array_equal(strong, dev_strong),
          f"detect: strong peak sets differ ({int((strong ^ dev_strong).sum())} px)")
    scale = rp[strong].max()
    err_p = float(np.max(np.abs(peaks[strong] - rp[strong]) / (np.abs(rp[strong]) + 0.1 * scale)))
    err_b = float(np.max(np.abs(blur - rb) / (np.abs(rb) + 1e-6)))
    # Peak values: rtol 1e-5 against |value| + 10% of the strongest
    # response — the min-eigenvalue response is a difference of two terms
    # the size of the trace, so float32 cancellation error scales with the
    # frame's strongest response, not with each small peak.
    check(err_p < 1e-5, f"detect: peak values off by {err_p:.3g}")
    check(err_b < 1e-5, f"detect: blur off by {err_b:.3g}")
    log(f"[kernels] detect+blur {H}x{W}: strong peaks {int(strong.sum())} equal; "
        f"max rel err peaks {err_p:.3g} blur {err_b:.3g} (tol 1e-5) | "
        f"{memory_line(detect.corner_peaks_and_blur, g)} | device "
        f"{fmt_ms(device_ms(detect.corner_peaks_and_blur, g))}")

    # 2. Patch slices at K vs NumPy slicing (incl. clipped border keypoints).
    pk, bl = detect.corner_peaks_and_blur(g)
    uv, _, _ = frontend._topk_select(pk, K)
    uv = np.asarray(uv).copy()
    uv[-4:] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]
    uv = jnp.asarray(uv)
    pat = np.asarray(descriptor_mxu.extract_patches(bl, uv))
    ref = reference.extract_patches_np(np.asarray(bl), np.asarray(uv))
    check(np.array_equal(pat, ref), "patches differ from NumPy slicing")
    log(f"[kernels] patches K={K}: equal to NumPy slicing | "
        f"{memory_line(descriptor_mxu.extract_patches, bl, uv)} | device "
        f"{fmt_ms(device_ms(descriptor_mxu.extract_patches, bl, uv))}")

    # 3. Whole front-end: default device vs CPU, same process.
    f_dev = frontend.extract(g, K)
    with jax.default_device(cpu):
        f_cpu = frontend.extract(jax.device_put(gray, cpu), K)
    kd = {tuple(p): i for i, p in enumerate(np.asarray(f_dev.uv).tolist())}
    kc = {tuple(p): i for i, p in enumerate(np.asarray(f_cpu.uv).tolist())}
    check(kd.keys() == kc.keys(), f"front-end: keypoint sets differ ({len(kd.keys() ^ kc.keys())})")
    order = np.array([kd[p] for p in kc])  # device index of each cpu keypoint
    vd, vc = np.asarray(f_dev.valid)[order], np.asarray(f_cpu.valid)
    check(np.array_equal(vd, vc), "front-end: validity differs")
    dd, dc = np.asarray(f_dev.desc)[order], np.asarray(f_cpu.desc)
    bits = np.unpackbits((dd ^ dc)[vc].view(np.uint8)).mean()
    # bf16 products with float32 accumulation: summation order differs
    # between backends, which flips only bits whose two samples are within
    # rounding of each other.
    check(bits <= 0.005, f"front-end: {bits:.4%} descriptor bits differ")
    n_same_order = int((order == np.arange(len(order))).sum())
    log(f"[kernels] front-end K={K}: same keypoints and validity "
        f"({int(vc.sum())} valid, {n_same_order}/{len(order)} in the same slot), "
        f"descriptor bits differing {bits:.4%} (tol 0.5%) | "
        f"{memory_line(lambda x: frontend._extract_stencil_fused(x, K), g)} | device "
        f"{fmt_ms(device_ms(frontend._extract_stencil_fused, g, K))}")

    # 4. Camera segment reduce / expand at config-#5 slot count vs NumPy.
    rng = np.random.default_rng(0)
    data = rng.standard_normal((seg_c, seg_n), dtype=np.float32)
    cam = rng.integers(0, seg_k, seg_n).astype(np.int32)
    xk = rng.standard_normal((seg_c, seg_k), dtype=np.float32)
    d_dev, c_dev, x_dev = jnp.asarray(data), jnp.asarray(cam), jnp.asarray(xk)
    red_fn = jax.jit(ba_large.cam_reduce, static_argnums=2)
    red = np.asarray(red_fn(d_dev, c_dev, seg_k))
    ref_red = reference.cam_reduce_np(data, cam, seg_k)
    # rtol 1e-5 of the sum of magnitudes: atomics reorder each camera's
    # float32 sum, and a sum's rounding error scales with sum(|terms|).
    mag = reference.cam_reduce_np(np.abs(data), cam, seg_k)
    err_r = float(np.max(np.abs(red - ref_red) / mag))
    check(err_r < 1e-5, f"cam_reduce off by {err_r:.3g}")
    exp = np.asarray(ba_large.cam_expand(x_dev, c_dev))
    check(np.array_equal(exp, reference.cam_expand_np(xk, cam)), "cam_expand differs")
    log(f"[kernels] cam_reduce C={seg_c} N={seg_n} K={seg_k}: max err/sum|terms| "
        f"{err_r:.3g} (tol 1e-5) | {memory_line(lambda a, b: ba_large.cam_reduce(a, b, seg_k), d_dev, c_dev)}"
        f" | device {fmt_ms(device_ms(red_fn, d_dev, c_dev, seg_k))}")
    log(f"[kernels] cam_expand C={seg_c} N={seg_n} K={seg_k}: equal | "
        f"{memory_line(ba_large.cam_expand, x_dev, c_dev)} | device "
        f"{fmt_ms(device_ms(jax.jit(ba_large.cam_expand), x_dev, c_dev))}")
    del d_dev, c_dev, x_dev, data

    # 5. One large-map LM iteration: default device vs CPU.
    prob, _ = build_loop_map(*lm_map)
    lm = jax.jit(lambda p: ba_large.optimize(p, n_iters=1, cg_iters=8, init_lambda=1e-2)[1])
    c_dev = float(lm(prob))
    c_cpu = float(lm(jax.device_put(prob, cpu)))
    c0 = float(ba_large._cost(prob))
    rel = abs(c_dev - c_cpu) / abs(c_cpu)
    check(rel < 1e-4, f"ba_large LM iteration: cost {c_dev} vs CPU {c_cpu}")
    check(c_dev < c0, f"ba_large LM iteration did not lower the cost ({c0} -> {c_dev})")
    log(f"[kernels] ba_large 1 LM iter K,P,Q={lm_map}: cost {c0:.6g} -> {c_dev:.6g} "
        f"(CPU {c_cpu:.6g}, rel diff {rel:.3g}, tol 1e-4) | {memory_line(lm, prob)} | "
        f"device {fmt_ms(device_ms(lm, prob, calls=2))}")


def run_stream(ds, n: int, rgbd: bool, max_features: int = 1024):
    """One production run: pipelined driver over frames [0, n), then the
    final pose graph. Returns (slam, wall seconds, ATE metres)."""
    from visual_slam_tpu.config import SlamConfig
    from visual_slam_tpu.pipeline import run_sequence
    from visual_slam_tpu.utils import evaluate

    cfg = SlamConfig()
    cfg.intrinsics = ds.intrinsics
    cfg.frontend.max_features = max_features
    cfg.use_depth = rgbd
    t0 = time.perf_counter()
    slam = run_sequence(ds, cfg, 0, n, pipelined=True)
    if slam.initialized:
        slam.optimize_pose_graph()
    wall = time.perf_counter() - t0
    ate = None
    if slam.initialized:
        idx, est = slam.positions()
        ate = evaluate.ate_rmse(est, ds.ground_truth()[idx, :3, 3], align_scale=not rgbd)[0]
    slam.close()
    return slam, wall, ate


def check_run(tag: str, slam, ate, bound: float) -> None:
    st = slam.stats
    check(slam.initialized, f"{tag}: never initialized")
    check(st.get("track_failures", 0) == 0, f"{tag}: {st.get('track_failures')} track failures")
    check(st["keyframes"] > 0 and st["ba_runs"] > 0,
          f"{tag}: keyframes={st['keyframes']} ba_runs={st['ba_runs']}")
    check(st["fetch_timeouts"] == 0, f"{tag}: {st['fetch_timeouts']} fetched results dropped")
    check(ate < bound, f"{tag}: ATE {ate:.4f} m over its bound {bound} m")


def phase_main(smi: str, n_mono: int = 450, n_rgbd: int = 200, width: int = 640,
               max_features: int = 1024, mono_bound: float = MONO_ATE_BOUND_M,
               rgbd_bound: float = RGBD_ATE_BOUND_M) -> None:
    import jax

    from visual_slam_tpu.utils.scene import SceneDataset

    t0 = time.perf_counter()
    ds = SceneDataset(max(n_mono, n_rgbd), seed=0, width=width, height=width * 3 // 4)
    log(f"[main] rendered {len(ds)} frames {width}x{width * 3 // 4} in "
        f"{time.perf_counter() - t0:.1f} s (outside every timed run)")
    clock = CompileClock()
    dev = jax.devices()[0]
    runs = [("mono cold", n_mono, False, mono_bound),
            ("mono warm", n_mono, False, mono_bound),
            ("rgbd", n_rgbd, True, rgbd_bound)]
    for tag, n, rgbd, bound in runs:
        c0 = clock.secs
        slam, wall, ate = run_stream(ds, n, rgbd, max_features)
        st = slam.stats
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
        log(f"[main] {tag}: frames={n} init_frame={st['init_frame']} "
            f"keyframes={st['keyframes']} ba_runs={st['ba_runs']} "
            f"loop_closures={st.get('loop_closures', 0)} "
            f"track_failures={st.get('track_failures', 0)} "
            f"fetch_timeouts={st['fetch_timeouts']} ate_m={ate} (bound {bound}) "
            f"wall_s={wall:.3f} fps={n / wall:.3f} compile_s={clock.secs - c0:.3f} "
            f"peak_bytes_in_use={peak} card=[{smi}]")
        check_run(f"main {tag}", slam, ate, bound)


def phase_batched(n_seq: int = 4, n_frames: int = 100, width: int = 640,
                  max_features: int = 1024) -> None:
    from visual_slam_tpu.config import SlamConfig
    from visual_slam_tpu.multi import run_batched
    from visual_slam_tpu.pipeline import run_sequence
    from visual_slam_tpu.utils.scene import SceneDataset

    seqs = [SceneDataset(n_frames, seed=s, width=width, height=width * 3 // 4)
            for s in range(1, n_seq + 1)]
    cfg = SlamConfig()
    cfg.intrinsics = seqs[0].intrinsics
    cfg.frontend.max_features = max_features
    cfg.use_depth = True
    t0 = time.perf_counter()
    slams = run_batched(seqs, cfg, 0, n_frames, mesh=None)
    wall = time.perf_counter() - t0
    for b, (seq, slam) in enumerate(zip(seqs, slams)):
        single = run_sequence(seq, cfg, 0, n_frames)
        ib, pb = slam.positions()
        is_, ps = single.positions()
        check(slam.initialized and np.array_equal(ib, is_),
              f"batched seq {b}: frames differ from its single-stream run")
        dmax = float(np.abs(pb - ps).max())
        check(dmax <= BATCHED_ATOL_M, f"batched seq {b}: {dmax:.4f} m from its single run")
        log(f"[batched] seq seed={seq.seed}: {len(ib)} poses, keyframes="
            f"{slam.stats['keyframes']}, max |batched - single| {dmax:.2e} m "
            f"(tol {BATCHED_ATOL_M})")
        slam.close()
        single.close()
    log(f"[batched] {n_seq} x {n_frames} frames in {wall:.3f} s "
        f"({n_seq * n_frames / wall:.3f} frames/s incl. compile)")


def phase_large_map(kpq=(5000, 1_048_576, 4), n_iters: int = 3) -> None:
    import jax

    from visual_slam_tpu.models import ba_large
    from visual_slam_tpu.utils.synthetic import build_loop_map

    t0 = time.perf_counter()
    prob, (_, t_gt, _) = build_loop_map(*kpq)
    log(f"[large_map] built K,P,Q={kpq} ({kpq[1] * kpq[2]} observations) in "
        f"{time.perf_counter() - t0:.1f} s")
    opt = jax.jit(lambda p: ba_large.optimize(p, n_iters=n_iters, cg_iters=8, init_lambda=1e-2))
    cost0 = float(ba_large._cost(prob))
    t0 = time.perf_counter()
    out, cost = opt(prob)
    cost = float(cost)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, cost_w = opt(prob)
    cost_w = float(cost_w)
    warm = time.perf_counter() - t0
    dev = jax.devices()[0]
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    t_err0 = float(np.abs(np.asarray(prob.t) - t_gt).max())
    t_err = float(np.abs(np.asarray(out.t) - t_gt).max())
    log(f"[large_map] {n_iters} LM iters: cost {cost0:.6g} -> {cost_w:.6g}, max |t - t_gt| "
        f"{t_err0:.4g} -> {t_err:.4g} m, per-iteration {warm / n_iters:.4f} s warm "
        f"(first call {cold:.3f} s incl. compile), peak_bytes_in_use={peak}")
    check(cost_w < cost0 and cost < cost0, f"large_map: cost did not decrease ({cost0} -> {cost_w})")


def phase_four(kpq=(5000, 1_048_576, 4), online=(64, 8192, 4), n_seq: int = 4,
               n_frames: int = 30, width: int = 640, max_features: int = 1024) -> None:
    """Sharded paths on a 4-device mesh vs the same problem on one device."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from visual_slam_tpu.config import SlamConfig
    from visual_slam_tpu.models import ba, ba_large, frontend
    from visual_slam_tpu.multi import _auto_mesh, run_batched
    from visual_slam_tpu.parallel import sharded_ba
    from visual_slam_tpu.utils.scene import SceneDataset
    from visual_slam_tpu.utils.synthetic import build_loop_map

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    mesh = Mesh(np.array(devs), ("pt",))

    def shard_devices(arr):
        return sorted({str(s.device) for s in arr.addressable_shards})

    # Large-map BA, landmark-sharded.
    prob, _ = build_loop_map(*kpq)
    one = jax.jit(lambda p: ba_large.optimize(p, n_iters=3, cg_iters=8, init_lambda=1e-2))
    _, c1 = one(prob)
    c1 = float(c1)
    out4, c4 = sharded_ba.optimize_large_sharded(prob, mesh, n_iters=3, cg_iters=8, init_lambda=1e-2)
    c4 = float(c4)
    t0 = time.perf_counter()
    out4, c4w = sharded_ba.optimize_large_sharded(prob, mesh, n_iters=3, cg_iters=8, init_lambda=1e-2)
    c4w = float(c4w)
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(one(prob)[1])
    t1 = time.perf_counter() - t0
    rel = abs(c4 - c1) / abs(c1)
    log(f"[four] large-map BA K,P,Q={kpq}, 3 LM iters: 4-card cost {c4:.8g} vs 1-card "
        f"{c1:.8g} (rel diff {rel:.3g}, tol 1e-4); warm wall 4-card {t4:.4f} s, "
        f"1-card {t1:.4f} s; landmark shards on {shard_devices(out4.X)}")
    check(rel < 1e-4, f"four: sharded large-map cost {c4} vs one card {c1}")
    check(len(shard_devices(out4.X)) == 4, "four: large-map shards not on 4 devices")

    # Online solver (dense camera system), landmark-sharded.
    prob_s, _ = build_loop_map(*online)
    _, s1 = ba.optimize(prob_s, n_iters=4, cg_iters=8, solver="cg")
    out_s4, s4 = sharded_ba.optimize_sharded(prob_s, mesh, n_iters=4, cg_iters=8, solver="cg")
    s1, s4 = float(s1), float(s4)
    rel_s = abs(s4 - s1) / abs(s1)
    log(f"[four] online BA K,P,Q={online}, 4 LM iters: 4-card cost {s4:.8g} vs 1-card "
        f"{s1:.8g} (rel diff {rel_s:.3g}, tol 1e-4); shards on {shard_devices(out_s4.X)}")
    check(rel_s < 1e-4, f"four: sharded online BA cost {s4} vs one card {s1}")

    # 4-way batched front-end (multi._auto_mesh) vs unsharded.
    seqs = [SceneDataset(n_frames, seed=s, width=width, height=width * 3 // 4)
            for s in range(1, n_seq + 1)]
    imgs = np.stack([s.gray(0) for s in seqs])
    fmesh = _auto_mesh(n_seq)
    check(fmesh is not None and fmesh.devices.size == 4, "four: _auto_mesh did not span 4 devices")
    feats = frontend.extract_batch(
        jax.device_put(imgs, NamedSharding(fmesh, P("seq", None, None))), max_features)
    log(f"[four] batched front-end shards on {shard_devices(feats.uv)}")
    check(len(shard_devices(feats.uv)) == 4, "four: front-end batch not on 4 devices")
    cfg = SlamConfig()
    cfg.intrinsics = seqs[0].intrinsics
    cfg.frontend.max_features = max_features
    cfg.use_depth = True
    sl4 = run_batched(seqs, cfg, 0, n_frames)
    sl1 = run_batched(seqs, cfg, 0, n_frames, mesh=Mesh(np.array(devs[:1]), ("seq",)))
    check(sl4[0].stats["frontend_devices"] == 4, "four: run_batched front-end not on 4 devices")
    for b, (a4, a1) in enumerate(zip(sl4, sl1)):
        i4, p4 = a4.positions()
        i1, p1 = a1.positions()
        check(np.array_equal(i4, i1), f"four: batched seq {b} frames differ")
        dmax = float(np.abs(p4 - p1).max())
        log(f"[four] run_batched seq {b}: 4-card vs 1-card max |diff| {dmax:.2e} m "
            f"(tol {BATCHED_ATOL_M}), keyframes {a4.stats['keyframes']}/{a1.stats['keyframes']}")
        check(dmax <= BATCHED_ATOL_M, f"four: batched seq {b} off by {dmax} m")
        a4.close()
        a1.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2

    from visual_slam_tpu.utils.scene import SceneDataset

    t_start = time.perf_counter()
    smi = phase_device()
    if args.four:
        phase_four()
    else:
        frame = SceneDataset(1, seed=0).gray_u8(0)
        for name, fn in (
            ("kernels", lambda: phase_kernels(frame)),
            ("main", lambda: phase_main(smi)),
            ("batched", phase_batched),
            ("large_map", phase_large_map),
        ):
            t0 = time.perf_counter()
            fn()
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    log(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s; card [{smi}]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
