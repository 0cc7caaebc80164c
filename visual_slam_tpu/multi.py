"""Multi-sequence batched SLAM (config #3).

Runs B sequences in lockstep: one batched front-end call per step, the
image batch DATA-PARALLEL over a device mesh (batch axis sharded with
`jax.sharding.NamedSharding`; XLA propagates the sharding through the
vmapped front-end so each device detects/describes only its sequences),
then each sequence's host-side tracking/bookkeeping consumes its slice of
the batch. The reference is strictly single-sequence (SURVEY.md §2.3), so
the semantics here are "N independent reference pipelines", scaled.

Distinct pseudo-sequences for testing/demos come from
utils.dataset.WindowView (offset/strided/reversed windows over a base
sequence).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .config import SlamConfig
from .models import frontend
from .pipeline import Slam


def _auto_mesh(batch: int) -> Mesh | None:
    """Largest power-of-two device count <= batch size, axis 'seq'."""
    devs = jax.devices()
    n = 1
    while n * 2 <= min(batch, len(devs)):
        n *= 2
    if n <= 1:
        return None
    return Mesh(np.array(devs[:n]), ("seq",))


def run_batched(
    sequences: list,
    config: SlamConfig | None = None,
    start: int = 0,
    stop: int | None = None,
    use_depth_list: list | None = None,
    mesh: Mesh | None = None,
) -> list[Slam]:
    """Run SLAM over B sequences with a shared, device-sharded front-end.

    Args:
      sequences: list of dataset objects (ICLNUIMDataset / WindowView).
      start/stop: frame range applied to every sequence.
      mesh: 1-axis device mesh to shard the image batch over (default:
        auto — largest power-of-two device count that divides into the
        batch; None/1 device = unsharded).
    Returns:
      list of Slam objects (one per sequence); each records the number of
      devices its front-end actually ran on in stats['frontend_devices'].
    """
    B = len(sequences)
    cfg = config or SlamConfig()
    if mesh is None:
        mesh = _auto_mesh(B)
    slams = [Slam(cfg) for _ in range(B)]
    n = min(
        (stop if stop is not None else len(ds)) - start for ds in sequences
    )
    n_mesh = int(mesh.devices.size) if mesh is not None else 1
    pad = (-B) % n_mesh
    n_devices_used = 1
    for step in range(n):
        i = start + step
        grays = np.stack([ds.gray(i) for ds in sequences])
        if pad:
            grays = np.concatenate([grays, grays[:pad]], axis=0)
        if mesh is not None:
            gdev = jax.device_put(
                grays, NamedSharding(mesh, P("seq", None, None))
            )
        else:
            gdev = jnp.asarray(grays)
        # One batched, jitted front-end call for all sequences; with a mesh
        # the batch axis stays sharded end-to-end (device-parallel extract).
        feats = frontend.extract_batch(
            gdev, cfg.frontend.max_features,
            cfg.frontend.quality_level, cfg.frontend.nms_radius,
        )
        n_devices_used = max(
            n_devices_used, len(feats.uv.sharding.device_set)
        )
        for b, slam in enumerate(slams):
            fb = jax.tree.map(lambda a: a[b], feats)
            depth = sequences[b].depth(i) if cfg.use_depth else None
            if not slam.initialized:
                slam._try_initialize(i, fb, depth)
            else:
                slam._track(i, fb, depth)
    for slam in slams:
        slam.stats["frontend_devices"] = n_devices_used
    return slams


@lru_cache(maxsize=16)
def _batched_window_fn(window: int, statics: tuple):
    """jit(vmap(_track_window)) cached per (window, static params).

    The sequence axis maps over images, snapshots, poses, keys, and
    counters; intrinsics and thresholds are shared.
    """
    from functools import partial as _partial

    from .pipeline import _track_window

    kw = dict(statics)
    fn = _partial(_track_window, window=window, **kw)
    return jax.jit(
        jax.vmap(
            fn,
            in_axes=(0, 0, 0, 0, 0, 0, None, 0, None, None, None),
        )
    )


def run_batched_windowed(
    sequences: list,
    config: SlamConfig | None = None,
    start: int = 0,
    stop: int | None = None,
    window: int = 8,
    mesh: Mesh | None = None,
) -> list[Slam]:
    """Run B sequences with the FULL tracking loop batched over devices.

    STATUS (r5): a DEVICE-RATE EXHIBIT, not the production config #3 mode.
    It rides the same windowed scan as pipeline.run_windowed, whose
    window-quantized keyframe cadence degrades beyond ~600 frames
    (round 4: 1200-frame windowed ATE 0.68 with failure
    clusters at ~frame 1075 at window 8 AND 16). The production
    multi-sequence mode is `run_batched` (per-frame semantics, shared
    device-sharded front-end), which is gated at 600 frames/sequence in
    tests/test_multi.py. Use this path to measure batched device
    throughput, or for sequences <=600 frames (gated at that length by
    tests/test_fullseq.py's windowed gate).

    Mechanics — upgrade of run_batched (which device-shards only the front-end): here
    each step dispatches ONE program computing a `window`-frame tracking
    scan (extract -> match -> PnP -> on-device keyframe rule,
    pipeline._track_window) for EVERY sequence, vmapped over the sequence
    axis and sharded over `mesh` — each device tracks its own sequences
    end-to-end on chip. Host-side per-sequence bookkeeping (keyframe
    insertion, mining, BA dispatch, event replays) consumes each
    sequence's slice of the one fetched batch (pipeline._walk_window).

    Sequences advance independent cursors (an event in one sequence replays
    only its own frames); finished sequences feed dummy windows until all
    are done. Init runs in lockstep with the device-sharded batched
    front-end (as in run_batched).
    """
    from .pipeline import _fetch_now, _walk_window

    B = len(sequences)
    cfg = config or SlamConfig()
    if mesh is None:
        mesh = _auto_mesh(B)
    n_mesh = int(mesh.devices.size) if mesh is not None else 1
    pad_b = (-B) % n_mesh
    Bp = B + pad_b
    slams = [Slam(cfg) for _ in range(B)]
    stops = [(stop if stop is not None else len(ds)) for ds in sequences]

    # ---- init phase: lockstep per-frame with the sharded batched front-end.
    i = start
    n_devices_used = 1
    while not all(s.initialized for s in slams) and i < min(stops):
        grays = np.stack([ds.gray(i) for ds in sequences])
        if pad_b:
            grays = np.concatenate([grays, grays[:pad_b]], axis=0)
        if mesh is not None:
            gdev = jax.device_put(grays, NamedSharding(mesh, P("seq", None, None)))
        else:
            gdev = jnp.asarray(grays)
        feats = frontend.extract_batch(
            gdev, cfg.frontend.max_features,
            cfg.frontend.quality_level, cfg.frontend.nms_radius,
        )
        n_devices_used = max(n_devices_used, len(feats.uv.sharding.device_set))
        for b, slam in enumerate(slams):
            fb = jax.tree.map(lambda a: a[b], feats)
            depth = sequences[b].depth(i) if cfg.use_depth else None
            if not slam.initialized:
                slam._try_initialize(i, fb, depth)
            else:
                slam._track(i, fb, depth)
        i += 1

    # ---- windowed phase: per-sequence cursors, one batched dispatch/window.
    cursors = [i] * B
    carrys: list[list] = [[] for _ in range(B)]
    last_gray = [np.asarray(sequences[b].gray(max(i - 1, 0))) for b in range(B)]

    def next_frame(b):
        if carrys[b]:
            return carrys[b].pop(0)
        j = cursors[b]
        if j >= stops[b]:
            return None
        cursors[b] += 1
        depth = sequences[b].depth(j) if cfg.use_depth else None
        return (j, np.asarray(sequences[b].gray(j)), depth)

    statics = (
        ("max_features", cfg.frontend.max_features),
        ("quality_level", cfg.frontend.quality_level),
        ("nms_radius", cfg.frontend.nms_radius),
        ("n_hyps", cfg.tracking.pnp_hypotheses),
        ("refine_iters", cfg.tracking.refine_iters),
        ("cross_check", cfg.frontend.cross_check),
        ("min_track_pts", cfg.tracking.min_tracked_points),
    )
    fn = _batched_window_fn(window, statics)

    while True:
        wins = []
        any_live = False
        for b in range(B):
            win = []
            while len(win) < window:
                fr = next_frame(b)
                if fr is None:
                    break
                win.append(fr)
            if win:
                any_live = True
                last_gray[b] = win[-1][1]
            wins.append(win)
        if not any_live:
            break
        for slam in slams:
            # Pending mines must land before stacking snapshots (the host
            # rule reads each snapshot's n_local).
            slam._apply_pending_mine(force=True)
            slam._apply_pending_ba()
        grays = np.stack(
            [
                np.stack(
                    [w[1] for w in win]
                    + [last_gray[b]] * (window - len(win))
                )
                for b, win in enumerate(wins)
            ]
        )
        if pad_b:
            grays = np.concatenate([grays, grays[:pad_b]], axis=0)
        # Stack per-sequence snapshots/poses/keys along the sequence axis.
        snaps = [s._snapshot for s in slams]
        def stack(key_):
            arrs = [sn[key_] for sn in snaps] + [snaps[0][key_]] * pad_b
            return jnp.stack(arrs)
        keys_in = jnp.stack([s.key for s in slams])
        split = jax.vmap(lambda k: jax.random.split(k, window + 1))(keys_in)
        split_np = np.asarray(split)
        for b, slam in enumerate(slams):
            slam.key = jnp.asarray(split_np[b, 0])
        keys = jnp.asarray(
            np.concatenate([split_np[:, 1:], split_np[:1, 1:].repeat(pad_b, 0)])
            if pad_b else split_np[:, 1:]
        )
        seq_sh = (
            NamedSharding(mesh, P("seq")) if mesh is not None else None
        )
        def put(x, spec_dims):
            if mesh is None:
                return jnp.asarray(x)
            return jax.device_put(
                x, NamedSharding(mesh, P("seq", *([None] * spec_dims)))
            )
        outs, _, _ = fn(
            put(grays, 2),
            put(stack("desc"), 2), put(stack("xyz"), 2), put(stack("valid"), 1),
            put(np.stack([s._prev_R for s in slams] + [slams[0]._prev_R] * pad_b), 2),
            put(np.stack([s._prev_t for s in slams] + [slams[0]._prev_t] * pad_b), 1),
            slams[0].intr,
            put(np.asarray(keys), 2),
            cfg.frontend.match_ratio,
            cfg.frontend.max_hamming,
            cfg.tracking.pnp_threshold_px,
        )
        n_devices_used = max(
            n_devices_used, len(outs.sharding.device_set)
        )
        (fetched,) = _fetch_now(outs)  # ONE array, ONE flush: (Bp,W,TOT)
        for b, slam in enumerate(slams):
            win = wins[b]
            if not win:
                continue
            carrys[b][:0] = _walk_window(slam, win, fetched[b], snaps[b])
    for slam in slams:
        slam._apply_pending_mine(force=True, dispatch_ba=True)
        slam._apply_pending_ba(force=True)  # final keyframes' BAs
        slam.stats["frontend_devices"] = n_devices_used
    return slams
