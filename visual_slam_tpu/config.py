"""Configuration dataclasses for the whole framework.

The reference hard-codes every constant inline (SURVEY.md §5 "Config / flag
system: none"); this module gathers them all, with the reference values and
their file:line provenance as defaults.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .models.map_state import MapConfig
from .models.loop_closure import LoopClosureConfig


@dataclass
class FrontendConfig:
    max_features: int = 1024  # reference allows 3000 corners (frame.py:11)
    quality_level: float = 0.01  # goodFeaturesToTrack quality (frame.py:11)
    nms_radius: int = 3  # minDistance 7 -> radius 3 (frame.py:11)
    match_ratio: float = 0.8  # Lowe ratio (frame.py:20)
    max_hamming: float = 96.0
    cross_check: bool = True


@dataclass
class TwoViewConfig:
    ess_threshold_factor: float = 3.0  # essTh = 3.0/fx (main.py:103)
    ransac_hypotheses: int = 512
    min_matches: int = 100  # skip-frame gate (main.py:97-98)
    min_valid_fraction: float = 0.9  # cheirality gate (main.py:113-114)
    distance_thresh: float = 50.0  # recoverPose distanceThresh (helper_functions.py:176)
    min_init_parallax_deg: float = 1.0  # median-parallax init gate (new; see pipeline._init_step)
    # Windowed-init pre-screen floor (pipeline._init_scan_window): frames
    # whose median match flow is below this cannot approach the 0.9
    # validFraction gate and are skipped without a full RANSAC attempt.
    min_flow_px: float = 30.0
    use_model_selection: bool = False  # homography-vs-essential init (v1 slam_test.py:207-218)
    # Anchor re-seeding (r5): init attempts pair the anchor frame against
    # each new frame; once the current frame is this many FRAMES past the
    # anchor (and no accept-confirm is in flight) the anchor slides to the
    # current frame. A pathological anchor (e.g. starting a sequence at lr
    # frame 200) otherwise starves init FOREVER. 150 clears the healthy
    # accept horizon (~63 frames of flow accumulation) PLUS the pipelined
    # init queue's ~44-frame consume lag, so normal runs never re-anchor.
    reanchor_after: int = 150


@dataclass
class TrackingConfig:
    pnp_hypotheses: int = 128  # extrinsic-guess hypothesis carries tracking; 128 random seeds suffice
    pnp_threshold_px: float = 8.0  # cv2.solvePnPRansac default reprojectionError
    # Gauss-Newton iterations per refine round (the tiered PnP runs TWO
    # re-gated rounds). 10 ≙ the reference's motion-only LM iterations
    # (LocalBA.py:39). DO NOT lower to save the ~0.6 ms/frame: a 600-frame
    # A/B showed parity (ATE 0.0353 at 5 vs 0.0367 at 10), but the
    # under-converged per-frame poses compound into monocular scale drift
    # that only shows at full length — 1200-frame no-loop ATE 0.048 at 10
    # vs 0.595 at 5, with the measured map scale exploding past 3x.
    refine_iters: int = 10
    min_tracked_points: int = 10  # hard floor to accept a pose


@dataclass
class KeyframeConfig:
    max_interval: int = 20  # main.py:221
    min_tracked: int = 80  # main.py:221
    tracked_ratio: float = 0.9  # main.py:221
    # Minimum frames between keyframes. The reference has no floor
    # (main.py:221); this framework needs a SMALL one because keyframe
    # insertion is pipelined: candidates are confirmed by re-tracking
    # against the current snapshot, and in low-texture segments where
    # mining starves (lr traj3 frames ~350-400) the rule chatters —
    # measured full-sequence mono: floor 0 gives 96 keyframes with
    # 1-frame-apart bursts + 392 re-track syncs + ATE 0.081; floor 10
    # (round 3) BECAME the cadence (keyframes every exactly 10 frames
    # until tracking collapsed). 5 suppresses the chatter without ever
    # being the binding constraint on the healthy cadence (10-21 frames).
    min_gap: int = 5
    cull_min_views: int = 3  # main.py:235
    cull_every: int = 4  # main.py:234
    cull_after: int = 6  # main.py:234
    # New-point triangulation parallax gate (≙ the reference's validated
    # `triangulation` helper, helper_functions.py:211-267 min_parallax; the
    # reference's main loop never calls it, and measurements agree: 0.5°
    # helps a 200-frame run slightly (ATE 0.0086 vs 0.0125) but starves the
    # map into tracking collapse on the full sequence's low-motion segments
    # (600-frame ATE 0.28 + 59 failures gated vs 0.037 + 0 ungated).
    # Default off; an adaptive fallback (min_mined_points) protects runs
    # that enable it.
    min_parallax_deg: float = 0.0
    # Adaptive-gate floor: when the strict parallax gate would mine fewer
    # than this many new landmarks, fall back to the ungated (reproj+depth)
    # mask — a starved snapshot cascades into keyframe-every-frame tracking
    # collapse on low-motion segments (measured on lr traj3 frames ~350-410).
    min_mined_points: int = 40
    max_new_depth: float = 10.0  # cheirality/depth gate for mined points
    triangulation_reproj_px: float = 4.0


@dataclass
class BAConfig:
    iters: int = 10  # optimizer.optimize(10) (LocalBA.py:39)
    cg_iters: int = 12  # truncated CG doubles as a trust region; 12 beats 24 on ATE
    scale_gauge_on_init: bool = True  # median-depth normalize (LocalBA.py:179-190)
    # "cg" = implicit-Schur truncated PCG — the truncation doubles as a
    # trust region, which is LOAD-BEARING on long sequences: with the exact
    # Cholesky step the full 1000-frame lr traj3 run warps to ATE 0.72 and
    # loses tracking, while CG-12 holds ATE 0.044 with zero failures (the
    # 200-frame run is indifferent: 0.019 vs 0.021).
    # "chol" = explicit reduced camera system + dense Cholesky (exact LM
    # step; fine for short windows).
    solver: str = "cg"
    # RGB-D inverse-depth residual weight (information, pseudo-disparity
    # units — see ba._depth_terms). Active only in use_depth mode; 0
    # disables. The reference never uses its depth images in BA.
    depth_weight: float = 1.0
    # Full-BA cadence in keyframes. 1 ≙ the reference (global BA on every
    # keyframe, main.py:322-323). Values >1 skip the BA dispatch on
    # intermediate keyframes (their observations join the next scheduled
    # BA) — a speed/accuracy knob for long sequences where BA-adjacent
    # host work dominates; any deviation from 1 must carry an A/B ATE
    # measurement next to the setting that uses it.
    every_n_kf: int = 1


@dataclass
class SlamConfig:
    intrinsics: np.ndarray = field(
        default_factory=lambda: np.array([481.20, 480.0, 319.5, 239.5], np.float32)
    )
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    twoview: TwoViewConfig = field(default_factory=TwoViewConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    map: MapConfig = field(default_factory=MapConfig)
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    seed: int = 0
    use_depth: bool = False  # RGB-D mode: metric init/triangulation from depth
