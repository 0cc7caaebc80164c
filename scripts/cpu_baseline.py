"""Measure the CPU reference-semantics baseline (BASELINE_CPU.json).

The reference repo cannot run here (g2o/pangolin not installed), so this
reproduces its per-frame tracking hot path with the exact same OpenCV calls
and parameters (reference: src/v2/frame.py:10-49 front-end + matcher,
src/v2/main.py:191-197 solvePnPRansac tracking) and measures frames/s on
ICL-NUIM lr (living-room traj3), first 200 frames.

3D points for PnP come from backprojecting the previous frame's keypoints
through the (real) depth map at TUM/ICL scale 5000 — the metric equivalent
of the map points the reference tracks. Keyframe-rate bundle adjustment is
EXCLUDED (g2o unavailable), which makes this baseline faster than the true
reference — i.e. our vs_baseline speedups are conservative.

Usage: python scripts/cpu_baseline.py --data <ICL-NUIM dir> [--frames 200]
           [--out BASELINE_CPU.json]
"""
import argparse
import json
import time

import numpy as np
import cv2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="ICL-NUIM lr kt* directory")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    DATA = args.data

    fx, fy, cx, cy = 481.20, 480.0, 319.5, 239.5
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    sift = cv2.SIFT_create()
    bf = cv2.BFMatcher()

    prev = None  # (kp ndarray, desc, depth)
    n_frames = 0
    t_total = 0.0
    t_detect = 0.0
    t_match = 0.0
    t_pnp = 0.0
    for i in range(args.frames):
        gray = cv2.imread(f"{DATA}/rgb/{i}.png", cv2.IMREAD_GRAYSCALE)
        depth = cv2.imread(f"{DATA}/depth/{i}.png", cv2.IMREAD_UNCHANGED).astype(np.float64) / 5000.0
        t0 = time.perf_counter()
        # Front-end ≙ FeatureExtractor.compute_features (frame.py:10-14).
        t_d0 = time.perf_counter()
        corners = cv2.goodFeaturesToTrack(gray, 3000, 0.01, 7)
        kps = [cv2.KeyPoint(x=float(p[0][0]), y=float(p[0][1]), size=20) for p in corners]
        kps, desc = sift.compute(gray, kps)
        uv = np.array([k.pt for k in kps], np.float64)
        t_detect += time.perf_counter() - t_d0
        if prev is not None:
            kp_prev, desc_prev, depth_prev = prev
            # Matcher ≙ FeatureMatcher.match_features (frame.py:20-49).
            t_m0 = time.perf_counter()
            knn = bf.knnMatch(desc_prev, desc, k=2)
            matches = [m for m, n in knn if m.distance < 0.8 * n.distance]
            t_match += time.perf_counter() - t_m0
            # PnP tracking ≙ main.py:191-197 (objectPoints from the map; here
            # from depth-backprojected previous-frame keypoints).
            if len(matches) >= 10:
                t_p0 = time.perf_counter()
                q = np.array([kp_prev[m.queryIdx] for m in matches])
                z = depth_prev[
                    np.clip(q[:, 1].astype(int), 0, 479),
                    np.clip(q[:, 0].astype(int), 0, 639),
                ]
                ok = z > 0.05
                X = np.stack(
                    [(q[:, 0] - cx) / fx * z, (q[:, 1] - cy) / fy * z, z], -1
                )[ok]
                img_pts = np.array([uv[m.trainIdx] for m in matches])[ok]
                if len(X) >= 6:
                    cv2.solvePnPRansac(
                        X[:, None, :].astype(np.float32),
                        img_pts[:, None, :].astype(np.float32),
                        K,
                        None,
                    )
                t_pnp += time.perf_counter() - t_p0
        prev = (uv, desc, depth)
        t_total += time.perf_counter() - t0
        n_frames += 1

    out = {
        "frames": n_frames,
        "fps": n_frames / t_total,
        "ms_per_frame": 1000 * t_total / n_frames,
        "ms_detect": 1000 * t_detect / n_frames,
        "ms_match": 1000 * t_match / max(n_frames - 1, 1),
        "ms_pnp": 1000 * t_pnp / max(n_frames - 1, 1),
        "note": "reference-semantics CPU hot path (OpenCV), BA excluded",
    }
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
