"""Seeded synthetic RGB-D stream in the shape of ICL-NUIM's living room.

The system's benchmark sequence (ICL-NUIM `lr kt*`: a synthetic living room
rendered at 640x480, depth as 16-bit PNG at scale 5000, TUM-format
ground-truth cam->world poses, intrinsics 481.2/480/319.5/239.5) cannot be
fetched where the system is tested and measured, so this module renders a
stream of the same shape from a seed, in pure NumPy:

  * a 5 x 4 x 2.7 m room with five pieces of box furniture, every surface
    covered by its own region of one procedural texture atlas (multi-scale
    value noise, rectangles and disks: non-repetitive, corner-rich);
  * a smooth closed camera loop of LOOP_FRAMES = 400 frames (~1 cm and
    ~0.5 deg per frame), so a longer run revisits its starting viewpoint;
  * ray casting against the room's planes and the furniture's slabs gives
    gray uint8 images and depth stored as ICL stores it (uint16, metres x
    5000), plus per-frame sensor noise seeded by (seed, frame).

`SceneDataset` renders every frame when it is built, so no timed loop ever
waits on the renderer, and exposes the `ICLNUIMDataset` interface that
`pipeline.run_sequence` and `multi.run_batched` consume.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .dataset import DEPTH_SCALE, ICL_INTRINSICS

ROOM_LO = np.array([-2.5, -2.0, 0.0])  # world frame: z up, floor at z = 0
ROOM_HI = np.array([2.5, 2.0, 2.7])
# Furniture as axis-aligned boxes (lo, hi): sofa, table, shelf, cabinet, crate.
FURNITURE = (
    ((-2.0, 1.2, 0.0), (0.2, 2.0, 0.8)),
    ((-0.5, 0.9, 0.0), (0.5, 1.5, 0.75)),
    ((1.8, -1.0, 0.0), (2.4, 1.0, 2.0)),
    ((-2.4, -1.8, 0.0), (-1.8, -0.6, 1.2)),
    ((0.8, -1.6, 0.0), (1.4, -1.0, 0.5)),
)
TEXEL_M = 0.005  # texture resolution: 5 mm per texel
ATLAS_W = 4096
LOOP_FRAMES = 400  # frames per closed camera loop
NOISE_STD = 1.0  # per-pixel sensor noise, gray levels


def intrinsics_for(width: int) -> np.ndarray:
    """ICL-NUIM intrinsics scaled to an image `width` pixels wide (pixel
    centres kept: cx' = (cx + 0.5) * s - 0.5)."""
    s = width / 640.0
    fx, fy, cx, cy = ICL_INTRINSICS.astype(np.float64)
    return np.array(
        [fx * s, fy * s, (cx + 0.5) * s - 0.5, (cy + 0.5) * s - 0.5], np.float32
    )


def _faces():
    """Every textured face as (normal axis, plane coordinate, (lo, hi) of
    the face's box, shade). The room's six faces come first."""
    faces = []
    boxes = [(ROOM_LO, ROOM_HI)] + [
        (np.asarray(lo, float), np.asarray(hi, float)) for lo, hi in FURNITURE
    ]
    for lo, hi in boxes:
        for a in range(3):
            for side, coord in ((0, lo[a]), (1, hi[a])):
                shade = (0.78, 1.0, 0.9)[a] * (1.0 if side else 0.94)
                faces.append((a, float(coord), lo, hi, shade))
    return faces


def _pack(faces):
    """Shelf-pack each face's (v, u) texel rectangle into the atlas.
    Returns per-face (row offset, col offset, rows, cols) and atlas height."""
    sizes = []
    for a, _, lo, hi, _ in faces:
        ua, va = [k for k in range(3) if k != a]
        cols = int(np.ceil((hi[ua] - lo[ua]) / TEXEL_M)) + 2
        rows = int(np.ceil((hi[va] - lo[va]) / TEXEL_M)) + 2
        sizes.append((rows, cols))
    order = sorted(range(len(faces)), key=lambda f: -sizes[f][0])
    place = [None] * len(faces)
    y = x = shelf = 0
    for f in order:
        rows, cols = sizes[f]
        if x + cols > ATLAS_W:
            y, x, shelf = y + shelf, 0, 0
        place[f] = (y, x, rows, cols)
        x += cols
        shelf = max(shelf, rows)
    return place, y + shelf


def _value_noise(rng, h: int, w: int, cell: int) -> np.ndarray:
    """Smooth random field with features `cell` texels across."""
    g = rng.random((h // cell + 2, w // cell + 2), dtype=np.float32)

    def axis(n):
        c = np.arange(n, dtype=np.float32) / cell
        i = c.astype(np.int32)
        f = c - i
        return i, f * f * (3.0 - 2.0 * f)

    iy, fy = axis(h)
    ix, fx = axis(w)
    rows = g[iy] * (1.0 - fy)[:, None] + g[iy + 1] * fy[:, None]
    return rows[:, ix] * (1.0 - fx) + rows[:, ix + 1] * fx


def _box3(t: np.ndarray) -> np.ndarray:
    p = np.pad(t, 1, mode="edge")
    h = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    return (h[:-2] + h[1:-1] + h[2:]) / 9.0


def _make_atlas(rng, h: int, w: int) -> np.ndarray:
    """Procedural texture: multi-scale value noise, then rectangles and
    disks with hard edges (Shi-Tomasi corners), lightly anti-aliased."""
    tex = np.zeros((h, w), np.float32)
    for cell, amp in ((512, 0.35), (128, 0.3), (32, 0.2), (8, 0.08)):
        tex += amp * _value_noise(rng, h, w, cell)
    n_rect = h * w // 450
    ys = rng.integers(0, h, n_rect)
    xs = rng.integers(0, w, n_rect)
    hs = rng.integers(6, 70, n_rect)
    ws = rng.integers(6, 70, n_rect)
    vals = rng.random(n_rect, dtype=np.float32) * 0.93
    for y, x, hh, ww, v in zip(ys, xs, hs, ws, vals):
        blk = tex[y : y + hh, x : x + ww]
        blk *= 0.25
        blk += 0.75 * v
    n_disk = h * w // 3000
    ys = rng.integers(0, h, n_disk)
    xs = rng.integers(0, w, n_disk)
    rs = rng.integers(4, 30, n_disk)
    vals = rng.random(n_disk, dtype=np.float32) * 0.93
    for y, x, r, v in zip(ys, xs, rs, vals):
        y0, y1, x0, x1 = max(y - r, 0), min(y + r + 1, h), max(x - r, 0), min(x + r + 1, w)
        yy, xx = np.ogrid[y0:y1, x0:x1]
        m = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
        tex[y0:y1, x0:x1][m] = v
    tex = _box3(_box3(tex))
    lo, hi = np.percentile(tex, [1, 99])
    return np.clip(0.12 + 0.76 * (tex - lo) / (hi - lo), 0.0, 1.0).astype(np.float32)


def trajectory(n_frames: int, seed: int = 0) -> np.ndarray:
    """(n_frames, 4, 4) cam->world poses of a smooth closed loop: an
    ellipse (0.75 x 0.5 m) around the room's centre at eye height, looking
    towards the sofa wall with +-50 deg of yaw, some pitch and roll.
    Camera axes: x right, y down, z forward."""
    rng = np.random.default_rng([seed, 1])
    th0 = np.pi / 2 + rng.uniform(-0.3, 0.3)
    yaw0 = np.radians(rng.uniform(-20.0, 20.0))
    th = 2.0 * np.pi * np.arange(n_frames) / LOOP_FRAMES
    C = np.stack(
        [
            0.75 * np.cos(th0 + th),
            -0.5 + 0.5 * np.sin(th0 + th),
            1.4 + 0.08 * np.sin(2.0 * th),
        ],
        -1,
    )
    yaw = yaw0 + np.radians(50.0) * np.sin(th)
    pitch = np.radians(-12.0 + 6.0 * np.sin(2.0 * th))
    roll = np.radians(2.0 * np.sin(3.0 * th))
    fwd = np.stack(
        [np.sin(yaw) * np.cos(pitch), np.cos(yaw) * np.cos(pitch), np.sin(pitch)], -1
    )
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    c, s = np.cos(roll)[:, None], np.sin(roll)[:, None]
    x_c = c * right + s * down
    y_c = -s * right + c * down
    T = np.tile(np.eye(4), (n_frames, 1, 1))
    T[:, :3, 0], T[:, :3, 1], T[:, :3, 2] = x_c, y_c, fwd
    T[:, :3, 3] = C
    return T


class _Scene:
    """Face geometry + texture atlas for one seed."""

    def __init__(self, seed: int):
        faces = _faces()
        place, atlas_h = _pack(faces)
        self.atlas = _make_atlas(np.random.default_rng([seed, 0]), atlas_h, ATLAS_W)
        n = len(faces)
        self.u_axis = np.empty(n, np.int64)
        self.v_axis = np.empty(n, np.int64)
        self.u0 = np.empty(n, np.float32)
        self.v0 = np.empty(n, np.float32)
        self.off = np.empty((n, 2), np.float32)  # (row, col) of texel (0, 0)
        self.lim = np.empty((n, 2), np.float32)  # last (row, col) for bilinear taps
        self.shade = np.empty(n, np.float32)
        for f, ((a, _, lo, hi, shade), (r0, c0, rows, cols)) in enumerate(
            zip(faces, place)
        ):
            ua, va = [k for k in range(3) if k != a]
            self.u_axis[f], self.v_axis[f] = ua, va
            self.u0[f], self.v0[f] = lo[ua], lo[va]
            self.off[f] = (r0 + 0.5, c0 + 0.5)
            self.lim[f] = (r0 + rows - 2, c0 + cols - 2)
            self.shade[f] = shade
        self.boxes = [
            (np.asarray(lo, float), np.asarray(hi, float)) for lo, hi in FURNITURE
        ]

    def render(self, T_wc: np.ndarray, rays_c: np.ndarray):
        """Cast the camera's rays (3, N) float32 (z = 1 in the camera frame,
        so the hit distance along a ray IS the depth). Returns (intensity
        (N,) float32 in [0, 1], depth (N,) float32 metres)."""
        C = T_wc[:3, 3].astype(np.float32)
        d = T_wc[:3, :3].astype(np.float32) @ rays_c  # (3, N) world directions
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            # Room: the exit plane along each axis (the camera is inside).
            ta = [
                np.where(d[k] > 0, (ROOM_HI[k] - C[k]) * inv[k],
                         (ROOM_LO[k] - C[k]) * inv[k])
                for k in range(3)
            ]
            ta = [np.where(x > 0, x, np.inf) for x in ta]
            a = np.where((ta[0] <= ta[1]) & (ta[0] <= ta[2]), 0,
                         np.where(ta[1] <= ta[2], 1, 2))
            t = np.minimum(ta[0], np.minimum(ta[1], ta[2]))
            face = 2 * a + (np.choose(a, d) > 0)
            # Furniture: slab test; the entry face is on the axis whose slab
            # is entered last.
            for b, (lo, hi) in enumerate(self.boxes):
                t1 = [(lo[k] - C[k]) * inv[k] for k in range(3)]
                t2 = [(hi[k] - C[k]) * inv[k] for k in range(3)]
                tn = [np.minimum(x, y) for x, y in zip(t1, t2)]
                t_far = np.minimum(
                    np.maximum(t1[0], t2[0]),
                    np.minimum(np.maximum(t1[1], t2[1]), np.maximum(t1[2], t2[2])),
                )
                ab = np.where((tn[0] >= tn[1]) & (tn[0] >= tn[2]), 0,
                              np.where(tn[1] >= tn[2], 1, 2))
                t_near = np.maximum(tn[0], np.maximum(tn[1], tn[2]))
                hit = (t_near <= t_far) & (t_near > 1e-6) & (t_near < t)
                side = np.choose(ab, d) < 0  # entered through the hi face
                t = np.where(hit, t_near, t)
                face = np.where(hit, 6 * (b + 1) + 2 * ab + side, face)
        P = C[:, None] + d * t
        pu = np.choose(self.u_axis[face], P) - self.u0[face]
        pv = np.choose(self.v_axis[face], P) - self.v0[face]
        row = np.clip(pv * (1 / TEXEL_M) + self.off[face, 0], 0, self.lim[face, 0])
        col = np.clip(pu * (1 / TEXEL_M) + self.off[face, 1], 0, self.lim[face, 1])
        r0 = row.astype(np.int64)
        c0 = col.astype(np.int64)
        fr = row - r0
        fc = col - c0
        flat = self.atlas.reshape(-1)
        k = r0 * ATLAS_W + c0
        top = flat[k] * (1 - fc) + flat[k + 1] * fc
        bot = flat[k + ATLAS_W] * (1 - fc) + flat[k + ATLAS_W + 1] * fc
        val = (top * (1 - fr) + bot * fr) * self.shade[face]
        return val, t


class SceneDataset:
    """A rendered seeded sequence with `ICLNUIMDataset`'s interface.

    Frames are rendered when the dataset is built (`n_frames` x (H, W)
    uint8 gray + uint16 depth in RAM)."""

    def __init__(
        self,
        n_frames: int,
        seed: int = 0,
        width: int = 640,
        height: int = 480,
    ):
        self.seed = seed
        self.intrinsics = intrinsics_for(width)
        self._poses = trajectory(n_frames, seed)
        fx, fy, cx, cy = self.intrinsics.astype(np.float64)
        v, u = np.mgrid[0:height, 0:width].astype(np.float64)
        rays = np.stack(
            [((u - cx) / fx).ravel(), ((v - cy) / fy).ravel(), np.ones(u.size)]
        ).astype(np.float32)
        scene = _Scene(seed)
        self._gray = np.empty((n_frames, height, width), np.uint8)
        self._depth = np.empty((n_frames, height, width), np.uint16)

        def render(i):
            val, depth = scene.render(self._poses[i], rays)
            noise = np.random.default_rng([seed, 2, i]).normal(
                0.0, NOISE_STD, val.shape
            ).astype(np.float32)
            self._gray[i] = np.clip(
                np.rint(val * 255.0 + noise), 0, 255
            ).reshape(height, width)
            self._depth[i] = np.clip(
                np.rint(depth * DEPTH_SCALE), 0, 65535
            ).reshape(height, width)

        # Frames are independent and NumPy releases the interpreter lock in
        # its array loops, so a few threads render in parallel; each frame
        # writes only its own slot.
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            for _ in ex.map(render, range(n_frames)):
                pass

    def __len__(self) -> int:
        return len(self._gray)

    def gray_u8(self, i: int) -> np.ndarray:
        """(H,W) uint8 grayscale as rendered."""
        return self._gray[i]

    def gray(self, i: int) -> np.ndarray:
        """(H,W) float32 grayscale in [0,1] (the same value the front-end
        computes on device from the uint8 frame)."""
        return self._gray[i].astype(np.float32) / np.float32(255.0)

    def rgb(self, i: int) -> np.ndarray:
        """(H,W,3) uint8 (the room is rendered in gray)."""
        return np.repeat(self._gray[i][..., None], 3, axis=-1)

    def depth_raw(self, i: int) -> np.ndarray:
        """(H,W) uint16 depth as ICL stores it (metres x 5000)."""
        return self._depth[i]

    def depth(self, i: int) -> np.ndarray:
        """(H,W) float32 metres; 0 = missing."""
        return self._depth[i].astype(np.float32) / DEPTH_SCALE

    def frames(
        self, start: int = 0, stop: int | None = None
    ) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        """Yield (idx, uint8 gray, float32 depth): the uint8 frame is what
        moves to the device (a quarter of float32's bytes)."""
        stop = stop if stop is not None else len(self)
        for i in range(start, stop):
            yield i, self._gray[i], self.depth(i)

    def ground_truth(self) -> np.ndarray:
        """(N, 4, 4) cam->world poses, indexed by frame."""
        return self._poses.copy()
