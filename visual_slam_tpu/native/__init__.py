"""ctypes bindings for the native (C++) components.

The reference delegates all performance-critical host work to C++ through
bindings (OpenCV/g2o/Pangolin — SURVEY.md §2.2); this package does the same
for the parts that remain host-side: asynchronous PNG decode/prefetch.
The shared library is not version-controlled: `_load()` builds it from
dataloader.cpp on first use (`sh visual_slam_tpu/native/build.sh`), and
callers fall back to PIL if that fails.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libvslam_native.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # Build when the library is absent OR stale (older than any .cpp source):
    # the binary is intentionally not version-controlled, so it is always a
    # product of the checked-in sources on this machine.
    src_dir = os.path.dirname(__file__)
    srcs = [
        os.path.join(src_dir, f) for f in os.listdir(src_dir) if f.endswith(".cpp")
    ]
    stale = not os.path.exists(_LIB_PATH) or any(
        os.path.getmtime(s) > os.path.getmtime(_LIB_PATH) for s in srcs
    )
    if stale:
        try:
            subprocess.run(
                ["sh", os.path.join(src_dir, "build.sh")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,  # expected height — decoded frames of any other size
        ctypes.c_int,  # expected width    are reported as failures
    ]
    lib.dl_get.restype = ctypes.c_int
    lib.dl_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint16),
    ]
    lib.dl_get_gray.restype = ctypes.c_int
    lib.dl_get_gray.argtypes = list(lib.dl_get.argtypes)
    lib.dl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class AsyncFrameLoader:
    """Prefetching RGB(-D) frame loader over the native thread pool.

    Usage:
        loader = AsyncFrameLoader(rgb_paths, depth_paths)
        rgb, depth = loader.get(i)    # blocks only if not yet prefetched
        loader.close()
    """

    def __init__(
        self,
        rgb_paths: list[str],
        depth_paths: list[str] | None = None,
        height: int = 480,
        width: int = 640,
        n_threads: int = 3,
        lookahead: int = 24,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native dataloader not available (build failed?)")
        self._lib = lib
        self.height, self.width = height, width
        self.n = len(rgb_paths)
        self._has_depth = depth_paths is not None
        rgb_arr = (ctypes.c_char_p * self.n)(*[p.encode() for p in rgb_paths])
        if depth_paths is not None:
            dep_arr = (ctypes.c_char_p * self.n)(*[p.encode() for p in depth_paths])
        else:
            dep_arr = (ctypes.c_char_p * self.n)(*([b""] * self.n))
        self._handle = lib.dl_open(
            rgb_arr, dep_arr, self.n, n_threads, lookahead, height, width
        )
        if not self._handle:
            raise RuntimeError("dl_open failed")

    def get(self, idx: int):
        """Returns (rgb uint8 (H,W,3), depth float32 metres (H,W) or None)."""
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        depth_raw = np.empty((self.height, self.width), np.uint16)
        rc = self._lib.dl_get(
            self._handle,
            idx,
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth_raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )
        if rc != 0:
            raise IOError(f"native decode failed for frame {idx}")
        depth = depth_raw.astype(np.float32) / 5000.0 if self._has_depth else None
        return rgb, depth

    def get_gray(self, idx: int):
        """Returns (gray uint8 (H,W), depth float32 metres (H,W) or None) —
        grayscale conversion happens in native code (1/3 the H2D bytes)."""
        gray = np.empty((self.height, self.width), np.uint8)
        depth_raw = np.empty((self.height, self.width), np.uint16)
        rc = self._lib.dl_get_gray(
            self._handle,
            idx,
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth_raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )
        if rc != 0:
            raise IOError(f"native decode failed for frame {idx}")
        depth = depth_raw.astype(np.float32) / 5000.0 if self._has_depth else None
        return gray, depth

    def close(self):
        if self._handle:
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
