"""ctypes binding for the native C++ binned-SAH builder / corrected-rtk
oracle (native/rtk_oracle.cpp).

Compiled on demand with g++ (cached in native/build/).  Two roles:
  * production: the host-side SAH topology source for builder/sah.py —
    the static-scene build option (the reference's builder is host-side
    SAH too, rtk.c:867-1019; ours feeds pack_binary_tree instead of a
    blob linearizer);
  * testing: a third independent implementation of the trace semantics
    and the CPU baseline for benchmark comparisons.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "rtk_oracle.cpp"
_BUILD = _ROOT / "native" / "build"
_SO = _BUILD / "librtk_oracle.so"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-msse4.1", "-shared", "-fPIC",
             str(_SRC), "-o", str(_SO)],
            check=True,
        )
    lib = ctypes.CDLL(str(_SO))
    lib.rtko_build.restype = ctypes.c_void_p
    lib.rtko_build.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.rtko_trace.restype = None
    lib.rtko_trace.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rtko_free.restype = None
    lib.rtko_free.argtypes = [ctypes.c_void_p]
    lib.rtko_build2.restype = ctypes.c_void_p
    lib.rtko_build2.argtypes = [ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64, ctypes.c_int]
    lib.rtko_build3.restype = ctypes.c_void_p
    lib.rtko_build3.argtypes = [ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.rtko_build4.restype = ctypes.c_void_p
    lib.rtko_build4.argtypes = [ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64, ctypes.c_int]
    lib.rtko_trace4.restype = None
    lib.rtko_trace4.argtypes = lib.rtko_trace.argtypes
    lib.rtko_free4.restype = None
    lib.rtko_free4.argtypes = [ctypes.c_void_p]
    lib.rtko_node_count.restype = ctypes.c_int64
    lib.rtko_node_count.argtypes = [ctypes.c_void_p]
    lib.rtko_export.restype = None
    lib.rtko_export.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


class NativeOracle:
    """Corrected-rtk CPU oracle: build once, trace ray batches."""

    def __init__(self, tri_pos: np.ndarray, leaf_max: int | None = None,
                 step_quant: bool = False):
        """step_quant: weight the SAH by leaf STEPS (ceil(count/leaf_max))
        instead of triangle count — the packet kernel tests leaves in
        fixed leaf_size-row tiles, so this is its real cost unit.  Drives
        children toward full-K leaves (fewer leaf pops, shallower trees);
        hit results are identical either way (topology only)."""
        lib = _load()
        tris = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
        self._n = tris.shape[0]
        fp = tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if leaf_max is None:
            self._handle = lib.rtko_build(fp, ctypes.c_int64(self._n))
        elif step_quant:
            self._handle = lib.rtko_build3(
                fp, ctypes.c_int64(self._n), ctypes.c_int(int(leaf_max)),
                ctypes.c_int(int(leaf_max)))
        else:
            self._handle = lib.rtko_build2(
                fp, ctypes.c_int64(self._n), ctypes.c_int(int(leaf_max)))
        self._lib = lib

    def export_tree(self):
        """-> (left, right, first, count, box_lo, box_hi, order, root):
        the host-SAH binary topology, for pack_binary_tree (the SAH build
        option and topology-quality experiments)."""
        nn = int(self._lib.rtko_node_count(self._handle))
        left = np.empty(nn, np.int32)
        right = np.empty(nn, np.int32)
        first = np.empty(nn, np.int32)
        count = np.empty(nn, np.int32)
        box_lo = np.empty((nn, 3), np.float32)
        box_hi = np.empty((nn, 3), np.float32)
        order = np.empty(self._n, np.int32)
        root = np.empty(1, np.int32)
        ip = ctypes.POINTER(ctypes.c_int32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.rtko_export(
            self._handle, left.ctypes.data_as(ip), right.ctypes.data_as(ip),
            first.ctypes.data_as(ip), count.ctypes.data_as(ip),
            box_lo.ctypes.data_as(fp), box_hi.ctypes.data_as(fp),
            order.ctypes.data_as(ip), root.ctypes.data_as(ip))
        return left, right, first, count, box_lo, box_hi, order, int(root[0])

    def trace(self, origin, direction, min_t, max_t, mode="closest"):
        """-> (t, u, v, tri_index) numpy arrays; index -1 on miss."""
        n = len(origin)
        rays = np.empty((n, 8), np.float32)
        rays[:, 0:3] = origin
        rays[:, 3:6] = direction
        rays[:, 6] = min_t
        rays[:, 7] = max_t
        rays = np.ascontiguousarray(rays)
        t = np.empty(n, np.float32)
        u = np.empty(n, np.float32)
        v = np.empty(n, np.float32)
        idx = np.empty(n, np.int32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.rtko_trace(
            self._handle, rays.ctypes.data_as(fp), ctypes.c_int64(n),
            0 if mode == "closest" else 1,
            t.ctypes.data_as(fp), u.ctypes.data_as(fp), v.ctypes.data_as(fp),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return t, u, v, idx

    def __del__(self):
        try:
            self._lib.rtko_free(self._handle)
        except Exception:
            pass


class NativeOracleSSE:
    """Clean-room SSE BVH4 CPU tracer (r5): the honest reference-CPU
    baseline — the reference's own kernel is a 4-wide SSE BVH4
    (rtk.c:181-539), so CPU-vs-device ratios must be quoted against this,
    not the scalar BVH2 stand-in above."""

    def __init__(self, tri_pos: np.ndarray, leaf_max: int = 4):
        lib = _load()
        tris = np.ascontiguousarray(tri_pos, np.float32).reshape(-1, 9)
        self._n = tris.shape[0]
        fp = tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._handle = lib.rtko_build4(fp, ctypes.c_int64(self._n),
                                       ctypes.c_int(int(leaf_max)))
        self._lib = lib

    def trace(self, origin, direction, min_t, max_t, mode="closest"):
        """-> (t, u, v, tri_index) numpy arrays; index -1 on miss."""
        n = len(origin)
        rays = np.empty((n, 8), np.float32)
        rays[:, 0:3] = origin
        rays[:, 3:6] = direction
        rays[:, 6] = min_t
        rays[:, 7] = max_t
        rays = np.ascontiguousarray(rays)
        t = np.empty(n, np.float32)
        u = np.empty(n, np.float32)
        v = np.empty(n, np.float32)
        idx = np.empty(n, np.int32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.rtko_trace4(
            self._handle, rays.ctypes.data_as(fp), ctypes.c_int64(n),
            0 if mode == "closest" else 1,
            t.ctypes.data_as(fp), u.ctypes.data_as(fp), v.ctypes.data_as(fp),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return t, u, v, idx

    def __del__(self):
        try:
            self._lib.rtko_free4(self._handle)
        except Exception:
            pass
