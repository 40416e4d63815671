"""ctypes bridge to the native C++ host library (native/libm3t.so).

The reference's native tier is the whole Mitsuba/Dr.Jit C++ stack; here the
host-side native work is scene I/O and BVH building — see native/*.cpp.  The
Python fallbacks stay authoritative for correctness; the native paths are
drop-in accelerations.  `build()` compiles the library from native/*.cpp
(`make -C native`); run it once with

    python -m mitsuba3_experiments_tpu.scene.native

or let scene.flagship.load_flagship call it.  Without the library, the BVH
build falls back to the slower numpy object-split builder.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libm3t.so")

_LIB = None
_TRIED = False


def build() -> str:
    """Compile native/libm3t.so with `make -C native` (a no-op when it is
    up to date) and load it; returns the library's path.  Raises when the
    build fails or the library does not load."""
    global _TRIED
    with open(os.path.join(NATIVE_DIR, "Makefile")) as lock:
        # one builder at a time across processes (test workers)
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-s", "-C", NATIVE_DIR], check=True,
                       stdout=subprocess.DEVNULL)
    if _LIB is None:
        _TRIED = False
    if _find_lib() is None:
        raise RuntimeError(f"{LIB_PATH} was built but does not load")
    return LIB_PATH


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    P, i64, c_int = ctypes.POINTER, ctypes.c_int64, ctypes.c_int
    f32p, i32p, vpp = P(ctypes.c_float), P(ctypes.c_int32), P(ctypes.c_void_p)
    lib.m3t_load_obj.restype = c_int
    lib.m3t_load_obj.argtypes = [
        ctypes.c_char_p, vpp,
        P(i64), P(i64),      # n_verts, n_faces
        P(c_int), P(c_int),  # has_normals, has_uvs
    ]
    lib.m3t_copy_mesh.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, i32p]
    lib.m3t_free_mesh.argtypes = [ctypes.c_void_p]
    lib.m3t_build_sbvh.restype = c_int
    lib.m3t_build_sbvh.argtypes = [
        f32p, i64, i32p, i64, c_int, ctypes.c_float, ctypes.c_float,
        vpp, P(i64), P(i64),
    ]
    lib.m3t_copy_sbvh.argtypes = [ctypes.c_void_p, f32p, f32p] + [i32p] * 6
    lib.m3t_free_sbvh.argtypes = [ctypes.c_void_p]
    lib.m3t_build_bvh.restype = c_int
    lib.m3t_build_bvh.argtypes = [f32p, i64, i32p, i64, c_int, vpp, P(i64)]
    lib.m3t_copy_bvh.argtypes = [ctypes.c_void_p, f32p, f32p] + [i32p] * 6
    lib.m3t_free_bvh.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def try_build_bvh_native(vertices, faces, leaf_size: int):
    """Returns (lo, hi, left, right, first, count, prim_order, max_leaf)
    numpy arrays or None when the native lib is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    handle = ctypes.c_void_p()
    n_nodes = ctypes.c_int64()
    rc = lib.m3t_build_bvh(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(v.shape[0]),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(f.shape[0]),
        ctypes.c_int(leaf_size),
        ctypes.byref(handle), ctypes.byref(n_nodes),
    )
    if rc != 0:
        return None
    nn = n_nodes.value
    lo = np.empty((nn, 3), np.float32)
    hi = np.empty((nn, 3), np.float32)
    left = np.empty(nn, np.int32)
    right = np.empty(nn, np.int32)
    first = np.empty(nn, np.int32)
    count = np.empty(nn, np.int32)
    order = np.empty(f.shape[0], np.int32)
    max_leaf = ctypes.c_int32()
    lib.m3t_copy_bvh(
        handle,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        left.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        right.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(max_leaf),
    )
    lib.m3t_free_bvh(handle)
    return lo, hi, left, right, first, count, order, int(max_leaf.value)


def try_build_sbvh_native(vertices, faces, leaf_size: int,
                          alpha: float = 1e-5, budget_factor: float = 2.0):
    """Spatial-split (SBVH) binary build — native/sbvh_builder.cpp.

    Returns (lo, hi, left, right, first, count, prim_order, max_leaf) or
    None when unavailable.  prim_order holds REFERENCES (len >= n_faces,
    repeated face ids allowed): a straddling triangle is duplicated into
    both children with clipped boxes, cutting node overlap — fewer rows
    visited per ray in the traversal."""
    lib = _find_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    handle = ctypes.c_void_p()
    n_nodes = ctypes.c_int64()
    n_refs = ctypes.c_int64()
    rc = lib.m3t_build_sbvh(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(v.shape[0]),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(f.shape[0]),
        ctypes.c_int(leaf_size), ctypes.c_float(alpha),
        ctypes.c_float(budget_factor),
        ctypes.byref(handle), ctypes.byref(n_nodes), ctypes.byref(n_refs),
    )
    if rc != 0:
        return None
    nn = n_nodes.value
    lo = np.empty((nn, 3), np.float32)
    hi = np.empty((nn, 3), np.float32)
    left = np.empty(nn, np.int32)
    right = np.empty(nn, np.int32)
    first = np.empty(nn, np.int32)
    count = np.empty(nn, np.int32)
    order = np.empty(n_refs.value, np.int32)
    max_leaf = ctypes.c_int32()
    lib.m3t_copy_sbvh(
        handle,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        left.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        right.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(max_leaf),
    )
    lib.m3t_free_sbvh(handle)
    return lo, hi, left, right, first, count, order, int(max_leaf.value)


def try_load_obj_native(path: str):
    """Returns (v, n, uv, f) numpy arrays or None if native lib unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    handle = ctypes.c_void_p()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    has_n = ctypes.c_int()
    has_uv = ctypes.c_int()
    rc = lib.m3t_load_obj(
        path.encode(), ctypes.byref(handle), ctypes.byref(nv),
        ctypes.byref(nf), ctypes.byref(has_n), ctypes.byref(has_uv),
    )
    if rc != 0:
        return None
    v = np.empty((nv.value, 3), np.float32)
    n = np.empty((nv.value, 3), np.float32)
    uv = np.empty((nv.value, 2), np.float32)
    f = np.empty((nf.value, 3), np.int32)
    lib.m3t_copy_mesh(
        handle,
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    lib.m3t_free_mesh(handle)
    return (
        v,
        n if has_n.value else None,
        uv if has_uv.value else None,
        f,
    )


if __name__ == "__main__":
    print(build())
