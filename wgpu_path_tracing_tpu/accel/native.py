"""ctypes bridge to the native C++ scene-prep kernels (accel/cbvh/).

The reference's host preprocessing is TypeScript; here the hot host paths
(SAH BVH over 100k+ triangle scenes, bvh_builder.cpp; glTF flattening,
flatten.cpp; atlas packing, potpack.cpp) have native implementations,
compiled lazily with g++ into one cached shared object. Falls back to the
NumPy code (accel/bvh.py, models/) when no toolchain is available; outputs
are bit-identical by construction (tests/test_cbvh.py,
tests/test_flatten_native.py and tests/test_potpack_native.py enforce it).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from wgpu_path_tracing_tpu.accel.bvh import BVH, build_bvh as build_bvh_numpy

_SRCS = [
    os.path.join(os.path.dirname(__file__), "cbvh", "bvh_builder.cpp"),
    os.path.join(os.path.dirname(__file__), "cbvh", "flatten.cpp"),
    os.path.join(os.path.dirname(__file__), "cbvh", "potpack.cpp"),
]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _compile_library() -> ctypes.CDLL | None:
    cache_dir = os.environ.get(
        "WPT_NATIVE_CACHE", os.path.join(tempfile.gettempdir(), "wpt_native")
    )
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "libwptbvh.so")
    if not (
        os.path.exists(so_path)
        and all(os.path.getmtime(so_path) >= os.path.getmtime(s) for s in _SRCS)
    ):
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-o", so_path + ".tmp", *_SRCS,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(so_path + ".tmp", so_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    try:
        _bind_symbols(lib)
    except AttributeError:
        # A cached .so that predates a newer entry point can survive the
        # mtime staleness check (mtime-preserving copies: rsync -a, tar,
        # docker layer reuse). Degrade to the Python fallbacks instead of
        # crashing every scene load on the missing symbol.
        return None
    return lib


def _bind_symbols(lib: ctypes.CDLL) -> None:
    lib.wpt_build_bvh.restype = ctypes.c_int64
    lib.wpt_build_bvh.argtypes = [
        _F32P, _F32P, _F32P,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        _F32P, _F32P, _I32P, _I64P,
    ]
    lib.wpt_flatten.restype = ctypes.c_int64
    lib.wpt_flatten.argtypes = [
        _F32P, _F32P, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), _I64P, ctypes.c_int64,
        ctypes.c_int32,
        _F32P, _F32P, _F32P, _F32P, _F32P, _F32P,
    ]
    lib.wpt_reorder_tris.restype = ctypes.c_int64
    lib.wpt_reorder_tris.argtypes = [
        _I64P, ctypes.c_int64,
        _F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _F32P,
        _I32P,
        _F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _F32P, _F32P,
        _I32P,
    ]
    lib.wpt_potpack.restype = ctypes.c_int64
    lib.wpt_potpack.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]


def native_available() -> bool:
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None:
            return True
        if _LIB_FAILED:
            return False
        _LIB = _compile_library()
        _LIB_FAILED = _LIB is None
        return not _LIB_FAILED


def build_bvh_native(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_leaf_size: int = 4,
    num_bins: int = 12,
) -> BVH:
    """Native build; raises RuntimeError if the library is unavailable."""
    if not native_available():
        raise RuntimeError("native BVH builder unavailable (g++ failed?)")
    num_tris = int(np.asarray(v0).shape[0])
    if num_tris == 0:
        return build_bvh_numpy(v0, v1, v2, max_leaf_size, num_bins)

    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    max_nodes = 2 * num_tris + 1
    aabb_min = np.empty((max_nodes, 3), np.float32)
    aabb_max = np.empty((max_nodes, 3), np.float32)
    meta = np.empty((max_nodes, 4), np.int32)
    order = np.empty((num_tris,), np.int64)

    fptr = ctypes.POINTER(ctypes.c_float)
    count = _LIB.wpt_build_bvh(
        v0.ctypes.data_as(fptr),
        v1.ctypes.data_as(fptr),
        v2.ctypes.data_as(fptr),
        num_tris,
        max_leaf_size,
        num_bins,
        aabb_min.ctypes.data_as(fptr),
        aabb_max.ctypes.data_as(fptr),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if count <= 0:
        raise RuntimeError(f"native BVH build failed (rc={count})")
    return BVH(
        aabb_min=aabb_min[:count].copy(),
        aabb_max=aabb_max[:count].copy(),
        meta=meta[:count].copy(),
        order=order,
    )


def build_bvh(v0, v1, v2, max_leaf_size: int = 4, num_bins: int = 12) -> BVH:
    """Best-available builder: native when it compiles, NumPy otherwise."""
    if np.asarray(v0).shape[0] >= 1 and native_available():
        return build_bvh_native(v0, v1, v2, max_leaf_size, num_bins)
    return build_bvh_numpy(v0, v1, v2, max_leaf_size, num_bins)


def potpack_native(wh: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Native atlas bin packer (accel/cbvh/potpack.cpp).

    wh: (n, 2) f64 box (w, h) dims in list order. Returns (xy (n, 2) f64,
    width, height) bit-identical to the Python packer
    (models/gltf.py::potpack_python, tests/test_potpack_native.py).
    Raises RuntimeError when the native library is unavailable.
    """
    if not native_available():
        raise RuntimeError("native potpack unavailable (g++ failed?)")
    wh = np.ascontiguousarray(wh, np.float64)
    n = int(wh.shape[0])
    xy = np.zeros((n, 2), np.float64)
    dims = np.zeros((2,), np.float64)
    dptr = ctypes.POINTER(ctypes.c_double)
    rc = _LIB.wpt_potpack(
        wh.ctypes.data_as(dptr), n,
        xy.ctypes.data_as(dptr), dims.ctypes.data_as(dptr),
    )
    if rc != 0:
        raise RuntimeError(f"native potpack failed (rc={rc})")
    return xy, float(dims[0]), float(dims[1])


def flatten_native(pos, nrm, world, normal_mat, idx):
    """Native transform + renormalize + corner gather (flatten.cpp).

    pos/nrm: (n_verts, 3) f32; world: (4, 4) f64; normal_mat: (4, 4) or
    (3, 3) f64 inverse-transpose; idx: (3k,) corner indices. Returns the
    six (k, 3) f32 corner arrays (v0, v1, v2, n0, n1, n2) — bit-identical
    to models/gltf.py's NumPy flatten block (tests/test_flatten_native.py).
    Raises RuntimeError when the native library is unavailable.
    """
    if not native_available():
        raise RuntimeError("native flattener unavailable (g++ failed?)")
    pos = np.ascontiguousarray(pos, np.float32)
    nrm = np.ascontiguousarray(nrm, np.float32)
    world = np.ascontiguousarray(world, np.float64)
    nmat = np.ascontiguousarray(np.asarray(normal_mat, np.float64)[0:3, 0:3])
    idx = np.ascontiguousarray(idx, np.int64)
    k = idx.shape[0] // 3
    n_verts = pos.shape[0]
    identity = int(np.array_equal(world, np.eye(4)))
    outs = [np.empty((k, 3), np.float32) for _ in range(6)]
    dptr = ctypes.POINTER(ctypes.c_double)
    rc = _LIB.wpt_flatten(
        pos.ctypes.data_as(_F32P),
        nrm.ctypes.data_as(_F32P),
        n_verts,
        world.ctypes.data_as(dptr),
        nmat.ctypes.data_as(dptr),
        idx.ctypes.data_as(_I64P),
        k,
        identity,
        *[o.ctypes.data_as(_F32P) for o in outs],
    )
    if rc != 0:
        raise RuntimeError(f"native flatten failed (rc={rc})")
    return tuple(outs)


def reorder_tris_native(order, v0, v1, v2, n0, n1, n2, u0, u1, u2, mat):
    """Fused BVH-order gather of the nine triangle columns (flatten.cpp).

    Pure permutation — bit-identical to the per-array NumPy fancy-index
    gathers in models/assemble.py::finalize_scene, one pass instead of
    nine. Raises RuntimeError when the native library is unavailable.
    """
    if not native_available():
        raise RuntimeError("native reorder unavailable (g++ failed?)")
    order = np.ascontiguousarray(order, np.int64)
    n = order.shape[0]
    ins3 = [np.ascontiguousarray(a, np.float32) for a in
            (v0, v1, v2, n0, n1, n2)]
    ins2 = [np.ascontiguousarray(a, np.float32) for a in (u0, u1, u2)]
    mi = np.ascontiguousarray(mat, np.int32)
    outs3 = [np.empty((n, 3), np.float32) for _ in range(6)]
    outs2 = [np.empty((n, 2), np.float32) for _ in range(3)]
    mo = np.empty((n,), np.int32)
    rc = _LIB.wpt_reorder_tris(
        order.ctypes.data_as(_I64P),
        n,
        *[a.ctypes.data_as(_F32P) for a in ins3],
        *[a.ctypes.data_as(_F32P) for a in ins2],
        mi.ctypes.data_as(_I32P),
        *[a.ctypes.data_as(_F32P) for a in outs3],
        *[a.ctypes.data_as(_F32P) for a in outs2],
        mo.ctypes.data_as(_I32P),
    )
    if rc != 0:
        raise RuntimeError(f"native reorder failed (rc={rc})")
    return (*outs3, *outs2, mo)
