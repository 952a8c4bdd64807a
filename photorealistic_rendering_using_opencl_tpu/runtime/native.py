"""ctypes bindings for the native (C++) host runtime.

The compute path is JAX/XLA/Pallas on the accelerator; this module is the *host* side
-- one-time scene setup that the reference also does in native code (BVH
build ``src/BVH/bvh.cpp``, model import ``src/Models/model_loader.cpp``).
The shared library is compiled lazily from ``csrc/prt_native.cpp`` with the
system g++ and cached next to the source; set ``PRT_NO_NATIVE=1`` to force
the pure-Python fallbacks in scene/bvh_build.py and scene/obj.py.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_CSRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_SRC = os.path.join(_CSRC_DIR, "prt_native.cpp")
_SO = os.path.join(_CSRC_DIR, "libprt_native.so")

_lock = threading.Lock()
_lib = None
_lib_tried = False


def _build_library() -> str | None:
    """Compile the shared library if missing or stale; None on failure."""
    try:
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return _SO
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-o", _SO + ".tmp", _SRC]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(_SO + ".tmp", _SO)
        return _SO
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_tried
    if os.environ.get("PRT_NO_NATIVE"):
        return None
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = _build_library()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        c_ll = ctypes.c_longlong
        c_vp = ctypes.c_void_p
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

        lib.prt_bvh_build.argtypes = [f32p, c_ll]
        lib.prt_bvh_build.restype = c_vp
        lib.prt_bvh_n_nodes.argtypes = [c_vp]
        lib.prt_bvh_n_nodes.restype = c_ll
        lib.prt_bvh_export.argtypes = [c_vp, f32p, f32p, i32p, i32p, i32p,
                                       i64p]
        lib.prt_bvh_free.argtypes = [c_vp]
        lib.prt_obj_load.argtypes = [ctypes.c_char_p]
        lib.prt_obj_load.restype = c_vp
        lib.prt_obj_n_tris.argtypes = [c_vp]
        lib.prt_obj_n_tris.restype = c_ll
        lib.prt_obj_export.argtypes = [c_vp, f32p, f32p]
        lib.prt_obj_free.argtypes = [c_vp]
        lib.prt_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def build_bvh_native(tri_verts: np.ndarray):
    """Native sweep-SAH build; returns the scene/bvh_build.FlatBVH fields as
    a tuple (bounds_min, bounds_max, miss, first_prim, prim_count, order)
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tri_verts, np.float32)
    t = tv.shape[0]
    handle = lib.prt_bvh_build(tv.reshape(-1, 9), t)
    if not handle:
        raise RuntimeError(lib.prt_last_error().decode())
    try:
        m = lib.prt_bvh_n_nodes(handle)
        bmin = np.empty((m, 3), np.float32)
        bmax = np.empty((m, 3), np.float32)
        miss = np.empty((m,), np.int32)
        first = np.empty((m,), np.int32)
        count = np.empty((m,), np.int32)
        order = np.empty((t,), np.int64)
        lib.prt_bvh_export(handle, bmin, bmax, miss, first, count, order)
    finally:
        lib.prt_bvh_free(handle)
    return bmin, bmax, miss, first, count, order


def load_obj_native(path: str):
    """Native OBJ import; (verts[T,3,3], normals[T,3,3]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.prt_obj_load(path.encode())
    if not handle:
        raise FileNotFoundError(lib.prt_last_error().decode())
    try:
        t = lib.prt_obj_n_tris(handle)
        verts = np.empty((t, 3, 3), np.float32)
        normals = np.empty((t, 3, 3), np.float32)
        lib.prt_obj_export(handle, verts.reshape(-1, 9),
                           normals.reshape(-1, 9))
    finally:
        lib.prt_obj_free(handle)
    return verts, normals
