"""Wavefront OBJ import (host, one-time).

Replaces the reference's Assimp-based model loader
(``src/Models/model_loader.cpp:16-431``): triangulating fan-wise, honoring
``vn`` normals when referenced and otherwise generating area-weighted
smooth vertex normals (the reference's aiProcessPreset_TargetRealtime_Quality
does the same smoothing).  Pure numpy; the C++ fast path lives in
``runtime/``.
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns (verts[T,3,3], normals[T,3,3]) float32 triangle soup.

    Uses the native C++ importer (runtime/csrc/prt_native.cpp) when
    available; set PRT_NO_NATIVE=1 to force this Python implementation.
    """
    from photorealistic_rendering_using_opencl_tpu.runtime import native
    res = native.load_obj_native(path)
    if res is not None:
        return res
    return load_obj_py(path)


def load_obj_py(path: str):
    """Pure-Python reference implementation of the OBJ importer."""
    positions: list[list[float]] = []
    vnormals: list[list[float]] = []
    faces: list[tuple] = []  # ((vi, ni), (vi, ni), (vi, ni))

    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vn "):
                parts = line.split()
                vnormals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                refs = line.split()[1:]
                idx = []
                for r in refs:
                    comps = r.split("/")
                    vi = int(comps[0])
                    ni = int(comps[2]) if len(comps) >= 3 and comps[2] else 0
                    idx.append((vi, ni))
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))

    pos = np.asarray(positions, np.float32)
    vn = np.asarray(vnormals, np.float32) if vnormals else None
    nv = len(pos)

    def _resolve(i, n):
        return (i - 1) if i > 0 else (n + i)

    tri_v = np.empty((len(faces), 3, 3), np.float32)
    tri_vi = np.empty((len(faces), 3), np.int64)
    tri_ni = np.empty((len(faces), 3), np.int64)
    for f, face in enumerate(faces):
        for c in range(3):
            vi, ni = face[c]
            vi = _resolve(vi, nv)
            tri_v[f, c] = pos[vi]
            tri_vi[f, c] = vi
            tri_ni[f, c] = _resolve(ni, len(vnormals)) if ni else -1

    if vn is not None and np.all(tri_ni >= 0):
        tri_n = vn[tri_ni]
    else:
        # area-weighted smooth normals over shared positions
        e1 = tri_v[:, 1] - tri_v[:, 0]
        e2 = tri_v[:, 2] - tri_v[:, 0]
        fn = np.cross(e1, e2)  # area-weighted face normal
        acc = np.zeros((nv, 3), np.float64)
        for c in range(3):
            np.add.at(acc, tri_vi[:, c], fn)
        norm = np.linalg.norm(acc, axis=1, keepdims=True)
        acc = acc / np.maximum(norm, 1e-20)
        tri_n = acc[tri_vi].astype(np.float32)

    # normalize normals defensively
    ln = np.linalg.norm(tri_n, axis=-1, keepdims=True)
    tri_n = (tri_n / np.maximum(ln, 1e-20)).astype(np.float32)
    return tri_v, tri_n


def make_icosphere(subdiv: int = 2, radius: float = 1.0,
                   center=(0.0, 0.0, 0.0)):
    """Procedural test mesh (keeps tests independent of external assets)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdiv):
        new_faces = []
        cache: dict = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(vlist)

    verts = np.asarray(verts, np.float32)
    ctr = np.asarray(center, np.float32)
    f = np.asarray(faces, np.int64)
    tri_v = verts[f] * radius + ctr
    tri_n = verts[f]  # unit sphere normal == position
    return tri_v.astype(np.float32), tri_n.astype(np.float32)



def torus_knot_mesh(p: int = 2, q: int = 3, segments: int = 158,
                    sides: int = 20, scale: float = 0.25,
                    tube: float = 0.15, center=(0.0, 0.6, 0.0)):
    """Procedural (p, q) torus knot tube as (positions, normals, faces).

    2 * segments * sides triangles.  The defaults give the flagship
    cornell mesh (6,320 triangles, the reference teapot's count): a
    non-convex, self-shadowing tube lying in the xz-plane above the box
    floor.  Normals are the analytic tube normals (vertex minus
    knot-curve point); faces wind counter-clockwise seen from outside.
    """
    phi = 2.0 * np.pi * np.arange(segments) / segments

    def curve(a):
        r = 2.0 + np.cos(q * a)
        # knot plane xy mapped to world xz; its out-of-plane wobble is y
        return np.stack([r * np.cos(p * a), -np.sin(q * a),
                         r * np.sin(p * a)], axis=-1) * scale

    c = curve(phi)
    tangent = curve(phi + 1e-4) - curve(phi - 1e-4)
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)
    # frame: the component of "up" orthogonal to the tangent, then binormal
    up = np.array([0.0, 1.0, 0.0])
    n1 = up - tangent * (tangent @ up)[:, None]
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 = np.cross(tangent, n1)
    theta = 2.0 * np.pi * np.arange(sides) / sides
    nrm = (np.cos(theta)[None, :, None] * n1[:, None, :]
           + np.sin(theta)[None, :, None] * n2[:, None, :])  # [S,V,3]
    pos = c[:, None, :] + tube * nrm + np.asarray(center)
    i = np.arange(segments)[:, None]
    j = np.arange(sides)[None, :]
    i1, j1 = (i + 1) % segments, (j + 1) % sides
    a, b = i * sides + j, i1 * sides + j
    cc, d = i1 * sides + j1, i * sides + j1
    faces = np.concatenate([np.stack([a, cc, b], -1).reshape(-1, 3),
                            np.stack([a, d, cc], -1).reshape(-1, 3)])
    return (pos.reshape(-1, 3).astype(np.float32),
            nrm.reshape(-1, 3).astype(np.float32), faces)


def make_torus_knot(**kw):
    """``torus_knot_mesh`` as a (verts[T,3,3], normals[T,3,3]) soup."""
    pos, nrm, faces = torus_knot_mesh(**kw)
    return pos[faces], nrm[faces]


def write_obj(path: str, pos, nrm, faces, comment: str = "") -> None:
    """Indexed mesh -> OBJ with ``v``/``vn`` pairs sharing one index."""
    with open(path, "w") as fh:
        if comment:
            fh.write(f"# {comment}\n")
        for x in np.asarray(pos):
            fh.write(f"v {x[0]:.6f} {x[1]:.6f} {x[2]:.6f}\n")
        for x in np.asarray(nrm):
            fh.write(f"vn {x[0]:.6f} {x[1]:.6f} {x[2]:.6f}\n")
        for f in np.asarray(faces) + 1:
            fh.write(f"f {f[0]}//{f[0]} {f[1]}//{f[1]} {f[2]}//{f[2]}\n")
