"""Scene intersection: analytic primitives, SDF raymarching, BVH meshes.

Wavefront re-design of ``kernels/intersect.cl`` + ``kernels/geometry/*``:
instead of one work-item walking primitive lists, the whole ray batch is
intersected against each primitive *class* with broadcasting ([rays x
objects] on the VPU), the SDF raymarcher is a masked ``lax.while_loop``
over the batch, and BVH traversal is a vectorized stackless walk over a
DFS-threaded node array (skip links) -- no per-lane stacks (the
divergence hazard called out in SURVEY §7).

Object ordering matches the reference SoA: [spheres | sdfs | boxes | quads]
(include/Scene/scene.h:262-469); the OBJ triangle mesh is a virtual object
with id == cfg.n_objects.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.ad_checkpoint
import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute
from photorealistic_rendering_using_opencl_tpu.ops.math import (
    EPS, RAY_INF, fetch_float_rows, normalize, select_rows,
)
from photorealistic_rendering_using_opencl_tpu.scene.types import (
    BOX, DIEL, QUAD, ROUGH_DIEL, SceneConfig, SceneData, SDF,
    SDF_BOX, SDF_CYLINDER, SDF_PLANE, SDF_ROUND_BOX, SDF_SPHERE, SDF_TORUS,
    SPHERE,
)


class Hit(NamedTuple):
    t: jnp.ndarray  # [N] distance (RAY_INF on miss)
    mesh_id: jnp.ndarray  # [N] int32; object index, cfg.n_objects for the OBJ
    pos: jnp.ndarray  # [N,3]
    normal: jnp.ndarray  # [N,3] (shading normal, backside-resolved)
    backside: jnp.ndarray  # [N] bool
    # winning triangle index in the active mesh backend's table space, -1
    # for analytic/miss.  Fed back as the NEXT dispatch's self-exclusion:
    # rounding in the den-multiplied t*den of a ray that starts ON its
    # triangle can exceed the EPS*den^2 self-intersection guard, so the
    # plane containing the origin is excluded by INDEX (exact for planar
    # triangles -- a ray can never legitimately re-hit the flat triangle
    # it leaves).
    tri: jnp.ndarray = None

    @property
    def valid(self):
        return self.t < RAY_INF


# ===========================================================================
# Analytic primitives (broadcast over [rays, objects])
# ===========================================================================

def sphere_hits(origin, direction, centers, radii):
    """[N,3] rays vs [S] spheres -> t[N,S] (inf on miss).

    Nearest-positive-root form of intersect_sphere (sphere.cl:5-27).
    """
    p = origin[:, None, :] - centers[None, :, :]  # [N,S,3]
    b = jnp.sum(p * direction[:, None, :], axis=-1)
    c = jnp.sum(p * p, axis=-1) - radii[None, :] ** 2
    det_sq = b * b - c
    # double-where: sqrt'(0) = inf would NaN the backward pass for misses
    miss = det_sq < EPS * EPS
    det = jnp.sqrt(jnp.where(miss, 1.0, det_sq))
    det = jnp.where(miss, 0.0, det)
    t0 = -b - det
    t1 = -b + det
    t = jnp.where(t0 > EPS, t0, jnp.where(t1 > EPS, t1, jnp.inf))
    return jnp.where(det_sq >= 0.0, t, jnp.inf)


def box_hits(origin, direction, centers, half_extents):
    """Slab test vs [B] boxes -> (t[N,B], normal[N,B,3], backside[N,B]).

    Matches intersect_box (box.cl:5-40) including the sign/step normal trick.
    NB the reference treats ``pos + joker`` / ``pos - joker`` as the two
    corners, i.e. joker = half extents about pos.
    """
    inv_d = 1.0 / jnp.where(jnp.abs(direction) < 1e-12,
                            jnp.copysign(1e-12, direction), direction)
    o = origin[:, None, :]
    idv = inv_d[:, None, :]
    tmin = (centers[None] + half_extents[None] - o) * idv
    tmax = (centers[None] - half_extents[None] - o) * idv
    real_min = jnp.minimum(tmin, tmax)  # [N,B,3]
    real_max = jnp.maximum(tmin, tmax)
    minmax = jnp.min(real_max, axis=-1)
    maxmin = jnp.max(real_min, axis=-1)
    outside = maxmin > 0.0
    hit = (minmax > maxmin) & ((outside & (maxmin > 0.0)) | (minmax > 0.0))
    t = jnp.where(outside, maxmin, minmax)
    # face normal: the axis achieving the entry (or exit, when inside) time
    plane = jnp.where(outside[..., None], real_min, real_max)
    # exact comparison like the reference's step() trick
    sel = jnp.where(outside[..., None],
                    plane == maxmin[..., None],
                    plane == minmax[..., None])
    normal = -jnp.sign(direction)[:, None, :] * sel.astype(jnp.float32)
    backside = ~outside
    t = jnp.where(hit & (t > EPS), t, jnp.inf)
    return t, normal, backside


def quad_hits(origin, direction, base, edge0, edge1, normal):
    """One-sided parallelogram intersect (quad.cl:11-38) -> t[N,Q].

    The stored ``base`` is the rect center of the reference's JSON
    ("vertices": center, edge0, edge1); the anchor corner is
    base - (edge0+edge1)/2 (quad.cl:17).
    """
    ndotw = jnp.sum(normal[None] * direction[:, None, :], axis=-1)  # [N,Q]
    anchor = base - (edge0 + edge1) * 0.5
    rt = jnp.sum(normal[None] * (anchor[None] - origin[:, None, :]), axis=-1) \
        / jnp.where(jnp.abs(ndotw) < 1e-12, 1e-12, ndotw)
    q = origin[:, None, :] + rt[..., None] * direction[:, None, :]
    v = q - anchor[None]
    l0 = jnp.sum(v * edge0[None], axis=-1) / jnp.maximum(
        jnp.sum(edge0 * edge0, axis=-1)[None], 1e-12)
    l1 = jnp.sum(v * edge1[None], axis=-1) / jnp.maximum(
        jnp.sum(edge1 * edge1, axis=-1)[None], 1e-12)
    ok = ((ndotw >= 1e-5) & (rt > EPS)
          & (l0 >= 0.0) & (l0 <= 1.0) & (l1 >= 0.0) & (l1 <= 1.0))
    return jnp.where(ok, rt, jnp.inf)


# ===========================================================================
# SDF raymarching (sdf.cl)
# ===========================================================================

def sd_primitive(geom_type, center_rel, params):
    """Signed distance of one SDF object; broadcast [..., objects].

    geom_type[S] carries the SDF subtype bits; params[S,4]; center_rel
    [..., S, 3] = p - position.
    """
    p = center_rel
    r = params[..., 0]
    b = params[..., :3]
    d_sphere = jnp.linalg.norm(p, axis=-1) - r
    q = jnp.abs(p) - b
    d_box = (jnp.minimum(jnp.max(q, axis=-1), 0.0)
             + jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1))
    d_round = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1) - params[..., 3]
    d_plane = jnp.sum(p * params[..., :3], axis=-1) + params[..., 3]
    # cylinder/torus: the reference's sdCylinder/sdTorus (sdf.cl:21-35),
    # dead there (no type bits), live here as JSON types 8/9
    len_xz = jnp.sqrt(jnp.maximum(p[..., 0] ** 2 + p[..., 2] ** 2, 1e-30))
    d_cyl = jnp.maximum(len_xz - params[..., 0],
                        jnp.abs(p[..., 1]) - params[..., 1])
    # torus params: (major radius, minor radius) in slots 0/1
    d_torus = jnp.sqrt(jnp.maximum(
        (len_xz - params[..., 0]) ** 2 + p[..., 1] ** 2, 1e-30)
    ) - params[..., 1]
    d = jnp.where((geom_type & SDF_SPHERE) != 0, d_sphere,
        jnp.where((geom_type & SDF_BOX) != 0, d_box,
        jnp.where((geom_type & SDF_ROUND_BOX) != 0, d_round,
        jnp.where((geom_type & SDF_PLANE) != 0, d_plane,
        jnp.where((geom_type & SDF_CYLINDER) != 0, d_cyl,
        jnp.where((geom_type & SDF_TORUS) != 0, d_torus, jnp.inf))))))
    return d


def sdf_map(pos, centers, geom_type, params):
    """min over SDF objects; pos [N,3] -> (dist[N], argmin[N])."""
    rel = pos[:, None, :] - centers[None]
    d = sd_primitive(geom_type[None], rel, params[None])  # [N,S]
    return jnp.min(d, axis=-1), jnp.argmin(d, axis=-1).astype(jnp.int32)


def sdf_march(origin, direction, t_limit, centers, geom_type, params,
              steps: int, active=None):
    """Sphere tracing (sdf.cl:103-118): returns (t[N], obj[N], hit[N]).

    Fully detached (while_loop); reattach derivatives with sdf_reattach.
    Masked-out lanes (active=False) are born done and cost no iterations.
    """
    origin, direction, t_limit, centers, params = jax.lax.stop_gradient(
        (origin, direction, t_limit, centers, params))

    def body(carry):
        i, t, done = carry
        pos = origin + direction * t[..., None]
        h, _ = sdf_map(pos, centers, geom_type, params)
        h = jnp.abs(h)
        new_done = done | (h < EPS) | (t > t_limit)
        t = jnp.where(new_done, t, t + h)
        return i + 1, t, new_done

    def cond(carry):
        i, _, done = carry
        return (i < steps) & ~jnp.all(done)

    t0 = jnp.full(origin.shape[:-1], EPS * 10.0, jnp.float32)
    done0 = jnp.zeros(origin.shape[:-1], bool)
    if active is not None:
        done0 = done0 | ~jax.lax.stop_gradient(active)
    _, t, _ = jax.lax.while_loop(cond, body, (jnp.array(0), t0, done0))
    hit = t <= t_limit
    pos = origin + direction * t[..., None]
    _, obj = sdf_map(pos, centers, geom_type, params)
    return t, obj, hit


def sdf_normal(pos, centers, geom_type, params, obj_idx):
    """Central differences on the selected object (sdf.cl:77-85)."""
    c = centers[obj_idx]
    gt = geom_type[obj_idx]
    pr = params[obj_idx]
    e = EPS * 2.0
    grads = []
    for axis in range(3):
        off = jnp.zeros((3,), jnp.float32).at[axis].set(e)
        dp = sd_primitive(gt, pos + off - c, pr)
        dm = sd_primitive(gt, pos - off - c, pr)
        grads.append(dp - dm)
    return normalize(jnp.stack(grads, axis=-1))


# ===========================================================================
# BVH traversal: stackless skip-link walk + Moller-Trumbore
# ===========================================================================

LEAF_SIZE = 4  # build-time max primitives per leaf (scene/bvh_build.py)


def _tri_intersect(p0, p1, p2, origin, direction, t_best):
    """Reference triangle test (triangle.cl:4-43) -> (hit, t, u, w)."""
    e1 = p0 - p1
    e2 = p2 - p0
    n = jnp.cross(e1, e2)
    c = p0 - origin
    r = jnp.cross(direction, c)
    den = jnp.sum(n * direction, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(den) < 1e-20,
                              jnp.copysign(1e-20, den), den)
    u = jnp.sum(r * e2, axis=-1) * inv_det
    v = jnp.sum(r * e1, axis=-1) * inv_det
    w = 1.0 - u - v
    t = jnp.sum(n * c, axis=-1) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (w >= 0.0) & (t > EPS) & (t < t_best)
    return hit, t, u, v


# lanes per while_loop.  Chunking bounds the worst-lane tail, but each
# chunk is a sequential loop of small launches: on the H100 a 524,288-ray
# dispatch took 212 ms in 8,192-lane chunks and 33 ms in one (PERF.md)
TRAVERSE_CHUNK = 1 << 20


def bvh_traverse(scene: SceneData, origin, direction, t_init,
                 any_hit=False, active=None):
    """Closest-hit over the threaded BVH, chunked over the ray batch.

    ``any_hit`` may be a python bool or a per-lane [N] array (mixed
    shadow/closest batches).  The while_loop runs until the WORST lane
    finishes; traversal depth is heavy-tailed, so splitting a megapixel
    batch into TRAVERSE_CHUNK-lane chunks (sequential ``lax.map``) pays
    sum(chunk maxima) instead of batch_size x global maximum.
    """
    n = origin.shape[0]
    if not isinstance(any_hit, bool):
        any_hit = jnp.broadcast_to(jnp.asarray(any_hit, bool), (n,))
    if n > TRAVERSE_CHUNK:
        pad = (-n) % TRAVERSE_CHUNK
        def pad0(x, fill=0):
            return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                           constant_values=fill)
        o = pad0(origin).reshape(-1, TRAVERSE_CHUNK, 3)
        d = pad0(direction, 1.0).reshape(-1, TRAVERSE_CHUNK, 3)
        ti = pad0(jnp.broadcast_to(t_init, (n,))).reshape(-1, TRAVERSE_CHUNK)
        act = active if active is not None else jnp.ones((n,), bool)
        act = pad0(act).reshape(-1, TRAVERSE_CHUNK)
        if isinstance(any_hit, bool):
            def one(args):
                o, d, ti, a = args
                return _bvh_traverse_chunk(scene, o, d, ti, any_hit, a)
            t, tri, u, v = jax.lax.map(one, (o, d, ti, act))
        else:
            ah = pad0(any_hit).reshape(-1, TRAVERSE_CHUNK)
            def one(args):
                o, d, ti, a, h = args
                return _bvh_traverse_chunk(scene, o, d, ti, h, a)
            t, tri, u, v = jax.lax.map(one, (o, d, ti, act, ah))
        return (t.reshape(-1)[:n], tri.reshape(-1)[:n],
                u.reshape(-1)[:n], v.reshape(-1)[:n])
    return _bvh_traverse_chunk(scene, origin, direction, t_init, any_hit,
                               active)


def _bvh_traverse_chunk(scene: SceneData, origin, direction, t_init,
                        any_hit: bool = False, active=None,
                        count_steps: bool = False):
    """Closest-hit over the threaded BVH.

    Returns (t[N], tri[N] (-1 = none), u[N], v[N]).  The walk replaces the
    reference's 64-deep per-thread stack (bvh.cl:131-206) with a skip-link
    (``miss``) threading: hit+inner -> node+1, else -> miss[node].  Every
    ray in the batch advances one node per iteration of a single
    ``lax.while_loop`` -- uniform control flow, VPU-wide.

    All inputs are detached (``lax.while_loop`` has no transpose rule); the
    caller reattaches derivatives by recomputing the hit against the
    selected triangle (``tri_reattach``), the standard detached-traversal
    VJP of SURVEY §7 stage 9.
    """
    origin = jax.lax.stop_gradient(origin)
    direction = jax.lax.stop_gradient(direction)
    t_init = jax.lax.stop_gradient(t_init)
    scene = jax.lax.stop_gradient(scene)
    n_nodes = scene.bvh_nodes.shape[0]
    nray = origin.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(direction) < 1e-12,
                            jnp.copysign(1e-12, direction), direction)
    # per-ray direction octant selects the near-first threading table
    oct_ = ((direction[:, 0] < 0).astype(jnp.int32)
            | ((direction[:, 1] < 0).astype(jnp.int32) << 1)
            | ((direction[:, 2] < 0).astype(jnp.int32) << 2))
    link_base = oct_ * n_nodes

    # One flat loop: every iteration fetches the 32B node row + 8B octant
    # links and (speculatively) the 144B leaf row.  A two-level
    # "while-while" variant that defers leaf fetches stalls lockstep lanes
    # through the inner walk, so the flat form stays.
    def cond(carry):
        node, t, tri, u, v = carry[:5]
        return jnp.any(node < n_nodes)

    def body(carry):
        node, t, tri, u, v = carry[:5]
        nid = jnp.minimum(node, n_nodes - 1)
        row = scene.bvh_nodes[nid]  # ONE [N,8] gather for the whole step
        meta = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
        links = scene.bvh_links[link_base + nid]  # [N,2] octant threading
        t_lo = (row[:, 0:3] - origin) * inv_d
        t_hi = (row[:, 3:6] - origin) * inv_d
        entry = jnp.maximum(jnp.max(jnp.minimum(t_lo, t_hi), axis=-1), EPS)
        exit_ = jnp.minimum(jnp.min(jnp.maximum(t_lo, t_hi), axis=-1), t)
        active = node < n_nodes
        box_hit = active & (entry <= exit_)

        count = meta & 7
        leaf_idx = meta >> 3
        is_leaf = count > 0
        # ONE gather brings back the whole padded leaf (4 tris x 9 floats)
        leaf = scene.leaf_verts[leaf_idx].reshape(nray, LEAF_SIZE, 3, 3)
        for k in range(LEAF_SIZE):
            tv = leaf[:, k]
            h, tk, uk, vk = _tri_intersect(tv[:, 0], tv[:, 1], tv[:, 2],
                                           origin, direction, t)
            take = box_hit & is_leaf & (k < count) & h
            t = jnp.where(take, tk, t)
            tri = jnp.where(take, leaf_idx * LEAF_SIZE + k, tri)
            u = jnp.where(take, uk, u)
            v = jnp.where(take, vk, v)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, links[:, 0], links[:, 1])
        if isinstance(any_hit, bool):
            if any_hit:
                # shadow variant (bvh.cl traverseShadows): a lane parks at
                # the end sentinel as soon as any occluder is found
                nxt = jnp.where(tri >= 0, n_nodes, nxt)
        else:
            # per-lane any-hit flag (mixed shadow/closest batch)
            nxt = jnp.where(any_hit & (tri >= 0), n_nodes, nxt)
        node = jnp.where(active, nxt, node)
        if count_steps:
            return node, t, tri, u, v, carry[5] + active.astype(jnp.int32)
        return node, t, tri, u, v

    # masked-out lanes park at the sentinel immediately: the while_loop
    # trip count then follows the worst ACTIVE lane, not the worst lane
    # (dead paths / non-NEE shadow rays cost zero iterations)
    start = jnp.zeros((nray,), jnp.int32)
    if active is not None:
        start = jnp.where(jax.lax.stop_gradient(active), start, n_nodes)
    carry0 = (
        start,
        jnp.asarray(jnp.broadcast_to(t_init, (nray,)), jnp.float32),
        jnp.full((nray,), -1, jnp.int32),
        jnp.zeros((nray,), jnp.float32),
        jnp.zeros((nray,), jnp.float32),
    )
    if count_steps:
        carry0 = carry0 + (jnp.zeros((nray,), jnp.int32),)
        node, t, tri, u, v, steps = jax.lax.while_loop(cond, body, carry0)
        return t, tri, u, v, steps
    node, t, tri, u, v = jax.lax.while_loop(cond, body, carry0)
    return t, tri, u, v


def tri_reattach(tri_verts, tri, origin, direction):
    """Differentiable (t, u, v) for an already-selected triangle.

    The traversal above runs fully detached; given its chosen primitive
    index, the Moller-Trumbore quantities are recomputed here so gradients
    flow from the hit into ray origin/direction and the mesh vertices --
    first-order exact at the solution.  ``tri_verts`` is whichever table
    matches the index space of ``tri`` (leaf-major for the BVH walk,
    compact bf_tri_verts for the brute-force kernel).
    """
    # gather from the FLAT [T,9] view: a [N,9] row gather keeps the
    # native T(8,128) layout, where a [N,3,3] gather forces a T(4,128)
    # layout plus a whole-array relayout copy (~3 ms/bounce at 262k lanes,
    # tools/trace_bounce.py fusion.359/363 + copy.602/605)
    tv = tri_verts.reshape(-1, 9)[jnp.maximum(tri, 0)]  # [N,9]
    p0, p1, p2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
    e1 = p0 - p1
    e2 = p2 - p0
    n = jnp.cross(e1, e2)
    c = p0 - origin
    r = jnp.cross(direction, c)
    den = jnp.sum(n * direction, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(den) < 1e-20,
                              jnp.copysign(1e-20, den), den)
    u = jnp.sum(r * e2, axis=-1) * inv_det
    v = jnp.sum(r * e1, axis=-1) * inv_det
    t = jnp.sum(n * c, axis=-1) * inv_det
    return t, u, v


def sdf_reattach(origin, direction, t_det, centers, geom_type, params,
                 obj_idx):
    """Differentiable sphere-tracing distance by one-step Newton.

    With f(t) = sdf(o + t*d) and the detached root t_det, the implicit
    function theorem gives dt = -df / <grad f, d>; evaluating
    t_det - f(o + t_det*d) / stop(<grad f, d>) reproduces t_det in the
    primal (f ~ 0 at the root) and carries the exact first-order
    derivative w.r.t. ray and SDF parameters.
    """
    c = centers[obj_idx]
    gt = geom_type[obj_idx]
    pr = params[obj_idx]
    pos = origin + direction * t_det[..., None]
    f = sd_primitive(gt, pos - c, pr)
    g = sdf_normal(pos, centers, geom_type, params, obj_idx)
    dfdt = jax.lax.stop_gradient(jnp.sum(g * direction, axis=-1))
    dfdt = jnp.where(jnp.abs(dfdt) < 1e-4, jnp.copysign(1e-4, dfdt), dfdt)
    return t_det - f / dfdt


def _surface_f(cfg, gt, p, c, prm, qb, qe0, qe1, qn):
    """Signed surface function F(p, params) of the winning analytic
    object: zero on the surface, smooth in p and in every table row.
    Per-lane dispatch on the (detached) geometry-type bits; absent
    primitive classes compile out (SceneConfig gating)."""
    rel = p - c
    out = jnp.zeros(p.shape[:-1], jnp.float32)
    if cfg.n_sdfs:
        out = jnp.where((gt & SDF) != 0, sd_primitive(gt, rel, prm), out)
    if cfg.n_quads:
        anchor = qb - (qe0 + qe1) * 0.5
        out = jnp.where((gt & QUAD) != 0,
                        jnp.sum(qn * (p - anchor), axis=-1), out)
    if cfg.n_boxes:
        out = jnp.where((gt & BOX) != 0,
                        jnp.max(jnp.abs(rel) - prm[:, 0:3], axis=-1), out)
    if cfg.n_spheres:
        out = jnp.where((gt & SPHERE) != 0,
                        jnp.sum(rel * rel, axis=-1)
                        - prm[:, 0] * prm[:, 0], out)
    return out


def analytic_reattach(cfg: SceneConfig, scene: SceneData, origin, direction,
                      t_det, mesh_id, normal_det):
    """Winner-only differentiable (t, normal) for analytic hits.

    ``_closest_analytic`` runs fully detached (see its docstring); this
    reattaches first-order-exact derivatives through the SELECTED object
    only, the same pattern as ``tri_reattach``/``sdf_reattach``: with
    F(o + t*d, params) = 0 defining the hit implicitly, the correction

        t = t_det - (F - stop(F)) / stop(dF/dt)

    is BITWISE t_det in the primal (F - stop(F) == 0 exactly) while its
    gradient is the implicit-function-theorem derivative w.r.t. ray
    origin/direction and the object tables.  The winner's parameter rows
    arrive through ONE packed ``fetch_float_rows`` gather whose transpose
    is a single one-hot matmul (ops/math.py), so the backward cost is
    winner-only elementwise math instead of the full [rays x objects]
    primitive sweep.  Normals get the same zero-in-primal correction.
    """
    if cfg.n_objects == 0:
        return t_det, normal_det
    k = scene.position.shape[0]
    analytic = (mesh_id >= 0) & (mesh_id < cfg.n_objects)
    idx = jnp.clip(mesh_id, 0, k - 1)
    rows = jnp.concatenate(
        [scene.position, scene.params, scene.quad_base, scene.quad_edge0,
         scene.quad_edge1, scene.quad_normal], axis=1)  # [K,19]
    g = fetch_float_rows(rows, idx)
    c, prm = g[:, 0:3], g[:, 3:7]
    qb, qe0, qe1, qn = g[:, 7:10], g[:, 10:13], g[:, 13:16], g[:, 16:19]
    gt = select_rows(jax.lax.stop_gradient(scene.geom_type), idx)

    t_sg = jax.lax.stop_gradient(t_det)
    p = origin + direction * t_sg[..., None]
    f = _surface_f(cfg, gt, p, c, prm, qb, qe0, qe1, qn)

    # dF/dt via a detached JVP in the ray direction (grazing-guarded)
    o_sg, d_sg = jax.lax.stop_gradient((origin, direction))
    args_sg = jax.lax.stop_gradient((c, prm, qb, qe0, qe1, qn))
    _, dfdt = jax.jvp(
        lambda pp: _surface_f(cfg, gt, pp, *args_sg),
        (o_sg + d_sg * t_sg[..., None],), (d_sg,))
    dfdt = jnp.where(jnp.abs(dfdt) < 1e-6, jnp.copysign(1e-6, dfdt), dfdt)

    t_re = t_det - jnp.where(analytic, f - jax.lax.stop_gradient(f), 0.0) \
        / dfdt

    # normal: differentiable recomputation per type, folded in as a
    # zero-in-primal correction (box face normals are piecewise constant
    # in both ray and params -- detached is exact a.e.)
    n_dif = jax.lax.stop_gradient(normal_det)
    if cfg.n_sdfs:
        e = EPS * 2.0
        grads = []
        for axis in range(3):
            off = jnp.zeros((3,), jnp.float32).at[axis].set(e)
            grads.append(sd_primitive(gt, p + off - c, prm)
                         - sd_primitive(gt, p - off - c, prm))
        n_sdf = normalize(jnp.stack(grads, axis=-1))
        n_dif = jnp.where((gt & SDF)[..., None] != 0, n_sdf, n_dif)
    if cfg.n_quads:
        n_dif = jnp.where((gt & QUAD)[..., None] != 0, qn, n_dif)
    if cfg.n_spheres:
        n_dif = jnp.where((gt & SPHERE)[..., None] != 0,
                          normalize(p - c), n_dif)
    # detached winners may have been sign-flipped against the ray after
    # the raw geometric normal was computed: match the stored primal's
    # SIGN so the correction stays zero-in-primal per component
    sign = jnp.sign(jnp.sum(n_dif * jax.lax.stop_gradient(normal_det),
                            axis=-1, keepdims=True))
    n_dif = n_dif * jnp.where(sign == 0.0, 1.0, sign)
    n_re = normal_det + jnp.where(
        analytic[..., None], n_dif - jax.lax.stop_gradient(n_dif), 0.0)
    return t_re, n_re


def bvh_smooth_normal(tri_normals, tri, u, v):
    """Barycentric vertex-normal interpolation (triangle.cl:29-37).

    Flat [N,9] gather for the same layout reason as tri_reattach.
    """
    tn = tri_normals.reshape(-1, 9)[jnp.maximum(tri, 0)]  # [N,9]
    w = 1.0 - u - v
    n = (w[..., None] * tn[:, 0:3] + u[..., None] * tn[:, 3:6]
         + v[..., None] * tn[:, 6:9])
    return n


# ===========================================================================
# Scene-level closest hit + shadow (intersect.cl:94-236)
# ===========================================================================

OBJ_MESH_ID_OFFSET = 0  # mesh id == cfg.n_objects


def mesh_closest(cfg: SceneConfig, scene: SceneData, origin, direction,
                 t_init, any_hit: bool = False, active=None,
                 exclude_tri=None):
    """Dispatch mesh intersection to the configured backend.

    Returns (t_detached [N], tri [N], tri_verts, tri_normals) where the
    tables match ``tri``'s index space; tri == -1 where nothing beats
    ``t_init``.  ``exclude_tri`` ([N] int32, -1 = none) removes one
    triangle per lane from consideration -- the self-exclusion feedback
    for rays originating on a mesh surface (see Hit.tri).  The BVH walk
    needs no exclusion (its t tests run in exact f32).
    """
    # the winning-index output is named for the bounce scan's remat
    # policy: downstream gathers index with THIS tensor (not the saved
    # post-processed Hit.tri), so leaving it unnamed makes the backward
    # recompute RE-RUN the whole mesh search + the [2N,9] validate gather
    # every iteration
    name = jax.ad_checkpoint.checkpoint_name
    if cfg.mesh_accel in ("brute", "reference"):
        reference = cfg.mesh_accel == "reference"
        perm = None
        if not reference and mesh_brute.uses_kernel():
            # block-coherence sort for the GPU kernel: block-coherent rays
            # let more blocks skip a cluster (measured on the H100,
            # PERF.md: forward frame 2.26 -> 1.16 s on cornell, 3.47 ->
            # 2.84 s on cornell_hi).  key = direction octant | quantized
            # origin cell.  All inputs are permuted, outputs unpermuted --
            # exactly result-invariant since cluster relevance is
            # conservative per lane.
            sg = jax.lax.stop_gradient
            o_sg, d_sg = sg(origin), sg(direction)
            cl = sg(scene.bf_clusters)
            lo = jnp.min(cl[:, 0:3], axis=0)
            hi = jnp.max(jnp.where(cl[:, 3:6] > -1e37, cl[:, 3:6],
                                   lo[None]), axis=0)
            cell = jnp.clip(((o_sg - lo) / jnp.maximum(hi - lo, 1e-6)
                             * 31.0).astype(jnp.int32), 0, 31)
            octant = ((d_sg[:, 0] < 0).astype(jnp.int32)
                      | ((d_sg[:, 1] < 0).astype(jnp.int32) << 1)
                      | ((d_sg[:, 2] < 0).astype(jnp.int32) << 2))
            key = ((octant << 15) | (cell[:, 0] << 10)
                   | (cell[:, 1] << 5) | cell[:, 2])
            perm = jnp.argsort(key)
            inv_perm = jnp.argsort(perm)
            origin_k, direction_k = origin[perm], direction[perm]
            t_init_k = jnp.broadcast_to(t_init, key.shape)[perm]
            active_k = None if active is None else active[perm]
            any_hit_k = (any_hit if isinstance(any_hit, bool)
                         else any_hit[perm])
            exclude_k = None if exclude_tri is None else exclude_tri[perm]
        else:
            origin_k, direction_k, t_init_k = origin, direction, t_init
            active_k, any_hit_k, exclude_k = active, any_hit, exclude_tri

        tm, tri_raw = mesh_brute.mesh_intersect(
            scene.bf_feat, scene.bf_clusters, origin_k, direction_k,
            t_init_k, active=active_k, any_hit=any_hit_k,
            exclude=exclude_k, reference=reference)
        if perm is not None:
            tm, tri_raw = tm[inv_perm], tri_raw[inv_perm]
        tri = _validate_winner(scene.bf_tri_verts, tri_raw, origin,
                               direction, t_init)
        return tm, name(tri, "hit"), scene.bf_tri_verts, scene.bf_tri_normals
    tm, tri, _, _ = bvh_traverse(scene, origin, direction, t_init,
                                 any_hit=any_hit, active=active)
    return tm, name(tri, "hit"), scene.tri_verts, scene.tri_normals


def _validate_winner(tri_verts, tri, origin, direction, t_init):
    """Exact f32 re-test of the brute search's winning triangle.

    The den-multiplied edge tests lose ~den^2 of precision, so GRAZING
    rays (den -> 0, i.e. mesh silhouettes) could report false hits under
    a lower-precision search.  One exact Moller-Trumbore on the single
    winning triangle per lane rejects those; a rejected winner falls back
    to the analytic hit, which is also what an exact search returns in
    the overwhelmingly common case (the false hit shadows nothing).  Both
    routes search in f32, so in practice this rarely rejects.
    """
    tv = tri_verts.reshape(-1, 9)[jnp.maximum(tri, 0)]
    ok, _, _, _ = _tri_intersect(tv[:, 0:3], tv[:, 3:6], tv[:, 6:9],
                                 origin, direction,
                                 jnp.broadcast_to(t_init, tri.shape)
                                 * (1.0 + 1e-5))
    return jnp.where(ok, tri, -1)


def traversal_cost(cfg: SceneConfig, scene: SceneData, origin, direction):
    """Per-ray traversal work estimate for the debug AOV (the reference's
    VIEW_STACK_INDEX heatmap, kernels/main.cl:6-13,144-147).

    brute backend: number of cluster tiles the ray's frustum makes relevant;
    bvh backend: node-visit count of the skip-link walk.
    """
    n = origin.shape[0]
    t_init = jnp.full((n,), RAY_INF, jnp.float32)
    if not cfg.has_mesh:
        return jnp.zeros((n,), jnp.int32)
    if cfg.mesh_accel in ("brute", "reference"):
        return mesh_brute.ray_cluster_count(scene.bf_clusters, origin,
                                            direction, t_init)
    _, _, _, _, steps = _bvh_traverse_chunk(scene, origin, direction,
                                            t_init, count_steps=True)
    return steps


def _closest_analytic(cfg: SceneConfig, scene: SceneData, origin, direction,
                      active=None):
    """Closest hit over the analytic primitive classes only -- DETACHED.

    Returns (t, mesh_id, normal), all detached; the caller reattaches
    first-order-exact derivatives for the winning object only via
    ``analytic_reattach`` (the same detached-selection + winner-reattach
    pattern as the mesh backends).  Differentiating the [rays x objects]
    broadcast intersects directly makes the backward recompute + transpose
    the whole primitive sweep every iteration.  The mesh backend runs
    separately so the
    integrator can merge its (expensive) custom call across ray batches.
    """
    origin = jax.lax.stop_gradient(origin)
    direction = jax.lax.stop_gradient(direction)
    scene = jax.lax.stop_gradient(scene)
    n = origin.shape[0]
    t = jnp.full((n,), RAY_INF, jnp.float32)
    mesh_id = jnp.full((n,), -1, jnp.int32)
    normal = jnp.zeros((n, 3), jnp.float32)

    s0, s1 = 0, cfg.n_spheres
    d0, d1 = s1, s1 + cfg.n_sdfs
    b0, b1 = d1, d1 + cfg.n_boxes
    q0, q1 = b1, b1 + cfg.n_quads

    # Analytic primitives run FIRST: they are cheap broadcasts and the
    # tightened ``t`` lets the mesh backend prune (cluster skipping in the
    # GPU kernel, box-exit clamping in the BVH walk).  Result is order-
    # independent: every section keeps the strictly closer hit.
    if cfg.n_spheres:
        ts = sphere_hits(origin, direction,
                         scene.position[s0:s1], scene.params[s0:s1, 0])
        best = jnp.min(ts, axis=-1)
        arg = jnp.argmin(ts, axis=-1).astype(jnp.int32)
        better = best < t
        t = jnp.where(better, best, t)
        mesh_id = jnp.where(better, s0 + arg, mesh_id)
        pos = origin + direction * t[..., None]
        ns = normalize(pos - scene.position[s0 + jnp.maximum(arg, 0)])
        normal = jnp.where(better[..., None], ns, normal)

    if cfg.n_sdfs:
        tsdf, obj, hit_s = sdf_march(origin, direction, t,
                                     scene.position[d0:d1],
                                     scene.geom_type[d0:d1],
                                     scene.params[d0:d1],
                                     cfg.marching_steps, active=active)
        better = hit_s & (tsdf < t)
        t = jnp.where(better, tsdf, t)
        mesh_id = jnp.where(better, d0 + obj, mesh_id)
        pos = origin + direction * t[..., None]
        nsdf = sdf_normal(pos, scene.position[d0:d1], scene.geom_type[d0:d1],
                          scene.params[d0:d1], obj)
        normal = jnp.where(better[..., None], nsdf, normal)

    if cfg.n_boxes:
        tb, nb, _bs = box_hits(origin, direction,
                               scene.position[b0:b1], scene.params[b0:b1, :3])
        best = jnp.min(tb, axis=-1)
        arg = jnp.argmin(tb, axis=-1)
        better = best < t
        t = jnp.where(better, best, t)
        mesh_id = jnp.where(better, b0 + arg.astype(jnp.int32), mesh_id)
        nsel = jnp.take_along_axis(nb, arg[:, None, None], axis=1)[:, 0]
        normal = jnp.where(better[..., None], nsel, normal)

    if cfg.n_quads:
        tq = quad_hits(origin, direction, scene.quad_base[q0:q1],
                       scene.quad_edge0[q0:q1], scene.quad_edge1[q0:q1],
                       scene.quad_normal[q0:q1])
        best = jnp.min(tq, axis=-1)
        arg = jnp.argmin(tq, axis=-1).astype(jnp.int32)
        better = best < t
        t = jnp.where(better, best, t)
        mesh_id = jnp.where(better, q0 + arg, mesh_id)
        nq = scene.quad_normal[q0 + jnp.maximum(arg, 0)]
        normal = jnp.where(better[..., None], nq, normal)

    # name the detached winners for the bounce scan's remat policy: the
    # backward then reads them as saved residuals instead of re-running
    # the whole primitive sweep (incl. the SDF while_loop) per iteration
    name = jax.ad_checkpoint.checkpoint_name
    return name(t, "hit"), name(mesh_id, "hit"), name(normal, "hit")


def _finish_hit(cfg: SceneConfig, scene: SceneData, origin, direction,
                t, mesh_id, normal, tri=None, tvs=None, tns=None) -> Hit:
    """Fold the mesh backend's result into the analytic closest hit and
    resolve the shading normal (intersect.cl:222-233)."""
    # analytic winners: detached selection, winner-only reattach (bitwise
    # primal; first-order-exact gradients)
    t, normal = analytic_reattach(cfg, scene, origin, direction, t,
                                  mesh_id, normal)
    if tri is not None:
        hit_m = tri >= 0
        if not cfg.mesh_vertex_grads:
            # keep ray-origin/direction gradients (camera, upstream
            # materials) but detach the vertex/normal TABLES: their
            # gather's transpose is a per-bounce [N,9] scatter-add into
            # the [T,9] tables (see SceneConfig.mesh_vertex_grads)
            tvs = jax.lax.stop_gradient(tvs)
            tns = jax.lax.stop_gradient(tns)
        # reattach gradients through the selected triangle (detached walk)
        tm, u, v = tri_reattach(tvs, tri, origin, direction)
        nm = normalize(bvh_smooth_normal(tns, tri, u, v))
        t = jnp.where(hit_m, tm, t)
        mesh_id = jnp.where(hit_m, cfg.n_objects, mesh_id)
        normal = jnp.where(hit_m[..., None], nm, normal)

    pos = origin + direction * t[..., None]

    # backside resolve (intersect.cl:222-233): flip the normal against the
    # ray unless the material is purely transmissive dielectric.
    mat_t = material_type_of(cfg, scene, mesh_id)
    n_trans = (mat_t & ~(DIEL | ROUGH_DIEL)) != 0
    backside = jnp.sum(normal * direction, axis=-1) > 0.0
    flip = n_trans & backside
    normal = jnp.where(flip[..., None], -normal, normal)
    tri_out = (jnp.full(t.shape, -1, jnp.int32) if tri is None
               else jnp.where(tri >= 0, tri, -1))
    return Hit(t, mesh_id, pos, normal, backside, tri_out)


def intersect_scene(cfg: SceneConfig, scene: SceneData, origin, direction,
                    active=None, exclude_tri=None) -> Hit:
    t, mesh_id, normal = _closest_analytic(cfg, scene, origin, direction,
                                           active=active)
    tri = tvs = tns = None
    if cfg.has_mesh:
        _, tri, tvs, tns = mesh_closest(cfg, scene, origin, direction, t,
                                        active=active,
                                        exclude_tri=exclude_tri)
    return _finish_hit(cfg, scene, origin, direction, t, mesh_id, normal,
                       tri, tvs, tns)


def material_type_of(cfg: SceneConfig, scene: SceneData, mesh_id):
    idx = jnp.clip(mesh_id, 0, scene.mat_type.shape[0] - 1)
    t = scene.mat_type[idx]
    if cfg.has_mesh:
        t = jnp.where(mesh_id == cfg.n_objects, scene.obj_mat_type, t)
    return jnp.where(mesh_id < 0, 0, t)


def _shadow_analytic(cfg: SceneConfig, scene: SceneData, origin, direction,
                     max_dist, active=None):
    """Analytic-primitive occlusion tests -> (blocked [N] bool, limit [N]).

    The mesh backend runs separately so the integrator can merge its
    (expensive) custom call across ray batches.
    """
    n = origin.shape[0]
    limit = max_dist * (1.0 - 1e-3)
    blocked = jnp.zeros((n,), bool)

    s0, s1 = 0, cfg.n_spheres
    d0, d1 = s1, s1 + cfg.n_sdfs
    b0, b1 = d1, d1 + cfg.n_boxes
    q0, q1 = b1, b1 + cfg.n_quads

    if cfg.n_spheres:
        ts = jnp.min(sphere_hits(origin, direction, scene.position[s0:s1],
                                 scene.params[s0:s1, 0]), axis=-1)
        blocked = blocked | (ts < limit)
    if cfg.n_sdfs:
        _, _, hit_s = sdf_march(origin, direction, limit,
                                scene.position[d0:d1], scene.geom_type[d0:d1],
                                scene.params[d0:d1],
                                cfg.shadow_marching_steps, active=active)
        blocked = blocked | hit_s
    if cfg.n_boxes:
        tb, _, _ = box_hits(origin, direction, scene.position[b0:b1],
                            scene.params[b0:b1, :3])
        blocked = blocked | (jnp.min(tb, axis=-1) < limit)
    if cfg.n_quads:
        tq = jnp.min(quad_hits(origin, direction, scene.quad_base[q0:q1],
                               scene.quad_edge0[q0:q1],
                               scene.quad_edge1[q0:q1],
                               scene.quad_normal[q0:q1]), axis=-1)
        blocked = blocked | (tq < limit)
    return blocked, limit


def shadow_visible(cfg: SceneConfig, scene: SceneData, origin, direction,
                   max_dist, active=None, exclude_tri=None) -> jnp.ndarray:
    """True where the segment [origin, origin + dir*max_dist] is unoccluded.

    Mirrors shadow() (intersect.cl:94-152): SDFs use the cheaper shadow
    march budget; everything else reuses the closest-hit tests with an
    early distance cap.
    """
    n = origin.shape[0]
    blocked, limit = _shadow_analytic(cfg, scene, origin, direction,
                                      max_dist, active=active)
    if cfg.has_mesh:
        # mesh goes LAST: lanes already occluded by a cheap analytic test
        # drop out of the (expensive) mesh backend via the active mask
        act = active if active is not None else jnp.ones((n,), bool)
        _, tri, _, _ = mesh_closest(cfg, scene, origin, direction, limit,
                                    any_hit=True, active=act & ~blocked,
                                    exclude_tri=exclude_tri)
        blocked = blocked | (tri >= 0)
    return ~blocked


def intersect_and_shadow(cfg: SceneConfig, scene: SceneData,
                         origin, direction, active, shadow_batches,
                         exclude_tri=None):
    """Closest hit for one ray batch + occlusion for K shadow batches with
    the mesh backend invoked ONCE on the concatenated (K+1)N-ray batch.

    The reference launches one traversal per ray kind per bounce
    (kernels/integrators/base.cl:31-192 calls intersectScene then shadow);
    here every mesh dispatch is a custom call (the GPU kernel) that
    fragments the surrounding XLA fusion graph and pays a fixed launch
    cost, so the integrator batches the NEE shadow rays with the next
    bounce's closest-hit rays into a single mixed dispatch (per-lane
    any-hit flag).

    ``shadow_batches``: list of (origin, direction, max_dist, active).
    ``exclude_tri`` may be one [N] row (same exclusion for every segment --
    valid when closest and shadow rays share their origin vertex) or a
    list of K+1 rows ([closest] + one per shadow batch) for drivers where
    the segments originate at different vertices (the regeneration loop:
    a regenerated lane's camera ray excludes nothing while its terminal-
    vertex NEE shadow ray still excludes the triangle it sits on).
    Returns (Hit for the closest batch, [visible bool arrays]).
    """
    n = origin.shape[0]
    act_c = active if active is not None else jnp.ones((n,), bool)
    t, mesh_id, normal = _closest_analytic(cfg, scene, origin, direction,
                                           active=act_c)
    blocked, limits, acts = [], [], []
    for (o_s, d_s, dist_s, a_s) in shadow_batches:
        b, lim = _shadow_analytic(cfg, scene, o_s, d_s, dist_s, active=a_s)
        a_s = a_s if a_s is not None else jnp.ones((o_s.shape[0],), bool)
        blocked.append(b)
        limits.append(lim)
        acts.append(a_s)

    tri = tvs = tns = None
    if cfg.has_mesh:
        o_all = jnp.concatenate([origin] + [b[0] for b in shadow_batches])
        d_all = jnp.concatenate([direction] + [b[1] for b in shadow_batches])
        t_all = jnp.concatenate([t] + limits)
        ah_all = jnp.concatenate(
            [jnp.zeros((n,), bool)]
            + [jnp.ones((b.shape[0],), bool) for b in blocked])
        act_all = jnp.concatenate(
            [act_c] + [a & ~b for a, b in zip(acts, blocked)])
        if exclude_tri is None:
            ex_all = None
        elif isinstance(exclude_tri, (list, tuple)):
            assert len(exclude_tri) == len(shadow_batches) + 1
            ex_all = jnp.concatenate(list(exclude_tri))
        else:
            # one vertex per lane: the same exclusion row covers all K+1
            # segments (trace's software-pipelined step)
            ex_all = jnp.tile(exclude_tri, len(shadow_batches) + 1)
        _, tri_all, tvs, tns = mesh_closest(cfg, scene, o_all, d_all, t_all,
                                            any_hit=ah_all, active=act_all,
                                            exclude_tri=ex_all)
        tri = tri_all[:n]
        off = n
        for i, b in enumerate(blocked):
            m = b.shape[0]
            blocked[i] = b | (tri_all[off:off + m] >= 0)
            off += m

    hit = _finish_hit(cfg, scene, origin, direction, t, mesh_id, normal,
                      tri, tvs, tns)
    return hit, [~b for b in blocked]
