"""Brute-force mesh intersection: relevance-pruned exhaustive Moller-Trumbore.

The skip-link BVH walk (ops/intersect.py:bvh_traverse) is correct but
gather-bound: every traversal step pays ~184 random bytes per lane and
lanes diverge in trip count.  This module takes the opposite design for
small and medium meshes: test EVERY (ray, triangle) pair of the tiles a
ray can reach, with no gathers and no divergence.

Math.  With the reference's triangle test (kernels/geometry/triangle.cl:
4-43): e1 = p0-p1, e2 = p2-p0, n = e1 x e2, c = p0 - o, den = n.d,
t*den = n.c, u*den = (d x c).e2, v*den = (d x c).e1.  Expanding
d x c = d x p0 - d x o and using the triple-product identity
(d x p0).e = d.(p0 x e), all four quantities are LINEAR in the 10-vector
ray feature  f = [o, d, d x o, 1]:

    den    = <f, [0,       n,       0,    0     ]>
    t*den  = <f, [-n,      0,       0,    n.p0  ]>
    u*den  = <f, [0,       p0 x e2, -e2,  0     ]>
    v*den  = <f, [0,       p0 x e1, -e1,  0     ]>

followed by a cheap elementwise hit test in den-multiplied form (no
divisions until the winning t).  All coefficient vectors are pre-scaled
by 1/|n| on the host so den is in [-1,1].

Triangles are kept in BVH leaf order (spatially sorted) and grouped into
tiles of TILE triangles; each tile's AABB ("cluster") lets a block of rays
skip whole tiles that none of its rays can hit closer than its current
best -- the coherence win of a BVH at tile granularity.

Two routes compute the same answer:

  * ``_intersect_xla`` -- the plain reference: a scan over tiles, one f32
    ``[rays, 16] x [16, 4*TILE]`` dot per tile at ``Precision.HIGHEST``
    (never TF32), no pruning.  It runs on the CPU and anywhere else.
  * ``_intersect_triton`` -- the GPU kernel (Pallas through Triton).  Each
    program owns BLOCK_RAYS rays, walks the cluster list, tests each
    cluster's AABB against its rays' current best t in-kernel, and for a
    relevant cluster evaluates the coefficient form in f32 on the CUDA
    cores, STEP_TRIS triangles at a time, min-reducing every
    ``[rays, triangles]`` score tile in registers.  No score matrix ever
    reaches device memory.

The hit test is exhaustive, so results equal the BVH walk's closest hit
(modulo exact-tie ordering).  Traversal stays detached; gradients reattach
through the selected triangle (ops/intersect.py:tri_reattach).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from photorealistic_rendering_using_opencl_tpu.ops.math import EPS

TILE = 128  # triangles per cluster tile (the pruning granularity)
FEAT = 16  # ray feature width (10 used, padded)

# GPU kernel shape: BLOCK_RAYS x STEP_TRIS f32 score tiles live in the
# registers of NUM_WARPS warps.  Swept on the H100 (PERF.md): small ray
# blocks prune best -- per 524,288-ray dispatch on cornell, 8x32 on one
# warp took 3.10 ms, 16x32 on 2 warps 4.11 ms, 64x32 on 4 warps 7.15 ms.
BLOCK_RAYS = 8
STEP_TRIS = 32
NUM_WARPS = 1

# largest mesh the GPU tests exhaustively; the skip-link walk takes over
# past it (scene/loader.py:_pick_mesh_accel).  Measured on the H100: the
# kernel beats the walk end to end at 81,920 triangles; larger meshes are
# not measured yet (PERF.md)
GPU_BRUTE_MAX_TRIS = 131072

# rows of the GPU kernel's ray pack ([RAY_ROWS, N] f32, one ray per column)
RAY_ROWS = 16
ROW_TINIT = 9
ROW_ACTIVE = 10
ROW_ANYHIT = 11


class BrutePack(NamedTuple):
    """Host-packed device tables (all jnp arrays once loaded)."""
    feat: np.ndarray  # [FEAT, 4*Tpad] coefficient table, tile-grouped cols
    clusters: np.ndarray  # [NT, 8] per-tile AABB: bmin(3) bmax(3) pad(2)
    tri_verts: np.ndarray  # [Tpad,3,3] vertices, same (compact) order
    tri_normals: np.ndarray  # [Tpad,3,3] vertex normals, same order


def pack_brute(tri_verts: np.ndarray, tri_normals: np.ndarray,
               tile: int = TILE) -> BrutePack:
    """Precompute the coefficient table from spatially-sorted triangles.

    ``tri_verts`` must already be in BVH order (scene/bvh_build.py
    ``order``) so consecutive tiles are spatially compact; the cluster
    AABBs then stay tight and tile skipping is effective.
    Padding slots get all-zero coefficients: den = t*den = 0 fails the
    strict t*den > EPS*den^2 test, so they can never register a hit.
    """
    t = tri_verts.shape[0]
    tpad = max(-(-t // tile) * tile, tile)
    v = np.zeros((tpad, 3, 3), np.float32)
    v[:t] = tri_verts
    nrm = np.zeros((tpad, 3, 3), np.float32)
    nrm[:t] = tri_normals

    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = p0 - p1
    e2 = p2 - p0
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    degen = nlen[:, 0] < 1e-20
    s = np.where(degen[:, None], 0.0, 1.0 / np.maximum(nlen, 1e-30))

    coef = np.zeros((4, tpad, FEAT), np.float32)
    # den = n.d
    coef[0, :, 3:6] = n * s
    # t*den = -n.o + n.p0
    coef[1, :, 0:3] = -n * s
    coef[1, :, 9] = np.sum(n * p0, axis=-1) * s[:, 0]
    # u*den = d.(p0 x e2) - (d x o).e2
    coef[2, :, 3:6] = np.cross(p0, e2) * s
    coef[2, :, 6:9] = -e2 * s
    # v*den = d.(p0 x e1) - (d x o).e1
    coef[3, :, 3:6] = np.cross(p0, e1) * s
    coef[3, :, 6:9] = -e1 * s

    # column layout per tile j: [den(C) | tden(C) | uden(C) | vden(C)]
    nt = tpad // tile
    feat = (coef.reshape(4, nt, tile, FEAT)
            .transpose(1, 0, 2, 3)  # [nt, 4, tile, FEAT]
            .reshape(nt * 4 * tile, FEAT)
            .T.copy())  # [FEAT, 4*tpad]

    clusters = np.zeros((nt, 8), np.float32)
    vt = v.reshape(nt, tile, 3, 3)
    live = ~degen.reshape(nt, tile)
    big = np.float32(3e38)
    lo = np.where(live[..., None, None], vt, big).min(axis=(1, 2))
    hi = np.where(live[..., None, None], vt, -big).max(axis=(1, 2))
    empty = ~live.any(axis=1)
    clusters[:, 0:3] = np.where(empty[:, None], big, lo)
    clusters[:, 3:6] = np.where(empty[:, None], -big, hi)
    return BrutePack(feat, clusters, v, nrm)


# ---------------------------------------------------------------------------
# Plain reference (CPU route; the comparison baseline on every device)
# ---------------------------------------------------------------------------

def _tile_scores(f, a_tile, c):
    """f [B,FEAT] x a_tile [FEAT,4C] -> per-pair t (inf when no hit).

    Den-multiplied Moller-Trumbore: u,v,w >= 0 and t > EPS become sign
    tests on products with den, avoiding per-pair division; the division
    producing t only matters for pairs that already pass.  The dot asks
    for HIGHEST precision: a float32 product may otherwise run in TF32 on
    a GPU, whose ~10 mantissa bits flip edge hits wholesale (the u*den,
    v*den terms cancel two O(|p0||e|) products down to a ~1e-3 signal).
    """
    out = jnp.dot(f, a_tile, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    den = out[:, 0 * c:1 * c]
    tden = out[:, 1 * c:2 * c]
    uden = out[:, 2 * c:3 * c]
    vden = out[:, 3 * c:4 * c]
    den2 = den * den
    m = jnp.minimum(jnp.minimum(uden * den, vden * den),
                    (den - uden - vden) * den)
    td = tden * den
    hit = (m >= 0.0) & (td > EPS * den2)
    return jnp.where(hit, td / den2, jnp.inf)


def _ray_features(origin, direction):
    o0, o1, o2 = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    d0, d1, d2 = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    dxo = jnp.concatenate([d1 * o2 - d2 * o1,
                           d2 * o0 - d0 * o2,
                           d0 * o1 - d1 * o0], axis=1)
    ones = jnp.ones_like(o0)
    zeros = jnp.zeros(origin.shape[:-1] + (FEAT - 10,), jnp.float32)
    return jnp.concatenate([origin, direction, dxo, ones, zeros], axis=1)


def _intersect_xla(feat, clusters, origin, direction, t_init, active,
                   exclude=None):
    n = origin.shape[0]
    c = TILE
    nt = feat.shape[1] // (4 * c)
    f = _ray_features(origin, direction)
    tiles = feat.T.reshape(nt, 4 * c, FEAT).transpose(0, 2, 1)

    def step(carry, inp):
        best_t, best_i = carry
        a_tile, off = inp
        score = _tile_scores(f, a_tile, c)
        if exclude is not None:
            # per-lane self-exclusion (see Hit.tri in ops/intersect.py)
            ids = off + jnp.arange(c, dtype=jnp.int32)
            score = jnp.where(ids[None, :] == exclude[:, None],
                              jnp.inf, score)
        tmin = jnp.min(score, axis=1)
        targ = jnp.argmin(score, axis=1).astype(jnp.int32) + off
        better = tmin < best_t
        return (jnp.where(better, tmin, best_t),
                jnp.where(better, targ, best_i)), None

    offs = jnp.arange(nt, dtype=jnp.int32) * c
    init = (jnp.asarray(jnp.broadcast_to(t_init, (n,)), jnp.float32),
            jnp.full((n,), -1, jnp.int32))
    (best_t, best_i), _ = jax.lax.scan(step, init, (tiles, offs))
    got = best_i >= 0
    if active is not None:
        got = got & active
    return (jnp.where(got, best_t, jnp.broadcast_to(t_init, (n,))),
            jnp.where(got, best_i, -1))


# ---------------------------------------------------------------------------
# GPU kernel (Pallas through Triton)
# ---------------------------------------------------------------------------

def _triangle_table(feat):
    """[FEAT, 4*Tpad] tile-grouped coefficients -> [16, Tpad] SoA table.

    Rows: 0-2 den's d-coefficients (n), 3 t*den's constant (n.p0), 4-6 /
    7-9 u*den's d- / (d x o)-coefficients, 10-12 / 13-15 the same for
    v*den.  t*den's o-coefficients are exactly -n, so they are not
    stored.  One triangle per column, so a step's loads are coalesced.
    """
    nt = feat.shape[1] // (4 * TILE)
    f = feat.reshape(FEAT, nt, 4, TILE)

    def rows(sec, lo, hi):
        return f[lo:hi, :, sec, :].reshape(hi - lo, nt * TILE)

    return jnp.concatenate([rows(0, 3, 6), rows(1, 9, 10),
                            rows(2, 3, 6), rows(2, 6, 9),
                            rows(3, 3, 6), rows(3, 6, 9)], axis=0)


def _mesh_kernel(ray_ref, ex_ref, tab_ref, clus_ref, t_ref, i_ref, *,
                 n_tiles: int, block_rays: int, step_tris: int):
    """One program: block_rays rays against every relevant cluster."""
    o = [ray_ref[k, :] for k in range(3)]
    d = [ray_ref[3 + k, :] for k in range(3)]
    w = [ray_ref[6 + k, :] for k in range(3)]  # d x o
    t_init = ray_ref[ROW_TINIT, :]
    active = ray_ref[ROW_ACTIVE, :] > 0.5
    any_hit = ray_ref[ROW_ANYHIT, :] > 0.5
    excl = ex_ref[:][:, None]
    inv_d = [1.0 / jnp.where(jnp.abs(dk) < 1e-12,
                             jnp.where(dk >= 0.0, 1e-12, -1e-12), dk)
             for dk in d]
    col = jax.lax.broadcasted_iota(jnp.int32, (block_rays, step_tris), 1)

    def step(base, carry):
        best_t, best_i = carry
        cols = pl.ds(base, step_tris)
        tab = [tab_ref[r, cols][None, :] for r in range(16)]
        d2 = [dk[:, None] for dk in d]
        o2 = [ok[:, None] for ok in o]
        w2 = [wk[:, None] for wk in w]
        den = d2[0] * tab[0] + d2[1] * tab[1] + d2[2] * tab[2]
        tden = tab[3] - (o2[0] * tab[0] + o2[1] * tab[1] + o2[2] * tab[2])
        uden = (d2[0] * tab[4] + d2[1] * tab[5] + d2[2] * tab[6]
                + w2[0] * tab[7] + w2[1] * tab[8] + w2[2] * tab[9])
        vden = (d2[0] * tab[10] + d2[1] * tab[11] + d2[2] * tab[12]
                + w2[0] * tab[13] + w2[1] * tab[14] + w2[2] * tab[15])
        den2 = den * den
        m = jnp.minimum(jnp.minimum(uden * den, vden * den),
                        (den - uden - vden) * den)
        td = tden * den
        hit = (m >= 0.0) & (td > EPS * den2) & (col + base != excl)
        score = jnp.where(hit, td / den2, jnp.inf)
        tmin = jnp.min(score, axis=1)
        targ = jnp.min(jnp.where(score <= tmin[:, None], col, step_tris),
                       axis=1) + base
        better = tmin < best_t
        best_t = jnp.where(better, jnp.where(any_hit, -jnp.inf, tmin),
                           best_t)
        return best_t, jnp.where(better, targ, best_i)

    def cluster(j, carry):
        best_t, best_i = carry
        # slab test of the cluster AABB against every ray's current best;
        # finished any-hit lanes and inactive lanes sit at -inf
        ent = jnp.full((block_rays,), EPS, jnp.float32)
        ext = best_t
        for k in range(3):
            lo = (clus_ref[j, k] - o[k]) * inv_d[k]
            hi = (clus_ref[j, 3 + k] - o[k]) * inv_d[k]
            ent = jnp.maximum(ent, jnp.minimum(lo, hi))
            ext = jnp.minimum(ext, jnp.maximum(lo, hi))
        relevant = jnp.max((ent <= ext).astype(jnp.int32)) > 0

        def run(carry):
            for s in range(TILE // step_tris):
                carry = step(j * TILE + s * step_tris, carry)
            return carry

        return jax.lax.cond(relevant, run, lambda c: c, (best_t, best_i))

    best_t = jnp.where(active, t_init, -jnp.inf)
    best_i = jnp.full((block_rays,), -1, jnp.int32)
    best_t, best_i = jax.lax.fori_loop(0, n_tiles, cluster, (best_t, best_i))
    got = best_i >= 0
    t_ref[:] = jnp.where(got & jnp.isfinite(best_t), best_t, t_init)
    i_ref[:] = best_i


def _intersect_triton(feat, clusters, origin, direction, t_init, active,
                      any_hit=False, exclude=None, interpret=False,
                      block_rays=BLOCK_RAYS, step_tris=STEP_TRIS,
                      num_warps=NUM_WARPS):
    n = origin.shape[0]
    npad = n + (-n) % block_rays
    act = active if active is not None else jnp.ones((n,), bool)
    t_init = jnp.broadcast_to(jnp.asarray(t_init, jnp.float32), (n,))
    ah = jnp.broadcast_to(jnp.asarray(any_hit, jnp.float32), (n,))
    ex = (jnp.full((n,), -1, jnp.int32) if exclude is None
          else exclude.astype(jnp.int32))
    o0, o1, o2 = origin[:, 0], origin[:, 1], origin[:, 2]
    d0, d1, d2 = direction[:, 0], direction[:, 1], direction[:, 2]
    rows = [o0, o1, o2, d0, d1, d2,
            d1 * o2 - d2 * o1, d2 * o0 - d0 * o2, d0 * o1 - d1 * o0,
            t_init, act.astype(jnp.float32), ah]
    rows += [jnp.zeros((n,), jnp.float32)] * (RAY_ROWS - len(rows))
    # padding lanes are inactive: they never make a cluster relevant
    rays = jnp.pad(jnp.stack(rows, axis=0), ((0, 0), (0, npad - n)))
    ex = jnp.pad(ex, (0, npad - n), constant_values=-1)
    tab = _triangle_table(feat)
    n_tiles = clusters.shape[0]

    out_t, out_i = pl.pallas_call(
        functools.partial(_mesh_kernel, n_tiles=n_tiles,
                          block_rays=block_rays, step_tris=step_tris),
        grid=(npad // block_rays,),
        in_specs=[
            pl.BlockSpec((RAY_ROWS, block_rays), lambda i: (0, i)),
            pl.BlockSpec((block_rays,), lambda i: (i,)),
            pl.BlockSpec(tab.shape, lambda i: (0, 0)),
            pl.BlockSpec(clusters.shape, lambda i: (0, 0)),
        ],
        out_specs=(pl.BlockSpec((block_rays,), lambda i: (i,)),
                   pl.BlockSpec((block_rays,), lambda i: (i,))),
        out_shape=(jax.ShapeDtypeStruct((npad,), jnp.float32),
                   jax.ShapeDtypeStruct((npad,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="mesh_intersect",
    )(rays, ex, tab, clusters)
    return out_t[:n], out_i[:n]


def ray_cluster_count(clusters, origin, direction, t_init):
    """Per-ray count of cluster tiles whose AABB the ray enters closer than
    ``t_init`` -- the brute backend's traversal-cost metric for the debug
    AOV (VIEW_STACK_INDEX analogue, kernels/main.cl:6-13,144-147)."""
    safe = jnp.where(jnp.abs(direction) < 1e-12,
                     jnp.where(direction >= 0.0, 1e-12, -1e-12), direction)
    inv_d = 1.0 / safe
    lo = (clusters[None, :, 0:3] - origin[:, None, :]) * inv_d[:, None, :]
    hi = (clusters[None, :, 3:6] - origin[:, None, :]) * inv_d[:, None, :]
    ent = jnp.maximum(jnp.max(jnp.minimum(lo, hi), axis=-1), EPS)
    ext = jnp.min(jnp.maximum(lo, hi), axis=-1)
    rel = ent <= jnp.minimum(ext, jnp.broadcast_to(t_init, ent.shape[:1])[:, None])
    return jnp.sum(rel, axis=-1).astype(jnp.int32)


def uses_kernel() -> bool:
    """True when mesh_intersect's default route is the GPU kernel."""
    return jax.devices()[0].platform == "gpu"


def mesh_intersect(feat, clusters, origin, direction, t_init, active=None,
                   any_hit=False, exclude=None, reference=False):
    """Closest mesh hit by exhaustive testing.

    Returns (t [N], tri [N] int32 index into the compact bf arrays, -1 on
    miss); t falls back to t_init when no triangle beats it.  ``any_hit``
    may be a python bool or a PER-LANE [N] array (mixed shadow/closest
    batches share one dispatch): for any-hit lanes only tri >= 0
    (occluded) is meaningful.  Fully detached (gradients reattach through
    the chosen triangle).

    The route follows the default device: the Triton kernel on a GPU, the
    plain reference on the CPU; ``reference=True`` forces the plain
    reference anywhere.  Other platforms are refused.
    """
    origin = jax.lax.stop_gradient(origin)
    direction = jax.lax.stop_gradient(direction)
    t_init = jax.lax.stop_gradient(t_init)
    feat = jax.lax.stop_gradient(feat)
    clusters = jax.lax.stop_gradient(clusters)
    if active is not None:
        active = jax.lax.stop_gradient(active)
    if exclude is not None:
        exclude = jax.lax.stop_gradient(exclude)
    platform = jax.devices()[0].platform
    if platform == "gpu" and not reference:
        return _intersect_triton(feat, clusters, origin, direction, t_init,
                                 active, any_hit=any_hit, exclude=exclude)
    if platform in ("cpu", "gpu"):
        # the reference always computes the closest hit; that subsumes
        # any-hit semantics (tri >= 0 iff some triangle is closer than
        # t_init)
        return _intersect_xla(feat, clusters, origin, direction, t_init,
                              active, exclude=exclude)
    raise NotImplementedError(
        f"no mesh intersection route for platform {platform!r}")
