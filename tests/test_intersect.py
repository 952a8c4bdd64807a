"""Geometry intersection: analytic closed-form checks + BVH vs brute force."""
import numpy as np
import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.ops import intersect
from photorealistic_rendering_using_opencl_tpu.scene import bvh_build, obj as obj_io
from photorealistic_rendering_using_opencl_tpu.scene.types import (
    SDF, SDF_SPHERE, SceneConfig, empty_scene_data,
)


def test_sphere_hit_closed_form():
    o = jnp.asarray([[0.0, 0.0, -5.0], [0.0, 3.0, -5.0], [0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    c = jnp.asarray([[0.0, 0.0, 0.0]])
    r = jnp.asarray([1.0])
    t = np.asarray(intersect.sphere_hits(o, d, c, r))
    assert abs(t[0, 0] - 4.0) < 1e-5          # outside hit
    assert np.isinf(t[1, 0])                  # miss above
    assert abs(t[2, 0] - 1.0) < 1e-5          # from inside: far root


def test_box_hit_normal_and_backside():
    o = jnp.asarray([[0.0, 0.0, -5.0], [0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 2)
    c = jnp.asarray([[0.0, 0.0, 0.0]])
    h = jnp.asarray([[1.0, 1.0, 1.0]])
    t, n, backside = intersect.box_hits(o, d, c, h)
    t, n, backside = np.asarray(t), np.asarray(n), np.asarray(backside)
    assert abs(t[0, 0] - 4.0) < 1e-5
    assert np.allclose(n[0, 0], [0, 0, -1], atol=1e-6)  # entry face
    assert not backside[0, 0]
    assert abs(t[1, 0] - 1.0) < 1e-5          # inside: exit face
    assert backside[1, 0]


def test_quad_one_sided():
    # quad centered at origin in the xy-plane, normal +z (= e0 x e1)
    base = jnp.asarray([[0.0, 0.0, 0.0]])
    e0 = jnp.asarray([[2.0, 0.0, 0.0]])
    e1 = jnp.asarray([[0.0, 2.0, 0.0]])
    nrm = jnp.asarray([[0.0, 0.0, 1.0]])
    d_toward = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    o = jnp.asarray([[0.3, 0.3, -2.0], [0.3, 0.3, 2.0]])
    t = np.asarray(intersect.quad_hits(o, d_toward, base, e0, e1, nrm))
    # one-sided: visible only travelling along the normal (reference quad.cl:20)
    assert abs(t[0, 0] - 2.0) < 1e-4
    assert np.isinf(t[1, 0])
    # outside the parallelogram
    o2 = jnp.asarray([[5.0, 0.0, -2.0]])
    t2 = np.asarray(intersect.quad_hits(o2, d_toward[:1], base, e0, e1, nrm))
    assert np.isinf(t2[0, 0])


def test_sdf_sphere_march_matches_analytic():
    n = 64
    rng = np.random.default_rng(0)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -5.0
    o[:, 0] = rng.uniform(-2, 2, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    centers = jnp.asarray([[0.0, 0.0, 0.0]])
    gt = jnp.asarray([SDF | SDF_SPHERE], jnp.int32)
    params = jnp.asarray([[1.0, 0, 0, 0]])
    t, obj, hit = intersect.sdf_march(jnp.asarray(o), jnp.asarray(d),
                                      jnp.full((n,), 20.0), centers, gt,
                                      params, steps=128)
    t, hit = np.asarray(t), np.asarray(hit)
    should_hit = np.abs(o[:, 0]) < 0.97
    assert (hit[should_hit]).all()
    t_exact = 5.0 - np.sqrt(np.maximum(1.0 - o[:, 0] ** 2, 1e-9))
    err = np.abs(t[should_hit] - t_exact[should_hit])
    assert err.max() < 5e-3


def test_triangle_moller_trumbore():
    p0 = jnp.asarray([[0.0, 0.0, 0.0]])
    p1 = jnp.asarray([[1.0, 0.0, 0.0]])
    p2 = jnp.asarray([[0.0, 1.0, 0.0]])
    o = jnp.asarray([[0.2, 0.2, -3.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    hit, t, u, v = intersect._tri_intersect(p0, p1, p2, o, d,
                                            jnp.full((1,), 1e9))
    assert bool(hit[0]) and abs(float(t[0]) - 3.0) < 1e-5
    # barycentrics: p = w*p0 + u*p1 + v*p2
    assert abs(float(u[0]) - 0.2) < 1e-5 and abs(float(v[0]) - 0.2) < 1e-5


def _brute_force(tri_v, o, d):
    """Closest-hit reference: loop all triangles in numpy."""
    n = o.shape[0]
    tbest = np.full(n, np.inf, np.float64)
    ibest = np.full(n, -1, np.int64)
    for i in range(tri_v.shape[0]):
        p0, p1, p2 = tri_v[i]
        e1, e2 = p1 - p0, p2 - p0
        h = np.cross(d, np.broadcast_to(e2, d.shape))
        a = (e1 * h).sum(-1)
        mask = np.abs(a) > 1e-12
        f = np.where(mask, 1.0 / np.where(mask, a, 1.0), 0.0)
        s = o - p0
        u = f * (s * h).sum(-1)
        q = np.cross(s, np.broadcast_to(e1, s.shape))
        v = f * (d * q).sum(-1)
        t = f * (q * e2).sum(-1)
        ok = mask & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-5) & (t < tbest)
        tbest = np.where(ok, t, tbest)
        ibest = np.where(ok, i, ibest)
    return tbest, ibest


def test_bvh_traversal_matches_brute_force(rng):
    tri_v, tri_n = obj_io.make_icosphere(subdiv=2)
    bvh = bvh_build.build_bvh(tri_v)
    nodes, leaf_verts, lm_v, lm_n, links = bvh_build.pack_for_device(
        bvh, tri_v, tri_n)

    data = empty_scene_data(n_tris=lm_v.shape[0], n_nodes=nodes.shape[0])
    data.tri_verts = jnp.asarray(lm_v)
    data.tri_normals = jnp.asarray(lm_n)
    data.bvh_nodes = jnp.asarray(nodes)
    data.leaf_verts = jnp.asarray(leaf_verts)
    data.bvh_links = jnp.asarray(links)

    n = 256
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    o[:, 2] = -4.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    t, tri, u, v = intersect.bvh_traverse(
        data, jnp.asarray(o), jnp.asarray(d), jnp.full((n,), 1e9, jnp.float32))
    t = np.asarray(t)
    tri = np.asarray(tri)

    t_ref, _ = _brute_force(tri_v, o.astype(np.float64),
                            d.astype(np.float64))
    hit_ref = np.isfinite(t_ref)
    hit_bvh = tri >= 0
    assert (hit_bvh == hit_ref).all()
    assert np.abs(t[hit_ref] - t_ref[hit_ref]).max() < 1e-3


def test_bvh_leaf_invariants():
    tri_v, _ = obj_io.make_icosphere(subdiv=1)
    bvh = bvh_build.build_bvh(tri_v)
    leaf = bvh.prim_count > 0
    assert bvh.prim_count.max() <= bvh_build.LEAF_SIZE
    # every triangle covered exactly once by leaf ranges
    covered = np.zeros(tri_v.shape[0], bool)
    for f, c in zip(bvh.first_prim[leaf], bvh.prim_count[leaf]):
        assert not covered[f:f + c].any()
        covered[f:f + c] = True
    assert covered.all()
    # miss links are strictly forward and in range
    m = bvh.miss.shape[0]
    assert ((bvh.miss > np.arange(m)) & (bvh.miss <= m)).all()


def test_bvh_traverse_chunked_matches_unchunked(rng, monkeypatch):
    """n > TRAVERSE_CHUNK exercises the lax.map chunking; results must be
    identical to the single-chunk walk."""
    monkeypatch.setattr(intersect, "TRAVERSE_CHUNK", 4096)
    tri_v, tri_n = obj_io.make_icosphere(subdiv=2)
    bvh = bvh_build.build_bvh(tri_v)
    nodes, leaf_verts, lm_v, lm_n, links = bvh_build.pack_for_device(
        bvh, tri_v, tri_n)
    data = empty_scene_data(n_tris=lm_v.shape[0], n_nodes=nodes.shape[0])
    data.tri_verts = jnp.asarray(lm_v)
    data.tri_normals = jnp.asarray(lm_n)
    data.bvh_nodes = jnp.asarray(nodes)
    data.leaf_verts = jnp.asarray(leaf_verts)
    data.bvh_links = jnp.asarray(links)

    n = intersect.TRAVERSE_CHUNK + 777  # force the padded chunked path
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    o[:, 2] = -4.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ti = jnp.full((n,), 1e9, jnp.float32)

    t_c, tri_c, u_c, v_c = intersect.bvh_traverse(
        data, jnp.asarray(o), jnp.asarray(d), ti)
    t_u, tri_u, u_u, v_u = intersect._bvh_traverse_chunk(
        data, jnp.asarray(o), jnp.asarray(d), ti)
    np.testing.assert_array_equal(np.asarray(tri_c), np.asarray(tri_u))
    np.testing.assert_allclose(np.asarray(t_c), np.asarray(t_u), atol=0)
