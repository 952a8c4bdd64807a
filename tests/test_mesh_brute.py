"""Brute-force mesh intersection (ops/mesh_brute.py) vs the BVH walk.

The two backends implement the same closest-hit semantics
(kernels/geometry/triangle.cl:4-43 + bvh.cl:132-206 in the reference);
exhaustive testing must agree with the traversal on every ray.  The GPU
route (Pallas through Triton) runs here in interpret mode and must agree
with the plain XLA reference and with a float64 numpy Moller-Trumbore.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute
from photorealistic_rendering_using_opencl_tpu.ops.intersect import bvh_traverse
from photorealistic_rendering_using_opencl_tpu.ops.math import EPS, RAY_INF
from photorealistic_rendering_using_opencl_tpu.scene import bvh_build
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu.scene.types import empty_scene_data


@pytest.fixture(scope="module")
def mesh_setup():
    tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
    tv, tn = np.asarray(tv), np.asarray(tn)
    bvh = bvh_build.build_bvh(tv)
    packed = bvh_build.pack_for_device(bvh, tv, tn)
    scene = empty_scene_data(n_objects=1, n_tris=packed[2].shape[0],
                             n_nodes=bvh.miss.shape[0])
    scene.tri_verts = jnp.asarray(packed[2])
    scene.tri_normals = jnp.asarray(packed[3])
    scene.bvh_nodes = jnp.asarray(packed[0])
    scene.leaf_verts = jnp.asarray(packed[1])
    scene.bvh_links = jnp.asarray(packed[4])
    bp = mesh_brute.pack_brute(tv[bvh.order], tn[bvh.order])
    return scene, bp


def _pack(subdiv, radius=0.8, center=(0.1, -0.2, 0.3)):
    tv, tn = make_icosphere(subdiv=subdiv, radius=radius, center=center)
    order = bvh_build.build_bvh(np.asarray(tv)).order
    return mesh_brute.pack_brute(np.asarray(tv)[order],
                                 np.asarray(tn)[order])


def _rays(rng, n):
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _triton(bp, o, d, t_init, active=None, any_hit=False, exclude=None,
            **kw):
    return mesh_brute._intersect_triton(
        jnp.asarray(bp.feat), jnp.asarray(bp.clusters), o, d, t_init,
        active, any_hit=any_hit, exclude=exclude, interpret=True, **kw)


def _xla(bp, o, d, t_init, active=None, exclude=None):
    return mesh_brute._intersect_xla(
        jnp.asarray(bp.feat), jnp.asarray(bp.clusters), o, d, t_init,
        active, exclude=exclude)


def test_brute_matches_bvh(mesh_setup, rng):
    scene, bp = mesh_setup
    o, d = _rays(rng, 2048)
    tinit = jnp.full((2048,), RAY_INF)
    t_b, tri_b, _, _ = bvh_traverse(scene, o, d, tinit)
    t_n, tri_n = mesh_brute.mesh_intersect(
        jnp.asarray(bp.feat), jnp.asarray(bp.clusters), o, d, tinit)
    t_b, tri_b = np.asarray(t_b), np.asarray(tri_b)
    t_n, tri_n = np.asarray(t_n), np.asarray(tri_n)
    assert ((tri_b >= 0) == (tri_n >= 0)).all()
    both = tri_b >= 0
    np.testing.assert_allclose(t_b[both], t_n[both], atol=5e-5)
    # winning triangle is the same geometric triangle (indices live in
    # different orders, so compare sorted vertex tuples)
    vb = np.sort(np.asarray(scene.tri_verts)[tri_b[both]].reshape(-1, 9), 1)
    vn = np.sort(bp.tri_verts[tri_n[both]].reshape(-1, 9), 1)
    np.testing.assert_allclose(vb, vn, atol=1e-6)


def test_triton_kernel_matches_reference_closest(mesh_setup, rng):
    _, bp = mesh_setup
    o, d = _rays(rng, 600)  # not a multiple of BLOCK_RAYS: padding lanes
    tinit = jnp.full((600,), RAY_INF)
    t_x, tri_x = _xla(bp, o, d, tinit)
    t_k, tri_k = _triton(bp, o, d, tinit)
    np.testing.assert_array_equal(np.asarray(tri_k), np.asarray(tri_x))
    assert (np.asarray(tri_x) >= 0).sum() > 30  # the test sees hits
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_x), rtol=1e-6,
                               atol=1e-6)


def test_triton_kernel_mixed_any_hit_active_t_init(mesh_setup, rng):
    """One dispatch carrying closest and any-hit lanes, an active mask and
    per-lane t_init: closest lanes match the reference's winner, any-hit
    lanes its occlusion with t = t_init, inactive lanes miss."""
    _, bp = mesh_setup
    n = 700
    o, d = _rays(rng, n)
    tinit = jnp.asarray(rng.uniform(0.1, 8.0, n).astype(np.float32))
    anyh = rng.random(n) < 0.5
    act = rng.random(n) < 0.9
    t_x, tri_x = _xla(bp, o, d, tinit, jnp.asarray(act))
    t_k, tri_k = _triton(bp, o, d, tinit, jnp.asarray(act),
                         any_hit=jnp.asarray(anyh))
    tri_x, tri_k = np.asarray(tri_x), np.asarray(tri_k)
    t_x, t_k = np.asarray(t_x), np.asarray(t_k)
    closest, shadow = act & ~anyh, act & anyh
    np.testing.assert_array_equal(tri_k[closest], tri_x[closest])
    np.testing.assert_allclose(t_k[closest], t_x[closest], rtol=1e-6)
    np.testing.assert_array_equal(tri_k[shadow] >= 0, tri_x[shadow] >= 0)
    assert (tri_x[shadow] >= 0).any() and (tri_x[shadow] < 0).any()
    np.testing.assert_array_equal(t_k[shadow], np.asarray(tinit)[shadow])
    assert (tri_k[~act] == -1).all()
    np.testing.assert_array_equal(t_k[~act], np.asarray(tinit)[~act])


def test_triton_kernel_self_exclusion(mesh_setup, rng):
    """Rays leaving a point ON a triangle exclude that triangle by index
    (see Hit.tri in ops/intersect.py) on both routes."""
    _, bp = mesh_setup
    n = 500
    n_real = int((np.abs(bp.feat).sum(0) > 0).sum() // 4)
    tri = rng.integers(0, n_real, n)
    v = bp.tri_verts[tri]
    o = (v[:, 0] + v[:, 1] + v[:, 2]) / 3.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    ex = jnp.asarray(tri.astype(np.int32))
    tinit = jnp.full((n,), RAY_INF)
    _, tri_x = _xla(bp, o, d, tinit, exclude=ex)
    _, tri_k = _triton(bp, o, d, tinit, exclude=ex)
    np.testing.assert_array_equal(np.asarray(tri_k), np.asarray(tri_x))
    assert (np.asarray(tri_k) != tri).all()
    # inward rays cross the sphere: exclusion must not hide real hits
    assert (np.asarray(tri_k) >= 0).sum() > n // 4


def _numpy_mt(tv, o, d, t_init):
    """Float64 exhaustive Moller-Trumbore (triangle.cl:4-43)."""
    tv = tv.astype(np.float64)
    p0, p1, p2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e1, e2 = p0 - p1, p2 - p0
    n = np.cross(e1, e2)
    o, d = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    c = p0[None] - o
    r = np.cross(d, c)
    den = np.sum(n[None] * d, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.sum(r * e2[None], -1) / den
        v = np.sum(r * e1[None], -1) / den
        t = np.sum(n[None] * c, -1) / den
    ok = ((u >= 0) & (v >= 0) & (1 - u - v >= 0) & (t > EPS)
          & (t < t_init[:, None]) & (np.abs(den) > 0))
    t = np.where(ok, t, np.inf)
    best = np.argmin(t, 1)
    return np.where(np.isfinite(t.min(1)), best, -1), t


def test_triton_kernel_matches_numpy_moller_trumbore(rng):
    bp = _pack(subdiv=2)  # 320 triangles, 3 tiles
    o, d = _rays(rng, 400)
    tinit = np.full(400, RAY_INF, np.float32)
    _, tri_k = _triton(bp, o, d, jnp.asarray(tinit))
    tri_k = np.asarray(tri_k)
    real = np.abs(bp.feat).reshape(16, -1, 4, mesh_brute.TILE).sum(
        axis=(0, 2)).reshape(-1) > 0
    want, t = _numpy_mt(bp.tri_verts[real], np.asarray(o), np.asarray(d),
                        tinit)
    np.testing.assert_array_equal(tri_k >= 0, want >= 0)
    hit = want >= 0
    rows = np.nonzero(hit)[0]
    # same winner, or a near-tie in float64 distance
    t_k = t[rows, tri_k[hit]]
    t_w = t[rows, want[hit]]
    np.testing.assert_allclose(t_k, t_w, rtol=1e-5)


@pytest.mark.parametrize("shape", [(16, 32, 2), (128, 32, 8)])
def test_triton_kernel_block_shapes_agree(mesh_setup, rng, shape):
    """Other block shapes change only the schedule, never the result."""
    _, bp = mesh_setup
    br, st, nw = shape
    n = 300  # not a multiple of either block
    o, d = _rays(rng, n)
    tinit = jnp.asarray(rng.uniform(0.5, 8.0, n).astype(np.float32))
    anyh = jnp.asarray(rng.random(n) < 0.3)
    t_a, tri_a = _triton(bp, o, d, tinit, any_hit=anyh)
    t_b, tri_b = _triton(bp, o, d, tinit, any_hit=anyh, block_rays=br,
                         step_tris=st, num_warps=nw)
    cl = ~np.asarray(anyh)
    np.testing.assert_array_equal(np.asarray(tri_a)[cl],
                                  np.asarray(tri_b)[cl])
    np.testing.assert_array_equal(np.asarray(tri_a) >= 0,
                                  np.asarray(tri_b) >= 0)
    np.testing.assert_array_equal(np.asarray(t_a), np.asarray(t_b))


def test_triton_kernel_odd_tile_count(rng):
    """A mesh whose tile count is odd and whose last tile is padded."""
    tv, tn = make_icosphere(subdiv=2, radius=0.7)
    tv = np.concatenate([tv, tv[:50] + 1.5])
    tn = np.concatenate([tn, tn[:50]])
    order = bvh_build.build_bvh(tv).order
    bp = mesh_brute.pack_brute(tv[order], tn[order])
    assert bp.clusters.shape[0] == 3  # 370 triangles
    o, d = _rays(rng, 257)
    tinit = jnp.full((257,), RAY_INF)
    _, tri_x = _xla(bp, o, d, tinit)
    _, tri_k = _triton(bp, o, d, tinit)
    np.testing.assert_array_equal(np.asarray(tri_k), np.asarray(tri_x))


def test_triton_kernel_prunes_large_mesh(rng):
    """A 5,120-triangle mesh (40 tiles) and coherent rays that reach only
    a few tiles each: the kernel skips most clusters and still returns the
    reference's winners."""
    bp = _pack(subdiv=4, radius=0.9, center=(0.0, 0.0, 0.0))
    n = 512
    o = np.tile(np.asarray([[0.0, 0.0, 3.0]], np.float32), (n, 1))
    o[:, :2] += rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    d[:, :2] += rng.uniform(-0.05, 0.05, (n, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tinit = jnp.full((n,), RAY_INF)
    reach = np.asarray(mesh_brute.ray_cluster_count(
        jnp.asarray(bp.clusters), o, d, tinit))
    n_tiles = bp.clusters.shape[0]
    assert n_tiles == 40 and reach.max() < n_tiles // 2
    t_x, tri_x = _xla(bp, o, d, tinit)
    t_k, tri_k = _triton(bp, o, d, tinit)
    np.testing.assert_array_equal(np.asarray(tri_k), np.asarray(tri_x))
    assert (np.asarray(tri_k) >= 0).all()
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_x), rtol=1e-6)


def test_triangle_table_matches_coefficients(mesh_setup):
    """The kernel's [16, Tpad] table holds exactly the reference's
    coefficients, one triangle per column."""
    _, bp = mesh_setup
    tab = np.asarray(mesh_brute._triangle_table(jnp.asarray(bp.feat)))
    c = mesh_brute.TILE
    nt = bp.clusters.shape[0]
    f = bp.feat.reshape(16, nt, 4, c)
    sec = lambda k: f[:, :, k, :].reshape(16, nt * c)  # noqa: E731
    np.testing.assert_array_equal(tab[0:3], sec(0)[3:6])
    np.testing.assert_array_equal(tab[3], sec(1)[9])
    np.testing.assert_array_equal(-tab[0:3], sec(1)[0:3])
    np.testing.assert_array_equal(tab[4:10], sec(2)[3:9])
    np.testing.assert_array_equal(tab[10:16], sec(3)[3:9])


def test_active_mask_and_t_init(mesh_setup, rng):
    scene, bp = mesh_setup
    o, d = _rays(rng, 512)
    feat, cl = jnp.asarray(bp.feat), jnp.asarray(bp.clusters)
    tinit = jnp.full((512,), RAY_INF)
    t0, tri0 = mesh_brute.mesh_intersect(feat, cl, o, d, tinit)
    # inactive lanes return (t_init, -1) regardless of geometry
    act = jnp.asarray(rng.uniform(size=512) < 0.5)
    t1, tri1 = mesh_brute.mesh_intersect(feat, cl, o, d, tinit, active=act)
    act_np = np.asarray(act)
    assert (np.asarray(tri1)[~act_np] == -1).all()
    assert (np.asarray(t1)[~act_np] == RAY_INF).all()
    assert (np.asarray(tri1)[act_np] == np.asarray(tri0)[act_np]).all()
    # a tight t_init suppresses hits beyond it
    tcap = jnp.full((512,), 0.5)
    t2, tri2 = mesh_brute.mesh_intersect(feat, cl, o, d, tcap)
    got = np.asarray(tri2) >= 0
    assert (np.asarray(t2)[got] < 0.5).all()
    assert (np.asarray(t2)[~got] == 0.5).all()


def _fake_platform(monkeypatch, platform):
    dev = types.SimpleNamespace(platform=platform)
    monkeypatch.setattr(mesh_brute.jax, "devices", lambda *a: [dev])


def test_dispatch_cpu_takes_reference(mesh_setup, rng, monkeypatch):
    _, bp = mesh_setup

    def refuse(*a, **k):
        raise AssertionError("the CPU must not take the GPU kernel")

    monkeypatch.setattr(mesh_brute, "_intersect_triton", refuse)
    o, d = _rays(rng, 64)
    tinit = jnp.full((64,), RAY_INF)
    feat, cl = jnp.asarray(bp.feat), jnp.asarray(bp.clusters)
    got = mesh_brute.mesh_intersect(feat, cl, o, d, tinit)
    want = _xla(bp, o, d, tinit)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert not mesh_brute.uses_kernel()


def test_dispatch_gpu_takes_kernel_unless_reference(mesh_setup, rng,
                                                   monkeypatch):
    _, bp = mesh_setup
    calls = []
    monkeypatch.setattr(mesh_brute, "_intersect_triton",
                        lambda *a, **k: calls.append("kernel") or "k")
    monkeypatch.setattr(mesh_brute, "_intersect_xla",
                        lambda *a, **k: calls.append("reference") or "r")
    _fake_platform(monkeypatch, "gpu")
    o, d = _rays(rng, 8)
    feat, cl = jnp.asarray(bp.feat), jnp.asarray(bp.clusters)
    assert mesh_brute.uses_kernel()
    assert mesh_brute.mesh_intersect(feat, cl, o, d, 1.0) == "k"
    assert mesh_brute.mesh_intersect(feat, cl, o, d, 1.0,
                                     reference=True) == "r"
    assert calls == ["kernel", "reference"]


def test_dispatch_unknown_platform_raises(mesh_setup, rng, monkeypatch):
    _, bp = mesh_setup
    _fake_platform(monkeypatch, "metal")
    o, d = _rays(rng, 8)
    with pytest.raises(NotImplementedError, match="metal"):
        mesh_brute.mesh_intersect(jnp.asarray(bp.feat),
                                  jnp.asarray(bp.clusters), o, d, 1.0)


def test_reference_dot_asks_for_highest_precision(mesh_setup, rng):
    """A float32 dot may run in TF32 on a GPU unless it asks for more:
    every dot of the reference states Precision.HIGHEST."""
    _, bp = mesh_setup
    o, d = _rays(rng, 16)
    jaxpr = jax.make_jaxpr(
        lambda o, d: mesh_brute._intersect_xla(
            jnp.asarray(bp.feat), jnp.asarray(bp.clusters), o, d,
            jnp.full((16,), RAY_INF), None))(o, d)

    text = str(jaxpr)
    n_dots = text.count("dot_general[")
    assert n_dots > 0
    assert text.count("precision=(Precision.HIGHEST, Precision.HIGHEST)") \
        == n_dots, text


def test_render_backends_identical(rng):
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene

    mesh = make_icosphere(subdiv=1, radius=0.6, center=(0.0, -1.0, 0.0))
    cfg, scene = load_scene("scenes/cornell.json", mesh_override=mesh)
    assert cfg.mesh_accel == "brute"
    cam = default_camera(32, 32).pytree()
    img_b, _ = pathtracer.render(cfg, scene, cam, 32, 32, 1, seed=3)
    cfg_v = dataclasses.replace(cfg, mesh_accel="bvh")
    img_v, _ = pathtracer.render(cfg_v, scene, cam, 32, 32, 1, seed=3)
    np.testing.assert_array_equal(np.asarray(img_b), np.asarray(img_v))
    cfg_r = dataclasses.replace(cfg, mesh_accel="reference")
    img_r, _ = pathtracer.render(cfg_r, scene, cam, 32, 32, 1, seed=3)
    np.testing.assert_array_equal(np.asarray(img_b), np.asarray(img_r))


def test_kernel_route_differentiates(rng, monkeypatch):
    """value_and_grad through the kernel route (interpret mode): the
    search is detached -- every float input, the cluster table included,
    is stop_gradient'ed -- and gradients reattach through the winner."""
    import functools

    from photorealistic_rendering_using_opencl_tpu.ops import intersect
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        build_scene,
    )

    doc = {"settings": {"MAX_BOUNCES": 2},
           "scene": {"spheres": [
               {"pos": [0.0, 3.0, 0.0], "radius": 0.5,
                "material": {"color": [5.0, 5.0, 5.0], "type": 0}}]}}
    mesh = make_icosphere(subdiv=2, radius=0.9, center=(0.0, 0.5, 0.0))
    cfg, scene = build_scene(doc, mesh_override=mesh)
    cfg = dataclasses.replace(cfg, mesh_accel="brute", mesh_vertex_grads=True)
    monkeypatch.setattr(mesh_brute, "_intersect_triton", functools.partial(
        mesh_brute._intersect_triton, interpret=True))
    _fake_platform(monkeypatch, "gpu")
    o, d = _rays(rng, 200)

    def loss(leaves, route_cfg):
        tv, cl, oo = leaves
        sc = dataclasses.replace(scene, bf_tri_verts=tv, bf_clusters=cl)
        hit = intersect.intersect_scene(route_cfg, sc, oo, d)
        return jnp.sum(jnp.where(hit.valid, hit.t, 0.0))

    leaves = (scene.bf_tri_verts, scene.bf_clusters, o)
    val, (g_tv, g_cl, g_o) = jax.value_and_grad(loss)(leaves, cfg)
    cfg_r = dataclasses.replace(cfg, mesh_accel="reference")
    val_r, (r_tv, _, r_o) = jax.value_and_grad(loss)(leaves, cfg_r)
    np.testing.assert_allclose(float(val), float(val_r), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_tv), np.asarray(r_tv),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g_o), np.asarray(r_o),
                               rtol=1e-5, atol=1e-6)
    assert float(jnp.abs(g_tv).max()) > 0.0
    assert float(jnp.abs(g_cl).max()) == 0.0


def test_ray_sorting_is_result_invariant(rng, monkeypatch):
    """The kernel route sorts lanes before the dispatch and unsorts the
    results; tile relevance is conservative per lane, so the hit must be
    BITWISE identical with sorting on or off (here through the XLA
    reference with the kernel gate forced open so the sort wrapper runs)."""
    from photorealistic_rendering_using_opencl_tpu.ops import intersect
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        build_scene,
    )

    doc = {"settings": {"MAX_BOUNCES": 2},
           "scene": {"spheres": [
               {"pos": [0.0, 3.0, 0.0], "radius": 0.5,
                "material": {"color": [5.0, 5.0, 5.0], "type": 0}}]}}
    mesh = make_icosphere(subdiv=2, radius=0.9, center=(0.0, 0.5, 0.0))
    cfg, scene = build_scene(doc, mesh_override=mesh)
    cfg = dataclasses.replace(cfg, mesh_accel="brute")

    n = 700
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    h0 = intersect.intersect_scene(cfg, scene, o, d)
    monkeypatch.setattr(mesh_brute, "uses_kernel", lambda: True)
    h1 = intersect.intersect_scene(cfg, scene, o, d)
    np.testing.assert_array_equal(np.asarray(h0.tri), np.asarray(h1.tri))
    np.testing.assert_array_equal(np.asarray(h0.t), np.asarray(h1.t))
    np.testing.assert_array_equal(np.asarray(h0.mesh_id),
                                  np.asarray(h1.mesh_id))
