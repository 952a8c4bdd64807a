"""The flagship mesh asset, the loader's mesh-route pick and the compile
cache location."""
import os
import types

import numpy as np
import pytest

from photorealistic_rendering_using_opencl_tpu.scene import loader, obj
from photorealistic_rendering_using_opencl_tpu.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torus_knot_asset_matches_generator():
    """scenes/assets/torus_knot.obj is torus_knot_mesh()'s defaults."""
    tv, tn = obj.load_obj_py(
        os.path.join(ROOT, "scenes", "assets", "torus_knot.obj"))
    gv, gn = obj.make_torus_knot()
    assert tv.shape == (6320, 3, 3)
    np.testing.assert_allclose(tv, gv, atol=1e-5)
    np.testing.assert_allclose(tn, gn, atol=1e-5)


def test_torus_knot_is_closed_outward_and_nonconvex():
    pos, nrm, faces = obj.torus_knot_mesh()
    tv = pos[faces]
    fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    assert (np.linalg.norm(fn, axis=1) > 0).all()
    # counter-clockwise seen from outside: face normals follow the normals
    assert (np.sum(fn * nrm[faces].mean(1), axis=1) > 0).all()
    # closed: every edge is shared by exactly two faces
    e = np.sort(np.stack([faces[:, [0, 1]], faces[:, [1, 2]],
                          faces[:, [2, 0]]], 1).reshape(-1, 2), 1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()
    # non-convex (shadow rays see self-occlusion): many vertices lie in
    # front of a face's plane, which no convex mesh allows
    c = tv.mean(1)[::7]
    unit = fn[::7] / np.linalg.norm(fn[::7], axis=1, keepdims=True)
    front = np.einsum("fvk,fk->fv", pos[None] - c[:, None], unit)
    assert (front > 1e-3).any(axis=1).mean() > 0.5


def test_cornell_loads_knot_from_the_repo():
    cfg, scene = loader.load_scene(os.path.join(ROOT, "scenes", "cornell.json"))
    assert cfg.n_triangles == 6320
    assert scene.bf_clusters.shape[0] == -(-6320 // 128)


@pytest.mark.parametrize("platform,n_tris,want", [
    ("cpu", 2048, "brute"), ("cpu", 6320, "bvh"),
    ("gpu", 6320, "brute"), ("gpu", 10 ** 7, "bvh")])
def test_pick_mesh_accel(monkeypatch, platform, n_tris, want):
    import jax
    monkeypatch.delenv("PRT_MESH_ACCEL", raising=False)
    dev = types.SimpleNamespace(platform=platform)
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    assert loader._pick_mesh_accel(n_tris) == want
    monkeypatch.setenv("PRT_MESH_ACCEL", "reference")
    assert loader._pick_mesh_accel(n_tris) == "reference"


def test_compile_cache_dir(monkeypatch):
    import jax
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.enable_compile_cache() == os.path.join(ROOT, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert config.enable_compile_cache() == "/some/where"
    assert seen == [("jax_compilation_cache_dir",
                     os.path.join(ROOT, ".jax_cache")),
                    ("jax_compilation_cache_dir", "/some/where")]
