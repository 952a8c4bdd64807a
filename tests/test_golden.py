"""Golden-image regression: bitwise-deterministic renders vs stored goldens.

The counter-based RNG (ops/rng.py) makes every render a pure function of
(scene, camera, seed), so tiny goldens pin the whole estimator -- geometry,
BSDFs, NEE/MIS, media, env maps.  Tolerance covers compiler/backend
reassociation only.  Regenerate with `python tests/golden_tool.py` when an
intentional estimator change lands.
"""
import os

import numpy as np
import pytest

from golden_tool import CONFIGS, GOLDEN_DIR, render_config


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden {path} missing; run tests/golden_tool.py")
    with np.load(path) as z:
        ref_img, ref_alpha = z["img"], z["alpha"]
    img, alpha = render_config(name)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, ref_img, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(alpha, ref_alpha, rtol=1e-4, atol=1e-5)


def test_cornell_hi_auto_picks_walk_on_cpu():
    """82k-tri auto-pick: on the CPU (this test env) exhaustive testing
    pays only for small meshes, so the skip-link walk carries it; the GPU
    pick follows mesh_brute.GPU_BRUTE_MAX_TRIS (measured, PERF.md)."""
    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene
    cfg, _ = load_scene("scenes/cornell_hi.json")
    assert cfg.n_triangles == 81920
    assert cfg.mesh_accel == "bvh"  # CPU pick
