"""Generate golden renders for the regression test (run from repo root):

    python tests/golden_tool.py            # writes tests/golden/*.npz

Configs are tiny (CPU-friendly) but exercise every geometry/material/media
path: analytic cornell, SDF+box mix, scattering media, BVH mesh, env map.
Regenerate ONLY when an intentional estimator change is made, and say so in
the commit message.
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

CONFIGS = {
    "cornell_simple": dict(scene="scenes/cornell_simple.json", spp=8),
    "cornell_media": dict(scene="scenes/cornell_media.json", spp=4),
    "sdf_demo": dict(scene="scenes/sdf_demo.json", spp=4),
    "mesh_icosphere": dict(scene="scenes/cornell_simple.json", spp=4,
                           mesh=True),
    "envmap": dict(scene="scenes/cornell_simple.json", spp=4, env=True),
    "exponential_fog": dict(scene="scenes/cornell_simple.json", spp=4,
                            exp_medium=True),
    "materials": dict(scene="scenes/materials.json", spp=4),
    # MIS edge cases (VERDICT round 1 weak #7); PICK_RANDOM_LIGHT comes
    # from the scene file's settings block -- the user-facing path
    "multi_light_pick": dict(scene="scenes/multilight_pick.json", spp=8),
    "alpha_test": dict(scene="scenes/cornell_simple.json", spp=8,
                       alpha=True),
    "coat_grazing": dict(scene="scenes/coat_grazing.json", spp=8),
    # 81,920-triangle mesh: on the CPU the loader auto-picks the skip-link
    # BVH walk -- pins both the fallback selection and the walk at
    # >32k-triangle scale
    "cornell_hi_bvh": dict(scene="scenes/cornell_hi.json", spp=2),
}
SIZE = 32
SEED = 9


def render_config(name: str):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import default_camera
    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere

    c = CONFIGS[name]
    kwargs = {}
    if c.get("alpha"):
        kwargs["alpha_testing"] = True
    if c.get("mesh"):
        kwargs["mesh_override"] = make_icosphere(
            subdiv=1, radius=0.7, center=(0.0, 0.8, 0.0))
    if c.get("env"):
        u = np.linspace(0.0, 1.0, 16, dtype=np.float32)
        gx, gy = np.meshgrid(u, u[:8], indexing="xy")
        env = np.stack([gx, gy, np.full((8, 16), 0.5, np.float32)],
                       axis=-1).astype(np.float32)
        kwargs["env_map"] = env
    if c.get("exp_medium"):
        import json as _json
        doc = _json.load(open(c["scene"]))
        doc["global_medium"] = {"type": "exponential", "density": 0.4,
                                "sigmaA": 0.1, "sigmaS": 0.6}
        from photorealistic_rendering_using_opencl_tpu.scene.loader import build_scene
        cfg, scene = build_scene(doc, **kwargs)
    else:
        cfg, scene = load_scene(c["scene"], **kwargs)
    if c.get("pick_random_light"):
        import dataclasses
        cfg = dataclasses.replace(cfg, pick_random_light=True)
    cam = default_camera(SIZE, SIZE).pytree()
    img, alpha = pathtracer.render(cfg, scene, cam, SIZE, SIZE, c["spp"],
                                   seed=SEED)
    return np.asarray(img), np.asarray(alpha)


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in CONFIGS:
        img, alpha = render_config(name)
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(path, img=img, alpha=alpha)
        print(f"{name}: mean={img.mean():.5f} max={img.max():.3f} -> {path}")


if __name__ == "__main__":
    sys.exit(main())
