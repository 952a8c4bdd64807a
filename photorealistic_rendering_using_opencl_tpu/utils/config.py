"""Config introspection: the three configuration tiers, resolved.

The reference configures through (1) CLI flags, (2) the JSON scene file,
and (3) compile-time kernel specialization by a textual preprocessor
(SURVEY §5 config/flag system).  Here tier 3 is `jax.jit` specialization
on the frozen SceneConfig; this module renders the resolved config for
logs / reproducibility manifests.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from photorealistic_rendering_using_opencl_tpu.scene.types import SceneConfig


def describe(cfg: SceneConfig) -> dict[str, Any]:
    """Resolved static configuration as a plain dict (jit specialization
    keys -- two renders with equal describe() share compiled executables
    for equal shapes)."""
    d = dataclasses.asdict(cfg)
    d["n_objects"] = cfg.n_objects
    d["has_mesh"] = cfg.has_mesh
    d["env_nee"] = cfg.env_nee
    return d


def manifest(cfg: SceneConfig, width: int, height: int, spp: int,
             seed: int = 0, extra: dict | None = None) -> str:
    """One-line JSON reproducibility manifest for a render."""
    return json.dumps({
        "config": describe(cfg),
        "width": width, "height": height, "spp": spp, "seed": seed,
        **(extra or {}),
    }, sort_keys=True)


# the checkout root (this file is <root>/<package>/utils/config.py)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself);
    otherwise the cache lives at a fixed ``<checkout>/.jax_cache`` -- a
    fixed path, because the path is part of the cache key.
    """
    import jax
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path
