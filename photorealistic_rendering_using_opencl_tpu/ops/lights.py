"""Area-light sampling for NEE: sphere solid-angle caps and quads.

Re-design of the light-geometry sampling in ``kernels/geometry/sphere.cl:
59-88`` and ``quad.cl:40-62`` plus the dispatch (geometry/geometry.cl:11-52).
Bug fixed vs the reference (SURVEY §7): ``sphere_sampleDirect`` overwrites
the cap sample with a scalar splat (``toGlobal(&frame, cosTheta)``,
sphere.cl:84); here the sampled cap direction is rotated into the frame of
the center direction as intended.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.ops.math import normalize, safe_sqrt, to_global
from photorealistic_rendering_using_opencl_tpu.ops.sampling import (
    uniform_spherical_cap, uniform_spherical_cap_pdf,
)
from photorealistic_rendering_using_opencl_tpu.scene.types import (
    QUAD, SceneConfig, SceneData, SPHERE,
)


class LightSample(NamedTuple):
    d: jnp.ndarray  # [N,3] direction to the light
    dist: jnp.ndarray  # [N]
    pdf: jnp.ndarray  # [N] solid-angle pdf
    valid: jnp.ndarray  # [N]


def sphere_sample_direct(center, radius, p, u1, u2) -> LightSample:
    """Solid-angle cap sampling toward a sphere light (sphere.cl:65-88)."""
    ell = center - p
    d2 = jnp.sum(ell * ell, axis=-1)
    d = jnp.sqrt(jnp.maximum(d2, 1e-20))
    c = d2 - radius * radius
    valid = c > 0.0
    ldir = ell / d[..., None]
    cos_theta_max = safe_sqrt(c) / d
    cap = uniform_spherical_cap(u1, u2, cos_theta_max)
    w = to_global(ldir, cap)
    b = d * cap[..., 2]
    det = safe_sqrt(b * b - c)
    dist = b - det
    pdf = uniform_spherical_cap_pdf(cos_theta_max)
    return LightSample(w, dist, pdf, valid)


def sphere_direct_pdf(center, radius, p, direction=None):
    ell = center - p
    d2 = jnp.sum(ell * ell, axis=-1)
    d = jnp.sqrt(jnp.maximum(d2, 1e-20))
    cos_theta_max = safe_sqrt(d2 - radius * radius) / d
    return uniform_spherical_cap_pdf(cos_theta_max)


def quad_sample_direct(base, edge0, edge1, normal, area, p, u1, u2
                       ) -> LightSample:
    """Area sampling of a one-sided quad light (quad.cl:40-54).

    ``base`` is the stored center point; sampling spans base + u*edge0 +
    v*edge1 like the reference (which therefore samples a quad offset by
    half an edge from the visible rect -- we keep the reference's anchor
    convention by shifting to the anchor corner).
    """
    anchor = base - (edge0 + edge1) * 0.5
    front = jnp.sum(normal * (p - base), axis=-1) > 0.0
    q = anchor + u1[..., None] * edge0 + u2[..., None] * edge1
    dvec = q - p
    r2 = jnp.sum(dvec * dvec, axis=-1)
    dist = jnp.sqrt(jnp.maximum(r2, 1e-20))
    d = dvec / dist[..., None]
    cos_theta = -jnp.sum(normal * d, axis=-1)
    pdf = r2 / jnp.maximum(cos_theta * area, 1e-12)
    return LightSample(d, dist, pdf, front & (cos_theta > 0.0))


def quad_direct_pdf(base, edge0, edge1, normal, area, p, direction):
    cos_theta = jnp.abs(jnp.sum(normal * direction, axis=-1))
    t = (jnp.sum(normal * (base - p), axis=-1)
         / jnp.where(jnp.abs(jnp.sum(normal * direction, axis=-1)) < 1e-12,
                     1e-12, jnp.sum(normal * direction, axis=-1)))
    return t * t / jnp.maximum(cos_theta * area, 1e-12)


# ---------------------------------------------------------------------------
# Dispatch over the (single) sampled light (base.cl:92 uses LIGHT_INDICES[0];
# PICK_RANDOM_LIGHT selects uniformly)
# ---------------------------------------------------------------------------

def pick_light(cfg: SceneConfig, scene: SceneData, u: jnp.ndarray):
    """Return (light_obj_idx, pick_pdf) for shading points.

    Single-light scenes get a SCALAR index: every downstream light-table
    lookup (position/params/quad_*/color/geom_type) then compiles to a
    broadcast row read instead of an [N]-gather.
    """
    if cfg.pick_random_light and cfg.n_lights > 1:
        li = jnp.clip((u * cfg.n_lights).astype(jnp.int32), 0, cfg.n_lights - 1)
        return scene.light_indices[li], 1.0 / cfg.n_lights
    return scene.light_indices[0], 1.0


def sample_direct(cfg: SceneConfig, scene: SceneData, light_idx, p, u1, u2
                  ) -> LightSample:
    """sampleDirect dispatch (geometry.cl:11-32): sphere or quad lights."""
    gt = scene.geom_type[light_idx]
    center = scene.position[light_idx]
    radius = scene.params[light_idx, 0]
    ls = sphere_sample_direct(center, radius, p, u1, u2)
    qs = quad_sample_direct(scene.quad_base[light_idx],
                            scene.quad_edge0[light_idx],
                            scene.quad_edge1[light_idx],
                            scene.quad_normal[light_idx],
                            scene.quad_area[light_idx], p, u1, u2)
    is_sphere = (gt & SPHERE) != 0
    is_quad = (gt & QUAD) != 0
    d = jnp.where(is_sphere[..., None], ls.d, qs.d)
    dist = jnp.where(is_sphere, ls.dist, qs.dist)
    pdf = jnp.where(is_sphere, ls.pdf, qs.pdf)
    valid = jnp.where(is_sphere, ls.valid, is_quad & qs.valid)
    return LightSample(d, dist, pdf, valid)


def direct_pdf(cfg: SceneConfig, scene: SceneData, light_idx, p, direction):
    """directPdf dispatch (geometry.cl:34-52)."""
    gt = scene.geom_type[light_idx]
    sp = sphere_direct_pdf(scene.position[light_idx],
                           scene.params[light_idx, 0], p)
    qp = quad_direct_pdf(scene.quad_base[light_idx],
                         scene.quad_edge0[light_idx],
                         scene.quad_edge1[light_idx],
                         scene.quad_normal[light_idx],
                         scene.quad_area[light_idx], p, direction)
    is_sphere = (gt & SPHERE) != 0
    return jnp.where(is_sphere, sp, jnp.where((gt & QUAD) != 0, qp, 0.0))
