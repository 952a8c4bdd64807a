"""Phong tessellation: curved-triangle evaluation + conservative AABBs.

Batched equivalent of the reference's dormant Phong-tessellation
support (``src/Math/MathHelp.cpp:144-281``, compiled out with
RENDER_PHONGTESS = 0).  The surface point blends the barycentric point
with its projections onto the three vertex tangent planes
[Boubekeur & Alexa 2008]; ``tessellated_aabb`` inflates triangle bounds so
a BVH built over curved patches stays conservative (the reference's
triThicknessAndSidedrop sampling approach, vectorized over triangles).
Batched over a leading triangle axis; alpha = 0 reduces to flat triangles.
"""
from __future__ import annotations

import jax.numpy as jnp


def _project_on_plane(q, p, n):
    return q - jnp.sum((q - p) * n, axis=-1, keepdims=True) * n


def phong_tessellate(p1, p2, p3, n1, n2, n3, alpha, u, v):
    """Curved-surface point at barycentric (u, v, w=1-u-v).

    All p*/n* are [...,3]; u/v broadcastable; mirrors
    MathHelp::phongTessellate (MathHelp.cpp:148-161).
    """
    u = jnp.asarray(u)[..., None]
    v = jnp.asarray(v)[..., None]
    w = 1.0 - u - v
    p_bary = p1 * u + p2 * v + p3 * w
    p_t = (u * _project_on_plane(p_bary, p1, n1)
           + v * _project_on_plane(p_bary, p2, n2)
           + w * _project_on_plane(p_bary, p3, n3))
    return (1.0 - alpha) * p_bary + alpha * p_t


_SAMPLE_UV = (
    (0.0, 0.5), (0.5, 0.0), (0.5, 0.5), (0.25, 0.75), (0.75, 0.25),
    (0.25, 0.0), (0.75, 0.0), (0.0, 0.25), (0.0, 0.75),
    (1.0 / 3.0, 1.0 / 3.0),
)


def tessellated_aabb(p1, p2, p3, n1, n2, n3, alpha):
    """Conservative per-triangle bounds of the curved patch.

    Vertices plus the reference's 9 edge/side samples and the centroid
    (MathHelp.cpp:167-221's sidedrop sampling); returns (bmin, bmax)
    [...,3].  Use at BVH build time when alpha > 0.
    """
    pts = [p1, p2, p3]
    for u, v in _SAMPLE_UV:
        pts.append(phong_tessellate(p1, p2, p3, n1, n2, n3, alpha, u, v))
    stack = jnp.stack(pts, axis=0)
    return jnp.min(stack, axis=0), jnp.max(stack, axis=0)
