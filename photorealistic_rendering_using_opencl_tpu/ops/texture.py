"""Texture sampling: bilinear / trilinear-mip / anisotropic, batched.

Working counterpart of the reference's dormant texture atlas
sampler (``kernels/texture.cl:6-60`` references undefined symbols and is
not included anywhere; SURVEY §2.2).  Textures are [H,W,C] arrays; mip
pyramids are tuples built host-side once.  UVs wrap; LOD is continuous.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def build_mip_pyramid(tex: jnp.ndarray, max_levels: int | None = None):
    """2x box-filter pyramid [full, half, ...] down to 1x1 (host, one-time).

    Returns a tuple of arrays (a static pytree -- jit-friendly).
    """
    levels = [jnp.asarray(tex, jnp.float32)]
    h, w = tex.shape[0], tex.shape[1]
    n = int(np.floor(np.log2(max(min(h, w), 1)))) if max_levels is None \
        else max_levels - 1
    cur = levels[0]
    for _ in range(n):
        ch, cw = cur.shape[0], cur.shape[1]
        if ch < 2 or cw < 2:
            break
        ch2, cw2 = ch // 2 * 2, cw // 2 * 2
        c = cur[:ch2, :cw2]
        cur = (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
               + c[1::2, 1::2]) * 0.25
        levels.append(cur)
    return tuple(levels)


def sample_bilinear(tex: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Bilinear fetch, u/v wrap (repeat addressing)."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0i + 1, h)
    c00 = tex[y0i, x0i]
    c10 = tex[y0i, x1i]
    c01 = tex[y1i, x0i]
    c11 = tex[y1i, x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_trilinear(pyramid: tuple, u: jnp.ndarray, v: jnp.ndarray,
                     lod: jnp.ndarray):
    """Trilinear: bilinear in the two straddling mips, lerped by frac(lod).

    Equivalent of SampleTextureTrilinear (texture.cl:6-19) without the
    atlas indirection.  lod is clamped to the pyramid height.
    """
    n = len(pyramid)
    lod = jnp.clip(lod, 0.0, n - 1.0)
    lo = jnp.floor(lod).astype(jnp.int32)
    f = (lod - lo.astype(jnp.float32))[..., None]

    # static unroll over mip levels, masked select (levels have distinct
    # shapes so a lax.switch over stacked arrays is not possible)
    out_lo = jnp.zeros(u.shape + (pyramid[0].shape[-1],), jnp.float32)
    out_hi = jnp.zeros_like(out_lo)
    for i, level in enumerate(pyramid):
        s = sample_bilinear(level, u, v)
        out_lo = jnp.where((lo == i)[..., None], s, out_lo)
        out_hi = jnp.where((jnp.minimum(lo + 1, n - 1) == i)[..., None],
                           s, out_hi)
    return out_lo * (1.0 - f) + out_hi * f


def sample_anisotropic(pyramid: tuple, u: jnp.ndarray, v: jnp.ndarray,
                       du: jnp.ndarray, dv: jnp.ndarray,
                       max_taps: int = 4):
    """Anisotropic filtering (texture.cl:21-58 semantics): several
    trilinear taps along the major UV-gradient axis at the LOD of the
    minor axis."""
    h, w = pyramid[0].shape[0], pyramid[0].shape[1]
    lx = jnp.linalg.norm(du * jnp.asarray([w, h], jnp.float32), axis=-1)
    ly = jnp.linalg.norm(dv * jnp.asarray([w, h], jnp.float32), axis=-1)
    major = jnp.maximum(lx, ly)
    minor = jnp.maximum(jnp.minimum(lx, ly), 1e-8)
    lod = jnp.log2(jnp.maximum(minor, 1.0))
    step = jnp.where((lx >= ly)[..., None], du, dv)
    acc = 0.0
    for i in range(max_taps):
        t = (i + 0.5) / max_taps - 0.5
        acc = acc + sample_trilinear(pyramid, u + step[..., 0] * t,
                                     v + step[..., 1] * t, lod)
    return acc / max_taps
