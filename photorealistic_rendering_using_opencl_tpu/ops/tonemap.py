"""Display transform: vignette + filmic-Reinhard + gamma, pure JAX.

Replaces the reference's GL fullscreen pass (``shaders/tonemapper.glsl``)
with a vectorized post op over the [H,W,3] radiance image -- same curve
constants (W=1.2, T2=7.5), vignette, smoothstep toe, gamma 2.2.
"""
from __future__ import annotations

import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.ops.math import smoothstep

_W = 1.2
_T2 = 7.5


def filmic_reinhard_curve(x):
    q = (_T2 * _T2 + 1.0) * x * x
    return q / (q + x + _T2 * _T2)


def filmic_reinhard(x):
    return filmic_reinhard_curve(x) / filmic_reinhard_curve(_W)


def tonemap(img: jnp.ndarray, vignette: bool = True,
            brightness: float = 1.0) -> jnp.ndarray:
    """img[H,W,3] linear radiance -> display RGB in [0,1].

    An elementwise chain that XLA fuses into one pass over the image.
    """
    h, w = img.shape[0], img.shape[1]
    color = img
    if vignette:
        ys = 1.0 - 2.0 * (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
        xs = 1.0 - 2.0 * (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
        pp = ys[:, None] ** 2 + xs[None, :] ** 2
        vig = 1.25 / (1.1 + 1.1 * pp)
        vig = vig * vig
        vig = 1.0 + (smoothstep(0.1, 1.1, vig) - 1.0) * 0.25
        color = color * vig[..., None]
    color = filmic_reinhard(brightness * color)
    color = smoothstep(-0.025, 1.0, color)
    return jnp.power(jnp.clip(color, 0.0, 1.0), 1.0 / 2.2)
