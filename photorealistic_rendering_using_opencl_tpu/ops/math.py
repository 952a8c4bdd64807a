"""Vector math + orthonormal bases, batched over leading axes.

All functions operate on arrays whose LAST axis is the 3-vector; everything
broadcasts over arbitrary leading (ray-batch) dimensions, replacing the
reference's scalar ``float3`` helpers (``include/Math/linear_algebra.h``,
``kernels/header.cl:179-204``) with vectorized forms the VPU eats whole.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

EPS = 1e-5
# NOTE: the reference clamps rays at INF = 2e1 (header.cl:5), i.e. a 20-unit
# world. That is a bug-by-convention we keep configurable; 1e30 is "infinity"
# but scene intersects still report the reference's horizon where required.
RAY_INF = 2e1
BIG = 1e30

PI = jnp.pi
TWO_PI = 2.0 * jnp.pi
FOUR_PI = 4.0 * jnp.pi
INV_PI = 1.0 / jnp.pi
INV_TWO_PI = 1.0 / (2.0 * jnp.pi)
INV_FOUR_PI = 1.0 / (4.0 * jnp.pi)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def dot3(a, b):
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    # eps floor keeps the rsqrt partial finite in f32 for ~zero vectors on
    # masked-out lanes (0-cotangent x inf-partial = NaN in scan transpose)
    return a * jnp.reciprocal(jnp.sqrt(jnp.maximum(dot3(a, a), eps)))


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt clamped at zero with a NaN-free backward pass.

    d/dx sqrt(max(x, 0)) at x <= 0 evaluates inf * 0 = NaN in reverse mode;
    the double-where makes the gradient exactly 0 there instead.
    """
    neg = x <= 0.0
    return jnp.where(neg, 0.0, jnp.sqrt(jnp.where(neg, 1.0, x)))


def fmax3(v: jnp.ndarray) -> jnp.ndarray:
    """Max component over the last axis (kernels/utils.cl:30)."""
    return jnp.max(v, axis=-1)


def fmin3(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.min(v, axis=-1)


def avg3(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(v, axis=-1)


def sgn_e(x: jnp.ndarray) -> jnp.ndarray:
    """Signum excluding zero (kernels/utils.cl:44): sgnE(0) = +1."""
    return jnp.where(x < 0.0, -1.0, 1.0)


def lerp(a, b, w):
    return a + w * (b - a)


# ---------------------------------------------------------------------------
# Tangent frames -- [Duff et al. 2017] branchless ONB, batched.
# Mirrors createTangentFrame/toLocal/toGlobal (kernels/header.cl:186-204).
# ---------------------------------------------------------------------------

def tangent_frame(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Return (tangent, bitangent) for unit normal(s) n[..., 3]."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sn = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sn + nz)
    b = nx * ny * a
    tangent = jnp.stack([1.0 + sn * nx * nx * a, sn * b, -sn * nx], axis=-1)
    bitangent = jnp.stack([b, sn + ny * ny * a, -ny], axis=-1)
    return tangent, bitangent


def to_local(n: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """World -> tangent space where n is the local +z."""
    t, bt = tangent_frame(n)
    return jnp.stack([dot(t, v), dot(bt, v), dot(n, v)], axis=-1)


def to_global(n: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Tangent -> world."""
    t, bt = tangent_frame(n)
    return (
        t * v[..., 0:1] + bt * v[..., 1:2] + n * v[..., 2:3]
    )


def reflect_local(wi: jnp.ndarray) -> jnp.ndarray:
    """Mirror about local +z: (-x, -y, z)."""
    return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)


def smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def power_heuristic(pdf0: jnp.ndarray, pdf1: jnp.ndarray) -> jnp.ndarray:
    """Power heuristic beta=2 (kernels/integrators/base.cl:23-25).

    Double-where guard: with both pdfs ~0 (masked-out lanes) the quotient's
    partial derivative overflows f32 and NaNs the backward pass.

    Overflow guard: masked-out lanes evaluate every BSDF family regardless
    of material, and a near-specular microfacet D on such a lane reaches
    ~1e32, whose square overflows f32 to inf -- the weight's VALUE is
    still fine (a2/inf = 0) but its partial is inf/inf = NaN, which
    0-cotangents turn into NaN gradients for the light's position/radius/
    roughness (found by the depth-32 fwd+bwd bench).  Both pdfs are scaled
    by a COMMON detached factor that brings the larger one down to 1e12,
    so the forward ratio is preserved exactly (a ratio in pdf0/pdf1 is
    invariant under common scaling; for pdfs <= 1e12 the factor is
    exactly 1.0) while the squares stay finite in both the forward and
    the transpose (ADVICE r3: the per-pdf clamp collapsed the weight to
    0.5 when both pdfs exceeded 1e12 with different magnitudes).
    """
    m = jax.lax.stop_gradient(jnp.maximum(pdf0, pdf1))
    big = m > 1e12
    s = jnp.where(big, 1e12 / jnp.where(big, m, 1.0), 1.0)
    pdf0 = pdf0 * s
    pdf1 = pdf1 * s
    p0 = pdf0 * pdf0
    denom = p0 + pdf1 * pdf1
    tiny = denom < 1e-12
    return jnp.where(tiny, 0.0, p0 / jnp.where(tiny, 1.0, denom))


# ---------------------------------------------------------------------------
# Table-row fetch with a one-hot-matmul VJP
# ---------------------------------------------------------------------------

SELECT_MAX_ROWS = 24


def select_rows(arr, idx):
    """``arr[idx]`` ([K,...] by [N]) as a compare/select chain.

    For the small object tables of typical scenes a K-way select chain of
    broadcast rows replaces a per-ray gather with K elementwise passes."""
    out = jnp.broadcast_to(arr[0],
                           idx.shape + arr.shape[1:]).astype(arr.dtype)
    for i in range(1, arr.shape[0]):
        m = idx == i
        if arr.ndim > 1:
            m = m[..., None]
        out = jnp.where(m, arr[i], out)
    return out


def _fetch_rows_impl(table, idx):
    return (select_rows(table, idx)
            if table.shape[0] <= SELECT_MAX_ROWS else table[idx])


@jax.custom_vjp
def fetch_float_rows(table, idx):
    """``table[idx]`` ([K,F] by [N] -> [N,F]) with a one-hot-matmul transpose.

    Forward: the usual select chain (or gather for big tables).  Backward:
    the VJP of a row-fetch is a segment-sum of the [N,F] cotangent into
    the [K,F] table -- autodiff of the select chain emits K masked
    [N,F]->[F] reductions PER FIELD PER ITERATION.  Here it is ONE one-hot
    [K,N]x[N,F] matmul instead.  HIGHEST precision keeps the accumulation
    f32-exact (the one-hot operand is exactly representable; TF32 or
    single-pass bf16 would quantize the cotangents)."""
    return _fetch_rows_impl(table, idx)


def _fetch_float_rows_fwd(table, idx):
    return _fetch_rows_impl(table, idx), (idx, table.shape[0])


def _fetch_float_rows_bwd(res, g):
    import numpy as np
    idx, k = res
    onehot = (idx[:, None] == jnp.arange(k, dtype=idx.dtype)[None, :])
    d_table = jax.lax.dot_general(
        onehot.astype(g.dtype), g, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)  # [K,F]
    return d_table, np.zeros(idx.shape, dtype=jax.dtypes.float0)


fetch_float_rows.defvjp(_fetch_float_rows_fwd, _fetch_float_rows_bwd)
