"""Counter-based parallel RNG: threefry2x32 + PCG4D, fully vectorized.

Replaces the reference's three ad-hoc seed schemes (host ``rand()`` salts +
per-pixel LCG hashes, ``kernels/prng/prng.cl:5-30``, ``main.cl:106-115``)
with deterministic counter streams keyed on (pixel, sample, dimension).
Every random decision in the tracer draws from a *fixed dimension index*,
so results are bit-reproducible regardless of device count or sharding --
the property the reference lacks (SURVEY §2.4 RNG row).

Three schemes, selected statically (the analogue of RNG_TYPE in
``kernels/header.cl:124-143``, which also offers three):
  * "threefry": threefry2x32, 20 rounds -- crypto-grade, default.
  * "pcg4d": the PCG4D hash of Jarzynski & Olano -- ~3x cheaper, fine for
    rendering, used by the perf path.
  * "mwc": dual 16-bit multiply-with-carry hash in the spirit of the
    reference's default scheme (prng.cl:5-16) but counter-keyed (the
    reference advances per-pixel LCG state; a stateful stream cannot be
    replayed per (pixel, sample, dim), so the same generator is applied
    as a hash).  Cheapest; statistically weakest.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32


def _rotl(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


_THREEFRY_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_THREEFRY_PARITY = 0x1BD11BDA


def threefry2x32(key0: jnp.ndarray, key1: jnp.ndarray,
                 x0: jnp.ndarray, x1: jnp.ndarray):
    """Threefry-2x32, 20 rounds. All args uint32, broadcastable."""
    key0 = key0.astype(_U32)
    key1 = key1.astype(_U32)
    ks2 = key0 ^ key1 ^ _U32(_THREEFRY_PARITY)
    x0 = x0.astype(_U32) + key0
    x1 = x1.astype(_U32) + key1
    ks = (key0, key1, ks2)
    for block in range(5):
        for i in range(4):
            x0 = x0 + x1
            x1 = _rotl(x1, _THREEFRY_ROTATIONS[(block % 2) * 4 + i])
            x1 = x1 ^ x0
        # key injection every 4 rounds
        inj = block + 1
        x0 = x0 + ks[inj % 3]
        x1 = x1 + ks[(inj + 1) % 3] + _U32(inj)
    return x0, x1


def pcg4d(v: jnp.ndarray) -> jnp.ndarray:
    """PCG4D hash; v is uint32[..., 4] -> uint32[..., 4]."""
    v = v.astype(_U32)
    v = v * _U32(1664525) + _U32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> _U32(16))
    y = y ^ (y >> _U32(16))
    z = z ^ (z >> _U32(16))
    w = w ^ (w >> _U32(16))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def mwc_hash(x0: jnp.ndarray, x1: jnp.ndarray) -> jnp.ndarray:
    """Three rounds of 16-bit multiply-with-carry mixing (prng.cl:5-16 as a
    counter hash).  x0/x1 uint32 -> uint32 bits."""
    x0 = x0.astype(_U32)
    x1 = x1.astype(_U32)
    for _ in range(3):
        x0 = _U32(36969) * (x0 & _U32(0xFFFF)) + (x0 >> _U32(16))
        x1 = _U32(18000) * (x1 & _U32(0xFFFF)) + (x1 >> _U32(16))
        x0, x1 = x0 ^ (x1 << _U32(16)), x1 ^ (x0 >> _U32(3))
    return (x0 << _U32(16)) + (x1 & _U32(0xFFFF))


def uniform_from_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 bits -> float32 in [0, 1) via mantissa trick (utils.cl:21-23)."""
    f = jax.lax.bitcast_convert_type(
        (bits >> _U32(9)) | _U32(0x3F800000), jnp.float32)
    return f - 1.0


class Sampler:
    """Per-ray deterministic random stream.

    ``pixel`` and ``sample`` index the stream; ``dim`` (auto-incremented)
    indexes the decision within the stream.  Shape of pixel/sample defines
    the batch shape of every draw.
    """

    __slots__ = ("pixel", "sample", "seed", "scheme",
                 "_dim0", "_off", "_blk", "_blk_win")

    def __init__(self, pixel: jnp.ndarray, sample: jnp.ndarray,
                 seed: int | jnp.ndarray = 0, scheme: str = "pcg4d",
                 dim: int | jnp.ndarray = 0):
        self.pixel = jnp.asarray(pixel, _U32)
        self.sample = jnp.asarray(sample, _U32)
        self.seed = jnp.asarray(seed, _U32)
        # ``dim`` must be a multiple of 4 (stream windows, see _draw);
        # integrator layouts (CAMERA_DIMS=8, DIMS_PER_BOUNCE=16) are.
        if isinstance(dim, int):
            assert dim % 4 == 0, "Sampler dim start must be 4-aligned"
        self._dim0 = dim
        self._off = 0  # python int: draws consumed so far
        self.scheme = scheme
        self._blk = None  # pcg4d 4-word block cache (see _draw)
        self._blk_win = -1

    @property
    def dim(self):
        return self._dim0 + self._off

    def next1d(self) -> jnp.ndarray:
        u, = self.nextnd(1)
        return u

    def next2d(self) -> tuple[jnp.ndarray, jnp.ndarray]:
        u, v = self.nextnd(2)
        return u, v

    def nextnd(self, n: int):
        outs = []
        for _ in range(n):
            outs.append(self._draw())
        return tuple(outs)

    def _draw(self) -> jnp.ndarray:
        if self.scheme == "threefry":
            d = jnp.asarray(self._dim0, _U32) + _U32(self._off)
            x0, _ = threefry2x32(self.seed, jnp.broadcast_to(d, self.pixel.shape),
                                 self.pixel, self.sample)
            bits = x0
        elif self.scheme == "mwc":
            d = jnp.asarray(self._dim0, _U32) + _U32(self._off)
            bits = mwc_hash(self.pixel ^ (self.seed * _U32(0x9E3779B9)),
                            self.sample * _U32(0x85EBCA6B) ^ d)
        else:
            # pcg4d yields FOUR well-mixed words per hash (Jarzynski &
            # Olano use all four lanes): hash once per 4-dim window and
            # hand out one word per draw -- 4x fewer hash passes over the
            # batch (each pass is a full HBM round trip at megapixel lane
            # counts).  Stream stays a pure function of (pixel, sample,
            # seed, dim) with dim = dim0 + off, dim0 4-aligned.
            win = self._off // 4
            if self._blk_win != win:
                base = (jnp.asarray(self._dim0, _U32) >> _U32(2)) + _U32(win)
                v = jnp.stack([
                    self.pixel,
                    self.sample,
                    jnp.broadcast_to(base, self.pixel.shape),
                    jnp.broadcast_to(self.seed, self.pixel.shape),
                ], axis=-1)
                self._blk = pcg4d(v)
                self._blk_win = win
            bits = self._blk[..., self._off % 4]
        self._off += 1
        return uniform_from_bits(bits)
