"""Display transform (ops/tonemap.py) against a numpy transcription of the
reference's GL tonemapper (shaders/tonemapper.glsl): vignette, filmic
Reinhard with W=1.2 and T2=7.5, smoothstep toe, gamma 2.2."""
import jax.numpy as jnp
import numpy as np
import pytest

from photorealistic_rendering_using_opencl_tpu.ops.tonemap import tonemap


def _smoothstep(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _reinhard(x, t2=7.5):
    q = (t2 * t2 + 1.0) * x * x
    return q / (q + x + t2 * t2)


def _tonemap_np(img, vignette, brightness):
    h, w = img.shape[:2]
    c = img.astype(np.float64)
    if vignette:
        ys = 1.0 - 2.0 * (np.arange(h) + 0.5) / h
        xs = 1.0 - 2.0 * (np.arange(w) + 0.5) / w
        pp = ys[:, None] ** 2 + xs[None, :] ** 2
        vig = (1.25 / (1.1 + 1.1 * pp)) ** 2
        vig = 1.0 + (_smoothstep(0.1, 1.1, vig) - 1.0) * 0.25
        c = c * vig[..., None]
    c = _reinhard(brightness * c) / _reinhard(1.2)
    c = _smoothstep(-0.025, 1.0, c)
    return np.clip(c, 0.0, 1.0) ** (1.0 / 2.2)


@pytest.mark.parametrize("vignette,brightness", [(True, 1.0), (False, 1.7)])
def test_tonemap_matches_numpy_transcription(vignette, brightness):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 3, (33, 47, 3)).astype(np.float32)
    got = np.asarray(tonemap(jnp.asarray(img), vignette=vignette,
                             brightness=brightness))
    want = _tonemap_np(img, vignette, brightness)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert got.min() >= 0.0 and got.max() <= 1.0
