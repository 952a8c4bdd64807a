"""Environment map: equirect lookup, importance sampling, env NEE."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from photorealistic_rendering_using_opencl_tpu.ops import envmap
from photorealistic_rendering_using_opencl_tpu.models import pathtracer
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu.scene.loader import build_scene
from conftest import uniform_grid


def _hotspot_env(h=16, w=32, bright=50.0):
    env = np.full((h, w, 3), 0.05, np.float32)
    env[h // 4, w // 3] = bright  # single bright texel
    return env


def test_searchsorted_rows_matches_numpy():
    rng = np.random.default_rng(3)
    table = np.sort(rng.uniform(0, 1, (8, 37)), axis=1).astype(np.float32)
    table[:, -1] = 1.0
    row = rng.integers(0, 8, 100).astype(np.int32)
    u = rng.uniform(0, 1, 100).astype(np.float32)
    got = np.asarray(envmap.jax_searchsorted_rows(
        jnp.asarray(table), jnp.asarray(row), jnp.asarray(u)))
    want = np.array([np.searchsorted(table[r], x) for r, x in zip(row, u)])
    np.testing.assert_array_equal(got, np.minimum(want, 36))


def test_sample_env_hits_hotspot_and_pdf_consistent():
    env = _hotspot_env()
    dist = envmap.build_env_distribution(jnp.asarray(env))
    u1, u2 = uniform_grid(4096)
    d, pdf = envmap.sample_env(dist, jnp.asarray(u1), jnp.asarray(u2))
    assert np.allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-4)
    # most samples should land on the bright texel
    rad = np.asarray(envmap.radiance(jnp.asarray(env), d))
    assert (rad[:, 0] > 1.0).mean() > 0.5
    # pdf of sampled dirs matches env_pdf lookup
    pdf2 = np.asarray(envmap.env_pdf(dist, d))
    np.testing.assert_allclose(np.asarray(pdf), pdf2, rtol=1e-3)


def test_env_sampling_estimator_unbiased():
    """MC estimate of irradiance via importance sampling == uniform-sphere
    reference, for a smooth env map."""
    rng = np.random.default_rng(0)
    env = (0.3 + 0.7 * rng.uniform(size=(8, 16, 3))).astype(np.float32)
    dist = envmap.build_env_distribution(jnp.asarray(env))
    n = 200_000
    u1 = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=n).astype(np.float32)
    d, pdf = envmap.sample_env(dist, jnp.asarray(u1), jnp.asarray(u2))
    est = np.asarray(envmap.radiance(jnp.asarray(env), d)
                     / np.asarray(pdf)[:, None]).mean(axis=0)

    # uniform-sphere reference
    z = 1.0 - 2.0 * rng.uniform(size=n)
    phi = 2 * np.pi * rng.uniform(size=n)
    r = np.sqrt(np.maximum(1 - z * z, 0))
    dirs = np.stack([r * np.cos(phi), z, r * np.sin(phi)], axis=-1)
    ref = np.asarray(envmap.radiance(
        jnp.asarray(env), jnp.asarray(dirs, jnp.float32)))
    ref = ref.mean(axis=0) * 4 * np.pi
    np.testing.assert_allclose(est, ref, rtol=0.05)


def test_env_nee_reduces_variance_same_mean():
    """Hotspot env: env NEE must agree in expectation with BSDF-only
    sampling and cut variance dramatically."""
    doc = {"settings": {"MAX_BOUNCES": 2},
           "scene": {"quads": [
               {"vertices": [0.0, -0.5, 0.0, 12.0, 0.0, 0.0, 0.0, 0.0, 12.0],
                "material": {"color": [0.7, 0.7, 0.7]}}]}}
    env = _hotspot_env(bright=200.0)
    cfg_on, scene = build_scene(doc, env_map=env)
    cfg_off = dataclasses.replace(cfg_on, enable_env_sampling=False)
    cam = default_camera(12, 12).pytree()

    img_on, _ = pathtracer.render(cfg_on, scene, cam, 12, 12, 64, seed=1)
    img_off, _ = pathtracer.render(cfg_off, scene, cam, 12, 12, 512, seed=2)
    m_on = float(jnp.mean(img_on))
    m_off = float(jnp.mean(img_off))
    # agree within MC noise of the (noisier) BSDF-only estimate
    assert abs(m_on - m_off) / max(m_off, 1e-6) < 0.25, (m_on, m_off)

    # variance: mean per-pixel std over 16 independent 1-spp renders;
    # jitter off so the only randomness is the lighting estimator
    def stack(cfg):
        return np.stack([
            np.asarray(pathtracer.render(cfg, scene, cam, 12, 12, 1,
                                         seed=s, jitter=False)[0])
            for s in range(16)])

    std_on = float(stack(cfg_on).std(axis=0).mean())
    std_off = float(stack(cfg_off).std(axis=0).mean())
    assert std_on < std_off, (std_on, std_off)
