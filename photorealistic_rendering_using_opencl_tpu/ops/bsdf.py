"""BSDF framework: sample / eval / pdf for the full material set, batched.

Batched re-design of ``kernels/bxdf/bxdf.cl`` + ``kernels/bxdf/Materials/*``:
instead of a per-thread type-bitmask if/else dispatch, every *present*
material family (statically gated by ``SceneConfig.active_mats``, the
analogue of the reference's ``#ifdef`` dead-code elimination) is evaluated
for the whole ray batch and combined with masked selects.  The BSDF math is
cheap vector arithmetic; traversal dominates, so all-lobes compute beats
divergent control flow on 8x128 vector lanes (SURVEY §7 "hard parts").

Conventions (match the reference):
  * tangent space with the shading normal as +z; ``wi`` points *away* from
    the surface toward the viewer (wi = to_local(-ray.dir)).
  * ``eval`` returns f * |cos(theta_o)| (the reference folds the cosine into
    BSDF_eval, e.g. Lambert.cl:24).
  * ``sample.weight`` is f * cos / pdf (throughput multiplier).
  * the non-adjoint eta^2 radiance scaling of BSDF2/BSDF_eval2
    (bxdf.cl:118-143) is applied here for dielectric transmission.

Deliberate bug fixes vs the reference (SURVEY §7):
  * LambertBSDF_pdf missing return (Lambert.cl:30) -> returns the pdf.
  * Burley diffuse promoted from dead code (bxdf/old/burley_diffuse.cl).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.ops import fresnel, microfacet
from photorealistic_rendering_using_opencl_tpu.ops.math import (
    INV_PI, normalize, reflect_local, sgn_e,
)
from photorealistic_rendering_using_opencl_tpu.ops.sampling import (
    cosine_hemisphere, cosine_hemisphere_pdf,
)
from photorealistic_rendering_using_opencl_tpu.scene.types import (
    ABS_REFR, ABS_REFR2, BURLEY, COAT, COND, DIEL, DIFF,
    DIFFUSE_REFLECTION_LOBE, FORWARD_LOBE, GLOSSY_REFLECTION_LOBE,
    GLOSSY_TRANSMISSION_LOBE, ROUGH_COND, ROUGH_DIEL, SceneConfig,
    SPECULAR_LOBE, SPECULAR_REFLECTION_LOBE, SPECULAR_TRANSMISSION_LOBE,
)

DIRAC_EPS = 1e-3  # DiracAcceptanceThreshold (utils.cl:48)

# Coat layer constants (Coat.cl:4-8)
COAT_IOR = 1.3
COAT_THICKNESS = 1.0
COAT_SIGMA_A = 0.0


class MatProps(NamedTuple):
    """Per-ray gathered material attributes (SoA)."""

    color: jnp.ndarray  # [N,3]
    eta: jnp.ndarray  # [N,3]
    k: jnp.ndarray  # [N,3]
    roughness: jnp.ndarray  # [N]
    mat_type: jnp.ndarray  # [N] int32
    lobes: jnp.ndarray  # [N] int32
    dist: jnp.ndarray  # [N] int32


class BSDFSample(NamedTuple):
    wo: jnp.ndarray  # [N,3] sampled direction, tangent space
    pdf: jnp.ndarray  # [N]
    weight: jnp.ndarray  # [N,3] f*cos/pdf (includes eta^2 scaling)
    lobe: jnp.ndarray  # [N] int32 sampled lobe
    valid: jnp.ndarray  # [N] bool -- False terminates the path


def _check_reflection(wi, wo):
    """Dirac mirror constraint (utils.cl:50-53)."""
    d = wi[..., 2] * wo[..., 2] - wi[..., 0] * wo[..., 0] - wi[..., 1] * wo[..., 1]
    return jnp.abs(d - 1.0) < DIRAC_EPS


def _check_refraction(wi, wo, eta, cos_theta_t):
    d = (-wi[..., 0] * wo[..., 0] * eta
         - wi[..., 1] * wo[..., 1] * eta
         - jnp.copysign(cos_theta_t, wi[..., 2]) * wo[..., 2])
    return jnp.abs(d - 1.0) < DIRAC_EPS


def _rel_eta(mat: MatProps, wi_z):
    """Relative IOR as the reference uses it (Dielectric.cl:10)."""
    return jnp.where(wi_z < 0.0, mat.eta[..., 0], 1.0 / mat.eta[..., 0])


def _absorption(mat: MatProps, backside, ray_t):
    """Beer-Lambert variants ABS_REFR/ABS_REFR2 (Dielectric.cl:30-37)."""
    abs1 = (mat.mat_type & ABS_REFR) != 0
    abs2 = (mat.mat_type & ABS_REFR2) != 0
    any_abs = abs1 | abs2
    tint = jnp.where(abs2[..., None], mat.color, 1.0)
    sigma = jnp.where(abs1[..., None], mat.color, 1.0)
    beer = jnp.exp(-ray_t[..., None] * sigma * 10.0)
    beer = jnp.where(backside[..., None], beer, 1.0)
    # materials without the flags just use plain albedo
    return jnp.where(any_abs[..., None], tint * beer, mat.color)


# ===========================================================================
# Lambert (Lambert.cl)
# ===========================================================================

def lambert_sample(mat: MatProps, wi, u1, u2) -> BSDFSample:
    wo = cosine_hemisphere(u1, u2)
    pdf = cosine_hemisphere_pdf(wo)
    valid = wi[..., 2] > 0.0
    lobe = jnp.full(wi.shape[:-1], DIFFUSE_REFLECTION_LOBE, jnp.int32)
    return BSDFSample(wo, pdf, mat.color, lobe, valid)


def lambert_eval(mat: MatProps, wi, wo):
    f = mat.color * INV_PI * wo[..., 2:3]
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return jnp.where(ok[..., None], f, 0.0)


def lambert_pdf(wi, wo):
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return jnp.where(ok, cosine_hemisphere_pdf(wo), 0.0)


# ===========================================================================
# Burley diffuse (promoted from bxdf/old/burley_diffuse.cl:10-17)
# ===========================================================================

def _burley_fd(roughness, cos_d, cos_x):
    fd90 = 0.5 + 2.0 * roughness * cos_d * cos_d
    return 1.0 + (fd90 - 1.0) * jnp.power(1.0 - jnp.abs(cos_x), 5.0)


def burley_sample(mat: MatProps, wi, u1, u2) -> BSDFSample:
    wo = cosine_hemisphere(u1, u2)
    pdf = cosine_hemisphere_pdf(wo)
    h = wi + wo
    # math.normalize: NaN-free backward at h ~= 0 (wo ~= -wi lanes)
    h = normalize(h)
    cos_d = jnp.sum(h * wo, axis=-1)
    fd = (_burley_fd(mat.roughness, cos_d, wi[..., 2])
          * _burley_fd(mat.roughness, cos_d, wo[..., 2]))
    valid = wi[..., 2] > 0.0
    lobe = jnp.full(wi.shape[:-1], DIFFUSE_REFLECTION_LOBE, jnp.int32)
    return BSDFSample(wo, pdf, mat.color * fd[..., None], lobe, valid)


def burley_eval(mat: MatProps, wi, wo):
    h = wi + wo
    # math.normalize: NaN-free backward at h ~= 0 (wo ~= -wi lanes)
    h = normalize(h)
    cos_d = jnp.sum(h * wo, axis=-1)
    fd = (_burley_fd(mat.roughness, cos_d, wi[..., 2])
          * _burley_fd(mat.roughness, cos_d, wo[..., 2]))
    f = mat.color * (INV_PI * fd * wo[..., 2])[..., None]
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return jnp.where(ok[..., None], f, 0.0)


# ===========================================================================
# Smooth conductor (Conductor.cl)
# ===========================================================================

def conductor_sample(mat: MatProps, wi) -> BSDFSample:
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, wi[..., 2])
    wo = reflect_local(wi)
    pdf = jnp.ones(wi.shape[:-1], jnp.float32)
    lobe = jnp.full(wi.shape[:-1], SPECULAR_REFLECTION_LOBE, jnp.int32)
    valid = jnp.ones(wi.shape[:-1], bool)
    return BSDFSample(wo, pdf, mat.color * f, lobe, valid)


def conductor_eval(mat: MatProps, wi, wo):
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, wi[..., 2])
    ok = _check_reflection(wi, wo)
    return jnp.where(ok[..., None], mat.color * f, 0.0)


def conductor_pdf(wi, wo):
    return _check_reflection(wi, wo).astype(jnp.float32)


# ===========================================================================
# Rough conductor (RoughConductor.cl)
# ===========================================================================

def rough_conductor_sample(mat: MatProps, wi, u1, u2,
                           roughness=None) -> BSDFSample:
    rough = mat.roughness if roughness is None else roughness
    alpha = microfacet.roughness_to_alpha(mat.dist, rough)
    m = microfacet.sample(mat.dist, alpha, u1, u2)
    wi_dot_m = jnp.sum(wi * m, axis=-1)
    wo = 2.0 * wi_dot_m[..., None] * m - wi
    valid = (wi[..., 2] > 0.0) & (wi_dot_m > 0.0) & (wo[..., 2] > 0.0)
    g = microfacet.G(mat.dist, alpha, wi, wo, m)
    d = microfacet.D(mat.dist, alpha, m)
    m_pdf = microfacet.pdf(mat.dist, alpha, m)
    pdf = m_pdf * 0.25 / jnp.maximum(wi_dot_m, 1e-12)
    w = wi_dot_m * g * d / jnp.maximum(wi[..., 2] * m_pdf, 1e-12)
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, wi_dot_m)
    lobe = jnp.full(wi.shape[:-1], GLOSSY_REFLECTION_LOBE, jnp.int32)
    return BSDFSample(wo, pdf, mat.color * f * w[..., None], lobe, valid)


def rough_conductor_eval(mat: MatProps, wi, wo):
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    hr = wi + wo
    # math.normalize: NaN-free backward at hr ~= 0 (wo ~= -wi lanes)
    hr = normalize(hr)
    cos_m = jnp.sum(wi * hr, axis=-1)
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, cos_m)
    g = microfacet.G(mat.dist, alpha, wi, wo, hr)
    d = microfacet.D(mat.dist, alpha, hr)
    fr = g * d * 0.25 / jnp.maximum(wi[..., 2], 1e-12)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return jnp.where(ok[..., None], mat.color * f * fr[..., None], 0.0)


def rough_conductor_pdf(mat: MatProps, wi, wo):
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    hr = wi + wo
    # math.normalize: NaN-free backward at hr ~= 0 (wo ~= -wi lanes)
    hr = normalize(hr)
    p = (microfacet.pdf(mat.dist, alpha, hr) * 0.25
         / jnp.maximum(jnp.sum(wi * hr, axis=-1), 1e-12))
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return jnp.where(ok, p, 0.0)


# ===========================================================================
# Smooth dielectric (Dielectric.cl) + absorption variants
# ===========================================================================

def dielectric_sample(mat: MatProps, wi, backside, ray_t, u0) -> BSDFSample:
    eta = _rel_eta(mat, wi[..., 2])
    f, cos_t = fresnel.dielectric_reflectance(eta, jnp.abs(wi[..., 2]))
    reflect = u0 < f
    wo_r = reflect_local(wi)
    wo_t = jnp.stack([
        -wi[..., 0] * eta,
        -wi[..., 1] * eta,
        -jnp.copysign(cos_t, wi[..., 2]),
    ], axis=-1)
    wo = jnp.where(reflect[..., None], wo_r, wo_t)
    pdf = jnp.where(reflect, f, 1.0 - f)
    wsc = jnp.where(reflect, f, 1.0 - f)
    valid = reflect | (f < 1.0)
    weight = jnp.broadcast_to(wsc[..., None] / jnp.maximum(pdf, 1e-12)[..., None],
                              wi.shape)  # == 1, kept for structure
    weight = weight * _absorption(mat, backside, ray_t)
    lobe = jnp.where(reflect, SPECULAR_REFLECTION_LOBE,
                     SPECULAR_TRANSMISSION_LOBE).astype(jnp.int32)
    return BSDFSample(wo, pdf, weight, lobe, valid)


def dielectric_eval(mat: MatProps, wi, wo, backside=None, ray_t=None):
    eta = _rel_eta(mat, wi[..., 2])
    f, cos_t = fresnel.dielectric_reflectance(eta, jnp.abs(wi[..., 2]))
    same_side = wi[..., 2] * wo[..., 2] >= 0.0
    refl_ok = _check_reflection(wi, wo)
    refr_ok = _check_refraction(wi, wo, eta, cos_t)
    val = jnp.where(same_side,
                    jnp.where(refl_ok, f, 0.0),
                    jnp.where(refr_ok, 1.0 - f, 0.0))
    return val[..., None] * mat.color


def dielectric_pdf(mat: MatProps, wi, wo):
    eta = _rel_eta(mat, wi[..., 2])
    f, cos_t = fresnel.dielectric_reflectance(eta, jnp.abs(wi[..., 2]))
    same_side = wi[..., 2] * wo[..., 2] >= 0.0
    refl_ok = _check_reflection(wi, wo)
    refr_ok = _check_refraction(wi, wo, eta, cos_t)
    return jnp.where(same_side,
                     jnp.where(refl_ok, f, 0.0),
                     jnp.where(refr_ok, 1.0 - f, 0.0))


def dielectric_eta(mat: MatProps, wi, wo):
    """Radiance-scaling eta for transmission (Dielectric.cl:82-87)."""
    same_side = wi[..., 2] * wo[..., 2] >= 0.0
    return jnp.where(same_side, 1.0, _rel_eta(mat, wi[..., 2]))


# ===========================================================================
# Rough dielectric (RoughDielectric.cl, Walter et al. 2007 style)
# ===========================================================================

def rough_dielectric_sample(mat: MatProps, wi, backside, ray_t,
                            u0, u1, u2) -> BSDFSample:
    wi_n = wi[..., 2]
    eta = _rel_eta(mat, wi_n)
    sample_rough = (1.2 - 0.2 * jnp.sqrt(jnp.abs(wi_n))) * mat.roughness
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    sample_alpha = microfacet.roughness_to_alpha(mat.dist, sample_rough)
    m = microfacet.sample(mat.dist, sample_alpha, u1, u2)
    pm = microfacet.pdf(mat.dist, sample_alpha, m)

    wi_dot_m = jnp.sum(wi * m, axis=-1)
    f, cos_t = fresnel.dielectric_reflectance(1.0 / mat.eta[..., 0], wi_dot_m)
    eta_m = jnp.where(wi_dot_m < 0.0, mat.eta[..., 0], 1.0 / mat.eta[..., 0])

    reflect = u0 < f
    wo_r = 2.0 * wi_dot_m[..., None] * m - wi
    wo_t = ((eta_m * wi_dot_m - sgn_e(wi_dot_m) * cos_t)[..., None] * m
            - eta_m[..., None] * wi)
    wo = jnp.where(reflect[..., None], wo_r, wo_t)
    wo_n = wo[..., 2]
    reflected = wi_n * wo_n > 0.0
    valid = (pm >= 1e-10) & (reflected == reflect)

    wo_dot_m = jnp.sum(wo * m, axis=-1)
    g = microfacet.G(mat.dist, alpha, wi, wo, m)
    d = microfacet.D(mat.dist, alpha, m)
    w = jnp.abs(wi_dot_m) * g * d / jnp.maximum(jnp.abs(wi_n) * pm, 1e-12)

    denom = jnp.square(eta * wi_dot_m + wo_dot_m)
    pdf_r = f * pm * 0.25 / jnp.maximum(jnp.abs(wi_dot_m), 1e-12)
    pdf_t = (1.0 - f) * pm * jnp.abs(wo_dot_m) / jnp.maximum(denom, 1e-12)
    pdf = jnp.where(reflect, pdf_r, pdf_t)
    lobe = jnp.where(reflect, GLOSSY_REFLECTION_LOBE,
                     GLOSSY_TRANSMISSION_LOBE).astype(jnp.int32)
    weight = w[..., None] * _absorption(mat, backside, ray_t)
    return BSDFSample(wo, pdf, weight, lobe, valid)


def _rough_dielectric_half(mat: MatProps, wi, wo):
    wi_n, wo_n = wi[..., 2], wo[..., 2]
    reflect = wi_n * wo_n >= 0.0
    eta = _rel_eta(mat, wi_n)
    m_r = sgn_e(wi_n)[..., None] * (wi + wo)
    m_t = -(wi * eta[..., None] + wo)
    m = jnp.where(reflect[..., None], m_r, m_t)
    m = normalize(m)  # NaN-free backward at m ~= 0
    return reflect, eta, m


def rough_dielectric_eval(mat: MatProps, wi, wo):
    reflect, eta, m = _rough_dielectric_half(mat, wi, wo)
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    wi_dot_m = jnp.sum(wi * m, axis=-1)
    wo_dot_m = jnp.sum(wo * m, axis=-1)
    f, _ = fresnel.dielectric_reflectance(1.0 / mat.eta[..., 0], wi_dot_m)
    g = microfacet.G(mat.dist, alpha, wi, wo, m)
    d = microfacet.D(mat.dist, alpha, m)
    wi_n = wi[..., 2]
    fx_r = f * g * d * 0.25 / jnp.maximum(jnp.abs(wi_n), 1e-12)
    denom = jnp.square(eta * wi_dot_m + wo_dot_m)
    fx_t = (jnp.abs(wi_dot_m * wo_dot_m) * (1.0 - f) * g * d
            / jnp.maximum(denom * jnp.abs(wi_n), 1e-12))
    fx = jnp.where(reflect, fx_r, fx_t)
    return fx[..., None] * mat.color


def rough_dielectric_pdf(mat: MatProps, wi, wo):
    reflect, eta, m = _rough_dielectric_half(mat, wi, wo)
    wi_n = wi[..., 2]
    sample_rough = (1.2 - 0.2 * jnp.sqrt(jnp.abs(wi_n))) * mat.roughness
    sample_alpha = microfacet.roughness_to_alpha(mat.dist, sample_rough)
    wi_dot_m = jnp.sum(wi * m, axis=-1)
    wo_dot_m = jnp.sum(wo * m, axis=-1)
    f, _ = fresnel.dielectric_reflectance(1.0 / mat.eta[..., 0], wi_dot_m)
    pm = microfacet.pdf(mat.dist, sample_alpha, m)
    pdf_r = f * pm * 0.25 / jnp.maximum(jnp.abs(wi_dot_m), 1e-12)
    denom = jnp.square(eta * wi_dot_m + wo_dot_m)
    pdf_t = (1.0 - f) * pm * jnp.abs(wo_dot_m) / jnp.maximum(denom, 1e-12)
    return jnp.where(reflect, pdf_r, pdf_t)


# ===========================================================================
# Coat: smooth dielectric clearcoat over rough-conductor substrate (Coat.cl)
# ===========================================================================

def coat_sample(mat: MatProps, wi, u0, u1, u2) -> BSDFSample:
    eta = 1.0 / COAT_IOR
    scaled_sigma_a = COAT_THICKNESS * COAT_SIGMA_A
    avg_transmittance = jnp.exp(-2.0 * scaled_sigma_a)

    fi, cos_ti = fresnel.dielectric_reflectance(eta, wi[..., 2])
    spec_prob = fi / (fi + avg_transmittance * (1.0 - fi))
    pick_spec = u0 < spec_prob

    # specular branch
    wo_s = reflect_local(wi)
    pdf_s = spec_prob
    w_s = (fi / jnp.maximum(spec_prob, 1e-12))[..., None]

    # substrate branch: refract wi into the coat, bounce off rough conductor
    wi_sub = jnp.stack([wi[..., 0] * eta, wi[..., 1] * eta, cos_ti], axis=-1)
    sub = rough_conductor_sample(mat, wi_sub, u1, u2)
    fo, cos_to = fresnel.dielectric_reflectance(COAT_IOR, sub.wo[..., 2])
    cos_sub = sub.wo[..., 2]
    wo_g = jnp.stack([
        sub.wo[..., 0] * COAT_IOR, sub.wo[..., 1] * COAT_IOR, cos_to
    ], axis=-1)
    w_g = sub.weight * ((1.0 - fi) * (1.0 - fo))[..., None]
    w_g = w_g / jnp.maximum(1.0 - spec_prob, 1e-12)[..., None]
    pdf_g = (sub.pdf * (1.0 - spec_prob) * eta * eta
             * cos_to / jnp.maximum(cos_sub, 1e-12))
    valid_g = sub.valid & (fo < 1.0)

    wo = jnp.where(pick_spec[..., None], wo_s, wo_g)
    pdf = jnp.where(pick_spec, pdf_s, pdf_g)
    weight = jnp.where(pick_spec[..., None], w_s, w_g)
    lobe = jnp.where(pick_spec, SPECULAR_REFLECTION_LOBE,
                     GLOSSY_REFLECTION_LOBE).astype(jnp.int32)
    valid = (wi[..., 2] > 0.0) & jnp.where(pick_spec, True, valid_g)
    return BSDFSample(wo, pdf, weight, lobe, valid)


def coat_eval(mat: MatProps, wi, wo):
    eta = 1.0 / COAT_IOR
    fi, cos_ti = fresnel.dielectric_reflectance(eta, wi[..., 2])
    refl = _check_reflection(wi, wo)
    fo, cos_to = fresnel.dielectric_reflectance(eta, wo[..., 2])
    wi_sub = jnp.stack([wi[..., 0] * eta, wi[..., 1] * eta,
                        jnp.copysign(cos_ti, wi[..., 2])], axis=-1)
    wo_sub = jnp.stack([wo[..., 0] * eta, wo[..., 1] * eta,
                        jnp.copysign(cos_to, wo[..., 2])], axis=-1)
    substrate = rough_conductor_eval(mat, wi_sub, wo_sub)
    laplacian = eta * eta * wo[..., 2] / jnp.maximum(cos_to, 1e-12)
    glossy = (laplacian * (1.0 - fi) * (1.0 - fo))[..., None] * substrate
    out = jnp.where(refl[..., None], fi[..., None] * jnp.ones_like(substrate),
                    glossy)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return jnp.where(ok[..., None], out, 0.0)


def coat_pdf(mat: MatProps, wi, wo):
    eta = 1.0 / COAT_IOR
    scaled_sigma_a = COAT_THICKNESS * COAT_SIGMA_A
    avg_transmittance = jnp.exp(-2.0 * scaled_sigma_a)
    fi, cos_ti = fresnel.dielectric_reflectance(eta, wi[..., 2])
    spec_prob = fi / (fi + avg_transmittance * (1.0 - fi))
    refl = _check_reflection(wi, wo)
    fo, cos_to = fresnel.dielectric_reflectance(eta, wo[..., 2])
    wi_sub = jnp.stack([wi[..., 0] * eta, wi[..., 1] * eta,
                        jnp.copysign(cos_ti, wi[..., 2])], axis=-1)
    wo_sub = jnp.stack([wo[..., 0] * eta, wo[..., 1] * eta,
                        jnp.copysign(cos_to, wo[..., 2])], axis=-1)
    sub_pdf = rough_conductor_pdf(mat, wi_sub, wo_sub)
    glossy = (sub_pdf * (1.0 - spec_prob) * eta * eta
              * jnp.abs(wo[..., 2] / jnp.maximum(cos_to, 1e-12)))
    p = jnp.where(refl, spec_prob, glossy)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return jnp.where(ok, p, 0.0)


# ===========================================================================
# Dispatch (bxdf.cl BSDF/BSDF2/BSDF_eval/BSDF_eval2/BSDF_pdf)
# ===========================================================================

def _select(mask, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    m1 = mask[..., None]
    return BSDFSample(
        jnp.where(m1, a.wo, b.wo),
        jnp.where(mask, a.pdf, b.pdf),
        jnp.where(m1, a.weight, b.weight),
        jnp.where(mask, a.lobe, b.lobe),
        jnp.where(mask, a.valid, b.valid),
    )


def sample(cfg: SceneConfig, mat: MatProps, wi, backside, ray_t,
           u0, u1, u2) -> BSDFSample:
    """Type-dispatched BSDF sampling with the eta^2 non-adjoint scaling."""
    n = wi.shape[:-1]
    out = BSDFSample(
        wo=jnp.zeros_like(wi),
        pdf=jnp.zeros(n, jnp.float32),
        weight=jnp.zeros_like(wi),
        lobe=jnp.zeros(n, jnp.int32),
        valid=jnp.zeros(n, bool),
    )
    t = mat.mat_type
    if cfg.has_mat(DIFF):
        out = _select((t & DIFF) != 0, lambert_sample(mat, wi, u1, u2), out)
    if cfg.has_mat(BURLEY):
        out = _select((t & BURLEY) != 0, burley_sample(mat, wi, u1, u2), out)
    if cfg.has_mat(COND):
        out = _select((t & COND) != 0, conductor_sample(mat, wi), out)
    if cfg.has_mat(ROUGH_COND):
        out = _select((t & ROUGH_COND) != 0,
                      rough_conductor_sample(mat, wi, u1, u2), out)
    if cfg.has_mat(DIEL):
        out = _select((t & DIEL) != 0,
                      dielectric_sample(mat, wi, backside, ray_t, u0), out)
    if cfg.has_mat(ROUGH_DIEL):
        out = _select((t & ROUGH_DIEL) != 0,
                      rough_dielectric_sample(mat, wi, backside, ray_t,
                                              u0, u1, u2), out)
    if cfg.has_mat(COAT):
        out = _select((t & COAT) != 0, coat_sample(mat, wi, u0, u1, u2), out)

    # non-adjoint eta^2 radiance scaling on dielectric transmission
    # (bxdf.cl:118-143)
    if cfg.has_mat(DIEL) or cfg.has_mat(ROUGH_DIEL):
        eta_scale = _eta_for(cfg, mat, wi, out.wo)
        out = out._replace(weight=out.weight * jnp.square(eta_scale)[..., None])
    return out


def _eta_for(cfg: SceneConfig, mat: MatProps, wi, wo):
    t = mat.mat_type
    eta = jnp.ones(wi.shape[:-1], jnp.float32)
    is_diel = (t & (DIEL | ROUGH_DIEL)) != 0
    e = dielectric_eta(mat, wi, wo)
    return jnp.where(is_diel, e, eta)


def evaluate(cfg: SceneConfig, mat: MatProps, wi, wo,
             backside=None, ray_t=None) -> jnp.ndarray:
    """f(wi,wo)*cos with eta^2 scaling (BSDF_eval2 non-adjoint)."""
    t = mat.mat_type
    f = jnp.zeros_like(wi)
    if cfg.has_mat(DIFF):
        f = jnp.where(((t & DIFF) != 0)[..., None], lambert_eval(mat, wi, wo), f)
    if cfg.has_mat(BURLEY):
        f = jnp.where(((t & BURLEY) != 0)[..., None], burley_eval(mat, wi, wo), f)
    if cfg.has_mat(COND):
        f = jnp.where(((t & COND) != 0)[..., None], conductor_eval(mat, wi, wo), f)
    if cfg.has_mat(ROUGH_COND):
        f = jnp.where(((t & ROUGH_COND) != 0)[..., None],
                      rough_conductor_eval(mat, wi, wo), f)
    if cfg.has_mat(DIEL):
        f = jnp.where(((t & DIEL) != 0)[..., None],
                      dielectric_eval(mat, wi, wo), f)
    if cfg.has_mat(ROUGH_DIEL):
        f = jnp.where(((t & ROUGH_DIEL) != 0)[..., None],
                      rough_dielectric_eval(mat, wi, wo), f)
    if cfg.has_mat(COAT):
        f = jnp.where(((t & COAT) != 0)[..., None], coat_eval(mat, wi, wo), f)
    if cfg.has_mat(DIEL) or cfg.has_mat(ROUGH_DIEL):
        f = f * jnp.square(_eta_for(cfg, mat, wi, wo))[..., None]
    return f


def pdf(cfg: SceneConfig, mat: MatProps, wi, wo) -> jnp.ndarray:
    t = mat.mat_type
    p = jnp.zeros(wi.shape[:-1], jnp.float32)
    if cfg.has_mat(DIFF):
        p = jnp.where((t & DIFF) != 0, lambert_pdf(wi, wo), p)
    if cfg.has_mat(BURLEY):
        p = jnp.where((t & BURLEY) != 0, lambert_pdf(wi, wo), p)
    if cfg.has_mat(COND):
        p = jnp.where((t & COND) != 0, conductor_pdf(wi, wo), p)
    if cfg.has_mat(ROUGH_COND):
        p = jnp.where((t & ROUGH_COND) != 0, rough_conductor_pdf(mat, wi, wo), p)
    if cfg.has_mat(DIEL):
        p = jnp.where((t & DIEL) != 0, dielectric_pdf(mat, wi, wo), p)
    if cfg.has_mat(ROUGH_DIEL):
        p = jnp.where((t & ROUGH_DIEL) != 0, rough_dielectric_pdf(mat, wi, wo), p)
    if cfg.has_mat(COAT):
        p = jnp.where((t & COAT) != 0, coat_pdf(mat, wi, wo), p)
    return p


def nee_capable(mat: MatProps) -> jnp.ndarray:
    """Materials whose lobes admit light sampling (base.cl:168)."""
    return (mat.lobes & ~(SPECULAR_LOBE | FORWARD_LOBE)) != 0
