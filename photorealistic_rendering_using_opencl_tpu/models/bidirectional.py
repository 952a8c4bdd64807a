"""Bidirectional path tracing, batched (whole subpath populations, no scatters).

The reference ships an EMPTY ``kernels/integrators/bidirectional.cl`` and
lists BDPT as future work (README.md:57); this module implements it.  The
design is wavefront-batched like the rest of the framework: every lane
owns one pixel sample, camera and light subpaths are generated into
fixed-depth [N, D, ...] arrays (python loop over the static depth), and
every (s, t) connection strategy is evaluated with a visibility ray --
contributions accumulate in-lane, so no scatters are needed.

Strategy set: all splits of a path with j surface vertices
(1 <= j <= max_bounces)

  * s = 0             : camera subpath hits the light directly
  * s = 1             : connect a camera vertex to a uniform-area light
                        sample (BDPT's NEE; area measure, not the
                        unidirectional tracer's solid-angle cap)
  * s >= 2            : connect a camera vertex to a light-subpath vertex

t = 0 / t = 1 lens strategies (light tracing splatted onto the image) are
EXCLUDED -- a pinhole/thin-lens splat needs image-space scatter-adds; the
MIS weights below renormalize over the included set, so the estimator
stays unbiased for every path the included strategies can sample (pure
specular-from-camera caustics are the classical loss).

MIS: balance heuristic over the included strategies, computed per
connection with the standard backward ratio walk over stored forward and
patched reverse AREA pdfs (Veach 10.2 / the classical recursive scheme).

Scope notes (documented, tested):
  * surface transport only (the global medium is ignored here; the
    unidirectional integrator handles media);
  * light-subpath BSDF transport omits the adjoint eta^2 correction, so
    transmissive-dielectric light subpaths are approximate; reflective
    scenes (the test scene set) are exact.

Reference semantics preserved where shared: emission/material model and
intersection all reuse the same ops as models/integrator.py.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.models.integrator import (
    CAMERA_DIMS, DIMS_PER_BOUNCE, gather_material,
)
from photorealistic_rendering_using_opencl_tpu.ops import bsdf as bsdf_ops
from photorealistic_rendering_using_opencl_tpu.ops.intersect import (
    intersect_scene, shadow_visible,
)
from photorealistic_rendering_using_opencl_tpu.ops.math import (
    PI, normalize, to_global, to_local,
)
from photorealistic_rendering_using_opencl_tpu.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu.ops.sampling import (
    cosine_hemisphere, uniform_sphere,
)
from photorealistic_rendering_using_opencl_tpu.scene.types import (
    LIGHT, QUAD, SceneConfig, SceneData, SPECULAR_LOBE, SPHERE,
)

_LIGHT_DIM0 = 4096  # RNG dim window for the light subpath (4-aligned)


class SubPath(NamedTuple):
    """Fixed-depth vertex arrays; index 0 = first stored vertex."""
    pos: jnp.ndarray      # [N,D,3]
    normal: jnp.ndarray   # [N,D,3] shading normal (faces the arriving ray)
    wi: jnp.ndarray       # [N,D,3] unit vector toward the PREVIOUS vertex
    beta: jnp.ndarray     # [N,D,3] throughput up to (and incl.) this vertex
    pdf_fwd: jnp.ndarray  # [N,D] area pdf of sampling this vertex forward
    pdf_rev: jnp.ndarray  # [N,D] area pdf of this vertex from the NEXT one
    mesh_id: jnp.ndarray  # [N,D]
    spec: jnp.ndarray     # [N,D] sampled lobe here was Dirac
    is_light: jnp.ndarray  # [N,D] vertex lies on an emitter
    valid: jnp.ndarray    # [N,D]


def _a(pdf_solid, from_pos, to_pos, to_normal):
    """Solid-angle pdf at from_pos -> area pdf at to_pos."""
    seg = to_pos - from_pos
    d2 = jnp.maximum(jnp.sum(seg * seg, axis=-1), 1e-12)
    w = seg / jnp.sqrt(d2)[..., None]
    return pdf_solid * jnp.abs(jnp.sum(w * to_normal, axis=-1)) / d2


def _light_area_and_emission(cfg: SceneConfig, scene: SceneData):
    li = scene.light_indices[0]
    gt = scene.geom_type[li]
    r = scene.params[li, 0]
    sphere_area = 4.0 * PI * r * r
    is_sphere = (gt & SPHERE) != 0
    area = jnp.where(is_sphere, sphere_area, scene.quad_area[li])
    return li, is_sphere, area, scene.color[li]


def sample_light_point(cfg: SceneConfig, scene: SceneData, u1, u2):
    """Uniform-area point on the NEE light -> (pos, normal, pdf_A, Le)."""
    li, is_sphere, area, le = _light_area_and_emission(cfg, scene)
    sd = uniform_sphere(u1, u2)
    sp = scene.position[li] + sd * scene.params[li, 0]
    anchor = (scene.quad_base[li]
              - (scene.quad_edge0[li] + scene.quad_edge1[li]) * 0.5)
    qp = (anchor + u1[..., None] * scene.quad_edge0[li]
          + u2[..., None] * scene.quad_edge1[li])
    pos = jnp.where(is_sphere, sp, qp)
    nrm = jnp.where(is_sphere, sd,
                    jnp.broadcast_to(scene.quad_normal[li], sd.shape))
    pdf_a = jnp.full(u1.shape, 1.0, jnp.float32) / area
    return pos, nrm, pdf_a, le


def gen_camera_subpath(cfg, scene, origin, direction, sampler_fn, depth):
    """Trace ``depth`` camera-side vertices (the lens vertex is implicit).

    sampler_fn(bounce) -> Sampler for that vertex's decisions.
    """
    n = origin.shape[0]
    recs = []
    pdf_rev = [jnp.zeros((n,), jnp.float32) for _ in range(depth)]
    o, d = origin, direction
    beta = jnp.ones((n, 3), jnp.float32)
    alive = jnp.ones((n,), bool)
    pdf_next_solid = jnp.ones((n,), jnp.float32)  # camera edge: common
    prev_pos = origin

    for i in range(depth):
        hit = intersect_scene(cfg, scene, o, d, active=alive)
        mat = gather_material(cfg, scene, hit.mesh_id)
        v_light = (mat.mat_type & LIGHT) != 0
        valid = alive & hit.valid

        pdf_fwd = jnp.where(
            jnp.asarray(i == 0), jnp.ones((n,), jnp.float32),
            _a(pdf_next_solid, prev_pos, hit.pos, hit.normal))

        smp = sampler_fn(i)
        u0, u1, u2 = smp.nextnd(3)
        wi_l = to_local(hit.normal, -d)
        samp = bsdf_ops.sample(cfg, mat, wi_l, hit.backside, hit.t,
                               u0, u1, u2)
        new_dir = to_global(hit.normal, samp.wo)
        spec = ((samp.lobe & SPECULAR_LOBE) != 0) & ~v_light

        if i > 0:
            # reverse pdf of the PREVIOUS vertex given this scatter
            pdf_rev_solid = bsdf_ops.pdf(cfg, mat, samp.wo, wi_l)
            pdf_rev[i - 1] = _a(pdf_rev_solid, hit.pos, prev_pos,
                                recs[i - 1][1])

        recs.append((hit.pos, hit.normal, -d, beta, pdf_fwd,
                     hit.mesh_id, spec, v_light, valid))

        beta = beta * jnp.where(valid[..., None], samp.weight, 1.0)
        alive = valid & ~v_light & samp.valid
        pdf_next_solid = samp.pdf
        prev_pos = o = hit.pos
        d = new_dir

    return _stack(recs, pdf_rev)


def gen_light_subpath(cfg, scene, pixel_idx, sample_idx, seed, rng_scheme,
                      depth):
    n = pixel_idx.shape[0]
    smp0 = Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                   dim=_LIGHT_DIM0)
    u1, u2, ud1, ud2 = smp0.nextnd(4)
    lpos, lnrm, pdf_a, le = sample_light_point(cfg, scene, u1, u2)

    recs = []
    pdf_rev = [jnp.zeros((n,), jnp.float32) for _ in range(depth)]
    beta = jnp.broadcast_to(le, (n, 3)) / pdf_a[..., None]
    recs.append((lpos, lnrm, lnrm, beta, pdf_a,
                 jnp.broadcast_to(scene.light_indices[0], (n,)),
                 jnp.zeros((n,), bool), jnp.ones((n,), bool),
                 jnp.ones((n,), bool)))

    # cosine emission direction (diffuse emitter)
    wo = cosine_hemisphere(ud1, ud2)
    d = to_global(lnrm, wo)
    pdf_dir = jnp.maximum(wo[..., 2], 1e-9) / PI
    # transport: Le picked up in beta[0]; directional term cos/pdf_dir
    beta = beta * (wo[..., 2] / jnp.maximum(pdf_dir, 1e-12))[..., None]
    o = lpos
    prev_pos = lpos
    pdf_next_solid = pdf_dir
    alive = jnp.ones((n,), bool)

    for i in range(1, depth):
        hit = intersect_scene(cfg, scene, o, d, active=alive)
        mat = gather_material(cfg, scene, hit.mesh_id)
        v_light = (mat.mat_type & LIGHT) != 0
        valid = alive & hit.valid & ~v_light  # light-path re-hit: drop

        pdf_fwd = _a(pdf_next_solid, prev_pos, hit.pos, hit.normal)

        smp = Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                      dim=_LIGHT_DIM0 + i * 4)
        u0, u1, u2 = smp.nextnd(3)
        wi_l = to_local(hit.normal, -d)
        samp = bsdf_ops.sample(cfg, mat, wi_l, hit.backside, hit.t,
                               u0, u1, u2)
        new_dir = to_global(hit.normal, samp.wo)
        spec = (samp.lobe & SPECULAR_LOBE) != 0

        pdf_rev_solid = bsdf_ops.pdf(cfg, mat, samp.wo, wi_l)
        prev_n = recs[i - 1][1]
        pdf_rev[i - 1] = _a(pdf_rev_solid, hit.pos, prev_pos, prev_n)

        recs.append((hit.pos, hit.normal, -d, beta, pdf_fwd,
                     hit.mesh_id, spec, v_light, valid))

        beta = beta * jnp.where(valid[..., None], samp.weight, 1.0)
        alive = valid & samp.valid
        pdf_next_solid = samp.pdf
        prev_pos = o = hit.pos
        d = new_dir

    return _stack(recs, pdf_rev)


def _stack(recs, pdf_rev):
    cols = list(zip(*recs))
    (pos, normal, wi, beta, pdf_fwd, mesh_id, spec, is_light,
     valid) = (jnp.stack(c, axis=1) for c in cols)
    return SubPath(pos, normal, wi, beta, pdf_fwd,
                   jnp.stack(pdf_rev, axis=1), mesh_id, spec, is_light,
                   valid)


def _remap0(x):
    return jnp.where(x > 0.0, x, 1.0)


def _mis_weight(cam: SubPath, lig: SubPath, s: int, t: int,
                pdf_rev_pt, pdf_rev_ptm, pdf_rev_qs, pdf_rev_qsm):
    """Balance-heuristic weight for strategy (s light, t camera vertices).

    pdf_rev_* are the junction patches (area pdfs); arrays [N].  Stored
    per-vertex pdf_rev entries hold "pdf of THIS vertex as seen from the
    next one along its own subpath"; patches replace the four entries
    adjacent to the junction.
    """
    sum_ri = jnp.zeros(pdf_rev_pt.shape, jnp.float32)

    # camera side: splits moving the junction toward the camera
    ri = jnp.ones_like(sum_ri)
    for i in range(t - 1, 0, -1):
        rev = pdf_rev_pt if i == t - 1 else (
            pdf_rev_ptm if i == t - 2 else cam.pdf_rev[:, i])
        ri = ri * _remap0(rev) / _remap0(cam.pdf_fwd[:, i])
        ok = ~cam.spec[:, i] & ~cam.spec[:, i - 1]
        sum_ri = sum_ri + jnp.where(ok, ri, 0.0)

    # light side: splits moving the junction toward the light
    ri = jnp.ones_like(sum_ri)
    for i in range(s - 1, -1, -1):
        rev = pdf_rev_qs if i == s - 1 else (
            pdf_rev_qsm if i == s - 2 else lig.pdf_rev[:, i])
        ri = ri * _remap0(rev) / _remap0(lig.pdf_fwd[:, i])
        prev_spec = lig.spec[:, i - 1] if i > 0 else jnp.zeros(
            sum_ri.shape, bool)
        ok = ~lig.spec[:, i] & ~prev_spec
        sum_ri = sum_ri + jnp.where(ok, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


DEFAULT_DEPTH_CAP = 6


def trace(cfg: SceneConfig, scene: SceneData, origin, direction,
          pixel_idx, sample_idx, seed=0, rng_scheme: str = "pcg4d",
          max_depth: int | None = None):
    """BDPT estimate per lane -> radiance [N,3].

    Path space matches the unidirectional integrator at equal budgets:
    paths with 1..b surface vertices ending on the light, where
    b = min(cfg.max_bounces, DEFAULT_DEPTH_CAP) unless ``max_depth``
    overrides it -- scenes with deeper budgets (cornell.json: 32) render
    a TRUNCATED path space by default, and ``pathtracer.render`` warns
    when that happens.
    """
    # BDPT cost is quadratic in depth (t_max * s_max connection
    # strategies, each with a shadow ray), so the DEFAULT caps at 6 --
    # deep specular budgets like cornell.json's 32 would compile ~33x32
    # strategies for negligible added light.  Pass max_depth explicitly to
    # go deeper.
    b = int(min(cfg.max_bounces, DEFAULT_DEPTH_CAP)
            if max_depth is None else max_depth)
    t_max = b + 1  # allow the s=0 strategy to reach the light
    s_max = b      # q0 on the light + up to b-1 surface vertices

    def cam_sampler(i):
        return Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                       dim=CAMERA_DIMS + i * DIMS_PER_BOUNCE)

    cam = gen_camera_subpath(cfg, scene, origin, direction, cam_sampler,
                             t_max)
    lig = gen_light_subpath(cfg, scene, pixel_idx, sample_idx, seed,
                            rng_scheme, s_max)
    li, is_sphere, area, le = _light_area_and_emission(cfg, scene)
    pdf_a_light = 1.0 / area

    n = origin.shape[0]
    acc = jnp.zeros((n, 3), jnp.float32)

    # ---------------- s = 0: camera path hits the light ------------------
    for t in range(2, t_max + 1):
        vi = t - 1
        on_light = cam.valid[:, vi] & cam.is_light[:, vi]
        # patches: pt.rev = area pdf of sampling this light point;
        # ptMinus.rev = emission-direction pdf at the light -> area at ptm
        pdf_rev_pt = jnp.full((n,), pdf_a_light)
        seg = cam.pos[:, vi - 1] - cam.pos[:, vi]
        dist = jnp.maximum(jnp.linalg.norm(seg, axis=-1), 1e-9)
        wdir = seg / dist[..., None]
        cos_l = jnp.abs(jnp.sum(wdir * cam.normal[:, vi], axis=-1))
        pdf_dir = cos_l / PI
        pdf_rev_ptm = _a(pdf_dir, cam.pos[:, vi], cam.pos[:, vi - 1],
                         cam.normal[:, vi - 1])
        w = _mis_weight(cam, lig, 0, t, pdf_rev_pt, pdf_rev_ptm,
                        jnp.ones((n,)), jnp.ones((n,)))
        # a path ending on a light other than the NEE light (base.cl:92
        # samples LIGHT_INDICES[0] only) is samplable by NO other included
        # strategy: its weight is exactly 1
        is_nee_light = cam.mesh_id[:, vi] == li
        w = jnp.where(is_nee_light, w, 1.0)
        le_hit = gather_material(cfg, scene, cam.mesh_id[:, vi]).color
        contrib = cam.beta[:, vi] * le_hit
        acc = acc + jnp.where(on_light[..., None],
                              contrib * w[..., None], 0.0)

    # ---------------- s >= 1 connections ---------------------------------
    for t in range(1, t_max + 1):
        vi = t - 1
        p_ok = cam.valid[:, vi] & ~cam.is_light[:, vi] & ~cam.spec[:, vi]
        p_pos = cam.pos[:, vi]
        p_n = cam.normal[:, vi]
        p_mat = gather_material(cfg, scene, cam.mesh_id[:, vi])
        p_wi = to_local(p_n, cam.wi[:, vi])

        for s in range(1, s_max + 1):
            if (t - 1) + (s - 1) + 1 > b:  # surface-vertex budget
                continue
            qi = s - 1
            q_ok = lig.valid[:, qi] & (True if s == 1 else ~lig.spec[:, qi])
            q_pos = lig.pos[:, qi]
            q_n = lig.normal[:, qi]

            seg = q_pos - p_pos
            d2 = jnp.maximum(jnp.sum(seg * seg, axis=-1), 1e-12)
            dist = jnp.sqrt(d2)
            wdir = seg / dist[..., None]

            f_p = bsdf_ops.evaluate(cfg, p_mat, p_wi,
                                    to_local(p_n, wdir),
                                    jnp.zeros((n,), bool),
                                    jnp.full((n,), 1.0))
            cos_q = jnp.sum(-wdir * q_n, axis=-1)
            if s == 1:
                # emitter: radiance only into its front hemisphere
                f_q = jnp.where(cos_q[..., None] > 0.0, 1.0, 0.0)
                f_q_scale = jnp.abs(cos_q) / d2
            else:
                q_mat = gather_material(cfg, scene, lig.mesh_id[:, qi])
                q_wi = to_local(q_n, lig.wi[:, qi])
                f_q = bsdf_ops.evaluate(cfg, q_mat, q_wi,
                                        to_local(q_n, -wdir),
                                        jnp.zeros((n,), bool),
                                        jnp.full((n,), 1.0))
                f_q_scale = 1.0 / d2  # both cosines live in the two evals

            cand = p_ok & q_ok & (jnp.sum(f_p * f_p, axis=-1) > 0.0)
            vis = shadow_visible(cfg, scene, p_pos, wdir, dist, active=cand)

            contrib = (cam.beta[:, vi] * f_p * f_q * lig.beta[:, qi]
                       * f_q_scale[..., None])

            # --- junction pdf patches (area measure) ---
            # pt as sampled from q:
            if s == 1:
                cos_l = jnp.maximum(cos_q, 0.0)
                pdf_q_to_p = cos_l / PI  # emission dir pdf
            else:
                q_mat_pdf = bsdf_ops.pdf(cfg, q_mat, q_wi,
                                         to_local(q_n, -wdir))
                pdf_q_to_p = q_mat_pdf
            pdf_rev_pt = _a(pdf_q_to_p, q_pos, p_pos, p_n)
            # ptMinus as sampled from pt scattering backward:
            if t >= 2:
                pdf_p_back = bsdf_ops.pdf(cfg, p_mat,
                                          to_local(p_n, wdir), p_wi)
                pdf_rev_ptm = _a(pdf_p_back, p_pos, cam.pos[:, vi - 1],
                                 cam.normal[:, vi - 1])
            else:
                pdf_rev_ptm = jnp.ones((n,))
            # qs as sampled from p:
            pdf_p_to_q = bsdf_ops.pdf(cfg, p_mat, p_wi,
                                      to_local(p_n, wdir))
            pdf_rev_qs = _a(pdf_p_to_q, p_pos, q_pos, q_n)
            # qsMinus as sampled from qs scattering backward:
            if s >= 2:
                pdf_q_back = bsdf_ops.pdf(cfg, q_mat,
                                          to_local(q_n, -wdir), q_wi)
                pdf_rev_qsm = _a(pdf_q_back, q_pos, lig.pos[:, qi - 1],
                                 lig.normal[:, qi - 1])
            else:
                pdf_rev_qsm = jnp.ones((n,))

            w = _mis_weight(cam, lig, s, t, pdf_rev_pt, pdf_rev_ptm,
                            pdf_rev_qs, pdf_rev_qsm)
            take = (cand & vis)[..., None]
            acc = acc + jnp.where(take, contrib * w[..., None], 0.0)

    return acc
