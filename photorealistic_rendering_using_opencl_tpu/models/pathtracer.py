"""Renderer front-end: full-frame renders, progressive accumulation, AOVs.

The flagship "model".  Replaces the reference's per-frame host loop +
megakernel relaunch (``src/main.cpp:247-302``, ``kernels/main.cl:66-163``)
with two jitted entry points:

  * ``render``: scan over samples, each sample a full path trace
    (models/integrator.py), returning the converged HDR image.
  * ``progressive_step``: one sample for every pixel, accumulating into a
    persistent ``ProgressiveState`` -- exact parity with the reference's
    interactive accumulate/reset cycle (src/main.cpp:283-302), checkpoint-
    able as a pytree (SURVEY §5 checkpoint/resume).

Debug AOVs mirror the VIEW_* compile options of kernels/main.cl:4-13.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.models import integrator
from photorealistic_rendering_using_opencl_tpu.ops import camera_rays, intersect
from photorealistic_rendering_using_opencl_tpu.ops.intersect import intersect_scene
from photorealistic_rendering_using_opencl_tpu.ops.math import RAY_INF
from photorealistic_rendering_using_opencl_tpu.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu.scene.types import SceneConfig, SceneData


def pixel_grid(width: int, height: int):
    px = jnp.tile(jnp.arange(width, dtype=jnp.int32), height)
    py = jnp.repeat(jnp.arange(height, dtype=jnp.int32), width)
    return px, py


def camera_rays_for_sample(cam_pytree, width, height, px, py, pixel_idx,
                           sample_idx, seed, rng_scheme="pcg4d",
                           jitter=True):
    sampler = Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                      dim=0)  # camera owns dims [0, 8)
    jx, jy = sampler.next2d()
    a1, a2 = sampler.next2d()
    return camera_rays.generate_rays(cam_pytree, width, height, px, py,
                                     (jx, jy), (a1, a2), jitter=jitter)


def render_sample(cfg: SceneConfig, scene: SceneData, cam_pytree,
                  width: int, height: int, sample_idx, seed=0,
                  rng_scheme: str = "pcg4d", jitter: bool = True,
                  method: str = "scan", bdpt_max_depth: int | None = None):
    """One sample per pixel -> (radiance [N,3], alpha [N])."""
    px, py = pixel_grid(width, height)
    pixel_idx = py.astype(jnp.uint32) * width + px.astype(jnp.uint32)
    sample_arr = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.uint32),
                                  pixel_idx.shape)
    origin, direction = camera_rays_for_sample(
        cam_pytree, width, height, px, py, pixel_idx, sample_arr, seed,
        rng_scheme, jitter)
    if method == "bdpt":
        from photorealistic_rendering_using_opencl_tpu.models import bidirectional
        eff = (bidirectional.DEFAULT_DEPTH_CAP if bdpt_max_depth is None
               else bdpt_max_depth)
        if eff < cfg.max_bounces:
            import warnings
            warnings.warn(
                f"BDPT depth {eff} truncates the scene's max_bounces="
                f"{cfg.max_bounces} path space (cost is quadratic in "
                f"depth); pass bdpt_max_depth to go deeper",
                stacklevel=2)
        rad = bidirectional.trace(cfg, scene, origin, direction, pixel_idx,
                                  sample_arr, seed=seed,
                                  rng_scheme=rng_scheme,
                                  max_depth=bdpt_max_depth)
        return rad, jnp.ones(rad.shape[:1], jnp.float32)
    return integrator.trace(cfg, scene, origin, direction, pixel_idx,
                            sample_arr, seed=seed, rng_scheme=rng_scheme,
                            method=method)


@functools.partial(jax.jit, static_argnames=("cfg", "width", "height", "spp",
                                             "rng_scheme", "jitter",
                                             "method", "regen_iters",
                                             "bdpt_max_depth"))
def render(cfg: SceneConfig, scene: SceneData, cam_pytree,
           width: int, height: int, spp: int, seed=0,
           rng_scheme: str = "pcg4d", jitter: bool = True,
           method: str = "scan", regen_iters: int = 0,
           bdpt_max_depth: int | None = None):
    """Full render -> (hdr [H,W,3], alpha [H,W]).

    method="scan" is reverse-mode differentiable; method="while" runs the
    per-sample early-exit loop; method="regen" (fastest, forward-only)
    regenerates each lane's next sample the moment its path dies, so lane
    occupancy stays ~100% instead of every sample batch paying the
    worst-lane path length; method="regen_scan" is the differentiable
    regen driver (pass ``regen_iters`` from ``calibrate_regen_iters``).
    All produce bit-identical radiance per (pixel, sample): the RNG is
    counter-keyed, not schedule-keyed.
    """
    if method == "regen":
        return _render_regen(cfg, scene, cam_pytree, width, height, spp,
                             seed, rng_scheme, jitter)
    if method == "regen_scan":
        if regen_iters <= 0:
            raise ValueError("method='regen_scan' needs regen_iters > 0 "
                             "(see calibrate_regen_iters)")
        px, py = pixel_grid(width, height)
        acc, alpha, _ = trace_regen_scan(cfg, scene, cam_pytree, width,
                                         height, spp, px, py, seed,
                                         regen_iters, rng_scheme, jitter)
        return (acc.reshape(height, width, 3), alpha.reshape(height, width))

    def body(carry, sample_idx):
        acc, aac = carry
        rad, alpha = render_sample(cfg, scene, cam_pytree, width, height,
                                   sample_idx, seed, rng_scheme, jitter,
                                   method, bdpt_max_depth)
        return (acc + rad, aac + alpha), None

    n = width * height
    (acc, aac), _ = jax.lax.scan(
        body,
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n,), jnp.float32)),
        jnp.arange(spp, dtype=jnp.uint32))
    img = (acc / spp).reshape(height, width, 3)
    alpha = (aac / spp).reshape(height, width)
    return img, alpha


def _render_regen(cfg: SceneConfig, scene: SceneData, cam_pytree,
                  width: int, height: int, spp: int, seed,
                  rng_scheme: str, jitter: bool):
    px, py = pixel_grid(width, height)
    acc, alpha = trace_regen(cfg, scene, cam_pytree, width, height, spp,
                             px, py, seed, rng_scheme, jitter)
    return (acc.reshape(height, width, 3), alpha.reshape(height, width))


def _regen_carry0(n: int):
    """Initial regeneration-loop carry over ``n`` lanes (no lane has a
    path yet; the dummy hit shades as a no-op on iteration 0)."""
    state0 = integrator.init_state(jnp.zeros((n, 3), jnp.float32),
                                   jnp.zeros((n, 3), jnp.float32))
    state0 = state0._replace(alive=jnp.zeros((n,), bool))
    hit0 = intersect.Hit(
        t=jnp.full((n,), RAY_INF, jnp.float32),
        mesh_id=jnp.full((n,), -1, jnp.int32),
        pos=jnp.zeros((n, 3), jnp.float32),
        normal=jnp.zeros((n, 3), jnp.float32),
        backside=jnp.zeros((n,), bool),
        tri=jnp.full((n,), -1, jnp.int32),
    )
    return (
        state0,
        hit0,
        jnp.zeros((n,), jnp.uint32),  # cur_sample: path being traced
        jnp.ones((n,), bool),         # pending: cur_sample not yet started
        jnp.zeros((n,), jnp.uint32),  # bounce index within current path
        jnp.zeros((n,), jnp.float32),  # alpha bank
    )


def _regen_step(cfg: SceneConfig, scene: SceneData, cam_pytree,
                width: int, height: int, spp: int, px, py, pixel_idx,
                seed, rng_scheme: str, jitter: bool, carry):
    """One iteration of the path-regeneration loop (shared verbatim by the
    forward while-loop and the differentiable fixed-length scan, so the
    two schedules stay bit-identical estimators)."""
    state, hit, cur, pending, bounce, alpha_sum = carry
    n = pixel_idx.shape[0]

    # 1. shade the current vertex (no-op for lanes without a path)
    sampler = Sampler(pixel_idx, cur, seed=seed, scheme=rng_scheme,
                      dim=integrator.CAMERA_DIMS
                      + bounce * integrator.DIMS_PER_BOUNCE)
    was_alive = state.alive
    was_scatter = state.n_scatter
    state, nee = integrator.shade_step(cfg, scene, state, hit, sampler)
    excl = integrator._self_exclusion(cfg, hit, state, was_scatter)
    bounce = jnp.where(was_alive, bounce + 1, bounce)
    died = was_alive & ~state.alive
    alpha_sum = alpha_sum + jnp.where(died, state.alpha, 0.0)
    cur = jnp.where(died, cur + 1, cur)
    pending = pending | died

    # 2. regenerate: a freed lane starts its next sample THIS iteration
    # (its camera ray rides the same merged dispatch as everyone's
    # next-bounce rays -- zero idle iterations)
    regen = pending & (cur < spp)
    o, d = camera_rays_for_sample(cam_pytree, width, height, px, py,
                                  pixel_idx, cur, seed, rng_scheme,
                                  jitter)
    r1 = regen[..., None]
    f1 = jnp.ones((n,), jnp.float32)
    i0 = jnp.zeros((n,), jnp.int32)
    state = state._replace(
        origin=jnp.where(r1, o, state.origin),
        direction=jnp.where(r1, d, state.direction),
        mask=jnp.where(r1, 1.0, state.mask),
        alpha=jnp.where(regen, f1, state.alpha),
        alive=state.alive | regen,
        prev_pdf=jnp.where(regen, f1, state.prev_pdf),
        prev_specular=state.prev_specular | regen,  # main.cl:133
        prev_did_nee=state.prev_did_nee & ~regen,
        n_diff=jnp.where(regen, i0, state.n_diff),
        n_spec=jnp.where(regen, i0, state.n_spec),
        n_trans=jnp.where(regen, i0, state.n_trans),
        n_scatter=jnp.where(regen, i0, state.n_scatter),
        n_total=jnp.where(regen, i0, state.n_total),
    )
    pending = pending & ~regen
    bounce = jnp.where(regen, 0, bounce)
    if excl is not None:
        # per-segment exclusion: a regenerated lane's closest ray starts
        # from the camera (exclude nothing), but its NEE shadow rays were
        # sampled at the OLD path's terminal vertex and must still exclude
        # the triangle they originate on
        excl = ([jnp.where(regen, -1, excl)] + [excl] * len(nee)
                if nee else jnp.where(regen, -1, excl))

    # 3. ONE merged dispatch: next/camera closest-hit rays + NEE shadow
    hit, vis = intersect.intersect_and_shadow(
        cfg, scene, state.origin, state.direction, state.alive,
        [(b.origin, b.direction, b.dist, b.active) for b in nee],
        exclude_tri=excl)
    hit = integrator.tag_hit(hit)
    vis = [integrator.tag_hit(v) for v in vis]
    # 4. bank the deferred NEE light (acc is cumulative across samples)
    state = integrator.accumulate_nee(state, nee, vis)
    return (state, hit, cur, pending, bounce, alpha_sum)


def trace_regen(cfg: SceneConfig, scene: SceneData, cam_pytree,
                width: int, height: int, spp: int, px, py, seed,
                rng_scheme: str = "pcg4d", jitter: bool = True,
                return_iters: bool = False):
    """Path-regeneration render loop (forward only) over a pixel slice.

    Wavefront version of the reference's own execution model (main.cl:
    122-136: persistent per-pixel path state, terminated paths restart on
    the next launch): each lane owns one pixel, traces its samples
    back-to-back, and banks radiance into a per-lane accumulator -- no
    scatters, no compaction, full vector occupancy until the final tail.
    Total steps ~= spp * E[path length] + worst tail, vs the per-sample
    while-loop's spp * worst-lane length.

    ``px/py`` may be any flat pixel slice (the sharded path passes this
    shard's pixels).  Returns per-lane (radiance_mean [N,3], alpha [N]),
    plus the iteration count when ``return_iters`` (the calibration input
    for the differentiable ``trace_regen_scan``).
    """
    pixel_idx = py.astype(jnp.uint32) * width + px.astype(jnp.uint32)
    n = px.shape[0]
    n_steps = integrator.n_steps_for(cfg)
    max_iters = jnp.uint32(spp * n_steps + 64)  # hard safety bound
    carry0 = _regen_carry0(n) + (jnp.zeros((), jnp.uint32),)

    def cond(carry):
        state, _, cur, pending, _, _, it = carry
        work = state.alive | (pending & (cur < spp))
        return jnp.any(work) & (it < max_iters)

    def body(carry):
        out = _regen_step(cfg, scene, cam_pytree, width, height, spp,
                          px, py, pixel_idx, seed, rng_scheme, jitter,
                          carry[:-1])
        return out + (carry[-1] + 1,)

    state, _, _, _, _, alpha_sum, it = jax.lax.while_loop(cond, body, carry0)
    if return_iters:
        return state.acc / spp, alpha_sum / spp, it
    return state.acc / spp, alpha_sum / spp


def trace_regen_scan(cfg: SceneConfig, scene: SceneData, cam_pytree,
                     width: int, height: int, spp: int, px, py, seed,
                     n_iters: int, rng_scheme: str = "pcg4d",
                     jitter: bool = True, remat: str = "body"):
    """Reverse-differentiable path regeneration: the same loop body as
    ``trace_regen`` run as a FIXED-length chunked ``lax.scan``.

    This closes the differentiable path's occupancy gap:
    ``integrator.trace(method="scan")`` advances all
    lanes through the full ``max_bounces + scatter`` budget per sample
    (cornell: 32+ steps while most paths die by ~8 under RR), whereas this
    driver keeps every lane busy on its NEXT sample the moment a path
    dies, so the step count is ~``spp * E[path length] + worst tail``
    instead of ``spp * budget`` -- the regen forward win, now under AD.

    ``n_iters`` must be static; size it with ``calibrate_regen_iters``
    (the forward while-loop's measured trip count plus margin, rounded to
    ``SCAN_CHUNK``).  With sufficient ``n_iters`` the result is the SAME
    estimator as regen/while/scan (counter-keyed RNG); surplus iterations
    are no-ops (all lanes idle -> the mesh search skips every cluster).  If
    ``n_iters`` is too small, unfinished samples' partial radiance is
    still banked (matching ``trace_regen``'s continuous accumulation);
    callers check the returned ``completed`` (min finished-sample count
    over lanes) to detect under-budgeting.

    Returns (radiance_mean [N,3], alpha [N], completed [] uint32).
    """
    pixel_idx = py.astype(jnp.uint32) * width + px.astype(jnp.uint32)
    n = px.shape[0]
    carry0 = _regen_carry0(n)
    chunk = integrator.SCAN_CHUNK
    ckpt = functools.partial(
        jax.checkpoint,
        policy=jax.checkpoint_policies.save_only_these_names("hit"))

    def body(carry, _):
        out = _regen_step(cfg, scene, cam_pytree, width, height, spp,
                          px, py, pixel_idx, seed, rng_scheme, jitter,
                          carry)
        return integrator._sanitize_grad(out), None

    if n_iters <= chunk:
        carry, _ = jax.lax.scan(ckpt(body), carry0, None, length=n_iters)
    else:
        # deep iteration budgets: nested outer-scan-of-chunk-scans keeps
        # the differentiated program small (same structure + rationale as
        # integrator.trace's chunked scan); the budget rounds UP to a
        # chunk multiple -- surplus iterations are no-ops.
        #
        # remat="body" (default) checkpoints each iteration: the scans
        # save every per-iteration carry (~80 B/lane/iter of device
        # memory) plus the named "hit" records, and the backward re-runs
        # only one iteration's elementwise shading at a time.
        # remat="segment" moves the boundary to the WHOLE inner chunk (a
        # memory hypothesis; XLA rebuffers the recompute segment), opt-in
        # for sweeps only.
        n_outer = -(-n_iters // chunk)

        if remat == "segment":
            @ckpt
            def seg_body(carry, _):
                return jax.lax.scan(body, carry, None, length=chunk)[0], None
        else:
            body = ckpt(body)

            def seg_body(carry, _):
                return jax.lax.scan(body, carry, None, length=chunk)[0], None

        carry, _ = jax.lax.scan(seg_body, carry0, None, length=n_outer)

    state, _, cur, _, _, alpha_sum = carry
    completed = jnp.min(jnp.minimum(cur, jnp.uint32(spp)))
    return state.acc / spp, alpha_sum / spp, completed


def calibrate_regen_iters(cfg: SceneConfig, scene: SceneData, cam_pytree,
                          width: int, height: int, spp: int, seed=0,
                          rng_scheme: str = "pcg4d", jitter: bool = True,
                          margin: float = 1.05, px=None, py=None) -> int:
    """Measured iteration budget for ``trace_regen_scan``: run the forward
    while-loop once and return its trip count (x margin, rounded up to a
    SCAN_CHUNK multiple).  Stable across seeds/steps for a fixed scene --
    calibrate once, reuse for the whole optimization run."""
    if px is None:
        px, py = pixel_grid(width, height)

    @functools.partial(jax.jit, static_argnames=())
    def run(scene, cam, px, py):
        return trace_regen(cfg, scene, cam, width, height, spp, px, py,
                           seed, rng_scheme, jitter, return_iters=True)[2]

    it = int(jax.device_get(run(scene, cam_pytree, px, py)))
    chunk = integrator.SCAN_CHUNK
    return -(-max(int(it * margin), 1) // chunk) * chunk


def make_frame_value_and_grad(cfg: SceneConfig, scene: SceneData,
                              cam_pytree, width: int, spp: int, seed=3,
                              regen_iters: int | None = None):
    """(jitted fn, args, regen_iters) for value_and_grad of the mean
    width^2 image w.r.t. every float scene leaf plus the camera pytree,
    through ``trace_regen_scan`` at the scene's full bounce budget.

    ``fn(args)`` returns (mean radiance, completed samples, gradients);
    the scene's int/bool tables (geometry types, BVH links) ride along
    undifferentiated.  ``regen_iters`` defaults to a calibrated budget.
    """
    if regen_iters is None:
        regen_iters = calibrate_regen_iters(cfg, scene, cam_pytree, width,
                                            width, spp, seed=seed)
    px, py = pixel_grid(width, width)
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    is_f = [jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            for x in leaves]
    f_leaves = [x for x, f in zip(leaves, is_f) if f]
    rest = [x for x, f in zip(leaves, is_f) if not f]

    def loss(args):
        f_l, cam = args
        it_f, it_r = iter(f_l), iter(rest)
        sc = jax.tree_util.tree_unflatten(
            treedef, [next(it_f) if f else next(it_r) for f in is_f])
        acc, _, completed = trace_regen_scan(cfg, sc, cam, width, width,
                                             spp, px, py, seed, regen_iters)
        return jnp.mean(acc), completed

    @jax.jit
    def value_and_grad(args):
        (val, completed), grad = jax.value_and_grad(loss, has_aux=True)(args)
        return val, completed, grad

    return value_and_grad, (f_leaves, cam_pytree), regen_iters


# ---------------------------------------------------------------------------
# Progressive (interactive-parity) API
# ---------------------------------------------------------------------------

class ProgressiveState(NamedTuple):
    acc: jnp.ndarray  # [H,W,3] radiance sum
    alpha: jnp.ndarray  # [H,W] alpha sum
    samples: jnp.ndarray  # [] uint32 accumulated sample count
    seed: jnp.ndarray  # [] uint32


def progressive_init(width: int, height: int, seed: int = 0
                     ) -> ProgressiveState:
    return ProgressiveState(
        acc=jnp.zeros((height, width, 3), jnp.float32),
        alpha=jnp.zeros((height, width), jnp.float32),
        samples=jnp.zeros((), jnp.uint32),
        seed=jnp.asarray(seed, jnp.uint32),
    )


def progressive_reset(state: ProgressiveState) -> ProgressiveState:
    """Camera-moved reset (src/main.cpp:283-290 buffer_reset)."""
    return ProgressiveState(
        acc=jnp.zeros_like(state.acc), alpha=jnp.zeros_like(state.alpha),
        samples=jnp.zeros_like(state.samples), seed=state.seed)


@functools.partial(jax.jit, static_argnames=("cfg", "rng_scheme"))
def progressive_step(cfg: SceneConfig, scene: SceneData, cam_pytree,
                     state: ProgressiveState, rng_scheme: str = "pcg4d"
                     ) -> ProgressiveState:
    height, width = state.acc.shape[0], state.acc.shape[1]
    # interactive accumulation never differentiates: take the early-exit path
    rad, alpha = render_sample(cfg, scene, cam_pytree, width, height,
                               state.samples, state.seed, rng_scheme,
                               method="while")
    return ProgressiveState(
        acc=state.acc + rad.reshape(height, width, 3),
        alpha=state.alpha + alpha.reshape(height, width),
        samples=state.samples + 1,
        seed=state.seed,
    )


def progressive_image(state: ProgressiveState):
    s = jnp.maximum(state.samples.astype(jnp.float32), 1.0)
    return state.acc / s, state.alpha / s


# ---------------------------------------------------------------------------
# Debug AOVs (kernels/main.cl VIEW_NORMAL / VIEW_ALBEDO / VIEW_BVH_HIT)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "width", "height", "mode"))
def render_aov(cfg: SceneConfig, scene: SceneData, cam_pytree,
               width: int, height: int, mode: str = "normal", seed=0):
    """mode in {normal, albedo, depth, mesh_id, traversal}."""
    px, py = pixel_grid(width, height)
    pixel_idx = py.astype(jnp.uint32) * width + px.astype(jnp.uint32)
    sample_arr = jnp.zeros_like(pixel_idx)
    origin, direction = camera_rays_for_sample(
        cam_pytree, width, height, px, py, pixel_idx, sample_arr, seed,
        jitter=False)
    if mode == "traversal":
        # traversal-cost heatmap (VIEW_STACK_INDEX, kernels/main.cl:6-13):
        # normalized per frame so hotspots read directly
        from photorealistic_rendering_using_opencl_tpu.ops.intersect import (
            traversal_cost,
        )
        steps = traversal_cost(cfg, scene, origin, direction)
        h = steps.astype(jnp.float32) / jnp.maximum(
            jnp.max(steps).astype(jnp.float32), 1.0)
        out = jnp.stack([h, 1.0 - h, jnp.zeros_like(h)], axis=-1)
        return out.reshape(height, width, 3)
    hit = intersect_scene(cfg, scene, origin, direction)
    if mode == "normal":
        out = hit.normal * 0.5 + 0.5
    elif mode == "albedo":
        mat = integrator.gather_material(cfg, scene, hit.mesh_id)
        out = mat.color
    elif mode == "depth":
        out = jnp.broadcast_to(hit.t[..., None], hit.normal.shape)
    elif mode == "mesh_id":
        out = jnp.broadcast_to(
            (hit.mesh_id[..., None].astype(jnp.float32) + 1.0)
            / (cfg.n_objects + 2), hit.normal.shape)
    else:
        raise ValueError(mode)
    out = jnp.where(hit.valid[..., None], out, 0.0)
    return out.reshape(height, width, 3)
