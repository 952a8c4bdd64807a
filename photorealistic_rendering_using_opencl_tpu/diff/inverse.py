"""Inverse rendering: optimize differentiable scene parameters to a target.

The flagship "training" loop of the framework (the reference renderer has
no backward pass at all): render -> L2 image loss -> adam/SGD on any float
leaves of SceneData (material colors, medium sigmas, env map, camera).
Single-chip here; the sharded SPMD equivalent with psum'd gradients is
parallel/render.py:make_train_step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, NamedTuple

import jax
import jax.numpy as jnp

from photorealistic_rendering_using_opencl_tpu.models import pathtracer
from photorealistic_rendering_using_opencl_tpu.scene.types import (
    SceneConfig, SceneData,
)

DEFAULT_PARAM_LEAVES = ("color", "obj_color")


class FitResult(NamedTuple):
    scene: SceneData
    losses: jnp.ndarray  # [steps]


def image_loss(cfg: SceneConfig, scene: SceneData, cam, width: int,
               height: int, spp: int, target, seed=0,
               method: str = "scan", regen_iters: int = 0) -> jnp.ndarray:
    img, _ = pathtracer.render(cfg, scene, cam, width, height, spp,
                               seed=seed, method=method,
                               regen_iters=regen_iters)
    return jnp.mean(jnp.square(img - target))


def make_loss_fn(cfg: SceneConfig, scene: SceneData, cam, width: int,
                 height: int, spp: int, target,
                 param_leaves: Iterable[str] = DEFAULT_PARAM_LEAVES,
                 method: str = "scan", regen_iters: int = 0):
    """Returns loss(params_dict, seed) closing over the static scene."""

    def loss(params, seed):
        s = dataclasses.replace(scene, **params)
        return image_loss(cfg, s, cam, width, height, spp, target, seed,
                          method=method, regen_iters=regen_iters)

    return loss


def fit_scene(cfg: SceneConfig, scene: SceneData, cam, width: int,
              height: int, spp: int, target, steps: int = 50,
              lr: float = 5e-2,
              param_leaves: Iterable[str] = DEFAULT_PARAM_LEAVES,
              optimizer=None, method: str = "scan",
              regen_margin: float = 1.25) -> FitResult:
    """Gradient-descend the selected scene leaves toward the target image.

    Uses optax.adam when available (it is baked into the environment);
    falls back to plain SGD otherwise.  A fresh RNG seed per step keeps the
    MC gradient unbiased across the trajectory.

    ``method="regen_scan"`` runs the differentiable path-regeneration
    driver (fewer iterations than "scan": lanes regenerate as paths
    die): the iteration budget is calibrated ONCE on the initial
    scene with ``regen_margin`` headroom, so optimization trajectories
    that lengthen paths substantially (e.g. albedos driven toward 1)
    can under-run the budget -- partial radiance is still banked, but
    prefer "scan" (always-exact) when parameters move far.
    """
    param_leaves = tuple(param_leaves)
    params = {k: getattr(scene, k) for k in param_leaves}
    regen_iters = 0
    if method == "regen_scan":
        regen_iters = pathtracer.calibrate_regen_iters(
            cfg, scene, cam, width, height, spp, seed=1,
            margin=regen_margin)
    loss_fn = make_loss_fn(cfg, scene, cam, width, height, spp, target,
                           param_leaves, method=method,
                           regen_iters=regen_iters)

    if optimizer is None:
        import optax
        optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, seed):
        loss, grads = jax.value_and_grad(loss_fn)(params, seed)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        params = jax.tree_util.tree_map(
            lambda p: jnp.clip(p, 0.0, None), params)  # colors stay >= 0
        return params, opt_state, loss

    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(i + 1, jnp.uint32))
        losses.append(loss)
    return FitResult(dataclasses.replace(scene, **params),
                     jnp.stack(losses))
