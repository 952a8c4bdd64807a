"""Multi-chip rendering: shard pixels over a device mesh, replicate the scene.

The reference is strictly single-device (one OpenCL work item per pixel,
``src/main.cpp:370``; SURVEY §2.4).  Here the same SPMD program runs on every
chip: the flat pixel batch is sharded over a 1-D ``rays`` mesh axis (tiles x
samples stay shard-local), the scene/BVH/env-map pytree is replicated in
every chip's HBM, and the only cross-chip traffic is

  * nothing at all for forward rendering (each shard owns its pixels), and
  * one ``psum`` over the mesh for parameter gradients in ``train_step``
    (the gradient all-reduce the BASELINE north star calls for).

Counter-based RNG keyed on the *global* pixel id makes the image bitwise
independent of the device count.
"""
from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from photorealistic_rendering_using_opencl_tpu.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu.ops import camera_rays
from photorealistic_rendering_using_opencl_tpu.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu.scene.types import SceneConfig, SceneData

RAYS_AXIS = "rays"


def default_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (RAYS_AXIS,))


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _render_block(cfg: SceneConfig, width, height, spp, rng_scheme,
                  scene: SceneData, cam, px, py, seed,
                  method: str = "scan"):
    """Per-shard body: render `spp` samples for this shard's pixel slice."""
    pixel_idx = py.astype(jnp.uint32) * width + px.astype(jnp.uint32)

    def body(carry, sample_idx):
        acc, aac = carry
        sample_arr = jnp.broadcast_to(sample_idx, pixel_idx.shape)
        origin, direction = pathtracer.camera_rays_for_sample(
            cam, width, height, px, py, pixel_idx, sample_arr, seed,
            rng_scheme, True)
        rad, alpha = integrator.trace(cfg, scene, origin, direction,
                                      pixel_idx, sample_arr, seed=seed,
                                      rng_scheme=rng_scheme, method=method)
        return (acc + rad, aac + alpha), None

    n = px.shape[0]
    (acc, aac), _ = jax.lax.scan(
        body, (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n,), jnp.float32)),
        jnp.arange(spp, dtype=jnp.uint32))
    return acc / spp, aac / spp


@functools.partial(jax.jit,
                   static_argnames=("cfg", "width", "height", "spp",
                                    "rng_scheme", "mesh"))
def render_sharded(cfg: SceneConfig, scene: SceneData, cam: Any,
                   width: int, height: int, spp: int, mesh: Mesh,
                   seed=0, rng_scheme: str = "pcg4d"):
    """Full frame over the mesh -> (hdr [H,W,3], alpha [H,W]).

    Pixels are padded to a multiple of the mesh size and sharded; every
    other operand is replicated.  No collective is needed: the gathered
    output shards tile the image exactly.
    """
    n_dev = mesh.devices.size
    n = width * height
    n_pad = _pad_to(n, n_dev)
    px, py = pathtracer.pixel_grid(width, height)
    px = jnp.pad(px, (0, n_pad - n))
    py = jnp.pad(py, (0, n_pad - n))

    def _shard_body(scene, cam, px, py, seed):
        # path-regeneration loop per shard (fastest forward path); pixel
        # slices keep the counter-based RNG keyed on GLOBAL pixel ids, so
        # the image is bitwise independent of the device count
        return pathtracer.trace_regen(cfg, scene, cam, width, height, spp,
                                      px, py, seed, rng_scheme)

    fn = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(RAYS_AXIS), P(RAYS_AXIS), P()),
        out_specs=(P(RAYS_AXIS), P(RAYS_AXIS)),
        # while_loop carries mix shard-varying ray state with fresh
        # constants; disable the vma replication checker (no collectives
        # are needed in the forward path anyway).
        check_vma=False,
    )
    seed = jnp.asarray(seed, jnp.uint32)
    rad, alpha = fn(scene, cam, px, py, seed)
    img = rad[:n].reshape(height, width, 3)
    a = alpha[:n].reshape(height, width)
    return img, a


# ---------------------------------------------------------------------------
# Differentiable training step with a gradient all-reduce
# ---------------------------------------------------------------------------

def make_train_step(cfg: SceneConfig, width: int, height: int, spp: int,
                    mesh: Mesh, rng_scheme: str = "pcg4d", lr: float = 1e-2,
                    param_leaves=("color", "obj_color", "medium_sigma_a",
                                  "medium_sigma_s", "medium_sigma_t")):
    """Build a jitted SPMD step: render -> L2 loss vs target -> psum grads.

    Gradients flow through the detached-sampling estimator (pdf-weighted
    contributions); discrete sampling decisions take zero gradient, the
    BASELINE-scoped semantics.  Parameter gradients are `psum` over the
    mesh -- the all-reduce the north star requires -- and a plain SGD
    update keeps every replica's scene bitwise identical.
    """
    n_dev = mesh.devices.size
    n = width * height
    n_pad = _pad_to(n, n_dev)

    def _shard_body(scene, cam, px, py, target, seed):
        rad, _ = _render_block(cfg, width, height, spp, rng_scheme,
                               scene, cam, px, py, seed)
        # local sum-of-squares; global mean needs the psum'd count
        return jnp.sum(jnp.square(rad - target))

    def _loss(params, scene, cam, px, py, target, seed):
        import dataclasses
        scene = dataclasses.replace(scene, **params)
        local = _shard_body(scene, cam, px, py, target, seed)
        return jax.lax.psum(local, RAYS_AXIS) / (n_pad * 3)

    def _grad_step(scene, cam, px, py, target, seed):
        # differentiate only the selected float leaves (ints stay static)
        params = {name: getattr(scene, name) for name in param_leaves}
        loss, grads = jax.value_and_grad(_loss)(params, scene, cam, px, py,
                                                target, seed)
        # Under check_vma=False the psum'd loss does NOT autodiff into the
        # correct replicated-parameter gradient: the loss-psum transpose
        # hands every shard its LOCAL pixels' gradient scaled by n_dev, so
        # out_specs=P() silently published shard 0's local gradient as the
        # step (caught by tools/spmd_audit.py: the compiled step moved only
        # the 4-byte loss scalar across chips).  The all-reduce over
        # parameter gradients must be explicit; /n_dev cancels the
        # transpose's replication factor.  tests/test_parallel_extra.py
        # pins update equality across device counts.
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, RAYS_AXIS) / n_dev, grads)
        new_scene = scene
        for name in param_leaves:
            v = getattr(new_scene, name)
            new_scene = _replace_leaf(new_scene, name, v - lr * grads[name])
        return loss, new_scene

    inner = shard_map(
        _grad_step, mesh=mesh,
        in_specs=(P(), P(), P(RAYS_AXIS), P(RAYS_AXIS), P(RAYS_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(scene: SceneData, cam, target_flat, seed):
        px, py = pathtracer.pixel_grid(width, height)
        px = jnp.pad(px, (0, n_pad - n))
        py = jnp.pad(py, (0, n_pad - n))
        tgt = jnp.pad(target_flat, ((0, n_pad - n), (0, 0)))
        return inner(scene, cam, px, py, tgt,
                     jnp.asarray(seed, jnp.uint32))

    return step


def _replace_leaf(scene: SceneData, name: str, value) -> SceneData:
    import dataclasses
    return dataclasses.replace(scene, **{name: value})
