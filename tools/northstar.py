"""Run the BASELINE north-star shape: cornell 1024^2 fwd+bwd at full depth.

BASELINE.md's target is 1024^2 x 256 spp fwd+bwd in under 10 s on 8
chips.  This tool measures the shape at low spp on the available device:

  * direct: value_and_grad of the mean-image loss over the whole 1024^2
    frame via trace_regen_scan (the bench path, 4x the bench lane count);
  * tiled:  the same loss accumulated over pixel tiles -- gradients are
    linear in the loss, so per-tile grads SUM to the full-frame grad
    exactly (embarrassingly parallel, no estimator change); this is the
    fallback if the direct shape OOMs, and the scaling story for any
    resolution.

Prints per-variant wall seconds, samples/s, temp memory, and the
projection to 256 spp.

Usage: python tools/northstar.py [spp] [tiles] [width]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_tiles = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    width = int(sys.argv[3]) if len(sys.argv) > 3 else 1024

    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu.utils.config import (
        enable_compile_cache,
    )

    enable_compile_cache()
    cfg, scene = load_scene("scenes/cornell.json")
    cam = default_camera(width, width).pytree()
    px, py = pathtracer.pixel_grid(width, width)
    n = width * width

    leaves, treedef = jax.tree_util.tree_flatten(scene)
    is_f = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.floating)
            for l in leaves]
    rest = [l for l, f in zip(leaves, is_f) if not f]
    f_leaves = [l for l, f in zip(leaves, is_f) if f]

    def scene_of(fl):
        it_f, it_r = iter(fl), iter(rest)
        merged = [next(it_f) if f else next(it_r) for f in is_f]
        return jax.tree_util.tree_unflatten(treedef, merged)

    def run_variant(label, px_s, py_s, iters):
        """Compile + time ONE tile-shaped fwd+bwd dispatch."""
        def loss(diff_args, pxa, pya):
            fl, cam_p = diff_args
            acc, _, completed = pathtracer.trace_regen_scan(
                cfg, scene_of(fl), cam_p, width, width, spp, pxa, pya, 3,
                iters)
            return jnp.sum(acc) / (3.0 * n), completed

        @jax.jit
        def vg(diff_args, pxa, pya):
            (val, completed), grad = jax.value_and_grad(
                loss, argnums=0, has_aux=True)(diff_args, pxa, pya)
            gsum = sum(jnp.sum(g)
                       for g in jax.tree_util.tree_leaves(grad))
            return val + gsum, completed

        t0 = time.perf_counter()
        compiled = vg.lower((f_leaves, cam), px_s, py_s).compile()
        compile_s = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        temp = getattr(mem, "temp_size_in_bytes", 0) if mem else 0
        print(f"{label}: compiled in {compile_s:.0f}s "
              f"temp={temp/1e9:.2f}GB iters={iters}", flush=True)
        return compiled

    def timed(compiled, args_list):
        def run():
            outs = [compiled(*a) for a in args_list]  # async dispatches
            tot, comp = 0.0, None
            for val, completed in outs:
                tot += float(val)
                comp = int(completed)
            return tot, comp

        run()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            _, comp = run()
            best = min(best, time.perf_counter() - t0)
        return best, comp

    # ---- tiled variant (always works) ----
    tile = n // n_tiles
    px_t = px.reshape(n_tiles, tile)
    py_t = py.reshape(n_tiles, tile)
    iters = pathtracer.calibrate_regen_iters(
        cfg, scene, cam, width, width, spp, seed=3,
        px=px_t[0], py=py_t[0])
    # one calibration serves all tiles: path-length statistics are
    # pixel-position-invariant at this scale; margin absorbs the rest
    try:
        ctile = run_variant(f"tiled x{n_tiles}", px_t[0], py_t[0], iters)
        args = [((f_leaves, cam), px_t[i], py_t[i])
                for i in range(n_tiles)]
        t_tiled, comp = timed(ctile, args)
        rate = n * spp / t_tiled
        print(f"tiled x{n_tiles}: {t_tiled:.2f}s for {width}^2 x {spp}spp "
              f"fwd+bwd = {rate:.0f} samples/s completed={comp}/{spp} "
              f"-> 256spp projection {t_tiled * 256 / spp:.0f}s/chip",
              flush=True)
    except Exception as e:
        print(f"tiled failed: {type(e).__name__}: {str(e)[:200]}",
              flush=True)

    # ---- direct full-frame variant ----
    try:
        cfull = run_variant("direct", px, py, iters)
        t_full, comp = timed(cfull, [((f_leaves, cam), px, py)])
        rate = n * spp / t_full
        print(f"direct: {t_full:.2f}s = {rate:.0f} samples/s "
              f"completed={comp}/{spp} "
              f"-> 256spp projection {t_full * 256 / spp:.0f}s/chip",
              flush=True)
    except Exception as e:
        print(f"direct failed: {type(e).__name__}: {str(e)[:200]}",
              flush=True)


if __name__ == "__main__":
    main()
