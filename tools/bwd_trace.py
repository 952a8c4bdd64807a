"""Profile the fwd+bwd regen_scan frame and print the top device ops.

Captures an op-level jax.profiler trace of the full value_and_grad
dispatch so the expensive HLO ops can be named (fusion sources,
transposes, reductions, matmuls).  The trace lands in
chiprun_out/bwd_trace.  Usage:

    python tools/bwd_trace.py [width] [spp] [mode]

mode: "all" (default) grads w.r.t. every float leaf; "fwd" forward only
(the subtraction localizes the backward's ops); a comma field list
differentiates that subset.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from photorealistic_rendering_using_opencl_tpu.utils.config import (  # noqa: E402
    enable_compile_cache,
)

TRACE_DIR = "chiprun_out/bwd_trace"


def main():
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    mode = sys.argv[3] if len(sys.argv) > 3 else "all"
    enable_compile_cache()

    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene

    cfg, scene = load_scene("scenes/cornell.json")
    cam = default_camera(width, width).pytree()
    regen_iters = pathtracer.calibrate_regen_iters(
        cfg, scene, cam, width, width, spp, seed=3)
    px, py = pathtracer.pixel_grid(width, width)
    print(f"iters={regen_iters}")

    if mode == "fwd":
        leaves, treedef = jax.tree_util.tree_flatten(scene)

        def run_fn(leaves):
            sc = jax.tree_util.tree_unflatten(treedef, leaves)
            acc, _, _ = pathtracer.trace_regen_scan(
                cfg, sc, cam, width, width, spp, px, py, 3, regen_iters)
            return jnp.mean(acc)
        compiled = jax.jit(run_fn).lower(leaves).compile()
        arg = leaves

        def run():
            return float(compiled(arg))
    else:
        import dataclasses
        if mode == "all":
            leaves, treedef = jax.tree_util.tree_flatten(scene)
            is_f = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.floating)
                    for l in leaves]
            rest = [l for l, f in zip(leaves, is_f) if not f]

            def loss(f_leaves):
                it_f, it_r = iter(f_leaves), iter(rest)
                merged = [next(it_f) if f else next(it_r) for f in is_f]
                sc = jax.tree_util.tree_unflatten(treedef, merged)
                acc, _, _ = pathtracer.trace_regen_scan(
                    cfg, sc, cam, width, width, spp, px, py, 3, regen_iters)
                return jnp.mean(acc)
            arg = [l for l, f in zip(leaves, is_f) if f]
        else:
            names = mode.split(",")

            def loss(vals):
                sc = dataclasses.replace(scene, **dict(zip(names, vals)))
                acc, _, _ = pathtracer.trace_regen_scan(
                    cfg, sc, cam, width, width, spp, px, py, 3, regen_iters)
                return jnp.mean(acc)
            arg = [getattr(scene, n) for n in names]

        @jax.jit
        def vg(a):
            val, grad = jax.value_and_grad(loss)(a)
            return val + sum(jnp.sum(g)
                             for g in jax.tree_util.tree_leaves(grad))

        compiled = vg.lower(arg).compile()

        def run():
            return float(compiled(arg))

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    print(f"wall {wall:.3f}s")

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        run()

    files = glob.glob(TRACE_DIR + "/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace file found")
        return
    with gzip.open(files[0], "rt") as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("dur")]
    agg = {}
    for e in events:
        name = e.get("name", "?")
        agg[name] = agg.get(name, 0) + e["dur"]
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:45]
    total = sum(agg.values())
    print(f"total traced op-us {total}")
    for name, us in top:
        print(f"{us/1e3:9.2f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
