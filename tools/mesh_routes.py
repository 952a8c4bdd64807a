"""Time the GPU mesh routes against each other, per dispatch and end to end.

    python tools/mesh_routes.py                 # on a GPU
    python tools/mesh_routes.py --rehearse      # CPU, tiny, interpret mode

Routes: the Triton kernel (mesh_accel="brute" on a GPU), the plain XLA
reference (mesh_accel="reference") and the skip-link BVH walk
(mesh_accel="bvh").  For each scene:

  * per dispatch: chip_smoke's phase-1 population (2 x W^2 mixed
    closest/any-hit rays), every route, a sweep of kernel block shapes,
    the walk with and without its lane chunking, and mesh_closest (the
    kernel behind block-coherence ray sorting);
  * end to end: the forward frame (render method="regen") and the fwd+bwd
    of chip_smoke's phase 3, per route (the reference only up to
    --ref-e2e-max-tris, past which its per-dispatch time rules it out).

Every line names the card and its power limit.  The JSON summary goes to
chiprun_out/mesh_routes.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

SWEEP = ((16, 32, 2), (32, 16, 4), (32, 32, 2), (32, 32, 4), (32, 64, 4),
         (64, 32, 4))


def best_of(fn, reps: int):
    """(min seconds over reps, first-call seconds incl. compilation)."""
    _, first = chip_smoke.timed(fn)
    return min(chip_smoke.timed(fn)[1] for _ in range(reps)), first


def compile_then_run(jitted, *args):
    """(seconds of one run, seconds of ahead-of-time compilation)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    return chip_smoke.timed(compiled, *args)[1], t_compile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes",
                    default="scenes/cornell.json,scenes/cornell_hi.json")
    ap.add_argument("--width", type=int, default=512,
                    help="dispatch population: 2 x width^2 rays")
    ap.add_argument("--frame", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--fb-spp", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions per dispatch measurement")
    ap.add_argument("--ref-e2e-max-tris", type=int, default=16384)
    ap.add_argument("--sweep", default=None,
                    help="kernel shapes to sweep, e.g. 16x32w2,32x32w4")
    ap.add_argument("--e2e-routes", default="brute,reference,bvh")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal: tiny sizes, kernel in interpret "
                         "mode; its times are not device times")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops import (
        intersect, mesh_brute,
    )
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        load_scene,
    )
    from photorealistic_rendering_using_opencl_tpu.utils.config import (
        enable_compile_cache,
    )

    dev = jax.devices()[0]
    if args.rehearse:
        card = "CPU rehearsal, not a device time"
        sweep = SWEEP[:2]
        e2e_routes = ("bvh",)
    else:
        if dev.platform != "gpu":
            print(f"mesh_routes: needs a GPU, JAX found {dev.platform!r}",
                  file=sys.stderr)
            return 1
        card = chip_smoke.card_info()
        sweep = SWEEP
        if args.sweep:
            sweep = [tuple(int(x) for x in s.replace("w", "x").split("x"))
                     for s in args.sweep.split(",")]
        e2e_routes = tuple(args.e2e_routes.split(","))
        enable_compile_cache()
    chip_smoke.CARD = card

    def log(what, secs, first=None, first_is="first call"):
        extra = "" if first is None else f" ({first_is} {first:.3f} s)"
        chip_smoke.log(f"{what}: {secs * 1e3:.3f} ms{extra} [{card}]")

    summary = {"card": card, "device_kind": dev.device_kind, "scenes": {}}
    for path in args.scenes.split(","):
        cfg, scene = load_scene(path)
        res = summary["scenes"][path] = {"triangles": cfg.n_triangles}
        tag = f"{os.path.basename(path)} ({cfg.n_triangles} tris)"
        pop = [jnp.asarray(x) for x in
               chip_smoke.ray_population(cfg, scene, args.width)]
        o, d, t0, act, ah, ex = pop
        feat, cl = scene.bf_feat, scene.bf_clusters
        nrays = o.shape[0]

        # ---- per dispatch ----
        for br, st, nw in sweep:
            f = jax.jit(lambda *a, br=br, st=st, nw=nw:
                        mesh_brute._intersect_triton(
                            *a[:6], any_hit=a[6], exclude=a[7],
                            interpret=args.rehearse, block_rays=br,
                            step_tris=st, num_warps=nw))
            t, first = best_of(lambda: f(feat, cl, *pop), args.reps)
            res[f"kernel_{br}x{st}w{nw}_ms"] = 1e3 * t
            log(f"{tag} dispatch {nrays} rays kernel {br}x{st} "
                f"warps={nw}", t, first)
        f = jax.jit(lambda *a: mesh_brute._intersect_xla(
            *a[:6], exclude=a[7]))
        t, first = best_of(lambda: f(feat, cl, *pop), args.reps)
        res["reference_ms"] = 1e3 * t
        log(f"{tag} dispatch {nrays} rays reference", t, first)
        chunk = intersect.TRAVERSE_CHUNK
        for ch in (chunk, 1 << 30):
            intersect.TRAVERSE_CHUNK = ch
            f = jax.jit(lambda o, d, t0, act, ah: intersect.bvh_traverse(
                scene, o, d, t0, any_hit=ah, active=act))
            t, first = best_of(lambda: f(o, d, t0, act, ah), args.reps)
            label = f"chunk{ch}" if ch == chunk else "unchunked"
            res[f"walk_{label}_ms"] = 1e3 * t
            log(f"{tag} dispatch {nrays} rays walk {label}", t, first)
        intersect.TRAVERSE_CHUNK = chunk
        if not args.rehearse:
            c = dataclasses.replace(cfg, mesh_accel="brute")
            f = jax.jit(lambda o, d, t0, act, ah, ex: intersect.mesh_closest(
                c, scene, o, d, t0, any_hit=ah, active=act,
                exclude_tri=ex)[1])
            t, first = best_of(lambda: f(*pop), args.reps)
            res["mesh_closest_ms"] = 1e3 * t
            log(f"{tag} mesh_closest {nrays} rays (sorted kernel)", t, first)

        # ---- end to end ----
        w = 16 if args.rehearse else args.frame
        spp = 2 if args.rehearse else args.spp
        fb_spp = 1 if args.rehearse else args.fb_spp
        cam = default_camera(w, w).pytree()
        routes = [r for r in e2e_routes
                  if r != "reference"
                  or cfg.n_triangles <= args.ref_e2e_max_tris]
        regen_iters = None
        for name in routes:
            c = dataclasses.replace(cfg, mesh_accel=name)
            # the scene goes in as a flat leaf list: ahead-of-time
            # compiled calls re-check the argument tree
            leaves, treedef = jax.tree_util.tree_flatten(scene)
            fwd = jax.jit(lambda lv, cam, c=c: pathtracer.render(
                c, treedef.unflatten(lv), cam, w, w, spp, seed=1,
                method="regen"))
            t, t_c = compile_then_run(fwd, leaves, cam)
            res[f"forward_{name}_s"] = t
            log(f"{tag} forward {w}^2 x {spp} spp route={name}", t, t_c,
                "compile")
            vg, fb_args, regen_iters = pathtracer.make_frame_value_and_grad(
                c, scene, cam, w, fb_spp, regen_iters=regen_iters)
            t, t_c = compile_then_run(vg, fb_args)
            res[f"fwd_bwd_{name}_s"] = t
            log(f"{tag} fwd+bwd {w}^2 x {fb_spp} spp route={name} "
                f"({regen_iters} iterations)", t, t_c, "compile")

    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/mesh_routes.json", "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
