"""Benchmark: cornell path-tracing throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Baseline (BASELINE.md north-star target): cornell 1024x1024 at 256 spp
forward+backward in <10 s on 8 chips => 3.355e6 pixel-samples/s/chip.
``vs_baseline`` is the measured fwd+bwd rate per chip over that target
rate (>1.0 means beating the target).

Each measurement is one warm-up call (compilation) followed by timed
calls that end in ``block_until_ready``.  Any failure exits non-zero; the
script refuses to run without a GPU.

Usage: python bench.py [--width 1024] [--spp 16] [--fb-spp 4] [--reps 2]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

BASELINE_SAMPLES_PER_SEC_PER_CHIP = 1024 * 1024 * 256 / 10.0 / 8.0


def _best(fn, reps: int) -> float:
    import jax
    jax.block_until_ready(fn())  # warm-up: compilation
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="scenes/cornell.json")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--fb-spp", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    import chip_smoke
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
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
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    card = chip_smoke.card_info()
    w = args.width
    cfg, scene = load_scene(args.scene)
    cam = default_camera(w, w).pytree()

    fwd_s = _best(lambda: pathtracer.render(cfg, scene, cam, w, w, args.spp,
                                            seed=1, method="regen"),
                  args.reps)
    img, _ = pathtracer.render(cfg, scene, cam, w, w, args.spp, seed=1,
                               method="regen")
    mean = float(np.asarray(img).mean())
    if not np.isfinite(mean):
        raise RuntimeError(f"non-finite mean radiance {mean}")

    vg, fb_args, iters = pathtracer.make_frame_value_and_grad(
        cfg, scene, cam, w, args.fb_spp)
    _, completed, _ = vg(fb_args)
    # an under-budgeted iteration count would time partial radiance
    if int(completed) != args.fb_spp:
        raise RuntimeError(f"regen_scan completed {int(completed)} of "
                           f"{args.fb_spp} spp at {iters} iterations")
    fb_s = _best(lambda: vg(fb_args), args.reps)

    fwd_rate = w * w * args.spp / fwd_s
    fb_rate = w * w * args.fb_spp / fb_s
    print(json.dumps({
        "metric": "cornell_fwd_bwd_samples_per_sec_per_chip",
        "value": fb_rate,
        "unit": "samples/s",
        "vs_baseline": fb_rate / BASELINE_SAMPLES_PER_SEC_PER_CHIP,
        "detail": {
            "device": dev.platform, "device_kind": dev.device_kind,
            "card": card,
            "width": w, "spp": args.spp, "forward_seconds": fwd_s,
            "forward_samples_per_sec": fwd_rate,
            "vs_baseline_forward": fwd_rate / BASELINE_SAMPLES_PER_SEC_PER_CHIP,
            "mean_radiance": mean,
            "fwd_bwd_spp": args.fb_spp, "fwd_bwd_seconds": fb_s,
            "fwd_bwd_regen_iters": iters,
            "bounces": cfg.max_bounces, "n_triangles": cfg.n_triangles,
            "mesh_accel": cfg.mesh_accel,
            # with mesh_vertex_grads=False (default) the mesh vertex/normal
            # tables are detached; every other float leaf and the camera
            # carry live gradients
            "mesh_vertex_grads": cfg.mesh_vertex_grads,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
