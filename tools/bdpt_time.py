"""Compile + time a BDPT frame on the available device.

The bidirectional integrator (models/bidirectional.py) exceeds the
reference (kernels/integrators/bidirectional.cl is an empty file).  Times
`render(method="bdpt")` at a modest shape: one warm-up call, then the
best of two timed calls ending in block_until_ready.

Usage: python tools/bdpt_time.py [width] [spp] [depth]
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402


def main():
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    depth = int(sys.argv[3]) if len(sys.argv) > 3 else 6

    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene

    cfg, scene = load_scene("scenes/cornell.json")
    cam = default_camera(width, width).pytree()

    from photorealistic_rendering_using_opencl_tpu.utils.config import (
        enable_compile_cache,
    )
    enable_compile_cache()

    def frame():
        return pathtracer.render(cfg, scene, cam, width, width, spp, seed=1,
                                 method="bdpt", bdpt_max_depth=depth)

    t0 = time.perf_counter()
    img, _ = jax.block_until_ready(frame())  # compile + warm
    print(f"first call (incl compile) {time.perf_counter() - t0:.0f}s",
          flush=True)
    per = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(frame())
        per = min(per, time.perf_counter() - t0)
    rate = width * width * spp / per
    dev = jax.devices()[0]
    print(f"bdpt {width}x{width} x {spp}spp depth={depth}: "
          f"{per*1e3:.0f} ms/frame = {rate:.0f} samples/s "
          f"mean={float(np.asarray(img).mean()):.5f} "
          f"device={dev.platform} ({dev.device_kind})", flush=True)


if __name__ == "__main__":
    main()
