"""Weak-scaling SPMD overhead measurement on a virtual device mesh.

BASELINE.md demands >=85% rays/s scaling efficiency from 1 chip to 2 hosts;
real multi-chip hardware is unavailable here, so this harness bounds the
SPMD overhead on an 8-way virtual CPU mesh: per-device pixel count is held
FIXED while the mesh grows (weak scaling), so ideal time is flat and
efficiency = t(1) / t(n).  The forward path has no collectives (scene
replicated, pixels sharded) -- overhead measured here is shard_map
dispatch + padding + XLA partitioning, the part that would ride the
interconnect for real.  Run:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/scaling_bench.py
"""
from __future__ import annotations

import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import default_camera  # noqa: E402
from photorealistic_rendering_using_opencl_tpu.parallel.render import (
    default_mesh, render_sharded,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene  # noqa: E402
from photorealistic_rendering_using_opencl_tpu.utils.config import (  # noqa: E402
    enable_compile_cache,
)


def main():
    enable_compile_cache()
    cfg, scene = load_scene("scenes/cornell_simple.json")
    per_dev = 64 * 64  # fixed pixels per device (weak scaling)
    spp = 4
    devices = jax.devices()
    results = []
    for n_dev in (1, 2, 4, 8):
        if n_dev > len(devices):
            break
        mesh = default_mesh(devices[:n_dev])
        n_pix = per_dev * n_dev
        w = 64
        h = n_pix // w
        cam = default_camera(w, h).pytree()
        img, _ = render_sharded(cfg, scene, cam, w, h, spp, mesh, seed=1)
        np.asarray(img)  # compile+completion
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(render_sharded(cfg, scene, cam, w, h, spp, mesh,
                                      seed=2)[0])
            best = min(best, time.perf_counter() - t0)
        results.append((n_dev, best))
        print(f"n_dev {n_dev}: {best*1e3:8.1f} ms "
              f"({n_pix} px, {per_dev}/dev)")

    t1 = results[0][1]
    cores = os.cpu_count() or 1
    # virtual devices share the host's physical cores: the core count, not
    # the mesh, is the compute ceiling.  speedup = (useful work)/(time) in
    # 1-device units; SPMD overhead is the shortfall against
    # min(n_devices, cores).
    out = {
        "metric": "weak_scaling_virtual_mesh",
        "per_device_pixels": per_dev,
        "spp": spp,
        "host_cores": cores,
        "points": [
            {"n_devices": n, "seconds": round(t, 4),
             "parallel_speedup": round(n * t1 / t, 3),
             "vs_core_ceiling": round(n * t1 / t / min(n, cores), 3)}
            for n, t in results
        ],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
