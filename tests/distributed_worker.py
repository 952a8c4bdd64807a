"""Worker process for the 2-process jax.distributed CPU test.

Usage: python tests/distributed_worker.py <coordinator_addr> <num_procs> <pid>

Each process owns 2 virtual CPU devices (4 global).  Exercises
``parallel.distributed.initialize`` for real (SURVEY §2.4 cross-host row):
a cross-process sharded render plus a distributed train step, both checked
against single-device references computed locally.  Prints "DIST_OK" and
exits 0 on success.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax
    jax.config.update("jax_platforms", "cpu")
    from photorealistic_rendering_using_opencl_tpu.utils.config import (
        enable_compile_cache,
    )
    enable_compile_cache()

    from photorealistic_rendering_using_opencl_tpu.parallel import distributed

    distributed.initialize(coordinator_address=addr, num_processes=nproc,
                           process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.parallel.render import (
        make_train_step, render_sharded,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene

    cfg, scene = load_scene("scenes/cornell_simple.json")
    W = H = 16
    spp = 2
    cam = default_camera(W, H).pytree()
    mesh = distributed.global_mesh()
    assert mesh.devices.size == 2 * nproc

    # ---- cross-process sharded render vs single-device reference --------
    img, alpha = render_sharded(cfg, scene, cam, W, H, spp, mesh, seed=7)
    ref_img, ref_alpha = pathtracer.render(cfg, scene, cam, W, H, spp,
                                           seed=7, method="regen")
    ref_img = np.asarray(ref_img)
    ref_alpha = np.asarray(ref_alpha)
    for s in img.addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), ref_img[s.index])
    for s in alpha.addressable_shards:
        np.testing.assert_array_equal(np.asarray(s.data), ref_alpha[s.index])

    # ---- distributed train step vs manually-computed global gradient ----
    lr = 1e-2
    step = make_train_step(cfg, W, H, spp, mesh, lr=lr,
                           param_leaves=("color",))
    target = np.zeros((W * H, 3), np.float32)
    loss, new_scene = step(scene, cam, target, 0)

    from photorealistic_rendering_using_opencl_tpu.parallel.render import (
        _render_block,
    )

    def ref_loss(color):
        sc = dataclasses.replace(scene, color=color)
        px, py = pathtracer.pixel_grid(W, H)
        rad, _ = _render_block(cfg, W, H, spp, "pcg4d", sc, cam, px, py,
                               jnp.asarray(0, jnp.uint32))
        return jnp.sum(jnp.square(rad - target)) / (W * H * 3)

    ref_l, ref_g = jax.value_and_grad(ref_loss)(scene.color)
    np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-5)
    expected = np.asarray(scene.color) - lr * np.asarray(ref_g)
    got = None
    for s in new_scene.color.addressable_shards:  # replicated output
        got = np.asarray(s.data)
        break
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-7)

    print("DIST_OK", flush=True)


if __name__ == "__main__":
    main()
