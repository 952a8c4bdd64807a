#!/usr/bin/env python3
"""GPU smoke test: drive the renderer's main path once on one card.

    python chip_smoke.py            # phases 1-4 on one GPU
    python chip_smoke.py --multi    # 4 GPUs: sharded render + train step

Phases (each an importable function that takes its sizes, so the CPU
tests run them tiny):

  1. ``kernel_phase``  -- the GPU mesh route against the plain reference
     at real width (2 x 512^2 mixed closest/any-hit rays on the cornell
     mesh), on the card and against a CPU run of the reference;
  2. ``forward_phase`` -- a 1024^2 x 16 spp render through the CLI entry
     (``runtime.app.main``);
  3. ``fwd_bwd_phase`` -- value_and_grad of the mean image over every
     float scene leaf plus the camera at 1024^2 x 4 spp (regen_scan, full
     bounce budget), then GPU route vs plain reference at small size;
  4. ``train_phase``   -- one ``make_train_step`` step on a 1-device mesh;
  5. ``multi_phase``   -- (``--multi`` only) 4-device sharded render and
     train step against 1 device.

Everything runs in this one process.  A failed check raises; the script
then exits non-zero and never prints its final ``{"ok": true, ...}`` line.
It refuses to run anywhere but on a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SCENE = "scenes/cornell.json"
OUT_DIR = "chiprun_out/smoke"
CARD = "card unknown"


def card_info() -> str:
    """Card name and power limit, read by nvidia-smi (no JAX involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args):
    """(result, seconds) with completion forced by block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 1: mesh kernel vs the plain reference
# ---------------------------------------------------------------------------

def ray_population(cfg, scene, width: int, seed: int = 0):
    """2 * width^2 rays laid out as intersect_and_shadow builds them:
    width^2 camera rays (closest hit), then width^2 bounce rays that start
    on the mesh, half closest-hit and half any-hit shadow rays toward the
    light sphere, ~10% inactive, each excluding its own triangle.

    Returns numpy arrays (origin, direction, t_init, active, any_hit,
    exclude)."""
    import jax.numpy as jnp
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops import intersect
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )

    rng = np.random.default_rng(seed)
    n = width * width
    cam = default_camera(width, width).pytree()
    px, py = pathtracer.pixel_grid(width, width)
    pix = py.astype(jnp.uint32) * width + px.astype(jnp.uint32)
    o_c, d_c = pathtracer.camera_rays_for_sample(
        cam, width, width, px, py, pix, jnp.zeros_like(pix), seed)

    # bounce origins: uniform points on random mesh triangles
    tv = np.asarray(scene.bf_tri_verts)
    tri = rng.integers(0, cfg.n_triangles, n)
    a, b = rng.random(n), rng.random(n)
    flip = a + b > 1.0
    a, b = np.where(flip, 1.0 - a, a), np.where(flip, 1.0 - b, b)
    p0, p1, p2 = tv[tri, 0], tv[tri, 1], tv[tri, 2]
    o_b = (p0 + a[:, None] * (p1 - p0) + b[:, None] * (p2 - p0))
    d_b = rng.normal(size=(n, 3))
    d_b /= np.linalg.norm(d_b, axis=1, keepdims=True)
    # shadow half: toward a point on the light sphere
    li = int(np.asarray(scene.light_indices)[0])
    lc = np.asarray(scene.position)[li]
    lr = float(np.asarray(scene.params)[li, 0])
    u = rng.normal(size=(n, 3))
    lp = lc + lr * u / np.linalg.norm(u, axis=1, keepdims=True)
    to_l = lp - o_b
    dist = np.linalg.norm(to_l, axis=1)
    shadow = np.arange(n) >= n // 2
    d_b = np.where(shadow[:, None], to_l / dist[:, None], d_b)

    origin = np.concatenate([np.asarray(o_c), o_b]).astype(np.float32)
    direction = np.concatenate([np.asarray(d_c), d_b]).astype(np.float32)
    t_an, _, _ = intersect._closest_analytic(
        cfg, scene, jnp.asarray(origin), jnp.asarray(direction))
    t_init = np.asarray(t_an).copy()
    t_init[n:][shadow] = (dist * (1.0 - 1e-3))[shadow]
    any_hit = np.concatenate([np.zeros(n, bool), shadow])
    active = np.concatenate([np.ones(n, bool), rng.random(n) < 0.9])
    exclude = np.concatenate([np.full(n, -1), tri]).astype(np.int32)
    return origin, direction, t_init, active, any_hit, exclude


def _mt_t(tv, tri, o, d):
    """Float64 Moller-Trumbore distance of ray i against triangle tri[i]."""
    p0, p1, p2 = tv[tri, 0], tv[tri, 1], tv[tri, 2]
    e1, e2 = p0 - p1, p2 - p0
    n = np.cross(e1, e2)
    return np.sum(n * (p0 - o), -1) / np.sum(n * d, -1)


def compare_winners(tv, o, d, any_hit, active, tri_a, tri_b):
    """Winner agreement on closest-hit lanes, near-tie check of every
    disagreement, and hit/miss flips on all active lanes."""
    closest = active & ~any_hit
    both = closest & (tri_a >= 0) & (tri_b >= 0) & (tri_a != tri_b)
    o64, d64, tv64 = (o.astype(np.float64), d.astype(np.float64),
                      tv.astype(np.float64))
    ta = _mt_t(tv64, tri_a[both], o64[both], d64[both])
    tb = _mt_t(tv64, tri_b[both], o64[both], d64[both])
    rel = np.abs(ta - tb) / np.maximum(np.maximum(np.abs(ta), np.abs(tb)),
                                       1e-30)
    flips = active & ((tri_a >= 0) != (tri_b >= 0))
    return {
        "closest_lanes": int(closest.sum()),
        "winner_agreement": float((tri_a[closest] == tri_b[closest]).mean()),
        "winner_disagreements": int((closest & (tri_a != tri_b)).sum()),
        "max_tie_rel_dt": float(rel.max()) if rel.size else 0.0,
        "active_lanes": int(active.sum()),
        "hit_miss_flips": int(flips.sum()),
    }


def _check_parity(stats: dict, what: str) -> None:
    check(stats["winner_agreement"] >= 0.9999,
          f"{what}: winner agreement {stats['winner_agreement']}")
    check(stats["max_tie_rel_dt"] < 1e-4,
          f"{what}: a disagreement is no near-tie "
          f"(rel dt {stats['max_tie_rel_dt']})")
    check(stats["hit_miss_flips"] <= 1e-5 * stats["active_lanes"],
          f"{what}: {stats['hit_miss_flips']} hit/miss flips")


def kernel_phase(scene_path: str = SCENE, width: int = 512,
                 n_cpu: int = 65536, seed: int = 0,
                 interpret: bool = False) -> dict:
    import jax
    import jax.numpy as jnp
    from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        load_scene,
    )

    cfg, scene = load_scene(scene_path)
    o, d, t0, act, ah, ex = ray_population(cfg, scene, width, seed)
    args = [jnp.asarray(x) for x in (o, d, t0, act, ah, ex)]
    feat, cl = scene.bf_feat, scene.bf_clusters

    def route(feat, cl, o, d, t0, act, ah, ex):
        return mesh_brute._intersect_triton(feat, cl, o, d, t0, act,
                                            any_hit=ah, exclude=ex,
                                            interpret=interpret)

    def reference(feat, cl, o, d, t0, act, ah, ex):
        return mesh_brute._intersect_xla(feat, cl, o, d, t0, act,
                                         exclude=ex)

    out = {"rays": int(o.shape[0]), "triangles": cfg.n_triangles}
    res = {}
    for name, fn in (("route", route), ("reference", reference)):
        compiled = jax.jit(fn).lower(feat, cl, *args).compile()
        log(f"[phase 1] {name} memory_analysis: "
            f"{compiled.memory_analysis()}")
        r, _ = timed(compiled, feat, cl, *args)
        times = [timed(compiled, feat, cl, *args)[1] for _ in range(3)]
        res[name] = [np.asarray(x) for x in r]
        out[f"{name}_ms"] = 1e3 * min(times)
        log(f"[phase 1] {name}: {out[f'{name}_ms']:.3f} ms per dispatch "
            f"of {o.shape[0]} rays [{CARD}]")

    out["vs_reference"] = compare_winners(
        np.asarray(scene.bf_tri_verts), o, d, ah, act,
        res["route"][1], res["reference"][1])
    log(f"[phase 1] route vs reference (same device): "
        f"{out['vs_reference']}")
    _check_parity(out["vs_reference"], "route vs reference")

    # the same reference on the host CPU, on a strided subset
    cpu = jax.devices("cpu")[0]
    sub = np.linspace(0, o.shape[0] - 1, min(n_cpu, o.shape[0])).astype(int)
    cpu_args = [jax.device_put(np.asarray(x)[sub], cpu)
                for x in (o, d, t0, act, ah, ex)]
    _, tri_cpu = jax.jit(reference)(jax.device_put(feat, cpu),
                                    jax.device_put(cl, cpu), *cpu_args)
    out["vs_cpu_reference"] = compare_winners(
        np.asarray(scene.bf_tri_verts), o[sub], d[sub], ah[sub], act[sub],
        res["route"][1][sub], np.asarray(tri_cpu))
    log(f"[phase 1] route vs CPU reference ({sub.size} rays): "
        f"{out['vs_cpu_reference']}")
    _check_parity(out["vs_cpu_reference"], "route vs CPU reference")
    return out


# ---------------------------------------------------------------------------
# Phase 2: forward render through the CLI entry
# ---------------------------------------------------------------------------

def forward_phase(out_dir: str = OUT_DIR, scene_path: str = SCENE,
                  width: int = 1024, height: int = 1024,
                  spp: int = 16) -> dict:
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.runtime import app
    from photorealistic_rendering_using_opencl_tpu.runtime.checkpoint import (
        load_checkpoint,
    )

    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "smoke.png")
    ckpt = os.path.join(out_dir, "smoke_state.npz")
    common = ["-scene", scene_path, "-width", str(width),
              "-height", str(height)]
    # warm-up at 1 spp compiles the progressive step for this frame size
    for p in (png, ckpt):
        if os.path.exists(p):
            os.remove(p)
    check(app.main(common + ["-spp", "1", "-o", png]) == 0, "warm-up CLI")
    os.remove(png)
    t0 = time.perf_counter()
    rc = app.main(common + ["-spp", str(spp), "-o", png,
                            "--checkpoint", ckpt,
                            "--checkpoint-interval", str(spp)])
    dt = time.perf_counter() - t0
    check(rc == 0, f"CLI exit code {rc}")
    check(os.path.isfile(png), f"{png} missing")
    state, _, _ = load_checkpoint(ckpt)
    img, _ = pathtracer.progressive_image(state)
    img = np.asarray(img)
    check(int(state.samples) == spp, f"{int(state.samples)} of {spp} spp")
    check(bool(np.isfinite(img).all()), "non-finite radiance")
    out = {"seconds": dt, "samples_per_s": width * height * spp / dt,
           "mean_radiance": float(img.mean())}
    log(f"[phase 2] CLI {width}x{height} @ {spp} spp: {dt:.3f} s, "
        f"{out['samples_per_s']:.1f} samples/s, mean radiance "
        f"{out['mean_radiance']:.6f} [{CARD}]")
    return out


# ---------------------------------------------------------------------------
# Phase 3: forward + backward
# ---------------------------------------------------------------------------

def fwd_bwd_phase(scene_path: str = SCENE, width: int = 1024, spp: int = 4,
                  cmp_width: int = 256, img_width: int = 512,
                  img_spp: int = 4) -> dict:
    import jax
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        load_scene,
    )

    cfg, scene = load_scene(scene_path)
    cfg = dataclasses.replace(cfg, mesh_accel="brute")
    out = {}
    cam = default_camera(width, width).pytree()
    vg, args, iters = pathtracer.make_frame_value_and_grad(
        cfg, scene, cam, width, spp)
    (val, completed, grad), t_first = timed(vg, args)
    (val, completed, grad), t = timed(vg, args)
    check(int(completed) == spp, f"completed {int(completed)} of {spp} spp")
    g = jax.tree_util.tree_leaves(grad)
    check(all(bool(np.isfinite(np.asarray(x)).all()) for x in g),
          "non-finite gradient")
    stats = jax.devices()[0].memory_stats() or {}
    out.update(seconds=t, seconds_first_call=t_first, regen_iters=iters,
               mean=float(val),
               samples_per_s=width * width * spp / t,
               peak_bytes=stats.get("peak_bytes_in_use"))
    log(f"[phase 3] fwd+bwd {width}^2 x {spp} spp, {cfg.max_bounces} "
        f"bounces, {iters} regen iterations: {t:.3f} s "
        f"(first call {t_first:.3f} s), {out['samples_per_s']:.1f} "
        f"samples/s, peak {out['peak_bytes']} B [{CARD}]")

    # GPU route vs plain reference: value and every gradient
    cam_s = default_camera(cmp_width, cmp_width).pytree()
    vals = {}
    it = None
    for accel in ("brute", "reference"):
        c = dataclasses.replace(cfg, mesh_accel=accel)
        vg, args, it = pathtracer.make_frame_value_and_grad(
            c, scene, cam_s, cmp_width, spp, regen_iters=it)
        val, completed, grad = vg(args)
        check(int(completed) == spp, f"{accel}: completed {int(completed)}")
        vals[accel] = (float(val), [np.asarray(x) for x in
                                    jax.tree_util.tree_leaves(grad)])
    (v_k, g_k), (v_r, g_r) = vals["brute"], vals["reference"]
    out["grad_mean_rel"] = abs(v_k - v_r) / abs(v_r)
    worst = 0.0
    for a, b in zip(g_k, g_r):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
        worst = max(worst, float(np.max(np.abs(a - b), initial=0.0)))
    out["grad_max_abs_diff"] = worst
    log(f"[phase 3] route vs reference at {cmp_width}^2 x {spp} spp: mean "
        f"rel {out['grad_mean_rel']:.3e}, max |dgrad| {worst:.3e} "
        f"over {len(g_k)} leaves")

    # forward images: mean radiance of the two routes, same seed
    cam_i = default_camera(img_width, img_width).pytree()
    means = {}
    for accel in ("brute", "reference"):
        c = dataclasses.replace(cfg, mesh_accel=accel)
        img, _ = pathtracer.render(c, scene, cam_i, img_width, img_width,
                                   img_spp, seed=5, method="regen")
        means[accel] = float(np.asarray(img).mean())
    out["image_mean_rel"] = (abs(means["brute"] - means["reference"])
                             / abs(means["reference"]))
    log(f"[phase 3] image mean {img_width}^2 x {img_spp} spp: route "
        f"{means['brute']:.6f}, reference {means['reference']:.6f}, rel "
        f"{out['image_mean_rel']:.3e}")
    check(out["image_mean_rel"] <= 5e-4,
          f"image mean differs by {out['image_mean_rel']}")
    return out


# ---------------------------------------------------------------------------
# Phase 4: one training step
# ---------------------------------------------------------------------------

def train_phase(scene_path: str = SCENE, width: int = 512,
                spp: int = 4) -> dict:
    import jax
    import jax.numpy as jnp
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.parallel.render import (
        default_mesh, make_train_step,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        load_scene,
    )

    cfg, scene = load_scene(scene_path)
    cam = default_camera(width, width).pytree()
    step = make_train_step(cfg, width, width, spp,
                           default_mesh(jax.devices()[:1]))
    target = jnp.full((width * width, 3), 0.25, jnp.float32)
    (loss, new), t_first = timed(step, scene, cam, target, 0)
    (loss, new), t = timed(step, scene, cam, target, 0)
    check(bool(np.isfinite(float(loss))), f"loss {float(loss)}")
    changed = [name for name in ("color", "obj_color")
               if not np.array_equal(np.asarray(getattr(new, name)),
                                     np.asarray(getattr(scene, name)))]
    check(changed == ["color", "obj_color"], f"updated leaves: {changed}")
    log(f"[phase 4] train step {width}^2 x {spp} spp: loss "
        f"{float(loss):.6f}, {t:.3f} s (first call {t_first:.3f} s), "
        f"changed {changed} [{CARD}]")
    return {"loss": float(loss), "seconds": t}


# ---------------------------------------------------------------------------
# Phase 5 (--multi): several devices against one
# ---------------------------------------------------------------------------

def multi_phase(scene_path: str = SCENE, n_devices: int = 4,
                width: int = 512, spp: int = 4, train_width: int = 256,
                train_spp: int = 2) -> dict:
    import jax
    import jax.numpy as jnp
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu.parallel.render import (
        default_mesh, make_train_step, render_sharded,
    )
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        load_scene,
    )

    devs = jax.devices()
    check(len(devs) >= n_devices, f"{len(devs)} devices, need {n_devices}")
    cfg, scene = load_scene(scene_path)
    out = {}
    cam = default_camera(width, width).pytree()
    imgs = {}
    for k in (n_devices, 1):
        mesh = default_mesh(devs[:k])
        (img, _), _ = timed(render_sharded, cfg, scene, cam, width, width,
                            spp, mesh)
        (img, _), t = timed(render_sharded, cfg, scene, cam, width, width,
                            spp, mesh)
        imgs[k] = np.asarray(img)
        out[f"render_{k}dev_seconds"] = t
        log(f"[multi] render_sharded {width}^2 x {spp} spp on {k} "
            f"device(s): {t:.3f} s [{CARD}]")
    a, b = imgs[n_devices], imgs[1]
    out["render_mean_rel"] = abs(a.mean() - b.mean()) / abs(b.mean())
    out["render_max_abs"] = float(np.max(np.abs(a - b)))
    log(f"[multi] render {n_devices} vs 1: mean rel "
        f"{out['render_mean_rel']:.3e}, max |dpixel| "
        f"{out['render_max_abs']:.3e}")
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    cam_t = default_camera(train_width, train_width).pytree()
    target = jnp.full((train_width * train_width, 3), 0.25, jnp.float32)
    res = {}
    for k in (n_devices, 1):
        step = make_train_step(cfg, train_width, train_width, train_spp,
                               default_mesh(devs[:k]))
        (loss, new), _ = timed(step, scene, cam_t, target, 0)
        (loss, new), t = timed(step, scene, cam_t, target, 0)
        res[k] = (float(loss), new)
        out[f"train_{k}dev_seconds"] = t
        log(f"[multi] train step {train_width}^2 x {train_spp} spp on {k} "
            f"device(s): loss {float(loss):.6f}, {t:.3f} s [{CARD}]")
    (la, na), (lb, nb) = res[n_devices], res[1]
    out["loss_rel"] = abs(la - lb) / abs(lb)
    check(out["loss_rel"] <= 1e-5, f"loss differs by {out['loss_rel']}")
    for name in ("color", "obj_color", "medium_sigma_a", "medium_sigma_s",
                 "medium_sigma_t"):
        np.testing.assert_allclose(np.asarray(getattr(na, name)),
                                   np.asarray(getattr(nb, name)),
                                   rtol=1e-5, atol=1e-7)
    log(f"[multi] train step {n_devices} vs 1: loss rel "
        f"{out['loss_rel']:.3e}, updated leaves agree")
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device sharded phase")
    ap.add_argument("--phases", default="1,2,3,4",
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)

    # phase 1 also runs the reference on the host CPU: keep that backend
    # visible next to the GPU (the GPU stays the default device)
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    from photorealistic_rendering_using_opencl_tpu.utils.config import (
        enable_compile_cache,
    )
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    CARD = card_info()
    log(f"card: {CARD}")
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
        f"compile cache {enable_compile_cache()}")

    results = {}
    if args.multi:
        results["multi"] = multi_phase()
    else:
        phases = {"1": kernel_phase, "2": forward_phase, "3": fwd_bwd_phase,
                  "4": train_phase}
        for p in args.phases.split(","):
            t0 = time.perf_counter()
            results[p] = phases[p]()
            log(f"[phase {p}] done in {time.perf_counter() - t0:.1f} s "
                f"[{CARD}]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "results.json"), "w") as fh:
        json.dump({"card": CARD, "device_kind": dev.device_kind,
                   "results": results}, fh, indent=1, default=str)
    log(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
