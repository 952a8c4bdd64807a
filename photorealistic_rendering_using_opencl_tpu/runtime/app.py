"""Command-line application: progressive renderer + terminal interactive shell.

The counterpart of the reference's application driver
(``src/main.cpp:323-485``) and viewer loop.  Flag names mirror the
reference CLI (``-scene -width -height -hdr -alpha -encoder``,
README.md:15-22) with framework extras (spp, output, checkpointing,
sharding, AOVs).  There is no OpenGL window on a headless accelerator
host; interactive mode is a terminal shell with the reference's key
bindings
(include/GL/user_interaction.h:16-43), re-invoking the jitted progressive
step after each camera edit and resetting accumulation exactly like
``buffer_reset`` (src/main.cpp:283-290).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photorealistic_rendering_using_opencl_tpu",
        description="Differentiable progressive Monte-Carlo path tracer")
    # reference-compatible flags (README.md:15-22)
    p.add_argument("-scene", "--scene", default="scenes/cornell.json")
    p.add_argument("-width", "--width", type=int, default=1024)
    p.add_argument("-height", "--height", type=int, default=1024)
    p.add_argument("-hdr", "--hdr", default=None,
                   help="equirect HDR environment map")
    p.add_argument("-alpha", "--alpha", action="store_true",
                   help="alpha testing: transparent background")
    p.add_argument("-encoder", "--encoder", type=int, default=0,
                   choices=(0, 1), help="0=PNG (tonemapped), 1=HDR")
    # framework extras
    p.add_argument("-spp", "--spp", type=int, default=64)
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--aov", default=None,
                   choices=(None, "normal", "albedo", "depth", "mesh_id",
                            "traversal"))
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; save every --checkpoint-interval "
                        "samples and resume from it when present")
    p.add_argument("--checkpoint-interval", type=int, default=32)
    p.add_argument("--interactive", action="store_true",
                   help="terminal viewer: continuous accumulation with a "
                        "live ANSI preview; reference key bindings plus "
                        "mouse-equivalent orbit/zoom/pan commands")
    p.add_argument("--preview", action="store_true", default=None,
                   help="force the live terminal preview on (default: "
                        "only when stdout is a tty)")
    p.add_argument("--no-preview", dest="preview", action="store_false")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over all visible devices (pjit/"
                        "shard_map data parallelism)")
    p.add_argument("--phase", default="isotropic",
                   choices=("isotropic", "hg", "rayleigh"))
    p.add_argument("--pick-random-light", action="store_true",
                   help="NEE picks one light uniformly per vertex instead "
                        "of always sampling light 0 (the reference's "
                        "PICK_RANDOM_LIGHT kernel toggle, base.cl:9); also "
                        "settable per scene via settings.PICK_RANDOM_LIGHT")
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace to this directory "
                        "during rendering")
    return p


def _load(args):
    import dataclasses

    from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu.utils.image import read_hdr

    env = read_hdr(args.hdr) if args.hdr else None
    cfg, scene = load_scene(args.scene, env_map=env,
                            alpha_testing=args.alpha,
                            phase_function=args.phase)
    if getattr(args, "pick_random_light", False):
        cfg = dataclasses.replace(cfg, pick_random_light=True)
    return cfg, scene


def _export(path: str, hdr_img, alpha, encoder: int) -> None:
    from photorealistic_rendering_using_opencl_tpu.ops.tonemap import tonemap
    from photorealistic_rendering_using_opencl_tpu.utils.image import (
        write_hdr, write_png,
    )
    img = np.asarray(hdr_img)
    if encoder == 1:
        if not path.endswith(".hdr"):
            path = path.rsplit(".", 1)[0] + ".hdr"
        write_hdr(path, img)
    else:
        ldr = np.asarray(tonemap(img))
        if alpha is not None:
            a = np.clip(np.asarray(alpha), 0.0, 1.0)[..., None]
            ldr = np.concatenate([ldr, a], axis=-1)
        write_png(path, ldr)
    print(f"saved {path}")


def run_batch(args) -> int:
    import jax
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer

    cfg, scene = _load(args)
    W, H = args.width, args.height

    if args.aov:
        from photorealistic_rendering_using_opencl_tpu.runtime.camera import InteractiveCamera
        cam = InteractiveCamera(resolution=(W, H)).build_render_camera()
        img = pathtracer.render_aov(cfg, scene, cam.pytree(), W, H,
                                    mode=args.aov)
        _export(args.output, img, None, 0)
        return 0

    from photorealistic_rendering_using_opencl_tpu.runtime.camera import InteractiveCamera
    from photorealistic_rendering_using_opencl_tpu.runtime.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    cam = InteractiveCamera(resolution=(W, H)).build_render_camera().pytree()

    if args.sharded and jax.device_count() > 1:
        from photorealistic_rendering_using_opencl_tpu.parallel.render import (
            default_mesh, render_sharded,
        )
        mesh = default_mesh()
        print(f"sharding {W}x{H} over {mesh.devices.size} devices")
        t0 = time.perf_counter()
        img, alpha = render_sharded(cfg, scene, cam, W, H, args.spp, mesh,
                                    seed=args.seed)
        img.block_until_ready()
        dt = time.perf_counter() - t0
        _report(W, H, args.spp, dt, cfg)
        _export(args.output, img, alpha if args.alpha else None, args.encoder)
        return 0

    state = pathtracer.progressive_init(W, H, seed=args.seed)
    if args.checkpoint:
        try:
            state, _, extra = load_checkpoint(args.checkpoint)
            print(f"resumed {args.checkpoint} at "
                  f"{int(state.samples)} samples")
        except FileNotFoundError:
            pass

    prof = None
    if args.profile:
        import jax.profiler
        prof = jax.profiler.trace(args.profile)
        prof.__enter__()

    t0 = time.perf_counter()
    done = int(state.samples)
    try:
        while done < args.spp:
            state = pathtracer.progressive_step(cfg, scene, cam, state)
            done = int(state.samples)
            if args.checkpoint and done % args.checkpoint_interval == 0:
                state.acc.block_until_ready()
                save_checkpoint(args.checkpoint, state)
            if done % 16 == 0 or done == args.spp:
                state.acc.block_until_ready()
                dt = time.perf_counter() - t0
                rate = done * W * H / max(dt, 1e-9)
                print(f"\r{done}/{args.spp} spp  "
                      f"{rate/1e6:.2f}M samples/s", end="", flush=True)
    except KeyboardInterrupt:
        print("\ninterrupted")
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    print()
    state.acc.block_until_ready()
    _report(W, H, done, time.perf_counter() - t0, cfg)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)
    img, alpha = pathtracer.progressive_image(state)
    _export(args.output, img, alpha if args.alpha else None, args.encoder)
    return 0


def _report(w, h, spp, dt, cfg):
    n = w * h * max(spp, 1)
    print(f"{w}x{h} @ {spp} spp in {dt:.2f}s -> "
          f"{n / max(dt, 1e-9) / 1e6:.2f}M pixel-samples/s "
          f"(~{n * cfg.max_bounces / max(dt, 1e-9) / 1e6:.0f}M rays/s upper "
          f"bound)")


def _stdin_ready() -> bool:
    import select
    try:
        return bool(select.select([sys.stdin], [], [], 0.0)[0])
    except (OSError, ValueError):
        return True  # closed/odd stdin: fall back to blocking reads


def handle_command(key: str, icam, reset_cls):
    """Apply one shell command to the camera.

    Returns (new_icam, camera_changed, handled).  Besides the reference
    keyboard map, the reference's MOUSE operations
    (include/GL/user_interaction.h:45-90) map to commands:
      * left-drag rotate  -> ``orbit DX DY`` (changeYaw/changePitch x0.01)
      * right-drag / scroll zoom -> ``zoom D`` and the +/- keys
      * middle-drag pan   -> ``pan DY`` (changeAltitude x0.01)
    """
    from photorealistic_rendering_using_opencl_tpu.runtime.camera import KEY_BINDINGS

    parts = key.split()
    op = parts[0] if parts else ""
    try:
        nums = [float(x) for x in parts[1:]]
    except ValueError:
        return icam, False, False
    if op == "orbit" and len(nums) == 2:
        icam.change_yaw(nums[0] * 0.01)
        icam.change_pitch(-nums[1] * 0.01)
        return icam, True, True
    if op == "zoom" and len(nums) == 1:
        icam.change_radius(-nums[0] * 0.01)
        return icam, True, True
    if op == "pan" and len(nums) == 1:
        icam.change_altitude(-nums[0] * 0.01)
        return icam, True, True
    if op == "+":
        icam.change_radius(-0.05)
        return icam, True, True
    if op == "-":
        icam.change_radius(0.05)
        return icam, True, True
    if key in ("space", " "):
        return reset_cls(), True, True
    if key in KEY_BINDINGS:
        KEY_BINDINGS[key](icam)
        return icam, True, True
    return icam, False, False


def run_interactive(args) -> int:
    from photorealistic_rendering_using_opencl_tpu.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu.runtime import terminal
    from photorealistic_rendering_using_opencl_tpu.runtime.camera import (
        InteractiveCamera,
    )

    cfg, scene = _load(args)
    W, H = args.width, args.height
    icam = InteractiveCamera(resolution=(W, H))
    state = pathtracer.progressive_init(W, H, seed=args.seed)
    preview = args.preview or (args.preview is None and sys.stdout.isatty())

    print("interactive viewer -- accumulates continuously; commands:")
    print("  w/a/s/d/r/f move   g/h aperture   t/y focal   "
          "left/right/up/down orbit keys")
    print("  orbit DX DY (mouse rotate)   zoom D / + / - (scroll)   "
          "pan DY (middle drag)")
    print("  space reset camera   p save image   n samples   q quit")
    if preview:
        sys.stdout.write(terminal.CLEAR)

    def reset_cls():
        return InteractiveCamera(resolution=(W, H))

    running = True
    while running:
        # accumulate continuously (the reference's free-running render loop,
        # src/main.cpp:465-480) until input arrives
        state = pathtracer.progressive_step(
            cfg, scene, icam.build_render_camera().pytree(), state)
        n = int(state.samples)  # also acts as the completion barrier
        if preview and (n <= 2 or n % 4 == 0):
            from photorealistic_rendering_using_opencl_tpu.ops.tonemap import tonemap
            img, _ = pathtracer.progressive_image(state)
            sys.stdout.write(terminal.CURSOR_HOME
                             + terminal.image_str(np.asarray(tonemap(img)))
                             + f"\n[{n} spp] > \x1b[K")
            sys.stdout.flush()
        if not _stdin_ready():
            continue
        line = sys.stdin.readline()
        if not line:
            break
        key = line.strip().lower()
        if not key:
            continue
        if key == "q":
            running = False
        elif key == "p":
            img, alpha = pathtracer.progressive_image(state)
            _export(args.output, img, alpha if args.alpha else None,
                    args.encoder)
        elif key == "n":
            print(f"\n{n} samples accumulated")
        else:
            icam, changed, handled = handle_command(key, icam, reset_cls)
            if changed:
                state = pathtracer.progressive_reset(state)
            elif not handled:
                print(f"\nunknown command {key!r}")
    img, alpha = pathtracer.progressive_image(state)
    _export(args.output, img, alpha if args.alpha else None, args.encoder)
    return 0


def main(argv=None) -> int:
    from photorealistic_rendering_using_opencl_tpu.utils.config import (
        enable_compile_cache,
    )
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    if args.interactive:
        return run_interactive(args)
    return run_batch(args)


if __name__ == "__main__":
    sys.exit(main())
