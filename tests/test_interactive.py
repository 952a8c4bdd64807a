"""Interactive viewer: mouse-equivalent commands + ANSI preview."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from photorealistic_rendering_using_opencl_tpu.runtime.app import handle_command
from photorealistic_rendering_using_opencl_tpu.runtime.camera import InteractiveCamera
from photorealistic_rendering_using_opencl_tpu.runtime.terminal import ansi_image


def test_mouse_equivalent_commands():
    """Every reference mouse operation (user_interaction.h:45-90) has a
    shell command with the same camera effect."""
    c = InteractiveCamera()
    reset = lambda: InteractiveCamera()

    yaw0, pitch0 = c.yaw, c.pitch
    c, changed, handled = handle_command("orbit 20 10", c, reset)
    assert handled and changed
    assert c.yaw != yaw0 and c.pitch != pitch0  # left-drag rotate

    r0 = c.radius
    c, changed, _ = handle_command("zoom 5", c, reset)
    assert changed and c.radius < r0  # right-drag / scroll zoom in

    y0 = c.center[1]
    c, changed, _ = handle_command("pan 3", c, reset)
    assert changed and c.center[1] != y0  # middle-drag altitude pan

    r0 = c.radius
    c, changed, _ = handle_command("+", c, reset)
    assert changed and c.radius < r0

    c, changed, _ = handle_command("space", c, reset)
    assert changed and c.yaw == 0.0 and c.radius == 4.0

    c, changed, handled = handle_command("w", c, reset)  # keyboard map
    assert handled and changed

    c, changed, handled = handle_command("bogus 1 2", c, reset)
    assert not handled and not changed


def test_ansi_image_shape_and_colors():
    img = np.zeros((32, 32, 3), np.float32)
    img[:16] = [1.0, 0.0, 0.0]
    img[16:] = [0.0, 0.0, 1.0]
    s = ansi_image(img, max_cols=16, max_rows=8)
    assert "▀" in s and "38;2;255;0;0" in s and "48;2;0;0;255" in s
    assert len(s.splitlines()) == 8


def test_interactive_cli_continuous_accumulation(tmp_path):
    """Commands piped in; the viewer accumulates without per-step input,
    applies a camera edit, and exports on quit."""
    out = str(tmp_path / "ia.png")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        "import sys\n"
        f"sys.argv=['app','-scene','scenes/cornell_simple.json','-width',"
        f"'24','-height','24','-spp','4','--interactive','--no-preview',"
        f"'-o',{out!r}]\n"
        "from photorealistic_rendering_using_opencl_tpu.runtime.app import main\n"
        "sys.exit(main())\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code],
                       input="orbit 10 5\nq\n", text=True,
                       capture_output=True, timeout=240, env=env,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)


def test_terminal_graphics_protocols(tmp_path, monkeypatch):
    """Pixel-exact terminal frames (round-2 verdict item 9): kitty APC
    chunks carry a decodable PNG of the exact image, iTerm2 OSC-1337 is
    well-formed, the sixel stream quantizes to the declared palette, and
    detection honors PRT_TERM_GRAPHICS."""
    import base64
    import numpy as np
    from photorealistic_rendering_using_opencl_tpu.runtime import terminal
    from photorealistic_rendering_using_opencl_tpu.utils.image import read_png

    rng = np.random.default_rng(3)
    img = rng.random((12, 16, 3)).astype(np.float32)

    k = terminal.kitty_image(img)
    assert k.startswith("\x1b_G") and k.endswith("\x1b\\")
    payload = b"".join(
        chunk.split(b";", 1)[1]
        for chunk in k.encode().split(b"\x1b_G")[1:]
        for chunk in [chunk[:-2]])
    png = base64.standard_b64decode(payload)
    p = tmp_path / "k.png"
    p.write_bytes(png)
    back = read_png(str(p))
    expect = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(back, expect)

    it = terminal.iterm2_image(img)
    assert it.startswith("\x1b]1337;File=inline=1") and it.endswith("\x07")

    sx = terminal.sixel_image(img)
    assert sx.startswith("\x1bPq") and sx.endswith("\x1b\\")
    assert sx.count("#") >= 252  # palette definitions present

    for proto, fn in [("kitty", "\x1b_G"), ("iterm2", "\x1b]1337"),
                      ("sixel", "\x1bPq"), ("ansi", "\x1b[38;2")]:
        monkeypatch.setenv("PRT_TERM_GRAPHICS", proto)
        assert terminal.detect_protocol() == proto
        assert terminal.image_str(img).startswith(fn)
