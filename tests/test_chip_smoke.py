"""chip_smoke.py's phases at tiny sizes on the CPU (the kernel in
interpret mode), its refusal to run without a GPU, and the on-card
kernel check behind the ``gpu`` marker."""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def short_scene(tmp_path_factory):
    """cornell.json with a 3-bounce budget (compiles faster)."""
    with open(os.path.join(ROOT, "scenes", "cornell.json")) as fh:
        doc = json.load(fh)
    doc["settings"]["MAX_BOUNCES"] = 3
    doc["scene"]["obj"]["path"] = os.path.join(
        ROOT, "scenes", "assets", "torus_knot.obj")
    path = tmp_path_factory.mktemp("scene") / "cornell_b3.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_ray_population_layout():
    from photorealistic_rendering_using_opencl_tpu.scene.loader import (
        load_scene,
    )
    cfg, scene = load_scene(os.path.join(ROOT, "scenes", "cornell.json"))
    o, d, t0, act, ah, ex = chip_smoke.ray_population(cfg, scene, 16)
    n = 16 * 16
    assert o.shape == d.shape == (2 * n, 3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-5)
    assert not ah[:n].any() and ah[n + n // 2:].all()
    assert act[:n].all() and not act[n:].all()
    assert (ex[:n] == -1).all()
    assert ((ex[n:] >= 0) & (ex[n:] < cfg.n_triangles)).all()
    assert np.isfinite(t0).all() and (t0 > 0).all()


def test_kernel_phase_tiny():
    out = chip_smoke.kernel_phase(
        os.path.join(ROOT, "scenes", "cornell.json"), width=16, n_cpu=128,
        interpret=True)
    assert out["rays"] == 512
    assert out["vs_reference"]["winner_agreement"] == 1.0
    assert out["vs_reference"]["hit_miss_flips"] == 0
    assert out["vs_cpu_reference"]["closest_lanes"] > 0


def test_forward_phase_through_cli(tmp_path):
    out = chip_smoke.forward_phase(
        str(tmp_path), os.path.join(ROOT, "scenes", "cornell.json"),
        width=16, height=12, spp=2)
    assert os.path.isfile(tmp_path / "smoke.png")
    assert np.isfinite(out["mean_radiance"]) and out["mean_radiance"] > 0


def test_fwd_bwd_phase_tiny(short_scene):
    out = chip_smoke.fwd_bwd_phase(short_scene, width=8, spp=2,
                                   cmp_width=8, img_width=8, img_spp=2)
    assert np.isfinite(out["mean"]) and out["regen_iters"] > 0
    assert out["image_mean_rel"] <= 5e-4


def test_train_phase_tiny(short_scene):
    out = chip_smoke.train_phase(short_scene, width=8, spp=1)
    assert np.isfinite(out["loss"])


def test_multi_phase_tiny(short_scene):
    out = chip_smoke.multi_phase(short_scene, n_devices=4, width=8, spp=1,
                                 train_width=8, train_spp=1)
    assert out["loss_rel"] <= 1e-5


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "needs a GPU" in captured.err


@pytest.mark.gpu
def test_kernel_phase_on_card(gpu_device):
    """The compiled kernel against the reference on the card (the smoke
    runs the same check at 2 x 512^2 rays)."""
    out = chip_smoke.kernel_phase(
        os.path.join(ROOT, "scenes", "cornell.json"), width=128,
        n_cpu=4096)
    assert out["vs_reference"]["winner_agreement"] >= 0.9999
