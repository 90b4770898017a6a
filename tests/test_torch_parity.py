"""The port's parity script (``raytrace_tpu_torch/scenes/parity.py``) on
the CPU: the metric on synthetic PNGs (PIL's bilinear downsample, mean /
p95 / max |delta|, the pixel and brightness criteria of
``scenes/parity.py``), the check against the reference means that
``PARITY.md`` records (1% for the pixel scenes, 5% for demo1), and the
verdicts: ``NO_REFERENCE`` when no reference PNG was compared (the JAX
script says PASS then), ``NO_ASSET`` for a scene whose mesh is absent.
One case renders end to end at 32 px, 2 spp."""
import json
import shutil

import numpy as np
import pytest
from PIL import Image

from raytrace_tpu_torch.scenes import parity
from raytrace_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _png(path, rgb):
    Image.fromarray(np.asarray(rgb, np.uint8), "RGB").save(path)
    return str(path)


def _const_png(path, value, size=(128, 72)):
    """A PNG whose every channel is the byte nearest ``value * 255``."""
    w, h = size
    return _png(path, np.full((h, w, 3), round(value * 255)))


def test_load_is_pil_bilinear(tmp_path):
    rg = np.random.default_rng(0)
    path = _png(tmp_path / "a.png", rg.integers(0, 256, (72, 128, 3)))
    got = parity.load(path, (64, 36))
    want = np.asarray(Image.open(path).convert("RGB").resize(
        (64, 36), Image.BILINEAR), float) / 255.0
    assert got.shape == (36, 64, 3)
    np.testing.assert_array_equal(got, want)


def test_compare_metric(tmp_path):
    rg = np.random.default_rng(1)
    img = rg.integers(40, 200, (72, 128, 3))
    a = _png(tmp_path / "a.png", img)
    same = parity.compare(a, a, (64, 36), "pixel")
    assert same["mean_abs_diff"] == same["max_abs_diff"] == 0.0
    assert same["png_ok"]
    b = _png(tmp_path / "b.png", img + 10)          # 10/255 = 0.039
    off = parity.compare(b, a, (64, 36), "pixel")
    assert abs(off["mean_abs_diff"] - 10 / 255) < 1e-3
    assert off["p95_abs_diff"] <= off["max_abs_diff"]
    assert not off["png_ok"]
    # brightness mode: 10/255 on a mean of ~0.47 is ~8% > 5%; 2/255 is not
    assert not parity.compare(b, a, (64, 36), "brightness")["png_ok"]
    c = _png(tmp_path / "c.png", img + 2)
    assert parity.compare(c, a, (64, 36), "brightness")["png_ok"]


@pytest.mark.parametrize("ref,mode,rel,ok", [
    ("cornell_box_redirect.png", "pixel", 0.0, True),
    ("cornell_box_redirect.png", "pixel", 0.03, False),
    ("example_image.png", "pixel", 0.0, True),
    ("example_image.png", "pixel", -0.03, False),
    ("demo1.png", "brightness", 0.03, True),
    ("demo1.png", "brightness", -0.08, False),
])
def test_brightness_against_recorded_means(tmp_path, ref, mode, rel, ok):
    target = parity.REFERENCE_MEANS[ref] * (1 + rel)
    path = _const_png(tmp_path / "x.png", target)
    rec = parity.brightness(path, ref, (64, 36), mode)
    # a byte is 1/255: the constant image is within half of one of target
    assert abs(rec["mean_ours"] - target) <= 0.5 / 255 + 1e-9
    assert rec["brightness_ok"] is ok


def test_verdicts_never_pass_on_nothing():
    assert parity.verdicts([])["parity"] == "NO_REFERENCE"
    assert parity.verdicts([])["brightness"] == "NO_RENDER"
    only_light = [{"brightness_ok": True}, {"status": "NO_ASSET"}]
    v = parity.verdicts(only_light)
    assert (v["parity"], v["brightness"]) == ("NO_REFERENCE", "PASS")
    v = parity.verdicts([{"brightness_ok": True, "png_ok": False}])
    assert (v["parity"], v["brightness"]) == ("FAIL", "PASS")


def test_run_case_end_to_end(tmp_path, monkeypatch):
    monkeypatch.delenv("RT_REFERENCE", raising=False)
    monkeypatch.setattr(parity, "CASES", [
        ("readme_example", ["--width", "32", "--spp", "2"],
         "example_image.png", (16, 9), "pixel")])
    rec = parity.run_case("readme_example", str(tmp_path), device="cpu")
    assert rec["status"] == "RENDERED" and rec["primary_rays_per_s"] > 0
    assert "brightness_ok" in rec and "png_ok" not in rec
    assert parity.verdicts([rec])["parity"] == "NO_REFERENCE"
    # a reference checkout holding our own render: the PNG check passes
    shutil.copy(rec["png"], tmp_path / "example_image.png")
    monkeypatch.setenv("RT_REFERENCE", str(tmp_path))
    (tmp_path / "again").mkdir()
    rec2 = parity.run_case("readme_example", str(tmp_path / "again"),
                           device="cpu")
    assert rec2["mean_abs_diff"] == 0.0 and rec2["png_ok"]
    assert parity.verdicts([rec2])["parity"] == "PASS"


def test_main_without_asset_says_so(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("RT_REFERENCE", raising=False)
    rc = parity.main(["--cpu", "--cases", "pawn_test", "--out-dir",
                      str(tmp_path)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[0]["status"] == "NO_ASSET"
    assert lines[-1]["parity"] == "NO_REFERENCE"
    assert lines[-1]["brightness"] == "NO_RENDER"
    assert rc == 0
