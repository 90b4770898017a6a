"""Golden-image parity against the reference's own renders
(``scenes/parity.py``).

Monte-Carlo parity is statistical, not bitwise: each case renders one of
the reference's configurations, downsamples our PNG and the reference's
with PIL's bilinear filter and compares them (mean, p95 and max |delta|).
The scale to beat is the reference's own noise: two of its renders of the
Cornell box differ by a mean |delta| of ~0.015 at 64 px.  Criteria: the
pixel scenes mean |delta| < 0.02; demo1, whose small spheres the
reference placed with a generator no other program reproduces, its mean
brightness within 5%.

Two changes from the JAX script:

* it never says PASS having compared nothing: with no reference PNG the
  PNG verdict is ``NO_REFERENCE``;
* it also holds each render's mean brightness, measured the same way, to
  the reference PNG's mean that ``PARITY.md`` records
  (:data:`REFERENCE_MEANS`): within 1% for the pixel scenes, 5% for
  demo1.  That check needs no asset.

The reference PNGs are looked for in the reference repository's checkout
(``RT_REFERENCE``, :mod:`._assets`).  Rendering runs in this process, on
the card unless ``--cpu``::

    python3 -m raytrace_tpu_torch.scenes.parity [--cases cornell_box ...]

Prints one JSON line per case and a summary line; exits 1 if a check
failed.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

from ._assets import reference_dir

# (scene module, its flags, reference png, downsampled size, mode).
# "pixel": statistical pixel parity (a deterministic scene);
# "brightness": the scene's layout is random (demo1), compare the mean
CASES = [
    ("cornell_box", ["--width", "600", "--spp", "200", "--depth", "50"],
     "cornell_box_redirect.png", (64, 64), "pixel"),
    ("readme_example", ["--width", "600", "--spp", "50"],
     "example_image.png", (64, 36), "pixel"),
    # pawnTest (test/Main.hs:323-344): 500 px, 400 spp, depth 20
    ("pawn_test", ["--width", "500", "--spp", "400", "--depth", "20"],
     "pawn_demo.png", (64, 64), "pixel"),
    # the README hero image (test/Main.hs:136-186)
    ("demo1", ["--width", "1200", "--spp", "500", "--depth", "50"],
     "demo1.png", (64, 36), "brightness"),
]
# the reference PNGs' mean brightness at the case's size (PARITY.md)
REFERENCE_MEANS = {"cornell_box_redirect.png": 0.2342,
                   "example_image.png": 0.6738,
                   "pawn_demo.png": 0.6064,
                   "demo1.png": 0.5639}
PIXEL_MEAN_ABS = 0.02
BRIGHTNESS_RTOL = {"pixel": 0.01, "brightness": 0.05}
CRITERION = ("pixel scenes: mean_abs_diff < 0.02 (the reference's own "
             "inter-render noise is ~0.015); random-layout scenes: mean "
             "brightness within 5%; brightness against PARITY.md's "
             "recorded reference means: within 1% (pixel), 5% (demo1)")


def load(path: str, size) -> np.ndarray:
    """The PNG at ``path`` as RGB in [0, 1], resized bilinearly to
    ``size`` (width, height)."""
    from PIL import Image
    im = Image.open(path).convert("RGB")
    return np.asarray(im.resize(size, Image.BILINEAR), float) / 255.0


def case(scene: str):
    """The :data:`CASES` entry of ``scene``."""
    for c in CASES:
        if c[0] == scene:
            return c
    raise KeyError(f"no parity case {scene!r}")


def compare(ours_png: str, ref_png: str, size, mode: str) -> dict:
    """The PNG comparison of our render with the reference's."""
    ours, ref = load(ours_png, size), load(ref_png, size)
    diff = np.abs(ours - ref)
    mean_abs = float(diff.mean())
    if mode == "pixel":
        ok = mean_abs < PIXEL_MEAN_ABS
    else:
        ok = (abs(float(ours.mean()) - float(ref.mean()))
              < BRIGHTNESS_RTOL["brightness"] * max(float(ref.mean()), 1e-6))
    return {"mean_abs_diff": round(mean_abs, 5),
            "p95_abs_diff": round(float(np.percentile(diff, 95)), 5),
            "max_abs_diff": round(float(diff.max()), 5),
            "mean_ref": round(float(ref.mean()), 5), "png_ok": ok}


def brightness(ours_png: str, ref_name: str, size, mode: str) -> dict:
    """Our render's mean brightness at ``size`` against the reference's
    recorded mean (:data:`REFERENCE_MEANS`)."""
    ours = float(load(ours_png, size).mean())
    ref = REFERENCE_MEANS[ref_name]
    rel = abs(ours - ref) / ref
    return {"mean_ours": round(ours, 5), "mean_ref_recorded": ref,
            "brightness_rel_diff": round(rel, 5),
            "brightness_ok": rel <= BRIGHTNESS_RTOL[mode]}


def run_case(scene: str, out_dir: str, device: str = "cuda",
             spp: int | None = None) -> dict:
    """Render ``scene`` at its reference configuration (``spp`` in place
    of the reference's where given) through its driver's ``main`` into
    ``out_dir``, and check it: the recorded brightness always, the PNG
    comparison where the reference's PNG exists.  A scene whose asset is
    absent gives ``{"status": "NO_ASSET"}``."""
    name, flags, ref_name, size, mode = case(scene)
    flags = list(flags)
    if spp is not None:
        flags[flags.index("--spp") + 1] = str(spp)
    out = os.path.join(out_dir, f"parity_{ref_name}")
    argv = flags + ["--out", out] + (["--cpu"] if device == "cpu" else [])
    mod = importlib.import_module(f"{__package__}.{name}")
    rec = {"scene": name, "reference": ref_name, "mode": mode,
           "flags": flags}
    t0 = time.perf_counter()
    try:
        img = mod.main(argv)
    except FileNotFoundError as e:
        return dict(rec, status="NO_ASSET", reason=str(e))
    wall = time.perf_counter() - t0
    rays = img.shape[0] * img.shape[1] * int(flags[flags.index("--spp") + 1])
    rec.update(status="RENDERED", png=out, seconds=wall,
               primary_rays_per_s=rays / wall)
    rec.update(brightness(out, ref_name, size, mode))
    ref = reference_dir()
    ref_png = None if ref is None else os.path.join(ref, ref_name)
    if ref_png is not None and os.path.exists(ref_png):
        rec.update(compare(out, ref_png, size, mode))
    return rec


def verdicts(results) -> dict:
    """The summary: the PNG comparison's verdict (``NO_REFERENCE`` where no
    case had a reference PNG) and the recorded brightness's
    (``NO_RENDER`` where no case rendered)."""
    png = [r["png_ok"] for r in results if "png_ok" in r]
    light = [r["brightness_ok"] for r in results if "brightness_ok" in r]
    return {"parity": ("NO_REFERENCE" if not png
                       else "PASS" if all(png) else "FAIL"),
            "brightness": ("NO_RENDER" if not light
                           else "PASS" if all(light) else "FAIL"),
            "criterion": CRITERION}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="*", default=[c[0] for c in CASES])
    ap.add_argument("--quick", action="store_true",
                    help="render at 1/8 of each case's spp (smoke checks)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    for name in args.cases:
        flags = case(name)[1]
        spp = (max(4, int(flags[flags.index("--spp") + 1]) // 8)
               if args.quick else None)
        rec = run_case(name, args.out_dir,
                       device="cpu" if args.cpu else "cuda", spp=spp)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    summary = verdicts(results)
    print(json.dumps(summary), flush=True)
    return 1 if "FAIL" in (summary["parity"], summary["brightness"]) else 0


if __name__ == "__main__":
    sys.exit(main())
