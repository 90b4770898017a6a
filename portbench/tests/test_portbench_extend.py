"""A configuration, a cell, a traffic mix and a per-layer metric added
as new files plus entries of BENCHMARK.json, in a copy where no file
that was there is edited, are found and run at a tiny size."""
import json
import os
import shutil
import subprocess
import sys

from portbench import core

CHILD = r"""
import json
from portbench import run
over = {"traffic": {"trace_steps": 1}}
line, checks, code = run.run_cell("small-train", 7, 0.0, True,
                                  device="cpu", overrides=over)
print(line)
"""


def test_new_files_and_entries_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(core.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(core.ROOT / "raytrace_tpu_torch", root / "raytrace_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pkg = root / "portbench"
    cfg = core.load_json(pkg / "configs" / "cornell.json")
    cfg["name"] = "cornell-small"
    cfg["camera"]["image_width"] = 16
    (pkg / "configs" / "cornell-small.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "fit-tiny.json").write_text(json.dumps(dict(
        entry="train_step", lanes=256, spp=2, lr=0.02,
        check_steps=3, trace_steps=1)))
    (pkg / "cells" / "small-train.json").write_text(json.dumps(dict(
        n_iters=8, check={"loss_gap": 1.0, "grad_gap": 1.0,
                          "change_gap": 1.0})))
    (pkg / "metrics" / "test.steps_traced.py").write_text(
        'SOURCE, LAYER, MOVES = "program_counter", "driver", '
        '"train_rays_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx["counters"]["steps"]\n')
    bench = core.benchmark()
    bench["configs"].append(dict(name="cornell-small", source="x",
                                 file="portbench/configs/cornell-small.json",
                                 reduced=cfg["reduced"], why="test"))
    bench["workloads"].append(dict(name="small-train", config="cornell-small",
                                   traffic="fit-tiny", chips=1, why="test"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "cornell-train" in m["workloads"]:
            m["workloads"].append("small-train")
    bench["per_layer"].append(dict(
        name="test.steps_traced", unit="steps", better="higher",
        source="program_counter", layer="driver", moves="train_rays_per_s",
        workloads=["small-train"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["test.steps_traced"] == {"value": 1,
                                                   "unit": "steps"}
    assert "setup.scene_build_s" in res["metrics"]
    assert res["attempted"] == 1
    for p, data in before.items():
        assert p.read_bytes() == data, p
