"""A run's last line and the modules it loads: the result keys, the
check numbers last, nothing of JAX or the JAX package."""
import json
import subprocess
import sys

from portbench import core

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(line):
    out = json.loads(line)
    keys = list(out)
    assert keys[:5] == KEYS
    assert keys[5:] in (["checks"], ["breakdown", "checks"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    return out


def test_result_line_shape():
    line = core.result_line(True, 3, 0, {"setup_s": {"value": 1.5,
                                                      "unit": "s"}},
                            {"platform": "gpu", "kind": "x", "count": 1,
                             "memory_peak_bytes": 7}, [("gap", 1e-7, 1e-5)])
    out = _line(line)
    assert out["checks"]["gap"] == {"value": 1e-7, "limit": 1e-5}
    line = core.result_line(False, 1, 1, {}, {}, [],
                            {"device_ops": [], "idle_gaps": []})
    assert list(_line(line))[5] == "breakdown"


def test_whole_names_are_compared():
    import importlib
    sys.modules.setdefault("raytrace_tpu_torch", importlib.import_module(
        "raytrace_tpu_torch"))
    assert "raytrace_tpu_torch" not in core.forbidden_modules()


CHILD = r"""
import importlib, json, pkgutil, sys
import portbench
from portbench import run, core
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from portbench.tests.tiny import TINY, SEED
line, checks, code = run.run_cell("demo1-fwd", SEED, 0.0, False,
                                  device="cpu", overrides=TINY["demo1-fwd"])
print(json.dumps(dict(line=line, code=code,
                      tops=sorted({m.split(".")[0] for m in sys.modules}))))
"""


def test_a_run_loads_no_jax_and_prints_the_contracts_line():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["code"] == 0
    assert not {"jax", "jaxlib", "flax", "raytrace_tpu"} & set(rec["tops"])
    assert "raytrace_tpu_torch" in rec["tops"]
    res = _line(rec["line"])
    assert set(res["metrics"]) == {"fwd_rays_per_s", "setup_s"}
    # the checks are also the last lines of standard error
    assert out.stderr.strip().splitlines()[-1].startswith("check image_gap")


def test_the_command_refuses_a_machine_without_the_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "demo1-fwd", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
