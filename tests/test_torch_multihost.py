"""A real multi-process render of the port (``raytrace_tpu_torch/parallel/
worker.py`` over ``multihost``), as ``tests/test_multihost.py`` does the
JAX package's.

Two worker processes join one gloo job on the CPU, the explicit way
(``--pid --nproc --port``: ``multihost.initialize`` over TCP on
localhost) and through torchrun's environment (``torch.distributed.run
--standalone``), render their pixel blocks with the sharded wavefront and
gather the image, and take one sharded train step's loss and gradients
over 512 lanes.  The image must equal the single process's
(``multihost.render`` without a job) and JAX's single-device
``trace_wavefront_stationary`` within atol 2e-5, rtol 1e-5; the loss and
every gradient leaf the single process's within ``GRAD_RTOL`` of the
leaf's largest value (each lane's result depends only on its pixel; the
sums over lanes are ordered otherwise).  Each group of workers has a
timeout that kills it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import raytrace_tpu as jrt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.render.integrator import trace_wavefront_stationary
from raytrace_tpu_torch.parallel import worker
from raytrace_tpu_torch.testing import free_port, torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 1e-3
TIMEOUT_S = 300


def _run(cmds):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{o[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single process: ``worker.main`` without a job."""
    out = str(tmp_path_factory.mktemp("single") / "single.npz")
    with torch_threads(1):
        worker.main(["--cpu", "--train", "--out", out])
    return dict(np.load(out))


def _check(got, single):
    np.testing.assert_allclose(got["image"], single["image"], atol=2e-5,
                               rtol=1e-5)
    assert abs(float(got["loss"]) - float(single["loss"])) <= \
        GRAD_RTOL * abs(float(single["loss"]))
    grads = [k for k in single if k.startswith("grad/")]
    assert any(np.abs(single[k]).max() > 0 for k in grads)
    for k in grads:
        scale = max(float(np.abs(single[k]).max()), 1e-30)
        assert float(np.abs(got[k] - single[k]).max()) <= GRAD_RTOL * scale, k


def test_two_process_render_matches_single(tmp_path, single):
    port = free_port()
    out = str(tmp_path / "mh.npz")
    cmds = [[sys.executable, "-m", "raytrace_tpu_torch.parallel.worker",
             "--pid", str(pid), "--nproc", "2", "--port", str(port),
             "--cpu", "--train"]
            + (["--out", out] if pid == 0 else []) for pid in range(2)]
    outs = _run(cmds)
    assert all("ok" in o for o in outs)
    _check(dict(np.load(out)), single)


def test_torchrun_two_process_render_matches_single(tmp_path, single):
    out = str(tmp_path / "tr.npz")
    _run([[sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "raytrace_tpu_torch.parallel.worker",
           "--cpu", "--train", "--out", out]])
    _check(dict(np.load(out)), single)


def test_single_matches_jax(single):
    scene = jrt.compile_scene(worker.worker_world(jrt))
    s = worker.worker_settings(jrt)
    n_pix = s.image_width * s.image_height
    ref = np.asarray(trace_wavefront_stationary(
        scene, s, jrng.base_key(worker.SEED), n_pix, s.samples_per_pixel))
    ref = (ref / s.samples_per_pixel).reshape(s.image_height,
                                              s.image_width, 3)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(single["image"], ref, atol=2e-5, rtol=1e-5)
