"""``diff/gradients.py:grad_render`` (the bounded-depth loss and its
gradient: ``render_tile(differentiable=True)`` over ``trace``'s generic
differentiable bounce) against the JAX package's ``grad_render``, on the
CPU: the Cornell box and the fog scene of ``tests/test_gradients.py``,
and ``testing.bigmesh_world`` at ``uv_sphere(8, 8)`` (a triangle mesh
in a lambertian on a lambertian floor under a light, the bigmesh-512
scene cut to size) under its camera; 64 pixels x 2 samples, depth 6, a
target of 0.1, ``base_key(3)``.  The
loss within rtol 1e-4, every gradient leaf within 1e-3 of its norm in the
L2 norm (the same estimator and draws), and zero where JAX's is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt

from raytrace_tpu.core import rng as jrng
from raytrace_tpu.diff.gradients import grad_render as jgrad_render
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.gradients import grad_render
from raytrace_tpu_torch.interop import grads_to_numpy
from raytrace_tpu_torch.testing import (
    bigmesh_settings, bigmesh_world, torch_threads,
)
from test_torch_trace import _pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _scenes(name):
    """``(jax scene, jax settings, port scene, port settings)``."""
    if name != "bigmesh":
        return _pair(name)
    return (jrt.compile_scene(bigmesh_world(jrt, 8, 8)),
            bigmesh_settings(jrt, 16, 2, 6),
            trt.compile_scene(bigmesh_world(trt, 8, 8), device="cpu"),
            bigmesh_settings(trt, 16, 2, 6))


@pytest.mark.parametrize("name", ["cornell", "fog", "bigmesh"])
def test_grad_render_matches_jax(name):
    js, jset, ts, tset = _scenes(name)
    pix = np.arange(0, 256, 4, dtype=np.int32)
    smp = np.arange(2, dtype=np.int32)
    target = np.full((pix.shape[0], 3), 0.1, np.float32)
    jl, jg = jgrad_render(js, jset, jrng.base_key(3), jnp.asarray(pix),
                          jnp.asarray(smp), jnp.asarray(target))
    tl, tg = grad_render(ts, tset, rng.base_key(3), torch.from_numpy(pix),
                         torch.from_numpy(smp), torch.from_numpy(target))
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    a, b = grads_to_numpy(jg), grads_to_numpy(tg)
    assert set(a) == set(b)
    if name == "fog":
        assert np.abs(a["volumes.density"]).max() > 0
    if name == "bigmesh":
        # the rows' corners get no gradient in either package (a
        # lambertian hit's weight does not depend on the hit point),
        # their edges do
        assert not np.any(a["prims.p0"]) and np.abs(a["prims.e1"]).max() > 0
    for k in a:
        assert np.all(np.isfinite(b[k])), k
        if not np.any(a[k]):
            assert not np.any(b[k]), k
        assert np.linalg.norm(a[k] - b[k]) <= 1e-3 * np.linalg.norm(a[k]), (
            k, np.linalg.norm(a[k] - b[k]), np.linalg.norm(a[k]))
