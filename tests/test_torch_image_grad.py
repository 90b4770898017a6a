"""The atlas gradient K13 (``ops/image_grad_kernel.py``) and the
differentiable texel gather (``textures._image_gather``) on the CPU.

* ``_image_gather``'s value and atlas gradient against ``jax.vjp`` of the
  gather and against the JAX package's ``image_grad_pallas(...,
  interpret=True)``, on the three shapes of
  ``tests/test_image_grad_kernel.py``.  Values exactly; gradients per
  texel within ``testing.SCATTER_RTOL * n * sum |g|`` over the texel's
  ``n`` contributions ``g`` (``testing.image_grad_errs``: the largest
  difference two summation orders can have).
* The CUDA source (``csrc/image_grad_kernel.cu``) built for the host with
  g++ (``testing.host_library``) against ``image_grad_plain`` and against
  a float64 sum, with the same bound, on a real apply_rich-shaped batch:
  most lanes' cotangent is zero at texel (0, 0) (they write nothing).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops.pallas.image_grad_kernel import (
    image_grad_pallas as jgrad,
)
from raytrace_tpu_torch.ops import image_grad_kernel as ik
from raytrace_tpu_torch.testing import host_library, image_grad_errs
from raytrace_tpu_torch.textures.textures import _image_gather

SHAPES = ((512, 1, 16, 16, 0), (640, 3, 8, 24, 1), (384, 2, 17, 5, 2))


def _case(n, n_img, h, w, seed):
    rg = np.random.default_rng(seed)
    images = rg.uniform(0, 1, (n_img, h, w, 3)).astype(np.float32)
    img_id = rg.integers(0, n_img, n).astype(np.int32)
    j = rg.integers(0, h, n).astype(np.int32)
    i = rg.integers(0, w, n).astype(np.int32)
    g = rg.normal(size=(n, 3)).astype(np.float32)
    return images, img_id, j, i, g


def _holds(img_id, j, i, g, ref, out):
    t = lambda x: torch.from_numpy(np.array(x))
    _, err, excess = image_grad_errs(t(img_id), t(j), t(i), t(g), t(ref),
                                     t(out))
    assert excess <= 0.0, (err, excess)


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_value_and_gradient_match_jax(shape):
    images, img_id, j, i, g = _case(*shape)
    _, vjp = jax.vjp(lambda x: x[img_id, j, i], jnp.asarray(images))
    (g_ref,) = vjp(jnp.asarray(g))
    n, n_img, h, w, _ = shape
    g_pal = jgrad(jnp.asarray(img_id), jnp.asarray(j), jnp.asarray(i),
                  jnp.asarray(g), n_img=n_img, h=h, w=w, interpret=True)
    x = torch.from_numpy(images).requires_grad_(True)
    idx = [torch.from_numpy(a) for a in (img_id, j, i)]
    val = _image_gather(x, *idx)
    np.testing.assert_array_equal(val.detach().numpy(),
                                  images[img_id, j, i])
    (val * torch.from_numpy(g)).sum().backward()
    out = x.grad.numpy()
    _holds(img_id, j, i, g, np.asarray(g_ref), out)
    _holds(img_id, j, i, g, np.asarray(g_pal), out)
    assert np.abs(out).sum() > 0.0


def test_gather_keeps_index_shape():
    images, img_id, j, i, _ = _case(24, 2, 4, 6, 3)
    idx = [torch.from_numpy(a).reshape(4, 6) for a in (img_id, j, i)]
    val = _image_gather(torch.from_numpy(images), *idx)
    assert val.shape == (4, 6, 3)
    np.testing.assert_array_equal(val.reshape(-1, 3).numpy(),
                                  images[img_id, j, i])


_RUN = r"""
extern "C" int run_image_grad(const ImageGradArgs* a) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long l = 0; l < a->n_lanes; ++l) {
    blockIdx.x = static_cast<unsigned>(l);
    image_grad_kernel(*a);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_image_grad(tmp_path_factory):
    lib = host_library("image_grad_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("image_grad_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_image_grad.argtypes = [ctypes.c_void_p]
    return lib


def _host_grad(lib, img_id, j, i, g, n_img, h, w):
    idx = [torch.from_numpy(a).to(torch.int32).contiguous()
           for a in (img_id, j, i)]
    gt = torch.from_numpy(g).contiguous()
    out = torch.zeros((n_img, h, w, 3))
    a = ik._ImageGradArgs(*(x.data_ptr() for x in idx + [gt, out]),
                          g.shape[0], n_img, h, w)
    lib.run_image_grad(ctypes.byref(a))
    return out.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_host_build_of_image_grad_kernel(host_image_grad, shape):
    _, img_id, j, i, g = _case(*shape)
    n, n_img, h, w, _ = shape
    # two thirds of the lanes carry a zero cotangent at texel (0, 0), as
    # the image-only deferred multiply sends them
    dead = np.arange(n) % 3 != 0
    img_id[dead], j[dead], i[dead], g[dead] = 0, 0, 0, 0.0
    out = _host_grad(host_image_grad, img_id, j, i, g, n_img, h, w)
    t = lambda x: torch.from_numpy(x)
    plain = ik.image_grad_plain(t(img_id), t(j), t(i), t(g), n_img=n_img,
                                h=h, w=w).numpy()
    exact = ik.image_grad_plain(t(img_id), t(j), t(i),
                                t(g.astype(np.float64)), n_img=n_img, h=h,
                                w=w).numpy()
    _holds(img_id, j, i, g, plain, out)
    _holds(img_id, j, i, g, exact, out)
    assert np.abs(out).sum() > 0.0
    zero = _host_grad(host_image_grad, img_id, j, i, np.zeros_like(g), n_img,
                      h, w)
    assert not zero.any()
