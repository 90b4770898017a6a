"""``eval_texture`` against the JAX package's on one table holding all six
texture kinds: constant, checker, two images of different sizes (a
two-image atlas), 2- and 4-octave noise, two marbles and two custom
textures (written once for torch and once for jnp), at seeded points and
at uvs outside [0, 1] (the image wraps, and its rows run from the top,
``(1 - v) h``).

Tolerances: constant, checker and image lanes exactly (integer lookups;
no multiply-add the XLA CPU backend could contract feeds a ``floor``);
noise lanes within 1e-6 and marble lanes within 2e-5 (the turbulence
times 10 inside a sine; XLA's CPU backend contracts the noise blend's
multiply-adds into FMAs); custom lanes within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.textures.textures import compile_textures as jcompile
from raytrace_tpu.textures.textures import eval_texture as jeval
from raytrace_tpu_torch.testing import earthmap
from raytrace_tpu_torch.textures.textures import (
    TEX_CHECKER, TEX_CONSTANT, TEX_CUSTOM, TEX_IMAGE, TEX_MARBLE, TEX_NOISE,
    compile_textures, eval_texture,
)


def _textures(rt, xp):
    rg = np.random.default_rng(7)
    small = rg.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    return [
        rt.constant_texture([0.2, 0.5, 0.7]),
        rt.checker_texture(4, 3, [0.9, 0.1, 0.1], [0.1, 0.9, 0.2]),
        rt.image_texture(earthmap()),
        rt.image_texture(small),
        rt.noise_texture(2, 2.0, [10, 0, 0], 0.0, 1.0),
        rt.noise_texture(4, 0.7, [0.3, -1.0, 2.0], [0.1, 0.1, 0.4],
                         [0.9, 0.8, 1.0]),
        rt.marble_texture([0, 0, 1], 4.0),
        rt.marble_texture([1.0, 2.0, 0.0], 2.0, shift=(0.3, 0.1, 0.9)),
        rt.custom_texture(lambda p, uv: xp.stack(
            [uv[..., 0] * 0.5, xp.sin(p[..., 1]), p[..., 2] * p[..., 0]],
            axis=-1)),
        rt.solid_texture(lambda p: xp.abs(p) * 0.1),
    ]


def _lanes(n: int, n_tex: int, seed: int):
    rg = np.random.default_rng(seed)
    pts = rg.uniform(-6, 6, (n, 3)).astype(np.float32)
    uvs = rg.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    uvs[: n // 8] = rg.uniform(0, 1, (n // 8, 2))
    tid = rg.integers(0, n_tex, n).astype(np.int32)
    return pts, uvs, tid


def test_eval_texture_matches_jax():
    jt = jcompile(_textures(jrt, jnp))
    tt = compile_textures(_textures(trt, torch))
    assert tt.kinds_present == jt.kinds_present
    assert tt.marble_rows == jt.marble_rows == (6, 7)
    assert tt.images.shape == jt.images.shape == (2, 256, 512, 3)
    pts, uvs, tid = _lanes(8192, 10, 3)
    ref = np.asarray(jeval(jt, jnp.asarray(tid), jnp.asarray(pts),
                           jnp.asarray(uvs)))
    out = eval_texture(tt, torch.from_numpy(tid), torch.from_numpy(pts),
                       torch.from_numpy(uvs)).numpy()
    kind = np.asarray(jt.kind)[tid]
    exact = np.isin(kind, (TEX_CONSTANT, TEX_CHECKER, TEX_IMAGE))
    np.testing.assert_array_equal(out[exact], ref[exact])
    for k, tol in ((TEX_NOISE, 1e-6), (TEX_MARBLE, 2e-5), (TEX_CUSTOM, 1e-6)):
        sel = kind == k
        assert sel.sum() > 500
        np.testing.assert_allclose(out[sel], ref[sel], atol=tol, rtol=0,
                                   err_msg=str(k))
    # both images were sampled: the earth's two colours and most of the
    # small image's 35 texels
    img = kind == TEX_IMAGE
    assert len(np.unique(out[img], axis=0)) > 30


def test_marble_kernel_route_equals_plain_form():
    """``marble_kernel=True`` (the forward render: the marble kernel's
    plain version on the CPU) gives the plain form's stripes bit for
    bit: the same per-lane arithmetic."""
    tt = compile_textures(_textures(trt, torch))
    pts, uvs, tid = _lanes(2048, 10, 4)
    args = (tt, torch.from_numpy(tid), torch.from_numpy(pts),
            torch.from_numpy(uvs))
    a = eval_texture(*args)
    b = eval_texture(*args, marble_kernel=True)
    assert torch.equal(a, b)


def test_image_wrap_and_rows_from_the_top():
    """A 2 x 4 image: u = 0 is the first column, v = 1 the first row; u
    and v wrap with period 1 (also for negative values)."""
    img = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    tt = compile_textures([trt.image_texture(img)])
    uv = torch.tensor([[0.0, 0.99], [0.3, 0.2], [1.3, -0.8], [-0.1, 0.6],
                       [0.99, 1.01]])
    col = eval_texture(tt, torch.zeros(5, dtype=torch.int32),
                       torch.zeros((5, 3)), uv)
    expect = np.stack([img[0, 0], img[1, 1], img[1, 1], img[0, 3],
                       img[1, 3]])
    np.testing.assert_array_equal(col.numpy(), expect)


def test_interop_carries_images_and_refuses_custom():
    """``scene_from_numpy`` of a JAX scene with image and noise textures
    gives the port's own compile of the same world (atlas, sizes and
    table); a scene with a custom texture cannot cross (a jnp closure)."""
    import pytest
    from raytrace_tpu_torch.interop import scene_from_numpy, scene_to_numpy
    from raytrace_tpu_torch.testing import image_grad_world, noise_test_world

    for world in (image_grad_world, noise_test_world):
        ps = scene_from_numpy(scene_to_numpy(jrt.compile_scene(world(jrt))),
                              device="cpu")
        ts = trt.compile_scene(world(trt), device="cpu")
        for f in ("kind", "c0", "c1", "v0", "v1", "f0", "f1", "i0", "images",
                  "image_hw"):
            assert torch.equal(getattr(ps.textures, f),
                               getattr(ts.textures, f)), f
        assert ps.textures.kinds_present == ts.textures.kinds_present
        assert ps.textures.marble_rows == ts.textures.marble_rows
    js = jrt.compile_scene(jrt.with_material(
        jrt.lambertian(jrt.solid_texture(lambda p: jnp.abs(p))),
        jrt.sphere([0, 0, -2], 1)))
    with pytest.raises(ValueError, match="custom textures"):
        scene_from_numpy(scene_to_numpy(js), device="cpu")
