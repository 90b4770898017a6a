"""The forward render of rich-textured scenes against the JAX package's.

* One bounce of the split route (the flat scan's plain version, the shade
  kernel's plain version, then the rich-texture post-multiply, whose
  marble stripes run the marble kernel's plain version) against JAX's
  ``_surface_hit`` + ``_fused_shade_bounce(..., interpret=True)``, lane
  by lane, as ``tests/test_fused_shade.py`` runs it: random rays in a
  scene with image, marble, noise and checker textures on every diffuse
  and specular family (the scene of ``_scene_rich`` there), 1024 lanes,
  90% alive.  Tolerances (``tests/test_fused_shade.py``): floats within
  atol 2e-3 + rtol 1e-3, alive and died flags equal, on all but
  ``FRAC_LANES`` = 1% of the lanes (XLA's CPU backend contracts
  multiply-adds into FMAs, which can move a grazing hit, a Schlick
  decision or a texel edge on a lane).
* ``render_accumulate`` of ``scenes/noise_test.py`` at 64 x 36, 4 spp,
  depth 8, seed 0 through both packages (the work-queue driver; the
  port's split route with the flat scan, JAX's XLA bounce): the image
  mean within rtol 2e-3 (measured 4e-4), the median pixel to f32
  rounding, the share of pixels that differ by more than 1e-4 below 2%
  (measured 0.9%) and by more than 1e-3 below 1% (measured 0.3%: paths
  that resolved an edge differently).  The noise albedo differs from
  JAX's in its last bits (FMAs, and torch's sin/cos against XLA's), which
  moves 12% of the pixels by 1e-5 to 1e-4, so ``test_torch_render``'s
  1e-5 threshold does not apply here.
"""
import jax.numpy as jnp
import numpy as np
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.render.integrator import (
    _fused_shade_bounce, _surface_hit, n_bounce_uniforms,
)
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.interop import fields_to_numpy, settings_from_numpy
from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
from raytrace_tpu_torch.ops.texture_kernel import marble_stripe_pallas
from raytrace_tpu_torch.render.integrator import (
    _bounce_step, bounce_split_soa, split_tables,
)
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.testing import noise_test_world

FRAC_LANES = 0.01


def rich_world(rt):
    """``tests/test_fused_shade.py:_scene_rich``: image, marble, noise,
    checker textures and a light on spheres and parallelograms."""
    earth = np.random.default_rng(42).uniform(0, 1, (16, 32, 3)).astype(
        np.float32)
    mats = [
        rt.lambertian(rt.image_texture(earth)),
        rt.lambertian(rt.marble_texture([0, 0, 0.05], 4.0)),
        rt.lambertian(rt.noise_texture(4, 2.0, [0, 0, 0], [0.1, 0.1, 0.2],
                                       [0.9, 0.9, 1.0])),
        rt.metal(0.2, rt.image_texture(earth)),
        rt.light_source(rt.constant_texture([5.0, 4.0, 3.0])),
        rt.dielectric(1.5),
        rt.lambertian(rt.checker_texture(4, 4, [0.2, 0.4, 0.6],
                                         [0.9, 0.8, 0.1])),
    ]
    geoms = []
    rg = np.random.default_rng(1)
    for i, m in enumerate(mats):
        geoms.append(rt.with_material(m, rt.sphere(rg.uniform(-6, 6, 3),
                                                   1.2)))
        geoms.append(rt.with_material(
            mats[(i + 2) % len(mats)],
            rt.parallelogram(rg.uniform(-6, 6, 3), [2, 0, 0], [0, 2, 0.3])))
    return rt.group(geoms)


def test_one_bounce_matches_jax_fused_shade():
    js = jrt.compile_scene(rich_world(jrt), accel="dense")
    ts = trt.compile_scene(rich_world(trt), accel="dense", device="cpu")
    jset = jrt.CameraSettings(background=jrt.const_background(
        [0.4, 0.5, 0.6]))
    tset = trt.CameraSettings(background=trt.const_background(
        [0.4, 0.5, 0.6]))
    n = 1024
    rg = np.random.default_rng(2)
    o = rg.uniform(-7, 7, (n, 3)).astype(np.float32)
    d = rg.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = rg.uniform(0, 1, n).astype(np.float32)
    rad = rg.uniform(0, 0.2, (n, 3)).astype(np.float32)
    thr = np.full((n, 3), 0.7, np.float32)
    alive = rg.uniform(0, 1, n) < 0.9
    n_u = n_bounce_uniforms(js) + 6

    keys = jrng.ray_keys_fast(jrng.base_key(9), jnp.arange(n),
                              jnp.zeros(n, jnp.int32))
    juni = jrng.uniform_block(keys, n_u)
    o_park = jnp.where(jnp.asarray(alive)[:, None], jnp.asarray(o),
                       jnp.float32(3e18))
    hit = _surface_hit(js, jset, o_park, jnp.asarray(d), jnp.asarray(tm),
                       False)
    ref = _fused_shade_bounce(js, jset, o_park, jnp.asarray(d), juni,
                              jnp.asarray(rad), jnp.asarray(thr),
                              jnp.asarray(alive), *hit, None, interpret=True)
    ref = [np.asarray(x) for x in ref]

    tkeys = rng.ray_keys_fast(rng.base_key(9), torch.arange(n),
                              torch.zeros(n, dtype=torch.int32))
    tuni = rng.uniform_cols(tkeys, n_u)
    np.testing.assert_array_equal(tuni.numpy().T, np.asarray(juni))
    tb = split_tables(ts, tset)
    assert tb.bvh is None and tb.rich
    bounce, _ = _bounce_step(ts, tset, n)
    assert bounce is bounce_split_soa
    comps = torch.from_numpy(np.concatenate([o.T, d.T, tm[None]]))
    k0 = pallas_nearest_record.launches, marble_stripe_pallas.launches
    out = bounce_split_soa(ts, tset, comps, tuni, torch.from_numpy(rad.T),
                           torch.from_numpy(thr.T), torch.from_numpy(alive),
                           tables=tb)
    assert (pallas_nearest_record.launches,
            marble_stripe_pallas.launches) == k0      # CPU: plain versions
    got = [out[0][0:3].T.numpy(), out[0][3:6].T.numpy(), out[1].T.numpy(),
           out[2].T.numpy(), out[3].numpy(), out[4].numpy()]
    bad = (got[4] != ref[4]) | (got[5] != ref[5])
    for a, b in zip(got[:4], ref[:4]):
        bad |= ~np.isclose(a, b, rtol=1e-3, atol=2e-3).all(axis=1)
    assert bad.mean() <= FRAC_LANES, bad.mean()
    # every rich kind was multiplied in on live lanes
    mat = hit[5]
    tex = np.asarray(js.textures.kind)[np.asarray(js.materials.tex)[
        np.asarray(mat)]]
    live = np.asarray(ref[4]) & np.isfinite(np.asarray(hit[0]))
    for k in (2, 3, 4):                 # image, noise, marble
        assert (live & (tex == k)).sum() > 10, k


def test_noise_test_render_matches_jax():
    jworld, tworld = noise_test_world(jrt), noise_test_world(trt)
    js = jrt.compile_scene(jworld)
    ts = trt.compile_scene(tworld, device="cpu")
    jset = jrt.CameraSettings(
        aspect_ratio=16 / 9, image_width=64, samples_per_pixel=4,
        max_depth=8, background=jrt.sky, vfov=jrt.degrees(20),
        center=jnp.asarray([13.0, 2.0, 3.0]), look_at=jnp.zeros(3))
    d = fields_to_numpy(jset)
    d["background"] = "sky"
    tset = settings_from_numpy(d)
    assert tset.image_height == 36
    jacc, jn = jrender(js, jset, 0, spp=4)
    tacc, tn = trender(ts, tset, 0, spp=4)
    assert tn == jn == 4
    a = np.asarray(jacc) / 4
    b = tacc.numpy() / 4
    assert b.shape == a.shape == (64 * 36, 3) and np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-4).mean() < 0.02, (diff > 1e-4).mean()
    assert (diff > 1e-3).mean() < 0.01, (diff > 1e-3).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)
    # the picture: a bright sky over a textured ground and ball
    img = b.reshape(36, 64, 3)
    assert img[:4].mean() > img[-8:].mean()
    assert img[-8:].std() > 0.01


def test_rich_light_textures_raise():
    """A light with a rich texture, which neither kernel A nor the split
    path shades (emission is evaluated in the kernels), renders through
    the generic bounce: its marble stripes vary over the light."""
    from raytrace_tpu_torch.render import integrator
    scene = trt.compile_scene(trt.group([
        trt.with_material(trt.light_source(trt.marble_texture([0, 0, 1],
                                                              2.0)),
                          trt.sphere([0, 0, -2], 1)),
        trt.with_material(trt.lambertian(trt.constant_texture(0.5)),
                          trt.sphere([0, -101, -2], 100))]), device="cpu")
    s = trt.CameraSettings(image_width=8, samples_per_pixel=1)
    assert integrator._bounce_step(scene, s, 128)[0] is \
        integrator.bounce_generic_soa
    img = trt.render(scene, s)
    assert bool(torch.isfinite(img).all())
    assert float(img.std()) > 0.01
