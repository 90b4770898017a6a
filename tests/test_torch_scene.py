"""The port's scene builder, compiler and kernel table packers against the
JAX package.

Each scene is built twice from the same numbers, once with each package's
builder, and compiled by each package's compiler.  The compiled rows, the
static scene facts and the packed kernel tables must agree: integer
columns exactly, floats to rtol 1e-6 (atol 1e-6 of the column scale for
entries that cancel to about zero: both sides round the same f32 formulas,
XLA with multiply-add contraction).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.ops.pallas import bounce_kernel as jbk
from raytrace_tpu.ops.pallas import intersect_kernel as jik
from raytrace_tpu.ops.pallas import iter_kernel as jitk
from raytrace_tpu.render.camera import camera_frame as jframe
from raytrace_tpu_torch.core import rng as trng
from raytrace_tpu_torch.ops import bounce_kernel as tbk
from raytrace_tpu_torch.ops import intersect_kernel as tik
from raytrace_tpu_torch.ops import iter_kernel as titk
from raytrace_tpu_torch.render.camera import camera_frame as tframe
from raytrace_tpu_torch.testing import (
    ALL_MATERIAL_TARGETS, all_materials_scene, cornell_scene_and_settings,
)


def _close(t, j):
    t = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape)
    if np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j)
    else:
        scale = max(float(np.abs(j).max()), 1.0) if j.size else 1.0
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6 * scale)


def _compile(rt, world, **kw):
    """The port's scenes are compiled for the CPU, the JAX package's as
    they are."""
    if rt is trt:
        kw["device"] = "cpu"
    return rt.compile_scene(world, **kw)


def _readme(rt):
    """scenes/readme_example.py's world."""
    world = rt.group([
        rt.with_material(rt.lambertian(rt.checker_texture(20, 10, 0.2, 0.8)),
                         rt.sphere([0, 0, 0], 1)),
        rt.with_material(rt.lambertian(rt.constant_texture([0, 0.2, 0.5])),
                         rt.sphere([0, -1000, 0], 999)),
        rt.with_material(rt.mirror(rt.constant_texture(0.8)),
                         rt.parallelogram([-3.25, -1, -0.75],
                                          [1.25, 0, -1.25], [0, 2, 0])),
    ])
    s = rt.CameraSettings(center=np.asarray([-0.75, 0.0, 2.0]),
                          look_at=np.asarray([0.0, 0.0, -1.0]),
                          aspect_ratio=16 / 9, image_width=64,
                          samples_per_pixel=4, max_depth=10)
    return _compile(rt, world), s


def _moving(rt):
    m = rt.lambertian(rt.constant_texture(0.5))
    world = rt.group([
        rt.moving([0, 0, 0], [3, 0, 0],
                  rt.with_material(m, rt.sphere([0, 0, -5], 1.0))),
        rt.with_material(m, rt.parallelogram([-9, -3, -9], [18, 0, 0],
                                             [0, 0, 18])),
        rt.transform(rt.compose(rt.translate([1, 0, -3]), rt.scale(0.5)),
                     rt.with_material(rt.metal(0.2, rt.constant_texture(
                         [0.9, 0.8, 0.7])), rt.cuboid([0, 0, 0], [1, 1, 1]))),
    ])
    s = rt.CameraSettings(background=rt.sky, image_width=32)
    return _compile(rt, world, accel="dense"), s


def _big(rt):
    """70 spheres, 20 triangles and 6 axis-aligned boxes: >= 65 rows, so
    the table is regrouped kind-major into 64-row segments."""
    rg = np.random.default_rng(5)
    mats = [rt.lambertian(rt.constant_texture(rg.uniform(0, 1, 3)))
            for _ in range(3)] + [rt.dielectric(1.5)]
    geoms = [rt.with_material(mats[i % 4], rt.sphere(rg.uniform(-9, 9, 3),
                                                     rg.uniform(0.2, 1.0)))
             for i in range(70)]
    geoms += [rt.with_material(mats[i % 3], rt.triangle(
        *rg.uniform(-9, 9, (3, 3)))) for i in range(20)]
    geoms += [rt.with_material(mats[i % 3], rt.cuboid(c, c + 1.0))
              for i, c in enumerate(rg.uniform(-9, 9, (6, 3)))]
    s = rt.CameraSettings(background=rt.gray_fade, image_width=32)
    return _compile(rt, rt.group(geoms), accel="dense"), s


def _all_materials(rt):
    s = rt.CameraSettings(background=rt.const_background(0.2))
    s = s.with_redirect_targets(ALL_MATERIAL_TARGETS)
    if rt is trt:
        return all_materials_scene(device="cpu"), s
    from test_bounce_kernel import _scene_all_materials
    return _scene_all_materials(), s


def _cornell(rt):
    if rt is trt:
        return cornell_scene_and_settings(64, 8, 10, device="cpu")
    return _cornell_scene_and_settings(64, 8, 10)


SCENES = {"cornell": _cornell, "readme": _readme, "moving": _moving,
          "segmented": _big, "all_materials": _all_materials}


@pytest.fixture(params=sorted(SCENES), scope="module")
def pair(request):
    build = SCENES[request.param]
    return request.param, build(jrt), build(trt)


def test_compiled_rows_equal(pair):
    name, (js, _), (ts, _) = pair
    for f in ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0", "mv1"):
        _close(getattr(ts.prims, f), getattr(js.prims, f))
    for f in ("n", "has_motion", "has_box", "kind_segments",
              "kinds_present", "sphere_rots"):
        assert getattr(ts.prims, f) == getattr(js.prims, f), f
    for f in ("kind", "tex", "param", "behavior_of", "behavior_rep"):
        _close(getattr(ts.materials, f), getattr(js.materials, f))
    for f in ("kinds_present", "n_behaviors", "light_tex_kinds"):
        assert getattr(ts.materials, f) == getattr(js.materials, f), f
    for f in ("kind", "c0", "c1", "v0", "v1", "f0", "f1", "i0", "images",
              "image_hw"):
        _close(getattr(ts.textures, f), getattr(js.textures, f))
    if name == "segmented":
        assert ts.prims.kind_segments is not None


def test_packed_tables_equal(pair):
    """pack_prims (plain and behaviour-collapsed), pack_materials,
    pack_behaviors and pack_targets."""
    _, (js, jset), (ts, tset) = pair
    _close(tik.pack_prims(ts.prims), jik.pack_prims(js.prims))
    jm, tm = js.materials, ts.materials
    jtex = jm.tex[js.prims.mat]
    jalb = jnp.where((js.textures.kind[jtex] == 0)[:, None],
                     js.textures.c0[jtex], 0.0)
    from raytrace_tpu_torch.render.integrator import bounce_tables
    tb = bounce_tables(ts, tset)
    _close(tb.ptbl, jik.pack_prims(
        js.prims, mat_override=jm.behavior_of[js.prims.mat], albedo=jalb,
        param=jm.param[js.prims.mat]))
    _close(tbk.pack_materials(tm, ts.textures),
           jbk.pack_materials(jm, js.textures))
    _close(tbk.pack_behaviors(tm, ts.textures),
           jbk.pack_behaviors(jm, js.textures))
    _close(tb.mtbl, jbk.pack_behaviors(jm, js.textures))
    _close(tb.ttbl, jbk.pack_targets(jset.redirect_prob, jset.redirect_q,
                                     jset.redirect_u, jset.redirect_v))


def test_camera_tables_equal(pair):
    """pack_cam (camera frame, rr_min, background color) and pack_kt."""
    _, (_, jset), (_, tset) = pair
    color = np.asarray([0.1, 0.2, 0.3], np.float32)
    _close(titk.pack_cam(tset, tframe(tset), color),
           jitk.pack_cam(jset, jframe(jset), color)[0])
    for seed in (0, 9, 2 ** 32 + 5):
        _close(titk.pack_kt(trng.base_key(seed), 199),
               jitk.pack_kt(jrng.base_key(seed), 199)[0])


def test_scan_bound_and_eligibility(pair):
    """The scan visits only the real rows of an unsegmented table (pad
    rows trailing) and the whole of a segmented one; both packages agree
    on whether the bounce kernel takes the scene."""
    from raytrace_tpu.render import integrator as jint
    from raytrace_tpu_torch.render import integrator as tint
    _, (js, jset), (ts, tset) = pair
    assert tint._n_scan_prims(ts.prims) == jint._n_scan_prims(js.prims)
    assert tint.bounce_kernel_eligible(ts, tset, 4096) \
        == jint.bounce_kernel_eligible(js, jset, 4096, interpret=True,
                                       forward_only=True)


def test_unported_features_raise():
    """The fused differentiable step refuses media (as the JAX package's
    does: their gradients take the generic differentiable bounce); the
    native .obj parser and the BVH accelerator mode, which raised until
    they were ported, now work (``tests/test_torch_obj_native.py``,
    ``tests/test_torch_bvh_mode.py``); lights with rich textures render
    through the generic bounce; stationary renders of 8192 rows and more
    take the sorted driver (``tests/test_torch_sorted.py``) instead of
    raising."""
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.fused_iter import fused_loop
    from raytrace_tpu_torch.render.render import uses_sorted
    from raytrace_tpu_torch.scene.obj import parse_obj
    from raytrace_tpu_torch.testing import uv_sphere
    assert parse_obj("v 0 0 0\n", native=True).vertices.tolist() == [
        [0.0, 0.0, 0.0]]
    v, f = uv_sphere(47, 90)
    big = trt.compile_scene(trt.with_material(
        trt.lambertian(trt.constant_texture(0.5)),
        trt.triangle_mesh(trt.Mesh(v, np.zeros((0, 2)), f,
                                   np.full_like(f, -1)))), device="cpu")
    assert big.prims.kind.shape[0] >= 8192 and uses_sorted(big)
    fog = trt.compile_scene(trt.with_material(
        trt.isotropic(trt.constant_texture(0.5)),
        trt.constant_medium(0.1, trt.sphere([0, 0, 0], 1))), device="cpu")
    with pytest.raises(NotImplementedError, match="generic differentiable "
                                                  "bounce"):
        fused_loop(fog, trt.CameraSettings(image_width=8,
                                           samples_per_pixel=1),
                   rng.base_key(0), 1, 0)
    bvh_scene = trt.compile_scene(trt.with_material(
        trt.lambertian(trt.constant_texture(0.5)),
        trt.sphere([0, 0, 0], 1)), accel="bvh", device="cpu")
    assert bvh_scene.bvh is not None and bvh_scene.bvh.n_nodes == 1
    assert bvh_scene.prims.kind_segments is None
    world = trt.with_material(
        trt.light_source(trt.marble_texture([0, 0, 1], 2.0)),
        trt.sphere([0, 0, -2], 1))
    scene = trt.compile_scene(world, device="cpu")
    img = trt.render(scene, trt.CameraSettings(image_width=8,
                                               samples_per_pixel=1))
    assert bool(torch.isfinite(img).all())      # the generic bounce


def test_interop_round_trip():
    """scene_from_numpy(scene_to_numpy(JAX scene)) packs the same tables
    as the port's own compiler."""
    from raytrace_tpu_torch.interop import scene_from_numpy, scene_to_numpy
    from raytrace_tpu_torch.render.integrator import bounce_tables
    js, _ = _cornell_scene_and_settings(64, 8, 10)
    ts, tset = cornell_scene_and_settings(64, 8, 10, device="cpu")
    ps = scene_from_numpy(scene_to_numpy(js), device="cpu")
    a, b = bounce_tables(ps, tset), bounce_tables(ts, tset)
    assert torch.equal(a.ptbl, b.ptbl) and torch.equal(a.mtbl, b.mtbl)
    assert (a.n_prims, a.n_mats) == (b.n_prims, b.n_mats) == (18, 2)


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` a scene goes to the card: where there is
    none, the call raises instead of landing on the CPU (on a machine
    with a card ``tests/test_torch_cuda.py`` checks the scene's device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from raytrace_tpu_torch.interop import scene_from_numpy, scene_to_numpy
    world = trt.with_material(trt.lambertian(trt.constant_texture(0.5)),
                              trt.sphere([0, 0, 0], 1))
    js, _ = _cornell_scene_and_settings(16, 1, 2)
    for call in (lambda: trt.compile_scene(world),
                 lambda: scene_from_numpy(scene_to_numpy(js)),
                 lambda: cornell_scene_and_settings(16, 1, 2),
                 lambda: all_materials_scene()):
        with pytest.raises((AssertionError, RuntimeError)):
            call()
