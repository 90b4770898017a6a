"""Constant-density media in the port against the JAX package, on the CPU.

* Compiled media: the port's ``Volumes`` (boundary rows in walk order,
  neither permuted nor padded, per-volume slices, densities, material
  ids) and surface table equal the JAX package's exactly on
  cornell_smoke, the sphere-and-box media of ``tests/test_volume_kernel.py``
  still and moving, the octahedron boundary and a scene of media only
  (one ``PRIM_PAD`` surface row); ``interop`` carries them across.
* The scatter candidates (``render/volumes.py``) against the JAX
  package's ``volume_candidates_pallas`` (kernels in interpret mode),
  with draws of exactly 0 on some lanes, which never scatter: the
  candidate's validity equal on every lane, t within rtol/atol 1e-5; the
  bounce's nearest medium (``medium_hit``) against JAX's candidates
  folded by a strict ``<``: the material id too equal on every lane.
* The prepared launches of ``volume_tables``: K11's planar
  instantiation chosen for planar boundaries only, and refused tables.
* The bounce's uniform columns with one and two media equal JAX's
  ``uniform_block(keys, 8 + V + 6)`` bit for bit.
* cornell_smoke rendered by both packages at seed 0, depth 10, 8 spp:
  32 x 32 (the work queue) and 128 x 128 (the stationary driver,
  rotate_k 8).  As in ``tests/test_torch_render.py``: the image mean
  within rtol 2e-3, the median pixel equal to f32 rounding, under 5% of
  pixels differing by more than 1e-5 (measured 0.4%: XLA's CPU backend
  contracts multiply-adds, so a few paths resolve a hit, a crossing or a
  free flight differently), and the mean |difference| far below
  ``PARITY.md``'s noise floor of 0.0151 (measured 3e-5).
* Beer-Lambert transmission of a pitch-black fog ball (from outside and
  from its center) and the lossless white furnace, as JAX
  ``tests/test_volumes.py``, through the port's render: within atol 0.02
  of ``exp(-density * length)`` and of 1.
* Media stay off kernels A and B and the fused branch at 1 spp (the
  fused differentiable step refuses them, as the JAX package's does);
  their gradients take the generic differentiable bounce.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.render.render import render_accumulate as jrender
from raytrace_tpu.render.volumes import volume_candidates_pallas
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.interop import (
    fields_to_numpy, scene_from_numpy, scene_to_numpy, settings_from_numpy,
)
from raytrace_tpu_torch.render.integrator import n_bounce_uniforms
from raytrace_tpu_torch.render.render import render_accumulate as trender
from raytrace_tpu_torch.render.volumes import volume_candidates_kernel
from raytrace_tpu_torch.testing import (
    cornell_smoke_settings, cornell_smoke_world, many_media_settings,
    many_media_world, torch_threads, volume_rays, volume_test_world,
)
from test_torch_volume_kernel import octahedron_world


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def media_only_world(rt):
    return rt.with_material(rt.pitch_black(),
                            rt.constant_medium(0.4, rt.sphere([0, 0, 0], 1.5)))


WORLDS = {
    "cornell_smoke": cornell_smoke_world,
    "ball_box": volume_test_world,
    "ball_box_moving": lambda rt: volume_test_world(rt, True),
    "octahedron": octahedron_world,
    "media_only": media_only_world,
    "many_media": many_media_world,
    "many_media_rotated": lambda rt: many_media_world(rt, 17, True),
}

PRIM_FIELDS = ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0", "mv1")
PRIM_STATICS = ("n", "has_motion", "has_box", "kind_segments",
                "kinds_present", "sphere_rots")


def _assert_prims_equal(tp, jp):
    for f in PRIM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for f in PRIM_STATICS:
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_compiled_volumes_equal_jax(name):
    ts = trt.compile_scene(WORLDS[name](trt), device="cpu")
    js = jrt.compile_scene(WORLDS[name](jrt))
    tv, jv = ts.volumes, js.volumes
    assert tv.starts == jv.starts and tv.counts == jv.counts
    assert tv.n_volumes == jv.n_volumes
    np.testing.assert_array_equal(tv.density.numpy(), np.asarray(jv.density))
    np.testing.assert_array_equal(tv.mat.numpy(), np.asarray(jv.mat))
    _assert_prims_equal(tv.prims, jv.prims)
    _assert_prims_equal(ts.prims, js.prims)
    np.testing.assert_array_equal(ts.materials.kind.numpy(),
                                  np.asarray(js.materials.kind))
    assert tv.prims.kind_segments is None       # never segmented or padded
    assert tv.prims.kind.shape[0] == sum(tv.counts)
    # interop carries the media across, and back
    ti = scene_from_numpy(scene_to_numpy(js), device="cpu")
    assert ti.volumes.starts == tv.starts and ti.volumes.counts == tv.counts
    _assert_prims_equal(ti.volumes.prims, jv.prims)
    np.testing.assert_array_equal(ti.volumes.density.numpy(),
                                  tv.density.numpy())
    back = scene_from_numpy(scene_to_numpy(ts), device="cpu")
    _assert_prims_equal(back.volumes.prims, jv.prims)
    if name == "cornell_smoke":
        assert tv.counts == (6, 6) and ts.prims.n == 6
    if name == "media_only":
        assert ts.prims.n == 0 and ts.prims.kind.tolist() == [-1]


def test_compile_rules():
    sph = trt.sphere([0, 0, 0], 1.0)
    with pytest.raises(ValueError, match="nested"):
        trt.compile_scene(trt.with_material(trt.isotropic(
            trt.constant_texture(1.0)), trt.constant_medium(
                1.0, trt.constant_medium(1.0, sph))), device="cpu")
    with pytest.raises(ValueError, match="material"):
        trt.compile_scene(trt.constant_medium(1.0, sph), device="cpu")
    with pytest.raises(ValueError, match="empty boundary"):
        trt.compile_scene(trt.with_material(trt.pitch_black(),
                                            trt.constant_medium(
                                                1.0, trt.group([]))),
                          device="cpu")
    with pytest.raises(ValueError, match="malformed bvh"):
        scene_from_numpy(dict(scene_to_numpy(jrt.compile_scene(
            media_only_world(jrt))), bvh=object()), device="cpu")


INSIDE = {"ball_box": ([0.0, 0.0, -3.0], [0.0, 0.0, 0.0]),
          "octahedron": ([0.0, 0.0, -3.0], [0.0, 0.0, 0.0]),
          "many_media_rotated": ([-5.0, 0.0, -2.0], [1.0, 0.0, -4.0])}


@pytest.mark.parametrize("name", sorted(INSIDE))
def test_candidates_match_jax(name):
    """``many_media_rotated``: 17 media on a 102-row boundary, so the
    port's crossings come from two launches (16 media, then 1)."""
    n = 512
    ts = trt.compile_scene(WORLDS[name](trt), device="cpu")
    js = jrt.compile_scene(WORLDS[name](jrt))
    nv = ts.volumes.n_volumes
    rays = volume_rays(n, 21, (-3.0, 3.0) if name == "octahedron"
                       else (-6.0, 6.0), INSIDE[name])
    rg = np.random.default_rng(22)
    u = (rg.integers(0, 1 << 16, (n, nv)) / 65536.0).astype(np.float32)
    u[::7] = 0.0                        # pair16 draws can be exactly 0
    o, d, tm = (x.numpy() for x in (rays[0:3], rays[3:6], rays[6]))
    jt, jvalid = volume_candidates_pallas(
        js.volumes, jnp.asarray(o.T), jnp.asarray(d.T), jnp.asarray(tm),
        jnp.full((n,), 1e-3, jnp.float32), jnp.asarray(u), 1e-3,
        interpret=True)
    jt, jvalid = np.asarray(jt), np.asarray(jvalid)
    tt = volume_candidates_kernel(ts.volumes, rays[0:3], rays[3:6], rays[6],
                                  float(np.float32(1e-3)),
                                  torch.from_numpy(u.T.copy()))
    tt = torch.stack(tt, 1).numpy()
    np.testing.assert_array_equal(np.isfinite(tt), jvalid)
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-5)
    assert jvalid.sum() > 20
    assert not np.isfinite(tt[::7]).any()      # a 0 draw never scatters


@pytest.mark.parametrize("name", sorted(INSIDE))
def test_medium_hit_matches_jax(name):
    """``medium_hit`` (the bounce's nearest medium: on the CPU the plain
    crossings, each medium's candidate and the fold) against the JAX
    package's ``volume_candidates_pallas`` (kernels in interpret mode)
    folded in medium order by a strict ``<``, from rays outside and
    inside the media, with draws of exactly 0: which lanes scatter and
    the medium's material id equal on every lane, the distance within
    rtol/atol 1e-5.  ``many_media_rotated``'s 17 media fold across two
    groups (16, then 1)."""
    from raytrace_tpu_torch.render.volumes import medium_hit, volume_tables
    n = 512
    ts = trt.compile_scene(WORLDS[name](trt), device="cpu")
    js = jrt.compile_scene(WORLDS[name](jrt))
    nv = ts.volumes.n_volumes
    rays = volume_rays(n, 31, (-3.0, 3.0) if name == "octahedron"
                       else (-6.0, 6.0), INSIDE[name])
    rg = np.random.default_rng(32)
    u = (rg.integers(0, 1 << 16, (n, nv)) / 65536.0).astype(np.float32)
    u[::5] = 0.0
    o, d, tm = (x.numpy() for x in (rays[0:3], rays[3:6], rays[6]))
    jt, _ = volume_candidates_pallas(
        js.volumes, jnp.asarray(o.T), jnp.asarray(d.T), jnp.asarray(tm),
        jnp.full((n,), 1e-3, jnp.float32), jnp.asarray(u), 1e-3,
        interpret=True)
    jt = np.asarray(jt)
    j_t = np.full(n, np.inf, np.float32)
    j_m = np.zeros(n, np.float32)
    for v, mat in enumerate(np.asarray(js.volumes.mat)):
        better = jt[:, v] < j_t
        j_t = np.where(better, jt[:, v], j_t)
        j_m = np.where(better, np.float32(mat), j_m)
    tables = volume_tables(ts.volumes)
    assert len(tables.launches) == -(-nv // 16)
    t_med, vmat = medium_hit(ts.volumes, tuple(rays.unbind(0)),
                             float(np.float32(1e-3)),
                             torch.from_numpy(u.T.copy()), tables)
    t_med, vmat = t_med.numpy(), vmat.numpy()
    np.testing.assert_array_equal(np.isfinite(t_med), np.isfinite(j_t))
    np.testing.assert_array_equal(vmat, j_m)
    np.testing.assert_allclose(t_med, j_t, rtol=1e-5, atol=1e-5)
    assert np.isfinite(t_med).sum() > 20
    assert not np.isfinite(t_med[::5]).any()     # 0 draws never scatter
    if nv > 1:
        assert len(np.unique(vmat[np.isfinite(t_med)])) > 1


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_prepared_launches_choose_and_refuse(name):
    """``volume_tables`` prepares one launch per group of 16 media: K11's
    planar instantiation exactly for boundaries of unmoving
    parallelograms and triangles (cornell_smoke's boxes, the octahedron),
    K11b's forest for 64+ rows; a prepared launch refuses other tables,
    slices, flags or densities, and ``prepare_volume_launch`` refuses
    what the kernels cannot run."""
    from raytrace_tpu_torch.ops import volume_kernel as tvk
    from raytrace_tpu_torch.render.volumes import (
        crossing_kw, uses_bcast, volume_tables,
    )
    vol = trt.compile_scene(WORLDS[name](trt), device="cpu").volumes
    tables = volume_tables(vol)
    vtbl, forest = tables.vtbl, tables.forest
    planar = name in ("cornell_smoke", "octahedron")
    assert [x.planar for x in tables.launches] == \
        [planar] * len(tables.launches)
    assert (forest is not None) == uses_bcast(vol)
    kw = crossing_kw(vol, 1e-3)
    launch = tables.launches[0]
    g_kw = dict(kw, slices=launch.slices)
    g_forest = launch.forest
    assert tvk.table_args(vtbl, g_forest, g_kw, launch.density, launch.mats,
                          launch) is launch.args
    assert launch.args.planar == int(planar)
    assert launch.args.n_tbl == vtbl.shape[0]
    with pytest.raises(ValueError, match="prepared"):
        tvk.table_args(vtbl.clone(), g_forest, g_kw, prepared=launch)
    with pytest.raises(ValueError, match="prepared"):
        tvk.table_args(vtbl, g_forest, dict(g_kw, slices=launch.slices[:1]
                                            + ((0, 1),)), prepared=launch)
    with pytest.raises(ValueError, match="prepared"):
        tvk.table_args(vtbl, g_forest, dict(g_kw, has_motion=not
                                            g_kw["has_motion"]),
                       prepared=launch)
    with pytest.raises(ValueError, match="prepared"):
        tvk.table_args(vtbl, g_forest, g_kw, launch.density.clone(),
                       launch.mats, prepared=launch)
    prep = dict(slices=launch.slices, has_motion=kw["has_motion"],
                has_box=kw["has_box"])
    if forest is None:
        assert not tvk.prepare_volume_launch(vtbl, **prep,
                                             general=True).planar
    with pytest.raises(ValueError, match="material ids"):
        tvk.prepare_volume_launch(vtbl, g_forest, **prep,
                                  density=launch.density, mats=())
    big = vtbl.new_zeros((tvk.MAX_STAGED_ROWS + 1, vtbl.shape[1]))
    with pytest.raises(ValueError, match="stages at most"):
        tvk.prepare_volume_launch(big, **prep)


@pytest.mark.parametrize("nv", [1, 2])
def test_uniform_columns_with_media(nv):
    world = volume_test_world if nv == 2 else media_only_world
    ts = trt.compile_scene(world(trt), device="cpu")
    assert n_bounce_uniforms(ts) == 8 + nv
    n = 1000
    rg = np.random.default_rng(nv)
    pix = rg.integers(0, 1 << 20, n).astype(np.int32)
    smp = rg.integers(0, 1000, n).astype(np.int32)
    dep = rg.integers(0, 50, n).astype(np.int32)
    jk = jrng.mix_depth(jrng.ray_keys_fast(jrng.base_key(5), pix, smp), dep)
    ju = np.asarray(jrng.uniform_block(jk, 8 + nv + 6))
    tk = rng.mix_depth(rng.ray_keys_fast(rng.base_key(5),
                                         torch.from_numpy(pix),
                                         torch.from_numpy(smp)),
                       torch.from_numpy(dep))
    tu = rng.uniform_cols(tk, n_bounce_uniforms(ts) + 6).T.numpy()
    np.testing.assert_array_equal(tu, ju)


def _assert_renders_match(a, b, n_pix):
    """The render agreement of this file (see the module docstring)."""
    assert b.shape == a.shape == (n_pix, 3)
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < 0.05, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    assert np.abs(a - b).mean() < 0.0151 / 20
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


@pytest.mark.parametrize("width", [32, 128])
def test_cornell_smoke_render_matches_jax(width):
    js = jrt.compile_scene(cornell_smoke_world(jrt))
    jset = cornell_smoke_settings(jrt, width, 8, 10)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    d = fields_to_numpy(jset)
    d["background"] = ("const", (0.0, 0.0, 0.0))
    tset = settings_from_numpy(d)
    jacc, jn = jrender(js, jset, 0, spp=8)
    tacc, tn = trender(ts, tset, 0, spp=8)
    assert tn == jn == 8
    _assert_renders_match(np.asarray(jacc) / 8, tacc.numpy() / 8,
                          width * width)


def test_many_media_render_matches_jax(monkeypatch):
    """17 media (more than one launch of the crossing kernels takes):
    the port launches K11's candidate mode once per group of at most 16
    media, two a bounce, and the render (32 x 32, 8 spp, depth 10, the
    work queue) agrees with the JAX package's, whose forward takes any
    count."""
    from raytrace_tpu_torch.render import volumes
    js = jrt.compile_scene(many_media_world(jrt))
    assert js.volumes.n_volumes == 17
    jset = many_media_settings(jrt, 32, 8, 10)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    d = fields_to_numpy(jset)
    d["background"] = "sky"
    tset = settings_from_numpy(d)
    groups = []
    k11 = volumes.pallas_volume_candidates

    def spy(*a, **kw):
        groups.append(len(kw["slices"]))
        return k11(*a, **kw)
    monkeypatch.setattr(volumes, "pallas_volume_candidates", spy)
    jacc, jn = jrender(js, jset, 0, spp=8)
    tacc, tn = trender(ts, tset, 0, spp=8)
    assert tn == jn == 8
    assert groups[:2] == [16, 1] and len(groups) % 2 == 0
    _assert_renders_match(np.asarray(jacc) / 8, tacc.numpy() / 8, 32 * 32)


def _fog_render(world, center, fog_s, max_depth, spp):
    """Mean radiance of a 16 x 16 render through a narrow camera at
    ``center`` looking down -z, against a white background."""
    sc = trt.compile_scene(world, device="cpu")
    s = trt.CameraSettings(center=center, look_at=[center[0], center[1],
                                                   center[2] - 1.0],
                           vfov=fog_s, image_width=16, max_depth=max_depth,
                           background=trt.const_background(1.0))
    acc, n = trender(sc, s, 0, spp=spp)
    return float((acc / n).mean())


def test_beer_lambert_and_furnace():
    ball = lambda rho, r: trt.with_material(
        trt.pitch_black(), trt.constant_medium(rho, trt.sphere([0, 0, 0], r)))
    # through the center of an absorbing ball: exp(-rho * 2 r)
    got = _fog_render(ball(0.4, 1.5), [0.0, 0.0, 5.0], 1e-3, 8, 16)
    assert abs(got - np.exp(-0.4 * 3.0)) < 0.02, got
    # from the center: exp(-rho * r)
    got = _fog_render(ball(0.5, 2.0), [0.0, 0.0, 0.0], 1e-3, 8, 16)
    assert abs(got - np.exp(-0.5 * 2.0)) < 0.02, got
    # a white isotropic fog scatters without loss
    fog = trt.with_material(trt.isotropic(trt.constant_texture(1.0)),
                            trt.constant_medium(1.0, trt.sphere([0, 0, 0],
                                                                1.0)))
    got = _fog_render(fog, [0.0, 0.0, 5.0], 1e-3, 64, 8)
    assert abs(got - 1.0) < 0.02, got
    # a ball the rays pass beside leaves the background
    got = _fog_render(ball(10.0, 1.0), [0.0, 3.0, 5.0], 1e-3, 4, 1)
    assert got == 1.0


def test_media_stay_off_kernels_a_and_b_and_gradients(monkeypatch):
    from raytrace_tpu_torch.diff.fused_iter import fused_iter_eligible
    from raytrace_tpu_torch.diff.gradients import (
        loss_and_grads, partition,
    )
    from raytrace_tpu_torch.render import integrator
    from raytrace_tpu_torch.render.integrator import (
        _kernel_reason, bounce_kernel_eligible,
    )
    sc = trt.compile_scene(cornell_smoke_world(trt), device="cpu")
    s = cornell_smoke_settings(trt, 16, 1, 4)
    assert not bounce_kernel_eligible(sc, s, 256)
    assert not fused_iter_eligible(sc, s, 256)
    assert "generic differentiable bounce" in _kernel_reason(sc, s, 256,
                                                             8192)
    calls = []
    for name in ("bounce_mega_soa", "fused_iter_fwd_step",
                 "bounce_split_soa"):
        real = getattr(integrator, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(integrator, name, spy)
    # 1 spp at 128 x 128: the stationary driver at rotate_k 1, where a
    # scene kernel B took would have its media dropped
    acc, _ = trender(sc, dataclasses.replace(s, image_width=128), 0, spp=1)
    assert set(calls) == {"bounce_split_soa"}
    assert torch.isfinite(acc).all()
    # the fwd+bwd takes the generic differentiable bounce, once an
    # iteration, never kernels A or B
    calls.clear()
    real = integrator.bounce_generic_soa

    def generic_spy(*a, **k):
        calls.append(("bounce_generic_soa", k.get("diff")))
        return real(*a, **k)
    monkeypatch.setattr(integrator, "bounce_generic_soa", generic_spy)
    params, statics = partition(sc)
    (loss, frac), grads = loss_and_grads(
        params, statics, s, rng.base_key(0),
        torch.arange(128, dtype=torch.int32), torch.zeros((128, 3)), spp=1,
        n_iters=4, remat=False)
    assert calls == [("bounce_generic_soa", True)] * 4
    assert bool(torch.isfinite(loss)) and float(frac) > 0.0
    assert bool(torch.isfinite(grads.volumes.density).all())
    from raytrace_tpu_torch.diff.fused_iter import fused_loop
    with pytest.raises(NotImplementedError, match="generic differentiable "
                                                  "bounce"):
        fused_loop(sc, s, rng.base_key(0), 1, 0)
