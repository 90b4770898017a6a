"""Object-space uv of rotated sphere instances against the JAX package's,
on the CPU.

The compiler records a world-to-object rotation for each rotated sphere
whose material reads uv (``Primitives.sphere_rots``); the uv is then
evaluated on the outward normal turned into object space.

* ``ops/intersect.py:apply_sphere_rotations`` against JAX's on random
  normals and winner indices (listed rows, others, -1 and ellipsoid
  winners ``-2 - e``), rotations about x, y and z: within 1e-6.
* The hit record's uv (``make_hit_record``) on scenes of a rotated
  checker sphere (x, y and z) beside an unrotated one and a ground
  quad, 512 rays, against JAX's ``make_hit_record``: the winner equal on
  every ray, uv within 1e-4 (periodic in u) where a sphere is hit.
* The split path's ``surface_hit`` (K8's plain version, then the torch
  uv) against JAX's ``pallas_nearest_record(interpret=True)`` followed by
  ``apply_sphere_rotations`` and the exact uv: t within 1e-5 relative,
  the winner and the flags equal, uv within 1e-4.
* ``DiffSurfaceHit``'s uv against ``make_diff_surface_hit``'s, and the
  VJP of a random cotangent on its uv and normal with respect to the
  table and the rays: within 1e-4 of JAX's norm in the L2 norm.
* K10's plain version with ``sphere_rots`` (``testing.sphere_rot_inputs``
  on ``testing.rotated_spheres_scene``: sphere flag 1 on sphere lanes,
  checker spheres of which 32 are rotated, some lanes given ellipsoid
  winner indices) against JAX's ``shade_megakernel(interpret=True,
  sphere_rots=...)``: the flags equal on all but 1% of
  the lanes, floats within atol 2e-3 + rtol 1e-3 where they agree (the
  tolerance of ``tests/test_torch_shade.py``); the rotation moves the
  rotated lanes' uv.
* ``csrc/shade_kernel.cu`` built with g++ (``testing.host_library``, its
  blocks of 128 host threads staging the tables) against ``shade_plain``
  with and without the rotation table and a medium: the exact rows equal
  on every lane, floats within ``testing.ATOL`` + ``testing.RTOL``
  |plain| (the host's ``sinf``/``cosf`` may round an ulp apart).
* Compiled ``sphere_rots`` equal to JAX's: rotated checker and image
  spheres are listed, a rotated cloud of constant-textured spheres is
  pruned.
* The render-level probe of ``tests/test_rotated_sphere_uv.py``: a light
  whose texture is its uv, on a sphere rotated a quarter turn about y,
  traced by ``integrator.trace`` (the generic bounce): u 0.25 at the
  probe point (0.5 unrotated), v unchanged, and JAX's ``trace`` alike
  within 1e-4.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.ops.diff_intersect import make_diff_surface_hit
from raytrace_tpu.ops.intersect import apply_sphere_rotations as japply
from raytrace_tpu.ops.intersect import make_hit_record as jrecord
from raytrace_tpu.ops.intersect import nearest_hit_t as jnearest
from raytrace_tpu.ops.pallas import bounce_kernel as jbk
from raytrace_tpu.ops.pallas.intersect_kernel import (
    pack_clusters as jpack_clusters, pack_prims as jpack_prims,
    pallas_nearest_record as jpallas_nearest,
)
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.ops import bounce_kernel as bk
from raytrace_tpu_torch.ops.diff_intersect import diff_surface_hit, hit_statics
from raytrace_tpu_torch.ops.intersect import (
    apply_sphere_rotations, dense_nearest, make_hit_record,
)
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.render.integrator import split_tables, surface_hit
from raytrace_tpu_torch.testing import (
    ATOL, BOUNCE_INT_ROWS, RTOL, earthmap, host_library, max_errs,
    rotated_spheres_scene, sphere_rot_inputs, synthetic_medium,
    torch_threads,
)

N = 512
FRAC_INT = 0.01
CENTER = np.asarray([0.0, 0.0, -3.0])
FLOATS = ("p0", "e1", "e2", "uvs", "mv0", "mv1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _rotation(rt, axis, angle):
    return {"x": rt.rotate_x, "y": rt.rotate_y, "z": rt.rotate_z}[axis](
        angle)


def _rot_world(rt, axis):
    """A checker sphere rotated 0.7 rad about ``axis`` at (0, 0, -3), an
    unrotated checker sphere beside it and a ground quad below."""
    check = rt.lambertian(rt.checker_texture(8, 4, [0.9, 0.2, 0.1],
                                             [0.1, 0.3, 0.9]))
    ground = rt.lambertian(rt.constant_texture(0.5))
    return rt.group([
        rt.transform(rt.compose(rt.translate(CENTER),
                                _rotation(rt, axis, 0.7)),
                     rt.with_material(check, rt.sphere([0, 0, 0], 1.0))),
        rt.with_material(check, rt.sphere([2.2, 0.2, -3.5], 0.8)),
        rt.with_material(ground, rt.parallelogram([-6, -1.2, 0], [12, 0, 0],
                                                  [0, 0, -12])),
    ])


def _pair(axis):
    js = jrt.compile_scene(_rot_world(jrt, axis))
    ts = trt.compile_scene(_rot_world(trt, axis), device="cpu")
    assert len(ts.prims.sphere_rots) == 1
    assert ts.prims.sphere_rots == js.prims.sphere_rots
    return js, ts


def _rays(seed, n=N):
    rg = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    tgt = np.where(rg.uniform(size=(n, 1)) < 0.6, CENTER,
                   [2.2, 0.2, -3.5]) + rg.normal(0, 0.7, (n, 3))
    d = (tgt / np.linalg.norm(tgt, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.zeros(n, np.float32)


def _u_close(a, b, atol):
    """uv within ``atol``, u taken modulo 1 (the seam)."""
    du = np.abs(a[:, 0] - b[:, 0])
    du = np.minimum(du, 1.0 - du)
    return (du <= atol) & (np.abs(a[:, 1] - b[:, 1]) <= atol)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_apply_sphere_rotations_matches_jax(axis):
    rg = np.random.default_rng(1)
    out = rg.normal(size=(N, 3)).astype(np.float32)
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    idx = rg.integers(-4, 8, N).astype(np.int32)
    rots = tuple(
        (row, tuple(np.asarray(_rotation(trt, ax, ang))[:3, :3].T
                    .astype(np.float32).ravel().tolist()))
        for row, ax, ang in ((1, axis, 0.7), (5, "y", -1.1)))
    ref = np.asarray(japply(jnp.asarray(out), jnp.asarray(idx), rots))
    got = apply_sphere_rotations(torch.from_numpy(out),
                                 torch.from_numpy(idx), rots).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    listed = np.isin(idx, [1, 5])
    assert np.array_equal(got[~listed], out[~listed])
    assert np.abs(got[listed] - out[listed]).max() > 0.1


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_hit_record_uv_matches_jax(axis):
    js, ts = _pair(axis)
    o, d, tm = _rays(2)
    jo, jd, jt = (jnp.asarray(x) for x in (o, d, tm))
    jt_hit, jidx = jnearest(js.prims, None, jo, jd, jt,
                            jnp.full((N,), 1e-3), jnp.full((N,), jnp.inf))
    jrec = jrecord(js.prims, jidx, jo, jd, jt,
                   jnp.where(jnp.isfinite(jt_hit), jt_hit, 1.0))
    to, td, tt = (torch.from_numpy(x) for x in (o, d, tm))
    t_hit, idx = dense_nearest(ts.prims, to, td, tt, torch.full((N,), 1e-3),
                               torch.full((N,), float("inf")))
    rec = make_hit_record(ts.prims, idx, to, td, tt,
                          torch.where(torch.isfinite(t_hit), t_hit, 1.0))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    kind = ts.prims.kind.numpy()[np.maximum(idx.numpy(), 0)]
    sph = (idx.numpy() >= 0) & (kind == 0)
    rot_row = ts.prims.sphere_rots[0][0]
    assert (idx.numpy() == rot_row).sum() > 100 and sph.sum() > 200
    ok = _u_close(rec.uv.numpy()[sph], np.asarray(jrec.uv)[sph], 1e-4)
    assert ok.all(), (~ok).sum()


@pytest.mark.parametrize("axis", ["x", "z"])
def test_split_surface_hit_matches_jax_interpret(axis):
    js, ts = _pair(axis)
    o, d, tm = _rays(3)
    s = trt.CameraSettings(t_min=1e-3)
    tb = split_tables(ts, s)
    assert tb.bvh is None and tb.sphere_rots == ts.prims.sphere_rots
    hit = surface_hit(tb, *(torch.from_numpy(x.T.copy())
                            for x in (o, d)), torch.from_numpy(tm))
    resh = lambda x: jnp.asarray(x).reshape(N // 128, 128)
    t, idx, nx, ny, nz, fr, uu, vv, mat = jpallas_nearest(
        jpack_prims(js.prims), jpack_clusters(js.prims),
        *(resh(o[:, k]) for k in range(3)), *(resh(d[:, k]) for k in range(3)),
        resh(tm), n_prims=js.prims.kind.shape[0], t_min=1e-3,
        has_motion=False, interpret=True)
    flat = lambda x: np.asarray(x).reshape(N)
    front = (flat(fr) & 1).astype(bool)
    is_sph = (flat(fr) & 2).astype(bool)
    normal = np.stack([flat(nx), flat(ny), flat(nz)], -1)
    outward = np.asarray(japply(
        jnp.asarray(normal * np.where(front, 1.0, -1.0)[:, None]),
        jnp.asarray(flat(idx)), js.prims.sphere_rots), np.float64)
    su = np.arctan2(outward[:, 0], outward[:, 2]) / (2 * np.pi) + 0.5
    sv = np.arccos(np.clip(-outward[:, 1], -1 + 1e-6, 1 - 1e-6)) / np.pi
    juv = np.stack([np.where(is_sph, su, flat(uu)),
                    np.where(is_sph, sv, flat(vv))], -1)
    assert np.array_equal(hit[1].numpy(), flat(idx).astype(np.float32))
    assert np.array_equal(hit[5].numpy() > 0.5, front)
    hits = np.isfinite(flat(t))
    assert hits.sum() > N // 2
    np.testing.assert_allclose(hit[0].numpy()[hits], flat(t)[hits],
                               rtol=1e-5)
    tuv = np.stack([hit[6].numpy(), hit[7].numpy()], -1)
    ok = _u_close(tuv[hits], juv[hits], 1e-4)
    assert ok.all(), (~ok).sum()


def test_diff_surface_hit_uv_and_vjp_match_jax():
    js, ts = _pair("y")
    o, d, tm = _rays(4)
    p = ts.prims
    s = trt.CameraSettings(t_min=1e-3)
    tb = split_tables(ts, s)
    st = hit_statics(tb, p, tb.t_min)
    assert st.sphere_rots == p.sphere_rots
    jhit = make_diff_surface_hit(False, tb.t_min, False, has_box=p.has_box,
                                 sphere_rots=js.prims.sphere_rots)
    ints_f = (jnp.asarray(p.kind.numpy(), jnp.float32),
              jnp.asarray(p.mat.numpy(), jnp.float32))
    jf = tuple(jnp.asarray(getattr(p, f).numpy()) for f in FLOATS)

    def jfn(f, a, b):
        out = jhit(f, ints_f, a, b, jnp.asarray(tm))
        return (out[2], out[4]), out

    _, vjp, jout = jax.vjp(jfn, jf, jnp.asarray(o), jnp.asarray(d),
                           has_aux=True)
    leaves = [getattr(p, f).clone().requires_grad_(True) for f in FLOATS]
    tin = [torch.from_numpy(x).requires_grad_(True) for x in (o, d)]
    tp = type(p)(**{**{f: getattr(p, f) for f in p.__dataclass_fields__},
                    **dict(zip(FLOATS, leaves))})
    tout = diff_surface_hit(st, tp, *tin, torch.from_numpy(tm))
    jidx = np.asarray(jout[1])
    assert np.array_equal(tout[1].numpy(), jidx)
    hit = jidx >= 0
    ok = _u_close(tout[4].detach().numpy()[hit], np.asarray(jout[4])[hit],
                  1e-4)
    assert ok.all() and (jidx == p.sphere_rots[0][0]).sum() > 100
    rg = np.random.default_rng(9)
    cts = (rg.normal(size=(N, 3)).astype(np.float32),
           rg.normal(size=(N, 2)).astype(np.float32))
    jf_g, *jr_g = vjp(tuple(jnp.asarray(c) for c in cts))
    tg = torch.autograd.grad((tout[2], tout[4]), leaves + tin,
                             [torch.from_numpy(c) for c in cts],
                             allow_unused=True)
    for name, a, b in zip(FLOATS + ("o", "d"), list(jf_g) + jr_g, tg):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(a),
                                                   1e-6), name


def _shade_inputs(seed):
    """K10's inputs with its in-kernel sphere uv
    (``testing.sphere_rot_inputs``) on the camera rays of
    ``testing.rotated_spheres_scene`` at 32 x 32 (1,024 lanes; 32 of its 64
    checker spheres rotated)."""
    ts, s = rotated_spheres_scene(32, device="cpu")
    return (ts,) + sphere_rot_inputs(ts, s, seed)


@pytest.mark.parametrize("with_medium", [False, True])
def test_shade_plain_sphere_rots_matches_jax(with_medium):
    ts, tb, hit, lanes, uni = _shade_inputs(5 + with_medium)
    medium = synthetic_medium(hit[0], tb.n_mats, 7) if with_medium else None
    rots = ts.prims.sphere_rots
    kw = dict(n_mats=tb.n_mats, n_targets=tb.n_targets,
              has_medium=with_medium)
    out = bk.shade_megakernel(tb.mtbl, tb.ttbl, hit, medium, lanes, uni,
                              sphere_rots=rots, **kw)
    ref = bk.shade_plain(tb.mtbl, tb.ttbl, hit, medium, lanes, uni,
                         sphere_rots=rots, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    n = hit[0].shape[0]
    g = n // 128
    j = lambda x: jnp.asarray(x.numpy().reshape(g, 128))
    jout = jbk.shade_megakernel(
        jnp.asarray(tb.mtbl.numpy()), jnp.asarray(tb.ttbl.numpy()),
        tuple(j(x) for x in hit),
        tuple(j(x) for x in medium) if with_medium else None,
        tuple(j(x) for x in lanes), jnp.asarray(uni.numpy().reshape(8, g,
                                                                    128)),
        interpret=True, sphere_rots=rots, **kw)
    jout = [np.asarray(x).reshape(n) for x in jout]
    out = [x.numpy() for x in out]
    agree = np.ones(n, bool)
    for k in BOUNCE_INT_ROWS:
        agree &= out[k] == jout[k]
    assert (~agree).mean() <= FRAC_INT, (~agree).mean()
    for k in range(15):
        np.testing.assert_allclose(out[k][agree], jout[k][agree], rtol=1e-3,
                                   atol=2e-3, err_msg=str(k))
    # the rotation changes the checker's cell on some rotated lanes
    plain0 = bk.shade_plain(tb.mtbl, tb.ttbl, hit, medium, lanes, uni, **kw)
    rot_lane = np.isin(hit[1].numpy(), [r for r, _ in rots]) \
        & (lanes[9].numpy() > 0.5)
    moved = np.abs(plain0[6].numpy() - out[6]) > 1e-3
    assert (moved & rot_lane).sum() > 10
    assert not (moved & ~rot_lane).any()


_RUN = r"""
// The grid on the host: blocks of 128 threads, one lane a thread, each
// block staging the material and target tables behind its barrier.
extern "C" int run_shade(const ShadeArgs* a) {
  rt_host_launch(static_cast<int>((a->n_lanes + kThreads - 1) / kThreads),
                 kThreads, [&] { shade_kernel(*a); });
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_shade(tmp_path_factory):
    lib = host_library("shade_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("shade_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_shade.argtypes = [ctypes.c_void_p]

    def run(tb, hit, medium, lanes, uni, rots):
        r = hit[0].shape[0]
        out = torch.empty((bk.N_OUT, r))
        table = bk.sphere_rot_table(rots, torch.device("cpu")) if rots \
            else None
        med = tuple(medium) if medium is not None else (None, None)
        ins = [None if x is None else x.contiguous()
               for x in (tb.mtbl, tb.ttbl) + tuple(hit) + med + tuple(lanes)
               + (uni, table)]
        args = bk._ShadeArgs(
            *(None if x is None else x.data_ptr() for x in ins + [out]),
            r, tb.n_mats, tb.n_targets, int(medium is not None), len(rots))
        lib.run_shade(ctypes.byref(args))
        return tuple(out.unbind(0))
    return run


@pytest.mark.parametrize("with_rots", [False, True])
@pytest.mark.parametrize("with_medium", [False, True])
def test_host_build_of_shade_kernel_matches_plain(host_shade, with_rots,
                                                  with_medium):
    ts, tb, hit, lanes, uni = _shade_inputs(11)
    medium = synthetic_medium(hit[0], tb.n_mats, 8) if with_medium else None
    rots = ts.prims.sphere_rots if with_rots else ()
    ref = bk.shade_plain(tb.mtbl, tb.ttbl, hit, medium, lanes, uni,
                         n_mats=tb.n_mats, n_targets=tb.n_targets,
                         has_medium=with_medium, sphere_rots=rots)
    out = host_shade(tb, hit, medium, lanes, uni, rots)
    n_int, _, excess = max_errs(ref, out, BOUNCE_INT_ROWS)
    assert n_int == 0 and excess <= 0.0, (n_int, excess, ATOL, RTOL)
    assert int((out[12] > 0.5).sum()) > out[12].shape[0] // 20


def _uv_mats_world(rt):
    """Rotated spheres: a cloud of 50 constant-textured ones (uv-blind),
    one checker and one image-textured (earth) one, and an unrotated
    checker sphere."""
    rg = np.random.default_rng(3)
    check = rt.lambertian(rt.checker_texture(4, 4, 0.2, 0.8))
    return rt.group([
        rt.transform(rt.rotate_y(0.3), rt.with_material(
            rt.lambertian(rt.constant_texture(0.7)),
            rt.spheres(rg.uniform(-5, 5, (50, 3)), np.full(50, 0.3)))),
        rt.transform(rt.compose(rt.translate([0, 0, -4]), rt.rotate_x(1.0)),
                     rt.with_material(check, rt.sphere([0, 0, 0], 1.0))),
        rt.transform(rt.compose(rt.translate([3, 0, -4]),
                                rt.rotate_y(np.pi / 2)),
                     rt.with_material(rt.lambertian(
                         rt.image_texture(earthmap())),
                         rt.sphere([0, 0, 0], 1.0))),
        rt.with_material(check, rt.sphere([-3, 0, -4], 1.0)),
    ])


def test_compiled_sphere_rots_equal_jax_and_prune_uv_blind_spheres():
    js = jrt.compile_scene(_uv_mats_world(jrt))
    ts = trt.compile_scene(_uv_mats_world(trt), device="cpu")
    assert ts.prims.sphere_rots == js.prims.sphere_rots
    assert len(ts.prims.sphere_rots) == 2
    np.testing.assert_array_equal(ts.prims.p0.numpy(),
                                  np.asarray(js.prims.p0))
    for row, r9 in ts.prims.sphere_rots:
        assert int(ts.prims.kind[row]) == 0
        r = np.asarray(r9).reshape(3, 3)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)


def _probe(rt, trace_fn, keys_fn, world):
    scene = rt.compile_scene(world) if rt is jrt else \
        rt.compile_scene(world, device="cpu")
    s = rt.CameraSettings(
        center=np.zeros(3), look_at=np.asarray(CENTER), vfov=0.02,
        image_width=1, aspect_ratio=1.0, samples_per_pixel=1, max_depth=2,
        background=rt.const_background(0.0))
    o = np.zeros((8, 3), np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (8, 1))
    return trace_fn(scene, s, o, d, np.zeros(8, np.float32), keys_fn(8))[0]


def test_render_level_uv_probe_matches_jax():
    from raytrace_tpu.core import rng as jrng
    from raytrace_tpu.render.integrator import trace as jtrace

    def worlds(rt, tex):
        light = rt.light_source(tex)
        return (rt.with_material(light, rt.sphere(CENTER, 1.0)),
                rt.transform(rt.compose(rt.translate(CENTER),
                                        rt.rotate_y(np.pi / 2)),
                             rt.with_material(light,
                                              rt.sphere([0, 0, 0], 1.0))))

    jtex = jrt.uv_texture(lambda uv: jnp.stack(
        [uv[..., 0], uv[..., 1], jnp.zeros_like(uv[..., 0])], axis=-1))
    ttex = trt.uv_texture(lambda uv: torch.stack(
        [uv[..., 0], uv[..., 1], torch.zeros_like(uv[..., 0])], dim=-1))
    jkeys = lambda n: jrng.ray_keys_fast(jrng.base_key(0),
                                         jnp.arange(n, dtype=jnp.int32),
                                         jnp.zeros(n, jnp.int32))
    tkeys = lambda n: rng.ray_keys_fast(rng.base_key(0),
                                        torch.arange(n, dtype=torch.int32),
                                        torch.zeros(n, dtype=torch.int32))
    jrun = lambda sc, s, o, d, t, k: np.asarray(jtrace(
        sc, s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), k))
    trun = lambda sc, s, o, d, t, k: integrator.trace(
        sc, s, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
        k).numpy()
    tw = worlds(trt, ttex)
    sc = trt.compile_scene(tw[1], device="cpu")
    assert integrator._bounce_step(sc, trt.CameraSettings(), 8)[0] \
        is integrator.bounce_generic_soa
    plain, rot = (_probe(trt, trun, tkeys, w) for w in tw)
    jplain, jrot = (_probe(jrt, jrun, jkeys, w) for w in worlds(jrt, jtex))
    assert abs(plain[0] - 0.5) < 1e-4      # unrotated u at +z
    assert abs(rot[0] - 0.25) < 1e-4       # rotated by a quarter turn
    assert abs(plain[1] - rot[1]) < 1e-4
    np.testing.assert_allclose(plain, jplain, atol=1e-4)
    np.testing.assert_allclose(rot, jrot, atol=1e-4)
