"""The flat-scan nearest-hit kernel K8 (``ops/intersect_kernel.py:
pallas_nearest_record``, ``csrc/nearest_flat_kernel.cu``) on the CPU.

* Its plain route (``pallas_nearest_plain``: ``prim_loop_plain`` through
  ``_record_contract``) against the JAX package's
  ``pallas_nearest_record(..., interpret=True)`` with the flat loop, on
  ``noise_test``'s table (two spheres) and on a small table of every
  kind (spheres, parallelograms, a triangle, boxes), still and moving.
  Rays: camera rays, their second bounce and random rays.  Tolerances
  as ``tests/test_torch_allpairs.py``: XLA's CPU backend contracts
  multiply-adds into FMAs, so a grazing ray may resolve to another row on
  at most 1% of lanes; where the winners agree, t within rtol 2e-4 + atol
  3e-5, normal and (planar rows') uv within atol 2e-3 + rtol 1e-3, flags
  and material exactly.
* The CUDA source built for the host with g++ (``testing.host_library``)
  against the plain version: the tables above and the 832-row mixed-kind
  mesh table (four 256-row tiles of shared memory, pad rows inside the
  kind segments), with axis-parallel rays and rays starting on box faces,
  and a table whose rows all appear twice, where the lower row must win.
  The winner, flags and material equal on every ray, every float on all
  but at most 1% of rays and there within 1e-5 relative: torch's CPU
  ``sqrt`` (SLEEF, 0.5001 ulp) can round a sphere's discriminant root the
  other way next to a midpoint, where the host's ``sqrtf`` and the card's
  (and torch's on the card) round correctly; the smoke holds the kernel
  on the card to equality.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.ops.pallas import intersect_kernel as jik
from raytrace_tpu_torch.ops import intersect_kernel as ik
from raytrace_tpu_torch.render.integrator import split_tables, uses_bvh
from raytrace_tpu_torch.testing import (
    host_library, mesh_all_kinds_scene, noise_test_settings,
    noise_test_world,
)
from test_torch_allpairs import mesh_rays
from test_torch_bvh_host import _axis_rays, _box_face_rays

FRAC_IDX = 0.01


def small_world(rt, moving: bool, twice: bool = False):
    """Spheres, parallelograms, a triangle and boxes (under 65 rows: an
    unsegmented table); with ``moving`` a moving sphere and box; with
    ``twice`` every primitive twice."""
    rg = np.random.default_rng(8)
    mats = [rt.lambertian(rt.constant_texture([0.7, 0.5, 0.3])),
            rt.metal(0.2, rt.constant_texture([0.9, 0.8, 0.6])),
            rt.lambertian(rt.checker_texture(3, 2, [0.8, 0.2, 0.1],
                                             [0.1, 0.3, 0.8]))]
    geoms = []
    for k in range(4):
        geoms.append(rt.with_material(mats[k % 3], rt.sphere(
            rg.uniform(-2.5, 2.5, 3), 0.6)))
        c = rg.uniform(-2.5, 2.5, 3)
        box = rt.cuboid(c, c + rg.uniform(0.4, 1.0, 3))
        if moving and k == 1:
            box = rt.moving([0, 0, 0], [0.4, 0.2, -0.3], box)
        geoms.append(rt.with_material(mats[(k + 1) % 3], box))
    sph = rt.sphere([0.0, 0.5, 0.0], 0.5)
    if moving:
        sph = rt.moving([0, 0, 0], [0.0, 0.3, 0.2], sph)
    geoms += [rt.with_material(mats[2], sph),
              rt.with_material(mats[0], rt.parallelogram(
                  [-3, -3, -3], [6, 0, 0], [0, 0, 6])),
              rt.with_material(mats[1], rt.parallelogram(
                  [-3, -3, -3], [0, 6, 0], [0, 0, 6])),
              rt.with_material(mats[2], rt.triangle(
                  [-2, -1, 2], [1, -1, 2.5], [0, 2, 2.2]))]
    return rt.group(geoms + geoms if twice else geoms)


def _settings(rt):
    return rt.CameraSettings(center=[0.0, 1.0, 7.0], look_at=[0.0, 0.0, 0.0],
                             image_width=32, background=rt.sky)


def _pair(case: str):
    if case == "noise_test":
        ts = trt.compile_scene(noise_test_world(trt), device="cpu")
        js = jrt.compile_scene(noise_test_world(jrt))
        return ts, js, noise_test_settings(trt, 32, 1, 4)
    moving = case == "small_moving"
    ts = trt.compile_scene(small_world(trt, moving), device="cpu")
    js = jrt.compile_scene(small_world(jrt, moving))
    return ts, js, _settings(trt)


@pytest.mark.parametrize("case", ["noise_test", "small", "small_moving"])
def test_flat_plain_matches_jax(case):
    ts, js, s = _pair(case)
    p = ts.prims
    assert p.kind_segments is None and not uses_bvh(p)
    assert p.has_motion == (case == "small_moving")
    tb = split_tables(ts, s)
    assert tb.bvh is None and tb.n_prims == p.n
    rays = mesh_rays(ts, s, 1536, 17)
    rays[0:3] = torch.where(torch.abs(rays[0:3]) > 1e17, 1e3, rays[0:3])
    kw = dict(n_prims=tb.n_prims, t_min=tb.t_min, has_motion=tb.has_motion)
    ref = [x.numpy() for x in ik.pallas_nearest_plain(tb.ptbl, *rays, **kw)]
    g = rays.shape[1] // 128
    jr = [jnp.asarray(x.numpy().reshape(g, 128)) for x in rays]
    jx = [np.asarray(o).reshape(-1) for o in jik.pallas_nearest_record(
        jik.pack_prims(js.prims), None, *jr, has_box=js.prims.has_box,
        interpret=True, **kw)]
    hit = np.isfinite(ref[0])
    assert hit.mean() > 0.2 and (ref[1] >= 0).sum() == hit.sum()
    same = ref[1] == jx[1]
    assert (~same).mean() <= FRAC_IDX, (~same).mean()
    ok = same & hit
    np.testing.assert_allclose(ref[0][ok], jx[0][ok], rtol=2e-4, atol=3e-5)
    # normal; u, v of planar rows (a sphere's uv is the caller's, from the
    # normal: the kernels leave 0, the TPU kernel its triangle columns)
    planar = ok & ((ref[5] & 2) == 0)
    for k, sel in ((2, ok), (3, ok), (4, ok), (6, planar), (7, planar)):
        np.testing.assert_allclose(ref[k][sel], jx[k][sel], rtol=1e-3,
                                   atol=2e-3, err_msg=str(k))
    for k in (5, 8):                    # front | sphere << 1, material
        np.testing.assert_array_equal(ref[k][ok], jx[k][ok], err_msg=str(k))
    # the CPU wrapper is the plain version
    n0 = ik.pallas_nearest_record.launches
    out = ik.pallas_nearest_record(tb.ptbl, *rays, **kw)
    assert ik.pallas_nearest_record.launches == n0
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b)


_RUN = r"""
extern "C" int run_flat(const FlatArgs* a) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long l = 0; l < a->n_lanes; ++l) {
    blockIdx.x = static_cast<unsigned>(l);
    nearest_flat_kernel(*a);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_flat(tmp_path_factory):
    lib = host_library("nearest_flat_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("flat_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_flat.argtypes = [ctypes.c_void_p]
    return lib


def _host_record(lib, tb, rays):
    r = rays.shape[1]
    rays = [x.contiguous() for x in rays.unbind(0)]
    outf = torch.empty((6, r))
    outi = torch.empty((3, r), dtype=torch.int32)
    a = ik._FlatArgs(*(x.data_ptr() for x in [tb.ptbl] + rays
                       + [outf, outi]),
                     r, tb.n_prims, int(tb.has_motion), float(tb.t_min))
    lib.run_flat(ctypes.byref(a))
    return (outf[0], outi[0], outf[1], outf[2], outf[3], outi[1], outf[4],
            outf[5], outi[2])


@pytest.mark.parametrize("case", ["noise_test", "small_moving", "twice",
                                  "mesh_832"])
def test_host_build_of_flat_kernel_matches_plain(host_flat, case):
    if case == "mesh_832":
        ts, s = mesh_all_kinds_scene(18, True, device="cpu")
    elif case == "twice":
        ts = trt.compile_scene(small_world(trt, False, twice=True),
                               device="cpu")
        s = _settings(trt)
    else:
        ts, _, s = _pair(case)
    tb = split_tables(ts, s)
    rays = torch.cat([mesh_rays(ts, s, 768, 21), _axis_rays(256, -3, 3, 22),
                      _box_face_rays(ts, 256, 23)], dim=1) \
        if ts.prims.has_box else mesh_rays(ts, s, 768, 21)
    kw = dict(n_prims=tb.n_prims, t_min=tb.t_min, has_motion=tb.has_motion)
    ref = ik.pallas_nearest_plain(tb.ptbl, *rays, **kw)
    out = _host_record(host_flat, tb, rays)
    assert int((ref[1] >= 0).sum()) >= 100
    differ = torch.zeros_like(ref[0], dtype=torch.bool)
    for k, (a, b) in enumerate(zip(ref, out)):
        if k in (1, 5, 8):              # winner, flags, material
            assert torch.equal(a, b), (k, int((a != b).sum()))
        else:
            close = (a == b) | (torch.abs(a - b) <= 1e-5 * torch.abs(a))
            assert bool(close.all()), (k, int((~close).sum()))
            differ |= a != b
    assert float(differ.float().mean()) <= 0.01
    if case == "twice":
        # every hit is on the first copy: rows of the second copy lose ties
        n = ts.prims.n // 2
        p = ts.prims
        key = torch.cat([p.p0, p.e1, p.e2, p.kind[:, None].float()], 1)
        for w in ref[1][ref[1] >= 0].unique():
            same = (key == key[w]).all(1).nonzero()[:, 0]
            assert len(same) == 2 and int(same[0]) == int(w), (w, same, n)
