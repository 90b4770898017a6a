"""The medium crossing kernels K11 and K11b (``ops/volume_kernel.py``,
``csrc/volume_kernel.cu``) on the CPU.

* ``_chunk_plans`` and ``pack_chunk_boxes`` equal the JAX package's, and
  the packed boundary rows agree as ``tests/test_torch_mesh_scene.py``
  holds packed tables.
* ``volume_crossings_plain`` (the plain version of both kernels) against
  the JAX package's ``pallas_volume_crossings`` and
  ``pallas_volume_crossings_bcast`` in interpret mode, as
  ``tests/test_volume_kernel.py`` runs them: a fog ball and an
  axis-aligned smoke box (a ``PRIM_BOX`` row), still and moving; the
  octahedron mesh boundary (shared edges); the stand-in pawn's 1,200-row
  boundary; rays from inside every medium and a lane parked at 3e18.
  The front flags equal on every lane, the crossings within JAX's own
  rtol/atol 1e-5 (XLA's CPU backend contracts multiply-adds into FMAs, so
  a root differs by a few ulps).  JAX's two kernels also agree with each
  other there; the plain version follows their fold (row order, the
  entering root first, strict ``<``), not the XLA scan's.
* The CUDA source built for the host with g++ (``testing.host_library``)
  against the plain version on the same scenes and on cornell_smoke's
  camera rays and their second bounce: flags equal, every crossing equal
  on all but at most 1% of lanes and there within 1e-5 relative (torch's
  CPU ``sqrt`` can round a sphere root the other way next to a midpoint;
  the smoke holds the kernels on the card to equality).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.ops.pallas import volume_kernel as jvk
from raytrace_tpu.ops.pallas.intersect_kernel import pack_prims as jpack
from raytrace_tpu_torch.ops import volume_kernel as tvk
from raytrace_tpu_torch.ops.intersect_kernel import pack_prims
from raytrace_tpu_torch.render.volumes import crossing_kw, volume_tables
from raytrace_tpu_torch.testing import (
    host_library, media_bounce_rays, pawn_inside_rays, pawn_standin_world,
    torch_threads, volume_rays, volume_test_world,
)

T_MIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def octahedron_world(rt):
    """``tests/test_volume_kernel.py``'s closed octahedron medium (8
    triangles, shared edges everywhere) over a ground sphere."""
    v = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [0, 0, 1], [0, 0, -1]], np.float64)
    f = np.asarray([(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
                    (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)], np.int64)
    mesh = rt.Mesh(vertices=v, uv=np.zeros((0, 2)), faces=f,
                   uv_faces=np.full((8, 3), -1, np.int64))
    return rt.group([
        rt.with_material(rt.isotropic(rt.constant_texture([1.0, 0.2, 0.2])),
                         rt.constant_medium(2.0, rt.triangle_mesh(mesh))),
        rt.with_material(rt.lambertian(rt.constant_texture(0.5)),
                         rt.sphere([0, -50, 0], 40.0)),
    ])


# world, ray box, points inside the media
CASES = {
    "ball_box": (lambda rt: volume_test_world(rt), (-6.0, 6.0),
                 ([0.0, 0.0, -3.0], [3.2, 0.0, -3.5])),
    "ball_box_moving": (lambda rt: volume_test_world(rt, True), (-6.0, 6.0),
                        ([0.3, 0.1, -3.2], [3.5, 0.1, -3.6])),
    "octahedron": (octahedron_world, (-3.0, 3.0), ([0.0, 0.0, 0.0],
                                                  [0.2, 0.1, -0.3])),
    "pawn": (pawn_standin_world, (-3.0, 6.0), ()),
}


def _case(name, n, seed):
    world, box, inside = CASES[name]
    ts = trt.compile_scene(world(trt), accel="dense", device="cpu")
    js = jrt.compile_scene(world(jrt), accel="dense")
    rays = volume_rays(n, seed, box, inside)
    if name == "pawn":
        rays[:, :n // 4] = pawn_inside_rays(n // 4, seed + 1)
    return ts, js, rays


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_plans_and_boxes_match_jax(name):
    ts, js, _ = _case(name, 128, 0)
    sl = tuple(zip(ts.volumes.starts, ts.volumes.counts))
    assert sl == tuple(zip(js.volumes.starts, js.volumes.counts))
    assert tvk._chunk_plans(sl) == jvk._chunk_plans(sl)
    np.testing.assert_array_equal(
        tvk.pack_chunk_boxes(ts.volumes.prims, sl).numpy(),
        np.asarray(jvk.pack_chunk_boxes(js.volumes.prims, sl)))
    # the packed boundary rows: tests/test_torch_mesh_scene.py's
    # tolerance (XLA contracts the cross products into multiply-adds)
    t = pack_prims(ts.volumes.prims).numpy()
    j = np.asarray(jpack(js.volumes.prims))
    np.testing.assert_array_equal(t[:, 16:18], j[:, 16:18])
    np.testing.assert_allclose(t, j, rtol=1e-6,
                               atol=1e-6 * float(np.abs(j).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_crossings_match_jax_kernels(name):
    n = 512
    ts, js, rays = _case(name, n, 3)
    kw = crossing_kw(ts.volumes, T_MIN)
    ref = [x.numpy() for x in tvk.volume_crossings_plain(
        pack_prims(ts.volumes.prims), *rays, **kw)]
    jr = [jnp.asarray(x.numpy().reshape(n // 128, 128)) for x in rays]
    jtbl = jpack(js.volumes.prims)
    outs = [jvk.pallas_volume_crossings_bcast(
        jtbl, jvk.pack_chunk_boxes(js.volumes.prims, kw["slices"]), *jr,
        interpret=True, **kw)]
    if name != "pawn":      # the scalar kernel over 1,200 rows is slow
        outs.append(jvk.pallas_volume_crossings(jtbl, *jr, interpret=True,
                                                **kw))
    for jo in outs:
        jo = [np.asarray(x).reshape(-1) for x in jo]
        for k, (a, b) in enumerate(zip(ref, jo)):
            if k % 3 == 1:
                np.testing.assert_array_equal(a, b, err_msg=f"front {k}")
            else:
                assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=f"t {k}")
    if len(outs) == 2:      # JAX's two kernels agree with each other
        for a, b in zip(*outs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for v in range(len(kw["slices"])):
        t1, t2 = ref[3 * v], ref[3 * v + 2]
        assert np.isfinite(t1).sum() > 20, v         # crossings exercised
        assert (ref[3 * v + 1] == 0.0)[np.isfinite(t1)].any(), v  # inside
        assert np.all(t2[np.isfinite(t2)] > t1[np.isfinite(t2)]), v
        assert not np.isnan(t1[-1]) and not np.isnan(t2[-1])  # parked


def test_cpu_wrappers_run_the_plain_version():
    ts, _, rays = _case("octahedron", 256, 5)
    vtbl, _ = volume_tables(ts.volumes)
    kw = crossing_kw(ts.volumes, T_MIN)
    cbox = tvk.pack_chunk_boxes(ts.volumes.prims, kw["slices"])
    n0 = (tvk.pallas_volume_crossings.launches,
          tvk.pallas_volume_crossings_bcast.launches)
    ref = tvk.volume_crossings_plain(vtbl, *rays, **kw)
    for out in (tvk.pallas_volume_crossings(vtbl, *rays, **kw),
                tvk.pallas_volume_crossings_bcast(vtbl, cbox, *rays, **kw)):
        for a, b in zip(ref, out):
            assert torch.equal(a, b)
    assert (tvk.pallas_volume_crossings.launches,
            tvk.pallas_volume_crossings_bcast.launches) == n0


_RUN = r"""
extern "C" int run_vol(const VolArgs* a, int chunked) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long l = 0; l < a->n_lanes; ++l) {
    blockIdx.x = static_cast<unsigned>(l);
    if (chunked)
      volume_chunked_kernel(*a);
    else
      volume_crossings_kernel(*a);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_vol(tmp_path_factory):
    lib = host_library("volume_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("vol_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_vol.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _host_crossings(lib, volumes, rays, chunked: bool):
    """The host build's crossings and rows tested per ray (chunked)."""
    vtbl, _ = volume_tables(volumes)
    kw = crossing_kw(volumes, T_MIN)
    cbox = tvk.pack_chunk_boxes(volumes.prims, kw["slices"])
    r = rays.shape[1]
    rays = [x.contiguous() for x in rays.unbind(0)]
    out = torch.empty((3 * volumes.n_volumes, r))
    tested = torch.zeros(r, dtype=torch.int32)
    nv = volumes.n_volumes
    pad = [0] * (tvk.MAX_VOLUMES - nv)
    args = tvk._VolArgs(
        *(x.data_ptr() for x in [vtbl, cbox] + rays + [out, tested]), r, nv,
        int(kw["has_motion"]), int(kw["has_box"]), kw["t_min"],
        (ctypes.c_int * tvk.MAX_VOLUMES)(*volumes.starts, *pad),
        (ctypes.c_int * tvk.MAX_VOLUMES)(*volumes.counts, *pad))
    lib.run_vol(ctypes.byref(args), int(chunked))
    return list(out.unbind(0)), tested


def _cornell_smoke_rays():
    from raytrace_tpu_torch.testing import cornell_smoke_scene
    sc, s = cornell_smoke_scene(24, 1, 10, device="cpu")
    rays = [c for c, _ in media_bounce_rays(sc, s, 7)]
    return sc, torch.cat(rays, 1)


@pytest.mark.parametrize("name", sorted(CASES) + ["cornell_smoke"])
def test_host_build_of_crossing_kernels_matches_plain(host_vol, name):
    if name == "cornell_smoke":
        ts, rays = _cornell_smoke_rays()
    else:
        ts, _, rays = _case(name, 1024, 11)
    vol = ts.volumes
    vtbl, _ = volume_tables(vol)
    ref = tvk.volume_crossings_plain(vtbl, *rays,
                                     **crossing_kw(vol, T_MIN))
    for chunked in (False, True):
        out, tested = _host_crossings(host_vol, vol, rays, chunked)
        differ = torch.zeros(rays.shape[1], dtype=torch.bool)
        for k, (a, b) in enumerate(zip(ref, out)):
            if k % 3 == 1:
                assert torch.equal(a, b), (chunked, k, int((a != b).sum()))
            else:
                close = (a == b) | (torch.abs(a - b) <= 1e-5 * torch.abs(a))
                assert bool(close.all()), (chunked, k, int((~close).sum()))
                differ |= a != b
        assert float(differ.float().mean()) <= 0.01, (chunked, name)
        if chunked:
            rows = vol.prims.kind.shape[0]
            assert int(tested.max()) <= rows
            if name == "pawn":          # the chunk boxes cull
                assert float(tested.float().mean()) < rows
