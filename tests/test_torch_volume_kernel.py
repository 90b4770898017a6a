"""The medium crossing kernels K11 and K11b (``ops/volume_kernel.py``,
``csrc/volume_kernel.cu``) on the CPU.

* ``_chunk_plans`` equal the JAX package's, the root box of each
  medium's tree (``pack_volume_bvh``) lies within the JAX package's
  chunk boxes (``pack_chunk_boxes``) of that medium widened by the tree's
  padding, and the packed boundary rows agree as
  ``tests/test_torch_mesh_scene.py`` holds packed tables.
* ``volume_crossings_plain`` (the plain version of both kernels) against
  the JAX package's ``pallas_volume_crossings`` and
  ``pallas_volume_crossings_bcast`` in interpret mode, as
  ``tests/test_volume_kernel.py`` runs them: a fog ball and an
  axis-aligned smoke box (a ``PRIM_BOX`` row), still and moving; the
  octahedron mesh boundary (shared edges); the stand-in pawn's 1,200-row
  boundary; four media of mixed sizes in one 1,266-row boundary table
  (``testing.mixed_media_world``: the pawn, a ball, a box, a 64-triangle
  mesh), still and moving; rays from inside every medium and a lane
  parked at 3e18.
  The front flags equal on every lane, the crossings within JAX's own
  rtol/atol 1e-5 (XLA's CPU backend contracts multiply-adds into FMAs, so
  a root differs by a few ulps).  JAX's two kernels also agree with each
  other there; the plain version follows their fold (row order, the
  entering root first, strict ``<``), not the XLA scan's.
* The CUDA source built for the host with g++ (``testing.host_library``):
  K11 in blocks of 32 host threads of two rays each that stage the table
  and meet at the barrier (5 rays short of a whole block), and K11b's
  forest walk on its
  persistent grid, 3 blocks of 32 host threads striding over the rays,
  as ``tests/test_torch_bvh_host.py`` runs K9 (the triangle-only
  instantiation on the pawn and the octahedron, the general one
  elsewhere; with and without its counts); both against the plain
  version on the same scenes and on cornell_smoke's camera rays and their
  second bounce: flags equal, every crossing equal on all but at most 1%
  of lanes and there within 1e-5 relative (torch's CPU ``sqrt`` can round
  a sphere root the other way next to a midpoint; the smoke holds the
  kernels on the card to equality).  The candidate mode of both, from a
  fold state an earlier group could have left, against
  ``volume_candidates_plain``: the material id and which lanes scatter
  equal on every lane, ``t_med`` under the crossings' tolerance (the
  host's ``logf`` and torch's CPU ``log`` may round a flight apart; on
  the card the smoke holds it to ``testing.CAND_ULPS``).  K11's planar
  instantiation, which cornell_smoke's boundary prepares, gives the
  general one's bits in both modes.  The walk's work: the pawn stand-in's
  camera rays make on average at most 12 box tests and 4 row tests (its
  256-row chunks tested 209 rows a ray).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.ops.pallas import volume_kernel as jvk
from raytrace_tpu.ops.pallas.intersect_kernel import pack_prims as jpack
from raytrace_tpu_torch.ops import volume_kernel as tvk
from raytrace_tpu_torch.ops.allpairs_kernel import NODE_PAD_ABS, NODE_PAD_REL
from raytrace_tpu_torch.ops.intersect_kernel import pack_prims
from raytrace_tpu_torch.render.volumes import crossing_kw, volume_tables
from raytrace_tpu_torch.testing import (
    MIXED_MEDIA_INSIDE, camera_rays, host_library, media_bounce_rays,
    mixed_media_world, pawn_inside_rays, pawn_standin_scene,
    pawn_standin_world, torch_threads, volume_rays, volume_test_world,
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
    "mixed": (mixed_media_world, (-6.0, 6.0), MIXED_MEDIA_INSIDE),
    "mixed_moving": (lambda rt: mixed_media_world(rt, True), (-6.0, 6.0),
                     MIXED_MEDIA_INSIDE),
}


def _case(name, n, seed):
    world, box, inside = CASES[name]
    ts = trt.compile_scene(world(trt), accel="dense", device="cpu")
    js = jrt.compile_scene(world(jrt), accel="dense")
    rays = volume_rays(n, seed, box, inside)
    if name == "pawn":
        rays[:, :n // 4] = pawn_inside_rays(n // 4, seed + 1)
    return ts, js, rays


def tree_rows_and_box(forest, root):
    """The rows (column ``ORIG_COL``) under ``root`` of ``forest`` and the
    union of its two children's boxes."""
    nodes = forest.nodes.numpy()
    words = nodes.view(np.int32)
    orig = forest.rows[:, 35].numpy().astype(np.int64)
    rows, todo = [], [root]
    while todo:
        w = todo.pop()
        for c in (0, 1):
            word, count = words[w, 12 + c], words[w, 14 + c]
            if count == 0:
                todo.append(word)
            else:
                rows.extend(orig[word:word + count])
    lo = np.minimum(nodes[root, 0:3], nodes[root, 6:9])
    hi = np.maximum(nodes[root, 3:6], nodes[root, 9:12])
    return np.unique(rows), lo, hi


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_plans_and_boxes_match_jax(name):
    ts, js, _ = _case(name, 128, 0)
    sl = tuple(zip(ts.volumes.starts, ts.volumes.counts))
    assert sl == tuple(zip(js.volumes.starts, js.volumes.counts))
    assert tvk._chunk_plans(sl) == jvk._chunk_plans(sl)
    # each medium's tree lies within the JAX package's chunk boxes of the
    # medium (they pad planar rows by 1e-4 as the tree does, and take a
    # triangle's fourth, parallelogram corner too) widened by the tree's
    # own padding and a few f32 ulps
    forest = tvk.pack_volume_bvh(ts.volumes.prims,
                                 pack_prims(ts.volumes.prims), sl)
    cbox = np.asarray(jvk.pack_chunk_boxes(js.volumes.prims, sl))
    k = 0
    for v, plan in enumerate(jvk._chunk_plans(sl)):
        jlo = cbox[k:k + len(plan), 0:3].min(0)
        jhi = cbox[k:k + len(plan), 3:6].max(0)
        k += len(plan)
        _, lo, hi = tree_rows_and_box(forest, forest.roots[v])
        scale = max(1.0, float(np.abs(cbox[:, 0:6]).max()))
        room = NODE_PAD_ABS + NODE_PAD_REL * scale + 1e-6 * scale
        assert np.all(lo < hi), (v, lo, hi)
        assert np.all(jlo - lo <= room) and np.all(hi - jhi <= room), (
            v, lo, jlo, hi, jhi)
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
    if "pawn" not in name and "mixed" not in name:
        # the scalar kernel over 1,200 rows is slow
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
    vtbl = volume_tables(ts.volumes).vtbl
    kw = crossing_kw(ts.volumes, T_MIN)
    forest = tvk.pack_volume_bvh(ts.volumes.prims, vtbl, kw["slices"])
    n0 = (tvk.pallas_volume_crossings.launches,
          tvk.pallas_volume_crossings_bcast.launches)
    ref = tvk.volume_crossings_plain(vtbl, *rays, **kw)
    for out in (tvk.pallas_volume_crossings(vtbl, *rays, **kw),
                tvk.pallas_volume_crossings_bcast(vtbl, forest, *rays,
                                                  **kw)):
        for a, b in zip(ref, out):
            assert torch.equal(a, b)
    assert (tvk.pallas_volume_crossings.launches,
            tvk.pallas_volume_crossings_bcast.launches) == n0


_RUN = r"""
// K11 in blocks of 32 host threads (kRays rays each), staging the table
// and meeting at the barrier; K11b's persistent grid as 3 blocks of 32
// host threads striding over the rays.  Each runs the instantiation the
// launcher would (scan_kernel, with_walk).
extern "C" int run_vol(const VolArgs* a, int walk) {
  if (!mode_args_ok(a)) return 1;
  if (walk) {
    with_walk(*a, [&](auto tri, auto count, auto cand, auto keys) {
      rt_host_launch(3, 32, [&] {
        volume_bvh_kernel<decltype(tri)::value, decltype(count)::value,
                          decltype(cand)::value, decltype(keys)::value>(*a);
      });
      return 0;
    });
    return 0;
  }
  const long long per_block = 32 * kRays;
  rt_host_launch(static_cast<int>((a->n_lanes + per_block - 1) / per_block),
                 32, [&] { scan_kernel(*a)(*a); });
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


def _host_args(volumes, rays, walk, tables, prepared, out, visits, cand):
    """The host build's argument struct, its table part prepared
    (``prepared``: K11's planar instantiation where it serves the table)
    or not; and the prepared launch and the tables, which must outlive
    the struct."""
    tables = volume_tables(volumes) if tables is None else tables
    vtbl, forest = tables.vtbl, tables.forest
    slices = tuple(zip(volumes.starts, volumes.counts))
    if walk and forest is None:
        forest = tvk.pack_volume_bvh(volumes.prims, vtbl, slices)
    kw = crossing_kw(volumes, T_MIN)
    forest = forest if walk else None
    launch = None
    if prepared:
        launch = tvk.prepare_volume_launch(
            vtbl, forest, slices=slices, has_motion=kw["has_motion"],
            has_box=kw["has_box"], density=None if cand is None else cand[3],
            mats=() if cand is None else cand[4])
    args = tvk.vol_args(vtbl, forest, rays, out, visits, prepared=launch,
                        cand=cand, **kw)
    return args, (launch, vtbl, forest)


def _host_crossings(lib, volumes, rays, walk: bool, tables=None,
                    count: bool = True, prepared: bool = False):
    """The host build's crossings of K11 or (``walk``) K11b, and K11b's
    box tests and row tests per ray [2, R] (with ``count``, else
    zeros)."""
    r = rays.shape[1]
    rays = [x.contiguous() for x in rays.unbind(0)]
    out = torch.empty((3 * volumes.n_volumes, r))
    visits = torch.zeros((2, r), dtype=torch.int32)
    args, keep = _host_args(volumes, rays, walk, tables, prepared, out,
                            visits if count else None, None)
    assert lib.run_vol(ctypes.byref(args), int(walk)) == 0
    del keep
    return list(out.unbind(0)), visits


def _cornell_smoke_rays():
    from raytrace_tpu_torch.testing import cornell_smoke_scene
    sc, s = cornell_smoke_scene(24, 1, 10, device="cpu")
    rays = [c for c, _ in media_bounce_rays(sc, s, 7)]
    return sc, torch.cat(rays, 1)


def _assert_host_close(ref, out, exact, label):
    """This file's tolerance for a host build against the plain version:
    the rows ``exact`` equal on every lane, the others equal on all but at
    most 1% of lanes and there within 1e-5 relative."""
    differ = torch.zeros(ref[0].shape[0], dtype=torch.bool)
    for k, (a, b) in enumerate(zip(ref, out)):
        if k in exact:
            assert torch.equal(a, b), (label, k, int((a != b).sum()))
        else:
            close = (a == b) | (torch.abs(a - b) <= 1e-5 * torch.abs(a))
            assert bool(close.all()), (label, k, int((~close).sum()))
            differ |= a != b
    assert float(differ.float().mean()) <= 0.01, label


def _case_rays(name):
    """A scene and rays of ``name``, 5 lanes short of a whole block so that
    K11's last block has rays past the end."""
    if name == "cornell_smoke":
        ts, rays = _cornell_smoke_rays()
    else:
        ts, _, rays = _case(name, 1024, 11)
    return ts, rays[:, :-5]


@pytest.mark.parametrize("name", sorted(CASES) + ["cornell_smoke"])
def test_host_build_of_crossing_kernels_matches_plain(host_vol, name):
    ts, rays = _case_rays(name)
    vol = ts.volumes
    vtbl = volume_tables(vol).vtbl
    ref = tvk.volume_crossings_plain(vtbl, *rays,
                                     **crossing_kw(vol, T_MIN))
    fronts = tuple(range(1, len(ref), 3))
    for walk in (False, True):
        out, visits = _host_crossings(host_vol, vol, rays, walk)
        _assert_host_close(ref, out, fronts, (walk, name))
        if walk:
            # the instantiation without counts (the routes') gives the same
            uncounted, _ = _host_crossings(host_vol, vol, rays, True,
                                           count=False)
            for a, b in zip(out, uncounted):
                assert torch.equal(a, b)
            rows = vol.prims.kind.shape[0]
            # every ray tests the roots' boxes, and no row twice
            assert bool((visits[0] >= 2 * vol.n_volumes).all())
            assert int(visits[1].max()) <= rows
            if name in ("pawn", "mixed", "mixed_moving"):  # the trees cull
                assert float(visits[1].float().mean()) < 0.1 * rows


def _fold_inputs(volumes, r: int, seed: int):
    """Draws ``u`` [V, R] (pair16 values, 0 on every 7th lane, which never
    scatters) and a fold state ``(t_med, vmat)`` that an earlier group
    could have left: a candidate at 0.5-6 on a third of the lanes, +inf
    and material 0 elsewhere."""
    rg = np.random.default_rng(seed)
    nv = volumes.n_volumes
    u = (rg.integers(0, 1 << 16, (nv, r)) / 65536.0).astype(np.float32)
    u[:, ::7] = 0.0
    near = rg.uniform(size=r) < 1 / 3
    t_med = np.where(near, rg.uniform(0.5, 6.0, r), np.inf)
    vmat = np.where(near, rg.integers(0, 9, r), 0)
    return (torch.from_numpy(u), torch.from_numpy(t_med.astype(np.float32)),
            torch.from_numpy(vmat.astype(np.float32)))


def _host_candidates(lib, volumes, rays, walk: bool, u, t_med, vmat,
                     prepared: bool = False, fresh: bool = False):
    """The host build's candidate mode of K11 or (``walk``) K11b: the fold
    ``(t_med, vmat)`` after every medium, on copies of the given rows
    (with ``fresh``, rows of NaN that the fold must not read)."""
    rays = [x.contiguous() for x in rays.unbind(0)]
    t_med, vmat = t_med.clone(), vmat.clone()
    if fresh:
        t_med.fill_(float("nan"))
        vmat.fill_(float("nan"))
    mats = tuple(float(m) for m in volumes.mat.tolist())
    args, keep = _host_args(volumes, rays, walk, None, prepared, None, None,
                            (u, t_med, vmat, volumes.density, mats, fresh))
    assert args.cand == (2 if fresh else 1)
    assert lib.run_vol(ctypes.byref(args), int(walk)) == 0
    del keep
    return t_med, vmat


def _plain_candidates(volumes, rays, u, t_med, vmat):
    return tvk.volume_candidates_plain(
        volume_tables(volumes).vtbl, *rays, u=u, t_med=t_med, vmat=vmat,
        density=volumes.density, mats=volumes.mat.tolist(),
        **crossing_kw(volumes, T_MIN))


@pytest.mark.parametrize("name", sorted(CASES) + ["cornell_smoke"])
def test_host_build_candidate_mode_matches_plain(host_vol, name):
    """The candidate mode of K11 and of K11b against
    ``volume_candidates_plain`` from a fold state an earlier group left,
    and from none (the first group's launch): the material id and which
    lanes have a candidate equal on every lane, ``t_med`` as this file's
    crossings (the host's ``logf`` and torch's ``log`` may round a draw's
    flight apart as ``sqrt`` does a root)."""
    ts, rays = _case_rays(name)
    vol = ts.volumes
    u, t0, m0 = _fold_inputs(vol, rays.shape[1], 12)
    ref = _plain_candidates(vol, rays, u, t0, m0)
    assert torch.isfinite(ref[0]).sum() > torch.isfinite(t0).sum()
    assert bool((ref[1] != m0).any())          # the media win lanes
    fresh_ref = _plain_candidates(vol, rays, u, None, None)
    for walk in (False, True):
        out = _host_candidates(host_vol, vol, rays, walk, u, t0, m0)
        assert torch.equal(torch.isfinite(out[0]), torch.isfinite(ref[0]))
        _assert_host_close(ref, out, (1,), (walk, name))
        # the first group's launch starts the fold without reading it
        out = _host_candidates(host_vol, vol, rays, walk, u, t0, m0,
                               fresh=True)
        _assert_host_close(fresh_ref, out, (1,), (walk, name, "fresh"))


def test_host_build_planar_instantiation_on_cornell_smoke(host_vol):
    """cornell_smoke's 12 boundary rows (two boxes of 6 unmoving
    parallelograms) prepare K11's planar instantiation; on its camera rays
    and their second bounce it gives the general one's bits in both modes,
    and the plain version's within this file's tolerance."""
    ts, rays = _case_rays("cornell_smoke")
    vol = ts.volumes
    tables = volume_tables(vol)
    assert [x.planar for x in tables.launches] == [True]
    assert tables.launches[0].forest is None
    general = _host_crossings(host_vol, vol, rays, False)[0]
    ref = tvk.volume_crossings_plain(tables.vtbl, *rays,
                                     **crossing_kw(vol, T_MIN))
    u, t0, m0 = _fold_inputs(vol, rays.shape[1], 13)
    t0 = torch.full_like(t0, float("inf"))      # the route's first group
    m0 = torch.zeros_like(m0)
    cand_general = _host_candidates(host_vol, vol, rays, False, u, t0, m0,
                                    fresh=True)
    cand_ref = _plain_candidates(vol, rays, u, t0, m0)
    assert int(torch.isfinite(cand_ref[0]).sum()) > 20
    planar = _host_crossings(host_vol, vol, rays, False, prepared=True)[0]
    assert all(torch.equal(a, b) for a, b in zip(planar, general))
    _assert_host_close(ref, planar, (1, 4), "planar")
    cand = _host_candidates(host_vol, vol, rays, False, u, t0, m0,
                            prepared=True, fresh=True)
    assert all(torch.equal(a, b) for a, b in zip(cand, cand_general))
    _assert_host_close(cand_ref, cand, (1,), "planar candidates")


def test_pawn_camera_rays_walk_little(host_vol):
    """The pawn stand-in's camera rays at 500 x 500 (2^14 of them, spread
    over the image as chip_smoke.py spreads its 2^17) make on average at
    most 12 box tests and 4 row tests: a Python model of the walk counted
    8.4 and 2.2, the 256-row chunks tested 209.4 rows."""
    scene, s = pawn_standin_scene(500, 1, 20, device="cpu")
    cam, _ = camera_rays(scene, s, 1 << 14, 82)
    vol = scene.volumes
    out, visits = _host_crossings(host_vol, vol, cam, True)
    ref = tvk.volume_crossings_plain(volume_tables(vol).vtbl, *cam,
                                     **crossing_kw(vol, T_MIN))
    assert torch.equal(out[1], ref[1])
    assert int(torch.isfinite(out[0]).sum()) > 2000
    v = visits.float()
    assert float(v[0].mean()) <= 12.0, float(v[0].mean())
    assert float(v[1].mean()) <= 4.0, float(v[1].mean())


# ----- the keyed mode (the differentiable media path's) -----


def brute_keyed(vtbl, rays, kw):
    """The crossings and keys of every medium from all of its rows'
    candidates at once (no chunks, no fold): t1 the least candidate and
    k1 the least key ``2 * row + slot`` attaining it, t2 the least
    candidate strictly beyond t1 and k2 likewise, -1 where +inf."""
    rr = [x[None, :] for x in rays]
    inv = (tuple(1.0 / tvk._safe(x) for x in rr[3:6]) if kw["has_box"]
           else None)
    tmn = float(np.float32(T_MIN))
    c1, _, c2 = tvk._crossing_cand(lambda k: vtbl[:, k:k + 1], *rr, inv,
                                   tmn, kw["has_motion"], kw["has_box"])
    out = []
    for start, count in kw["slices"]:
        rows = torch.arange(start, start + count)
        c = torch.cat([c1[start:start + count], c2[start:start + count]])
        key = torch.cat([2 * rows, 2 * rows + 1]).float()[:, None]
        t1 = c.amin(0)
        t2 = torch.where(c > t1, c, float("inf")).amin(0)
        for t in (t1, t2):
            k = torch.where(c == t, key, float("inf")).amin(0)
            out.append((t, torch.where(torch.isfinite(t), k, -1.0).int()))
    return out


@pytest.mark.parametrize("name", sorted(CASES) + ["cornell_smoke"])
def test_keyed_plain_matches_brute_force(name):
    """``volume_crossings_plain(keys=True)``: the crossings equal the
    crossings mode's bits, and the keys those of a brute-force pass over
    all of each medium's candidates on every lane (the lowest key on a
    tie: shared mesh edges give ties)."""
    ts, rays = _case_rays(name)
    vol = ts.volumes
    vtbl = volume_tables(vol).vtbl
    kw = crossing_kw(vol, T_MIN)
    ref = tvk.volume_crossings_plain(vtbl, *rays, **kw)
    outs, keys = tvk.volume_crossings_plain(vtbl, *rays, keys=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ref, outs))
    brute = brute_keyed(vtbl, rays, kw)
    for v in range(vol.n_volumes):
        for s in (0, 1):
            t, k = brute[2 * v + s]
            assert torch.equal(t, outs[3 * v + 2 * s]), (name, v, s)
            assert torch.equal(k, keys[2 * v + s]), (name, v, s)
            assert int(torch.isfinite(t).sum()) > 5, (name, v, s)


def _host_keyed(lib, volumes, rays, walk: bool, prepared: bool = False):
    """The host build's keyed mode of K11 or (``walk``) K11b:
    ``(crossings, keys)``."""
    r = rays.shape[1]
    rays = [x.contiguous() for x in rays.unbind(0)]
    out = torch.empty((3 * volumes.n_volumes, r))
    keys = torch.empty((2 * volumes.n_volumes, r), dtype=torch.int32)
    tables = volume_tables(volumes)
    vtbl, forest = tables.vtbl, tables.forest
    slices = tuple(zip(volumes.starts, volumes.counts))
    if walk and forest is None:
        forest = tvk.pack_volume_bvh(volumes.prims, vtbl, slices)
    forest = forest if walk else None
    kw = crossing_kw(volumes, T_MIN)
    launch = (tvk.prepare_volume_launch(vtbl, forest, slices=slices,
                                        has_motion=kw["has_motion"],
                                        has_box=kw["has_box"])
              if prepared else None)
    args = tvk.vol_args(vtbl, forest, rays, out, None, prepared=launch,
                        keys=keys, **kw)
    assert args.keyed == 1
    assert lib.run_vol(ctypes.byref(args), int(walk)) == 0
    del launch, vtbl, forest
    return list(out.unbind(0)), list(keys.unbind(0))


@pytest.mark.parametrize("name", sorted(CASES) + ["cornell_smoke"])
def test_host_build_keyed_mode_matches_plain(host_vol, name):
    """The keyed mode of K11 (its general instantiation, and its planar
    one where the boundary prepares it: cornell_smoke) and of K11b's
    walk against ``volume_crossings_plain(keys=True)``: the crossings as
    the crossings mode's host builds (this file's tolerance) and equal to
    the host's crossings mode bit for bit, the keys equal on every lane
    whose crossings equal the plain version's."""
    ts, rays = _case_rays(name)
    vol = ts.volumes
    vtbl = volume_tables(vol).vtbl
    ref, ref_keys = tvk.volume_crossings_plain(vtbl, *rays, keys=True,
                                               **crossing_kw(vol, T_MIN))
    fronts = tuple(range(1, len(ref), 3))
    runs = [(False, False), (True, False)]
    if name == "cornell_smoke":
        runs.append((False, True))
    for walk, prepared in runs:
        out, keys = _host_keyed(host_vol, vol, rays, walk, prepared)
        _assert_host_close(ref, out, fronts, (walk, prepared, name))
        plain_mode, _ = _host_crossings(host_vol, vol, rays, walk,
                                        count=False, prepared=prepared)
        assert all(torch.equal(a, b) for a, b in zip(out, plain_mode))
        for v in range(vol.n_volumes):
            for s in (0, 1):
                same = out[3 * v + 2 * s] == ref[3 * v + 2 * s]
                same |= ~torch.isfinite(ref[3 * v + 2 * s])
                k_out, k_ref = keys[2 * v + s], ref_keys[2 * v + s]
                assert torch.equal(k_out[same], k_ref[same]), (
                    walk, prepared, name, v, s)
                assert bool((k_out[~same] >= 0).all())


@pytest.mark.parametrize("name", ["ball_box", "ball_box_moving",
                                  "octahedron", "mixed"])
def test_diff_crossings_vjp_matches_jax_scan(name):
    """``render/volumes.py:DiffCrossings`` (the keyed crossings forward,
    the winner-only backward) against ``jax.vjp`` of the JAX package's
    ``_crossing_scan2`` per medium, with respect to the boundary rows and
    the rays: t1 and t2 within rtol/atol 1e-5 where finite (the plain
    version's tolerance above), the front flag equal, and the VJP of a
    random cotangent on the finite crossings within 1e-4 of JAX's norm in
    the L2 norm.  Random rays from a numpy seed meet no ties, where JAX's
    ``min`` would split a cotangent and the keyed backward gives it to the
    lowest key."""
    from raytrace_tpu.render.volumes import _crossing_scan2
    from raytrace_tpu.scene.types import Primitives as JPrims
    from raytrace_tpu_torch.render.volumes import (
        DiffCrossings, crossing_statics,
    )
    ts, _, rays = _case(name, 512, 21)
    vol = ts.volumes
    vp = vol.prims
    r = rays.shape[1]
    o, d, tm = rays[0:3].T.contiguous(), rays[3:6].T.contiguous(), rays[6]
    fields = ("p0", "e1", "e2", "mv0", "mv1")
    st = crossing_statics(vol, T_MIN)
    leaves = [getattr(vp, f).clone().requires_grad_(True) for f in fields]
    tin = [x.clone().requires_grad_(True) for x in (o, d, tm)]
    t1, f1, t2 = DiffCrossings.apply(st, *tin, *leaves)
    rg = np.random.default_rng(4)
    nv = vol.n_volumes
    c1 = rg.normal(size=(nv, r)).astype(np.float32)
    c2 = rg.normal(size=(nv, r)).astype(np.float32)
    c1 = np.where(np.isfinite(t1.detach().numpy()), c1, 0.0)
    c2 = np.where(np.isfinite(t2.detach().numpy()), c2, 0.0)
    tg = torch.autograd.grad((t1, t2), leaves + tin,
                             (torch.from_numpy(c1), torch.from_numpy(c2)),
                             allow_unused=True)
    a = lambda x: jnp.asarray(x.detach().numpy())

    def jfn(p0, e1, e2, mv0, mv1, oo, dd, tt):
        jp = JPrims(kind=a(vp.kind), p0=p0, e1=e1, e2=e2, uvs=a(vp.uvs),
                    mat=a(vp.mat), mv0=mv0, mv1=mv1, n=vp.n,
                    has_motion=vp.has_motion, has_box=vp.has_box)
        tmin = jnp.full((r,), T_MIN, jnp.float32)
        res = [_crossing_scan2(jp, s, c, oo, dd, tt, tmin)
               for s, c in zip(vol.starts, vol.counts)]
        return (jnp.stack([x[0] for x in res]),
                jnp.stack([x[2] for x in res])), jnp.stack(
                    [x[1] for x in res])

    (j1, j2), vjp, jf1 = jax.vjp(jfn, *(a(x) for x in leaves),
                                 *(a(x) for x in tin), has_aux=True)
    np.testing.assert_array_equal(f1.numpy(), np.asarray(jf1))
    for x, y in ((t1, j1), (t2, j2)):
        x, y = x.detach().numpy(), np.asarray(y)
        assert np.array_equal(np.isfinite(x), np.isfinite(y))
        fin = np.isfinite(y)
        np.testing.assert_allclose(x[fin], y[fin], rtol=1e-5, atol=1e-5)
    jg = vjp((jnp.asarray(c1), jnp.asarray(c2)))
    for k, (x, y) in enumerate(zip(tg, jg)):
        y = np.asarray(y)
        x = np.zeros_like(y) if x is None else x.numpy()
        assert np.all(np.isfinite(x)), (name, k)
        assert np.linalg.norm(x - y) <= 1e-4 * np.linalg.norm(y) + 1e-6, (
            name, k, np.linalg.norm(x - y), np.linalg.norm(y))
