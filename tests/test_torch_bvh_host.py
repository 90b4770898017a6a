"""The nearest kernel's CUDA source, compiled for the host, against the
plain all-pairs version.

The body of ``csrc/nearest_kernel.cu`` (the near-child-first walk of
``csrc/bvh_nearest.cuh`` over a binned-SAH tree of two-box nodes, the
per-row test of ``csrc/prim_loop.cuh`` or its triangle-only branch) is
plain C++ once ``__device__``, ``__ldg`` and the launch indices are
defined for the host, so the host C++ compiler builds it (the launcher
after ``extern "C"`` is left out) and runs its persistent grid through
``rt_host_launch``: 3 blocks of 32 host threads striding over the rays.
That checks the walk on the CPU before any card sees it: it must never
cull a hit that the flat scan finds, and ties must go to the lowest row
whatever the visiting order.  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
hold the kernel itself against the same plain version on the card.

Rays: camera rays and their second bounce on the bunny stand-in
(triangle-only), on the mixed-kind mesh scene (still and moving), on a
table in which every triangle of a mesh appears twice, where the lower
row must win, and on 256 triangles whose boxes share one centre (the SAH
bins degenerate and the build splits by count); axis-parallel rays (zero
direction components); rays that start on the faces of the scene's box.
Tolerance: none, every output equal on every ray (the build uses
``-ffp-contract=off``, as the card's uses ``--fmad=false``, and the
per-row arithmetic is the plain version's).  The work: the 600-px
stand-in's hit camera rays make at most 45 box tests and 10 row tests on
average, as ``Visits`` counts them.
"""
import ctypes

import numpy as np
import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.ops import allpairs_kernel as ak
from raytrace_tpu_torch.ops.bounce_kernel import shade_plain
from raytrace_tpu_torch.render.integrator import split_tables, surface_hit
from raytrace_tpu_torch.testing import (
    bunny_standin_scene, camera_rays, host_library, mesh_all_kinds_scene,
    uv_sphere,
)

_RUN = r"""
// The persistent grid on the host: 3 blocks of 32 threads striding over
// the rays.
template <bool kTriOnly>
static void run_grid(const NearestArgs* a) {
  rt_host_launch(3, 32, [&] {
    if (a->visits != nullptr)
      nearest_kernel<kTriOnly, true>(*a);
    else
      nearest_kernel<kTriOnly, false>(*a);
  });
}
extern "C" int run_nearest(const NearestArgs* a) {
  if (a->tri_only)
    run_grid<true>(a);
  else
    run_grid<false>(a);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_nearest(tmp_path_factory):
    lib = host_library("nearest_kernel.cu", _RUN,
                       tmp_path_factory.mktemp("nearest_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler")
    lib.run_nearest.argtypes = [ctypes.c_void_p]

    def run(tb, rays, seen=None):
        r = rays.shape[1]
        rays = [x.contiguous() for x in rays.unbind(0)]
        outf = torch.empty((6, r))
        outi = torch.empty((3, r), dtype=torch.int32)
        visits = torch.empty((2, r), dtype=torch.int32)
        a = ak.nearest_args(tb.bvh, rays, outf, outi, visits,
                            has_motion=tb.has_motion, t_min=tb.t_min,
                            seen=seen)
        lib.run_nearest(ctypes.byref(a))
        out = (outf[0], outi[0], outf[1], outf[2], outf[3], outi[1], outf[4],
               outf[5], outi[2])
        return out, visits
    return run


def _second_bounce(tb, cam, uni):
    k = cam.shape[1]
    hit = surface_hit(tb, cam[0:3], cam[3:6], cam[6])
    lanes = (*cam[0:6], *torch.ones((3, k)), torch.ones(k))
    out = shade_plain(tb.mtbl, tb.ttbl, hit, None, lanes, uni,
                      n_mats=tb.n_mats, n_targets=tb.n_targets,
                      has_medium=False)
    o2 = torch.where(out[12] > 0.5, torch.stack(out[0:3]), 3e18)
    return torch.cat([o2, torch.stack(out[3:6]), cam[6:7]])


def _axis_rays(n: int, lo: float, hi: float, seed: int):
    """Rays along the six axis directions (two direction components exactly
    zero, one of them a negative zero) from random origins."""
    rg = np.random.default_rng(seed)
    o = rg.uniform(lo, hi, (3, n))
    d = np.zeros((3, n))
    axis = np.arange(n) % 3
    d[axis, np.arange(n)] = np.where(np.arange(n) % 2, 1.0, -1.0)
    d[(axis + 1) % 3, np.arange(n)] = -0.0
    tm = rg.uniform(0, 1, (1, n))
    return torch.from_numpy(np.concatenate([o, d, tm]).astype(np.float32))


def _box_face_rays(scene, n: int, seed: int):
    """Rays that start on the faces of the scene's box rows, pointing in
    random directions (a third of them along an axis)."""
    p = scene.prims
    boxes = torch.nonzero(p.kind == 3)[:, 0]
    rg = np.random.default_rng(seed)
    b = boxes[rg.integers(0, boxes.numel(), n)]
    lo, hi = p.p0[b].numpy(), p.e1[b].numpy()
    o = rg.uniform(lo, hi)
    face = rg.integers(0, 3, n)
    side = rg.integers(0, 2, n).astype(bool)
    o[np.arange(n), face] = np.where(side, hi[np.arange(n), face],
                                     lo[np.arange(n), face])
    d = rg.normal(size=(n, 3))
    ax = np.arange(n) % 3 == 0
    d[ax] = 0.0
    d[ax, face[ax]] = np.where(side[ax], 1.0, -1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.zeros((n, 1))
    return torch.from_numpy(np.concatenate([o, d, tm], 1).T.astype(
        np.float32)).contiguous()


def _duplicated_mesh_scene():
    v, f = uv_sphere(10, 12)
    f2 = np.concatenate([f, f])
    mesh = rt.Mesh(vertices=v, uv=np.zeros((0, 2)), faces=f2,
                   uv_faces=np.full_like(f2, -1))
    scene = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)), rt.triangle_mesh(mesh)),
        device="cpu")
    s = rt.CameraSettings(center=[0.0, 0.3, 3.0], look_at=[0.0, 0.0, 0.0],
                          image_width=32, background=rt.gray_fade)
    return scene, s


def _one_centroid_scene():
    """256 triangles whose boxes share one centre (vertices p, -p and q
    with |q| <= |p| on every axis, on a dyadic grid so the packed corners
    are exact): every SAH bin boundary leaves one side empty, so the
    build splits by count."""
    rg = np.random.default_rng(21)
    p = rg.integers(4, 17, (256, 3)) * rg.choice([-1, 1], (256, 3)) / 16
    q = rg.integers(-16, 17, (256, 3)) / 16 * np.abs(p)
    v = np.concatenate([p, -p, q])
    f = np.arange(768).reshape(3, 256).T
    mesh = rt.Mesh(vertices=v, uv=np.zeros((0, 2)), faces=f,
                   uv_faces=np.full_like(f, -1))
    scene = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)), rt.triangle_mesh(mesh)),
        device="cpu")
    s = rt.CameraSettings(center=[0.4, 0.7, 3.0], look_at=[0.0, 0.0, 0.0],
                          image_width=32, background=rt.gray_fade)
    return scene, s


def _cases():
    return ("standin", "all_kinds", "all_kinds_moving", "duplicated",
            "one_centroid")


@pytest.mark.parametrize("case", _cases())
def test_host_build_of_nearest_kernel_matches_plain(host_nearest, case):
    if case == "standin":
        scene, s = bunny_standin_scene(64, 1, 10, device="cpu")
    elif case == "duplicated":
        scene, s = _duplicated_mesh_scene()
    elif case == "one_centroid":
        scene, s = _one_centroid_scene()
    else:
        scene, s = mesh_all_kinds_scene(18, case == "all_kinds_moving",
                                        device="cpu")
    tb = split_tables(scene, s)
    cam, uni = camera_rays(scene, s, 640, 11)
    groups = [cam, _second_bounce(tb, cam, uni), _axis_rays(384, -3, 3, 12)]
    if scene.prims.has_box:
        groups.append(_box_face_rays(scene, 384, 13))
    rays = torch.cat(groups, dim=1)
    ref = ak.allpairs_nearest_plain(tb.ptbl, *rays.unbind(0),
                                    n_prims=tb.n_prims, t_min=tb.t_min,
                                    has_motion=tb.has_motion)
    out, visits = host_nearest(tb, rays)
    hit = ref[1] >= 0
    assert int(hit.sum()) >= 50
    for k, (a, b) in enumerate(zip(ref, out)):
        assert torch.equal(a, b), (k, int((a != b).sum()))
    # the walk tests far fewer rows than the table has (but where every
    # box holds the one centre) and at least the root's two boxes
    if case != "one_centroid":
        assert float(visits[1].float().mean()) < 0.2 * tb.n_prims
    assert bool((visits[0] >= 2).all())
    if case == "one_centroid":
        p = scene.prims
        lo, hi = torch.minimum(p.p0, p.p0 + p.e1), torch.maximum(
            p.p0, p.p0 + p.e1)
        real = p.kind == 2
        assert bool(((lo + hi)[real] == 0).all()) and tb.bvh.depth > 3
    if case == "duplicated":
        # every hit lands on the lower of a pair of identical rows
        p = scene.prims
        key = torch.cat([p.p0, p.e1, p.e2], 1)
        win = ref[1][hit].long()
        for w in win.unique():
            same = (key == key[w]).all(1) & (p.kind == 2)
            assert int(torch.nonzero(same)[0, 0]) == int(w)


def test_hit_camera_rays_of_the_standin_visit_little(host_nearest):
    """The 600-px stand-in's camera rays that hit make on average at most
    45 box tests and 10 row tests (the threaded median-split walk of
    before made 82.4 and 20.2)."""
    scene, s = bunny_standin_scene(600, 1, 10, device="cpu")
    tb = split_tables(scene, s)
    cam, _ = camera_rays(scene, s, 20000, 11)
    out, visits = host_nearest(tb, cam)
    hit = out[1] >= 0
    assert int(hit.sum()) > 2000
    v = visits.float()
    assert float(v[0][hit].mean()) <= 45.0, float(v[0][hit].mean())
    assert float(v[1][hit].mean()) <= 10.0, float(v[1][hit].mean())


def test_seen_marks_each_node_and_row_read(host_nearest):
    """``seen`` marks the nodes and leaf rows the walk reads: a single
    ray reads each at most once, so it marks ``visits / 2`` nodes (two
    box tests a node) and ``visits`` rows; a batch marks the union of
    its rays' marks."""
    scene, s = bunny_standin_scene(96, 1, 10, device="cpu")
    tb = split_tables(scene, s)
    cam, _ = camera_rays(scene, s, 64, 5)    # columns 0 and 48
    n = tb.bvh.n_nodes + tb.bvh.rows.shape[0]
    union = torch.zeros(n, dtype=torch.uint8)
    for i in range(cam.shape[1]):
        seen = torch.zeros(n, dtype=torch.uint8)
        _, visits = host_nearest(tb, cam[:, i:i + 1], seen)
        nodes, rows = seen[:tb.bvh.n_nodes], seen[tb.bvh.n_nodes:]
        assert int(nodes.sum()) * 2 == int(visits[0, 0]) and nodes[0] == 1
        assert int(rows.sum()) == int(visits[1, 0])
        union |= seen
    seen = torch.zeros(n, dtype=torch.uint8)
    host_nearest(tb, cam, seen)
    assert torch.equal(seen, union) and int(union[tb.bvh.n_nodes:].sum()) > 20
