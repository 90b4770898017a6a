"""Meshes in the port against the JAX package: the builder, the compiler
and the .obj parser.

* ``Mesh``, ``triangle_mesh`` and ``compile_scene`` on the bunny stand-in
  (4,968 triangles, 4,992 rows) and on the mixed-kind mesh scene (with
  and without motion) give exactly the JAX package's compiled rows (kind,
  corners, edges, uvs, material, motion) and kind segments: the
  kind-major segmentation and the 64-row padding agree row for row.  The
  packed tables (``pack_prims``) agree within tests/test_torch_scene.py's
  tolerance (rtol 1e-6, atol 1e-6 of the table's largest entry): XLA's
  CPU backend contracts the cross products into multiply-adds.
* ``parse_obj`` on inline texts (v/vt/f forms, negative indices, quads
  and their fan triangulation, comments) equals the JAX package's
  ``_parse_obj_py`` and raises ``ObjParseError`` on the same malformed
  lines.  No test reads an asset from outside the repository.
"""
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.ops.pallas import intersect_kernel as jik
from raytrace_tpu.scene import obj as jobj
from raytrace_tpu_torch.ops import intersect_kernel as tik
from raytrace_tpu_torch.scene import obj as tobj
from raytrace_tpu_torch.testing import (
    bunny_standin_world, mesh_all_kinds_world,
)


@pytest.mark.parametrize("case", ["standin", "all_kinds", "all_kinds_moving"])
def test_mesh_tables_equal_jax(case):
    if case == "standin":
        worlds = bunny_standin_world(jrt), bunny_standin_world(trt)
    else:
        moving = case == "all_kinds_moving"
        worlds = (mesh_all_kinds_world(jrt, 18, moving),
                  mesh_all_kinds_world(trt, 18, moving))
    js = jrt.compile_scene(worlds[0])
    ts = trt.compile_scene(worlds[1], device="cpu")
    assert ts.prims.kind_segments == js.prims.kind_segments
    assert ts.prims.n == int(js.prims.n)
    assert ts.prims.has_motion == (case == "all_kinds_moving")
    for name in ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0", "mv1"):
        np.testing.assert_array_equal(getattr(ts.prims, name).numpy(),
                                      np.asarray(getattr(js.prims, name)),
                                      err_msg=name)
    t = tik.pack_prims(ts.prims).numpy()
    j = np.asarray(jik.pack_prims(js.prims))
    np.testing.assert_array_equal(t[:, 16:18], j[:, 16:18])   # kind, mat
    np.testing.assert_allclose(t, j, rtol=1e-6,
                               atol=1e-6 * float(np.abs(j).max()))
    if case == "standin":
        assert ts.prims.kind.shape[0] == 4992 and ts.prims.n == 4968
    else:
        assert ts.prims.kind.shape[0] > 512


@pytest.mark.parametrize("case", ["standin", "random"])
def test_build_bvh_equals_jax(case):
    """``scene/bvh.py:build_bvh``, the median split whose permutation sets
    ``compile_scene``'s row order (held against JAX's above), equals the
    JAX package's on the same boxes: permutation and nodes.  The device
    BVH is a separate build (``build_sah_bvh``) over the packed rows."""
    from raytrace_tpu.scene import bvh as jbvh
    from raytrace_tpu_torch.scene import bvh as tbvh
    if case == "standin":
        ts = trt.compile_scene(bunny_standin_world(trt), device="cpu")
        p = ts.prims
        real = p.kind.numpy() >= 0
        f64 = lambda x: x.numpy().astype(np.float64)[real]
        args = (p.kind.numpy()[real], f64(p.p0), f64(p.e1), f64(p.e2),
                f64(p.mv0), f64(p.mv1))
        lo, hi = tbvh.prim_aabbs(*args)
        jlo, jhi = jbvh.prim_aabbs(*args)
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(hi, jhi)
    else:
        c = np.random.default_rng(5).normal(size=(777, 3))
        lo, hi = c - 0.05, c + 0.05
    perm, nodes = tbvh.build_bvh(lo, hi, leaf_size=4)
    jperm, jnodes = jbvh.build_bvh(lo, hi, leaf_size=4)
    np.testing.assert_array_equal(perm, jperm)
    assert sorted(nodes) == sorted(jnodes)
    for k in nodes:
        np.testing.assert_array_equal(nodes[k], jnodes[k], err_msg=k)


def test_mesh_transform_and_bounds_equal_jax():
    v = np.random.default_rng(4).normal(size=(30, 3))
    f = np.arange(30).reshape(10, 3)
    uv = np.random.default_rng(5).uniform(size=(8, 2))
    uvf = np.where(np.arange(30).reshape(10, 3) % 4 == 0, -1,
                   np.arange(30).reshape(10, 3) % 8)
    m = trt.compose(trt.rotate_y(0.5), trt.scale(3.0), trt.translate([1, 2, 3]))
    tm = trt.Mesh(v, uv, f, uvf).transform_vertices(m)
    jm = jrt.Mesh(v, uv, f, uvf).transform_vertices(m)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    for a, b in zip(tm.bounding_box(), jm.bounding_box()):
        np.testing.assert_array_equal(a, b)
    tb, jb = trt.triangle_mesh(tm), jrt.triangle_mesh(jm)
    for name in ("p0", "e1", "e2", "uvs"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))


_OBJ_TEXTS = [
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    # comments, blank lines, ignored statements, extra vertex fields
    "# a comment\nv 0 0 0 1.0\nv 1 0 0 # trailing\n\nvn 0 0 1\n"
    "v 0 1 0\ng group\nf 1 2 3 # face\n",
    # vt and the i/j and i//k forms, negative indices
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0.5\n"
    "f 1/1 2/2 3/3\nf -4//1 -2//1 -1//1\nf 1/-1 3/-2 4/-3\n",
    # a quad and a pentagon: fan triangulation
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv -1 0.5 0\nf 1 2 3 4\n"
    "f 1/1 2/1 3/1 4/1 5/1\nvt 0.25 0.75\n",
]

_BAD_TEXTS = [
    "v 0 0\n",                      # too few coordinates
    "v 0 0 x\n",                    # not a number
    "vt \n",                        # empty vt
    "vt 0 y\n",
    "v 0 0 0\nf 1 1\n",             # fewer than 3 vertices
    "v 0 0 0\nf 1 2 1\n",           # index out of bounds
    "v 0 0 0\nf 1 -2 1\n",
    "v 0 0 0\nf a 1 1\n",           # not a number
    "v 0 0 0\nf 1/x 1 1\n",
    "v 0 0 0\nvt 0 0\nf 1/2 1/1 1/1\n",
]


@pytest.mark.parametrize("text", _OBJ_TEXTS)
def test_parse_obj_matches_jax(text):
    tm = tobj.parse_obj(text)
    jm = jobj._parse_obj_py(text)
    for name in ("vertices", "uv", "faces", "uv_faces"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tm.faces.shape[0] >= 1


@pytest.mark.parametrize("text", _BAD_TEXTS)
def test_parse_obj_errors_match_jax(text):
    with pytest.raises(jobj.ObjParseError) as je:
        jobj._parse_obj_py(text)
    with pytest.raises(tobj.ObjParseError) as te:
        tobj.parse_obj(text)
    assert str(te.value) == str(je.value)


def test_read_obj_and_native_parser(tmp_path):
    """``read_obj`` parses a file and prefixes errors with its path; the
    native parser (``native=True``) gives the Python parser's mesh."""
    path = tmp_path / "tri.obj"
    path.write_text(_OBJ_TEXTS[2])
    mesh = tobj.read_obj(str(path))
    assert mesh.faces.shape == (3, 3)
    bad = tmp_path / "bad.obj"
    bad.write_text(_BAD_TEXTS[0])
    with pytest.raises(tobj.ObjParseError, match=str(bad)):
        tobj.read_obj(str(bad))
    for text in _OBJ_TEXTS:
        a = tobj.parse_obj(text, native=True)
        b = tobj.parse_obj(text, native=False)
        for name in ("vertices", "uv", "faces", "uv_faces"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    scene = trt.compile_scene(trt.with_material(
        trt.lambertian(trt.constant_texture(0.5)),
        trt.triangle_mesh(tobj.parse_obj(_OBJ_TEXTS[3]))), device="cpu")
    assert scene.prims.n == 5 and bool((scene.prims.kind[:5] == 2).all())
    assert torch.isfinite(scene.prims.uvs).all()
