"""The native .obj parser (``csrc/objparse.cpp``, built with g++ into
``raytrace_tpu_torch/_build/`` at first use and called through ctypes)
against the port's Python parser and the JAX package's native parser.

Texts: ``tests/test_obj.py``'s parity texts (mixed newlines, fans, exotic
number forms, forward references), generated meshes written by
``testing.mesh_obj_text`` (exact floats), and its error cases.  Meshes
must be equal array for array (the parsers read the same decimal strings
into doubles); errors must carry the Python parser's exact message.  No
test reads a file outside the repository.
"""
import numpy as np
import pytest

from raytrace_tpu.scene import obj as jobj
from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.scene import obj as tobj
from raytrace_tpu_torch.testing import mesh_obj_text, uv_sphere

PARITY_TEXTS = [
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "v 0 0 0\r\nv 1 0 0\rv 0 1 0\nf -3 -2 -1",
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
    "v 1e-3 +2.5 -3E2 9\nv 4 5 6\nv 7 8 9\nvt .5\nf 1/1 2//9 3\n",
    "v 1_0 2_5.5 0\nv 4 5 6\nv 7 8 9\nf 1 2 3\n",
    "  v 9 9 9\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "v 0 0 0 # c\nv 1 0 0\nv 0 1 0\nvt 0 1 5\nf\t1/1  2/1\t3/1\n",
    "f 1 2 3\nv 0 0 0\nv 1 0 0\nv 0 1 0\n",
    "# a comment\nv 0 0 0 1.0\nv 1 0 0 # trailing\n\nvn 0 0 1\n"
    "v 0 1 0\ng group\nf 1 2 3 # face\n",
]

ERROR_TEXTS = [
    "v 1 2\nf 1 1 1\n",
    "v 0x1 0 0\nf 1 1 1\n",
    "v _1 0 0\nf 1 1 1\n",
    "v 1_ 0 0\nf 1 1 1\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt x\nf 1 2 3\n",
    "v 0 0 0\nf 1 2 3\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3/9\n",
    "v 0 0 0\nf 1/x 1 1\n",
]


def _mesh_texts():
    rg = np.random.default_rng(7)
    v, f = uv_sphere(24, 31)
    yield mesh_obj_text(v * 1.5, f)
    yield mesh_obj_text(rg.normal(size=(50, 3)) * 1e3,
                        rg.integers(0, 50, (80, 3)))


def _equal(a, b):
    for name in ("vertices", "uv", "faces", "uv_faces"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("k", range(len(PARITY_TEXTS) + 2))
def test_native_matches_python_and_jax(k):
    text = (PARITY_TEXTS + list(_mesh_texts()))[k]
    native = tobj.parse_obj(text, native=True)
    _equal(native, tobj.parse_obj(text, native=False))
    _equal(native, jobj.parse_obj(text, native=True))
    _equal(native, tobj.parse_obj(text))


def test_generated_mesh_round_trips_exactly():
    v, f = uv_sphere(40, 52)
    m = tobj.parse_obj(mesh_obj_text(v * 1.5, f), native=True)
    np.testing.assert_array_equal(m.vertices, v * 1.5)
    np.testing.assert_array_equal(m.faces, f)
    assert (m.uv_faces == -1).all() and m.uv.shape == (0, 2)


@pytest.mark.parametrize("text", ERROR_TEXTS)
def test_native_errors_match_python(text):
    with pytest.raises(tobj.ObjParseError) as en:
        tobj.parse_obj(text, native=True)
    with pytest.raises(tobj.ObjParseError) as ep:
        tobj.parse_obj(text, native=False)
    with pytest.raises(jobj.ObjParseError) as ej:
        jobj.parse_obj(text, native=True)
    assert str(en.value) == str(ep.value) == str(ej.value)


def test_library_is_built_from_the_port_source(monkeypatch):
    """The library is the port's own ``csrc/objparse.cpp`` built into
    ``_build/`` under a name that carries a hash of the source; inputs
    the native parser may read differently take the Python parser under
    ``native=None``; without a library ``native=True`` raises and
    ``native=None`` parses in Python."""
    lib = _build.native_library("objparse")
    name = lib._name
    assert name.startswith(str(_build.BUILD_DIR)) and "objparse_" in name
    src = (_build.CSRC / "objparse.cpp").read_text()
    assert "rt_parse_obj" in src
    assert not tobj._native_safe("v 0 0 0\x0b\n") and \
        not tobj._native_safe("v 0 0 0 é\n")
    calls = []

    def refuse(name):
        calls.append(name)
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(_build, "native_library", refuse)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tobj.parse_obj(PARITY_TEXTS[0], native=True)
    _equal(tobj.parse_obj(PARITY_TEXTS[0]),
           tobj.parse_obj(PARITY_TEXTS[0], native=False))
    assert calls == ["objparse", "objparse"]
    calls.clear()
    tobj.parse_obj("v 0 0 0\x0b\n", native=None)   # Python, no build
    assert calls == []
