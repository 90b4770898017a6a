"""Wavefront .obj parser (``raytrace_tpu/scene/obj.py``), pure Python.

* ``#`` comments are stripped; only ``v``, ``vt`` and ``f`` statements are
  used, everything else is ignored.
* ``v`` must begin with three decimal numbers; extra fields are ignored.
* ``vt`` must begin with two decimal numbers (a single number means v=0).
* ``f`` entries may be ``i``, ``i/j`` or ``i//k`` (normals ignored);
  indices are 1-based, negative indices count from the end, and both are
  normalized to 0-based.  Faces with more than three vertices are
  fan-triangulated.
* Errors name the 1-based line number, prefixed with the file path by
  :func:`read_obj`.

The same grammar is parsed natively by ``csrc/objparse.cpp`` (a copy of
the JAX package's ``native/objparse.cpp``), built with g++ at first use
(``ops/_build.py:native_library``) and called through ``ctypes``: the
loader of mesh-scale files.
"""
from __future__ import annotations

import subprocess

import numpy as np

from .builder import Mesh


class ObjParseError(ValueError):
    pass


def _parse_float(tok: str):
    try:
        return float(tok)
    except ValueError:
        return None


def _process_index(length: int, i: int, line_no: int) -> int:
    # 1-based or negative-from-end -> 0-based
    if 1 <= i <= length:
        return i - 1
    if -length <= i <= -1:
        return i + length
    raise ObjParseError(f"line {line_no}: index out of bounds: {i}")


def _parse_face_vertex(tok: str, n_vs: int, n_vts: int, line_no: int):
    parts = tok.split("/")
    try:
        vi = int(parts[0])
    except ValueError:
        raise ObjParseError(f"line {line_no}: expected number") from None
    vi = _process_index(n_vs, vi, line_no)
    ti = -1
    if len(parts) >= 2 and parts[1] != "":
        try:
            ti = int(parts[1])
        except ValueError:
            raise ObjParseError(f"line {line_no}: expected number") from None
        ti = _process_index(n_vts, ti, line_no)
    return vi, ti


_NATIVE_UNSAFE = set("\x00\f\v\x1c\x1d\x1e")


def _native_safe(text: str) -> bool:
    """True when the native parser is guaranteed to agree with the Python
    one: ASCII without exotic separators.  Outside that set the two can
    diverge (Python's splitlines/str.split treat \\f, \\v, \\x1c-\\x1e,
    NBSP, U+2028/9 etc. as separators; C does not, and an embedded NUL
    truncates a C token), so such inputs take the Python parser."""
    return text.isascii() and not (_NATIVE_UNSAFE & set(text))


def parse_obj(text: str, native: bool | None = None) -> Mesh:
    """Parse .obj text.  ``native=None`` takes the C++ parser for plain
    ASCII input when its library builds, else the Python parser;
    ``native=True`` takes the C++ parser and raises if its library does
    not build; ``native=False`` takes the Python parser (the JAX
    package's rule)."""
    if native is not False and (native is True or _native_safe(text)):
        lib = _obj_lib(required=native is True)
        if lib is not None:
            return _parse_obj_native(lib, text)
    return _parse_obj_py(text)


def _obj_lib(required: bool):
    """The native parser's library, configured for ctypes; None if it does
    not build, unless ``required``."""
    import ctypes

    from ..ops._build import native_library
    try:
        lib = native_library("objparse")
    except (OSError, RuntimeError, subprocess.SubprocessError):
        if required:
            raise
        return None
    pd = ctypes.POINTER(ctypes.c_double)
    pl = ctypes.POINTER(ctypes.c_long)
    lib.rt_parse_obj.restype = ctypes.c_int
    lib.rt_parse_obj.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(pd),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(pd),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(pl),
        ctypes.POINTER(pl), ctypes.POINTER(ctypes.c_long), ctypes.c_char_p,
        ctypes.c_long]
    lib.rt_obj_free.restype = None
    lib.rt_obj_free.argtypes = [ctypes.c_void_p]
    return lib


def _parse_obj_native(lib, text: str) -> Mesh:
    """:func:`parse_obj` by the C++ parser ``lib``: the same arrays and
    error messages as :func:`_parse_obj_py`."""
    import ctypes
    data = text.encode()
    pd = ctypes.POINTER(ctypes.c_double)
    pl = ctypes.POINTER(ctypes.c_long)
    verts, uvs = pd(), pd()
    faces, uv_faces = pl(), pl()
    nv, nt, nf = (ctypes.c_long() for _ in range(3))
    err = ctypes.create_string_buffer(256)
    rc = lib.rt_parse_obj(data, len(data), ctypes.byref(verts),
                          ctypes.byref(nv), ctypes.byref(uvs),
                          ctypes.byref(nt), ctypes.byref(faces),
                          ctypes.byref(uv_faces), ctypes.byref(nf), err,
                          len(err))
    if rc != 0:
        raise ObjParseError(err.value.decode())
    try:
        v = np.ctypeslib.as_array(verts, (nv.value, 3)).copy()
        u = np.ctypeslib.as_array(uvs, (nt.value, 2)).copy()
        f = np.ctypeslib.as_array(faces, (nf.value, 3)).copy()
        uf = np.ctypeslib.as_array(uv_faces, (nf.value, 3)).copy()
    finally:
        for p in (verts, uvs, faces, uv_faces):
            lib.rt_obj_free(p)
    return Mesh(vertices=v.reshape(-1, 3), uv=u.reshape(-1, 2),
                faces=f.astype(np.int64).reshape(-1, 3),
                uv_faces=uf.astype(np.int64).reshape(-1, 3))


def _parse_obj_py(text: str) -> Mesh:
    v_lines: list[tuple[int, str]] = []
    vt_lines: list[tuple[int, str]] = []
    f_lines: list[tuple[int, str]] = []
    for line_no, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0]
        if line.startswith("v "):
            v_lines.append((line_no, line[2:]))
        elif line.startswith("vt "):
            vt_lines.append((line_no, line[3:]))
        elif line.startswith("f "):
            f_lines.append((line_no, line[2:]))

    vertices = []
    for line_no, body in v_lines:
        toks = body.split()
        vals = [_parse_float(t) for t in toks[:3]]
        if len(vals) < 3 or any(x is None for x in vals):
            raise ObjParseError(f"line {line_no}: invalid 'v' statement")
        vertices.append(vals)

    uvs = []
    for line_no, body in vt_lines:
        toks = body.split()
        if len(toks) == 1:
            u = _parse_float(toks[0])
            if u is None:
                raise ObjParseError(f"line {line_no}: invalid 'vt' statement")
            uvs.append([u, 0.0])
        else:
            u = _parse_float(toks[0]) if toks else None
            v = _parse_float(toks[1]) if len(toks) > 1 else None
            if u is None or v is None:
                raise ObjParseError(f"line {line_no}: invalid 'vt' statement")
            uvs.append([u, v])

    faces = []
    uv_faces = []
    for line_no, body in f_lines:
        toks = body.split()
        if len(toks) < 3:
            raise ObjParseError(
                f"line {line_no}: invalid 'f' statement (fewer than 3 "
                "vertices)")
        idx = [_parse_face_vertex(t, len(vertices), len(uvs), line_no)
               for t in toks]
        first = idx[0]
        for a, b in zip(idx[1:-1], idx[2:]):  # fan triangulation
            faces.append([first[0], a[0], b[0]])
            uv_faces.append([first[1], a[1], b[1]])

    return Mesh(
        vertices=np.asarray(vertices, np.float64).reshape(-1, 3),
        uv=np.asarray(uvs, np.float64).reshape(-1, 2),
        faces=np.asarray(faces, np.int64).reshape(-1, 3),
        uv_faces=np.asarray(uv_faces, np.int64).reshape(-1, 3),
    )


def read_obj(path: str) -> Mesh:
    """Parse the .obj file at ``path``; errors are prefixed with the
    path."""
    with open(path) as f:
        text = f.read()
    try:
        return parse_obj(text)
    except ObjParseError as e:
        raise ObjParseError(f"{path}, {e}") from None
