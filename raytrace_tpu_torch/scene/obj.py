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

The JAX package's native C++ parser (``native/objparse.cpp``) is not
ported yet (ROADMAP M8): ``parse_obj(native=True)`` raises.
"""
from __future__ import annotations

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


def parse_obj(text: str, native: bool | None = None) -> Mesh:
    """Parse .obj text.  ``native=None`` and ``native=False`` take the
    Python parser; ``native=True`` asks for the C++ parser, which is not
    ported yet, and raises."""
    if native:
        raise NotImplementedError(
            "parse_obj(native=True): the native C++ .obj parser is not "
            "ported yet (ROADMAP M8); use native=None")
    return _parse_obj_py(text)


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
