"""Scene compiler: Python scene graph -> flat tensors, dense mode
(``raytrace_tpu/scene/compile.py``).

Transforms are baked into primitive parameters, motion becomes two
per-row displacement vectors, materials and textures are interned, and
rows are ordered by the median-split BVH permutation (in the dense mode,
tables of 65 rows and more are then regrouped kind-major into
64-row-padded segments), so the packed tables equal the JAX package's.
The BVH accelerator mode keeps the rows in that order, unsegmented, with
the threaded tree (:class:`BVH`).  Constant-density media get their own
table of boundary rows, every volume's rows merged in walk order
(neither permuted, segmented nor padded) with static per-volume slices.
Spheres under a non-uniform linear map become ellipsoids, kept in their
own buffer (:class:`Ellipsoids`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..materials.materials import Material, compile_materials
from ..ops.intersect_kernel import MAX_DENSE_PRIMS
from ..textures.textures import (
    TEX_CHECKER, TEX_CUSTOM, TEX_IMAGE, Texture, compile_textures,
)
from . import builder as B
from .bvh import build_bvh, prim_aabbs
from .types import (
    BVH, PRIM_BOX, PRIM_PAD, PRIM_PARALLELOGRAM, PRIM_SPHERE, PRIM_TRIANGLE,
    Ellipsoids, Primitives, Scene, Volumes,
)

_DEFAULT_TRI_UVS = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
_EYE9 = np.eye(3).ravel()
# kind segmentation: cluster width and the smallest table it applies to
_CLUSTER = 64
_SEGMENT_MIN_PRIMS = 65


@dataclasses.dataclass
class _Rows:
    kind: list
    p0: list
    e1: list
    e2: list
    uvs: list
    mat: list
    mv0: list
    mv1: list
    rot: list  # [n, 9] world->object rotation (sphere uv; identity else)

    @classmethod
    def empty(cls):
        return cls([], [], [], [], [], [], [], [], [])

    def n(self):
        return sum(k.shape[0] for k in self.kind)


class _Interner:
    def __init__(self):
        self.textures: dict[Texture, int] = {}
        self.materials: dict[Material, int] = {}

    def material_id(self, m: Material) -> int:
        if m not in self.materials:
            if m.texture not in self.textures:
                self.textures[m.texture] = len(self.textures)
            self.materials[m] = len(self.materials)
        return self.materials[m]


def _bake_block(block: B.PrimBlock, matrix: np.ndarray, mv0, mv1,
                mat_id: int, rows: _Rows, ellipsoids: list | None):
    a = matrix[:3, :3]
    b = matrix[:3, 3]
    n = block.p0.shape[0]
    kind = np.full(n, block.kind, np.int32)
    if block.kind == PRIM_BOX:
        # a box row survives positive uniform scale + translation only;
        # anything else lowers to six parallelograms and re-bakes
        s = a[0, 0]
        if s > 0.0 and np.allclose(a, s * np.eye(3),
                                   atol=1e-12 * max(abs(s), 1.0)):
            rows.kind.append(kind)
            rows.p0.append(block.p0 * s + b)
            rows.e1.append(block.e1 * s + b)
            rows.e2.append(np.zeros((n, 3)))
            rows.uvs.append(
                np.broadcast_to(_DEFAULT_TRI_UVS[None], (n, 3, 2)).copy())
            rows.mat.append(np.full(n, mat_id, np.int32))
            rows.mv0.append(np.broadcast_to(mv0, (n, 3)).copy())
            rows.mv1.append(np.broadcast_to(mv1, (n, 3)).copy())
            rows.rot.append(np.broadcast_to(_EYE9, (n, 9)).copy())
            return
        _bake_block(B.box_faces(block.p0, block.e1), matrix, mv0, mv1,
                    mat_id, rows, ellipsoids)
        return
    rot = _EYE9
    if block.kind == PRIM_SPHERE:
        ata = a.T @ a
        s2 = np.trace(ata) / 3.0
        if not np.allclose(ata, s2 * np.eye(3), atol=1e-9 * max(s2, 1.0)):
            # a non-uniform linear part: ellipsoids, in their own buffer
            # (object-space center and radius, the affine, the motion)
            if ellipsoids is None:
                raise ValueError(
                    "transform: non-uniform-scaled spheres (ellipsoids) "
                    "are not supported as constant_medium boundaries")
            for i in range(n):
                ellipsoids.append((block.p0[i], float(block.e1[i, 0]), a, b,
                                   mat_id, mv0.copy(), mv1.copy()))
            return
        p0 = block.p0 @ a.T + b
        e1 = np.zeros((n, 3))
        e1[:, 0] = block.e1[:, 0] * np.sqrt(s2)
        e2 = np.zeros((n, 3))
        # world->object rotation (sphere uv is evaluated in object space)
        rot = (a.T / np.sqrt(s2)).ravel()
    else:
        p0 = block.p0 @ a.T + b
        e1 = block.e1 @ a.T
        e2 = block.e2 @ a.T
    uvs = (np.broadcast_to(_DEFAULT_TRI_UVS[None], (n, 3, 2)).copy()
           if block.uvs is None else np.asarray(block.uvs, np.float64))
    rows.kind.append(kind)
    rows.p0.append(p0)
    rows.e1.append(e1)
    rows.e2.append(e2)
    rows.uvs.append(uvs)
    rows.mat.append(np.full(n, mat_id, np.int32))
    rows.mv0.append(np.broadcast_to(mv0, (n, 3)).copy())
    rows.mv1.append(np.broadcast_to(mv1, (n, 3)).copy())
    rows.rot.append(np.broadcast_to(rot, (n, 9)).copy())


def _walk(node: B.Geom, matrix, mv0, mv1, material, interner, rows: _Rows,
          volumes: list | None, ellipsoids: list | None):
    """Bake the rows below ``node`` into ``rows``.  ``volumes`` collects
    ``(density, material id, boundary rows)`` of each medium and
    ``ellipsoids`` ``(center, radius, A, b, material id, mv0, mv1)`` of
    each ellipsoid; both are None inside a medium's boundary, where media
    may not nest, ellipsoids raise and rows take material id 0."""
    if isinstance(node, B.WithMaterial):
        eff = material if material is not None else node.material
        _walk(node.child, matrix, mv0, mv1, eff, interner, rows, volumes,
              ellipsoids)
    elif isinstance(node, B.Transform):
        _walk(node.child, matrix @ node.matrix, mv0, mv1, material,
              interner, rows, volumes, ellipsoids)
    elif isinstance(node, B.Moving):
        lin = matrix[:3, :3]
        _walk(node.child, matrix, mv0 + lin @ node.v0, mv1 + lin @ node.v1,
              material, interner, rows, volumes, ellipsoids)
    elif isinstance(node, B.Group):
        for c in node.children:
            _walk(c, matrix, mv0, mv1, material, interner, rows, volumes,
                  ellipsoids)
    elif isinstance(node, B.Medium):
        if volumes is None:
            raise ValueError("constant_medium cannot be nested inside another")
        if material is None:
            raise ValueError("constant_medium needs a material attached with "
                             "with_material")
        vol_rows = _Rows.empty()
        _walk(node.child, matrix, mv0, mv1, None, interner, vol_rows, None,
              None)
        if vol_rows.n() == 0:
            raise ValueError("constant_medium: empty boundary geometry")
        volumes.append((node.density, interner.material_id(material),
                        vol_rows))
    elif isinstance(node, B.PrimBlock):
        if node.p0.shape[0] == 0:
            return
        if material is None and volumes is not None:
            raise ValueError("primitive reached compile without a material; "
                             "wrap it in with_material(...)")
        mat_id = interner.material_id(material) if material is not None \
            else 0
        _bake_block(node, matrix, mv0, mv1, mat_id, rows, ellipsoids)
    else:
        raise TypeError(f"unknown scene node {type(node)!r}")


def _pad(arrs, n_pad):
    kind, p0, e1, e2, uvs, mat, mv0, mv1, rot = arrs
    z3 = np.zeros((n_pad, 3))
    # pad rows get unit edges so the plane math stays finite; kind ==
    # PRIM_PAD is what keeps them from ever being hit
    ex = np.zeros((n_pad, 3))
    ex[:, 0] = 1.0
    ey = np.zeros((n_pad, 3))
    ey[:, 1] = 1.0
    return (
        np.concatenate([kind, np.full(n_pad, PRIM_PAD, np.int32)]),
        np.concatenate([p0, z3]),
        np.concatenate([e1, ex]),
        np.concatenate([e2, ey]),
        np.concatenate([uvs, np.zeros((n_pad, 3, 2))]),
        np.concatenate([mat, np.zeros(n_pad, np.int32)]),
        np.concatenate([mv0, z3]),
        np.concatenate([mv1, z3]),
        np.concatenate([rot, np.broadcast_to(_EYE9, (n_pad, 9))]),
    )


def _rows_to_primitives(rows: _Rows, perm, pad_to: int,
                        uv_mats: frozenset, segment: bool = True
                        ) -> Primitives:
    """The rows as a :class:`Primitives` table: reordered by ``perm``
    (None keeps the walk order), kind-segmented from 65 rows with
    ``segment``, else padded to a multiple of ``pad_to``."""
    arrs = tuple(np.concatenate(getattr(rows, f)) for f in
                 ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0", "mv1",
                  "rot"))
    if perm is not None:
        arrs = tuple(x[perm] for x in arrs)
    kind = arrs[0]
    n = kind.shape[0]
    kind_segments = None
    if segment and n >= _SEGMENT_MIN_PRIMS:
        # kind-major order, spatial order kept within each kind, each
        # segment padded to the 64-row cluster width
        groups = (
            (PRIM_SPHERE, kind == PRIM_SPHERE),
            (PRIM_PARALLELOGRAM,
             (kind == PRIM_PARALLELOGRAM) | (kind == PRIM_TRIANGLE)),
            (PRIM_BOX, kind == PRIM_BOX),
        )
        pieces = None
        segs = []
        k_cursor = 0
        for gkind, mask in groups:
            idx = np.nonzero(mask)[0]
            if idx.size == 0:
                continue
            part = tuple(a[idx] for a in arrs)
            n_padg = -idx.size % _CLUSTER
            if n_padg:
                part = _pad(part, n_padg)
            n_cl = (idx.size + n_padg) // _CLUSTER
            segs.append((int(gkind), k_cursor, k_cursor + n_cl))
            k_cursor += n_cl
            pieces = part if pieces is None else tuple(
                np.concatenate([a, b]) for a, b in zip(pieces, part))
        arrs = pieces
        kind_segments = tuple(segs)
    else:
        n_pad = -n % pad_to
        if n_pad:
            arrs = _pad(arrs, n_pad)

    kind, p0, e1, e2, uvs, mat, mv0, mv1, rot = arrs
    rotated = (kind == PRIM_SPHERE) & (np.abs(rot - _EYE9).max(axis=1)
                                       > 1e-9)
    rotated &= np.isin(mat, np.asarray(sorted(uv_mats), np.int32))
    sphere_rots = tuple(
        (int(r), tuple(np.asarray(rot[r], np.float32).tolist()))
        for r in np.nonzero(rotated)[0])
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    return Primitives(
        kind=torch.from_numpy(kind.astype(np.int32)), p0=f32(p0),
        e1=f32(e1), e2=f32(e2), uvs=f32(uvs),
        mat=torch.from_numpy(mat.astype(np.int32)), mv0=f32(mv0),
        mv1=f32(mv1), n=int(n),
        has_motion=bool(np.any(mv0 != 0.0) or np.any(mv1 != 0.0)),
        has_box=bool(np.any(kind == PRIM_BOX)),
        kind_segments=kind_segments,
        kinds_present=tuple(sorted(set(int(k) for k in kind if k >= 0))),
        sphere_rots=sphere_rots,
    )


def default_dense_threshold(device) -> int:
    """The surface rows above which ``accel="auto"`` picks the BVH mode on
    ``device``: none on the card (``1 << 62``), as the JAX package on a
    TPU; ``MAX_DENSE_PRIMS`` elsewhere, as the JAX package on the CPU."""
    return 1 << 62 if torch.device(device).type == "cuda" else \
        MAX_DENSE_PRIMS


def compile_scene(root: B.Geom, *, accel: str = "auto", leaf_size: int = 4,
                  dense_threshold: int | None = None, pad_to: int = 8,
                  device="cuda") -> Scene:
    """Compile a scene graph into a :class:`Scene` on ``device`` (the card
    by default; pass ``device="cpu"`` for the CPU).

    ``accel``: "dense" (kind-segmented rows), "bvh" (the rows in BVH
    order, unsegmented, with the threaded tree in ``Scene.bvh``) or
    "auto": the BVH mode above ``dense_threshold`` surface rows, by
    default :func:`default_dense_threshold`: on the card no size picks
    it (the nearest-hit kernel K9 walks a tree of its own over a dense
    table of any size), on the CPU it is taken past ``MAX_DENSE_PRIMS``
    (65,536) rows."""
    if accel not in ("auto", "dense", "bvh"):
        raise ValueError(f"compile_scene: unknown accel {accel!r}")
    if dense_threshold is None:
        dense_threshold = default_dense_threshold(device)
    interner = _Interner()
    rows = _Rows.empty()
    volumes: list = []
    ellipsoids: list = []
    _walk(root, np.eye(4), np.zeros(3), np.zeros(3), None, interner, rows,
          volumes, ellipsoids)
    n_surface = rows.n()
    if n_surface == 0 and not volumes and not ellipsoids:
        raise ValueError("compile_scene: empty scene")
    use_bvh = accel == "bvh" or (accel == "auto"
                                 and n_surface > dense_threshold)
    bvh = None

    if n_surface == 0:
        # a scene of media or ellipsoids only: one pad row, never hit
        z3 = torch.zeros((1, 3))
        prims = Primitives(
            kind=torch.full((1,), PRIM_PAD, dtype=torch.int32), p0=z3,
            e1=z3, e2=z3, uvs=torch.zeros((1, 3, 2)),
            mat=torch.zeros((1,), dtype=torch.int32), mv0=z3, mv1=z3, n=0)
    else:
        lo, hi = prim_aabbs(
            np.concatenate(rows.kind), np.concatenate(rows.p0),
            np.concatenate(rows.e1), np.concatenate(rows.e2),
            np.concatenate(rows.mv0), np.concatenate(rows.mv1))
        # both modes order the rows by the median-split permutation: the
        # BVH mode's leaves are then contiguous, the dense mode's segments
        # spatially coherent
        perm, nodes = build_bvh(lo, hi, leaf_size=leaf_size)
        if use_bvh:
            bvh = BVH(**{k: torch.from_numpy(nodes[k]) for k in
                         ("lo", "hi", "start", "count", "skip")},
                      n_nodes=int(nodes["lo"].shape[0]))
        # material ids whose texture consumes uv: only their rotated
        # spheres need the object-space uv correction
        uv_mats = frozenset(
            mid for m, mid in interner.materials.items()
            if m.texture.kind in (TEX_CHECKER, TEX_IMAGE, TEX_CUSTOM))
        prims = _rows_to_primitives(rows, perm, pad_to, uv_mats,
                                    segment=not use_bvh)

    vol = None
    if volumes:
        merged = _Rows.empty()
        starts, counts = [], []
        for _, _, vrows in volumes:
            starts.append(merged.n())
            counts.append(vrows.n())
            for f in dataclasses.fields(_Rows):
                getattr(merged, f.name).extend(getattr(vrows, f.name))
        # boundaries never evaluate uv (the medium overrides it)
        vol = Volumes(
            prims=_rows_to_primitives(merged, None, 1, frozenset(),
                                      segment=False),
            density=torch.tensor([v[0] for v in volumes],
                                 dtype=torch.float32),
            mat=torch.tensor([v[1] for v in volumes], dtype=torch.int32),
            starts=tuple(starts), counts=tuple(counts))

    ell = None
    if ellipsoids:
        fwd = np.stack([e[2] for e in ellipsoids])
        emv0 = np.stack([e[5] for e in ellipsoids])
        emv1 = np.stack([e[6] for e in ellipsoids])
        f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
        ell = Ellipsoids(
            center=f32(np.stack([e[0] for e in ellipsoids])),
            radius=f32([e[1] for e in ellipsoids]), fwd=f32(fwd),
            inv=f32(np.linalg.inv(fwd)),
            shift=f32(np.stack([e[3] for e in ellipsoids])),
            mat=torch.tensor([e[4] for e in ellipsoids], dtype=torch.int32),
            mv0=f32(emv0), mv1=f32(emv1), n=len(ellipsoids),
            has_motion=bool(np.any(emv0 != 0.0) or np.any(emv1 != 0.0)))

    textures = compile_textures(list(interner.textures))
    materials = compile_materials(list(interner.materials),
                                  interner.textures)
    scene = Scene(prims=prims, materials=materials, textures=textures,
                  volumes=vol, ellipsoids=ell, bvh=bvh)
    return scene.to(device)
