"""Compiled scene: flat struct-of-arrays tensors
(``raytrace_tpu/scene/types.py``).

One tagged row per primitive, an interned material table, an interned
texture table, for scenes with constant-density media a separate table
of the media's boundary rows (:class:`Volumes`), for spheres under
non-uniform scales a small buffer of ellipsoids (:class:`Ellipsoids`),
and for scenes compiled in the BVH accelerator mode the threaded tree
over the rows (:class:`BVH`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..materials.materials import MaterialTable
from ..textures.textures import TextureTable, _tensors_to

PRIM_PAD = -1           # padding row; never hit
PRIM_SPHERE = 0         # p0 = center, e1[0] = radius
PRIM_PARALLELOGRAM = 1  # p0 = q, e1 = u, e2 = v
PRIM_TRIANGLE = 2       # p0, e1 = p1 - p0, e2 = p2 - p0, uvs
PRIM_BOX = 3            # p0 = lo, e1 = hi: an axis-aligned box as one row


@dataclasses.dataclass(frozen=True)
class Primitives:
    """Tagged primitive rows in world space (transforms baked in);
    ``mv0``/``mv1`` are motion displacements at time 0 / 1."""
    kind: torch.Tensor   # i32[N]
    p0: torch.Tensor     # f32[N, 3]
    e1: torch.Tensor     # f32[N, 3]
    e2: torch.Tensor     # f32[N, 3]
    uvs: torch.Tensor    # f32[N, 3, 2] triangle corner uvs
    mat: torch.Tensor    # i32[N]
    mv0: torch.Tensor    # f32[N, 3]
    mv1: torch.Tensor    # f32[N, 3]
    n: int = 0                       # true row count (pad rows excluded)
    has_motion: bool = False
    has_box: bool = False
    # ((kind, cluster_start, cluster_end), ...) for kind-major tables of
    # 65 rows and more; None for an unsegmented table (pad rows trailing)
    kind_segments: tuple | None = None
    kinds_present: tuple | None = None  # primitive kinds present
    # ((row, r9), ...) world->object rotations of rotated uv-textured
    # spheres: their uv is evaluated in object space
    sphere_rots: tuple = ()

    def __len__(self):
        return self.n

    def to(self, device) -> "Primitives":
        return _tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class BVH:
    """The BVH accelerator mode's flat threaded tree over the primitive
    rows, in depth-first order (``scene/bvh.py:build_bvh``, the JAX
    package's ``BVH``): a ray that hits node ``i``'s box goes on to ``i +
    1`` (the first child), a ray that misses it, or has tested its leaf,
    to ``skip[i]``; ``skip == n_nodes`` ends the walk.  A leaf holds the
    ``count`` rows from ``start`` (the rows are in leaf order).  Static
    data of the scene: gradients do not reach it."""
    lo: torch.Tensor      # f32[K, 3]
    hi: torch.Tensor      # f32[K, 3]
    start: torch.Tensor   # i32[K] a leaf's first row
    count: torch.Tensor   # i32[K] a leaf's rows; 0 for an interior node
    skip: torch.Tensor    # i32[K] the escape index
    n_nodes: int = 0

    def to(self, device) -> "BVH":
        return _tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class Volumes:
    """Constant-density media: each volume owns the contiguous slice
    ``[starts[v], starts[v] + counts[v])`` of ``prims`` (its closed
    boundary surface, rows in compile order, neither permuted nor
    padded)."""
    prims: Primitives
    density: torch.Tensor   # f32[V]
    mat: torch.Tensor       # i32[V]
    starts: tuple = ()
    counts: tuple = ()

    @property
    def n_volumes(self) -> int:
        return len(self.starts)

    def to(self, device) -> "Volumes":
        return dataclasses.replace(self, prims=self.prims.to(device),
                                   density=self.density.to(device),
                                   mat=self.mat.to(device))


@dataclasses.dataclass(frozen=True)
class Ellipsoids:
    """Spheres under arbitrary affines, in their own small buffer,
    intersected in object space and merged after the nearest surface hit
    (``ops/ellipsoid.py``).  ``center``/``radius`` are object-space;
    ``fwd``/``inv`` the linear part A and its inverse (``inv`` is a leaf
    of its own, as in the JAX package, not recomputed from ``fwd``);
    ``shift`` the translation; ``mv0``/``mv1`` the world-space motion
    displacements at time 0 / 1."""
    center: torch.Tensor   # f32[E, 3]
    radius: torch.Tensor   # f32[E]
    fwd: torch.Tensor      # f32[E, 3, 3]
    inv: torch.Tensor      # f32[E, 3, 3]
    shift: torch.Tensor    # f32[E, 3]
    mat: torch.Tensor      # i32[E]
    mv0: torch.Tensor      # f32[E, 3]
    mv1: torch.Tensor      # f32[E, 3]
    n: int = 0
    has_motion: bool = False

    def to(self, device) -> "Ellipsoids":
        return _tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class Scene:
    prims: Primitives
    materials: MaterialTable
    textures: TextureTable
    volumes: Volumes | None = None
    ellipsoids: Ellipsoids | None = None
    bvh: BVH | None = None

    @property
    def device(self) -> torch.device:
        return self.prims.p0.device

    def to(self, device) -> "Scene":
        return Scene(self.prims.to(device), self.materials.to(device),
                     self.textures.to(device),
                     None if self.volumes is None
                     else self.volumes.to(device),
                     None if self.ellipsoids is None
                     else self.ellipsoids.to(device),
                     None if self.bvh is None else self.bvh.to(device))
