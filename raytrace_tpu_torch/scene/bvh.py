"""Host-side median-split BVH (``raytrace_tpu/scene/bvh.py``), numpy only.

Dense scenes use its primitive permutation to order their rows spatially,
so the packed tables match the JAX package's row for row; its flat
threaded node list, built over the packed rows, is what the nearest-hit
kernel walks (``ops/allpairs_kernel.py:pack_bvh``).
"""
from __future__ import annotations

import sys

import numpy as np

from .types import PRIM_BOX, PRIM_PARALLELOGRAM, PRIM_SPHERE, PRIM_TRIANGLE

PLANE_PAD = 1e-4  # bbox padding of planar primitives


def prim_aabbs(kind, p0, e1, e2, mv0=None, mv1=None):
    """Numpy AABBs [n, 3], [n, 3] of primitive rows, joined over both
    motion extremes."""
    kind = np.asarray(kind)
    n = kind.shape[0]
    lo = np.empty((n, 3))
    hi = np.empty((n, 3))

    is_sphere = kind == PRIM_SPHERE
    if is_sphere.any():
        r = np.abs(e1[is_sphere, 0:1])
        lo[is_sphere] = p0[is_sphere] - r
        hi[is_sphere] = p0[is_sphere] + r

    is_box = kind == PRIM_BOX
    if is_box.any():
        lo[is_box] = p0[is_box]
        hi[is_box] = e1[is_box]

    is_planar = (kind == PRIM_PARALLELOGRAM) | (kind == PRIM_TRIANGLE)
    if is_planar.any():
        q = p0[is_planar]
        u = e1[is_planar]
        v = e2[is_planar]
        far = np.where((kind[is_planar] == PRIM_PARALLELOGRAM)[:, None],
                       q + u + v, q)  # 4th corner only for parallelograms
        corners = np.stack([q, q + u, q + v, far], axis=1)
        lo[is_planar] = corners.min(1) - PLANE_PAD
        hi[is_planar] = corners.max(1) + PLANE_PAD

    if mv0 is not None:
        lo = np.minimum(lo + mv0, lo + mv1)
        hi = np.maximum(hi + mv0, hi + mv1)
    return lo, hi


def build_bvh(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4):
    """Median-split BVH over primitive AABBs.

    Returns ``(perm, nodes)``: ``perm`` reorders primitives so leaf ranges
    are contiguous, ``nodes`` holds numpy arrays (lo, hi, start, count,
    skip) in depth-first order with escape pointers."""
    n = lo.shape[0]
    if n == 0:
        raise ValueError("build_bvh: empty primitive list")
    mid = 0.5 * (lo + hi)

    perm: list[int] = []
    node_lo: list[np.ndarray] = []
    node_hi: list[np.ndarray] = []
    node_start: list[int] = []
    node_count: list[int] = []

    def emit(box_lo, box_hi, start, count):
        node_lo.append(box_lo)
        node_hi.append(box_hi)
        node_start.append(start)
        node_count.append(count)

    def build(indices):
        box_lo = lo[indices].min(0)
        box_hi = hi[indices].max(0)
        if len(indices) <= leaf_size:
            start = len(perm)
            perm.extend(int(i) for i in indices)
            emit(box_lo, box_hi, start, len(indices))
            return
        axis = int(np.argmax(box_hi - box_lo))
        order = np.argsort(mid[indices, axis], kind="stable")
        indices = indices[order]
        half = len(indices) // 2
        emit(box_lo, box_hi, 0, 0)
        build(indices[:half])
        build(indices[half:])

    sizes: dict[int, int] = {}

    def subtree_size(i):
        if node_count[i] > 0:
            return 1
        left = i + 1
        ls = subtree_size(left)
        rs = subtree_size(left + ls)
        sizes[i] = 1 + ls + rs
        return sizes[i]

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 2 * n + 1000))
    try:
        build(np.arange(n))
        subtree_size(0)
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(node_lo)
    skip = np.asarray([i + sizes[i] if node_count[i] == 0 else i + 1
                       for i in range(n_nodes)], np.int32)
    nodes = dict(
        lo=np.asarray(node_lo, np.float32),
        hi=np.asarray(node_hi, np.float32),
        start=np.asarray(node_start, np.int32),
        count=np.asarray(node_count, np.int32),
        skip=skip,
    )
    return np.asarray(perm, np.int64), nodes
