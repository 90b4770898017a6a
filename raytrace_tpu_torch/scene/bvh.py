"""Host-side BVHs over primitive boxes, numpy only.

* :func:`build_bvh`, the median split of ``raytrace_tpu/scene/bvh.py``:
  dense scenes use its primitive permutation to order their rows
  spatially, so the packed tables match the JAX package's row for row.
* :func:`build_sah_bvh`, a binned-SAH tree of two-box nodes built level by
  level: the BVH the nearest-hit walk reads, built over the packed rows
  (``ops/allpairs_kernel.py:pack_bvh``).
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


def _segments(counts):
    """Segment id of every element of segments of ``counts`` elements laid
    end to end, and each segment's first element."""
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.repeat(np.arange(counts.size), counts), first


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                  + e[..., 2] * e[..., 0])


def build_sah_bvh(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4,
                  n_bins: int = 16):
    """Binned-SAH BVH of two-box nodes over primitive AABBs.

    Built level by level: every node of a level is split at once, with
    numpy segment reductions over its primitives.  A node of more than
    ``leaf_size`` primitives is split at the bin boundary (``n_bins``
    bins of the centroid extent, on each axis) of least surface-area
    cost ``A_L N_L + A_R N_R``; where no boundary separates its
    centroids (all in one bin, or one centroid), it is split by count
    at the median centroid of its widest centroid axis.

    Returns ``(perm, nodes, depth)``: ``perm`` orders the primitives so
    that every leaf is a contiguous range; ``nodes`` holds, for each
    interior node in breadth-first order (the root first), its two
    children's boxes ``lo``/``hi`` [n, 2, 3] and words ``child`` [n, 2]
    and ``count`` [n, 2]: an interior child has count 0 and the index of
    its node, a leaf the first position of its range in ``perm`` and its
    count (where all primitives fit one leaf, both children of the root
    are that leaf).
    ``depth`` is the most interior nodes on a path from the root."""
    n = lo.shape[0]
    if n == 0:
        raise ValueError("build_sah_bvh: empty primitive list")
    perm = np.arange(n)
    if n <= leaf_size:
        # the root's two children are its one leaf
        box = lambda b: np.broadcast_to(b, (1, 2, 3)).copy()
        return perm, dict(lo=box(lo.min(0)), hi=box(hi.max(0)),
                          child=np.zeros((1, 2), np.int64),
                          count=np.full((1, 2), n, np.int64)), 1
    cen = 0.5 * (lo + hi)
    # the active nodes of a level: [start, end) of perm, the parent slot
    # (node index * 2 + side) their box and word go to (-1: the root)
    start = np.zeros(1, np.int64)
    end = np.full(1, n, np.int64)
    slot = np.full(1, -1, np.int64)
    box_lo, box_hi, words, counts = [], [], [], []
    n_nodes, depth = 0, 0
    while start.size:
        cnt = end - start
        seg, first = _segments(cnt)
        pos = np.repeat(start - first, cnt) + np.arange(cnt.sum())
        ids = perm[pos]
        slo = np.minimum.reduceat(lo[ids], first)
        shi = np.maximum.reduceat(hi[ids], first)
        inner = cnt > leaf_size
        node = np.full(start.size, -1, np.int64)
        node[inner] = n_nodes + np.arange(int(inner.sum()))
        has = slot >= 0
        box_lo.append((slot[has], slo[has]))
        box_hi.append(shi[has])
        words.append(np.where(inner, node, start)[has])
        counts.append(np.where(inner, 0, cnt)[has])
        n_nodes += int(inner.sum())
        if not inner.any():
            break
        depth += 1
        # ---- split every inner node of the level ----
        keep = inner[seg]
        seg_i = np.cumsum(inner)[seg[keep]] - 1       # index among inner
        m = int(inner.sum())
        pos, ids = pos[keep], ids[keep]
        k_all = ids.size
        c, lo_i, hi_i = cen[ids], lo[ids], hi[ids]
        first_i = np.concatenate([[0], np.cumsum(cnt[inner])[:-1]])
        cmin = np.minimum.reduceat(c, first_i)
        ext = np.maximum.reduceat(c, first_i) - cmin
        # the bin of every primitive on each axis, and each (axis, node,
        # bin)'s count and box: sort by that key, reduce its runs
        e = ext[seg_i].T
        bins = np.floor(n_bins * (c.T - cmin[seg_i].T)
                        / np.where(e > 0, e, 1.0)).astype(np.int64)
        bins = np.clip(bins, 0, n_bins - 1)
        key = ((np.arange(3)[:, None] * m + seg_i) * n_bins + bins).ravel()
        order = np.argsort(key, kind="stable")
        ks = key[order]
        run = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
        blo = np.full((3 * m * n_bins, 3), np.inf)
        bhi = np.full((3 * m * n_bins, 3), -np.inf)
        blo[ks[run]] = np.minimum.reduceat(lo_i[order % k_all], run)
        bhi[ks[run]] = np.maximum.reduceat(hi_i[order % k_all], run)
        nb = np.bincount(key, minlength=3 * m * n_bins).reshape(3, m, n_bins)
        blo = blo.reshape(3, m, n_bins, 3)
        bhi = bhi.reshape(3, m, n_bins, 3)
        nl = np.cumsum(nb, 2)[..., :-1]
        nr = cnt[inner][:, None] - nl
        al = _area(np.minimum.accumulate(blo, 2),
                   np.maximum.accumulate(bhi, 2))[..., :-1]
        ar = _area(np.minimum.accumulate(blo[:, :, ::-1], 2)[:, :, ::-1],
                   np.maximum.accumulate(bhi[:, :, ::-1], 2)[:, :, ::-1])[
                       ..., 1:]
        cost = np.where((nl > 0) & (nr > 0), al * nl + ar * nr, np.inf)
        # the least cost, the lower axis and boundary on a tie
        flat = cost.transpose(1, 0, 2).reshape(m, 3 * (n_bins - 1))
        arg = np.argmin(flat, 1)
        best = flat[np.arange(m), arg]
        best_axis, best_k = arg // (n_bins - 1), arg % (n_bins - 1)
        right = bins[best_axis[seg_i], np.arange(k_all)] > best_k[seg_i]
        part = seg_i * 2 + right
        by_count = ~np.isfinite(best)
        if by_count.any():
            # by count: the upper half of the centroids on the widest axis
            axis = np.argmax(ext, 1)
            rank = np.lexsort((c[np.arange(k_all), axis[seg_i]], seg_i))
            within = np.empty_like(rank)
            within[rank] = np.arange(k_all)
            within -= first_i[seg_i]
            upper = within >= cnt[inner][seg_i] // 2
            counted = by_count[seg_i]
            right = np.where(counted, upper, right)
            part = seg_i * 2 + right
            order = np.lexsort((np.where(counted, within, 0), part))
        else:
            order = np.argsort(part, kind="stable")
        perm[pos] = ids[order]
        n_left = np.bincount(seg_i, weights=~right, minlength=m).astype(
            np.int64)
        s_i, e_i, nd = start[inner], end[inner], node[inner]
        start = np.stack([s_i, s_i + n_left], 1).ravel()
        end = np.stack([s_i + n_left, e_i], 1).ravel()
        slot = np.stack([2 * nd, 2 * nd + 1], 1).ravel()

    out_lo = np.zeros((n_nodes * 2, 3))
    out_hi = np.zeros((n_nodes * 2, 3))
    child = np.zeros(n_nodes * 2, np.int64)
    count = np.zeros(n_nodes * 2, np.int64)
    for (s, bl), bh, w, k in zip(box_lo, box_hi, words, counts):
        out_lo[s], out_hi[s], child[s], count[s] = bl, bh, w, k
    nodes = dict(lo=out_lo.reshape(n_nodes, 2, 3),
                 hi=out_hi.reshape(n_nodes, 2, 3),
                 child=child.reshape(n_nodes, 2),
                 count=count.reshape(n_nodes, 2))
    return perm, nodes, depth
