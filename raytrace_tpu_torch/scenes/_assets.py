"""The reference's test images and meshes (``scenes/_assets.py``).

The reference repository's checkout is named by the environment variable
``RT_REFERENCE``; its images and meshes are in its ``images/`` folder.
Where it is unset or lacks a file, :func:`earthmap` returns the
procedural earth and :func:`obj_path` raises.
"""
from __future__ import annotations

import os

import numpy as np


def reference_dir() -> str | None:
    """The reference repository's checkout (``RT_REFERENCE``), or None."""
    return os.environ.get("RT_REFERENCE") or None


def _ref_image(name: str) -> str | None:
    ref = reference_dir()
    return None if ref is None else os.path.join(ref, "images", name)


def earthmap() -> np.ndarray:
    """Linear-RGB earth texture [H, W, 3]: the reference's
    ``earthmap.jpg``, or where it is absent the procedural fallback
    [256, 512, 3], blue with lighter land blobs."""
    path = _ref_image("earthmap.jpg")
    if path is not None and os.path.exists(path):
        from ..render.image import read_image
        return read_image(path)
    h, w = 256, 512
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    land = (np.sin(u * 14) * np.cos(v * 9) > 0.3).astype(float)
    return np.stack([0.1 + 0.4 * land, 0.2 + 0.5 * land, 0.6 - 0.4 * land],
                    axis=-1)


def obj_path(name: str) -> str:
    """The path of the reference's mesh ``name``; raises
    ``FileNotFoundError`` where it is absent."""
    path = _ref_image(name)
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            f"{name} not found; this scene needs the reference's assets "
            "(set RT_REFERENCE to the reference repository's checkout, "
            "whose images/ folder holds them)")
    return path
