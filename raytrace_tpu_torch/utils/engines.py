"""Which engine serves each stage of a render
(``raytrace_tpu/utils/engines.py``).

A scene the kernels refuse does not fail: it falls to a slower route, so
a fallback shows only in a wall time.  :func:`engine_report` names the
route each driver takes for a scene and camera, from the drivers' own
route functions (``render/render.py:forward_route``, which
``render_accumulate`` and the stationary driver decide by, and
``render/integrator.py:bounce_route``, ``diff_route`` and
``surface_engine``, which the bounce steps decide by), so tests and the
smoke can hold it against the kernels that really launch.  It does not
influence the drivers.
"""
from __future__ import annotations


def engine_report(scene, s, *, n_pix: int | None = None,
                  lanes: int | None = None, diff: bool = False,
                  rotate_k: int = 1) -> dict:
    """Which engine serves each stage of a render of ``scene`` under the
    camera ``s``: ``render_accumulate`` at ``s.samples_per_pixel`` (its
    first chunk of at most 512 samples), or with ``diff=True`` the
    differentiable wavefront (``trace_wavefront_diff`` at ``rotate_k``;
    ``grad_render``'s ``trace`` takes the generic differentiable bounce
    whatever this says).  The keys are the JAX package's:

    * ``driver``: ``queue`` | ``sorted`` | ``stationary``, or
      ``diff-wavefront`` with ``diff``;
    * ``forward``: ``kernel-B`` (the fused iteration) | ``kernel-A`` |
      ``split`` | ``generic`` (the generic bounce);
    * ``intersect``: ``in-kernel`` (inside kernel A or B) | ``K8`` (the
      flat scan) | ``K9`` (the BVH walk) | ``torch-bvh`` (the BVH mode's
      tree walked in torch, on the CPU);
    * ``backward`` (``diff`` only, else None): ``K5`` | ``K7`` |
      ``autograd`` (the generic bounce's torch backward);
    * ``volumes``: ``K11`` | ``K11b`` | None (no media).

    ``n_pix`` defaults to the camera's whole image, ``lanes`` to the
    lane pool of that many pixels (for the work queue, the pool
    ``render_accumulate`` gives its first chunk, ``render.py:
    queue_lanes``).  On the card every name but
    ``torch-bvh`` and ``autograd`` is a kernel that launches; on the CPU
    each runs its plain version."""
    from ..render.integrator import (
        LANE_ALIGN, bounce_route, diff_route, surface_engine,
    )
    from ..render.render import default_spp_chunk, forward_route, queue_lanes
    from ..render.volumes import uses_bcast

    if n_pix is None:
        n_pix = int(s.image_width) * int(s.image_height)
    pool = lanes
    if lanes is None:
        lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    backward = None
    if diff:
        driver = "diff-wavefront"
        route = diff_route(scene, s, lanes, rotate_k=rotate_k)
        forward = {"fused": "kernel-B"}.get(route, route)
        backward = {"fused": "K5", "kernel-A": "K7"}.get(route, "autograd")
    else:
        driver, fused = forward_route(scene, s, n_pix)
        if driver == "queue" and pool is None:
            lanes = queue_lanes(n_pix, default_spp_chunk(
                "queue", int(s.samples_per_pixel), n_pix, 1 << 17))
        forward = "kernel-B" if fused else bounce_route(scene, s, lanes)
    intersect = ("in-kernel" if forward in ("kernel-A", "kernel-B")
                 else surface_engine(scene))
    volumes = None
    if scene.volumes is not None:
        volumes = "K11b" if uses_bcast(scene.volumes) else "K11"
    return {"driver": driver, "forward": forward, "intersect": intersect,
            "backward": backward, "volumes": volumes}
