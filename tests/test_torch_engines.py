"""``utils/engines.py:engine_report`` against the route each driver
really takes, on the CPU.

Each case renders (or, for the differentiable driver, enters) a small
scene with the drivers' bounce functions, nearest-hit wrappers, crossing
wrappers and drivers wrapped by spies, and holds the report's
``driver``, ``forward``, ``intersect`` and ``volumes`` against the
functions that ran.  Renders of tables of 8,192 rows and more at the
sorted driver's image sizes are too slow for the CPU: there a stub takes
the driver's place and records that it was called.

The JAX package's report names the fused iteration for the stationary
forward at 200 spp (ROADMAP F2), where its ``render_accumulate`` rotates
the pixels (``rotate_k`` 8) and runs the bounce kernel; the port's
stationary driver fuses its rotated iteration too (kernel B's rotated
mode), so its report says kernel B, and a render at 8 spp (``rotate_k``
8) runs it.
A work queue's lane pool is its first chunk's paths
(``render.py:queue_lanes``): sphere_uv_test's one pixel is one lane, not
a multiple of 128, and takes the generic bounce, as the report says.
"""
import numpy as np
import pytest
import torch

import raytrace_tpu_torch as trt
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.render import integrator, render, volumes
from raytrace_tpu_torch.testing import (
    bunny_standin_scene, cornell_scene_and_settings, cornell_smoke_scene,
    marble_light_scene, mesh_all_kinds_world, pawn_standin_scene,
    torch_threads, uv_sphere,
)
from raytrace_tpu_torch.utils.engines import engine_report


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


class _Stubbed(Exception):
    pass


@pytest.fixture
def spies(monkeypatch):
    """``{name: calls}`` of the spied functions; the sorted driver and the
    differentiable drivers are stubs that record and stop."""
    calls = {}

    def spy(module, name, stub=None):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls.setdefault(name, []).append(k.get("generic", a[-1]
                                                    if a else None))
            if stub is not None:
                return stub(*a, **k)
            return real(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("bounce_mega_soa", "bounce_split_soa", "bounce_generic_soa",
                 "fused_iter_fwd_step", "allpairs_nearest_record",
                 "pallas_nearest_record", "nearest_hit_t"):
        spy(integrator, name)
    for name in ("trace_wavefront", "trace_wavefront_stationary"):
        spy(render, name)

    def stop(*a, **k):
        raise _Stubbed

    spy(render, "trace_wavefront_sorted", stop)
    for name in ("_trace_wavefront_diff_fused",
                 "_trace_wavefront_diff_unfused"):
        spy(integrator, name, stop)
    for name in ("pallas_volume_candidates",
                 "pallas_volume_candidates_bcast"):
        spy(volumes, name)
    return calls


FORWARD = {"kernel-A": "bounce_mega_soa", "split": "bounce_split_soa",
           "generic": "bounce_generic_soa", "kernel-B": "fused_iter_fwd_step"}
INTERSECT = {"K9": "allpairs_nearest_record", "K8": "pallas_nearest_record",
             "torch-bvh": "nearest_hit_t"}
DRIVER = {"queue": "trace_wavefront", "stationary":
          "trace_wavefront_stationary", "sorted": "trace_wavefront_sorted"}
VOLUMES = {"K11": "pallas_volume_candidates",
           "K11b": "pallas_volume_candidates_bcast"}


def _big_mesh(accel="auto"):
    """A sphere of 8,460 triangles: past the sorted driver's 8,192 rows."""
    v, f = uv_sphere(47, 90)
    mesh = trt.Mesh(v, np.zeros((0, 2)), f, np.full_like(f, -1))
    world = trt.with_material(trt.lambertian(trt.constant_texture(0.5)),
                              trt.triangle_mesh(mesh))
    s = trt.CameraSettings(center=np.asarray([0.0, 0.0, 4.0]),
                           look_at=np.asarray([0.0, 0.0, 0.0]),
                           image_width=128, samples_per_pixel=1, max_depth=2)
    return trt.compile_scene(world, accel=accel, device="cpu"), s


def _bvh_mode():
    scene = trt.compile_scene(mesh_all_kinds_world(trt, 18), accel="bvh",
                              device="cpu")
    s = trt.CameraSettings(center=np.asarray([0.0, 2.0, 8.0]),
                           look_at=np.asarray([0.0, 0.0, 0.0]),
                           image_width=16, samples_per_pixel=1, max_depth=3,
                           background=trt.sky)
    return scene, s


def _sphere_uv():
    """``scenes/sphere_uv_test.py`` at its own 1 x 1 pixel, 1 spp."""
    from types import SimpleNamespace
    from raytrace_tpu_torch.scenes import sphere_uv_test
    return sphere_uv_test.build(SimpleNamespace(width=1, spp=1, depth=10,
                                                device="cpu"))[:2]


CASES = {
    "cornell_1spp": lambda: cornell_scene_and_settings(128, 1, 3,
                                                       device="cpu"),
    "cornell_8spp": lambda: cornell_scene_and_settings(128, 8, 2,
                                                       device="cpu"),
    "cornell_queue": lambda: cornell_scene_and_settings(16, 2, 3,
                                                        device="cpu"),
    "mesh_queue": lambda: bunny_standin_scene(16, 1, 3, device="cpu"),
    "big_mesh_sorted": _big_mesh,
    "smoke_queue": lambda: cornell_smoke_scene(16, 1, 4, device="cpu"),
    "pawn_sorted": lambda: pawn_standin_scene(128, 1, 3, device="cpu"),
    "pawn_queue": lambda: pawn_standin_scene(16, 1, 3, device="cpu"),
    "marble_light": lambda: marble_light_scene(16, 1, 3, device="cpu"),
    "bvh_mode": _bvh_mode,
    # one pixel: a one-lane work queue, not a multiple of 128 lanes
    "uv_one_pixel": _sphere_uv,
}

EXPECTED = {
    "cornell_1spp": ("stationary", "kernel-B", "in-kernel", None),
    "cornell_8spp": ("stationary", "kernel-B", "in-kernel", None),
    "cornell_queue": ("queue", "kernel-A", "in-kernel", None),
    "mesh_queue": ("queue", "split", "K9", None),
    "big_mesh_sorted": ("sorted", "split", "K9", None),
    "smoke_queue": ("queue", "split", "K8", "K11"),
    "pawn_sorted": ("sorted", "split", "K9", "K11b"),
    "pawn_queue": ("queue", "split", "K9", "K11b"),
    "marble_light": ("queue", "generic", "K8", None),
    "bvh_mode": ("queue", "split", "torch-bvh", None),
    "uv_one_pixel": ("queue", "generic", "K8", None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_report_matches_the_route_taken(case, spies):
    scene, s = CASES[case]()
    rep = engine_report(scene, s)
    assert (rep["driver"], rep["forward"], rep["intersect"],
            rep["volumes"]) == EXPECTED[case]
    assert rep["backward"] is None
    try:
        img = trt.render(scene, s, seed=1)
        assert bool(torch.isfinite(img).all())
    except _Stubbed:
        assert rep["driver"] == "sorted"
    ran = set(spies)
    assert DRIVER[rep["driver"]] in ran
    assert not (ran & set(DRIVER.values())) - {DRIVER[rep["driver"]]}
    if rep["driver"] == "sorted":
        return              # the stub stopped before the bounce
    assert FORWARD[rep["forward"]] in ran
    assert not (ran & set(FORWARD.values())) - {FORWARD[rep["forward"]]}
    walks = ran & set(INTERSECT.values())
    if rep["intersect"] == "in-kernel":
        assert not walks
    else:
        assert walks == {INTERSECT[rep["intersect"]]}
    assert ran & set(VOLUMES.values()) == (
        set() if rep["volumes"] is None else {VOLUMES[rep["volumes"]]})


def test_bench_forward_reports_kernel_b():
    """ROADMAP F2: the bench forward (600 x 600, 200 spp) rotates pixels
    8 ways and runs kernel B in its rotated mode; at 1 spp the fused
    iteration runs unrotated."""
    scene, s = cornell_scene_and_settings(600, 200, 50, device="cpu")
    rep = engine_report(scene, s)
    assert (rep["driver"], rep["forward"], rep["intersect"]) == (
        "stationary", "kernel-B", "in-kernel")
    rep1 = engine_report(scene, s.replace(samples_per_pixel=1))
    assert rep1["forward"] == "kernel-B"
    assert render.rotate_k_for(200) == 8


DIFF_CASES = {
    "cornell": (lambda: cornell_scene_and_settings(16, 2, 3, device="cpu"),
                ("kernel-B", "in-kernel", "K5", None)),
    "mesh": (lambda: bunny_standin_scene(16, 1, 3, device="cpu"),
             ("kernel-B", "in-kernel", "K5", None)),
    "big_mesh": (_big_mesh, ("generic", "K9", "autograd", None)),
    "smoke": (lambda: cornell_smoke_scene(16, 1, 4, device="cpu"),
              ("generic", "K8", "autograd", "K11")),
    "bvh_mode": (_bvh_mode, ("generic", "torch-bvh", "autograd", None)),
    "rich_light": (lambda: marble_light_scene(16, 1, 3, device="cpu"),
                   ("generic", "K8", "autograd", None)),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_report_matches_the_route_taken(case, spies):
    make, expected = DIFF_CASES[case]
    scene, s = make()
    pix = torch.arange(128, dtype=torch.int32)
    rep = engine_report(scene, s, n_pix=128, diff=True)
    assert rep["driver"] == "diff-wavefront"
    assert (rep["forward"], rep["intersect"], rep["backward"],
            rep["volumes"]) == expected
    with pytest.raises(_Stubbed):
        integrator.trace_wavefront_diff(scene, s, rng.base_key(0), pix, 1)
    if rep["forward"] == "kernel-B":
        assert set(spies) >= {"_trace_wavefront_diff_fused"}
        assert "_trace_wavefront_diff_unfused" not in spies
    else:
        generic = spies["_trace_wavefront_diff_unfused"][0]
        assert generic == (rep["forward"] == "generic")
