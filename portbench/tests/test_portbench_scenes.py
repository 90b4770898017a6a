"""The frozen scene data: compiling ``configs/cornell.json`` and
``configs/demo1.json`` through the scene API gives the rows, materials,
textures and camera of the repository's Cornell box and demo1 scene,
and the reference's own tables hold the same rows."""
import json

import numpy as np
import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.scenes import demo1
from raytrace_tpu_torch.testing import cornell_scene_and_settings

from portbench import core, world
from portbench.reference import scene as ref_scene
from portbench.reference import tracer


def _config(name):
    return core.load_json(core.PKG / "configs" / f"{name}.json")


def _ours_and_theirs(name):
    cfg = _config(name)
    ours = world.scene(rt, cfg, "cpu")
    s_ours = world.settings(rt, cfg)
    if name == "cornell":
        theirs, s_theirs = cornell_scene_and_settings(600, 8, 50, "cpu")
        s_theirs = s_theirs.replace(rr_depth=2)
    else:
        theirs = rt.compile_scene(demo1.world(rt), accel="dense",
                                  device="cpu")
        s_theirs = demo1.settings(rt, 1200, 64, 50)
    return cfg, ours, s_ours, theirs, s_theirs


def _tensor_fields(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("name", ["cornell", "demo1"])
def test_config_compiles_to_the_repository_scene(name):
    cfg, ours, s_ours, theirs, s_theirs = _ours_and_theirs(name)
    for table in ("prims", "materials", "textures"):
        a, b = getattr(ours, table), getattr(theirs, table)
        fa, fb = _tensor_fields(a), _tensor_fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (table, k)
    assert ours.prims.n == theirs.prims.n
    assert ours.prims.kind_segments == theirs.prims.kind_segments
    for f in ("center", "look_at", "up", "redirect_prob", "redirect_q",
              "redirect_u", "redirect_v"):
        assert torch.equal(getattr(s_ours, f), getattr(s_theirs, f)), f
    for f in ("vfov", "defocus_angle", "focus_dist", "aspect_ratio",
              "image_width", "image_height", "samples_per_pixel",
              "max_depth", "rr_depth", "t_min", "rr_min"):
        assert getattr(s_ours, f) == getattr(s_theirs, f), f
    bg = s_ours.background
    assert bg is rt.sky if name == "demo1" else bg == s_theirs.background


@pytest.mark.parametrize("name", ["cornell", "demo1"])
def test_reference_tables_hold_the_same_rows(name):
    cfg, ours, *_ = _ours_and_theirs(name)
    w = ref_scene.build_world(cfg)
    real = ours.prims.kind >= 0
    key = lambda p0, e1, e2: sorted(map(tuple, torch.cat(
        [p0, e1, e2], 1).tolist()))
    assert key(w.p0, w.e1, w.e2) == key(ours.prims.p0[real],
                                       ours.prims.e1[real],
                                       ours.prims.e2[real])
    # each row's colour, through the program's material and texture ids
    tex = ours.materials.tex[ours.prims.mat[real].long()].long()
    theirs = sorted(map(tuple, torch.cat(
        [ours.prims.p0[real], ours.textures.c0[tex]], 1).tolist()))
    mine = sorted(map(tuple, torch.cat([w.p0, w.c0[w.mat]], 1).tolist()))
    assert mine == theirs


@pytest.mark.parametrize("name", ["cornell", "demo1"])
def test_reference_camera_is_the_program_camera(name):
    from raytrace_tpu_torch.render.camera import camera_frame, camera_table
    cfg, _, s_ours, _, _ = _ours_and_theirs(name)
    view = ref_scene.build_view(cfg)
    assert view.cam == camera_table(s_ours, camera_frame(s_ours))
    assert (view.width, view.height) == (s_ours.image_width,
                                         s_ours.image_height)


@pytest.mark.parametrize("name", ["cornell", "demo1"])
def test_reference_render_is_the_program_render(name):
    """At a small width the reference's sums equal the program's (the
    kernels' plain versions on the CPU) to float rounding."""
    cfg = json.loads(json.dumps(_config(name)))
    cfg["camera"]["image_width"] = 16
    cfg["render"]["max_depth"] = 8
    scene = world.scene(rt, cfg, "cpu")
    s = world.settings(rt, cfg)
    acc, _ = rt.render_accumulate(scene, s, seed=5, spp=2)
    view = ref_scene.build_view(cfg)
    n = view.width * view.height
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    smp = torch.arange(2, dtype=torch.int32).repeat_interleave(n)
    from portbench.reference import rng
    rad, _ = tracer.trace(tracer.tables(ref_scene.build_world(cfg), "cpu"),
                          view, rng.key_words(0, 5), pix, smp)
    ref = torch.zeros((n, 3)).index_add(0, pix.long(), rad)
    np.testing.assert_allclose(acc.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
