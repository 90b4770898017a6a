"""The ray-sorted work-queue driver (``render/integrator.py:
trace_wavefront_sorted``) and the routing to it, on the CPU.

The scene: a ground and a metal sphere under the sky, with a red fog
bounded by a lat-long sphere mesh of 80 triangles (a mesh-scale medium
boundary: kernel K11b's table) around a glass ball.

* The sorted driver traces the same (pixel, sample) paths as the
  pixel-stationary one, so the two images differ only by the order of
  float adds: per pixel within rtol 1e-5 + atol 1e-6 (32 x 32, 4 spp,
  depth 8); a band of pixels at an offset equals the same pixels of the
  whole image.
* Against the JAX package's ``trace_wavefront_sorted`` on the same scene
  (JAX's XLA bounce on the CPU): the bounds of ``tests/test_torch_render.py``
  (mean within rtol 2e-3, median pixel to f32 rounding, under 5% of
  pixels off by more than 1e-5: XLA contracts multiply-adds, and its
  crossing scan may flag a tie between one row's exit and a later row's
  entry differently); with ``with_stats`` on both sides, the lanes equal
  and the iterations and segments within ``tests/test_torch_stats.py``'s
  2% and 1%.
* Routing (JAX ``render.py:_stationary_fn``): a stationary render takes
  the sorted driver for media with 64 boundary rows and more or a surface
  table of 8,192 rows and more, the stationary driver otherwise; a
  table of 8,192 rows renders instead of raising.
* The turn around the bounce (``ops/sorted_turn.py``): after the stable
  argsort of the sort keys the dead lanes are a suffix, so the exclusive
  count of dead lanes before a dead lane is its index less the live
  count (what the kernel uses in place of the cumsum); the driver's
  image and counts equal, bit for bit, those of the loop it had before
  HEAD and TAIL (``_loop_before``: the same torch lines, inline) on the
  fog and pawn scenes, with Russian roulette and at a pixel offset; and
  ``csrc/sorted_turn.cu`` built for the host (``testing.host_library``:
  its grid as blocks of 32 host threads) equals the plain versions on
  every launch of a render (``testing.sorted_turn_checks``): the lane
  ints, keys, control words and counts exactly, the floats exactly but
  for the camera rays of the lanes that start a sample (within
  ``ATOL + RTOL |plain|``: the host's ``sinf``, ``cosf`` and ``sqrtf``
  against torch's CPU kernels), the radiance sums within
  ``SCATTER_RTOL x k x |plain|``; one medium (15 uniform columns) and two
  (16), with Russian roulette, at a pixel offset with padding lanes,
  over launches of every state of the queue (the first turn, middle
  turns, the turn whose items run out inside the dead suffix, drain
  turns).  The uniform blocks of both HEADs equal ``rng.uniform_cols``
  for an odd and an even column count.
"""
import numpy as np
import pytest
import torch

import raytrace_tpu as jrt
import raytrace_tpu_torch as trt
from raytrace_tpu.core import rng as jrng
from raytrace_tpu.render.integrator import (
    trace_wavefront_sorted as jsorted,
)
from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.interop import scene_from_numpy, scene_to_numpy
from raytrace_tpu_torch.ops.sorted_turn import (
    DEAD_KEY, SortedTurn, _sort_key, head_args, head_buffers,
    sorted_head_plain, sorted_lanes, tail_args,
)
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.render import render as trender_mod
from raytrace_tpu_torch.render.camera import camera_frame, camera_table
from raytrace_tpu_torch.render.integrator import (
    trace_wavefront_sorted, trace_wavefront_stationary,
)
from raytrace_tpu_torch.render.render import uses_sorted
from raytrace_tpu_torch.testing import (
    cornell_smoke_scene, host_library, pawn_standin_scene,
    sorted_turn_checks, torch_threads, uv_sphere,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def fog_mesh_world(rt, second_medium: bool = False):
    v, f = uv_sphere(6, 8)
    mesh = rt.Mesh(vertices=1.2 * v + np.asarray([0.0, 0.2, 0.0]),
                   uv=np.zeros((0, 2)), faces=f, uv_faces=np.full_like(f, -1))
    extra = [rt.with_material(
        rt.isotropic(rt.constant_texture([0.3, 0.4, 0.9])),
        rt.constant_medium(0.9, rt.sphere([-2.0, 0.2, 0.5], 0.7)))] \
        if second_medium else []
    return rt.group(extra + [
        rt.with_material(rt.lambertian(rt.constant_texture([0.6, 0.6, 0.5])),
                         rt.parallelogram([-6, -1, -6], [12, 0, 0],
                                          [0, 0, 12])),
        rt.with_material(rt.metal(0.1, rt.constant_texture([0.8, 0.7, 0.6])),
                         rt.sphere([2.2, 0.0, -0.5], 1.0)),
        rt.with_material(rt.dielectric(1.5), rt.sphere([0.0, 0.2, 0.0],
                                                       0.5)),
        rt.with_material(rt.isotropic(rt.constant_texture([0.9, 0.2, 0.2])),
                         rt.constant_medium(1.5, rt.triangle_mesh(mesh))),
    ])


def _settings(rt, width=32):
    return rt.CameraSettings(center=np.asarray([0.0, 1.0, 5.0]),
                             look_at=np.asarray([0.0, 0.0, 0.0]),
                             image_width=width, max_depth=8,
                             background=rt.sky)


@pytest.fixture(scope="module")
def fog():
    ts = trt.compile_scene(fog_mesh_world(trt), device="cpu")
    assert ts.volumes.prims.kind.shape[0] == 80 and uses_sorted(ts)
    return ts, _settings(trt)


def test_sorted_matches_stationary(fog):
    ts, s = fog
    key = rng.base_key(3)
    n_pix = 32 * 32
    a = trace_wavefront_stationary(ts, s, key, n_pix, 4)
    b = trace_wavefront_sorted(ts, s, key, n_pix, 4)
    assert torch.isfinite(b).all() and float(b.mean()) > 0.0
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    # a band of rows at an offset: the same pixels
    half = trace_wavefront_sorted(ts, s, key, n_pix // 2, 4,
                                  pixel_offset=n_pix // 2)
    torch.testing.assert_close(half, a[n_pix // 2:], rtol=1e-5, atol=1e-6)


def test_sorted_matches_jax_sorted(fog):
    js = jrt.compile_scene(fog_mesh_world(jrt))
    jset = _settings(jrt)
    ts = scene_from_numpy(scene_to_numpy(js), device="cpu")
    _, s = fog
    n_pix = 32 * 32
    a, jst = jsorted(js, jset, jrng.base_key(3), n_pix, 4, with_stats=True)
    b, tst = trace_wavefront_sorted(ts, s, rng.base_key(3), n_pix, 4,
                                    with_stats=True)
    a, b = np.asarray(a) / 4, b.numpy() / 4
    # the drivers' counts (tests/test_torch_stats.py's bounds; measured
    # equal: 13 iterations, 6,714 segments)
    assert tst["lanes"] == int(jst["lanes"]) == n_pix
    for name, rtol in (("iterations", 0.02), ("segments", 0.01)):
        assert abs(int(tst[name]) - int(jst[name])) <= rtol * int(jst[name])
    diff = np.abs(a - b).max(axis=1)
    assert (diff > 1e-5).mean() < 0.05, (diff > 1e-5).mean()
    assert np.median(diff) <= 1e-6
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)


def test_routing_to_the_sorted_driver(fog, monkeypatch):
    ts, s = fog
    smoke, _ = cornell_smoke_scene(16, 1, 4, device="cpu")
    pawn, _ = pawn_standin_scene(16, 1, 4, device="cpu")
    assert uses_sorted(pawn) and not uses_sorted(smoke)
    calls = []
    for name in ("trace_wavefront_sorted", "trace_wavefront_stationary"):
        def spy(scene, settings, key, n_pix, spp, _name=name, **kw):
            calls.append(_name)
            return torch.zeros((n_pix, 3))
        monkeypatch.setattr(trender_mod, name, spy)
    big = s.replace(image_width=128)
    trender_mod.render_accumulate(ts, big, 0, spp=1)
    trender_mod.render_accumulate(smoke, big, 0, spp=1)
    assert calls == ["trace_wavefront_sorted", "trace_wavefront_stationary"]


def test_table_of_8192_rows_renders():
    v, f = uv_sphere(47, 90)
    ts = trt.compile_scene(trt.with_material(
        trt.lambertian(trt.constant_texture([0.6, 0.6, 0.6])),
        trt.triangle_mesh(trt.Mesh(1.5 * v, np.zeros((0, 2)), f,
                                   np.full_like(f, -1)))), device="cpu")
    assert ts.prims.kind.shape[0] >= 8192 and uses_sorted(ts)
    s = trt.CameraSettings(center=[0.0, 1.0, 4.0], look_at=[0.0, 0.0, 0.0],
                           image_width=16, max_depth=2, background=trt.sky)
    acc = trace_wavefront_sorted(ts, s, rng.base_key(0), 256, 1)
    assert acc.shape == (256, 3) and torch.isfinite(acc).all()
    assert float(acc.mean()) > 0.0


@pytest.mark.parametrize("case", ["none_dead", "all_dead", "half", "few"])
def test_dead_lanes_are_a_suffix_after_the_stable_argsort(case):
    gen = torch.Generator().manual_seed(11)
    lanes = 896
    comps = torch.randn((7, lanes), generator=gen) * 3.0
    p_alive = dict(none_dead=1.0, all_dead=0.0, half=0.5, few=0.05)[case]
    alive = torch.rand(lanes, generator=gen) < p_alive
    blo = torch.tensor([-4.0, -4.0, -4.0])
    binv = torch.tensor([0.125, 0.2, 0.1])
    key = _sort_key(comps, alive, blo, binv)
    assert int(key.max()) <= DEAD_KEY and \
        bool((key[alive] < DEAD_KEY).all())
    perm = torch.argsort(key, stable=True)
    alive_p = alive[perm]
    n_live = int(alive.sum())
    assert bool(alive_p[:n_live].all()) and not bool(alive_p[n_live:].any())
    # the driver's exclusive cumsum of the dead lanes, at the dead lanes
    dead_i = (~alive_p).to(torch.int64)
    excl = torch.cumsum(dead_i, 0) - dead_i
    idx = torch.arange(lanes)
    assert torch.equal(excl[n_live:], idx[n_live:] - n_live)


def _loop_before(scene, s, base_key, n_pix, spp, sample_offset=0,
                 pixel_offset=0):
    """The sorted driver's loop as it was before HEAD and TAIL: the same
    torch lines in one function (the re-bin's key, argsort and gathers,
    the queue's cumsum, hash and camera, the bounce, the depth cap,
    Russian roulette, the flush, the state pack).  Returns the [n_pix, 3]
    sum, the turns and the segments."""
    from raytrace_tpu_torch.render.camera import rays_from_table
    from raytrace_tpu_torch.render.integrator import (
        LANE_ALIGN, _bounce_step, _n_scan_prims, _russian_roulette,
        n_bounce_uniforms,
    )
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    n_u = n_bounce_uniforms(scene)
    cam = camera_table(s, camera_frame(s))
    total_work = n_pix * spp
    bounce_fn, tables = _bounce_step(scene, s, lanes)
    p = scene.prims
    nn = _n_scan_prims(p)
    ext = torch.abs(p.e1[:nn]) + torch.abs(p.e2[:nn])
    blo = (p.p0[:nn] - ext).amin(0)
    bhi = (p.p0[:nn] + ext).amax(0)
    binv = 1.0 / torch.clamp(bhi - blo, min=1e-6)
    acc3 = torch.zeros((3, n_pix))
    next_w = torch.zeros((), dtype=torch.int64)
    fstate = torch.zeros((13, lanes))
    fstate[5] = 1.0
    istate = torch.zeros((4, lanes), dtype=torch.int32)
    iters, segments = 0, 0
    while bool((next_w < total_work) | (istate[3] > 0).any()):
        perm = torch.argsort(_sort_key(fstate, istate[3] > 0, blo, binv),
                             stable=True)
        fstate = fstate[:, perm]
        istate = istate[:, perm]
        comps, rad, thr = fstate[0:7], fstate[7:10], fstate[10:13]
        pixel, sample, depth = istate[0], istate[1], istate[2]
        alive = istate[3] > 0
        dead = ~alive
        dead_i = dead.to(torch.int64)
        wi = next_w + torch.cumsum(dead_i, 0) - dead_i
        can = dead & (wi < total_work)
        w_safe = torch.clamp(wi, max=total_work - 1)
        pixel = torch.where(can, (w_safe % n_pix).to(torch.int32), pixel)
        sample = torch.where(
            can, (torch.div(w_safe, n_pix, rounding_mode="floor")
                  + sample_offset).to(torch.int32), sample)
        depth = torch.where(can, 0, depth)
        alive = alive | can
        next_w = next_w + can.sum()
        keys = rng.ray_keys_fast(base_key, pixel_offset + pixel, sample)
        uniforms = rng.uniform_cols(rng.mix_depth(keys, depth), n_u + 6)
        new_comps = rays_from_table(cam, s.image_width, pixel_offset + pixel,
                                    uniforms[n_u:n_u + 5])
        comps = torch.where(can, new_comps, comps)
        rad = rad * (1.0 - can.to(torch.float32))
        thr = torch.where(can, 1.0, thr)
        comps, rad, thr, alive, died = bounce_fn(
            scene, s, comps, uniforms, rad, thr, alive, tables=tables)
        depth = depth + 1
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[n_u + 5], depth, thr, alive, died)
        acc3.index_add_(1, pixel.long(), rad * died.to(torch.float32))
        fstate = torch.cat([comps, rad, thr])
        istate = torch.stack([pixel, sample, depth, alive.to(torch.int32)])
        iters += 1
        segments += int((alive | died).sum())
    return acc3.T, iters, segments


@pytest.mark.parametrize("case", ["fog", "fog_rr_offset", "pawn",
                                  "pawn_offset"])
def test_sorted_driver_equals_the_loop_before_head_and_tail(fog, case):
    if case.startswith("fog"):
        scene, s = fog
        width, spp = 32, 4
    else:
        scene, s = pawn_standin_scene(24, 3, 8, device="cpu")
        width, spp = 24, 3
    if case.endswith("rr_offset"):
        s = s.replace(rr_depth=2)
    offset = 100 if "offset" in case else 0
    n_pix = width * width - offset
    key = rng.base_key(5)
    acc, st = trace_wavefront_sorted(scene, s, key, n_pix, spp,
                                     sample_offset=3, pixel_offset=offset,
                                     with_stats=True)
    ref, iters, segments = _loop_before(scene, s, key, n_pix, spp, 3,
                                        offset)
    assert torch.equal(acc, ref)
    assert (st["iterations"], int(st["segments"])) == (iters, segments)


_RUN = r"""
// The grids on the host: blocks of 32 threads, one lane a thread.
extern "C" int run_head(const HeadArgs* a) {
  rt_host_launch(static_cast<int>((a->n_lanes + 31) / 32), 32,
                 [&] { sorted_head_kernel(*a); });
  return 0;
}
extern "C" int run_tail(const TailArgs* a) {
  rt_host_launch(static_cast<int>((a->n_lanes + 31) / 32), 32,
                 [&] { sorted_tail_kernel(*a); });
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_turn(tmp_path_factory):
    """HEAD and TAIL of ``csrc/sorted_turn.cu`` built for the host, called
    as ``ops/sorted_turn.py:sorted_head`` and ``sorted_tail``."""
    import ctypes
    lib = host_library("sorted_turn.cu", _RUN,
                       tmp_path_factory.mktemp("sorted_turn"))
    if lib is None:
        pytest.skip("no host C++ compiler")

    def head(turn, perm, lanes, par):
        buffers = head_buffers(turn, perm.device)
        assert lib.run_head(ctypes.byref(
            head_args(turn, perm, lanes, par, buffers))) == 0
        return buffers

    def tail(turn, lanes, par, hd, out, acc3, segments=None):
        args, _keep = tail_args(turn, lanes, par, hd, out, acc3, segments)
        assert lib.run_tail(ctypes.byref(args)) == 0
    return head, tail


@pytest.mark.parametrize("case", ["one_medium", "one_medium_rr",
                                  "two_media", "offset"])
def test_sorted_turn_host_build_matches_plain(fog, host_turn, monkeypatch,
                                              case):
    if case == "two_media":
        scene = trt.compile_scene(fog_mesh_world(trt, second_medium=True),
                                  device="cpu")
        s = _settings(trt)
    else:
        scene, s = fog
    if case == "one_medium_rr":
        s = s.replace(rr_depth=2)
    offset = 200 if case == "offset" else 0
    n_pix = 32 * 32 - offset
    stats = {}
    for name, fn in sorted_turn_checks(stats, *host_turn).items():
        monkeypatch.setattr(integrator, name, fn)
    acc, st = trace_wavefront_sorted(scene, s, rng.base_key(9), n_pix, 4,
                                     pixel_offset=offset, with_stats=True)
    monkeypatch.undo()
    head, tail = stats["sorted_head"], stats["sorted_tail"]
    assert head["launches"] == tail["launches"] == st["iterations"] > 0
    assert head["n_int"] == 0 and head["excess"] <= 0.0, head
    assert tail["n_int"] == 0 and tail["err"] == 0.0, tail
    assert tail["acc_excess"] <= 0.0, tail
    assert all(n > 0 for n in head["turns"].values()), head["turns"]
    ref, ref_st = trace_wavefront_sorted(scene, s, rng.base_key(9), n_pix,
                                         4, pixel_offset=offset,
                                         with_stats=True)
    assert (st["iterations"], int(st["segments"])) == \
        (ref_st["iterations"], int(ref_st["segments"]))
    torch.testing.assert_close(acc, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_media", [1, 2])
def test_head_uniform_block_equals_uniform_cols(fog, host_turn, n_media):
    """15 columns (one medium: an odd count, the last hash's high half
    unused) and 16 (two media)."""
    scene, s = fog
    lanes, n_u = 256, 8 + n_media
    gen = torch.Generator().manual_seed(n_media)
    st = sorted_lanes(lanes, 10 ** 6, "cpu")
    st.istate[0] = torch.randint(0, 1024, (lanes,), generator=gen,
                                 dtype=torch.int32)
    st.istate[1] = torch.randint(0, 400, (lanes,), generator=gen,
                                 dtype=torch.int32)
    st.istate[2] = torch.randint(0, 20, (lanes,), generator=gen,
                                 dtype=torch.int32)
    st.istate[3] = (torch.arange(lanes) < 200).to(torch.int32)
    st.ctl[0], st.ctl[2] = 5000, 200
    turn = SortedTurn(s=s, cam=camera_table(s, camera_frame(s)),
                      base_key=rng.base_key(4), box=torch.zeros(6),
                      n_pix=1024, lanes=lanes, total_work=10 ** 6, n_u=n_u,
                      sample_offset=0, pixel_offset=37)
    perm = torch.arange(lanes)
    ref_st = sorted_lanes(lanes, 10 ** 6, "cpu")
    for a, b in zip((ref_st.fstate, ref_st.istate, ref_st.ctl),
                    (st.fstate, st.istate, st.ctl)):
        a.copy_(b)
    plain = sorted_head_plain(turn, perm, ref_st, 0)
    host = host_turn[0](turn, perm, st, 0)
    pixel, sample, depth = plain[4]
    want = rng.uniform_cols(rng.mix_depth(rng.ray_keys_fast(
        turn.base_key, 37 + pixel, sample), depth), n_u + 6)
    assert want.shape[0] == n_u + 6
    assert torch.equal(plain[3], want) and torch.equal(host[3], want)
    assert torch.equal(host[4], plain[4]) and torch.equal(st.ctl, ref_st.ctl)
