"""The stationary driver's rotated fused branch (kernel B's rotated mode,
``ops/iter_kernel.py:Rotation``) against its unfused rotated body (torch
glue around kernel A, forced here by refusing ``stationary_fused``), on
the CPU through the plain versions.

* Cornell at depth 4: rotate_k 2 over a 130 x 130 image (16,900 pixels
  on 17,024 lanes: padding slots), rotate_k 3 over its second row band
  (``pixel_offset`` 8,450) and rotate_k 8 over the whole image.  Both
  bodies trace the same (pixel, sample) paths with the same random
  streams, so ``iterations`` and ``segments`` are equal; the image only
  sums each pixel's contributions in another order (the planes, summed
  after the loop, against the masked rolls of every turn): per pixel
  relative gaps of float32 reassociation, median at most 1e-6 and max
  at most 1e-5.
* The fused branch's turn is one step of kernel B: as many steps as
  iterations and ``driver.iteration`` spans, and no counter recorded;
  the unfused body takes no step.
* ``iter_plain``'s rotated mode is its unrotated mode at the unfused
  body's rotated pixel maps, lane for lane (the same schedule), and adds
  each dying lane's radiance to its own (plane, slot) of the planes.
"""
import pytest
import torch

from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
from raytrace_tpu_torch.ops.iter_kernel import (
    Rotation, iter_plain, next_carry,
)
from raytrace_tpu_torch.render import integrator as tint
from raytrace_tpu_torch.testing import (
    cornell_scene_and_settings, fresh_carry, torch_threads,
)
from raytrace_tpu_torch.utils import profiling

WIDTH = 130
# (rotate_k, spp, first row, rows) of each case: the band's pixels are
# rows x WIDTH from pixel first row x WIDTH
CASES = {"k2_padding": (2, 4, 0, WIDTH),
         "k3_second_band": (3, 3, 65, 65),
         "k8_padding": (8, 8, 0, WIDTH)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with torch_threads(4):
        yield


@pytest.fixture(scope="module")
def cornell():
    return cornell_scene_and_settings(WIDTH, 8, 4, device="cpu")


def _render(scene, s, k, spp, r0, rows):
    """The band's image and ``with_stats`` dict, and what was recorded
    meanwhile: the counters, the ``driver.iteration`` spans and the
    kernel B steps taken."""
    steps = [0]
    real = tint.fused_iter_fwd_step

    def counted(*a, **kw):
        step = real(*a, **kw)

        def counted_step(*b):
            steps[0] += 1
            return step(*b)
        return counted_step

    tint.fused_iter_fwd_step = counted
    try:
        with profiling.tracing() as rec:
            acc, st = tint.trace_wavefront_stationary(
                scene, s, rng.base_key(6), rows * WIDTH, spp, rotate_k=k,
                pixel_offset=r0 * WIDTH, with_stats=True)
    finally:
        tint.fused_iter_fwd_step = real
    out = rec.export()
    turns = sum(sp["name"] == "driver.iteration" for sp in out["spans"])
    return acc, st, (out["counters"], turns, steps[0])


@pytest.fixture(scope="module")
def renders(cornell):
    """``{case: (fused, unfused)}``, each :func:`_render`'s triple."""
    scene, s = cornell
    out = {}
    for case, (k, spp, r0, rows) in CASES.items():
        assert tint.stationary_fused(scene, s, rows * WIDTH)
        fused = _render(scene, s, k, spp, r0, rows)
        real = tint.stationary_fused
        tint.stationary_fused = lambda *a: False
        try:
            unfused = _render(scene, s, k, spp, r0, rows)
        finally:
            tint.stationary_fused = real
        out[case] = fused, unfused
    return out


@pytest.mark.parametrize("count", ["iterations", "segments"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rotated_fused_counts_equal_unfused(renders, case, count):
    (_, st, _), (_, st_u, _) = renders[case]
    assert st["lanes"] == st_u["lanes"]
    assert int(st[count]) == int(st_u[count])


@pytest.mark.parametrize("case", sorted(CASES))
def test_rotated_fused_image_equals_unfused_up_to_reassociation(renders,
                                                                case):
    (acc, _, _), (acc_u, _, _) = renders[case]
    k, spp, r0, rows = CASES[case]
    assert acc.shape == acc_u.shape == (rows * WIDTH, 3)
    assert bool(torch.isfinite(acc).all()) and bool((acc_u > 0).any())
    den = acc_u.abs().sum(1)
    lit = den > 0
    assert torch.equal(acc.abs().sum(1)[~lit], den[~lit])
    rel = (acc - acc_u).abs().sum(1)[lit] / den[lit]
    assert float(rel.median()) <= 1e-6
    assert float(rel.max()) <= 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_turn_is_one_kernel_b_step(renders, case):
    (_, st, rec), (_, st_u, rec_u) = renders[case]
    assert rec == ({}, st["iterations"], st["iterations"])
    assert rec_u == ({}, st_u["iterations"], 0)


def test_plain_rotated_mode_is_the_unrotated_at_the_rotated_pixel(cornell):
    scene, s = cornell
    lanes, n_pix, off, s0, k = 512, 500, 300, 4, 4
    tables, kw = iter_kernel_args(scene, s, rng.base_key(3), s0 + 2 * k - 1)
    stride = tint.rotation_stride(lanes, k)
    rot = Rotation(k, 2, stride, s0, off, n_pix,
                   torch.zeros((k, 3, lanes)))
    carry = fresh_carry(lanes, "cpu")
    carry = (carry[0] + s0,) + carry[1:]
    planes = torch.zeros((k, 3, lanes))
    for _ in range(12):
        smp2 = torch.where((carry[2] < 0.5) & (carry[0] < s0 + 2 * k - 1),
                           carry[0] + 1, carry[0])
        # the unfused body's pixel maps, written out
        c = torch.clamp(torch.div(smp2 - s0, 2, rounding_mode="floor"),
                        0, k - 1).long()
        slot = (torch.arange(lanes) + c * stride) % lanes
        pix = (off + torch.clamp(slot, max=n_pix - 1)).to(torch.int32)
        out = iter_plain(*tables, (pix,) + carry, **kw)
        out_r = iter_plain(*tables, (torch.zeros_like(pix),) + carry,
                           rotation=rot, **kw)
        for a, b in zip(out, out_r):
            assert torch.equal(a, b)
        died = out[16] > 0.5
        planes[c[died], :, slot[died]] += torch.stack(out[7:10]).T[died]
        assert torch.equal(rot.planes, planes)
        carry = next_carry(out)
    assert bool((planes != 0).any())
