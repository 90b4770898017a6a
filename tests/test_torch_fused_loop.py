"""The fused differentiable driver's whole-loop node against its turn-by-turn
iteration, on the CPU.

``render_loss_wavefront`` runs each run of fused iterations (the
``n_iters`` loop and each completion phase) as one autograd node
(``fused_iter.fused_loop``).  Here the same loss is also built turn by
turn from one-turn nodes of the same Function (``testing.per_turn_loss``:
``fused_loop`` with ``n=1`` each turn, the turns' sums as autograd ops,
the completion phases compacted as the driver compacts them), on the same
inputs: Cornell at 64 px, 4096 lanes, 4 spp, 16 iterations, Russian
roulette from depth 2 (the size of ``tests/test_torch_gradients.py``),
with and without the completion schedule ``((15, 2048),)``, and the
box-and-motion scene (15 row columns).

Tolerances.  The forward is the same kernel B steps and the same adds
(a death flag is 0 or 1, so ``a + r * died`` is exact in any order): the
loss and the completed fraction are equal bit for bit.  The backward is
the same K5 launches on the same cotangents; only the order in which the
turns' row gradients are summed onto a leaf differs, so each gradient
leaf agrees to ``rtol=1e-5``, ``atol=1e-7``.  The tape holds one
whole-loop node per run of iterations, the reference's one node a turn.  A
second backward through a retained graph gives the first's gradients
exactly.  The node's one-op views and sums of rows (``fused_iter._rows``,
``row_reduce.add_rows``) take tensors of separate storages that lie back
to back in memory for what they are.
"""
import pytest
import torch

from raytrace_tpu_torch.core import rng
from raytrace_tpu_torch.diff.fused_iter import _rows
from raytrace_tpu_torch.diff.gradients import (
    leaves, partition, render_loss_wavefront,
)
from raytrace_tpu_torch.ops.row_reduce import RowGrads, add_rows
from raytrace_tpu_torch.testing import (
    box_motion_scene, cornell_scene_and_settings, per_turn_loss, tape_nodes,
    torch_threads,
)

R = 4096
SPP = 4
N_ITERS = 16
SCHEDULE = ((15, 2048),)
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _cornell():
    scene, s = cornell_scene_and_settings(64, SPP, 10, device="cpu")
    return scene, s.replace(rr_depth=2)


def _box_motion():
    scene, s = box_motion_scene(device="cpu")
    return scene, s.replace(samples_per_pixel=SPP, rr_depth=2)


CASES = {"cornell": (_cornell, None), "cornell_schedule": (_cornell, SCHEDULE),
         "box_motion": (_box_motion, None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_loop_matches_turn_by_turn(case):
    make, schedule = CASES[case]
    scene, s = make()
    n_pix = s.image_width * s.image_height
    pix = torch.arange(R, dtype=torch.int32) % n_pix
    target = torch.rand((R, 3), generator=torch.Generator().manual_seed(3))
    key = rng.base_key(0)
    params, statics = partition(scene)
    named = {k: v for k, v in leaves(params).items() if v.requires_grad}

    loss, frac = render_loss_wavefront(params, statics, s, key, pix, target,
                                       SPP, n_iters=N_ITERS,
                                       schedule=schedule)
    assert tape_nodes(loss).get("_FusedLoopBackward", 0) == 1 + len(
        schedule or ())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)

    ref, ref_frac = per_turn_loss(params, statics, s, key, pix, target, SPP,
                                  N_ITERS, schedule)
    assert tape_nodes(ref).get("_FusedLoopBackward", 0) == N_ITERS + sum(
        n for n, _ in schedule or ())
    ref_grads = torch.autograd.grad(ref, list(named.values()),
                                    allow_unused=True)

    assert torch.equal(loss, ref) and torch.equal(frac, ref_frac)
    assert 0.0 < float(frac) <= 1.0
    reached = 0
    for k, g, g_ref in zip(named, grads, ref_grads):
        if g_ref is None:
            assert g is None or not torch.any(g), k
            continue
        torch.testing.assert_close(g, g_ref, rtol=RTOL, atol=ATOL, msg=k)
        reached += bool(torch.any(g_ref))
    assert reached >= 3


def test_second_backward_through_a_retained_graph():
    scene, s = _cornell()
    pix = torch.arange(R, dtype=torch.int32) % (s.image_width
                                                * s.image_height)
    target = torch.rand((R, 3), generator=torch.Generator().manual_seed(3))
    params, statics = partition(scene)
    named = [v for v in leaves(params).values() if v.requires_grad]
    loss, _ = render_loss_wavefront(params, statics, s, rng.base_key(0), pix,
                                    target, SPP, n_iters=N_ITERS,
                                    schedule=SCHEDULE)
    first = torch.autograd.grad(loss, named, allow_unused=True,
                                retain_graph=True)
    second = torch.autograd.grad(loss, named, allow_unused=True)
    assert any(g is not None and torch.any(g) for g in first)
    for a, b in zip(first, second):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(loss, named, allow_unused=True)


def _back_to_back(*sizes):
    """f32 tensors of ``sizes`` elements, each on a storage of its own,
    lying back to back in one host buffer."""
    mem = memoryview(bytearray(4 * sum(sizes)))
    out, at = [], 0
    for n in sizes:
        out.append(torch.frombuffer(mem[at:at + 4 * n], dtype=torch.float32))
        at += 4 * n
    return [x.copy_(torch.arange(float(x.numel()))) for x in out]


def test_rows_views_one_storage_and_stacks_separate_ones():
    buf = torch.arange(12.0).view(3, 4)
    view = _rows(buf.unbind(0))
    assert view.data_ptr() == buf.data_ptr() and torch.equal(view, buf)
    ts = _back_to_back(4, 4, 4)
    assert ts[1].data_ptr() == ts[0].data_ptr() + 16
    rows = _rows(ts)
    assert rows.untyped_storage().data_ptr() != ts[0].untyped_storage(
        ).data_ptr()
    assert torch.equal(rows, torch.stack(ts))


@pytest.mark.parametrize("layout", ["one_buffer", "back_to_back"])
def test_add_rows_sums_each_field(layout):
    p, n_row, n_mats, n_tex = 3, 9, 2, 2
    nc = n_row + 7

    def grads(k):
        if layout == "one_buffer":
            buf = torch.arange(float(p * nc + n_mats + 6 * n_tex)) * k
            sums = buf[:p * nc].view(p, nc)
            g_tex = buf[p * nc + n_mats:].view(n_tex, 6)
            return RowGrads(sums[:, :n_row], buf[p * nc:p * nc + n_mats],
                            g_tex[:, :3], g_tex[:, 3:])
        sums, g_mparam, g_tex = _back_to_back(p * nc, n_mats, 6 * n_tex)
        sums, g_tex = sums.mul_(k).view(p, nc), g_tex.mul_(k).view(n_tex, 6)
        assert g_mparam.data_ptr() == sums.data_ptr() + 4 * p * nc
        return RowGrads(sums[:, :n_row], g_mparam.mul_(k), g_tex[:, :3],
                        g_tex[:, 3:])

    total, expect = grads(1.0), [x.clone() for x in grads(3.0)]
    add_rows(total, grads(2.0))
    for x, y in zip(total, expect):
        assert torch.equal(x, y)
