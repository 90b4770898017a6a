"""The differentiable bounce of the unfused wavefront
(``raytrace_tpu/diff/mega_bounce.py``: ``mega_bounce_diff_soa``).

:func:`mega_bounce_diff_soa` is a ``torch.autograd.Function`` over one
bounce of every lane: kernel A forward (``render/integrator.py:
bounce_mega_soa`` with the winner index), and a backward that replays the
bounce from its saved inputs and the winner index through kernel K7
(``diff/lane_replay.py:replay_bwd_soa``), differentiable with respect to
every float leaf of the scene.  Sampled directions and the MIS mixture pdf
stay detached, as in the forward kernels' plain versions.  It returns the
bounce's radiance *contribution*, not the new radiance, so the caller's
radiance carry never enters the saved tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.bounce_kernel import N_U
from ..render.integrator import BounceTables, bounce_mega_soa, bounce_tables
from .gradients import leaves, map_scene
from .lane_replay import prim_columns, replay_bwd_soa


@dataclasses.dataclass(frozen=True)
class MegaStatics:
    """What one unfused bounce needs besides its lane tensors: kernel A's
    tables, the detached scene, the names of the float leaves that take
    gradients (in input order) and the per-prim gathered columns of K7
    (:func:`lane_replay.prim_columns`)."""
    tables: BounceTables
    scene: object
    names: tuple
    cols: tuple
    n_row: int


def mega_statics(scene, s) -> MegaStatics:
    """:class:`MegaStatics` of ``scene`` (its leaves with
    ``requires_grad``, as :func:`gradients.partition` makes them, take
    gradients) and camera ``s``; built once per driver call."""
    names = tuple(k for k, v in leaves(scene).items() if v.requires_grad)
    with torch.no_grad():
        det = map_scene(lambda x: x.detach(), scene)
        n_row = 15 if det.prims.has_motion else 9
        return MegaStatics(tables=bounce_tables(det, s), scene=det,
                           names=names, cols=prim_columns(det, n_row),
                           n_row=n_row)


class _MegaBounce(torch.autograd.Function):
    """Inputs ``(st, s, comps [7, R], uniforms [>=8, R], thr [3, R],
    alive, *float leaves)``; outputs ``(comps2 [7, R], contrib [3, R],
    thr2 [3, R], alive2, died)``."""

    @staticmethod
    def forward(ctx, st, s, comps, uniforms, thr, alive, *params):
        comps2, contrib, thr2, alive2, died, idx = bounce_mega_soa(
            st.scene, s, comps, uniforms, torch.zeros_like(thr), thr, alive,
            with_idx=True, tables=st.tables)
        # residuals: the bounce's inputs (not parked), its 8 uniform
        # columns, alive and the winner index
        ctx.save_for_backward(comps, uniforms[:N_U], thr, alive, idx)
        ctx.st = st
        ctx.s = s
        ctx.mark_non_differentiable(alive2, died)
        return comps2, contrib, thr2, alive2, died

    @staticmethod
    def backward(ctx, g_comps2, g_contrib, g_thr2, _g_alive, _g_died):
        st = ctx.st
        comps, u_cols, thr, alive, idx = ctx.saved_tensors
        z3 = torch.zeros_like(thr)
        ct12 = torch.cat([
            torch.zeros((6,) + comps.shape[1:], device=comps.device)
            if g_comps2 is None else g_comps2[0:6],
            z3 if g_contrib is None else g_contrib,
            z3 if g_thr2 is None else g_thr2]).contiguous()
        g_scene, g_comps, g_thr = replay_bwd_soa(
            st.scene, ctx.s, comps, u_cols, thr, alive, idx, ct12,
            has_motion=st.n_row == 15, t_min=st.tables.t_min, cols=st.cols,
            ttbl=st.tables.ttbl)
        if g_comps2 is not None:
            g_comps[6] += g_comps2[6]       # the time passes through
        gl = leaves(g_scene)
        return ((None, None, g_comps, None, g_thr, None)
                + tuple(gl[k] for k in st.names))


def mega_bounce_diff_soa(scene, s, comps, uniforms, thr, alive,
                         statics: MegaStatics | None = None):
    """One differentiable bounce of every lane on a scene kernel A takes.

    ``comps`` [7, R] (origin, direction, time), ``uniforms`` [>=8, R]
    (only the first 8 columns enter the bounce), ``thr`` [3, R],
    ``alive`` bool [R].  Returns ``(comps2 [7, R], contrib [3, R], thr2
    [3, R], alive2, died)``, ``contrib`` being this bounce's radiance
    contribution (the caller adds it to its carry).  Differentiable with
    respect to ``comps``, ``thr`` and every float leaf of ``scene`` with
    ``requires_grad``; the integer tables and ``s`` get no gradient.
    ``statics`` is :func:`mega_statics`' result, built here if not
    given."""
    st = mega_statics(scene, s) if statics is None else statics
    lv = leaves(scene)
    return _MegaBounce.apply(st, s, comps, uniforms, thr, alive,
                             *(lv[k] for k in st.names))
