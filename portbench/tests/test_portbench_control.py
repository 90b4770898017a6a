"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in bfloat16 put in the program's place) and a
run driven with the timed path broken underneath, at a tiny size on the
CPU, against each cell's own limits."""
import pytest
import torch

import raytrace_tpu_torch as rt
from raytrace_tpu_torch.parallel import sharding
from raytrace_tpu_torch.render import render as render_mod

from portbench import control, core, run
from portbench.tests.tiny import SEED, TINY


def _run(workload):
    return run.Run(core.Cell(workload, overrides=TINY[workload]), SEED,
                   "cpu", core.Spans(), rt)


def _limits(workload):
    return core.Cell(workload).params["check"]


@pytest.mark.parametrize("workload", ["cornell-train", "demo1-fwd"])
def test_the_control_fails(workload):
    fn = control.train_numbers if workload == "cornell-train" \
        else control.render_numbers
    nums = fn(_run(workload), "control")
    lim = _limits(workload)
    assert any(nums[k] > lim[k] for k in lim), nums


def _correct(workload):
    line, checks, code = run.run_cell(workload, SEED, 0.0, False,
                                      device="cpu",
                                      overrides=TINY[workload])
    assert code == 0
    return line, checks


def _fails(workload):
    line, checks = _correct(workload)
    assert '"correct": false' in line, checks


def test_train_state_unchanged(monkeypatch):
    fn = sharding.sharded_train_step_fn

    def frozen(*a, **k):
        step = fn(*a, **k)
        real = step.with_state

        def with_state(scene, opt_state, *rest):
            loss, _, _ = real(scene, opt_state, *rest)
            return loss, scene, opt_state
        step.with_state = with_state
        return step
    monkeypatch.setattr(sharding, "sharded_train_step_fn", frozen)
    _fails("cornell-train")


def test_train_half_the_batch(monkeypatch):
    inner = sharding.loss_and_grads

    def half(params, statics, settings, key, pixel_ids, target, **kw):
        n = pixel_ids.shape[0] // 2
        return inner(params, statics, settings, key, pixel_ids[:n],
                     target[:n], **kw)
    monkeypatch.setattr(sharding, "loss_and_grads", half)
    _fails("cornell-train")


def test_train_answer_altered(monkeypatch):
    inner = sharding.loss_and_grads

    def altered(*a, **kw):
        (loss, frac), grads = inner(*a, **kw)
        grads.textures.c0.mul_(1.5)
        return (loss, frac), grads
    monkeypatch.setattr(sharding, "loss_and_grads", altered)
    _fails("cornell-train")


def _patch_render(monkeypatch, fn):
    real = rt.render_accumulate

    def patched(scene, settings, seed=0, *, spp=None, acc=None,
                spp_done=0, **kw):
        out, total = real(scene, settings, seed, spp=spp, acc=acc,
                          spp_done=spp_done, **kw)
        return fn(out, acc), total
    monkeypatch.setattr(rt, "render_accumulate", patched)
    monkeypatch.setattr(render_mod, "render_accumulate", patched)


def test_render_state_unchanged(monkeypatch):
    _patch_render(monkeypatch, lambda out, acc: (
        torch.zeros_like(out) if acc is None else acc.clone()))
    _fails("demo1-fwd")


def test_render_half_the_batch(monkeypatch):
    def half(out, acc):
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0 if acc is None else \
            acc[out.shape[0] // 2:]
        return out
    _patch_render(monkeypatch, half)
    _fails("demo1-fwd")


def test_render_answer_altered(monkeypatch):
    _patch_render(monkeypatch, lambda out, acc: out * 1.001)
    _fails("demo1-fwd")


@pytest.mark.cuda
def test_cells_run_correct_on_the_card(cuda_device):
    for workload in ("cornell-train", "demo1-fwd"):
        line, checks, code = run.run_cell(workload, SEED, 0.0, False,
                                          device=cuda_device,
                                          overrides=TINY[workload])
        assert code == 0 and '"correct": true' in line, checks
