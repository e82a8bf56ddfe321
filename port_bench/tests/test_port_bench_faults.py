"""Each fault a cell can have, planted in the program under a whole run on
the CPU, turns ``correct`` false; so does the control, the reference in
bfloat16 put in the program's place. No cell has an exchange between
chips: all run on one."""

from __future__ import annotations

import pytest
import torch

from dtc_tpu_torch.experiments import energy, engine
from port_bench.run import run_cell
from port_bench.spec import Spec
from port_bench.study import gaps

CELLS = ["l20_x.autocorr", "l20_xy.autocorr", "l20_x.energy"]


# set-up's warm-up runs 3 cycles (warm_tf): the faults below leave it whole
# and break every call of the window


def _step_unchanged(*outs):
    """The state after cycle 2 is the state before it: every later reading
    moves one cycle on."""
    for o in outs:
        if o.shape[2] > 3:
            o[:, :, 3:] = o[:, :, 2:-1].clone()


def _half_batch(*outs):
    """Half of the trajectories left out, the mean taken over the rest."""
    for o in outs:
        h = o.shape[1] // 2
        if h:
            o[:, h:2 * h] = o[:, :h].clone()


def _answer_altered(*outs):
    """One trajectory's reading at one cycle altered where it is made."""
    if outs[0].shape[2] > 3:
        outs[0][0, 0, 3] += 5.0


FAULTS = {"step_unchanged": _step_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def _plant(monkeypatch, fault):
    def wrap(fn):
        def broken(*a, **kw):
            out = fn(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            fault(*outs)
            return out
        return broken

    monkeypatch.setattr(engine, "_forward_batch",
                        wrap(engine._forward_batch))
    monkeypatch.setattr(energy, "_obs_batch", wrap(energy._obs_batch))


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(small_root, monkeypatch, cell,
                                        fault):
    _plant(monkeypatch, FAULTS[fault])
    res = run_cell(Spec(small_root), cell, 2**31 + 3, 0.0, False, "cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(small_root, cell):
    """The reference in bfloat16 against the float32 reference, on three
    seeds: each fails at least one of the cell's limits."""
    spec = Spec(small_root)
    c = spec.cell(cell)
    from port_bench.spec import driver

    traffic = spec.traffic(c)
    limits = spec.limits(c)
    for seed in (1, 2, 3):
        study = driver(traffic).prepare(spec.config(c), traffic, seed, "cpu")
        inp = study.inputs(0)
        got = gaps(study.reference(inp, torch.bfloat16),
                   study.reference(inp, torch.float32))
        assert any(got[k] > limits[k] for k in limits), (seed, got)
