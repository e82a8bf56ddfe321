"""The benchmark's large-L autocorrelator cell, ``l28_x.autocorr``, on the
CPU: the large-L reference chain (``port_bench/reference/floquet_large.py``)
against ``floquet.Chain``, the driver ``drivers/autocorr_streamed.py`` on
the streamed route's plain versions, its counted state traffic, and the
cell as the harness finds it by name."""

import numpy as np
import pytest
import torch

from port_bench.drivers import autocorr, autocorr_streamed
from port_bench.reference import floquet, floquet_large
from port_bench.spec import Spec, driver
from port_bench.study import gaps

torch.set_num_threads(2)

CELL = "l28_x.autocorr"
L_SMALL = 12
KW = dict(p=0.05, q=L_SMALL // 2, b0=0, af=0.95 ** 6)


def _disorder(L, seed=2**31 + 9):
    rng = np.random.default_rng(seed)
    hs = rng.uniform(-np.pi, np.pi, size=(2, L))
    phis = rng.uniform(0.0, np.pi, size=(2, L - 1)) - 1.5 * np.pi
    return hs, phis


def _uniforms(rows, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((2, 3, rows, L_SMALL), generator=gen)


@pytest.mark.parametrize("real", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [floquet_large.BLOCK_INDICES, 1 << 8])
def test_large_chain_equals_the_chain(block, real):
    hs, phis = _disorder(L_SMALL)
    kw = dict(L=L_SMALL, polarization="x", g=0.97, T=6, real=real,
              device="cpu")
    small = floquet.Chain(hs, phis, **kw)
    large = floquet_large.Chain(hs, phis, block=block, **kw)
    assert large.zs is None
    # E: the same 2L - 1 terms summed in another order
    assert torch.allclose(large.energy, small.energy, rtol=0, atol=1e-12)
    assert torch.equal(large.d0, small.d0)
    u, u_echo = _uniforms(6, 1), _uniforms(12, 2)
    assert np.array_equal(floquet.forward_autocorr(large, u, **KW),
                          floquet.forward_autocorr(small, u, **KW))
    assert np.array_equal(floquet.echo_autocorr(large, u_echo, range(6), **KW),
                          floquet.echo_autocorr(small, u_echo, range(6), **KW))
    for a, b in zip(floquet.energy_trace(large, u, p=0.05, b0=0),
                    floquet.energy_trace(small, u, p=0.05, b0=0)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_streamed_study_matches_the_large_reference_at_l24():
    """L=24, the smallest L that ``engine_for`` sends to the streamed x
    family: T=3, one trajectory, the plain versions of K6 against the
    large-L reference, within the cell's own limits."""
    spec = Spec()
    cell = spec.cell(CELL)
    traffic = spec.traffic(cell)
    cfg = {**spec.config(cell), "L": 24, "q": 12, "tf": 3}
    study = driver(traffic).prepare(cfg, traffic, 2**33 + 7, "cpu")
    inp = study.inputs(0)
    got = gaps(study.call(inp), study.reference(inp, torch.float32))
    limits = spec.limits(cell)
    assert set(got) == set(limits)
    assert all(got[k] <= limits[k] for k in limits), got


@pytest.mark.parametrize("L,adds", [(20, False), (22, False), (23, True),
                                    (28, True)])
def test_work_adds_the_state_floor_past_the_l2(L, adds):
    spec = Spec()
    cell = spec.cell(CELL)
    traffic = spec.traffic(cell)
    cfg = {**spec.config(cell), "L": L, "q": L // 2}
    base = autocorr.prepare(cfg, traffic, 1, "cpu").work
    work = autocorr_streamed.prepare(cfg, traffic, 1, "cpu").work
    floor = 16 * base["amp_steps"] if adds else 0
    assert work == {**base, "io_bytes": base["io_bytes"] + floor}


def test_l28_work_and_cycles():
    # T=50: 49 forward and sum_{t<50} 2t = 2450 echo amplitude-steps of 2^28
    spec = Spec()
    cell = spec.cell(CELL)
    study = driver(spec.traffic(cell)).prepare(spec.config(cell),
                                               spec.traffic(cell), 1, "cpu")
    assert study.cycles_per_call == 50 + 2450
    assert study.work["amp_steps"] == (49 + 2450) << 28
    assert study.work["io_bytes"] == 4 * 3 * 50 * 28 + 16 * 50 \
        + 16 * ((49 + 2450) << 28)


def test_the_harness_finds_the_cell_by_its_files():
    spec = Spec()
    cell = spec.cell(CELL)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    assert (cell["config"], cell["chips"]) == ("l28_x", 1)
    assert (cfg["L"], cfg["q"], cfg["polarization"], cfg["tf"]) == \
        (28, 14, "x", 50)
    assert driver(traffic) is autocorr_streamed
    assert (traffic["inst"], traffic["n_trajectories"]) == (1, 1)
    assert set(spec.limits(cell)) == {"forward_gap", "echo_gap"}
    bench = spec.bench
    entry = next(c for c in bench["configs"] if c["name"] == "l28_x")
    assert entry["reduced"] == cfg["reduced"] == ["n_trajectories"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert CELL in m.get("workloads", [CELL]), m["name"]
    assert {m["name"] for m in spec.metrics(cell, False)} == \
        {"cycles_per_s", "setup_s"}
    assert {m["name"] for m in spec.metrics(cell, True)} == \
        {m["name"] for m in bench["per_layer"]}
