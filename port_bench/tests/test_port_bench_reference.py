"""The plain reference against the port's entries on the CPU, where the
entries take their kernels' plain versions (L=14: K3 and K4; L=17: K1/K2;
energy: K5) or the sigma engine (L=8)."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench.spec import ROOT, driver
from port_bench.study import gaps

# f32 sums over at most 2^17 amplitudes in another order, 6 cycles: the
# widest gap read 9e-6
TOL = 5e-5


def _cfg(L, pol):
    with open(ROOT / "port_bench/configs/l20_x.json") as f:
        cfg = json.load(f)
    return {**cfg, "L": L, "q": L // 2, "tf": 6, "polarization": pol}


CASES = [(mix, L, pol) for L, pol in [(8, "x"), (8, "xy"), (14, "x"),
                                      (14, "xy"), (17, "x")]
         for mix in ("autocorr", "forward", "energy")
         if mix != "energy" or L >= 14]  # K5's route starts at L=14


@pytest.mark.parametrize("mix,L,pol", CASES)
def test_reference_matches_the_port_on_cpu(mix, L, pol):
    traffic = {"inst": 2 if mix == "autocorr" else 1, "n_trajectories": 4,
               "nprobs": [0.0, 0.01, 0.1], "driver": mix}
    study = driver(traffic).prepare(_cfg(L, pol), traffic, 2**31 + 5, "cpu")
    inp = study.inputs(3)
    got = gaps(study.call(inp), study.reference(inp, torch.float32))
    assert all(v < TOL for v in got.values()), got


def test_echo_reference_covers_every_t():
    traffic = {"inst": 1, "n_trajectories": 2, "driver": "autocorr"}
    cfg = {**_cfg(8, "x"), "tf": 20}
    study = driver(traffic).prepare(cfg, traffic, 11, "cpu")
    echo = study.reference(study.inputs(0), torch.float32)["echo"]
    assert echo.shape == (1, 20) and torch.isfinite(
        torch.as_tensor(echo)).all()


def test_a_call_draws_the_same_inputs_again():
    traffic = {"inst": 1, "n_trajectories": 2, "driver": "autocorr"}
    study = driver(traffic).prepare(_cfg(8, "x"), traffic, 2**33 + 1, "cpu")
    first = [study.inputs(i) for i in range(3)]
    again = study.inputs(1)
    assert all(torch.equal(a, b) for a, b in zip(first[1][3:], again[3:]))
    assert not torch.equal(first[0][3], first[1][3])
    other = driver(traffic).prepare(_cfg(8, "x"), traffic, 2**33 + 1, "cpu")
    assert torch.equal(other.inputs(0)[4], first[0][4])
