"""QASM export and gate counts of the port against the reference.

The port's kick schedule is a float64 torch tensor and the reference's a
float64 jax array. For the x drive the exported text is byte-identical; for
the other drives (cos/sin and halved angles, whose last bit may differ
between the two libraries) the parsed gate streams are equal, names and
qubits exactly and parameters within 1e-12. Gate counts, depth and noisy
gate events are equal integers. The round trip re-simulates the parsed
gates with the independent dense oracle (``tests/exact_oracle.py``) and
gets its direct value to 1e-10.
"""

import functools

import numpy as np
import pytest

import exact_oracle as oracle
from dtc_tpu.device import qasm as j_qasm
from dtc_tpu.device import transpile as j_transpile
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_schedule
from dtc_tpu_torch.device import qasm, transpile
from dtc_tpu_torch.models.drives import build_kick_schedule

DRIVES = ["x", "y", "xy", "yx", "circular_left", "xy_cycle"]
ALL_DRIVES = DRIVES + ["circular_right", "circular_static"]


@functools.lru_cache(maxsize=None)
def _schedules(pol, T):
    kw = dict(circular_frequency=0.5, xy_cycle_period=2)
    return build_kick_schedule(pol, 0.93, T, **kw), j_schedule(pol, 0.93, T,
                                                               **kw)


def _same_stream(ours, ref):
    a, b = qasm.parse_qasm_gates(ours), j_qasm.parse_qasm_gates(ref)
    assert [(n, q) for n, _, q in a] == [(n, q) for n, _, q in b]
    pa = np.array([p for _, ps, _ in a for p in ps])
    pb = np.array([p for _, ps, _ in b for p in ps])
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-12)


@pytest.mark.parametrize("interferometric", [True, False])
@pytest.mark.parametrize("state", ["vacuum", "neel"])
@pytest.mark.parametrize("echo", [False, True])
@pytest.mark.parametrize("pol", DRIVES)
def test_circuit_to_qasm_matches_reference(pol, echo, state,
                                           interferometric):
    L, T = 5, 4
    hs, phis = generate_disorder(L, 1, seed=80)
    ours_s, ref_s = _schedules(pol, T)
    kw = dict(echo=echo, initial_state=state, interferometric=interferometric,
              probe_qubit=1)
    ours = qasm.circuit_to_qasm(L, hs[0], phis[0], 3, ours_s, **kw)
    ref = j_qasm.circuit_to_qasm(L, hs[0], phis[0], 3, ref_s, **kw)
    if pol == "x":
        assert ours == ref
    else:
        _same_stream(ours, ref)
    # disorder given as tensors on the host: the same text
    import torch

    assert qasm.circuit_to_qasm(L, torch.as_tensor(hs[0]),
                                torch.as_tensor(phis[0]), 3, ours_s,
                                **kw) == ours


def test_save_qasm_writes_the_text(tmp_path):
    hs, phis = generate_disorder(4, 1, seed=3)
    sched, ref_s = _schedules("x", 3)
    path = qasm.save_qasm(str(tmp_path / "c.qasm"), 4, hs[0], phis[0], 3,
                          sched, echo=True)
    ref = j_qasm.save_qasm(str(tmp_path / "j.qasm"), 4, hs[0], phis[0], 3,
                           ref_s, echo=True)
    assert open(path).read() == open(ref).read()


@pytest.mark.parametrize("pol", ALL_DRIVES)
def test_gate_counts_match_reference(pol, tmp_path):
    for L in range(2, 9):
        for t in range(6):
            for echo in (False, True):
                for inter in (True, False):
                    kw = dict(echo=echo, polarization=pol,
                              interferometric=inter)
                    for fn in ("gate_counts", "circuit_depth",
                               "noisy_1q_gate_events"):
                        assert getattr(transpile, fn)(L, t, **kw) == \
                            getattr(j_transpile, fn)(L, t, **kw), (fn, L, t)
    ours = transpile.write_gate_count_csv(str(tmp_path / "a.csv"), 6, 3,
                                          echo=True, polarization=pol)
    ref = j_transpile.write_gate_count_csv(str(tmp_path / "b.csv"), 6, 3,
                                           echo=True, polarization=pol)
    assert open(ours).read() == open(ref).read()


def _simulate(gates, n):
    """The parsed gate stream on a dense state vector (QASM qubit 0 = the
    ancilla); <Z> of qubit 0."""
    psi = np.zeros(2**n, dtype=complex)
    psi[0] = 1.0
    p0 = np.array([[1, 0], [0, 0]], dtype=complex)
    p1 = np.array([[0, 0], [0, 1]], dtype=complex)
    for name, params, qubits in gates:
        if name == "measure":
            continue
        if name == "h":
            u = oracle.op_on(oracle.H, qubits[0], n)
        elif name == "x":
            u = oracle.op_on(oracle.X, qubits[0], n)
        elif name == "cz":
            u = (oracle.op_on(p0, qubits[0], n)
                 + oracle.op_on(p1, qubits[0], n)
                 @ oracle.op_on(oracle.Z, qubits[1], n))
        elif name in ("rx", "ry", "rz"):
            u = oracle.op_on(getattr(oracle, name)(params[0]), qubits[0], n)
        elif name == "rzz":
            u = oracle.op_on(oracle.rzz_matrix(params[0]), min(qubits), n)
        else:
            raise AssertionError(name)
        psi = u @ psi
    za = oracle.op_on(oracle.Z, 0, n)
    return float(np.real(psi.conj() @ (za @ psi)))


@pytest.mark.parametrize("state", ["vacuum", "neel"])
@pytest.mark.parametrize("echo", [False, True])
@pytest.mark.parametrize("pol", ["x", "xy", "circular_left"])
def test_qasm_roundtrip_simulates_to_the_oracle(pol, echo, state):
    """Parse the port's QASM and re-simulate it gate by gate: the oracle's
    direct noiseless value to 1e-10."""
    L, t, g = 3, 3, 0.9
    hs, phis = generate_disorder(L, 1, seed=80)
    sched = build_kick_schedule(pol, g, t)
    text = qasm.circuit_to_qasm(L, hs[0], phis[0], t, sched, echo=echo,
                                initial_state=state)
    got = _simulate(qasm.parse_qasm_gates(text), L + 1)
    want = oracle.autocorr_dm(L, g, hs[0], phis[0], t, 0.0, echo=echo,
                              initial_state=state, polarization=pol)
    np.testing.assert_allclose(got, want, atol=1e-10)
