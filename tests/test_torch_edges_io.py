"""The port's copies of the reference's edge helpers give its results
exactly: gate-count names and the name parser, the disorder file writer
(file bytes), the Pauli-string export of the Hamiltonian (equal lists,
coefficients equal as floats), and the generic heavy-hex graph, the shipped
snake layouts and their validation."""

import filecmp

import numpy as np
import pytest

from dtc_tpu.device import layouts as j_layouts
from dtc_tpu.io import disorder as j_disorder
from dtc_tpu.io import naming as j_naming
from dtc_tpu.models import hamiltonian as j_hamiltonian
from dtc_tpu.utils.config import SimConfig as JSimConfig
from dtc_tpu_torch.device import layouts
from dtc_tpu_torch.io import disorder, naming
from dtc_tpu_torch.models import hamiltonian
from dtc_tpu_torch.utils.config import SimConfig

NAME_CONFIGS = [
    {},
    dict(L=20, g=0.97, inst=2, tf=50, phi_delta=0.1, phi_amplitude=1.5),
    dict(L=7, initial_state="neel", randomphi=0, noise_prob=1e-5,
         use_noise=0, polarization="xy_cycle"),
    dict(L=4, use_optimization=1, optimization_iterations=7,
         target_echo=1.0, feedback_gain=0.05),
    dict(L=12, use_optimization=0, decay_compensation=0.25),
    dict(L=12, use_optimization=0, exponential_feedback=0),
]


@pytest.mark.parametrize("t", [0, 1, 29])
def test_gate_count_csv_name_identical(t):
    for echo in (False, True):
        for kw in ({}, dict(opt_level=3), dict(backend="fake_brisbane"),
                   dict(tag="v2"), dict(opt_level=1, backend="b", tag="x")):
            assert naming.gate_count_csv_name(t, echo, **kw) == \
                j_naming.gate_count_csv_name(t, echo, **kw)


@pytest.mark.parametrize("kw", NAME_CONFIGS)
def test_parse_config_from_name_identical(kw):
    jcfg = JSimConfig(**kw)
    names = [j_naming.autocorr_csv_name(jcfg, pol=pol, with_envelopes=env)
             for pol in (None, "xy_cycle", "circular_left")
             for env in (False, True)]
    names += [j_naming.autocorr_comparison_csv_name(jcfg),
              j_naming.energy_csv_name(jcfg), j_naming.adaptive_csv_name(jcfg),
              j_naming.adaptive_comparison_csv_name(jcfg),
              j_naming.g_history_csv_name(jcfg),
              "/some/folder/" + j_naming.autocorr_csv_name(jcfg),
              j_naming.gate_count_csv_name(3, True), "unrelated.csv"]
    for name in names:
        assert naming.parse_config_from_name(name) == \
            j_naming.parse_config_from_name(name), name


@pytest.mark.parametrize("L,inst,amp,delta,randomphi", [
    (6, 3, 1.0, 0.0, 1), (4, 1, 0.5, 0.25, 1), (9, 2, 1.0, 0.0, 0)])
def test_disorder_files_identical(L, inst, amp, delta, randomphi, tmp_path):
    ours = disorder.disorder_filenames(L, inst, amp, delta, randomphi,
                                       str(tmp_path / "torch"))
    ref = j_disorder.disorder_filenames(L, inst, amp, delta, randomphi,
                                        str(tmp_path / "jax"))
    assert [p.replace("torch", "jax") for p in ours] == list(ref)
    hs, phis = j_disorder.generate_disorder(
        L, inst, phi_amplitude=amp, phi_delta=delta, randomphi=randomphi,
        seed=L)
    disorder.save_disorder(hs, phis, *ours)
    j_disorder.save_disorder(hs, phis, *ref)
    for a, b in zip(ours, ref):
        assert filecmp.cmp(a, b, shallow=False)
    # and the port's loader reads back what it wrote
    got = disorder.load_disorder(*ours, L, inst)
    np.testing.assert_array_equal(got[0], hs)
    np.testing.assert_array_equal(got[1], phis)


@pytest.mark.parametrize("component", j_hamiltonian.COMPONENTS)
def test_pauli_string_terms_identical(component):
    L = 6
    hs, phis = j_disorder.generate_disorder(L, 1, seed=4)
    ours = hamiltonian.hamiltonian_terms(L, 0.9, hs[0], phis[0], component)
    ref = j_hamiltonian.hamiltonian_terms(L, 0.9, hs[0], phis[0], component)
    snake = j_layouts.REFERENCE_SNAKES["brisbane_energy"]
    for kw in ({}, dict(num_qubits=127, layout=snake),
               dict(num_qubits=127), dict(num_qubits=9, layout=[8, 0, 7, 1,
                                                                6, 2])):
        got = hamiltonian.pauli_string_terms(L, ours, **kw)
        want = j_hamiltonian.pauli_string_terms(L, ref, **kw)
        assert got == want
        assert all(type(c) is float for _, c in got)
    with pytest.raises(ValueError, match="layout"):
        hamiltonian.pauli_string_terms(L, ours, num_qubits=5)


@pytest.mark.parametrize("long_rows,width", [(7, 15), (3, 9), (2, 5)])
def test_heavy_hex_coupling_identical(long_rows, width):
    assert layouts.heavy_hex_coupling(long_rows, width) == \
        j_layouts.heavy_hex_coupling(long_rows, width)


@pytest.mark.parametrize("name,graph", [
    ("torino_autocorr", "heron_coupling"),
    ("brisbane_energy", "eagle_coupling"),
    ("garnet_autocorr", "garnet_coupling")])
def test_reference_snakes_and_validation_identical(name, graph):
    assert layouts.REFERENCE_SNAKES[name] == j_layouts.REFERENCE_SNAKES[name]
    n, edges, _ = getattr(layouts, graph)()
    path = layouts.REFERENCE_SNAKES[name]
    for p in (path, path[1:], path[:5] + path[:2], [n, *path[:3]]):
        for distinct in (True, False):
            assert layouts.validate_snake(p, n, edges, distinct=distinct) == \
                j_layouts.validate_snake(p, n, edges, distinct=distinct)
