"""The energy family's ops and engines against the JAX reference (CPU).

Inputs are made from a seed with numpy, or drawn by JAX and passed as
numpy, and go through the reference function and the port's. Tolerances:
- paulis, gates and the uniform kick layer at L=5 (the layer also at L=9,
  two kron groups): 1e-6 in complex64 and 1e-12 in complex128 (the same
  arithmetic, rounded in another order);
- ``hamiltonian_terms``: exact; ``dense_hamiltonian`` at L=3: 1e-12;
- the eager ``evolve_observables`` at L=6 on the reference's uniforms:
  1e-10 in complex128, 1e-5 in complex64;
- the plain K5 against the reference's K5 in interpret mode at L=17, T=3
  (the reference test's case): energy 2e-3, <Z_q> 1e-4, the reference's
  own bounds for its interpret kernel against its eager engine;
- the plain K5 on two instances at once against two single calls: the
  float32 sums of the measure in another order (``f32_rounding.py``).
The CUDA kernel itself is held against the plain K5 on the card by
``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core.evolve import evolve_observables as j_evolve
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models import hamiltonian as j_ham
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops import gates as j_gates
from dtc_tpu.ops import paulis as j_paulis
from dtc_tpu.ops.diag import zz_z_diag_energy as j_diag_energy
from dtc_tpu.ops.diag import zz_z_phase_mask as j_phase_mask
from dtc_tpu.ops.kick import apply_uniform_1q_layer as j_layer
from dtc_tpu.ops.pallas_observables import (
    observables_forward_batch as j_obs,
)
from dtc_tpu_torch.core.evolve import evolve_observables, make_floquet_params
from dtc_tpu_torch.models import hamiltonian
from dtc_tpu_torch.models.drives import build_kick_schedule, slot_unitary
from dtc_tpu_torch.ops import gates, paulis
from dtc_tpu_torch.ops import observables as obs
from dtc_tpu_torch.ops.diag import zz_z_diag_energy
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer
from dtc_tpu_torch.ops.params_general import general_forward_rows
from dtc_tpu_torch.utils import profiling

from f32_rounding import sum_order_gap

torch.set_num_threads(2)

DT = {"complex64": (np.complex64, torch.complex64, 1e-6),
      "complex128": (np.complex128, torch.complex128, 1e-12)}


def _state(L, dtype, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(*batch, 1 << L))
         + 1j * rng.normal(size=(*batch, 1 << L)))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(dtype)


def _uniforms(keys, shape):
    return np.array(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32))(keys))


@pytest.mark.parametrize("dtype", list(DT))
def test_pauli_strings_match_reference(dtype):
    np_dt, t_dt, tol = DT[dtype]
    L = 5
    rng = np.random.default_rng(1)
    psi = _state(L, np_dt, 2)
    for codes in rng.integers(0, 4, size=(6, L)):
        jm = j_paulis.pauli_string_masks(jnp.asarray(codes))
        tm = paulis.pauli_string_masks(torch.from_numpy(codes))
        assert [int(x) for x in jm] == [int(x) for x in tm]
        ref = np.asarray(j_paulis.apply_pauli_string(jnp.asarray(psi), *jm))
        got = paulis.apply_pauli_string(torch.from_numpy(psi), *tm).numpy()
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    # one string per batch entry
    codes = rng.integers(0, 4, size=(3, L))
    batch = _state(L, np_dt, 3, batch=(3,))
    got = paulis.apply_pauli_string(
        torch.from_numpy(batch),
        *paulis.pauli_string_masks(torch.from_numpy(codes))).numpy()
    for b in range(3):
        ref = j_paulis.apply_pauli_string(
            jnp.asarray(batch[b]),
            *j_paulis.pauli_string_masks(jnp.asarray(codes[b])))
        np.testing.assert_allclose(got[b], np.asarray(ref), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", list(DT))
def test_gates_match_reference(dtype):
    np_dt, t_dt, tol = DT[dtype]
    L = 5
    psi = _state(L, np_dt, 4, batch=(2,))
    tp, jp = torch.from_numpy(psi), jnp.asarray(psi)
    for q in range(L):
        for fn in ("expect_z", "expect_x"):
            np.testing.assert_allclose(
                getattr(gates, fn)(tp, q, L).numpy(),
                np.asarray(getattr(j_gates, fn)(jp, q, L)), atol=tol, rtol=0)
        for a, b in zip(gates.probabilities_bit(tp, q, L),
                        j_gates.probabilities_bit(jp, q, L)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                       rtol=0)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("L", [5, 9])  # 9: two kron groups, 7 + 2
def test_uniform_kick_layer_matches_reference(dtype, L):
    np_dt, t_dt, tol = DT[dtype]
    psi = _state(L, np_dt, 5, batch=(2,))
    u = slot_unitary(0.7, -1.1, t_dt)
    got = apply_uniform_1q_layer(torch.from_numpy(psi), u, L)
    ref = j_layer(jnp.asarray(psi), jnp.asarray(u.numpy()), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("component", hamiltonian.COMPONENTS)
def test_hamiltonian_terms_match_reference(component):
    hs, phis = generate_disorder(6, 1, seed=3)
    ref = j_ham.hamiltonian_terms(6, 0.93, hs[0], phis[0], component)
    got = hamiltonian.hamiltonian_terms(6, 0.93, torch.from_numpy(hs[0]),
                                        torch.from_numpy(phis[0]), component)
    assert np.array_equal(got.hs.numpy(), np.asarray(ref.hs))
    assert np.array_equal(got.phis.numpy(), np.asarray(ref.phis))
    assert got.x_coeff == float(ref.x_coeff)
    np.testing.assert_allclose(
        hamiltonian.dense_hamiltonian(3, hamiltonian.hamiltonian_terms(
            3, 0.93, torch.from_numpy(hs[0]), torch.from_numpy(phis[0]),
            component)).numpy(),
        j_ham.dense_hamiltonian(3, j_ham.hamiltonian_terms(
            3, 0.93, hs[0], phis[0], component)), atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="component"):
        hamiltonian.hamiltonian_terms(6, 0.93, hs[0], phis[0], "zzz")


EVOLVE_CASES = [(pol, p, dt) for pol in ("x", "y", "xy") for p in (0.0, 0.3)
                for dt in ("complex128", "complex64")]


@pytest.mark.parametrize("pol,p,dtype", EVOLVE_CASES)
def test_evolve_observables_matches_reference(pol, p, dtype):
    L, T, n = 6, 5, 3
    np_dt, t_dt, _ = DT[dtype]
    tol = 1e-10 if dtype == "complex128" else 1e-5
    real = np.float64 if dtype == "complex128" else np.float32
    t_real = torch.float64 if dtype == "complex128" else torch.float32
    hs, phis = generate_disorder(L, 1, seed=9)
    terms = j_ham.hamiltonian_terms(L, 0.93, hs[0], phis[0], "full")
    sched = j_sched(pol, 0.93, T)
    K = sched.angles.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    psi0 = np.zeros(1 << L, np_dt)
    psi0[0] = 1.0
    diag = j_phase_mask(jnp.asarray(hs[0]), jnp.asarray(phis[0]), L,
                        dtype=np_dt)
    diag_e = j_diag_energy(terms.hs, terms.phis, L, dtype=real)
    e_ref, z_ref = jax.vmap(lambda k: j_evolve(
        jnp.asarray(psi0), sched.angles, diag, diag_e, terms.x_coeff, k,
        L=L, T=T, K=K, p=p))(keys)
    u = torch.from_numpy(_uniforms(keys, (T * K, L))) if p > 0 else None
    t_terms = hamiltonian.hamiltonian_terms(L, 0.93, torch.from_numpy(hs[0]),
                                            torch.from_numpy(phis[0]))
    e, z = evolve_observables(
        torch.from_numpy(psi0).expand(n, -1),
        build_kick_schedule(pol, 0.93, T).angles,
        make_floquet_params(torch.from_numpy(hs[0]),
                            torch.from_numpy(phis[0]), L, dtype=t_dt),
        zz_z_diag_energy(t_terms.hs, t_terms.phis, L, dtype=t_real),
        t_terms.x_coeff, u, L=L, T=T, K=K, p=p)
    assert e.shape == (n, T) and z.shape == (n, T, L)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=tol,
                               rtol=0)


# ---------------------------------------------------------------------------
# plain K5 against the reference's K5 in interpret mode

L17, T17 = 17, 3
K5_CASES = {"x p=0": ("x", 0.0, "full", "vacuum"),
            "y p=0.3": ("y", 0.3, "full", "vacuum"),
            "xy p=0.2 z_zz neel": ("xy", 0.2, "z_zz", "neel")}


def _k5_inputs(pol, component, g=0.93, seed=11):
    hs, phis = generate_disorder(L17, 1, seed=seed)
    hs, phis = hs[:, :L17], phis[:, :L17 - 1]
    terms = j_ham.hamiltonian_terms(L17, g, hs[0], phis[0], component)
    return hs, phis, terms


@pytest.fixture(scope="module")
def k5_reference():
    """The reference's interpret K5 on every case, computed once."""
    out = {}
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    for name, (pol, p, component, state) in K5_CASES.items():
        hs, phis, terms = _k5_inputs(pol, component)
        sched = j_sched(pol, 0.93, T17)
        K = sched.angles.shape[1]
        with_x = float(terms.x_coeff) != 0.0
        e_d, x_s, zs = j_obs(
            jnp.asarray(hs), jnp.asarray(phis), jnp.asarray(terms.hs)[None],
            jnp.asarray(terms.phis)[None], sched.angles, keys[None], L=L17,
            T=T17, K=K, p=p, initial_state=state, with_x=with_x,
            interpret=True)
        out[name] = (np.asarray(e_d), np.asarray(x_s), np.asarray(zs),
                     _uniforms(keys, (T17 * K, L17))[None])
    return out


def _k5_port(pol, p, component, state, u):
    hs, phis, _ = _k5_inputs(pol, component)
    terms = hamiltonian.hamiltonian_terms(
        L17, 0.93, torch.from_numpy(hs[0]), torch.from_numpy(phis[0]),
        component)
    angles = build_kick_schedule(pol, 0.93, T17).angles
    K = angles.shape[1]
    rows = general_forward_rows(
        torch.from_numpy(u), torch.from_numpy(hs)[:, None],
        torch.from_numpy(phis)[:, None], angles, L=L17, T=T17, K=K, p=p)
    erow = obs.energy_row(terms.hs, terms.phis, L17)[None, None]
    return obs.observables_forward_batch(
        rows, erow, L=L17, T=T17, initial_state=state,
        with_x=terms.x_coeff != 0.0), terms


@pytest.mark.parametrize("name", list(K5_CASES))
def test_plain_k5_matches_reference_interpret(name, k5_reference):
    pol, p, component, state = K5_CASES[name]
    e_ref, x_ref, z_ref, u = k5_reference[name]
    (e_d, x_s, zs), terms = _k5_port(pol, p, component, state, u)
    assert e_d.shape == (1, 2, T17) and zs.shape == (1, 2, T17, L17)
    np.testing.assert_allclose(e_d.numpy(), e_ref, atol=2e-3, rtol=0)
    np.testing.assert_allclose(x_s.numpy(), x_ref, atol=2e-3, rtol=0)
    np.testing.assert_allclose(
        (e_d + terms.x_coeff * x_s).numpy(), e_ref + terms.x_coeff * x_ref,
        atol=2e-3, rtol=0)
    np.testing.assert_allclose(zs.numpy(), z_ref, atol=1e-4, rtol=0)
    if terms.x_coeff == 0.0:
        assert not x_s.any()


def _two_instances():
    """L, T, (2, 2, T*K, 128) rows of two disorder instances, their (2, 1,
    128) energy rows, and the widths of e_diag, x_sum and zs between a
    batch and a single call: the batch moves nothing but the measure's
    float32 sums over the 2^L amplitudes (their matrix product takes
    another order for one row than for several), so a gap within
    ``f32_rounding.sum_order_gap`` of |O| = sum |th| + sum |tph|, L, 1."""
    L, T, K, p = 14, 3, 2, 0.3
    hs, phis = generate_disorder(L, 2, seed=5)
    hs, phis = torch.from_numpy(hs[:, :L]), torch.from_numpy(phis[:, :L - 1])
    angles = build_kick_schedule("xy", 0.97, T).angles
    u = torch.from_numpy(np.random.default_rng(6).random(
        (2, 2, T * K, L), dtype=np.float32))
    rows = general_forward_rows(u, hs[:, None], phis[:, None], angles, L=L,
                                T=T, K=K, p=p)
    erow = obs.energy_row(hs, phis, L)[:, None]
    scale = float(erow[..., :2 * L - 1].abs().sum(-1).max())
    widths = [sum_order_gap(L, norm) for norm in (scale, L, 1)]
    return L, T, rows, erow, widths


def test_plain_k5_two_instances_equal_two_single_calls():
    """Each instance carries its own evolution rows and energy row; the
    batch is the two single-instance calls, within the widths of
    ``_two_instances``."""
    L, T, rows, erow, widths = _two_instances()
    both = obs.observables_forward_batch(rows, erow, L=L, T=T)
    for i in range(2):
        one = obs.observables_forward_batch(rows[i:i + 1], erow[i:i + 1],
                                            L=L, T=T)
        for a, b, w in zip(both, one, widths):
            assert a[i:i + 1].shape == b.shape
            np.testing.assert_allclose(a[i:i + 1].numpy(), b.numpy(),
                                       atol=w, rtol=0)
    assert not torch.equal(both[0][0], both[0][1])


def test_plain_k5_swapped_instance_rows_fail_by_orders_of_magnitude():
    """A planted fault, each single call given the other instance's
    evolution rows: off the batch by over 100 times a width."""
    L, T, rows, erow, widths = _two_instances()
    both = obs.observables_forward_batch(rows, erow, L=L, T=T)
    for i in range(2):
        one = obs.observables_forward_batch(rows[1 - i:2 - i],
                                            erow[i:i + 1], L=L, T=T)
        worst = max(float((a[i:i + 1] - b).abs().max()) / w
                    for a, b, w in zip(both, one, widths))
        assert worst > 100, worst


def test_plain_k5_noiseless_first_cycles():
    """Vacuum, x drive, p=0: cycle 0 measures the basis state (E = sum th +
    sum tph, x_sum 0, z 1); cycle 1 has <Z_q> = cos(pi g) for every q (the
    diagonal does not move it)."""
    L, T, g = 14, 2, 0.97
    hs, phis = generate_disorder(L, 1, seed=2)
    hs, phis = torch.from_numpy(hs[:, :L]), torch.from_numpy(phis[:, :L - 1])
    angles = build_kick_schedule("x", g, T).angles
    rows = general_forward_rows(None, hs[:, None], phis[:, None], angles,
                                L=L, T=T, K=1, p=0.0, batch=(1, 1))
    e_d, x_s, zs = obs.observables_forward_batch(
        rows, obs.energy_row(hs, phis, L)[:, None], L=L, T=T)
    assert abs(float(e_d[0, 0, 0]) - float(hs.sum() + phis.sum())) < 1e-4
    assert float(x_s[0, 0, 0]) == 0.0
    assert torch.all(zs[0, 0, 0] == 1.0)
    np.testing.assert_allclose(zs[0, 0, 1].numpy(), np.cos(np.pi * g),
                               atol=1e-5)


def test_observables_entry_rejects_out_of_range():
    rows = torch.zeros((1, 3, 128))
    erow = torch.zeros((1, 128))
    for L in (13, 24):
        with pytest.raises(ValueError, match="supports"):
            obs.observables_forward_batch(rows, erow, L=L, T=3)
    with pytest.raises(ValueError, match="K per cycle"):
        obs.observables_forward_batch(rows, erow, L=14, T=2)
    with pytest.raises(ValueError, match="supports"):
        obs.observables_forward_batch(torch.zeros((1, obs.MAX_STEPS + 1, 128)),
                                      erow, L=14, T=obs.MAX_STEPS + 1)
    with pytest.raises(ValueError):  # neither CPU (plain) nor CUDA (kernel)
        obs.observables_forward_batch(rows.to("meta"), erow, L=14, T=3)


def test_observables_wrapper_routes_cpu_to_plain_version():
    L, T = 14, 2
    hs, phis = generate_disorder(L, 1, seed=1)
    hs, phis = torch.from_numpy(hs[:, :L]), torch.from_numpy(phis[:, :L - 1])
    rows = general_forward_rows(None, hs[:, None], phis[:, None],
                                build_kick_schedule("y", 0.97, T).angles,
                                L=L, T=T, K=1, p=0.0, batch=(1, 1))
    erow = obs.energy_row(hs, phis, L)[:, None]
    profiling.reset_counters()
    a = obs.observables_forward_batch(rows, erow, L=L, T=T)
    b = obs.observables_forward_batch_ref(rows, erow, L=L, T=T)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA
