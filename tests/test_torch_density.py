"""The exact density matrix (``dtc_tpu_torch/core/density.py``), the dense
gates (``ops/gates.py``) and the direct-mode autocorrelator
(``core/evolve.py``) against the JAX reference on the CPU.

Every function of ``dtc_tpu/core/density.py`` has its counterpart here, on
the same numpy inputs: complex128 within 1e-10, complex64 within 1e-5, at
L = 3-6 with K = 1 (x, y) and K = 2 (xy, circular_left), p = 0 and 0.05.
``run_autocorr(method="exact")`` writes the reference's CSV name and
header and its values within 1e-10 in complex128. ``autocorr_forward`` and
``autocorr_echo`` take the uniforms that the reference's split/fold_in key
schedule draws, within 1e-5 (complex64).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core import density as J
from dtc_tpu.core import evolve as j_evolve
from dtc_tpu.core.statevector import initial_statevector as j_psi0
from dtc_tpu.experiments.autocorr import run_autocorr as j_run_autocorr
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.models.drives import slot_unitary as j_slot_unitary
from dtc_tpu.models.hamiltonian import hamiltonian_terms as j_terms
from dtc_tpu.ops import gates as j_gates
from dtc_tpu.ops.diag import zz_z_phase_mask as j_phase_mask
from dtc_tpu.utils.config import SimConfig
from dtc_tpu_torch.core import density as P
from dtc_tpu_torch.core import evolve
from dtc_tpu_torch.core.statevector import initial_statevector
from dtc_tpu_torch.experiments.autocorr import run_autocorr
from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
from dtc_tpu_torch.ops import gates
from dtc_tpu_torch.ops.diag import zz_z_phase_mask
from dtc_tpu_torch.utils.cli import main as cli_main
from dtc_tpu_torch.utils.config import SimConfig as PortConfig

torch.set_num_threads(2)
DTYPES = {"complex128": (jnp.complex128, torch.complex128, 1e-10),
          "complex64": (jnp.complex64, torch.complex64, 1e-5)}
CASES = [(3, "circular_left"), (4, "x"), (5, "xy"), (6, "y")]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _rand_complex(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _case(L, pol, T=6, seed=3):
    hs, phis = generate_disorder(L, 1, seed=seed)
    ang = np.asarray(j_sched(pol, 0.97, T).angles)
    return hs[0, :L], phis[0, :L - 1], ang


def _diag(hs, phis, L, dtype_name):
    jd, td, _ = DTYPES[dtype_name]
    return (j_phase_mask(jnp.asarray(hs), jnp.asarray(phis), L, dtype=jd),
            zz_z_phase_mask(torch.tensor(hs), torch.tensor(phis), L,
                            dtype=td))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("p", [0.0, 0.05])
@pytest.mark.parametrize("L,pol", CASES)
def test_run_wrappers_match_reference(L, pol, p, dtype_name):
    """dm_autocorr_forward_run / dm_autocorr_echo_run: A(t) and the echo
    at every t, the echo's forward cycles shared across t in the port."""
    hs, phis, ang = _case(L, pol)
    kw = dict(L=L, T=6, K=ang.shape[1], p=p, q=L // 2,
              initial_state="neel" if L == 5 else "vacuum",
              dtype_name=dtype_name)
    tol = DTYPES[dtype_name][2]
    jargs = (jnp.asarray(hs), jnp.asarray(phis), jnp.asarray(ang))
    targs = (torch.tensor(hs), torch.tensor(phis), torch.tensor(ang))
    _close(P.dm_autocorr_forward_run(*targs, **kw),
           J.dm_autocorr_forward_run(*jargs, **kw), tol)
    ts = [5, 0, 2, 3, 1, 4]
    _close(P.dm_autocorr_echo_run(*targs, ts, **kw),
           J.dm_autocorr_echo_run(*jargs, jnp.asarray(ts), **kw), tol)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("L,pol", [(4, "xy"), (5, "x")])
def test_direct_mode_pieces_match_reference(L, pol, dtype_name):
    """dm_autocorr_forward, dm_autocorr_echo (one t), dm_energy with
    energy_weight_vector, and _dm_cycle forward and inverse, on a random
    operator vector."""
    jd, td, tol = DTYPES[dtype_name]
    hs, phis, ang = _case(L, pol)
    K, p, T = ang.shape[1], 0.05, 6
    jdiag, tdiag = _diag(hs, phis, L, dtype_name)
    jpsi, tpsi = j_psi0(L, "vacuum", dtype=jd), initial_statevector(
        L, "vacuum", dtype=td)
    kw = dict(L=L, T=T, K=K, p=p, q=1)
    _close(P.dm_autocorr_forward(tpsi, torch.tensor(ang), tdiag, **kw,
                                 ancilla_factor=0.9),
           J.dm_autocorr_forward(jpsi, jnp.asarray(ang), jdiag, **kw,
                                 ancilla_factor=0.9), tol)
    for t in (0, 3, T):
        _close(P.dm_autocorr_echo(tpsi, torch.tensor(ang), tdiag, t, **kw),
               J.dm_autocorr_echo(jpsi, jnp.asarray(ang), jdiag, t, **kw),
               tol)
    with pytest.raises(ValueError):
        P.dm_autocorr_echo(tpsi, torch.tensor(ang), tdiag, T + 1, **kw)
    jw = J.energy_weight_vector(j_terms(L, 0.97, hs, phis, "full"), L,
                                dtype=jd)
    tw = P.energy_weight_vector(hamiltonian_terms(
        L, 0.97, torch.tensor(hs), torch.tensor(phis), "full"), L, dtype=td)
    _close(tw, jw, tol)
    ekw = dict(L=L, T=T, K=K, p=p)
    _close(P.dm_energy(tpsi, torch.tensor(ang), tdiag, tw, **ekw),
           J.dm_energy(jpsi, jnp.asarray(ang), jdiag, jw, **ekw), 10 * tol)
    rng = np.random.default_rng(L)
    vec = _rand_complex(rng, 4 ** L)
    jdm = J.diag_mask_dm(jdiag, L)
    jdep = J.depolarizing_site_op(p, dtype=jd)
    for inverse in (False, True):
        got = P._dm_cycle(torch.tensor(vec, dtype=td), torch.tensor(ang[2]),
                          P.diag_mask_dm(tdiag, L),
                          P.depolarizing_site_op(p, dtype=td), L=L, K=K, p=p,
                          dtype=td, inverse=inverse)
        want = J._dm_cycle(jnp.asarray(vec, dtype=jd), jnp.asarray(ang[2]),
                           jdm, jdep, L=L, K=K, p=p, dtype=jd,
                           inverse=inverse)
        _close(got, want, 10 * tol)


@pytest.mark.parametrize("echo", [False, True])
@pytest.mark.parametrize("L,pol,p", [(4, "x", 0.05), (3, "xy", 0.0),
                                     (5, "circular_left", 0.05)])
def test_interferometric_matches_reference_and_direct_mode(L, pol, p, echo):
    """The literal Hadamard test: the reference's value in complex128, and
    the direct mode's at the same t."""
    hs, phis, ang = _case(L, pol)
    jdiag, tdiag = _diag(hs, phis, L, "complex128")
    jpsi = j_psi0(L, "vacuum", dtype=jnp.complex128)
    tpsi = initial_statevector(L, "vacuum", dtype=torch.complex128)
    kw = dict(L=L, K=ang.shape[1], p=p, q=L // 2, echo=echo)
    got = P.dm_autocorr_interferometric(tpsi, torch.tensor(ang), tdiag, 3,
                                        **kw)
    want = J.dm_autocorr_interferometric(jpsi, jnp.asarray(ang), jdiag, 3,
                                         **kw)
    assert abs(got - want) <= 1e-10
    dkw = dict(L=L, T=6, K=ang.shape[1], p=p, q=L // 2)
    direct = (P.dm_autocorr_echo(tpsi, torch.tensor(ang), tdiag, 3, **dkw)
              if echo else P.dm_autocorr_forward(
                  tpsi, torch.tensor(ang), tdiag, **dkw)[3])
    assert abs(got - float(direct)) <= 1e-10


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_layout_helpers_match_reference(dtype_name):
    """pure_dm_vec, op_vec, dm_vec_to_matrix, diag_mask_dm,
    pauli_weight_vector (every code at every site), trace_weight_vector
    and _interleave_bits."""
    jd, td, tol = DTYPES[dtype_name]
    rng = np.random.default_rng(0)
    for n in (1, 3, 4):
        a, b = _rand_complex(rng, 1 << n), _rand_complex(rng, 1 << n)
        ja, jb = jnp.asarray(a, dtype=jd), jnp.asarray(b, dtype=jd)
        ta, tb = torch.tensor(a, dtype=td), torch.tensor(b, dtype=td)
        _close(P.pure_dm_vec(ta, n), J.pure_dm_vec(ja, n), tol)
        _close(P.op_vec(ta, tb, n), J.op_vec(ja, jb, n), tol)
        vec = _rand_complex(rng, 4 ** n)
        _close(P.dm_vec_to_matrix(torch.tensor(vec, dtype=td), n),
               J.dm_vec_to_matrix(jnp.asarray(vec, dtype=jd), n), tol)
        _close(P.dm_vec_to_matrix(P.op_vec(ta, tb, n), n),
               np.outer(a, np.conj(b)), 100 * tol)
        _close(P.diag_mask_dm(ta, n), J.diag_mask_dm(ja, n), tol)
        for codes in ([0] * n, [1, 2, 3, 0][:n], [3, 1, 2, 2][:n],
                      [2] * n):
            _close(P.pauli_weight_vector(codes, n, dtype=td),
                   J.pauli_weight_vector(codes, n, dtype=jd), 0)
        _close(P.trace_weight_vector(n, dtype=td),
               J.trace_weight_vector(n, dtype=jd), 0)
        top = (1 << n) - 1
        for row, col in ((0, 0), (1, top), (5 & top, 2 & top)):
            assert (P._interleave_bits(row, col, n)
                    == J._interleave_bits(row, col, n))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_superoperators_match_reference(dtype_name):
    """unitary_site_op, depolarizing_site_op, apply_uniform_site_layer
    (groups of 1, 3 and 4 digits, an untouched ancilla digit, a batch
    axis), apply_site_op, two_qubit_superop and apply_two_site_op with the
    high site first and second, on a non-unitary block too."""
    jd, td, tol = DTYPES[dtype_name]
    rng = np.random.default_rng(1)
    u = np.asarray(j_slot_unitary(0.7, 0.3, jnp.complex128))
    _close(P.unitary_site_op(torch.tensor(u)),
           J.unitary_site_op(jnp.asarray(u)), 1e-15)
    for p in (0.0, 0.05, 0.3):
        _close(P.depolarizing_site_op(p, dtype=td),
               J.depolarizing_site_op(p, dtype=jd), 0)
    m4 = _rand_complex(rng, (4, 4))
    n = 5
    vec = _rand_complex(rng, (2, 4 ** n))
    jm, tm = jnp.asarray(m4, dtype=jd), torch.tensor(m4, dtype=td)
    jv, tv = jnp.asarray(vec, dtype=jd), torch.tensor(vec, dtype=td)
    for n_sites, group in ((5, 3), (4, 3), (5, 1), (5, 4)):
        _close(P.apply_uniform_site_layer(tv, tm, n_sites, group=group),
               J.apply_uniform_site_layer(jv, jm, n_sites, group=group),
               100 * tol)
    for q in (0, 2, 4):
        _close(P.apply_site_op(tv, tm, q), J.apply_site_op(jv, jm, q),
               10 * tol)
    cx = np.eye(4)[[0, 1, 3, 2]]
    for block in (cx, _rand_complex(rng, (4, 4))):
        s16 = P.two_qubit_superop(block)
        np.testing.assert_allclose(s16, J.two_qubit_superop(block), atol=0)
        for s1, s2 in ((3, 1), (1, 3), (4, 0), (0, 2)):
            _close(P.apply_two_site_op(tv, torch.tensor(s16, dtype=td), s1,
                                       s2),
                   J.apply_two_site_op(jv, jnp.asarray(s16, dtype=jd), s1,
                                       s2), 100 * tol)
    with pytest.raises(ValueError):
        P.apply_two_site_op(tv, torch.tensor(s16, dtype=td), 2, 2)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_gates_match_reference(dtype_name):
    """apply_1q, apply_2q (q1 > q2, q1 < q2, adjacent and apart, a
    non-unitary block), apply_diag and apply_gate_layer on a batch of
    states."""
    jd, td, tol = DTYPES[dtype_name]
    rng = np.random.default_rng(2)
    n = 5
    st = _rand_complex(rng, (3, 1 << n))
    js, ts = jnp.asarray(st, dtype=jd), torch.tensor(st, dtype=td)
    u2 = _rand_complex(rng, (2, 2))
    for q in range(n):
        _close(gates.apply_1q(ts, torch.tensor(u2, dtype=td), q, n),
               j_gates.apply_1q(js, jnp.asarray(u2, dtype=jd), q, n), tol)
    u4 = _rand_complex(rng, (4, 4))
    for q1, q2 in ((3, 1), (1, 3), (4, 3), (0, 4), (2, 0)):
        _close(gates.apply_2q(ts, torch.tensor(u4, dtype=td), q1, q2, n),
               j_gates.apply_2q(js, jnp.asarray(u4, dtype=jd), q1, q2, n),
               10 * tol)
    with pytest.raises(ValueError):
        gates.apply_2q(ts, torch.tensor(u4, dtype=td), 2, 2, n)
    d = _rand_complex(rng, 1 << n)
    _close(gates.apply_diag(ts, torch.tensor(d, dtype=td)),
           j_gates.apply_diag(js, jnp.asarray(d, dtype=jd)), tol)
    layer = [(_rand_complex(rng, (2, 2)), q) for q in (0, 3, 3, 1)]
    _close(gates.apply_gate_layer(
        ts, [(torch.tensor(u, dtype=td), q) for u, q in layer], n),
        j_gates.apply_gate_layer(
            js, [(jnp.asarray(u, dtype=jd), q) for u, q in layer], n),
        10 * tol)


def _fold_uniforms(key, n_keys, K, L):
    """(n_keys, K, L): uniform(fold_in(split(key, n_keys)[i], k), (L,))."""
    keys = jax.random.split(key, n_keys)
    return np.stack([[np.asarray(jax.random.uniform(
        jax.random.fold_in(k, j), (L,), dtype=jnp.float32))
        for j in range(K)] for k in keys])


@pytest.mark.parametrize("L,pol,p", [(5, "x", 0.3), (4, "xy", 0.3),
                                     (6, "y", 0.0)])
def test_autocorr_forward_and_echo_match_reference(L, pol, p):
    """The branch-pair autocorrelator on the reference's own draws."""
    hs, phis, ang = _case(L, pol)
    T, K, q = 6, ang.shape[1], 2
    key = jax.random.PRNGKey(L)
    jdiag = j_evolve.make_floquet_params(jnp.asarray(hs), jnp.asarray(phis),
                                         L)
    tdiag = evolve.make_floquet_params(torch.tensor(hs), torch.tensor(phis),
                                       L)
    jpsi, tpsi = j_psi0(L, "vacuum"), initial_statevector(L, "vacuum")
    kw = dict(L=L, T=T, K=K, p=p, q=q, ancilla_factor=0.8)
    want = j_evolve.autocorr_forward(jpsi, jnp.asarray(ang), jdiag, key, **kw)
    got = evolve.autocorr_forward(
        tpsi, torch.tensor(ang), tdiag,
        torch.tensor(_fold_uniforms(key, T, K, L)), **kw)
    _close(got, want, 1e-5)
    u_echo = torch.tensor(_fold_uniforms(key, 2 * T, K, L))
    for t in (0, 1, 4, T):
        want = j_evolve.autocorr_echo(jpsi, jnp.asarray(ang), jdiag, key,
                                      jnp.asarray(t), **kw)
        got = evolve.autocorr_echo(tpsi, torch.tensor(ang), tdiag, u_echo, t,
                                   **kw)
        _close(got, want, 1e-5)
    # without uniforms: a seeded generator's draws, the same each call
    a = evolve.autocorr_forward(tpsi, torch.tensor(ang), tdiag, **kw, seed=3)
    b = evolve.autocorr_forward(tpsi, torch.tensor(ang), tdiag, **kw, seed=3)
    assert torch.equal(a, b) and abs(float(a[0]) - 0.8) <= 1e-6


@pytest.mark.parametrize("p", [0.05, 0.0])
def test_run_autocorr_exact_matches_reference(p, tmp_path):
    """run_autocorr(method="exact") at L=4, T=6, inst=2 in complex128: the
    CSV's name and header byte for byte, the values within 1e-10; at p=0
    the echo is exactly 1."""
    hs, phis = generate_disorder(4, 2, seed=9)
    kw = dict(L=4, tf=6, inst=2, noise_prob=0.05, use_noise=int(p > 0),
              dtype="complex128")
    ref = j_run_autocorr(SimConfig(**kw), hs, phis, method="exact",
                         out_dir=str(tmp_path / "jax"))
    got = run_autocorr(PortConfig(**kw), hs, phis, method="exact",
                       device="cpu", out_dir=str(tmp_path / "torch"))
    assert (os.path.basename(got["csv_path"])
            == os.path.basename(ref["csv_path"]))
    with open(got["csv_path"], "rb") as f, open(ref["csv_path"], "rb") as g:
        assert f.readline() == g.readline()
    for k in ("av_autocorr", "av_autocorr_echo", "sqrt_av_autocorr_echo"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-10, rtol=0)
    if p == 0:
        assert np.array_equal(got["av_autocorr_echo"], np.ones(6))


def test_cli_method_exact_writes_the_reference_csv(tmp_path, capsys):
    """``autocorr --device cpu --method exact`` writes the CSV of
    run_autocorr(method="exact") on the same disorder."""
    argv = ["autocorr", "--device", "cpu", "--method", "exact", "--L", "4",
            "--tf", "5", "--inst", "2", "--out_dir", str(tmp_path / "cli"),
            "--disorder_dir", str(tmp_path)]
    assert cli_main(argv) == 0
    path = capsys.readouterr().out.split("wrote ")[-1].strip()
    r = run_autocorr(PortConfig(L=4, tf=5, inst=2), method="exact",
                     device="cpu", disorder_dir=str(tmp_path), write=False)
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    np.testing.assert_allclose([float(r_[1]) for r_ in rows],
                               r["av_autocorr"], atol=1e-7, rtol=0)
