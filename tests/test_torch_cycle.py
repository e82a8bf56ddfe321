"""The plain versions of the per-shard cycle kernels K8a-d (``ops/cycle.py``)
against the reference's Pallas kernels (``dtc_tpu/ops/pallas_cycle.py``) in
interpret mode, and against the port's own K1/K2/K4 plain steps.

One cycle at L_loc = 17 on random unit states: the reference's planar
(n, 2, TOP, 16384) f32 state is the port's flat (n, 2^17) complex64 state,
index by index. The rows are the port's (``pack_cycle_params_compact``,
``general_forward_rows``, ``general_echo_rows``), which
``tests/test_torch_params*.py`` hold equal to the reference's. Tolerances:
amplitudes of a unit state at 2^17 are about 3e-3, and f32 sums of a cycle
leave them within 2e-6 (TOL_AMP); partial sums within 1e-5 (TOL_SUM).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.ops import pallas_cycle as jc
from dtc_tpu.ops.pallas_resident import _C, _kick_matrices
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu_torch.core.sigma_evolve import presample_noise
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops.params import forward_rows, pack_cycle_params_compact
from dtc_tpu_torch.ops.params_general import (
    general_echo_rows,
    general_forward_rows,
)

torch.set_num_threads(2)
L = 17
TOP = 1 << (L - 14)
TOL_AMP, TOL_SUM = 2e-6, 1e-5
THETA = float(np.pi * 0.93)


def _disorder():
    hs, phis = generate_disorder(L, 1, seed=9)
    return (torch.as_tensor(hs[0, :L]), torch.as_tensor(phis[0, :L - 1]))


def _states(n, seed=2):
    """(port (n, 2^L) complex64, reference (n, 2, TOP, C) f32) unit states."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, 2, 1 << L)).astype(np.float32)
    s /= np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))
    port = torch.complex(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]))
    return port, jnp.asarray(s.reshape(n, 2, TOP, _C))


def _flat(planar):
    s = np.array(planar).reshape(planar.shape[0], 2, -1)
    return torch.complex(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]))


def _x_rows(n, seed=4):
    """Noisy compact rows (p=0.6) of cycle 1 for n trajectories."""
    hs, phis = _disorder()
    u = torch.rand((n, 2, L), generator=torch.Generator().manual_seed(seed))
    _, zm, _, csum = presample_noise(u, 0.6, L)
    return pack_cycle_params_compact(zm[:, 1], csum[:, 1], hs, phis, L)


def _kicks():
    ang = jnp.asarray(j_sched("x", 0.93, 2).angles)
    return _kick_matrices(ang, L, TOP, time_dependent=False)


def _general_inputs(pol, n, seed=5):
    hs, phis = _disorder()
    sched = build_kick_schedule(pol, 0.97, 2)
    K = sched.K
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 4 * K, L), generator=gen)
    return hs, phis, sched.angles, K, u


@pytest.mark.parametrize("q", [8, 15])
def test_k8a_matches_reference_interpret(q):
    n = 2
    st, jst = _states(n)
    rows = _x_rows(n)
    got, part = cycle.cycle_forward_apply(st, rows, THETA, L=L, q=q)
    want, jpart = jc.cycle_forward_apply(jst, jnp.asarray(rows.numpy()),
                                         *_kicks(), L=L, q=q, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), atol=TOL_SUM)


def test_k8b_matches_reference_interpret():
    n = 2
    st, jst = _states(n, seed=3)
    rows = _x_rows(n, seed=6)
    got = cycle.cycle_inverse_apply(st, rows, THETA, L=L)
    want = jc.cycle_inverse_apply(jst, jnp.asarray(rows.numpy()), *_kicks(),
                                  L=L, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP


@pytest.mark.parametrize("pol,q", [("xy", 8), ("circular_left", 15)])
def test_k8c_matches_reference_interpret(pol, q):
    n = 2
    hs, phis, ang, K, u = _general_inputs(pol, n)
    rows = general_forward_rows(u[:, :2 * K], hs, phis, ang, L=L, T=2, K=K,
                                p=0.6).reshape(n, 2, K, -1)[:, 1]
    st, jst = _states(n, seed=7)
    got, part = cycle.general_cycle_forward_apply(st, rows, L=L, K=K, q=q)
    want, jpart = jc.general_cycle_forward_apply(
        jst, jnp.asarray(rows.numpy()), L=L, K=K, q=q, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), atol=TOL_SUM)


@pytest.mark.parametrize("pol", ["y", "xy"])
def test_k8d_matches_reference_interpret(pol):
    n = 2
    hs, phis, ang, K, u = _general_inputs(pol, n)
    tiles = general_echo_rows(u, [1], hs, phis, ang, L=L, T=2, K=K, p=0.6)
    tiles = tiles.reshape(n, 4, K, 2, -1)[:, 1]            # inverse step 1
    st, jst = _states(n, seed=8)
    got = cycle.general_cycle_inverse_apply(st, tiles, L=L, K=K)
    want = jc.general_cycle_inverse_apply(jst, jnp.asarray(tiles.numpy()),
                                          L=L, K=K, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP


def test_k8b_undoes_k8a_in_the_conjugated_frame():
    """conj(K8b(conj(K8a(s)))) = s on the same row: the inverse applies the
    diagonal before the kick with un-negated angles, (D K)^dag =
    conj(K D)."""
    st, _ = _states(1, seed=9)
    rows = _x_rows(1, seed=10)
    s1, _ = cycle.cycle_forward_apply(st.clone(), rows, THETA, L=L, q=8)
    back = cycle.cycle_inverse_apply(s1.conj().resolve_conj(), rows, THETA,
                                     L=L).conj()
    assert float((back - st).abs().max()) < TOL_AMP


def test_chains_equal_the_whole_state_plain_kernels():
    """With no shard bits (k_bits = 0) a chain of cycles is the unsharded
    kernel: K8a over T cycles gives K1's partials, K8c gives K4's forward,
    K8d run over every step of a pair's echo rows gives K4's echo."""
    T, q, n = 3, 8, 2
    hs, phis = _disorder()
    u = torch.rand((n, T, L), generator=torch.Generator().manual_seed(1))
    rows, sig = forward_rows(u, hs[None], phis[None], L=L, T=T, p=0.6)
    want = rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=q)
    st = rb.basis_states(n, L, 0, "cpu")
    parts = [torch.ones(n)]
    for t in range(T - 1):
        parts.append(cycle.cycle_forward_apply(st, rows[:, t], THETA, L=L,
                                               q=q)[1])
    got = rb.forward_host_factor(torch.stack(parts, 1), sig, q, 0, 1.0)
    torch.testing.assert_close(got, want, atol=TOL_SUM, rtol=0)

    _, _, ang, K, ug = _general_inputs("circular_left", n)
    grows = general_forward_rows(ug[:, :2 * K], hs, phis, ang, L=L, T=2,
                                 K=K, p=0.6)
    want = rg.general_forward_batch_ref(grows, L=L, T=2, q=q)
    st = rb.basis_states(n, L, 0, "cpu")
    a1 = cycle.general_cycle_forward_apply(st, grows[:, :K], L=L, K=K, q=q)[1]
    torch.testing.assert_close(a1, want[:, 1], atol=TOL_SUM, rtol=0)

    tiles = general_echo_rows(ug, [2], hs, phis, ang, L=L, T=2, K=K, p=0.6)
    want = rg.general_echo_batch_ref(tiles, L=L, q=q)[:, 0]
    st = rb.basis_states(n, L, 0, "cpu")
    for k in range(4):
        cycle.general_cycle_inverse_apply(
            st, tiles[:, 0].reshape(n, 4, K, 2, -1)[:, k], L=L, K=K)
    got = (st.real ** 2 + st.imag ** 2) @ rb.angle_table(L, "cpu")[q]
    torch.testing.assert_close(got, want, atol=TOL_SUM, rtol=0)


def test_range_checks_and_cpu_route():
    cycle.reset_counters()
    st = torch.zeros((1, 1 << 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="17 <= L_loc <= 23"):
        cycle.cycle_forward_apply(st, torch.zeros(1, 128), THETA, L=16, q=3)
    st, _ = _states(1)
    with pytest.raises(ValueError, match="shard-local probe"):
        cycle.cycle_forward_apply(st, torch.zeros(1, 128), THETA, L=L, q=L)
    with pytest.raises(ValueError, match="rows must be"):
        cycle.general_cycle_inverse_apply(st, torch.zeros(1, 2, 128), L=L,
                                          K=2)
    cycle.cycle_inverse_apply(st, torch.zeros(1, 128), THETA, L=L)
    assert not any(cycle.LAUNCHES.values())
    assert not any(cycle.PLAIN_ON_CUDA.values())
