"""No chunk helper sizes a kernel launch past the kernels' grid limit.

Every CUDA entry takes at most ``resident_blocked.MAX_LAUNCH`` (65535)
trajectories or pairs a launch, the grid's y dimension, and
``routes.KERNEL_STATE_BYTES`` of live states. The helpers that size the
launches must keep both at every L from 1 to 30: ``kernel_chunks`` with
the arguments of each caller (the forward and echo sweeps, the device
sweeps, the adaptive batches; t values x states for the echoes), the
energy ``obs`` chunk, the planar forward's chunk (one K11 launch a cycle
holds inst x chunk states) and the sharded cycle-kernel engines'
``_launch_traj``. On the CPU the plain versions take any batch, so only
these helpers can show it here; ``tests/test_torch_kernels_cuda.py`` runs
65536 pairs and 65536 planar states through the kernels on a card.
"""

import pytest

from dtc_tpu_torch.experiments import engine
from dtc_tpu_torch.experiments.energy import obs_chunk
from dtc_tpu_torch.ops import routes
from dtc_tpu_torch.ops.resident_blocked import MAX_LAUNCH, batch_size
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.parallel.mesh import make_mesh

LS = range(1, 31)
COUNTS = [1, 7, 512, 40000, 65535, 65536, 100000, 1 << 20]


def _state_bytes(L):
    return 8 << L


@pytest.mark.parametrize("L", LS)
def test_kernel_chunks_stay_within_a_launch(L):
    """(inst, trajectories, t values) per launch, as forward_sweep (1 t),
    echo_sweep (t_chunk 8), the device sweeps (one instance) and the
    adaptive batches (all of a call's ts) ask for them."""
    for inst in (1, 2, 16, 70000):
        for n in COUNTS:
            for n_ts in (1, 8, 50, 512):
                ic, c, ts = routes.kernel_chunks(inst, n, n_ts, L)
                assert ic >= 1 and c >= 1 and ts >= 1
                items = ic * c * ts
                assert items <= MAX_LAUNCH, (inst, n, n_ts, ic, c, ts)
                assert (items == 1
                        or items * _state_bytes(L)
                        <= routes.KERNEL_STATE_BYTES)


@pytest.mark.parametrize("L", LS)
def test_obs_and_planar_chunks_stay_within_a_launch(L):
    """The observables launch holds inst x chunk states, the planar
    forward's K11 launch inst x chunk (16 bytes an amplitude with the
    matmul temporaries)."""
    for inst in (1, 2, 3, 16):
        for n in COUNTS:
            c = obs_chunk(n, L, inst)
            assert 1 <= c <= n and inst * c <= max(inst, MAX_LAUNCH)
            assert c == 1 or inst * c * _state_bytes(L) <= (
                routes.KERNEL_STATE_BYTES)
            c = engine.planar_chunk(n, L, inst)
            assert 1 <= c <= n and inst * c <= max(inst, MAX_LAUNCH)
            assert c == 1 or 2 * inst * c * _state_bytes(L) <= (
                routes.KERNEL_STATE_BYTES)


@pytest.mark.parametrize("n_amp,n_traj,cards", [
    (1, 1, 1), (2, 1, 1), (2, 4, 8), (4, 1, 4), (4, 2, 1), (8, 1, 8)])
def test_sharded_launches_stay_within_a_launch(n_amp, n_traj, cards):
    """At every L_loc the cycle kernels run (17..30), a run's trajectories
    stay within the grid limit and, but for one trajectory, within the
    byte budget on the card that holds most of its shards (logical devices
    laid round-robin over ``cards``; only their identity is read)."""
    mesh = make_mesh(n_amp, n_traj, devices=[
        f"cuda:{i % cards}" for i in range(n_amp * n_traj)])
    per_device = max(sum(mesh.device(t, a) == mesh.device(t, b)
                         for b in range(n_amp))
                     for t in range(n_traj) for a in range(n_amp))
    for local_bits in range(17, 31):
        c = sh._launch_traj(mesh, local_bits)
        assert 1 <= c <= 4096 < MAX_LAUNCH
        assert c == 1 or 2 * c * per_device * _state_bytes(local_bits) <= (
            routes.KERNEL_STATE_BYTES)


def test_the_cases_of_f1():
    """The four launches the helpers used to size past 65535: an echo of
    16 instances x 512 trajectories x 8 t values at L=14, a forward of
    65536 trajectories at L=14, energy at L=14 with 2 instances x 40000
    trajectories, and the planar forward at L=10 with 100000."""
    ic, c, ts = routes.kernel_chunks(16, 512, 8, 14)
    assert ic * c * ts <= MAX_LAUNCH and ts == 8
    ic, c, ts = routes.kernel_chunks(1, 65536, 1, 14)
    assert ic * c * ts == MAX_LAUNCH
    assert 2 * obs_chunk(40000, 14, 2) <= MAX_LAUNCH
    assert engine.planar_chunk(100000, 10, 1) == MAX_LAUNCH
    assert batch_size((MAX_LAUNCH,), "echo") == MAX_LAUNCH
    with pytest.raises(ValueError, match="65535"):
        batch_size((MAX_LAUNCH + 1,), "echo")
