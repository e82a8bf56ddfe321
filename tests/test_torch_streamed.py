"""Streamed x-drive entries (the large-L CUDA family and its plain versions).

On the CPU the entries run the plain versions, which are held against the
JAX package's HBM-streamed kernels in interpret mode (K6a/K6b
``pallas_streamed.py``, K7a/K7b ``pallas_streamed_hi.py``) and against its
sigma engine, fed the same uniforms (drawn in JAX, passed as numpy): 1e-4,
the reference's own bound for its interpret kernels against the sigma
engine. The cases are the JAX suite's (``tests/test_kernel_interpret_parity
.py``): L=22, T=2, p=0.6, q=11, ts [1, 2], and the row probes q=17 and q=21.
The kernels themselves are compared with these plain versions on the card
by ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core.sigma_evolve import presample_noise as j_presample
from dtc_tpu.core.sigma_evolve import sigma_echo_batch as j_sigma_echo
from dtc_tpu.core.sigma_evolve import sigma_forward_batch as j_sigma_forward
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops import pallas_streamed, pallas_streamed_hi
from dtc_tpu.ops.pallas_noise import pack_cycle_params_compact as j_pack
from dtc_tpu.ops.pallas_resident import echo_pair_tiles as j_tiles
from dtc_tpu_torch.experiments.autocorr import run_autocorr
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import routes
from dtc_tpu_torch.ops import streamed as sm
from dtc_tpu_torch.ops.params import (
    echo_pair_tiles,
    echo_width,
    forward_rows,
    forward_width,
)
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig

torch.set_num_threads(2)

L = 22
THETA = 0.97 * np.pi
KERNELS = {
    ("forward", "streamed"): pallas_streamed.streamed_forward_batch,
    ("forward", "streamed_hi"): pallas_streamed_hi.streamed_hi_forward_batch,
    ("echo", "streamed"): pallas_streamed.streamed_echo_batch,
    ("echo", "streamed_hi"): pallas_streamed_hi.streamed_hi_echo_batch,
}


def _setup(T):
    """The JAX suite's inputs: disorder seed 7, one trajectory of key 9."""
    hs, phis = generate_disorder(L, 1, seed=7)
    keys = jax.random.split(jax.random.PRNGKey(9), 1)[None]
    jargs = (jnp.asarray(hs[:, :L]), jnp.asarray(phis[:, :L - 1]),
             j_sched("x", 0.97, T).angles, keys)
    return (torch.as_tensor(hs[:, :L]), torch.as_tensor(phis[:, :L - 1]),
            jargs)


def _uniforms(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys)))


def _port(kind, T, p, q, ts, hs, phis, keys):
    if kind == "forward":
        rows, sig = forward_rows(_uniforms(keys, (T, L)), hs[:, None],
                                 phis[:, None], L=L, T=T, p=p)
        return sm.streamed_forward_batch(rows, sig, THETA, L=L, q=q).numpy()
    tiles, sig = echo_pair_tiles(_uniforms(keys, (2 * T, L)), torch.tensor(ts),
                                 hs[:, None], phis[:, None], L=L, T=T, p=p)
    return sm.streamed_echo_batch(tiles, sig, THETA, L=L, q=q).numpy()


@pytest.mark.parametrize("kind,maker,q", [
    ("forward", "streamed", 11), ("forward", "streamed_hi", 11),
    ("echo", "streamed", 11), ("echo", "streamed_hi", 11),
    ("forward", "streamed", 17), ("forward", "streamed_hi", 17),
    ("forward", "streamed_hi", 21), ("echo", "streamed", 17),
    ("echo", "streamed_hi", 17)])
def test_plain_matches_reference_interpret(kind, maker, q):
    """Each of K6a, K7a, K6b, K7b at L=22, T=2, p=0.6 in interpret mode
    against the plain entry: the probe in the low band (q=11) and in the
    row bands above bit 13 (q=17, and q=21 on the hi kernel)."""
    T, p, ts = 2, 0.6, [1, 2]
    hs, phis, jargs = _setup(T)
    extra = (jnp.asarray(ts),) if kind == "echo" else ()
    ref = np.asarray(KERNELS[kind, maker](*jargs, *extra, L=L, T=T, p=p, q=q,
                                          interpret=True))
    got = _port(kind, T, p, q, ts, hs, phis, jargs[3])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("q", [11, 17, 21])
def test_plain_matches_reference_sigma_engine(q):
    """Against JAX's sigma engine at T=3, where A(2) depends on q; the
    echo at ts [1, 2]."""
    T, p, ts = 3, 0.6, [1, 2]
    hs, phis, jargs = _setup(T)
    kw = dict(L=L, T=T, K=1, p=p, q=q, has_y=False, initial_state="vacuum",
              dtype_name="complex64", ancilla_factor=1.0)
    ref_f = np.asarray(j_sigma_forward(*jargs, **kw))
    ref_e = np.asarray(j_sigma_echo(*jargs, jnp.asarray(ts), **kw))
    got_f = _port("forward", T, p, q, ts, hs, phis, jargs[3])
    got_e = _port("echo", T, p, q, ts, hs, phis, jargs[3])
    np.testing.assert_allclose(got_f, ref_f, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_e, ref_e, atol=1e-4, rtol=0)
    assert np.abs(ref_e - 1.0).max() > 1e-5  # sampled events moved it


@pytest.mark.parametrize("Lw", [26, 27, 30])
def test_wide_rows_bit_identical(Lw):
    """Rows and echo step tiles at the width the rule gives equal JAX's at
    that width bit for bit: 256 lanes for the echo at L = 26, 27, 30 and
    for the forward at L = 27, 30 (128 at L=26)."""
    T, p = 3, 0.6
    fw, ew = forward_width(Lw), echo_width(Lw)
    assert (fw, ew) == ((128 if Lw == 26 else 256), 256)
    rng = np.random.default_rng(Lw)
    hs, phis = rng.standard_normal(Lw), rng.standard_normal(Lw - 1)
    key = jax.random.PRNGKey(Lw)
    _, zm, _, csum = j_presample(key, p, T, Lw)
    ref = np.asarray(jax.vmap(lambda z, s: j_pack(
        z, s, jnp.asarray(hs), jnp.asarray(phis), Lw, width=fw))(zm, csum))
    u = np.asarray(jax.random.uniform(key, (T, Lw), dtype=jnp.float32))
    rows, sig = forward_rows(torch.from_numpy(u.copy()), torch.from_numpy(hs),
                             torch.from_numpy(phis), L=Lw, T=T, p=p)
    np.testing.assert_array_equal(rows.numpy(), ref)
    np.testing.assert_array_equal(sig.numpy(), np.asarray(csum))
    ue = np.asarray(jax.random.uniform(key, (2 * T, 1, Lw),
                                       dtype=jnp.float32))[:, 0]
    ts = [0, 1, 3]
    tiles, sfin = echo_pair_tiles(torch.from_numpy(ue.copy()), torch.tensor(ts),
                                  torch.from_numpy(hs), torch.from_numpy(phis),
                                  L=Lw, T=T, p=p, batch=())
    for i, t in enumerate(ts):
        rt, rs = j_tiles(key, jnp.asarray(t), jnp.asarray(hs),
                         jnp.asarray(phis), L=Lw, T=T, p=p, width=ew)
        np.testing.assert_array_equal(tiles[i].numpy(), np.asarray(rt))
        assert int(sfin[i]) == int(rs)


def test_row_width_rule():
    """The reference's rule: forward 128 lanes while 5L-2 <= 128, echo
    while 5L-2 <= 124 (the 4 flag lanes), else 256; 128 wide rows at
    L <= 25 keep their old layout."""
    for n in range(2, 31):
        assert forward_width(n) == (128 if 5 * n - 2 <= 128 else 256)
        assert echo_width(n) == (128 if 5 * n - 2 <= 124 else 256)
    hs, phis = torch.zeros((25,)), torch.zeros((24,))
    rows, _ = forward_rows(None, hs, phis, L=25, T=2, p=0.0, batch=())
    tiles, _ = echo_pair_tiles(None, [1], hs, phis, L=25, T=2, p=0.0,
                               batch=())
    assert rows.shape[-1] == 128 and tiles.shape[-1] == 128
    assert tiles[0, 0, 124] == 2.0  # trip count 2t at lane width-4


def test_entries_reject_out_of_range():
    sig = torch.zeros((1, 3), dtype=torch.int64)
    for Lr, q, width in ((21, 3, 128), (31, 3, 256), (24, 24, 128),
                         (27, 3, 128), (24, 3, 192)):
        with pytest.raises(ValueError):
            sm.streamed_forward_batch(torch.zeros((1, 3, width)), sig, THETA,
                                      L=Lr, q=q)
    with pytest.raises(ValueError):
        sm.streamed_forward_batch(torch.zeros((1, 1025, 128)),
                                  torch.zeros((1, 1025), dtype=torch.int64),
                                  THETA, L=22, q=3)
    with pytest.raises(ValueError):  # L=26 echo rows need 256 lanes
        sm.streamed_echo_batch(torch.zeros((1, 8, 128)),
                               torch.zeros((1,), dtype=torch.int64), THETA,
                               L=26, q=3)
    with pytest.raises(ValueError):
        sm.streamed_echo_batch(torch.zeros((1, 4 * 513, 256)),
                               torch.zeros((1,), dtype=torch.int64), THETA,
                               L=26, q=3)
    with pytest.raises(ValueError):  # neither CPU (plain) nor CUDA (kernel)
        sm.streamed_forward_batch(torch.zeros((1, 3, 128), device="meta"),
                                  sig, THETA, L=22, q=3)


def test_wrapper_routes_cpu_to_plain_version():
    hs, phis = torch.zeros((1, L)), torch.full((1, L - 1), -math.pi)
    rows, sig = forward_rows(None, hs[:, None], phis[:, None], L=L, T=2,
                             p=0.0, batch=(1, 1))
    profiling.reset_counters()
    a = sm.streamed_forward_batch(rows, sig, THETA, L=L, q=0)
    b = sm.streamed_forward_batch_ref(rows, sig, THETA, L=L, q=0)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a[0, 0, 1], math.cos(THETA), atol=1e-6)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA


@pytest.mark.parametrize("Lr", [24, 26, 28, 30])
def test_engine_routes_large_x_to_streamed(Lr):
    """A constant x drive in complex64 at 24 <= L <= 30 takes the streamed
    route, with autocorr's default probe q = L//2 too; complex128 and T past
    the kernels' limits stay on the sigma engine, and other drives take the
    streamed lab-frame route to L=29 (the sigma engine at L=30)."""
    q = SimConfig(L=Lr).probe_qubit
    x = build_kick_schedule("x", 0.97, 6).angles
    kw = dict(L=Lr, T=6, q=q, has_y=False)
    for echo in (False, True):
        assert routes.engine_for(x, dtype_name="complex64", echo=echo,
                                 **kw) == "streamed"
        assert routes.engine_for(x, dtype_name="complex128", echo=echo,
                                 **kw) == "sigma"
    y = build_kick_schedule("y", 0.97, 6).angles
    assert routes.engine_for(y, dtype_name="complex64", echo=False,
                             **{**kw, "has_y": True}) == (
        "sigma" if Lr == 30 else "general_hi")
    long_x = build_kick_schedule("x", 0.97, 513).angles
    assert routes.engine_for(long_x, L=Lr, T=513, q=q, has_y=False,
                             dtype_name="complex64", echo=True) == "sigma"
    assert routes.engine_for(x, L=23, T=6, q=11, has_y=False,
                             dtype_name="complex64", echo=False) == "blocked"


@pytest.mark.parametrize("inst,n_traj,n_ts,Lr,want", [
    (2, 32, 8, 20, (2, 32, 8)), (2, 32, 1, 23, (2, 32, 1)),
    (2, 4, 8, 28, (1, 1, 4)), (2, 4, 1, 28, (2, 2, 1)),
    (2, 1, 8, 30, (1, 1, 1))])
def test_kernel_chunks_hold_the_budget(inst, n_traj, n_ts, Lr, want):
    got = routes.kernel_chunks(inst, n_traj, n_ts, Lr)
    assert got == want
    assert math.prod(got) * (8 << Lr) <= max(routes.KERNEL_STATE_BYTES,
                                             8 << Lr)


def test_sweep_split_to_one_state_equals_unsplit(monkeypatch):
    """At L=22 through the streamed route, a sweep whose state budget holds
    one state splits instances, trajectories and t values into one-state
    launches and gives the numbers of the unsplit sweep."""
    monkeypatch.setattr(rb, "MAX_L", 21)  # L=22 takes the streamed route
    cfg = SimConfig(L=L, tf=2, inst=2, n_trajectories=2, noise_prob=0.3)
    sizes = []
    for name in ("streamed_forward_batch", "streamed_echo_batch"):
        fn = getattr(sm, name)

        def counted(x, *a, _fn=fn, **k):
            sizes.append(math.prod(x.shape[:-2]))
            return _fn(x, *a, **k)

        monkeypatch.setattr(sm, name, counted)
    whole = run_autocorr(cfg, device="cpu", write=False)
    assert max(sizes) == 8  # the echo's 2 instances x 2 trajectories x 2 t
    sizes.clear()
    monkeypatch.setattr(routes, "KERNEL_STATE_BYTES", 8 << L)
    split = run_autocorr(cfg, device="cpu", write=False)
    assert max(sizes) == 1 and len(sizes) == 4 + 2 * 4
    for k in ("autocorr_per_instance", "echo_per_instance"):
        np.testing.assert_allclose(split[k], whole[k], atol=1e-6, rtol=0)
    assert whole["autocorr_per_instance"][0, 0] == pytest.approx(0.7 ** 6)
