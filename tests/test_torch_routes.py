"""The kernel choice in one place (``dtc_tpu_torch/ops/routes.py``), on the
CPU at small L, where every entry runs its plain version.

- A sweep at a shape that a kernel route takes calls that route's feeder
  and entry, and no other route's entry, and gives the values of the
  feeder and entry called directly. The range constants are patched, as
  the split tests of ``test_torch_streamed.py`` and
  ``test_torch_general_hi.py`` patch them, so that the streamed routes
  take L=14.
- A sweep of many launches routes once.
- No module under ``core``, ``ops``, ``parallel``, ``models`` or ``io``
  imports ``dtc_tpu_torch.experiments``.
"""

import ast
import os

import numpy as np
import pytest
import torch

import dtc_tpu_torch
from dtc_tpu_torch.experiments import engine
from dtc_tpu_torch.io.disorder import generate_disorder
from dtc_tpu_torch.models.noise import NoiseSpec
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import params, params_general, routes
from dtc_tpu_torch.ops import resident as rs
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops import streamed as sm
from dtc_tpu_torch.utils.config import SimConfig

torch.set_num_threads(2)

T, N_TRAJ, P = 3, 2, 0.1

# route -> (L, polarization, range patches that send L there)
SHAPES = {
    "resident": (14, "x", []),
    "blocked": (17, "x", []),
    "streamed": (14, "x", [(rs, "MIN_L", 15), (sm, "MIN_L", 14)]),
    "general": (14, "y", []),
    "general_hi": (14, "y", [(rg, "MAX_L", 13), (chg, "MIN_ROUTE_L", 14),
                             (chg, "MIN_L", 14)]),
}

ENTRIES = {
    "resident": (rs, "resident_forward_batch", "resident_echo_batch"),
    "blocked": (rb, "blocked_forward_batch", "blocked_echo_batch"),
    "streamed": (sm, "streamed_forward_batch", "streamed_echo_batch"),
    "general": (rg, "general_forward_batch", "general_echo_batch"),
    "general_hi": (chg, "general_hi_forward_batch", "general_hi_echo_batch"),
}

FEEDS = [(params, "forward_rows"), (params, "echo_pair_tiles"),
         (params_general, "general_forward_rows"),
         (params_general, "general_echo_rows")]


def _setup(route, monkeypatch, **over):
    L, pol, patches = SHAPES[route]
    for mod, name, value in patches:
        monkeypatch.setattr(mod, name, value)
    cfg = SimConfig(**dict(dict(L=L, tf=T, inst=1, n_trajectories=N_TRAJ,
                                noise_prob=P, polarization=pol), **over))
    hs, phis = generate_disorder(L, cfg.inst, seed=5)
    sched, prm, noise = engine.build_context(cfg, hs, phis, device="cpu")
    return cfg, sched, prm, noise


def _spy(monkeypatch, calls):
    """Record, by name, every call of every route's entries and of the four
    feeders."""
    spied = [(mod, name) for mod, *names in ENTRIES.values()
             for name in names] + FEEDS
    for mod, name in spied:
        fn = getattr(mod, name)

        def recorded(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, recorded)


def _direct(route, echo, u, hs, phis, angles, L, q, af):
    """The route's feeder, then its entry, called by hand: x rows with the
    schedule (K3) or theta (K1/K2, the streamed x family), lab-frame rows
    with no kick (K4, K10)."""
    h, ph = hs[:, None], phis[:, None]
    batch = (u.shape[0], u.shape[1])
    ts = torch.arange(T)
    mod, fwd_name, echo_name = ENTRIES[route]
    fn = getattr(mod, echo_name if echo else fwd_name)
    kw = dict(L=L, q=q, initial_state="vacuum", ancilla_factor=af)
    if route in ("general", "general_hi"):
        if echo:
            rows = params_general.general_echo_rows(
                u, ts, h, ph, angles, L=L, T=T, K=1, p=P, batch=batch)
            return fn(rows, **kw)
        rows = params_general.general_forward_rows(
            u, h, ph, angles, L=L, T=T, K=1, p=P, batch=batch)
        return fn(rows, T=T, **kw)
    if echo:
        rows, sig = params.echo_pair_tiles(u, ts, h, ph, L=L, T=T, p=P,
                                           batch=batch)
    else:
        rows, sig = params.forward_rows(u, h, ph, L=L, T=T, p=P, batch=batch)
    kick = angles if route == "resident" else float(angles[0, 0, 0])
    return fn(rows, sig, kick, **kw)


@pytest.mark.parametrize("echo", [False, True], ids=["forward", "echo"])
@pytest.mark.parametrize("route", list(routes.ROUTES))
def test_sweep_calls_the_routes_feeder_and_entry(route, echo, monkeypatch):
    cfg, sched, (hs, phis), noise = _setup(route, monkeypatch)
    L, q = cfg.L, cfg.probe_qubit
    shape = dict(L=L, T=T, q=q, dtype_name="complex64",
                 has_y=cfg.polarization != "x")
    assert routes.engine_for(sched.angles, echo=echo, **shape) == route
    gen = torch.Generator().manual_seed(11)
    u = torch.rand((1, N_TRAJ, (1 + echo) * T, L), generator=gen)
    calls = []
    _spy(monkeypatch, calls)
    sweep = engine.echo_sweep if echo else engine.forward_sweep
    got = sweep(cfg, sched, (hs, phis), noise, uniforms=u.numpy(),
                engine="auto")
    mod, fwd_name, echo_name = ENTRIES[route]
    feeds = (("echo_pair_tiles", "general_echo_rows") if echo
             else ("forward_rows", "general_forward_rows"))
    feed = feeds[route in ("general", "general_hi")]
    assert calls == [feed, echo_name if echo else fwd_name]
    vals = _direct(route, echo, u, hs, phis, sched.angles, L, q,
                   noise.ancilla_factor)
    want = vals.sum(dim=1).numpy().astype(np.float64) / N_TRAJ
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.shape == (1, T) and np.isfinite(got).all()


@pytest.mark.parametrize("echo", [False, True], ids=["forward", "echo"])
def test_a_sweep_of_many_launches_routes_once(echo, monkeypatch):
    """With room for one state a launch, the 2 instances x 2 trajectories
    (x 3 t values for the echo) run in one launch each, and the sweep
    routes once."""
    cfg, sched, prm, noise = _setup("resident", monkeypatch, inst=2)
    monkeypatch.setattr(routes, "KERNEL_STATE_BYTES", 8 << cfg.L)
    routed, calls = [], []
    engine_for = routes.engine_for

    def counted(*a, **k):
        routed.append(k["echo"])
        return engine_for(*a, **k)

    monkeypatch.setattr(routes, "engine_for", counted)
    _spy(monkeypatch, calls)
    (engine.echo_sweep if echo else engine.forward_sweep)(
        cfg, sched, prm, noise, engine="auto")
    entry = "resident_echo_batch" if echo else "resident_forward_batch"
    assert calls.count(entry) == (2 * 2 * T if echo else 2 * 2)
    assert routed == [echo]


@pytest.mark.parametrize("route", list(routes.ROUTES) + ["sigma", "planar"])
def test_x_family(route):
    """The x family (x rows: K3, K1/K2 and the streamed x family) is the
    routes whose entries take the kick; ``sigma`` and ``planar`` are not
    kernel routes."""
    assert routes.x_route(route) == (route in ("resident", "blocked",
                                               "streamed"))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("package", ["core", "ops", "parallel", "models",
                                     "io"])
def test_lower_layers_do_not_import_experiments(package):
    root = os.path.join(os.path.dirname(dtc_tpu_torch.__file__), package)
    found = [(name, mod) for name in sorted(os.listdir(root))
             if name.endswith(".py")
             for mod in _imports(os.path.join(root, name))
             if mod.startswith("dtc_tpu_torch.experiments")]
    assert os.listdir(root) and not found
