"""The kernel choice: which route serves a sweep's shape, what each kernel
route calls, and how many states one launch holds.

``engine_for`` routes by shape, as the reference does, with the port's own
tiers:
- an x drive (K = 1, no y angle) in complex64: ``resident`` (K3a/K3b,
  ``ops/resident.py``) at 14 <= L <= 16 when it is constant (one angle for
  every cycle) and at 14 <= L <= 21 when it is per-cycle (the adaptive-g
  schedules), the reference's K3 range;
- a constant x drive: ``blocked`` (K1/K2, ``ops/resident_blocked.py``) at
  17 <= L <= 23 and ``streamed`` (the large-L x family, ``ops/streamed.py``)
  at 24 <= L <= 30;
- every other drive (y, xy, yx, circular, xy-cycle, per-cycle x at
  22 <= L) in complex64: ``general`` (K4, ``ops/resident_general.py``) at
  14 <= L <= 23 and ``general_hi`` (K10a/K10b, ``ops/cycle_hi_general.py``)
  at 24 <= L <= 29;
- everything else: ``sigma``, the sigma-frame engine, among it every non-x
  drive at L=30 and complex128, as in the reference, whose single-chip
  general route stops at L=29 and complex64; under ``engine="planar"`` a
  constant x drive's forward takes ``planar``.
On CPU tensors every entry runs its plain version.

``ROUTES`` names each kernel route's forward and echo feeders and entries
and the form in which the entries take the kick: the x routes read the
rows of ``ops/params.py`` and take the schedule with ``time_dependent``
(``resident``) or the constant angle theta (``blocked``, ``streamed``);
the lab-frame routes read the rows of ``ops/params_general.py``, which
carry each step's U, and take no kick. ``sweep_route`` routes a sweep
once, from one host copy of its schedule.

Feeders, entries and range constants are looked up on their modules at call
time, so a patch of any of them reaches every sweep.
"""

from __future__ import annotations

from typing import NamedTuple

from dtc_tpu_torch.ops import (
    cycle_hi_general,
    params,
    params_general,
    resident,
    resident_blocked,
    resident_general,
    streamed,
)

# Live states per launch on the kernel routes. The CUDA kernels hold
# every state of a launch in device memory at once (8 MiB per trajectory or
# echo pair at L=20, 64 MiB at L=23, 8 GiB at L=30), unlike the TPU kernels,
# which hold one per grid step. 8 GiB is a tenth of an 80 GB card: 1024
# trajectories at L=20, 128 at L=23, one at L=30, and room left for the
# plain route's angle tables.
KERNEL_STATE_BYTES = 8 << 30


def launch_states(L: int, state_bytes: int = 8) -> int:
    """States of 2^L amplitudes, ``state_bytes`` each with their
    temporaries, that one kernel launch may hold: within KERNEL_STATE_BYTES
    and at most ``resident_blocked.MAX_LAUNCH``, the kernels' grid limit;
    at least one."""
    return max(1, min(resident_blocked.MAX_LAUNCH,
                      KERNEL_STATE_BYTES // (state_bytes << L)))


def kernel_chunks(inst: int, n_traj: int, n_ts: int, L: int):
    """(instances, trajectories, t values) per kernel launch: at most
    ``launch_states(L)`` states (t values x states for the echoes), at
    least one of each; the t values are kept together first, then the
    instances, then the trajectories."""
    states = launch_states(L)
    ts = min(n_ts, states)
    ic = min(inst, states // ts)
    return ic, min(n_traj, states // (ts * ic)), ts


class Route(NamedTuple):
    """A kernel route: its feeders on ``feeds`` and entries on ``entries``,
    by name (forward, echo), and the form of its entries' kick."""

    feeds: object
    feed_names: tuple[str, str]
    entries: object
    entry_names: tuple[str, str]
    kick: str  # "schedule", "theta" or "rows"

    def feeder(self, echo: bool):
        return getattr(self.feeds, self.feed_names[echo])

    def entry(self, echo: bool):
        return getattr(self.entries, self.entry_names[echo])

    def x_entry(self, echo: bool, rows, sig, angles, theta, **kw):
        """The x entry on ``rows`` and ``sig`` with the kick in its form:
        theta, or the schedule (per-cycle where theta is None)."""
        if self.kick == "theta":
            return self.entry(echo)(rows, sig, theta, **kw)
        return self.entry(echo)(rows, sig, angles,
                                time_dependent=theta is None, **kw)


_X_FEEDS = (params, ("forward_rows", "echo_pair_tiles"))
_LAB_FEEDS = (params_general, ("general_forward_rows", "general_echo_rows"))

ROUTES = {
    "resident": Route(*_X_FEEDS, resident,
                      ("resident_forward_batch", "resident_echo_batch"),
                      "schedule"),
    "blocked": Route(*_X_FEEDS, resident_blocked,
                     ("blocked_forward_batch", "blocked_echo_batch"),
                     "theta"),
    "streamed": Route(*_X_FEEDS, streamed,
                      ("streamed_forward_batch", "streamed_echo_batch"),
                      "theta"),
    "general": Route(*_LAB_FEEDS, resident_general,
                     ("general_forward_batch", "general_echo_batch"),
                     "rows"),
    "general_hi": Route(*_LAB_FEEDS, cycle_hi_general,
                        ("general_hi_forward_batch", "general_hi_echo_batch"),
                        "rows"),
}


def x_route(route: str) -> bool:
    """Whether ``route`` is a kernel route of the x family (x rows)."""
    return route in ROUTES and ROUTES[route].kick != "rows"


def x_schedule(angles) -> bool:
    """Whether the schedule kicks about x only: K = 1 and no y angle."""
    ang = angles.detach().cpu()
    return ang.shape[1] == 1 and not bool((ang[:, :, 1] != 0).any())


def constant_x_theta(angles) -> float | None:
    """The kick angle of a constant x-drive schedule, else None."""
    if not x_schedule(angles):
        return None
    ang = angles.detach().cpu()
    if not bool((ang == ang[0]).all()):
        return None
    return float(ang[0, 0, 0])


def engine_for(angles, *, L, T, q, dtype_name, has_y, echo: bool,
               engine: str = "auto") -> str:
    """'resident' (x kernels K3a/K3b or their plain versions), 'blocked'
    (K1/K2 or their plain versions), 'streamed' (the large-L x family or its
    plain versions), 'general' (the lab-frame kernel K4 or its plain
    versions), 'general_hi' (the large-L lab-frame family or its plain
    versions) or 'sigma'; under ``engine="planar"`` 'planar' (a constant x
    drive's forward, any L and dtype: the planar engine computes in f32
    planes) or 'sigma'."""
    x_only = not has_y and x_schedule(angles)
    const_x = x_only and constant_x_theta(angles) is not None
    if engine == "planar":
        return ("planar" if const_x and not echo and 0 <= q < L
                else "sigma")
    if dtype_name != "complex64" or not 0 <= q < L:
        return "sigma"
    if x_only:
        # constant x: K3 below K1's range; per-cycle x: K3's whole range
        top = resident_blocked.MIN_L - 1 if const_x else resident.MAX_L
        t_max = resident.MAX_T_ECHO if echo else resident.MAX_T_FORWARD
        if resident.MIN_L <= L <= top and T <= t_max:
            return "resident"
    if const_x:
        for name, mod in (("blocked", resident_blocked),
                          ("streamed", streamed)):
            t_max = mod.MAX_T_ECHO if echo else mod.MAX_T_FORWARD
            if mod.MIN_L <= L <= mod.MAX_L and T <= t_max:
                return name
    if const_x:
        return "sigma"
    steps = (2 if echo else 1) * T * angles.shape[1]
    for name, lo, mod in (
            ("general", resident_general.MIN_L, resident_general),
            ("general_hi", cycle_hi_general.MIN_ROUTE_L, cycle_hi_general)):
        if lo <= L <= mod.MAX_L and steps <= mod.MAX_STEPS:
            return name
    return "sigma"


def sweep_route(angles, *, echo: bool, **shape) -> tuple[str, float | None]:
    """(``engine_for``'s route, ``constant_x_theta``) of a sweep's schedule,
    both read from one host copy of it; ``shape`` is ``engine_for``'s
    other keywords."""
    host = angles.detach().cpu()
    return engine_for(host, echo=echo, **shape), constant_x_theta(host)
