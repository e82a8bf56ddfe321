"""A single-controller (traj, amp) device mesh and its collectives.

Port of ``dtc_tpu/parallel/mesh.py`` (``make_mesh``, ``amp_bits``). The
reference is single-controller: one process runs ``shard_map`` over
``jax.devices()``, and its tests run on 8 virtual CPU devices in one
process. The counterpart here is one process that holds a list of torch
devices, in which a device may repeat (as XLA's forced host device count
makes virtual devices): ``--num_devices 4`` lays four logical devices over
one card. Shard (t, a) of the grid lives on ``devices[(t * n_amp + a) %
len(devices)]``.

'traj' splits the trajectories (no exchange but the final sum); 'amp'
splits the 2^L amplitudes by their top log2(n_amp) index bits, shard a
holding global indices [a M, (a+1) M), M = 2^(L - log2(n_amp)). The
collectives the sharded engines need (``parallel/sharded.py``):

- ``axis_index``: each shard's index along an axis;
- ``xor_partners``: ``lax.ppermute`` over the pairs a <-> a ^ 2^bit
  (``_xor_perm``), out of place: every shard's partner is the OLD tensor of
  the other shard, so the caller computes every new shard from the old ones
  before it replaces any. On one device the partner is the same tensor, no
  copy; across cards it is a peer copy;
- ``psum``: a sum over the shards of an axis in shard order (deterministic).
"""

from __future__ import annotations

import torch


class Mesh:
    """Shape {"traj": n_traj, "amp": n_amp} over a list of torch devices."""

    def __init__(self, devices, n_traj: int, n_amp: int):
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"traj": n_traj, "amp": n_amp}

    def device(self, t: int, a: int) -> torch.device:
        """The device of shard (t, a)."""
        return self.devices[(t * self.shape["amp"] + a) % len(self.devices)]

    def axis_index(self, name: str) -> list[int]:
        """Each shard's index along ``name``, in shard order."""
        return list(range(self.shape[name]))

    @staticmethod
    def xor_partners(shards, bit: int) -> list:
        """partner[a] = shards[a ^ 2^bit], on shard a's device."""
        return [shards[a ^ (1 << bit)].to(s.device)
                for a, s in enumerate(shards)]

    @staticmethod
    def psum(values) -> torch.Tensor:
        """Sum over the shards of one axis, in shard order, on the first
        shard's device."""
        total = values[0]
        for v in values[1:]:
            total = total + v.to(total.device)
        return total


def visible_devices(device="cuda") -> list[torch.device]:
    """Every card for a CUDA ``device`` (raises without CUDA), else the one
    ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not"
                           " available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def logical_devices(n: int, device="cuda") -> list[torch.device]:
    """``n`` logical devices laid round-robin over ``visible_devices``: the
    counterpart of the reference's ``--num_devices`` virtual devices."""
    cards = visible_devices(device)
    return [cards[i % len(cards)] for i in range(n)]


def make_mesh(n_amp: int = 1, n_traj: int | None = None,
              devices=None) -> Mesh:
    """Mesh with shape (traj, amp); n_amp must be a power of two. devices
    defaults to every visible card."""
    if devices is None:
        devices = visible_devices()
    n_dev = len(devices)
    if n_amp & (n_amp - 1):
        raise ValueError("n_amp must be a power of two")
    if n_traj is None:
        n_traj = n_dev // n_amp
    if n_traj * n_amp > n_dev:
        raise ValueError(f"need {n_traj * n_amp} devices, have {n_dev}")
    return Mesh(devices[: n_traj * n_amp], n_traj, n_amp)


def amp_bits(mesh: Mesh) -> int:
    return mesh.shape["amp"].bit_length() - 1
