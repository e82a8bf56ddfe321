"""The multi-device dry run (``dtc_tpu_torch/dryrun.py``) on 8 logical CPU
devices: every check passes on the kernels' plain versions and the OK line
is the last thing printed."""

import pytest
import torch

from dtc_tpu_torch import dryrun
from dtc_tpu_torch.dryrun import dryrun_multichip, main
from dtc_tpu_torch.experiments.sharded_run import forward_plan
from dtc_tpu_torch.ops.resident_blocked import MAX_LAUNCH
from dtc_tpu_torch.parallel.mesh import logical_devices, make_mesh
from dtc_tpu_torch.utils.config import SimConfig

torch.set_num_threads(2)


def test_dryrun_multichip_on_eight_cpu_devices(capsys):
    dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("dryrun_multichip OK on 8 devices")
    assert "mesh traj=1 x amp=8" in out[-1]
    assert "L=32: route=cycle_hi L_loc=29" in out[-1]
    assert ("L=20: route=cycle L_loc=17 1048576 B a shard, 128 launches a "
            "cycle of at most 512 trajectories") in out[-1]


def test_dryrun_cli_on_three_cpu_devices(capsys):
    """n = 3: amp = 1 for the small mesh, 2 shards for the kernels' step."""
    assert main(["3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("dryrun_multichip OK on 3 devices "
                              "(mesh traj=3 x amp=1)")


def test_forward_plan_allocates_nothing_and_names_the_route():
    """The L=32 plan on 4 shards of one device takes the sigma engines
    (L_loc = 30, as the reference routes x there) and launches no kernel;
    on 8 shards the streamed per-shard kernels, one trajectory a launch."""
    cfg = SimConfig(L=32, tf=2, n_trajectories=1, qubit=11)
    plan = forward_plan(make_mesh(4, 1, devices=["cpu"] * 4), cfg)
    assert plan["route"] == "sharded_sigma" and plan["launches"] == []
    assert plan["shard_bytes"] == 8 << 30 and plan["group_traj"] == 1
    plan = forward_plan(make_mesh(8, 1, devices=["cpu"] * 8), cfg)
    assert plan["route"] == "cycle_hi" and plan["launches"] == [1] * 8


@pytest.mark.parametrize("launch,what", [
    (MAX_LAUNCH + 1, "grid limit"), (1025, "KERNEL_STATE_BYTES")])
def test_plan_check_refuses_an_oversized_launch(monkeypatch, launch, what):
    """On 4 shards of one device the L_loc = 17 plan's launches hold at
    most 1024 trajectories (16 B x 4 shards x 2^17 in 8 GiB); a plan with
    a launch past that, or past the grid limit, fails its check."""
    plan = dryrun.forward_plan
    assert "32 launches a cycle of at most 1024" in dryrun._plans(
        logical_devices(4, "cpu"), 4)

    def bad(mesh, cfg):
        got = plan(mesh, cfg)
        if got["local_bits"] == 17:
            got["launches"], got["group_traj"] = [launch] * 4, launch
        return got

    monkeypatch.setattr(dryrun, "forward_plan", bad)
    with pytest.raises(RuntimeError, match=f"{what} failed: {launch}$"):
        dryrun._plans(logical_devices(4, "cpu"), 4)
