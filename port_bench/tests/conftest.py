"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with the cells cut to a size a CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from port_bench.spec import ROOT

SMALL = {"L": 14, "q": 7, "tf": 6}
SMALL_TRAFFIC = {"n_trajectories": 4, "warm_tf": 3}


def copy_bench(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's files under ``dest``."""
    shutil.copytree(ROOT / "port_bench", dest / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    return dest


def shrink(root: Path, cfg=SMALL, traffic=SMALL_TRAFFIC) -> Path:
    for f in (root / "port_bench/configs").glob("*.json"):
        f.write_text(json.dumps({**json.loads(f.read_text()), **cfg}))
    for f in (root / "port_bench/traffic").glob("*.json"):
        f.write_text(json.dumps({**json.loads(f.read_text()), **traffic}))
    return root


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    """One torch thread a test process: the tests run in several worker
    processes on a few cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return shrink(copy_bench(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def cuda_card():
    """Skips where no CUDA card is found; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")
