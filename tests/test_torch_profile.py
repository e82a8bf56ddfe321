"""The profiler summary's busy time and per-kernel sums (CPU, fake events)."""

from types import SimpleNamespace

import pytest
import torch

from dtc_tpu_torch.profile_sweep import busy_summary, short_name

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_is_the_union_of_device_intervals():
    events = [_ev("pass_lo", 0, 400), _ev("pass_hi", 350, 800),
              _ev("pass_lo", 1000, 1400), _ev("memcpy", 1100, 1200),
              _ev("aten::copy_", 0, 5000, CPU)]
    s = busy_summary(events)
    assert s["busy_ms"] == 1.2  # [0, 800) and [1000, 1400) us
    assert s["kernels"][0] == {"name": "pass_lo", "ms": 0.8, "launches": 2}
    assert [k["name"] for k in s["kernels"]] == ["pass_lo", "pass_hi",
                                                 "memcpy"]


def test_top_kernels_and_other():
    events = [_ev(f"k{i}", 10 * i, 10 * i + i + 1) for i in range(8)]
    s = busy_summary(events, top=2)
    assert [k["name"] for k in s["kernels"]] == ["k7", "k6", "other"]
    assert s["kernels"][-1]["launches"] == 6
    assert abs(s["kernels"][-1]["ms"] - 0.021) < 1e-12  # 1 + 2 + ... + 6 us


@pytest.mark.parametrize("raw, short", [
    ("(anonymous namespace)::pass_hi_kernel(float2*, int, long)",
     "pass_hi_kernel"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >"
     "(at::native::ReduceOp<float>)", "at::native::reduce_kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH"),
    ("plain", "plain"),
    ("void (anonymous namespace)::pass_lo_kernel<true>(float2*, int, int, "
     "(anonymous namespace)::Obs)", "pass_lo_kernel<true>"),
    ("void (anonymous namespace)::pass_hi_kernel<false>(float2*, int)",
     "pass_hi_kernel<false>"),
    ("void (anonymous namespace)::general_strided_kernel<true>(float2*, int, "
     "int, int, float const*, long, int, int, int, float*)",
     "general_strided_kernel<true>"),
    ("void (anonymous namespace)::general_strided_kernel<false, 128>(float2*,"
     " int, int, int, float const*, long, int, int, int, float*)",
     "general_strided_kernel<false>"),
    ("void (anonymous namespace)::measured_reduce_kernel<128>(float const*, "
     "int, float const*, long, int, int, float*, int)",
     "measured_reduce_kernel"),
])
def test_short_name(raw, short):
    assert short_name(raw) == short


def test_no_device_events():
    s = busy_summary([_ev("aten::add", 0, 10, CPU)])
    assert s == {"busy_ms": 0.0, "kernels": []}
