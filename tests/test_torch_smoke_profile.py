"""``chip_smoke.device_rows``: the device time by kernel of a profiled run,
summed from the profiler's raw events (``key_averages`` would first build
the tree of every host event, which takes about half a minute for one
ScanNet train step).

- Device events are summed by name, largest first, with their counts;
  host events, user annotations and zero-length events are left out.
- A run profiled on the CPU alone has no device rows.
"""
import importlib.util
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_profile", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Event:
    def __init__(self, name, device, ns, annotation=False):
        self._name, self._device, self._ns, self._annotation = name, device, ns, annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def duration_ns(self):
        return self._ns

    def is_user_annotation(self):
        return self._annotation


class _Prof:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def test_device_rows_sum_device_events_by_name(smoke):
    events = [_Event("edge_kernel", CUDA, 3_000_000), _Event("basis_kernel", CUDA, 1_500_000),
              _Event("edge_kernel", CUDA, 2_000_000), _Event("cudaLaunchKernel", CPU, 9_000_000),
              _Event("aten::mm", CPU, 7_000_000), _Event("step", CUDA, 8_000_000, annotation=True),
              _Event("empty", CUDA, 0)]
    rows = smoke.device_rows(_Prof(events))
    assert rows == [(5.0, 2, "edge_kernel"), (1.5, 1, "basis_kernel")]
    assert smoke.pass_ms(rows, (("edge", (("edge_",),)), ("basis", (("basis_",),)))) == {"edge": 5.0, "basis": 1.5}


def test_device_rows_of_a_cpu_run_are_empty(smoke):
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (x @ x).relu()
    assert smoke.device_rows(prof) == []
