"""The trace's reading: busy time, idle gaps by host operation, kernels by
name."""
from __future__ import annotations

import torch

from portbench.trace import Stretch, _gaps_by_host, seconds_of


def test_kernels_found_by_bare_name():
    kernel_s = {"void (anonymous namespace)::flash_wgmma_kernel<128>(int)": 2.0,
                "void (anonymous namespace)::flash_bwd_wgmma_dq_kernel<128>(int)": 3.0,
                "flash_merge_kernel": 0.5,
                "void at::native::vectorized_elementwise_kernel<4>(int)": 7.0,
                "nvjet_tst_256x128_64x4_2x1_v_bz_coopA_NNT": 11.0}
    assert seconds_of(kernel_s, "flash_") == 5.5
    assert seconds_of(kernel_s, "decode_") == 0.0


def test_gaps_named_by_the_innermost_host_operation():
    host = [(0, 100, "job"), (10, 20, "aten::mm"), (40, 60, "aten::add")]
    gaps = [(12, 16), (30, 36), (50, 52), (110, 120)]
    got = _gaps_by_host(gaps, host)
    assert got == {"aten::mm": 4e-9, "job": 6e-9, "aten::add": 2e-9,
                   "(no host operation)": 10e-9}


def test_a_cpu_stretch_reads_no_device_time():
    with Stretch(host=True) as st:
        torch.ones(64, 64) @ torch.ones(64, 64)
    t = st.read()
    assert t["busy_s"] == 0 and t["kernels"] == 0 and t["window_s"] > 0
    assert t["idle_gaps"] and t["device_ops"] == []
