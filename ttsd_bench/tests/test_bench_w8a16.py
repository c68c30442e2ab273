"""The ``w8a16_roofline.batch`` reader on the CPU, over traces written by
hand: the int8 weight bytes of a MOSS-TTSD v0.5 step counted from the
configuration, the kernels' device time taken a traced step, and nothing
read where there is nothing to read.

    python -m pytest ttsd_bench/tests -q
"""

from __future__ import annotations

import json

import pytest

from ttsd_bench import run
from ttsd_bench.counts import PEAK_HBM_BYTES_PER_S
from ttsd_bench.readers import load

READ = load("w8a16_roofline.batch")
KERNEL = "void moss::w8a16::product_kernel<1, false>(moss::w8a16::Args)"
HEAD = "void moss::w8a16::product_kernel<1, true>(moss::w8a16::Args)"
GEMM = "void moss::w8a16_gemm::gemm_kernel<false>(moss::w8a16::Args)"


def _cfg(name: str) -> dict:
    with open(run.ROOT / "ttsd_bench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_bytes_of_a_step_over_the_kernels_time_a_step():
    """28 layers of seven projections (20480 rows of 2048 or 6144 bytes)
    and the eight heads (152704 + 7 x 1025 rows of 2048): 1.7367 G int8
    weights and 4 bytes of scale a row; 12 traced steps whose kernels
    took 1.2 ms each read 1739.5 MB / 3.35 TB/s / 1.2 ms."""
    cfg = _cfg("moss-ttsd-v0.5-int8")
    rows = 28 * (2048 + 1024 + 1024 + 2048 + 6144 + 6144 + 2048) \
        + 152704 + 7 * 1025
    weights = 28 * (2 * 2048 * 2048 + 2 * 1024 * 2048 + 3 * 6144 * 2048) \
        + (152704 + 7 * 1025) * 2048
    nbytes = weights + 4 * rows
    trace = {"steps": 12, "kernels": {KERNEL: [0.225e-3] * 12 * 4,
                                      HEAD: [0.3e-3] * 12,
                                      GEMM: [2.0e-3] * 4,
                                      "other_kernel": [5.0] * 3}}
    got = READ({"trace": trace}, cfg)
    want = 100.0 * nbytes / PEAK_HBM_BYTES_PER_S / 1.2e-3
    assert got == pytest.approx(want, rel=1e-12)
    assert nbytes == pytest.approx(1.7395e9, rel=1e-4)


@pytest.mark.parametrize("case", ["bf16_config", "restricted_head",
                                  "no_kernel", "prefill_kernel_only",
                                  "no_steps", "no_trace"])
def test_nothing_to_read(case):
    """None, not 0: a configuration without int8 weights, one whose text
    head is restricted (its steps read a window, and the whole table only
    on audits), a trace without the decode kernels (a program that
    dequantizes into copies, or one whose only w8a16 kernel is the
    prefill's), no labelled step, no trace at all."""
    cfg = _cfg("moss-ttsd-v0.5-bf16" if case == "bf16_config"
               else "moss-ttsd-v0.5-int8")
    if case == "restricted_head":
        cfg = {**cfg, "restricted_text_head": True}
    trace = {"steps": 12, "kernels": {KERNEL: [1e-3]}}
    if case == "no_kernel":
        trace["kernels"] = {"void at::native::direct_copy": [1e-3]}
    elif case == "prefill_kernel_only":
        trace["kernels"] = {GEMM: [1e-3]}
    elif case == "no_steps":
        trace["steps"] = 0
    layer = {} if case == "no_trace" else {"trace": trace}
    assert READ(layer, cfg) is None
