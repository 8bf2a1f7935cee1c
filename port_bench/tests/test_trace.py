"""The trace arithmetic on a synthetic trace: busy time as the union of
device intervals, idle gaps labelled by the span the host was in, the
top operations, kernel kinds, and the per-layer readers on top."""

from __future__ import annotations

import pytest

from port_bench import readers, trace
from port_bench.common import Run


def synthetic() -> trace.Trace:
    # window 0..100 us; device: two overlapping kernels, a copy, a gap
    device = [(10.0, 30.0, "sm90_xmma_gemm_bf16"),
              (15.0, 40.0, "vectorized_elementwise_kernel"),
              (60.0, 70.0, "Memcpy HtoD (Pageable -> Device)"),
              (70.0, 90.0, "cudnn_conv_fprop_implicit")]
    spans = [(0.0, 50.0, "forward"), (50.0, 100.0, "d2h")]
    return trace.Trace(0.0, 100.0, device, spans)


def test_busy_and_gaps():
    t = synthetic()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(60e-6)      # [10,40] + [60,90]
    assert t.gaps() == [(0.0, 10.0), (40.0, 60.0), (90.0, 100.0)]


def test_idle_by_span():
    # gaps' middles: 5 and 50 -> "d2h" starts at 50 -> forward, d2h, d2h
    got = dict(synthetic().idle_by_span())
    assert got == {"forward": pytest.approx(10e-6),
                   "d2h": pytest.approx(30e-6)}


def test_top_ops_and_kinds():
    top = synthetic().top_ops(10)
    assert top[0] == ["vectorized_elementwise_kernel", pytest.approx(25e-6)]
    assert [v for _, v in top] == sorted((v for _, v in top), reverse=True)
    assert len(synthetic().top_ops(2)) == 2
    assert trace.kind("Memcpy DtoH (Device -> Pageable)") == "copy"
    assert trace.kind("cudnn_conv_fprop_implicit") == "conv"
    assert trace.kind("sm90_xmma_gemm_bf16") == "gemm"
    assert trace.kind("vectorized_elementwise_kernel") == "other"


def test_readers():
    run = Run(trace=synthetic(), batches=2, units=4,
              cfg={"dtype": "bfloat16"},
              device_kind="NVIDIA H100 80GB HBM3")
    assert readers.idle_pct(run) == pytest.approx(40.0)
    assert readers.device_ms_per_call(run, ("other",)) == \
        pytest.approx(25e-3 / 2)
    assert readers.device_ms_per_call(run, ("conv", "gemm")) == \
        pytest.approx(40e-3 / 2)
    # 989e12 operations a second for 100 us: 9.89e10 is the whole peak
    assert readers.peak_share(run, 9.89e10, "bf16_flop_per_s") == \
        pytest.approx(100.0)


def test_readers_report_nothing_without_data():
    assert readers.idle_pct(Run()) is None
    run = Run(trace=synthetic(), batches=2, device_kind="some other card",
              cfg={"dtype": "bfloat16"})
    assert readers.peak_share(run, 1.0, "bf16_flop_per_s") is None
    empty = Run(trace=trace.Trace(0.0, 10.0), batches=1)
    assert readers.device_ms_per_call(empty, ("other",)) is None
