"""The benchmark's operation and byte counts against hand-worked values,
the trace reduction on a hand-made timeline, and the readers on it."""
import math
from types import SimpleNamespace as N

import pytest
from torch.autograd import DeviceType

from portbench import counts, harness, spec, trace

ZAMBA2 = spec.load_json(spec.HERE / "configs" / "hybrid-mamba2-2.3b.json")
MINICPM = spec.load_json(spec.HERE / "configs" / "minicpm-2b.json")
PEAK = spec.load_json(harness.PEAKS)["NVIDIA H100 80GB HBM3"]


def test_minicpm_forward_flops():
    # per layer: q, k, v, o of 2304 x 2304, and three 2304 x 5760 matrices
    layer = 4 * 2304 * 2304 + 3 * 2304 * 5760          # 61,046,784
    weights = 40 * layer + 2304 * 122753               # + the tied head
    assert weights == 2_724_694_272
    tokens = 2 * 2048
    attention = 40 * 2 * 2 * 2 * 2304 * (2048 * 2049 // 2)
    assert counts.forward_flops(MINICPM, 2, 2048) == 2 * weights * tokens + attention
    assert counts.forward_flops(MINICPM, 2, 2048) == 23_867_638_677_504
    assert counts.train_step_flops(MINICPM, 2, 2048) == 3 * 23_867_638_677_504


def test_zamba2_forward_flops():
    # Mamba2: in_proj 2560 x (2*5120 + 2*64 + 80), out_proj 5120 x 2560
    mamba = 2560 * 10448 + 5120 * 2560                 # 39,854,080
    shared = 4 * 2560 * 2560 + 3 * 2560 * 10240        # 104,857,600
    weights = 54 * mamba + 9 * shared + 2560 * 32000
    assert weights == 3_177_758_720
    attention = 9 * 2 * 2 * 2 * 2560 * (2048 * 2049 // 2)
    assert counts.forward_flops(ZAMBA2, 2, 2048) == \
        2 * weights * 4096 + attention == 26_418_935_234_560


def test_ssd_scan_counts_at_zamba2s_call():
    # 2 rows x 80 heads, L 2048, P = N = 64, one B/C group per row
    nbytes = 4 * (2 * 160 * 2048 * 64 + 160 * 2048 + 2 * 2 * 2048 * 64)
    assert counts.ssd_scan_bytes(160, 2048, 64, 64, 2) == nbytes == 171_180_032
    assert counts.ssd_scan_flops(160, 2048, 64, 64) == 5 * 160 * 2048 * 4096
    least, by = counts.ssd_scan_least_s(160, 2048, 64, 64, 2, PEAK)
    assert by == "bytes" and least == pytest.approx(171_180_032 / 3.35e12)
    assert least * 1e3 == pytest.approx(0.0511, abs=1e-4)   # chip_smoke's bound


def test_counts_at_the_cells_batch():
    # 24 and 32 rows: the weights' FLOPs scale with the tokens, attention
    # with the rows
    assert counts.forward_flops(MINICPM, 24, 2048) == \
        12 * 23_867_638_677_504 == 286_411_664_130_048
    assert counts.forward_flops(ZAMBA2, 32, 2048) == \
        16 * 26_418_935_234_560 == 422_702_963_752_960
    assert counts.ssd_scan_bytes(2560, 2048, 64, 64, 32) == \
        16 * 171_180_032 == 2_738_880_512


def test_only_float32_is_run():
    cell = spec.resolve("minicpm-2b.score_b24_l2048")
    cell.config = dict(cell.config, dtype="bfloat16")
    with pytest.raises(ValueError, match="float32"):
        harness.run_cell(cell, 1, 0.01, False, "cpu", 0.0)
    assert set(PEAK) == {"source", "f32_flops_per_s", "tf32_flops_per_s",
                         "hbm_bytes_per_s"}


def ev(name, s, e, dev, note=False):
    return N(name=name, time_range=N(start=s, end=e), device_type=dev,
             is_user_annotation=note)


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
TIMELINE = [
    ev(trace.WINDOW, 0, 100, CPU), ev(trace.WINDOW, 0, 100, GPU),
    ev("sm90_xmma_gemm_f32", 10, 30, GPU), ev("elementwise", 20, 40, GPU),
    ev("ssd_out_kernel", 60, 70, GPU), ev("before", -50, -10, GPU),
    ev("aten::mm", 35, 65, CPU), ev("cudaDeviceSynchronize", 66, 100, CPU),
    ev("nccl:all_reduce", 80, 95, GPU, note=True)]


def test_trace_union_gaps_and_own_spans():
    s = trace.summarize(TIMELINE)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)           # [10, 40] + [60, 70]
    assert s["device_s_by_name"] == pytest.approx(
        {"sm90_xmma_gemm_f32": 20e-6, "elementwise": 20e-6,
         "ssd_out_kernel": 10e-6})
    assert s["idle_s_by_host_op"] == pytest.approx(
        {"host idle": 10e-6, "aten::mm": 20e-6, "cudaDeviceSynchronize": 30e-6})
    assert trace.summarize(TIMELINE[2:]) == {}


def reading(cell, **kw):
    c = spec.resolve(cell)
    return harness.Reading(cell, c.config, c.traffic, trace.summarize(TIMELINE),
                           kw.get("iters", 1), kw.get("peak", PEAK),
                           kw.get("chips", 1))


@pytest.mark.parametrize("name,cell,expect,chips", [
    ("device_idle.score", "hybrid-mamba2-2.3b.score_b32_l2048", 60.0, 1),
    ("gemm_ms.score", "minicpm-2b.score_b24_l2048", 0.02, 1),
    ("mfu.score", "minicpm-2b.score_b24_l2048",
     100 * 286_411_664_130_048 / 100e-6 / 67e12, 1),
    ("mfu.score", "minicpm-2b.score_b24_l2048",        # rank 0's window of 4
     100 * 286_411_664_130_048 / 100e-6 / (4 * 67e12), 4),
    ("mfu.train", "minicpm-2b.train_b2_s2048",
     100 * 3 * 23_867_638_677_504 / 100e-6 / 67e12, 1),
    ("ssd_scan_roofline", "hybrid-mamba2-2.3b.score_b32_l2048",
     100 * 54 * 2_738_880_512 / 3.35e12 / 10e-6, 1),
])
def test_readers_on_the_timeline(name, cell, expect, chips):
    assert spec.metric_module(name).read(reading(cell, chips=chips)) == \
        pytest.approx(expect)


@pytest.mark.parametrize("name,cell", [
    ("device_idle.train", "minicpm-2b.score_b24_l2048"),
    ("mfu.score", "minicpm-2b.train_b2_s2048"),
    ("ssd_scan_roofline", "minicpm-2b.score_b24_l2048"),
    ("gemm_ms.train", "hybrid-mamba2-2.3b.score_b32_l2048"),
])
def test_readers_read_nothing_outside_their_cells(name, cell):
    assert spec.metric_module(name).read(reading(cell)) is None


def test_no_peak_no_share():
    r = reading("hybrid-mamba2-2.3b.score_b32_l2048", peak=None)
    for name in ("mfu.score", "ssd_scan_roofline"):
        assert spec.metric_module(name).read(r) is None
    assert math.isclose(spec.metric_module("gemm_ms.score").read(r), 0.02)
