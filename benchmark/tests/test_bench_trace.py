"""The frozen trace reader and the per-layer readings on a small synthetic
Chrome trace: categories, the busy union over two streams, a roofline at a
hand-reckoned shape, idle gaps by what the host was doing."""

from __future__ import annotations

import json

import pytest

from benchmark.lib import readers
from benchmark.lib import trace as tl

BLUR_IN, BLUR_OUT = [16, 256, 256, 128], [16, 257, 257, 128]
EPI = [16, 64, 64, 154]


def op(name, ts, dur, ext, dims=(), types=(), concrete=()):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": {"External id": ext, "Input Dims": list(dims), "Input type": list(types),
                     "Concrete Inputs": list(concrete)}}


def kernel(name, ts, dur, ext, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": stream, "args": {"External id": ext}}


@pytest.fixture
def trace(tmp_path):
    events = [
        op("aten::conv2d", 0, 20, 1),
        op("aten::convolution", 1, 18, 2, [[2, 3, 8, 8], [4, 3, 3, 3], [4]],
           ["float"] * 3, ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"]),
        kernel("sm90_xmma_fprop_implicit_gemm", 10, 50, 2),
        op("aten::mul", 25, 10, 6, [[2, 4, 8, 8], []]),
        kernel("void at::native::vectorized_elementwise_kernel<4>", 30, 50, 6, stream=8),
        op("aten::item", 70, 145, 9),
        op("Blur4Fn", 220, 80, 3, [BLUR_IN, [4, 4]], ["c10::BFloat16", "float"]),
        op("aten::empty", 221, 5, 4, [[]], [""], [str(BLUR_OUT)]),
        kernel("void (anonymous namespace)::blur4_tiled<__nv_bfloat16, 8>", 220, 100, 3),
        op("FusedNoiseBiasLReLUFn", 400, 50, 5, [EPI, EPI[:3] + [1], [154], [1]],
           ["float"] * 4),
        kernel("void (anonymous namespace)::fnbl_kernel<lanes::F32>", 405, 40, 5),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tl.load_events(str(path), log=lambda *a: None)


def test_categories_and_busy_union(trace):
    cats = {e["name"]: tl.category(e) for e in trace.device}
    assert cats["sm90_xmma_fprop_implicit_gemm"] == "cuDNN convolution"
    assert cats["void at::native::vectorized_elementwise_kernel<4>"] == "elementwise"
    assert "blur4" in cats.values() and "epilogue" in cats.values()
    assert set(cats.values()) <= set(tl.CATEGORIES)
    assert tl.busy_union(trace.device) == pytest.approx(70 + 100 + 40)
    assert tl.category_us(trace, ("cuDNN convolution",)) == 50


def test_roofline_at_a_hand_reckoned_shape(trace):
    n_in, n_out = 16 * 256 * 256 * 128, 16 * 257 * 257 * 128
    blur = 100 * (2 * (n_in + n_out) / 3.35e12) / 100e-6
    assert tl.roofline_percent(trace, ("blur4",), 3.35e12) == pytest.approx(blur)
    x = 16 * 64 * 64 * 154
    epi = 100 * (4 * (2 * x + 16 * 64 * 64 + 154 + 1) / 3.35e12) / 40e-6
    assert tl.roofline_percent(trace, ("epilogue", "masked_scale"), 3.35e12) \
        == pytest.approx(epi)
    assert tl.roofline_percent(trace, ("masked_scale",), 3.35e12) is None


def test_idle_gaps_by_host_op(trace):
    gaps = dict(tl.idle_gaps(trace))
    assert gaps["aten::item"] == pytest.approx(140e-6)
    assert gaps["(no op)"] == pytest.approx(85e-6)


def test_readings(trace):
    data = {**readers.from_trace(trace, units=2), "rate": 1000.0, "flop_per_unit": 1e9,
            "peak_tflops": 989.4, "chips": 1, "peak_bytes": 7e9,
            "spans_ms": {"d": 1.0, "d_reg": 0.5, "g": 2.0, "g_reg": 0.25, "ema": 0.1}}
    assert data["busy_s"] == pytest.approx(210e-6)
    assert data["window_s"] == pytest.approx(435e-6)
    assert readers.category_ms(data, readers.CONV) == pytest.approx(0.025)
    assert readers.idle_percent(data) == pytest.approx(100 * (1 - 105e-6 * 1000))
    assert readers.mfu_percent(data) == pytest.approx(100 * 1e12 / 989.4e12)
    assert readers.phase_ms(data, ("d_reg", "g_reg")) == pytest.approx(0.75)
    assert readers.peak_gb(data) == 7.0
    assert readers.phase_ms({}, ("d",)) is None and readers.category_ms({}, ("NCCL",)) is None
