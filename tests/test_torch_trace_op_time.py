"""The port's trace summary (``tools/trace_op_time.py``): executed FLOPs
counted from a real CPU ``torch.profiler`` trace (``record_shapes``) of a
strided, grouped convolution forward and backward, a transposed
convolution, a matrix product and a linear layer, against the profiler's
own ``flops`` for the forward ops and the closed formula per output mask
for the backward; and, on a small hand-written Chrome trace with ``kernel``
events tied to ops by ``External id``, the attribution of kernels to their
innermost op, the categories, the nesting annotation left out, the totals
adding up to the busy time, the merge of two files and ``--iters``."""

import json

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from content_aware_gan_compression_torch.tools import trace_op_time as tot
from torch_train_util import torch_threads  # noqa: F401


def _profiled(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True, with_flops=True) as p:
        fn()
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    return p, tot.load_events(str(path), log=lambda *a: None)


def _flops_of(trace, name):
    return [op.flops for op in trace.ops if op.name == name and op.flops]


@pytest.mark.parametrize("input_grad", [True, False])
def test_convolution_flops_against_the_profiler_and_the_formula(tmp_path, input_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 9, 9, generator=g, requires_grad=input_grad)
    w = torch.randn(4, 3, 3, 3, generator=g, requires_grad=True)

    def work():
        y = F.conv2d(x, w, stride=2, padding=1, groups=2)
        y.square().sum().backward()

    prof, trace = _profiled(tmp_path, work)
    (want_fwd,) = [e.flops for e in prof.events() if e.name == "aten::conv2d"]
    # [2, 6, 9, 9] * [4, 3, 3, 3], stride 2, pad 1, groups 2 -> [2, 4, 5, 5]
    formula = 2 * 2 * 4 * 5 * 5 * 3 * 9
    assert want_fwd == formula
    assert _flops_of(trace, "aten::convolution") == [want_fwd]
    # the backward: one count per gradient its output mask asks for
    assert _flops_of(trace, "aten::convolution_backward") == [formula * (1 + input_grad)]
    assert tot.executed_flops(trace) == formula * (2 + input_grad)
    # nested ops count once: conv2d > convolution > _convolution > the backend's
    assert not _flops_of(trace, "aten::_convolution")


def test_transposed_convolution_and_matrix_products(tmp_path):
    g = torch.Generator().manual_seed(1)
    y = torch.randn(2, 4, 5, 5, generator=g)
    w = torch.randn(4, 3, 3, 3, generator=g)  # [C_in, C_out / groups, 3, 3]
    a, b = torch.randn(5, 7, generator=g), torch.randn(7, 3, generator=g)
    lw, lb = torch.randn(3, 7, generator=g), torch.randn(3, generator=g)
    bx, by = torch.randn(2, 5, 7, generator=g), torch.randn(2, 7, 3, generator=g)

    def work():
        F.conv_transpose2d(y, w, stride=2, padding=1, groups=2)
        torch.mm(a, b)
        F.linear(a, lw, lb)
        torch.bmm(bx, by)

    prof, trace = _profiled(tmp_path, work)
    # the adjoint of the forward convolution of the test above: the same count
    assert _flops_of(trace, "aten::convolution") == [2 * 2 * 4 * 5 * 5 * 3 * 9]
    profiled = {e.name: e.flops for e in prof.events() if e.flops}
    assert _flops_of(trace, "aten::mm") == [profiled["aten::mm"]] == [2 * 5 * 7 * 3]
    assert _flops_of(trace, "aten::bmm") == [profiled["aten::bmm"]] == [2 * 2 * 5 * 7 * 3]
    # linear holds addmm: counted once, as linear
    assert _flops_of(trace, "aten::linear") == [2 * 5 * 7 * 3]
    assert not _flops_of(trace, "aten::addmm")
    assert set(tot.counted_ops(trace)) == {"aten::convolution", "aten::mm", "aten::linear",
                                          "aten::bmm"}


def _op(name, ts, dur, ext, dims=(), types=(), concrete=(), tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 7, "tid": tid, "ts": ts,
            "dur": dur, "args": {"External id": ext, "Input Dims": list(dims),
                                 "Input type": list(types), "Concrete Inputs": list(concrete)}}


def _dev(name, ts, dur, ext, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"External id": ext, "correlation": ext + 100}}


CONV_DIMS = ([2, 4, 8, 8], [8, 4, 3, 3], [], [], [], [], [], [], [])
CONV_TYPES = ("float", "float", "", "ScalarList", "ScalarList", "ScalarList", "Scalar",
              "ScalarList", "Scalar")
CONV_ARGS = ("", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1")
CONV_FLOPS = 2 * 2 * 8 * 8 * 8 * 4 * 9
MM_FLOPS = 2 * 16 * 32 * 8


def _hand_trace():
    """conv2d > convolution > cudnn_convolution launching two kernels; an
    add launching an elementwise kernel, a copy and the port's epilogue; mm
    launching a GEMM kernel; a record_function range over the first
    kernels on the device; and a runtime call, which is no device event."""
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        _op("aten::conv2d", 0, 100, 1, CONV_DIMS[:7], CONV_TYPES[:7], CONV_ARGS[:7]),
        _op("aten::convolution", 1, 98, 2, CONV_DIMS, CONV_TYPES, CONV_ARGS),
        _op("aten::cudnn_convolution", 2, 90, 3, CONV_DIMS[:2], CONV_TYPES[:2]),
        _op("aten::add_", 110, 5, 4, ([2, 8, 8, 8], [2, 8, 8, 8]), ("float", "float")),
        _op("aten::mm", 120, 10, 5, ([16, 32], [32, 8]), ("c10::BFloat16", "c10::BFloat16")),
        # a backward that runs a counted convolution inside: its FLOPs are the outer op's
        _op("aten::convolution_backward", 140, 40, 6, [[2, 8, 8, 8]] + list(CONV_DIMS[:2]),
            ("float",) * 3, ("", "", "", "[0]", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]",
                             "1", "[False, True, False]")),
        _op("aten::_convolution", 141, 30, 7, CONV_DIMS, CONV_TYPES, CONV_ARGS),
        _op("aten::cudnn_convolution", 142, 20, 8, ([4, 2, 8, 8], [8, 2, 8, 8]),
            ("float", "float")),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 7, "tid": 1,
         "ts": 3, "dur": 2, "args": {"External id": 3, "correlation": 103}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "a range", "pid": 0, "tid": 7,
         "ts": 199, "dur": 70, "args": {}},
        _dev("sm90_xmma_fprop_implicit_gemm_bf16", 200, 30, 3),
        _dev("void cudnn::ops::nchwToNhwcKernel<float>", 231, 10, 3),
        _dev("void at::native::vectorized_elementwise_kernel<4, AddFunctor>", 250, 4, 4),
        _dev("Memcpy DtoD (Device -> Device)", 255, 2, 4, cat="gpu_memcpy"),
        _dev("void fnbl_kernel<Vec16<float>>(float const*)", 258, 1, 4),
        _dev("sm90_gemm_bf16_128x128", 260, 6, 5),
        _dev("void implicit_convolve_sgemm<__nv_bfloat16, 128>", 270, 50, 8),
    ]}


def test_hand_trace_attribution_and_totals(tmp_path, capsys):
    (tmp_path / "t.json").write_text(json.dumps(_hand_trace()))
    logged = []
    trace = tot.load_events(str(tmp_path), log=logged.append)
    assert logged == ["# left out, device events that nest the ones counted: "
                      "gpu_user_annotation 0.070 ms"]
    assert [e["op"].name for e in trace.device] == [
        "aten::cudnn_convolution", "aten::cudnn_convolution", "aten::add_", "aten::add_",
        "aten::add_", "aten::mm", "aten::cudnn_convolution"]
    # the backward's mask asks for the weight gradient alone: one convolution's count
    assert tot.executed_flops(trace) == 2 * CONV_FLOPS + MM_FLOPS
    s = tot.summarize(trace)
    cats = {k: v for k, v in s["categories"].items() if v[3]}
    assert {k: (v[0], v[3]) for k, v in cats.items()} == {
        "cuDNN convolution": (90.0, 3), "elementwise": (4.0, 1), "copies": (2.0, 1),
        "epilogue": (1.0, 1), "GEMM": (6.0, 1)}
    assert s["busy_us"] == sum(v[0] for v in s["categories"].values()) == 103.0
    assert s["window_us"] == 120.0 and s["union_us"] == 103.0
    # the convolution's FLOPs split over its two kernels by time; mm's to its one;
    # the backward's to the kernel launched inside its inner convolution
    assert cats["cuDNN convolution"][1] == pytest.approx(2 * CONV_FLOPS)
    kernels = s["kernels"]
    assert kernels["sm90_xmma_fprop_implicit_gemm_bf16"][1] == pytest.approx(CONV_FLOPS * 0.75)
    assert kernels["void implicit_convolve_sgemm<__nv_bfloat16, 128>"][1] == CONV_FLOPS
    assert cats["GEMM"][1] == MM_FLOPS and cats["GEMM"][2] == (16 * 32 + 32 * 8) * 2
    # an op's input bytes over the kernels it launched itself
    add_bytes = 2 * 2 * 8 * 8 * 8 * 4
    assert sum(v[2] for k, v in s["ops"].items() if k[0] == "aten::add_") == pytest.approx(
        add_bytes)
    assert s["ops"][("aten::cudnn_convolution", "[[2, 4, 8, 8], [8, 4, 3, 3]] float")][3] == 1
    assert s["categories"]["epilogue"][3] == 1 and s["categories"]["blur4"][3] == 0

    # --iters: every figure per iteration; two files merge
    (tmp_path / "u.json").write_text(json.dumps(_hand_trace()))
    capsys.readouterr()
    tot.main([str(tmp_path), "3", "--iters", "2"])
    out = capsys.readouterr().out
    assert "# merging 2 trace files" in out
    assert "device busy: 0.206 ms" in out and "= 0.103 ms/iter over 2 iterations" in out
    conv_row = next(line for line in out.splitlines() if line.endswith("cuDNN convolution"))
    assert conv_row.split()[0] == "0.090" and "ms/it" in conv_row
    assert "== top 3 aten ops with their input shapes" in out
    assert "aten::cudnn_convolution [[2, 4, 8, 8], [8, 4, 3, 3]] float" in out
    assert any(line.endswith(" sm90_xmma_fprop_implicit_gemm_bf16") and " n=2 " in line
               for line in out.splitlines())
