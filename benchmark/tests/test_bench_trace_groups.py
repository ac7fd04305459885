"""``benchmark/trace_groups.py`` on a small hand-made chrome trace: launches
under autograd ops, launches from the no-grad serving path matched by the
allocations before them on their host thread, one launch matched neither
way, the busy time inside the traced span and the idle gaps named by the
benchmark's host spans."""

import pytest

from benchmark import flops
from benchmark import trace_groups as tg

BF16 = "c10::BFloat16"


def kernel(name, ts, dur, ext=0, corr=0, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": stream,
            "args": {"stream": stream, "External id": ext, "correlation": corr}}


def host(name, ts, dur=1, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


EVENTS = [
    host("bench:stretch", 0, 300, cat="user_annotation"),
    host("bench:call", 0, 100, cat="user_annotation"),
    host("bench:cost", 200, 50, cat="user_annotation"),
    # Under autograd: the Function op carries the shapes.
    host("ConvNormActFn", 1, 5, **{"External id": 10, "Input Dims": [[2, 16, 16, 3], [4, 4, 3, 8]],
                                   "Input type": [BF16, "float"]}),
    host("GroupNormActFnBackward", 2, 5, **{"External id": 12, "Input Dims": [[2, 8, 8, 32]],
                                            "Input type": [BF16]}),
    # No grad: kernel 1 launched after casting its weights and allocating its output.
    host("aten::to", 100, **{"External id": 20, "Input Dims": [[4, 4, 8, 16], [], [], [], []],
                             "Input type": ["float", "Scalar"]}),
    host("aten::empty", 102, **{"External id": 21, "Input Dims": [[], [], [], [], [], []],
                                "Concrete Inputs": ["[2, 4, 4, 16]", "15", "", "", "False", ""]}),
    host("cudaLaunchKernel", 104, cat="cuda_runtime", correlation=501),
    # No grad: kernel 3 launched after allocating its output like its input.
    host("aten::empty_like", 110, **{"External id": 22, "Input Dims": [[2, 8, 8, 32], []],
                                     "Input type": [BF16, ""]}),
    host("cudaLaunchKernelExC", 112, cat="cuda_runtime", correlation=502),
    # A kernel-2 launch with nothing to match: kernel 2 stays out of the share.
    host("cudaLaunchKernel", 120, cat="cuda_runtime", correlation=503),
    kernel("void acg::wg::pack_weights_kernel<false>(__nv_bfloat16 const*)", 10, 5, 10),
    kernel("void acg::wg::conv_wgmma_kernel<false, 64, 256, 8>(__nv_bfloat16 const*)", 15, 20, 10),
    kernel("acg::gn_stats_kernel(float const*, float const*, float*)", 35, 2, 10),
    kernel("void (anonymous namespace)::gn_bwd_cluster_kernel<float, __nv_bfloat16, 8, 1>(float)",
           40, 8, 12),
    kernel("gn_bwd_batch_sum_kernel(float const*, float*, float*, int, int)", 48, 2, 12),
    kernel("void acg::wg::conv_wgmma_kernel<false, 64, 256, 8>(__nv_bfloat16 const*)", 110, 10,
           999, 501),
    kernel("acg::gn_apply_kernel<float, __nv_bfloat16>(float const*)", 120, 5, 999, 0),
    kernel("void (anonymous namespace)::gn_cluster_kernel<__nv_bfloat16, 8, 2>(float const*)",
           130, 6, 999, 502),
    kernel("void acg::conv_wmma_kernel<true, 64, 64, 2, 2, 1, 8>(__nv_bfloat16 const*)", 140, 10,
           999, 503),
    kernel("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 150, 30),
    kernel("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
           220, 20),
    kernel("Memcpy DtoH (Device -> Pageable)", 280, 10, stream=9, cat="gpu_memcpy"),
    kernel("outside_the_stretch", 400, 10),
]


@pytest.fixture
def summary():
    return tg.summarize({"traceEvents": EVENTS}, "bench:stretch")


def test_groups_and_busy_time(summary):
    assert summary.window_s == pytest.approx(300e-6)
    # Busy: [10, 37) [40, 50) [110, 125) [130, 136) [140, 180) [220, 240) [280, 290).
    assert summary.busy_s == pytest.approx((27 + 10 + 15 + 6 + 40 + 20 + 10) * 1e-6)
    g = summary.group_s
    assert g["acgan conv_norm_act (kernel 1)"] == pytest.approx((5 + 20 + 2 + 10 + 5) * 1e-6)
    assert g["acgan gn_act_bwd (kernel 4)"] == pytest.approx(10e-6)
    assert g["acgan group_norm_act (kernel 3)"] == pytest.approx(6e-6)
    assert g["acgan conv_transpose_norm_act (kernel 2)"] == pytest.approx(10e-6)
    assert g["cuDNN / cuBLAS conv and GEMM"] == pytest.approx(30e-6)
    assert g["elementwise"] == pytest.approx(20e-6)
    assert g["copies and memsets"] == pytest.approx(10e-6)
    assert summary.library_s == pytest.approx(60e-6)


def test_launches_matched_by_op_and_by_host_allocations(summary):
    k = summary.kernels
    assert (k["conv_norm_act"]["launches"], k["conv_norm_act"]["matched"]) == (2, 2)
    assert (k["group_norm_act"]["launches"], k["group_norm_act"]["matched"]) == (1, 1)
    assert (k["gn_act_bwd"]["launches"], k["gn_act_bwd"]["matched"]) == (1, 1)
    # Kernel 2's launch finds no allocation since kernel 3's launch before it.
    assert (k["conv_transpose_norm_act"]["launches"],
            k["conv_transpose_norm_act"]["matched"]) == (1, 0)
    autograd = flops.conv_cost(2, 16, 16, 3, 4, 8, 2, False, 2)
    no_grad = flops.conv_cost(2, 8, 8, 8, 4, 16, 2, False, 2)
    assert k["conv_norm_act"]["roof_s"] == pytest.approx(autograd + no_grad)
    assert k["group_norm_act"]["roof_s"] == pytest.approx(flops.gn_cost(2, 8, 8, 32, 2))
    assert k["gn_act_bwd"]["roof_s"] == pytest.approx(flops.gn_bwd_cost(2, 8, 8, 32, 2, 2))
    roof = autograd + no_grad + flops.gn_cost(2, 8, 8, 32, 2) + flops.gn_bwd_cost(2, 8, 8, 32, 2, 2)
    # Kernel 2's unmatched launch keeps kernel 2 out of the share.
    assert summary.roofline_share() == pytest.approx(roof / ((42 + 6 + 10) * 1e-6))


def test_idle_gaps_named_by_the_host_span(summary):
    # Gaps: [0, 10) [37, 40) [50, 110) in bench:call; [240, 280) in
    # bench:cost; [125, 130) [136, 140) [180, 220) [290, 300) in none.
    assert [(n, round(s * 1e6)) for n, s in summary.idle_gaps] == [
        ("bench:call", 60), ("no bench span", 40), ("bench:cost", 40), ("bench:call", 10),
        ("no bench span", 10), ("no bench span", 5), ("no bench span", 4), ("bench:call", 3)]


def test_no_shapes_no_share():
    events = [e for e in EVENTS if e["cat"] in ("user_annotation", "kernel")
              and "conv_wgmma" not in e["name"] and "bwd" not in e["name"]]
    assert tg.summarize({"traceEvents": events}, "bench:stretch").roofline_share() is None


def test_the_stretch_span_is_required():
    with pytest.raises(ValueError, match="bench:stretch"):
        tg.summarize({"traceEvents": EVENTS[1:]}, "bench:stretch")
