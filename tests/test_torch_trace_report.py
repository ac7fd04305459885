"""``profile-report`` (``utils/trace_report.py``), the port's counterpart of
the JAX package's ``utils/xplane.py`` (tests/test_xplane.py): a hand-made
chrome trace with every kind of device event, and the trace a tiny CPU
``train --profile-steps`` writes."""

import json

import pytest
import torch

from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.utils import trace_report as tr

torch.set_num_threads(1)


def kernel(name, ts, dur, ext=0, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": stream,
            "args": {"stream": stream, "External id": ext, "correlation": ts}}


def op(name, ext, dims, types):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": 0, "dur": 1, "pid": 1, "tid": 1,
            "args": {"External id": ext, "Input Dims": dims, "Input type": types}}


BF16 = "c10::BFloat16"
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "acgan:train_call[k=2]", "ts": 0, "dur": 150,
     "pid": 1, "tid": 1, "args": {}},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "acgan:train_call[k=2]", "ts": 5, "dur": 190,
     "pid": 0, "tid": 7, "args": {}},
    op("ConvNormActFn", 10, [[2, 16, 16, 3], [4, 4, 3, 8], [8], [8]], [BF16, "float", "float", "float"]),
    op("ConvTransposeNormActFn", 11, [[2, 8, 8, 8], [4, 4, 8, 4], [], [4]], [BF16, "float", "", "float"]),
    op("ConvNormActFnBackward", 12, [[2, 8, 8, 8]], [BF16]),
    op("GroupNormActFn", 13, [[2, 8, 8, 32], [32], [32]], ["float", "float", "float"]),
    kernel("void acg::wg::pack_weights_kernel<false>(__nv_bfloat16 const*)", 10, 5, 10),
    kernel("void acg::wg::conv_wgmma_kernel<false, 64, 256, 8>(__nv_bfloat16 const*)", 15, 20, 10),
    kernel("acg::gn_stats_kernel(float const*, float const*, float*)", 35, 2, 10),
    kernel("void acg::gn_apply_kernel<float, __nv_bfloat16>(float const*)", 37, 3, 10),
    kernel("void acg::conv_wmma_kernel<true, 64, 64, 2, 2, 1, 8>(__nv_bfloat16 const*)", 40, 10, 11),
    kernel("void acg::gn_apply_kernel<float, __nv_bfloat16>(float const*)", 50, 4, 11),
    kernel("void acg::narrow::narrow_transpose_kernel<1, 8>(acg::narrow::Args)", 54, 6, 99),
    kernel("void (anonymous namespace)::gn_cluster_kernel<float, 8, 2>(float const*)", 60, 5, 13),
    kernel("void (anonymous namespace)::gn_bwd_cluster_kernel<float, __nv_bfloat16, 8, 1>(float)",
           65, 8, 12),
    kernel("gn_bwd_batch_sum_kernel(float const*, float*, float*, int, int)", 73, 1, 12),
    kernel("sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 80, 30),
    kernel("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>", 110, 7),
    kernel("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>", 117, 4),
    kernel("Memcpy HtoD (Pinned -> Device)", 100, 9, stream=9, cat="gpu_memcpy"),
    kernel("Memset (Device)", 125, 1, cat="gpu_memset"),
    kernel("some_other_kernel", 190, 10),
]


def roof(flops, nbytes, peak):
    return max(flops / peak, nbytes / tr.PEAK_BYTES) * 1e6


def test_views_of_a_hand_made_trace():
    s = tr.summarize({"traceEvents": EVENTS, "source": "hand"})
    assert (s.steps_per_dispatch, s.dispatches, s.steps) == (2, 1, 2)
    k = s.kernels
    assert [k[n]["launches"] for n in tr.KERNELS] == [1, 2, 1, 1, 0]
    assert [k[n]["device_us"] for n in tr.KERNELS] == [30, 20, 5, 9, 0]
    g = s.group_us
    assert g["acgan conv_norm_act (kernel 1)"] == 30 and g["acgan gn_act_bwd (kernel 4)"] == 9
    assert g["cuDNN / cuBLAS conv and GEMM"] == 30 and g["elementwise"] == 7
    assert g["copies and memsets"] == 4 + 9 + 1 and g["other"] == 10
    # Busy: the union of the device spans (the copy at 100-109 overlaps the
    # dgrad at 80-110); the window runs from the host span's start to the
    # last device event's end.
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in EVENTS
                   if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset"))
    covered = set()
    for a, b in spans:
        covered.update(range(a, b))
    assert s.busy_us == len(covered) and s.window_us == 200
    assert s.busy_share == pytest.approx(len(covered) / 200)
    # Kernel 1's roofline from ConvNormActFn's shapes (bf16, k4 s2 16 -> 8),
    # kernel 2's from ConvTransposeNormActFn's for its one shaped launch,
    # kernel 3's and 4's from their ops.
    k1 = roof(2 * 2 * 8 * 8 * 16 * 3 * 8, (2 * 16 * 16 * 3 + 16 * 3 * 8 + 2 * 8 * 8 * 8) * 2 + 64,
              tr.PEAK_BF16_FLOPS)
    assert k["conv_norm_act"]["roof_us"] == pytest.approx(k1)
    k2 = roof(2 * 2 * 8 * 8 * 16 * 8 * 4, (2 * 8 * 8 * 8 + 16 * 8 * 4 + 2 * 16 * 16 * 4) * 2 + 32,
              tr.PEAK_BF16_FLOPS)
    assert k["conv_transpose_norm_act"]["roof_us"] == pytest.approx(k2)
    assert k["conv_transpose_norm_act"]["roof_launches"] == 1  # the narrow one has no shapes
    n = 2 * 8 * 8 * 32
    assert k["group_norm_act"]["roof_us"] == pytest.approx(
        roof(10 * n, 2 * n * 4 + 8 * 32, tr.PEAK_F32_FLOPS))
    n = 2 * 8 * 8 * 8
    assert k["gn_act_bwd"]["roof_us"] == pytest.approx(
        roof(12 * n, n * (4 + 3 * 2) + 12 * 8, tr.PEAK_F32_FLOPS))
    rows = {(r.name[:40], r.group): r for r in s.rows}
    apply_rows = [r for r in s.rows if "gn_apply_kernel" in r.name]
    assert sorted(r.group for r in apply_rows) == [
        "acgan conv_norm_act (kernel 1)", "acgan conv_transpose_norm_act (kernel 2)"]
    assert sum(r.device_us for r in s.rows) == sum(g.values())
    assert all(r.roof_us is None for r in s.rows if not r.group.startswith("acgan"))
    assert rows and s.rows[0].device_us == 30


def test_cli_profile_report_writes_json(tmp_path, capsys):
    path = tmp_path / "trace_step8.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    out = tmp_path / "report.json"
    assert cli.main(["profile-report", "--out", str(path), "--json", str(out), "--top", "5"]) == 0
    text = capsys.readouterr().out
    assert "2 steps (1 calls x 2)" in text and "per step by group" in text
    report = json.loads(out.read_text())
    assert report["steps"] == 2 and report["kernels"]["gn_act_bwd"]["launches"] == 1
    assert len(report["rows"]) == 16


def test_cli_profile_report_missing_trace(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["profile-report", "--workdir", str(tmp_path)])
    assert e.value.code == 2
    assert "train --profile-steps" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["profile-report"])


def test_a_cpu_train_trace_has_no_device_kernel(tmp_path, capsys):
    """A tiny CPU ``train --profile-steps`` writes its trace with one
    acgan:train_call span a call; the report finds no device kernel and
    exits 1."""
    argv = ["--device", "cpu", "--preset", "config1", "--set", "train.batch_size=2",
            "--set", "model.image_size=16", "--set", "model.g_levels=2",
            "--set", "model.g_base_channels=8", "--set", "model.d_levels=2",
            "--set", "model.d_base_channels=8", "--set", "model.group_norm_groups=4",
            "--set", "train.steps_per_call=2", "--set", "train.log_every=100",
            "--set", "train.checkpoint_every=0", "--set", "train.sample_every=0",
            "--workdir", str(tmp_path)]
    assert cli.main(["train", *argv, "--steps", "10", "--profile-steps", "2"]) == 0
    capsys.readouterr()
    trace = tr.load_trace(str(tmp_path / "profile"))
    s = tr.summarize(trace)
    assert trace["source"].endswith("trace_step8.json")
    assert (s.dispatches, s.steps_per_dispatch, s.rows, s.busy_us) == (1, 2, [], 0.0)
    assert cli.main(["profile-report", "--workdir", str(tmp_path)]) == 1
    assert "no device kernel" in capsys.readouterr().out


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    """``utils/profiling``: a trace of the enclosed work written where
    ``load_trace`` finds it, with an ``acgan:`` span of each ``span`` in it,
    and the spans' records, which time the blocks."""
    from action_conditioned_gans_tpu_torch.utils import profiling

    profiling.reset()
    with profiling.trace(str(tmp_path), device="cpu"):
        for _ in range(3):
            with profiling.span("train_call[k=4]", k=4):
                torch.ones(8, 8) @ torch.ones(8, 8)
    recs = profiling.records()
    assert [(r.name, r.attrs) for r in recs] == [("train_call[k=4]", {"k": 4})] * 3
    assert all(r.host_ms > 0 and r.device_ms is None for r in recs)
    s = tr.summarize(tr.load_trace(str(tmp_path)))
    assert (s.dispatches, s.steps_per_dispatch, s.steps, s.rows) == (3, 4, 12, [])


def host_span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid, "args": {}}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def device_event(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"stream": 7, "correlation": corr}}


PHASE_EVENTS = [
    host_span("acgan:train_call[k=1]", 0, 300),
    host_span("acgan:step", 0, 200),
    host_span("acgan:step.g_rollout", 0, 50),
    host_span("acgan:step.d_update", 50, 70),
    host_span("acgan:step.g_adam", 120, 80),
    host_span("bench:call", 0, 300),  # not the program's: names nothing
    launch(10, 1), launch(60, 2, tid=2), launch(130, 3), launch(250, 4),
    # The device runs behind the host: each event after its launch.
    device_event("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 20, 20, 1),
    device_event("Memcpy DtoD (Device -> Device)", 70, 10, 2, cat="gpu_memcpy"),
    device_event("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
                 140, 10, 3),
    device_event("Memset (Device)", 150, 5, 99, cat="gpu_memset"),  # no launch matched
    device_event("some_other_kernel", 260, 10, 4),
]


def test_idle_gaps_named_and_device_time_split_by_acgan_span():
    s = tr.summarize({"traceEvents": PHASE_EVENTS})
    # Gaps 40-70, 80-140 and 155-260, each named by the innermost acgan:
    # span open on the host when it began.
    assert s.idle_us_by_span == {"step.g_rollout": 30, "step.d_update": 60, "step.g_adam": 105}
    assert s.idle_gaps == [("step.g_adam", 105), ("step.d_update", 60), ("step.g_rollout", 30)]
    # Each event charged to the innermost span open at its launch (the
    # launch at 250 falls in the call span alone; the one at 60, from a
    # thread with no span, like autograd's engine, to the span open on the
    # other); an event with no launch matched to NO_SPAN.
    assert s.phase_group_us == {
        "step.g_rollout": {"cuDNN / cuBLAS conv and GEMM": 20},
        "step.d_update": {"copies and memsets": 10},
        "step.g_adam": {"elementwise": 10},
        "train_call[k=1]": {"other": 10},
        tr.NO_SPAN: {"copies and memsets": 5},
    }
    assert sum(sum(g.values()) for g in s.phase_group_us.values()) == sum(s.group_us.values())


def test_the_report_prints_the_two_views(tmp_path, capsys):
    path = tmp_path / "trace_step1.json"
    path.write_text(json.dumps({"traceEvents": PHASE_EVENTS}))
    assert cli.main(["profile-report", "--out", str(path)]) == 0
    text = capsys.readouterr().out
    assert "idle gaps per step by the acgan: span" in text
    assert "device time per step by the acgan: span that launched it" in text
    lines = [line.split() for line in text.splitlines()]
    assert ["105.0", "step.g_adam"] in lines
    assert ["20.0", "20.0", "0.0", "0.0", "0.0", "step.g_rollout"] in lines
