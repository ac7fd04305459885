"""The harness finds every cell, configuration, traffic mix, limit and
per-layer reader by its name in ``BENCHMARK.json``; the file keeps to the
benchmark's contract; the last line of a run has its shape, ``check`` last;
a run without a card, or in a directory that holds only the benchmark,
exits non-zero and prints no result."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, runners, trace_groups

from conftest import ROOT, tiny

torch.set_num_threads(2)
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_the_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        conf = harness.load_json(os.path.join(ROOT, c["file"]))
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert sorted(conf["changed"]) == sorted(c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])


def test_layers_are_named_as_perf_md_lists_them():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_everything_a_cell_names_is_found(cell):
    found = harness.find_cell(cell)
    assert callable(harness.runner(found["traffic"]["kind"]))
    assert harness.reference_module(found["config"]).train_steps
    assert found["limits"] and all(v > 0 for v in found["limits"].values())
    run = runners.Run(kind=found["traffic"]["kind"], setup_s=1, window_s=2.0, units=4,
                      attempted=4, failed=0, frames_per_unit=1, flops_per_unit=1e12,
                      end_to_end={}, spans={"call": [0.5], "rollout": [0.5]},
                      memory_peak_bytes=0, readings={})
    bare = runners.Run(**{**run.__dict__, "spans": {}, "units": 0, "window_s": 0.0})
    summary = trace_groups.Summary(busy_s=0.5, window_s=1.0, group_s={}, kernels={
        k: {"launches": 0, "matched": 0, "device_s": 0.0, "roof_s": 0.0}
        for k in trace_groups.KERNELS}, idle_gaps=[])
    traced = runners.Run(**{**run.__dict__, "trace": summary, "stretch_units": 2,
                            "stretch_s": 1.0})
    for m in found["per_layer"]:
        read = harness.reader(m["name"])
        assert read(bare) is None, m["name"]
        value = read(traced)
        if "roofline" in m["name"]:
            assert value is None, m["name"]  # no launch of kernels 1-4 in this trace
        else:
            assert isinstance(value, float), m["name"]


def test_one_reader_serves_every_suffix_and_idle_is_the_untraced_windows():
    run = runners.Run(kind="x", setup_s=1, window_s=2.0, units=4, attempted=4, failed=0,
                      frames_per_unit=1, flops_per_unit=1.0, end_to_end={}, spans={},
                      memory_peak_bytes=0, readings={}, stretch_units=2, stretch_s=3.0,
                      trace=trace_groups.Summary(busy_s=0.2, window_s=3.0, group_s={},
                                                 kernels={}, idle_gaps=[]))
    # 0.1 s busy a unit against 0.5 s a unit in the untraced window; the
    # traced stretch's own length (3 s) does not enter.
    assert harness.reader("device_idle_pct.train")(run) == pytest.approx(80.0)
    assert harness.reader("device_idle_pct.serve")(run) == pytest.approx(80.0)
    # 4 units of 1 FLOP in 2 s.
    assert harness.reader("mfu.train")(run) == pytest.approx(200 / 989e12)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.find_cell("config9.train")


@pytest.mark.parametrize("cell,trace", [("config5.train", 1), ("config5.serve", 0),
                                        ("config1.serve", 1)])
def test_the_last_line_has_its_shape(cell, trace):
    found = tiny(harness.find_cell(cell))
    line = harness.run_cell(cell, 2**33 + 1, 0.3, bool(trace), time.perf_counter(),
                            device="cpu", config=found["config"]["config"])
    line = json.loads(json.dumps(line))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "check"
    assert set(line) <= set(keys) | {"breakdown", "check"}
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    want = ({m["name"] for m in found["end_to_end"]} if not trace else
            {m["name"] for m in found["per_layer"]})
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and isinstance(v["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "config5.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); from benchmark import harness; "
            "print(harness.run_cell('config5.serve', 1, 0.1, False, time.perf_counter(), "
            "device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "action_conditioned_gans_tpu_torch" in out.stderr
