"""``doctor`` (``utils/doctor.py``) on the CPU, as tests/test_doctor.py
tests the JAX package's: each check in a process of its own with a
timeout, a hung, crashed or silent check diagnosed, the data and
checkpoint checks, and the CLI's report and exit code."""

import dataclasses
import json
import subprocess
import sys

import torch

from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.config import get_preset
from action_conditioned_gans_tpu_torch.utils import doctor
from tests.test_torch_native_tfrecord import write_files

torch.set_num_threads(1)


def python(code):
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_probe_on_the_cpu(monkeypatch):
    info = doctor._probe({"device": "cpu"})
    assert info["ok"] and info["platform"] == "cpu", info
    monkeypatch.setattr(doctor, "_PROBE_WANT", 1.0)
    info = doctor._probe({"device": "cpu"})
    assert not info["ok"] and "wrong probe value (2097152.0" in info["error"]


def test_a_hung_crashed_or_silent_check_is_diagnosed():
    info = doctor._collect("device", python("import time; time.sleep(60)"), timeout=2)
    assert not info["ok"] and "hung past 2s" in info["error"]
    info = doctor._collect("device", python("import sys; sys.exit(7)"), timeout=60)
    assert not info["ok"] and "exited 7" in info["error"]
    info = doctor._collect("gxx", python("print('no json')"), timeout=60)
    assert not info["ok"] and "printed no JSON" in info["error"]
    info = doctor._collect("gxx", python("print('{\"ok\": true, \"v\": 1}')"), timeout=60)
    assert info == {"ok": True, "v": 1}


def file_args(cfg, path, **extra):
    return dict(data=dataclasses.asdict(cfg.data), action_dim=4, state_dim=3,
                workdir=str(path), device="cpu", dir=str(path), **extra)


def test_data_dir_checks(tmp_path):
    cfg = get_preset("config1")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, clip_len=6, raw_image_size=16,
                                               source="tfrecord_native"))
    r = doctor._data_dir(file_args(cfg, tmp_path))
    assert not r["ok"] and "no TFRecord files match" in r["error"]
    write_files(tmp_path, n=4, files=1)
    r = doctor._data_dir(file_args(cfg, tmp_path))
    assert r["ok"] and r["files"] == 1 and r["first_clip"]["frames"] == [6, 16, 16, 3], r
    (tmp_path / "c0.tfrecord").write_bytes(b"")
    r = doctor._data_dir(file_args(cfg, tmp_path))
    assert not r["ok"] and "contains no records" in r["error"]
    wrong = cfg.replace(data=dataclasses.replace(cfg.data, raw_image_size=8, tfrecord_encoding="raw"))
    write_files(tmp_path, n=4, files=1)
    r = doctor._data_dir(file_args(wrong, tmp_path))
    assert not r["ok"] and "first record unreadable" in r["error"]


def test_checkpoints_gate_states(tmp_path):
    args = {"workdir": str(tmp_path)}
    r = doctor._checkpoints(args)
    assert r["ok"] and "no checkpoint dir" in r["skipped"]
    (tmp_path / "checkpoints").mkdir()
    r = doctor._checkpoints(args)
    assert r["ok"] and "fresh run" in r["note"]
    (tmp_path / "checkpoints" / "8.tmp-123").mkdir()
    r = doctor._checkpoints(args)
    assert r["ok"] and "in progress" in r["note"]
    (tmp_path / "checkpoints" / "not-a-step").mkdir()
    r = doctor._checkpoints(args)
    assert not r["ok"] and "no numeric step" in r["error"]
    (tmp_path / "checkpoints" / "100").mkdir()
    r = doctor._checkpoints(args)
    assert r["ok"] and r["latest"] == 100


def test_cli_doctor_end_to_end(tmp_path, capsys):
    """Every check for real, in processes of their own; ``--device cpu`` is
    the probe's target, so nvcc and the kernels' build do not gate."""
    write_files(tmp_path / "data", n=4, files=1)
    sets = ["--set", "data.source=tfrecord_native", "--set", f"data.data_dir={tmp_path / 'data'}",
            "--set", "data.clip_len=6", "--set", "data.raw_image_size=16"]
    rc = cli.main(["doctor", "--device", "cpu", "--probe-timeout", "300", "--workdir",
                   str(tmp_path), *sets])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report
    assert report["ok"] and report["device"]["ok"] and report["device"]["platform"] == "cpu"
    assert report["native_lib"]["ok"] and report["native_lib"]["abi_version"] == 2
    assert report["data_dir"]["ok"] and report["data_dir"]["files"] == 1
    assert "eval_data_dir unset" in report["eval_data_dir"]["skipped"]
    assert report["kernels"]["skipped"].startswith("device=cpu")
    assert report["toolchain"]["gxx"]["ok"] and "nvcc" in report["toolchain"]
    assert report["versions"]["torch"] == torch.__version__.split("+")[0] or report["versions"]["torch"]
    assert report["checkpoints"]["skipped"].startswith("no checkpoint dir")
    # An eval split that holds no files fails the report: exit 1.
    rc = cli.main(["doctor", "--device", "cpu", "--workdir", str(tmp_path), *sets,
                   "--set", f"data.eval_data_dir={tmp_path / 'none'}"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and not report["ok"]
    assert "no TFRecord files match" in report["eval_data_dir"]["error"]
