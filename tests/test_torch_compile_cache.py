"""``utils/compile_cache.py``: ``ACGAN_COMPILE_CACHE_DIR`` moves the kernel
(nvcc) and TFRecord library (g++) builds under one directory, which later
processes reuse; unset, nothing moves."""

import json
import os
import subprocess
import sys

import torch

from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt
from action_conditioned_gans_tpu_torch.ops.kernels import build
from action_conditioned_gans_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_knob_off_is_inert(monkeypatch):
    monkeypatch.delenv("ACGAN_COMPILE_CACHE_DIR", raising=False)
    before = (build.BUILD_DIR, nt.BUILD_DIR)
    assert maybe_enable_compile_cache() is None
    assert (build.BUILD_DIR, nt.BUILD_DIR) == before
    assert build.BUILD_DIR == os.path.join(REPO, "build", "kernels")
    assert nt.BUILD_DIR == os.path.join(REPO, "build", "native")


def test_the_builds_move_under_the_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)  # restored after the test
    monkeypatch.setattr(nt, "BUILD_DIR", nt.BUILD_DIR)
    monkeypatch.setattr(nt, "_lib", None)
    monkeypatch.setenv("ACGAN_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert maybe_enable_compile_cache(str(tmp_path / "cache")) == str(tmp_path / "cache")
    assert build.BUILD_DIR == str(tmp_path / "cache" / "kernels")
    assert build.library_path("gn_act_bwd").startswith(str(tmp_path / "cache" / "kernels"))
    nt.load_library()
    assert os.listdir(tmp_path / "cache" / "native") == [os.path.basename(nt.library_path())]
    assert maybe_enable_compile_cache() == str(tmp_path / "env")  # the variable, when no path


def test_the_cache_persists_across_processes(tmp_path):
    env = dict(os.environ, ACGAN_COMPILE_CACHE_DIR=str(tmp_path), PYTHONPATH=REPO)
    code = ("from action_conditioned_gans_tpu_torch.utils.compile_cache import "
            "maybe_enable_compile_cache as m; m(); "
            "from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt; "
            "nt.load_library(); print(nt.library_path())")
    first = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                           timeout=300, check=True).stdout.strip().splitlines()[-1]
    assert first.startswith(str(tmp_path / "native"))
    again = subprocess.run([sys.executable, "-m", "action_conditioned_gans_tpu_torch.utils.doctor",
                            "native_lib", "{}"], env=env, capture_output=True, text=True,
                           timeout=300, check=True).stdout.strip().splitlines()[-1]
    report = json.loads(again)
    assert report["ok"] and report["already_built"] and report["path"] == first
