"""Build the Hopper kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
root of the checkout, compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The hash covers every file in ``csrc/``, so an edited source never
loads a stale library. A build happens on first use; :func:`build_all`
starts one ``nvcc`` per source at once. ``ptxas -v`` reports each kernel's
registers, shared memory and spills; :func:`ptxas_report` reads them back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
KERNELS = ("conv_norm_act", "conv_transpose_norm_act", "group_norm_act", "gn_act_bwd", "adam_flat")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the Hopper "
            "kernels are built from source on the machine with the GPU"
        )
    return found


def _sources_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:12]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_sources_hash()}.so")


def _nvcc_command(name: str, out: str) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns {name: library path}. Raises with the compiler's output if any
    build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                _nvcc_command(name, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            with open(f"{paths[name]}.ptxas", "w") as f:
                f.write(log)
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: registers, spill_stores, spill_loads, smem} of
    library ``name`` as ``ptxas -v`` reported them when it was built."""
    with open(f"{library_path(name)}.ptxas") as f:
        log = f.read()
    report = {}
    for block in log.split("Compiling entry function '")[1:]:
        kernel = block.split("'", 1)[0]
        report[kernel] = {
            key: int(m[1]) if (m := re.search(pattern, block)) else 0
            for key, pattern in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("smem", r"(\d+) bytes smem"))
        }
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _declare(name, lib)
            _loaded[name] = lib
        return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name == "adam_flat":
        lib.acg_adam_flat.argtypes = (
            [_P] * 5  # p, g, mu, nu, norm (None without clipping)
            + [_I, ctypes.c_longlong]  # bf16 moments, n
            + [_F] * 9  # b1, 1 - b1, b2, 1 - b2, 1 / bc1, 1 / bc2, eps, -lr, clip
            + [_P]  # stream
        )
        lib.acg_adam_flat.restype = _I
        return
    if name == "gn_act_bwd":
        lib.acg_gn_bwd_plan.argtypes = [_I] * 6 + [_P]  # y_bytes, t_bytes, B, HW, C, groups, out
        lib.acg_gn_bwd_plan.restype = _I
        lib.acg_gn_bwd_max_active_clusters.argtypes = [_I] * 6  # y_bytes, t_bytes, B, HW, C, groups
        lib.acg_gn_bwd_max_active_clusters.restype = _I
        lib.acg_gn_bwd_scratch_floats.argtypes = [_I] * 2  # B, C
        lib.acg_gn_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.acg_gn_act_bwd.argtypes = (
            [_P] * 10  # y, out, g, scale, mean, rstd, dx, dscale, dbias, scratch
            + [_I] * 7  # y_bf16, bf16, B, HW, C, groups, act
            + [_F, _P]  # leak, stream
        )
        lib.acg_gn_act_bwd.restype = _I
        return
    if name == "group_norm_act":
        lib.acg_gn_plan.argtypes = [_I] * 5 + [_P]  # bf16, B, HW, C, groups, out (6 ints)
        lib.acg_gn_plan.restype = _I
        lib.acg_gn_max_active_clusters.argtypes = [_I] * 6  # bf16, B, HW, C, groups, cluster
        lib.acg_gn_max_active_clusters.restype = _I
        lib.acg_group_norm_act.argtypes = (
            [_P] * 5  # x, scale, bias, out, stats
            + [_I] * 5  # bf16, B, HW, C, groups
            + [_F, _I, _F, _P]  # eps, act, leak, stream
        )
        lib.acg_group_norm_act.restype = _I
        return
    if name == "conv_norm_act":
        lib.acg_conv_path.argtypes = [_I, _I, _I, _P]  # bf16, Cin, Cout, x
        lib.acg_conv_path.restype = _I
        lib.acg_conv_tiles.argtypes = [_I, _I, _I, _I, _P]  # bf16, Cin, Cout, OH*OW, x
        lib.acg_conv_tiles.restype = _I
        lib.acg_conv_norm_act.argtypes = (
            [_P] * 10  # x, w, wt, scale, bias, out, y, psum, psq, stats
            + [_I] * 14  # bf16, B, H, W, Cin, OH, OW, Cout, KH, KW, stride, pad_h, pad_w, group_norm
            + [_I, _F, _I, _F, _P]  # groups, eps, act, leak, stream
        )
        lib.acg_conv_norm_act.restype = _I
    elif name == "conv_transpose_norm_act":
        # bf16, Cin, Cout, group_norm, H, W, x
        for fn in (lib.acg_conv_transpose_path, lib.acg_conv_transpose_tiles):
            fn.argtypes = [_I] * 6 + [_P]
            fn.restype = _I
        lib.acg_conv_transpose_norm_act.argtypes = (
            [_P] * 10  # x, w, wt, scale, bias, out, y, psum, psq, stats
            + [_I] * 7  # bf16, B, H, W, Cin, Cout, group_norm
            + [_I, _F, _I, _F, _P]  # groups, eps, act, leak, stream
        )
        lib.acg_conv_transpose_norm_act.restype = _I
    else:
        raise KeyError(f"unknown kernel {name!r}")
