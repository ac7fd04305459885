"""Device time by kernel in a ``torch.profiler`` chrome trace: the port's
counterpart of the JAX package's ``utils/xplane.py``, which reads
``jax.profiler`` xplane traces of the TPU.

``train --profile-steps N`` writes ``<workdir>/profile/trace_step<S>.json``
(``train/loop.py``), with one ``acgan:train_call[k=K]`` span a call. This
module reads the newest such trace and gives xplane's views: every device
kernel (and copy, and memset) with its count, device µs and share of the
busy time; the same by group (the five ``acgan`` kernels by symbol, cuDNN and
cuBLAS convolutions and GEMMs, elementwise, copies and memsets, other); the
steps a call (the spans' K) and a step's share of each; and the device's
busy share of the traced window.

Two views by the program's own ``acgan:`` spans (``utils/profiling.py``:
the call, each step and its phases, a serving request and its parts):
the device's idle gaps, each named by the innermost ``acgan:`` span open
on the host when it began (where the host was while the device waited);
and device time by phase and group, each device event charged to the
innermost ``acgan:`` span open on its host thread when it was launched
(its runtime event of the same ``correlation``), or on any thread where
its own holds none (autograd's engine launches the backward from threads
of its own), so that copies and memsets, say, are split by the phase that
issued them.

Kernels 1 and 2 share their GEMM and GroupNorm epilogue kernels'
names; the GEMM's first template argument (``TRANSPOSE``) tells them apart,
and an epilogue kernel belongs to the last conv kernel before it on its
stream. A kernel's ``launches`` count one wrapper call each (the GEMM, the
narrow conv-transpose, or the cluster kernel), as the wrappers' launch
counters do. A row of kernels 1-4 carries a roofline time (its FLOPs over
the bf16 or float32 peak, or its bytes over the memory rate, whichever is
longer, as ``chip_smoke.py`` reckons its bounds) when the trace holds the
shapes of the autograd op that launched it (``record_shapes``, as the loop
records them); otherwise, and for every other row, it is null. Kernel 5
(``adam_flat``, the fused Adam of ``train.flatten_optimizer``) is launched
outside autograd, so its rows carry no roofline.

Consumed by ``python -m action_conditioned_gans_tpu_torch profile-report``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

# H100 SXM peaks (NVIDIA's data sheet), as chip_smoke.py and bench.py take them.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNELS = (
    "conv_norm_act", "conv_transpose_norm_act", "group_norm_act", "gn_act_bwd", "adam_flat")
GROUPS = tuple(f"acgan {k} (kernel {i})" for i, k in enumerate(KERNELS, 1)) + (
    "cuDNN / cuBLAS conv and GEMM", "elementwise", "copies and memsets", "other")
_CONV = re.compile(r"conv_(?:wgmma|wmma|fma)_kernel<(true|false)")
_PACK = re.compile(r"pack_weights_kernel<(true|false)>")
_LIBRARY = re.compile(r"cudnn|cutlass|xmma|gemm|cublas|implicit_convolve|winograd|dgrad|wgrad|"
                      r"fprop|nhwcAddPadding|nchwToNhwc|nhwcToNchw|sm\d\d_", re.IGNORECASE)
_CALL = re.compile(r"^acgan:train_call\[k=(\d+)\]$")
_SPAN_PREFIX = "acgan:"
NO_SPAN = "no acgan span"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Row:
    """One device kernel name (or copy, or memset) over the trace."""

    name: str
    group: str
    count: int
    device_us: float
    share_of_busy: float
    roof_us: Optional[float] = None  # kernels 1, 2 and 4 only, when the shapes are known


@dataclasses.dataclass
class Summary:
    source: str
    steps_per_dispatch: int
    dispatches: Optional[int]  # acgan:train_call spans in the trace; None without them
    window_us: float
    busy_us: float
    busy_share: float
    rows: List[Row]
    group_us: Dict[str, float]
    # kernels 1-5: launches, device_us, and roof_us summed over the
    # roof_launches whose shapes the trace holds (None when it holds none)
    kernels: Dict[str, Dict[str, float]]
    # idle µs between the first and the last device event by the innermost
    # acgan: span open when each gap began (NO_SPAN outside them), and the
    # longest gaps, longest first
    idle_us_by_span: Dict[str, float] = dataclasses.field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    # device µs by the acgan: span that launched each event (without the
    # prefix; NO_SPAN where none was open or no launch matched), by group
    phase_group_us: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    @property
    def steps(self) -> Optional[int]:
        return None if self.dispatches is None else self.dispatches * self.steps_per_dispatch


def load_trace(path: str) -> dict:
    """The trace at ``path``: a chrome trace file, or the newest
    ``*.json`` in a directory (or in its ``profile/``)."""
    if os.path.isfile(path):
        found = [path]
    else:
        found = (glob.glob(os.path.join(path, "*.json"))
                 or glob.glob(os.path.join(path, "profile", "*.json")))
    if not found:
        raise FileNotFoundError(f"no chrome trace (*.json) under {path}")
    newest = max(found, key=os.path.getmtime)
    with open(newest) as f:
        trace = json.load(f)
    trace.setdefault("source", newest)
    return trace


def _owner(name: str) -> Optional[str]:
    """The acgan kernel a device kernel belongs to by its symbol; "epilogue"
    for the GroupNorm kernels kernels 1 and 2 share."""
    if "adam_flat_kernel" in name:
        return "adam_flat"
    if "gn_bwd_cluster_kernel" in name or "gn_bwd_batch_sum_kernel" in name:
        return "gn_act_bwd"
    if "gn_cluster_kernel" in name:
        return "group_norm_act"
    if "narrow_transpose_kernel" in name:
        return "conv_transpose_norm_act"
    m = _CONV.search(name) or _PACK.search(name)
    if m:
        return "conv_transpose_norm_act" if m.group(1) == "true" else "conv_norm_act"
    if "gn_stats_kernel" in name or "gn_apply_kernel" in name:
        return "epilogue"
    return None


def _primary(name: str) -> bool:
    """Whether a kernel is the one launch a wrapper call counts."""
    return bool(_CONV.search(name)) or any(k in name for k in (
        "narrow_transpose_kernel", "gn_cluster_kernel", "gn_bwd_cluster_kernel",
        "adam_flat_kernel"))


def _group(event: dict, owner: Optional[str]) -> str:
    if owner in KERNELS:
        return GROUPS[KERNELS.index(owner)]
    name = event["name"]
    if event.get("cat") in ("gpu_memcpy", "gpu_memset") or "copy" in name.lower() or (
            name.startswith(("Memcpy", "Memset"))):
        return "copies and memsets"
    if _LIBRARY.search(name):
        return "cuDNN / cuBLAS conv and GEMM"
    if "elementwise_kernel" in name or "reduce_kernel" in name or "at::native::" in name:
        return "elementwise"
    return "other"


def _itemsize(type_name: str) -> int:
    return 2 if type_name in ("c10::BFloat16", "c10::Half") else 4


_FUSED = {"ConvNormActFn": "conv_norm_act", "ConvTransposeNormActFn": "conv_transpose_norm_act"}


def _roofline_us(owner: str, op: Optional[dict]) -> Optional[float]:
    """The least time of one call, from the shapes of the autograd op that
    launched it: ``ConvNormActFn`` / ``ConvTransposeNormActFn`` (kernels 1
    and 2: x and w), ``GroupNormActFn`` (kernel 3: x) or their backward
    (kernel 4: the output's gradient, y float32 behind a fused block and in
    the gradient's dtype behind a split one)."""
    if op is None:
        return None
    args = op.get("args", {})
    dims, types = args.get("Input Dims") or [], args.get("Input type") or []
    name = op.get("name", "")
    if not dims or len(dims[0]) != 4:
        return None
    item = _itemsize(types[0]) if types else 4
    if _FUSED.get(name) == owner:
        if len(dims) < 2 or len(dims[1]) != 4:
            return None
        (b, h, w, cin), (kh, kw, _, cout) = dims[0], dims[1]
        if owner == "conv_transpose_norm_act":
            oh, ow = 2 * h, 2 * w
            flops = 2 * b * h * w * kh * kw * cin * cout
        else:
            stride = 2 if kh == 4 else 1  # the model's SAME convs: k4 s2 and k3 s1
            oh, ow = -(-h // stride), -(-w // stride)
            flops = 2 * b * oh * ow * kh * kw * cin * cout
        nbytes = (b * h * w * cin + kh * kw * cin * cout + b * oh * ow * cout) * item
        nbytes += 2 * cout * 4
        peak = PEAK_BF16_FLOPS if item == 2 else PEAK_F32_FLOPS
        return max(flops / peak, nbytes / PEAK_BYTES) * 1e6
    b, h, w, c = dims[0]
    n = b * h * w * c
    if owner == "group_norm_act" and name == "GroupNormActFn":
        return max(10 * n / PEAK_F32_FLOPS, (2 * n * item + 8 * c) / PEAK_BYTES) * 1e6
    if owner == "gn_act_bwd" and name in ("ConvNormActFnBackward",
                                          "ConvTransposeNormActFnBackward",
                                          "GroupNormActFnBackward"):
        y_item = item if name.startswith("GroupNorm") else 4
        nbytes = n * (y_item + 3 * item) + 12 * c
        return max(12 * n / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e6
    return None


def _union_us(spans) -> float:
    total, end = 0.0, None
    for start, stop in sorted(spans):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


class _Spans:
    """The trace's ``acgan:`` host spans by thread: the innermost one open
    at a time."""

    def __init__(self, events: List[dict]):
        self.by_tid: Dict[object, List[tuple]] = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith(_SPAN_PREFIX):
                ts = float(e["ts"])
                self.by_tid[e.get("tid")].append((ts, ts + float(e.get("dur", 0.0)),
                                                  e["name"][len(_SPAN_PREFIX):]))
        self.starts = {}
        for tid, spans in self.by_tid.items():
            spans.sort(key=lambda s: (s[0], -s[1]))  # of two that start together, inner last
            self.starts[tid] = [s[0] for s in spans]

    def _inner(self, tid, at: float) -> Optional[tuple]:
        spans = self.by_tid.get(tid, [])
        # Spans on one thread nest: the latest-starting one that holds ``at``.
        for i in range(bisect.bisect_right(self.starts.get(tid, []), at) - 1, -1, -1):
            if spans[i][1] > at:
                return spans[i]
        return None

    def at(self, at: float, tid=None) -> str:
        """The innermost span open at ``at`` on thread ``tid``; where there
        is none (autograd's engine launches a backward from a thread of its
        own while the span's thread waits in it), or with no ``tid``, the
        shortest of those open on any thread."""
        found = self._inner(tid, at) if tid is not None else None
        if found is None:
            inner = [s for s in (self._inner(t, at) for t in self.by_tid) if s is not None]
            found = min(inner, key=lambda s: s[1] - s[0], default=None)
        return found[2] if found else NO_SPAN


def _gaps(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    gaps, at = [], lo
    for start, stop in sorted(spans):
        if start > at:
            gaps.append((at, min(start, hi)))
        at = max(at, stop)
        if at >= hi:
            break
    return [(a, b) for a, b in gaps if b > a]


def summarize(trace: dict) -> Summary:
    """The views of one trace (see the module's docstring)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # The host's spans (the trace also projects them onto the device's
    # timeline as gpu_user_annotation events).
    calls = [e for e in events
             if e.get("cat") == "user_annotation" and _CALL.match(e.get("name", ""))]
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    k = int(_CALL.match(calls[0]["name"]).group(1)) if calls else 1

    # (name, group) -> [count, device µs, roofline µs, roofline known]: an
    # epilogue kernel's name has a row under kernel 1 and one under kernel 2.
    by_row: Dict[tuple, list] = collections.defaultdict(lambda: [0, 0.0, 0.0, False])
    groups: Dict[str, float] = collections.Counter()
    kernels = {name: {"launches": 0, "device_us": 0.0, "roof_us": 0.0, "roof_launches": 0}
               for name in KERNELS}
    last_conv: Dict[object, str] = {}
    device.sort(key=lambda e: (str(e.get("args", {}).get("stream")), e["ts"]))
    device_groups = []  # (group, µs) of each event of ``device``
    for e in device:
        name, dur = e["name"], float(e.get("dur", 0.0))
        owner = _owner(name) if e.get("cat") == "kernel" else None
        stream = e.get("args", {}).get("stream")
        if owner == "epilogue":
            owner = last_conv.get(stream)
        elif owner in ("conv_norm_act", "conv_transpose_norm_act"):
            last_conv[stream] = owner
        group = _group(e, owner)
        device_groups.append((group, dur))
        row = by_row[(name, group)]
        row[0] += 1
        row[1] += dur
        groups[group] += dur
        if owner in kernels:
            kernels[owner]["device_us"] += dur
            if _primary(name):
                kernels[owner]["launches"] += 1
                roof = _roofline_us(owner, ops.get(e.get("args", {}).get("External id")))
                if roof is not None:
                    kernels[owner]["roof_us"] += roof
                    kernels[owner]["roof_launches"] += 1
                    row[2] += roof
                    row[3] = True
    for totals in kernels.values():
        if not totals["roof_launches"]:
            totals["roof_us"] = None

    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in device]
    busy = _union_us(spans)
    named = _Spans(events)
    idle_by_span: Dict[str, float] = collections.Counter()
    gaps = []
    if spans:
        for a, b in _gaps(spans, min(s for s, _ in spans), max(s for _, s in spans)):
            name = named.at(a)
            idle_by_span[name] += b - a
            gaps.append((name, b - a))
    gaps.sort(key=lambda g: -g[1])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    by_phase: Dict[str, Dict[str, float]] = collections.defaultdict(collections.Counter)
    for e, (group, dur) in zip(device, device_groups):
        launch = launches.get(e.get("args", {}).get("correlation"))
        phase = NO_SPAN if launch is None else named.at(float(launch["ts"]), launch.get("tid"))
        by_phase[phase][group] += dur
    edges = spans + [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in calls]
    window = (max(s for _, s in edges) - min(s for s, _ in edges)) if edges else 0.0
    rows = [Row(name=name, group=group, count=c, device_us=t,
                share_of_busy=t / busy if busy else 0.0, roof_us=roof if has_roof else None)
            for (name, group), (c, t, roof, has_roof) in by_row.items()]
    rows.sort(key=lambda r: -r.device_us)
    return Summary(source=trace.get("source", ""), steps_per_dispatch=k,
                   dispatches=len(calls) if calls else None, window_us=window, busy_us=busy,
                   busy_share=busy / window if window else 0.0, rows=rows,
                   group_us={g: groups.get(g, 0.0) for g in GROUPS}, kernels=kernels,
                   idle_us_by_span=dict(idle_by_span), idle_gaps=gaps[:10],
                   phase_group_us={p: dict(g) for p, g in by_phase.items()})


def print_summary(s: Summary, top_n: int = 30) -> None:
    """xplane's views, as text."""
    per = f"{s.steps} steps ({s.dispatches} calls x {s.steps_per_dispatch})" if s.steps else (
        "no acgan:train_call span: totals over the trace")
    print(f"== {s.source} | {per} | device busy {s.busy_us / 1e3:.3f} ms of a "
          f"{s.window_us / 1e3:.3f} ms window ({100 * s.busy_share:.1f}%) ==")
    steps = s.steps or 1
    print(f"{'us/step':>10} {'count':>6} {'busy%':>6} {'roof_us':>9}  kernel | group")
    for r in s.rows[:top_n]:
        roof = f"{r.roof_us / steps:9.1f}" if r.roof_us is not None else f"{'-':>9}"
        print(f"{r.device_us / steps:10.1f} {r.count:6d} {100 * r.share_of_busy:6.2f} {roof}  "
              f"{r.name[:100]} | {r.group}")
    print("\nper step by group (us):")
    for g, v in sorted(s.group_us.items(), key=lambda kv: -kv[1]):
        print(f"  {v / steps:10.1f}  {g}")
    print("acgan kernels per step (launches, device us; roofline us over the launches whose "
          "shapes the trace holds):")
    for name, k in s.kernels.items():
        roof = (f"{k['roof_us'] / steps:.1f} over {k['roof_launches']}"
                if k["roof_us"] is not None else "null")
        print(f"  {name:24s} {k['launches'] / steps:7.2f} {k['device_us'] / steps:10.1f}  {roof}")
    if s.idle_us_by_span:
        idle = sum(s.idle_us_by_span.values())
        print(f"\nidle gaps per step by the acgan: span open when each began (us; {idle / steps:.1f}"
              f" in all); longest: " + ", ".join(f"{n} {v:.1f}" for n, v in s.idle_gaps[:5]))
        for name, v in sorted(s.idle_us_by_span.items(), key=lambda kv: -kv[1]):
            print(f"  {v / steps:10.1f}  {name}")
    if s.phase_group_us:
        shown = [g for g in GROUPS if any(p.get(g) for p in s.phase_group_us.values())]
        print("\ndevice time per step by the acgan: span that launched it, by group (us):")
        print(f"{'total':>10}  " + "  ".join(f"{g[:14]:>14}" for g in shown) + "  span")
        for name, g in sorted(s.phase_group_us.items(), key=lambda kv: -sum(kv[1].values())):
            print(f"{sum(g.values()) / steps:10.1f}  "
                  + "  ".join(f"{g.get(x, 0.0) / steps:14.1f}" for x in shown) + f"  {name}")
