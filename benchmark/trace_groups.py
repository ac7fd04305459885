"""Device time by group, kernels 1-4's share of their roofline, the device's
busy time and its idle gaps, from a ``torch.profiler`` chrome trace.

A frozen copy of the program's ``utils/trace_report.py`` (its kernel
groups by symbol, its attribution of the shared GroupNorm epilogue kernels
to the conv kernel before them on their stream, the roofline of kernels 1-4
from the shapes of the autograd op that launched them, the union of busy
intervals), kept here so that a change to the program cannot move the
yardstick. Its operation and byte counts are ``flops.py``'s.

Extended for the serving path: under ``no_grad`` the program launches
kernels 1-3 straight from their wrappers, through no autograd op and, when
it is not exporting, through no ``acgan::`` custom op either, so the trace
holds no op with the launch's shapes. For such a launch the reader goes to
the host thread that launched it (the runtime event of the same
``correlation``) and reads the shapes from the last allocations before the
launch, which ``record_shapes`` records with their sizes: kernels 1 and 2
allocate their output ``(b, oh, ow, cout)`` with ``aten::empty`` after
casting the weights ``(kh, kw, cin, cout)`` with ``aten::to``; kernel 3
allocates its output with ``aten::empty_like`` of its input ``(b, h, w, c)``.
A launch whose shapes are found neither way is counted as unmatched, and a
kernel with unmatched launches is left out of the share.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

from benchmark import flops

KERNELS = ("conv_norm_act", "conv_transpose_norm_act", "group_norm_act", "gn_act_bwd", "adam_flat")
ROOFLINE_KERNELS = KERNELS[:4]
GROUPS = tuple(f"acgan {k} (kernel {i})" for i, k in enumerate(KERNELS, 1)) + (
    "cuDNN / cuBLAS conv and GEMM", "elementwise", "copies and memsets", "other")
_CONV = re.compile(r"conv_(?:wgmma|wmma|fma)_kernel<(true|false)")
_PACK = re.compile(r"pack_weights_kernel<(true|false)>")
_LIBRARY = re.compile(r"cudnn|cutlass|xmma|gemm|cublas|implicit_convolve|winograd|dgrad|wgrad|"
                      r"fprop|nhwcAddPadding|nchwToNhwc|nhwcToNchw|sm\d\d_", re.IGNORECASE)
_FUSED = {"ConvNormActFn": "conv_norm_act", "ConvTransposeNormActFn": "conv_transpose_norm_act"}
_BWD = ("ConvNormActFnBackward", "ConvTransposeNormActFnBackward", "GroupNormActFnBackward")
# The dtype codes record_shapes writes for an allocation's dtype argument.
_DTYPE_ITEMSIZE = {"15": 2, "5": 2, "6": 4}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def owner(name: str) -> Optional[str]:
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


def primary(name: str) -> bool:
    """Whether a kernel is the one launch a wrapper call counts."""
    return bool(_CONV.search(name)) or any(k in name for k in (
        "narrow_transpose_kernel", "gn_cluster_kernel", "gn_bwd_cluster_kernel",
        "adam_flat_kernel"))


def group_of(event: dict, own: Optional[str]) -> str:
    if own in KERNELS:
        return GROUPS[KERNELS.index(own)]
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


def roofline_from_op(own: str, op: Optional[dict]) -> Optional[float]:
    """A launch's bound in seconds from the autograd op that launched it:
    ``ConvNormActFn`` / ``ConvTransposeNormActFn`` (kernels 1 and 2: x and
    w), ``GroupNormActFn`` (kernel 3: x) or their backward (kernel 4: the
    output's gradient; y float32 behind a fused block, in the gradient's
    dtype behind a split one)."""
    if op is None:
        return None
    args = op.get("args", {})
    dims, types = args.get("Input Dims") or [], args.get("Input type") or []
    name = op.get("name", "")
    if not dims or len(dims[0]) != 4:
        return None
    item = _itemsize(types[0]) if types else 4
    if _FUSED.get(name) == own:
        if len(dims) < 2 or len(dims[1]) != 4:
            return None
        (b, h, w, cin), (k, _, _, cout) = dims[0], dims[1]
        return flops.conv_cost(b, h, w, cin, k, cout, 2 if k == 4 else 1,
                               own == "conv_transpose_norm_act", item)
    b, h, w, c = dims[0]
    if own == "group_norm_act" and name == "GroupNormActFn":
        return flops.gn_cost(b, h, w, c, item)
    if own == "gn_act_bwd" and name in _BWD:
        return flops.gn_bwd_cost(b, h, w, c, item, item if name.startswith("GroupNorm") else 4)
    return None


def _sizes(text: str) -> Optional[List[int]]:
    try:
        value = json.loads(text)
    except (TypeError, ValueError):
        return None
    return value if isinstance(value, list) and all(isinstance(v, int) for v in value) else None


def roofline_from_host(own: str, before: List[dict]) -> Optional[float]:
    """A no-grad launch's bound from the allocations its wrapper made before
    it on its host thread (``before``: that thread's ops since the launch of
    kernels 1-4 before it, newest last); see the module's docstring."""
    out = weight = None
    for op in reversed(before):
        args = op.get("args", {})
        dims = args.get("Input Dims") or [[]]
        name = op.get("name", "")
        if own == "group_norm_act":
            if name == "aten::empty_like" and len(dims[0]) == 4:
                return flops.gn_cost(*dims[0], _itemsize((args.get("Input type") or [""])[0]))
            continue
        concrete = args.get("Concrete Inputs") or []
        if out is None and name == "aten::empty" and concrete:
            sizes = _sizes(concrete[0])
            if sizes and len(sizes) == 4 and len(concrete) > 1 and concrete[1] in _DTYPE_ITEMSIZE:
                out = (sizes, _DTYPE_ITEMSIZE[concrete[1]])
        elif out is not None and name == "aten::to" and len(dims[0]) == 4:
            weight = dims[0]
            break
    if out is None or weight is None:
        return None
    (b, oh, ow, cout), item = out
    k, _, cin, _ = weight
    if own == "conv_transpose_norm_act":
        return flops.conv_cost(b, oh // 2, ow // 2, cin, k, cout, 2, True, item)
    stride = 2 if k == 4 else 1
    return flops.conv_cost(b, oh * stride, ow * stride, cin, k, cout, stride, False, item)


def union_s(spans) -> float:
    total, end = 0.0, None
    for start, stop in sorted(spans):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def _gaps(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    gaps, at = [], lo
    for start, stop in sorted(spans):
        if start > at:
            gaps.append((at, min(start, hi)))
        at = max(at, stop)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]


@dataclasses.dataclass
class Summary:
    """One traced window: its length and the device's busy time in it
    (seconds), device seconds by group, kernels 1-5's launches, device
    seconds and bounds (over the launches whose shapes were found), and the
    longest idle gaps named by the host span they fell in."""

    window_s: float
    busy_s: float
    group_s: Dict[str, float]
    kernels: Dict[str, Dict[str, float]]
    idle_gaps: List[Tuple[str, float]]

    @property
    def library_s(self) -> float:
        """Device seconds of everything but the port's own kernels:
        cuDNN, cuBLAS and torch's kernels, copies and memsets."""
        return sum(s for g, s in self.group_s.items() if not g.startswith("acgan "))

    def roofline_share(self) -> Optional[float]:
        """Sum of bounds over sum of device seconds of kernels 1-4, over the
        kernels whose every launch was matched to its shapes; None when
        none was."""
        roof = busy = 0.0
        for name in ROOFLINE_KERNELS:
            k = self.kernels[name]
            if k["launches"] and k["matched"] == k["launches"]:
                roof += k["roof_s"]
                busy += k["device_s"]
        return roof / busy if busy else None


def summarize(trace: dict, window_span: Optional[str], span_prefix: str = "bench:") -> Summary:
    """The views of one trace, inside the host span named ``window_span``
    (the traced stretch; the device's clock is the host's in the trace), or
    with None over the whole trace, from its first device event to its
    last. Idle gaps are named by the innermost host span starting with
    ``span_prefix`` that was open when the gap began."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(span_prefix)]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    win = [e for e in spans if e["name"] == window_span]
    if win:
        lo = float(win[0]["ts"])
        hi = lo + float(win[0].get("dur", 0.0))
    elif window_span is None:
        lo = min((float(e["ts"]) for e in device), default=0.0)
        hi = max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in device), default=0.0)
    else:
        raise ValueError(f"the trace holds no {window_span!r} span")
    device = [e for e in device if lo <= float(e["ts"]) < hi or window_span is None]
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    by_thread: Dict[object, List[dict]] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread[e.get("tid")].append(e)
    starts = {}
    for tid, evs in by_thread.items():
        evs.sort(key=lambda e: float(e["ts"]))
        starts[tid] = [float(e["ts"]) for e in evs]
    # Each thread's launches of kernels 1-4's primary kernels: a launch's
    # allocations lie after the one before it.
    primaries = {e["args"].get("correlation") for e in device
                 if primary(e["name"]) and owner(e["name"]) in ROOFLINE_KERNELS}
    primary_launches: Dict[object, List[float]] = collections.defaultdict(list)
    for corr, e in launches.items():
        if corr in primaries:
            primary_launches[e.get("tid")].append(float(e["ts"]))
    for times in primary_launches.values():
        times.sort()

    groups: Dict[str, float] = collections.Counter()
    kernels = {name: {"launches": 0, "matched": 0, "device_s": 0.0, "roof_s": 0.0}
               for name in KERNELS}
    last_conv: Dict[object, str] = {}
    for e in sorted(device, key=lambda e: (str(e.get("args", {}).get("stream")), e["ts"])):
        name, dur = e["name"], float(e.get("dur", 0.0)) * 1e-6
        args = e.get("args", {})
        own = owner(name) if e.get("cat") == "kernel" else None
        stream = args.get("stream")
        if own == "epilogue":
            own = last_conv.get(stream)
        elif own in ("conv_norm_act", "conv_transpose_norm_act"):
            last_conv[stream] = own
        groups[group_of(e, own)] += dur
        if own not in kernels:
            continue
        kernels[own]["device_s"] += dur
        if not primary(name):
            continue
        kernels[own]["launches"] += 1
        roof = roofline_from_op(own, ops.get(args.get("External id")))
        if roof is None and own in ROOFLINE_KERNELS:
            launch = launches.get(args.get("correlation"))
            if launch is not None:
                tid, at = launch.get("tid"), float(launch["ts"])
                before = primary_launches[tid][:bisect.bisect_left(primary_launches[tid], at)]
                lo_i = bisect.bisect_right(starts.get(tid, []), before[-1]) if before else 0
                hi_i = bisect.bisect_left(starts.get(tid, []), at)
                roof = roofline_from_host(own, by_thread.get(tid, [])[lo_i:hi_i])
        if roof is not None:
            kernels[own]["matched"] += 1
            kernels[own]["roof_s"] += roof

    busy_spans = [(float(e["ts"]), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi))
                  for e in device]
    busy = union_s(busy_spans) * 1e-6
    named = []
    for a, b in _gaps(busy_spans, lo, hi):
        open_spans = [s for s in spans if s["name"] != window_span
                      and float(s["ts"]) <= a < float(s["ts"]) + float(s.get("dur", 0.0))]
        inner = min(open_spans, key=lambda s: float(s.get("dur", 0.0)), default=None)
        named.append((inner["name"] if inner else "no bench span", (b - a) * 1e-6))
    named.sort(key=lambda g: -g[1])
    return Summary(window_s=(hi - lo) * 1e-6, busy_s=busy,
                   group_s={g: groups.get(g, 0.0) for g in GROUPS}, kernels=kernels,
                   idle_gaps=named[:10])
