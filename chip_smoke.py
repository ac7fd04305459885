"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a GPU

Phases, each of which fails the run (non-zero exit, no final line):

1. Print the card and its power limit; build every Hopper kernel from
   ``action_conditioned_gans_tpu_torch/csrc`` (one nvcc per source, in
   parallel).
2. Per-kernel parity at the seven config1 generator layer shapes (batch 8)
   and at four ragged shapes: float32 with TF32 off within 1e-3 abs + 1e-3
   rel of the plain PyTorch version; bfloat16 within 3e-2 abs of the plain
   version run in float32 on the same bfloat16 inputs (a bfloat16 plain
   version rounds its pre-norm conv output, which moves outputs near 4 by
   one bfloat16 step, 0.031).
3. The committed JAX fixture (tests/fixtures/torch_port_tiny_generator.npz)
   reproduced on cuda in float32 within 1e-3, and the full-width config1
   generator on cuda against the same weights on the CPU's plain path.
4. Serving at config1 width in bfloat16 with seeded weights: counts set to
   0, then Predictor.predict at B=128 and Predictor.rollout at T=10, B=16;
   every kernel must have launched 4 resp. 3 times per generator call.
   Then both are timed with CUDA events.
5. The port's HTTP server answers /healthz, /predict and /rollout (float32
   and uint8) with exactly the direct calls' results.
6. A ``kernels`` JSON line (per kernel: launches, max |err|, kernel, plain,
   bound and library times summed over one predict's calls at B=128), then
   the final line ``{"ok": true, "device": {...}}``.

Per-layer numbers are the ``layer`` lines of the output.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_tiny_generator.npz")
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_INFO = {
    "conv_norm_act": dict(
        source="action_conditioned_gans_tpu_torch/csrc/conv_norm_act.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/conv.py:177",
        per_call=4,
    ),
    "conv_transpose_norm_act": dict(
        source="action_conditioned_gans_tpu_torch/csrc/conv_transpose_norm_act.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/conv.py:392",
        per_call=3,
    ),
}


def say(*parts):
    print(*parts, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- layer shapes of the main path ---------------------------------------------


def capture_layers(predictor, frame, action):
    """(block name, ConvBlock, input shape) of every layer, as the main path
    calls them, recorded by forward pre-hooks during one predict."""
    seen = []
    hooks = [
        block.register_forward_pre_hook(
            lambda mod, args, name=name: seen.append((name, mod, tuple(args[0].shape)))
        )
        for name, block in predictor.generator.named_children()
    ]
    try:
        predictor.predict(frame, action)
    finally:
        for h in hooks:
            h.remove()
    return seen


def layer_inputs(block, shape, batch, dtype, seed):
    """Random operands for one layer: x ~ N(0, 1), w ~ N(0, 1/fan_in) so the
    conv output is O(1), scale ~ 1 + 0.1 N, bias ~ 0.1 N."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kh, kw, cin, cout = block.kernel.shape
    x = torch.randn((batch, *shape[1:]), generator=g, device="cuda").to(dtype)
    w = torch.randn((kh, kw, cin, cout), generator=g, device="cuda") / (kh * kw * cin) ** 0.5
    scale = 1 + 0.1 * torch.randn(cout, generator=g, device="cuda") if block.norm != "none" else None
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    return x, w, scale, bias


def kernel_call(block):
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    name = "conv_transpose_norm_act" if block.transpose else "conv_norm_act"
    kw = dict(stride=block.stride, kind=block.norm, groups=block.groups, act=block.act,
              leak=block.leak)
    kernel, plain = getattr(conv, name), getattr(conv, f"{name}_plain")
    return (
        name,
        lambda x, w, s, b: kernel(x, w, s, b, **kw),
        lambda x, w, s, b: plain(x, w, s, b, **kw),
    )


def library_call(block, x, w, scale, bias):
    """One cuDNN conv + F.group_norm + activation on channels-last views of
    the same operands: the yardstick, never called by the port."""
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups

    xn = x.permute(0, 3, 1, 2)
    if block.transpose:
        wt = w.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1).contiguous()
        conv = lambda: F.conv_transpose2d(xn, wt, stride=2, padding=1)  # noqa: E731
    else:
        wt = w.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        pad = (w.shape[0] - 1) // 2 if block.stride == 1 else 1
        conv = lambda: F.conv2d(xn, wt, stride=block.stride, padding=pad)  # noqa: E731
    acts = {"lrelu": lambda t: F.leaky_relu(t, block.leak), "relu": F.relu, "tanh": torch.tanh}

    def run():
        y = conv()
        if block.norm == "group":
            y = F.group_norm(y, resolve_groups(w.shape[3], block.groups), scale.to(y.dtype),
                             bias.to(y.dtype))
        else:
            y = y + bias.to(y.dtype)[:, None, None]
        return acts[block.act](y)

    return run


def work(block, shape, itemsize):
    """(FLOPs, bytes) one call needs: each input read once, the output
    written once."""
    b, h, w, cin = shape
    kh, kw, _, cout = block.kernel.shape
    if block.transpose:
        oh, ow = 2 * h, 2 * w
        flops = 2 * b * h * w * kh * kw * cin * cout
    else:
        oh, ow = -(-h // block.stride), -(-w // block.stride)
        flops = 2 * b * oh * ow * kh * kw * cin * cout
    nbytes = (b * h * w * cin + kh * kw * cin * cout + b * oh * ow * cout) * itemsize
    nbytes += (2 if block.norm != "none" else 1) * cout * 4
    return flops, nbytes


# -- phases ----------------------------------------------------------------------


def edge_layers():
    """Shapes off the main path that stress masking: odd and non-square
    planes, channel counts that are no multiple of 8, groups of 2-4
    channels, narrow bfloat16 tiles with GroupNorm."""
    from action_conditioned_gans_tpu_torch.models.common import ConvBlock

    return [
        ("edge_k4s2_odd", ConvBlock(5, 12, kernel=4, stride=2, groups=4), (3, 9, 9, 5)),
        ("edge_k3s1_none", ConvBlock(7, 5, kernel=3, stride=1, norm="none", act="tanh"),
         (3, 7, 10, 7)),
        ("edge_t_gn8", ConvBlock(6, 8, transpose=True, groups=4, act="relu"), (3, 5, 6, 6)),
        ("edge_t_gn80", ConvBlock(20, 80, transpose=True, groups=32), (2, 3, 3, 20)),
    ]


def phase_parity(layers, batch=8):
    """Kernel vs plain version on the same inputs; returns the worst
    bfloat16 |err| per kernel over ``layers``."""
    worst = {}
    for i, (lname, block, shape) in enumerate(layers):
        name, kernel, plain = kernel_call(block)
        with torch.inference_mode():
            x, w, s, b = layer_inputs(block, shape, batch or shape[0], torch.float32, seed=100 + i)
            got, want = kernel(x, w, s, b), plain(x, w, s, b)
            torch.cuda.synchronize()
            err32 = float((got - want).abs().max())
            ok32 = bool(((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all())
            xb = x.to(torch.bfloat16)
            wb = w.to(torch.bfloat16)
            got16 = kernel(xb, wb, s, b)
            want16 = plain(xb.float(), wb.float(), s, b)
            torch.cuda.synchronize()
            err16 = float((got16.float() - want16).abs().max())
        say(f"parity {lname:14s} {name:24s} x{tuple(x.shape)} f32 max|d|={err32:.3e} "
            f"bf16 max|d|={err16:.3e}")
        check(ok32 and np.isfinite(err32), f"{lname}: float32 kernel vs plain beyond 1e-3")
        check(err16 <= 3e-2, f"{lname}: bfloat16 kernel vs plain beyond 3e-2 ({err16})")
        worst[name] = max(worst.get(name, 0.0), err16)
    return worst


def phase_fixture():
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor

    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    buf = io.BytesIO()
    np.savez(buf, **{k: v for k, v in arrays.items() if not k.startswith("fixture/")})
    buf.seek(0)
    p = Predictor.from_npz(buf, device="cuda")
    check(p.cfg.model.compute_dtype == "float32", "fixture is not float32")
    pred = p.predict(arrays["fixture/frame"], arrays["fixture/action"]).cpu().numpy()
    roll = p.rollout(arrays["fixture/frame"], arrays["fixture/actions"]).cpu().numpy()
    e_pred = float(np.abs(pred - arrays["fixture/predict"]).max())
    e_roll = float(np.abs(roll - arrays["fixture/rollout"]).max())
    say(f"fixture (JAX tiny generator) on cuda f32: predict max|d|={e_pred:.3e} "
        f"rollout max|d|={e_roll:.3e}")
    check(e_pred <= 1e-3 and e_roll <= 1e-3, "JAX fixture not reproduced within 1e-3")

    # Full config1 width: the kernel path on cuda against the plain path on
    # the CPU, same weights, float32.
    c1 = get_preset("config1")
    cfg = dataclasses.replace(c1, model=dataclasses.replace(c1.model, compute_dtype="float32"))
    params = seeded_params(cfg, seed=1)
    rng = np.random.default_rng(1)
    frame = np.tanh(rng.standard_normal((4, 64, 64, 3))).astype(np.float32)
    action = rng.standard_normal((4, 4)).astype(np.float32)
    on_gpu = Predictor(cfg, params, device="cuda").predict(frame, action).cpu().numpy()
    on_cpu = Predictor(cfg, params, device="cpu").predict(frame, action).numpy()
    e_full = float(np.abs(on_gpu - on_cpu).max())
    say(f"config1 generator f32, cuda kernels vs cpu plain: max|d|={e_full:.3e}")
    check(e_full <= 1e-3, "config1 generator on cuda differs from the CPU plain path")


def seeded_params(cfg, seed):
    """Flax-layout numpy weights in the JAX init distribution, from a seed."""
    from action_conditioned_gans_tpu_torch.convert import state_dict_to_flax
    from action_conditioned_gans_tpu_torch.models import Generator

    gen = Generator(cfg.model, generator=torch.Generator().manual_seed(seed))
    return state_dict_to_flax(gen.state_dict())


def config1_predictor():
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor

    cfg = get_preset("config1")
    check(cfg.model.compute_dtype == "bfloat16", "config1 does not serve in bfloat16")
    return Predictor(cfg, seeded_params(cfg, seed=0), device="cuda")


def phase_serving(predictor):
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    rng = np.random.default_rng(0)
    frame = np.tanh(rng.standard_normal((128, 64, 64, 3))).astype(np.float32)
    action = rng.standard_normal((128, 4)).astype(np.float32)
    frame0 = frame[:16]
    actions = rng.standard_normal((16, 10, 4)).astype(np.float32)
    predictor.predict(frame, action)  # warm-up
    predictor.rollout(frame0, actions)
    torch.cuda.synchronize()

    conv.reset_launches()
    out = predictor.predict(frame, action)
    clip = predictor.rollout(frame0, actions)
    torch.cuda.synchronize()
    launches = dict(conv.LAUNCHES)
    say(f"main path launches (predict B=128 + rollout T=10 B=16): {launches}")
    for name, info in KERNEL_INFO.items():
        want = info["per_call"] * (1 + 10)
        check(launches[name] == want, f"{name} launched {launches[name]} times, want {want}")
    check(tuple(out.shape) == (128, 64, 64, 3) and out.dtype == torch.bfloat16, "predict shape")
    check(tuple(clip.shape) == (16, 10, 64, 64, 3), "rollout shape")
    for t in (out, clip):
        check(bool(torch.isfinite(t.float()).all()) and float(t.float().abs().max()) <= 1.0,
              "outputs not finite or outside [-1, 1]")

    f_t, a_t = (torch.from_numpy(a).cuda() for a in (frame, action))
    f0_t, as_t = (torch.from_numpy(a).cuda() for a in (frame0, actions))
    predict_ms = cuda_time_ms(lambda: predictor.predict(f_t, a_t), iters=20)
    rollout_ms = cuda_time_ms(lambda: predictor.rollout(f0_t, as_t), iters=5)
    t0 = time.perf_counter()
    for _ in range(10):
        predictor.predict(frame, action)
    torch.cuda.synchronize()
    host_predict_ms = (time.perf_counter() - t0) / 10 * 1e3
    serving = dict(
        predict_b128_ms=predict_ms,
        predict_frames_per_s=128 / predict_ms * 1e3,
        predict_b128_from_numpy_ms=host_predict_ms,
        rollout_t10_b16_ms=rollout_ms,
        rollout_frames_per_s=160 / rollout_ms * 1e3,
    )
    say("serving " + json.dumps(serving))
    return launches


def phase_http(predictor):
    from action_conditioned_gans_tpu_torch.serve import client_predict, client_rollout, make_server, to_host

    srv = make_server(predictor, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            meta = json.loads(r.read())
        check(meta["ok"] is True and meta["device"] == torch.cuda.get_device_name(0), "healthz")
        rng = np.random.default_rng(5)
        frame = np.tanh(rng.standard_normal((4, 64, 64, 3))).astype(np.float32)
        action = rng.standard_normal((4, 4)).astype(np.float32)
        actions = rng.standard_normal((2, 3, 4)).astype(np.float32)
        direct_p = to_host(predictor.predict(frame, action))
        direct_r = to_host(predictor.rollout(frame[:2], actions))
        via_p = client_predict(url, frame, action)
        via_r = client_rollout(url, frame[:2], actions)
        check(np.array_equal(via_p, direct_p), "/predict differs from the direct call")
        check(np.array_equal(via_r, direct_r), "/rollout differs from the direct call")
        q_p = client_predict(url, frame, action, encoding="uint8")
        q_r = client_rollout(url, frame[:2], actions, encoding="uint8")
        tol = 1.0 / 255.0 + 1e-6
        check(float(np.abs(q_p - direct_p).max()) <= tol, "/predict?encoding=uint8")
        check(float(np.abs(q_r - direct_r).max()) <= tol, "/rollout?encoding=uint8")
        say(f"http: /healthz {meta['device']}, /predict {via_p.shape}, /rollout {via_r.shape}, "
            "float32 equal to direct, uint8 within 1/255")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def phase_kernel_times(layers, worst_b8):
    """Each layer at its main-path shape (B=128, bfloat16): kernel, plain
    version and library composite times, and the bound."""
    totals = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
                      bound_ms=0.0, max_abs_err=worst_b8[n]) for n in KERNEL_INFO}
    with torch.inference_mode():
        for i, (lname, block, shape) in enumerate(layers):
            name, kernel, plain = kernel_call(block)
            shape = (128, *shape[1:])
            x, w, s, b = layer_inputs(block, shape, 128, torch.bfloat16, seed=200 + i)
            got = kernel(x, w, s, b)
            want = plain(x.float(), w.to(torch.bfloat16).float(), s, b)
            err = float((got.float() - want).abs().max())
            check(err <= 3e-2, f"{lname}: bfloat16 kernel vs plain at B={shape[0]} ({err})")
            ms = cuda_time_ms(lambda: kernel(x, w, s, b), iters=20)
            plain_ms = cuda_time_ms(lambda: plain(x, w, s, b), iters=20)
            library_ms = cuda_time_ms(library_call(block, x, w, s, b), iters=20)
            flops, nbytes = work(block, shape, 2)
            ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = dict(layer=lname, kernel=name, shape=list(shape), flops=flops, bytes=nbytes,
                       ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes", max_abs_err=err)
            say("layer " + json.dumps(row))
            t = totals[name]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[key] += row[key]
            t["ops_ms"] += ops_ms
            t["bytes_ms"] += bytes_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    say(smi)
    # The plain versions are the references: no TF32 in their convs/matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    build_s = time.perf_counter() - t0
    say(f"built {sorted(paths)} for sm_90a in {build_s:.1f} s -> {build.BUILD_DIR}")

    predictor = config1_predictor()
    rng = np.random.default_rng(2)
    layers = capture_layers(
        predictor, np.tanh(rng.standard_normal((8, 64, 64, 3))).astype(np.float32),
        rng.standard_normal((8, 4)).astype(np.float32),
    )
    check(len(layers) == 7, f"expected 7 generator layers, saw {len(layers)}")
    worst = phase_parity(layers)
    phase_parity(edge_layers(), batch=None)
    phase_fixture()
    launches = phase_serving(predictor)
    phase_http(predictor)
    totals = phase_kernel_times(layers, worst)

    kernels = []
    for name, info in KERNEL_INFO.items():
        t = totals[name]
        kernels.append(dict(
            name=name, route="cuda", source=info["source"], replaces=info["replaces"],
            launches=launches[name], max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            library_ms=t["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
