"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a GPU

Phases, each of which fails the run (non-zero exit, no final line):

1. Print the card and its power limit; build every Hopper kernel from
   ``action_conditioned_gans_tpu_torch/csrc`` (one nvcc per source, in
   parallel).
2. Per-kernel parity at the seven config1 generator layer shapes and the
   four config1 discriminator layer shapes (batch 8) and at four ragged
   shapes: float32 with TF32 off within 1e-3 abs + 1e-3 rel of the plain
   PyTorch version; bfloat16 within 3e-2 abs of the plain version run in
   float32 on the same bfloat16 inputs (a bfloat16 plain version rounds its
   pre-norm conv output, which moves outputs near 4 by one bfloat16 step,
   0.031).
3. The committed JAX fixture (tests/fixtures/torch_port_tiny_generator.npz)
   reproduced on cuda in float32 within 1e-3, and the full-width config1
   generator on cuda against the same weights on the CPU's plain path.
4. Serving at config1 width in bfloat16 with seeded weights: counts set to
   0, then Predictor.predict at B=128 and Predictor.rollout at T=10, B=16;
   every kernel must have launched 4 resp. 3 times per generator call.
   Then both are timed with CUDA events.
5. The port's HTTP server answers /healthz, /predict and /rollout (float32
   and uint8) with exactly the direct calls' results.
6. Per-layer kernel, plain, library and bound times of the generator layers
   at B=128 (the ``layer`` lines). Kernel-level times are device times:
   20 calls captured in a CUDA graph and replayed (``device_time_ms``).
7. The GroupNorm+activation backward kernel against its plain version
   (``reference.gn_act_grads``) at every config1 GroupNorm shape (B=8) and
   at ragged shapes, for lrelu / relu / tanh / none: float32 within 1e-4 abs
   + 1e-4 rel; bfloat16 dx within 1e-2 abs + 1e-2 rel of the plain version
   in float32 on the same inputs (one bfloat16 rounding of dx), dscale and
   dbias within the float32 bar.
8. Autograd parity: every config1 G and D layer at B=4 in float32, TF32
   off: the autograd Functions on the kernels against autograd of the plain
   composite on cuda; dx, dw, dscale, dbias within 1e-3 abs + 1e-3 rel.
9. The committed training fixture (tests/fixtures/torch_port_tiny_train.npz:
   the JAX package's tiny four-step run) replayed on cuda in float32; the
   (d_loss, g_loss, g_recon) trajectory within tests/test_golden.py's
   tolerances.
10. Training at config1 width, bfloat16, B=128, T=1, bfloat16 Adam moments:
    3 warm-up steps; counts set to 0, one step, counts read (12 / 3 / 11
    launches) and every kernel call of it recorded; then 20 steps timed with
    CUDA events. Losses finite, both parameter sets moved. Each distinct conv
    call of that step (D at B=256 and B=128 among them) held against its
    plain version as in phase 2 (bfloat16, 3e-2).
11. Per-call times of the backward kernel at the shapes of that step (the
    ``gnbwd_layer`` lines), each checked against its plain version in float32
    on the same inputs: dx within 1e-2 abs + 1e-2 rel, dscale and dbias
    within 1e-4 of their largest magnitude + 1e-4 rel. Then a ``kernels``
    JSON line (per kernel:
    launches over the serving and the training run, max |err|, kernel,
    plain, bound and library times), then the final line
    ``{"ok": true, "device": {...}}``.
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
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_tiny_train.npz")
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_INFO = {
    "conv_norm_act": dict(
        source="action_conditioned_gans_tpu_torch/csrc/conv_norm_act.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/conv.py:177",
        per_call=4,
        per_step=12,
    ),
    "conv_transpose_norm_act": dict(
        source="action_conditioned_gans_tpu_torch/csrc/conv_transpose_norm_act.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/conv.py:392",
        per_call=3,
        per_step=3,
    ),
    "gn_act_bwd": dict(
        source="action_conditioned_gans_tpu_torch/csrc/gn_act_bwd.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/gn_bwd.py:120",
        per_call=0,
        per_step=11,
    ),
}
# tests/test_golden.py's tolerances on (d_loss, g_loss, g_recon): (atol, rtol).
GOLDEN_TOL = ((2e-4, 1e-3), (2e-3, 1e-3), (2e-4, 1e-3))


def say(*parts):
    print(*parts, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed, so the host's launch rate (which varies from machine to
    machine) does not enter. For kernel-level numbers; end-to-end calls use
    :func:`cuda_time_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def card_state() -> str:
    """SM clock, its maximum, temperature and power draw, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


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


def capture_layers(model, run, prefix=""):
    """(block name, ConvBlock, input shape) of every layer of ``model``, as
    ``run()`` calls them, recorded by forward pre-hooks."""
    seen = []
    hooks = [
        block.register_forward_pre_hook(
            lambda mod, args, name=prefix + name: seen.append((name, mod, tuple(args[0].shape)))
        )
        for name, block in model.named_children()
    ]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def discriminator_layers(batch=8):
    """The config1 discriminator's four layers at ``batch``, bfloat16."""
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.models import Discriminator

    m = get_preset("config1").model
    disc = Discriminator(m, generator=torch.Generator().manual_seed(3)).cuda()
    rng = np.random.default_rng(3)
    frames = [torch.from_numpy(np.tanh(rng.standard_normal((batch, 64, 64, 3))).astype(np.float32)).cuda()
              for _ in range(2)]
    action = torch.from_numpy(rng.standard_normal((batch, 4)).astype(np.float32)).cuda()
    with torch.inference_mode():
        return capture_layers(disc, lambda: disc(frames[0], frames[1], action), prefix="D.")


def call_inputs(x_shape, w_shape, kind, dtype, seed):
    """Random operands for one conv call: x ~ N(0, 1), w ~ N(0, 1/fan_in) so
    the conv output is O(1), scale ~ 1 + 0.1 N, bias ~ 0.1 N."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kh, kw, cin, cout = w_shape
    x = torch.randn(x_shape, generator=g, device="cuda").to(dtype)
    w = torch.randn((kh, kw, cin, cout), generator=g, device="cuda") / (kh * kw * cin) ** 0.5
    scale = 1 + 0.1 * torch.randn(cout, generator=g, device="cuda") if kind != "none" else None
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    return x, w, scale, bias


def layer_inputs(block, shape, batch, dtype, seed):
    return call_inputs((batch, *shape[1:]), tuple(block.kernel.shape), block.norm, dtype, seed)


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


def reset_launches():
    from action_conditioned_gans_tpu_torch.ops.kernels import conv, gn_bwd

    conv.reset_launches()
    gn_bwd.reset_launches()


def read_launches():
    from action_conditioned_gans_tpu_torch.ops.kernels import conv, gn_bwd

    return {**conv.LAUNCHES, **gn_bwd.LAUNCHES}


def phase_serving(predictor):
    rng = np.random.default_rng(0)
    frame = np.tanh(rng.standard_normal((128, 64, 64, 3))).astype(np.float32)
    action = rng.standard_normal((128, 4)).astype(np.float32)
    frame0 = frame[:16]
    actions = rng.standard_normal((16, 10, 4)).astype(np.float32)
    predictor.predict(frame, action)  # warm-up
    predictor.rollout(frame0, actions)
    torch.cuda.synchronize()

    reset_launches()
    out = predictor.predict(frame, action)
    clip = predictor.rollout(frame0, actions)
    torch.cuda.synchronize()
    launches = read_launches()
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
                      bound_ms=0.0, max_abs_err=worst_b8[n]) for n in worst_b8}
    with torch.inference_mode():
        for i, (lname, block, shape) in enumerate(layers):
            name, kernel, plain = kernel_call(block)
            shape = (128, *shape[1:])
            x, w, s, b = layer_inputs(block, shape, 128, torch.bfloat16, seed=200 + i)
            got = kernel(x, w, s, b)
            want = plain(x.float(), w.to(torch.bfloat16).float(), s, b)
            err = float((got.float() - want).abs().max())
            check(err <= 3e-2, f"{lname}: bfloat16 kernel vs plain at B={shape[0]} ({err})")
            ms = device_time_ms(lambda: kernel(x, w, s, b))
            plain_ms = device_time_ms(lambda: plain(x, w, s, b))
            library_ms = device_time_ms(library_call(block, x, w, s, b))
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


# -- training phases ---------------------------------------------------------------


ACTS = ("lrelu", "relu", "tanh", "none")


def gn_inputs(shape, groups, act, dtype, seed):
    """y (float32), scale, out = act(GroupNorm(y)) and a cotangent g in
    ``dtype``, and the (mean, rstd) of y, on the card."""
    from action_conditioned_gans_tpu_torch.ops import common, reference

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    gr = common.resolve_groups(c, groups)
    y = 1.5 * torch.randn(shape, generator=gen, device="cuda") + 0.3
    scale = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    out = reference.norm_act(y, scale, bias, groups=groups, act=act).to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    yg = y.double().reshape(shape[0], -1, gr, c // gr)
    mean = yg.mean(dim=(1, 3))
    rstd = torch.rsqrt(yg.var(dim=(1, 3), unbiased=False) + 1e-5)
    return y, scale, bias, out, g, mean.float().contiguous(), rstd.float().contiguous()


def gn_bwd_pair(shape, groups, act, dtype, seed):
    """(kernel result, plain result in float32 on the same inputs, inputs)."""
    from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd

    y, scale, bias, out, g, mean, rstd = gn_inputs(shape, groups, act, dtype, seed)
    kw = dict(groups=groups, act=act, leak=0.2)
    got = gn_bwd.gn_act_bwd(y, scale, out, g, mean, rstd, **kw)
    want = gn_bwd.gn_act_bwd_plain(y, scale, out.float(), g.float(), mean, rstd, **kw)
    torch.cuda.synchronize()
    return got, want, (y, scale, bias, out, g, mean, rstd)


def within(got, want, atol, rtol):
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= atol + rtol * want.float().abs()).all())


def phase_gn_bwd_parity():
    """Kernel 4 vs reference.gn_act_grads at the config1 GroupNorm shapes
    (B=8) and at ragged ones, every activation, float32 and bfloat16."""
    shapes = [((8, 32, 32, 64), 32), ((8, 16, 16, 128), 32), ((8, 8, 8, 256), 32),
              ((8, 4, 4, 512), 32),
              # ragged: groups 32 -> 5, 32 -> 20, 8 -> 6, 32 -> 24; odd planes
              ((3, 7, 9, 5), 32), ((2, 5, 11, 80), 32), ((3, 9, 9, 12), 8), ((2, 13, 3, 48), 32)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (shape, groups) in enumerate(shapes):
        for act in ACTS:
            for dtype in (torch.float32, torch.bfloat16):
                got, want, _ = gn_bwd_pair(shape, groups, act, dtype, seed=400 + i)
                dx_bar = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
                e_dx, ok_dx = within(got[0], want[0], *dx_bar)
                e_s, ok_s = within(got[1], want[1], 1e-4, 1e-4)
                e_b, ok_b = within(got[2], want[2], 1e-4, 1e-4)
                tag = f"{shape} groups {groups} {act} {str(dtype)[6:]}"
                check(got[0].dtype == dtype and got[1].dtype == torch.float32, f"gn_act_bwd dtypes {tag}")
                check(ok_dx and ok_s and ok_b,
                      f"gn_act_bwd vs plain at {tag}: dx {e_dx:.3e} dscale {e_s:.3e} dbias {e_b:.3e}")
                worst[dtype] = max(worst[dtype], e_dx, e_s, e_b)
    say(f"gn_act_bwd parity ({len(shapes)} shapes x {len(ACTS)} activations): "
        f"f32 max|d|={worst[torch.float32]:.3e} (bar 1e-4 + 1e-4 rel), "
        f"bf16 max|d|={worst[torch.bfloat16]:.3e} (dx bar 1e-2 + 1e-2 rel)")


def phase_autograd_parity(layers, batch=4):
    """The autograd Functions on the kernels against autograd of the plain
    composite on cuda, float32, every G and D layer."""
    worst = 0.0
    for i, (lname, block, shape) in enumerate(layers):
        name, kernel, plain = kernel_call(block)
        x, w, s, b = layer_inputs(block, shape, batch, torch.float32, seed=300 + i)

        def grads(fn):
            ins = [None if t is None else t.clone().requires_grad_() for t in (x, w, s, b)]
            out = fn(*ins)
            ct = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(i),
                             device="cuda")
            return out, torch.autograd.grad(out, [t for t in ins if t is not None], ct)

        out_k, got = grads(kernel)
        _, want = grads(plain)
        check(out_k.grad_fn is not None and out_k.grad_fn.name().startswith("Conv"),
              f"{lname}: the kernel path did not go through its autograd Function")
        torch.cuda.synchronize()
        errs = []
        for label, a, r in zip(("dx", "dw", "dscale", "dbias") if s is not None else ("dx", "dw", "dbias"),
                               got, want):
            err, ok = within(a, r, 1e-3, 1e-3)
            check(ok, f"{lname}: {label} of the autograd Function vs the plain composite ({err:.3e})")
            errs.append(f"{label} {err:.2e}")
            worst = max(worst, err)
        say(f"grad parity {lname:14s} {name:24s} x{tuple(x.shape)} f32 " + " ".join(errs))
    return worst


def phase_train_fixture():
    """The JAX package's tiny four-step training run, replayed on cuda."""
    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.train import make_train_step
    from action_conditioned_gans_tpu_torch.train.state import state_from_params

    with np.load(TRAIN_FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    cfg = config_from_dict(json.loads(str(arrays["__config__"])))
    check(cfg.model.compute_dtype == "float32", "training fixture is not float32")
    sds = [{k[2:].replace("/", "."): torch.from_numpy(np.array(v)) for k, v in arrays.items()
            if k.startswith(p)} for p in ("g/", "d/")]
    state = state_from_params(cfg, *sds, device="cuda")
    step = make_train_step(cfg, device="cuda")
    worst = 0.0
    for i, want in enumerate(arrays["trajectory"]):
        state, m = step(state, {k: arrays[f"batch{i}/{k}"] for k in ("frames", "actions")})
        got = [float(m[k]) for k in ("d_loss", "g_loss", "g_recon")]
        for a, b, (atol, rtol) in zip(got, want, GOLDEN_TOL):
            check(abs(a - b) <= atol + rtol * abs(b),
                  f"training fixture step {i}: {got} vs JAX {want.tolist()}")
            worst = max(worst, abs(a - b))
    say(f"training fixture (JAX tiny 4-step run) on cuda f32: max|d| of (d_loss, g_loss, g_recon)="
        f"{worst:.3e} (bars of tests/test_golden.py)")


def phase_training(steps=20, warmup=3, batch=128):
    """config1 at full width, bfloat16, B=128, T=1, bfloat16 Adam moments
    (bench.py's override), seeded weights and seeded numpy clips."""
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.ops.kernels import conv, gn_bwd
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step
    from action_conditioned_gans_tpu_torch.train.state import param_count

    c1 = get_preset("config1")
    cfg = c1.replace(train=dataclasses.replace(c1.train, batch_size=batch, rollout_length=1,
                                               adam_moment_dtype="bfloat16"))
    check(cfg.model.compute_dtype == "bfloat16", "config1 does not train in bfloat16")
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
    step = make_train_step(cfg, device="cuda")
    rng = np.random.default_rng(10)
    batches = [dict(frames=torch.from_numpy(np.tanh(rng.standard_normal((batch, 2, 64, 64, 3)))
                                            .astype(np.float32)).cuda(),
                    actions=torch.from_numpy(rng.standard_normal((batch, 1, 4)).astype(np.float32)).cuda())
               for _ in range(4)]
    g0 = {k: v.clone() for k, v in state.g_params.items()}
    d0 = {k: v.clone() for k, v in state.d_params.items()}
    for i in range(warmup):
        state, m = step(state, batches[i % 4])
    torch.cuda.synchronize()

    # The main path's counted step; every kernel wrapper's calls are recorded.
    calls, conv_calls, real = [], [], gn_bwd.gn_act_bwd
    real_conv = {name: getattr(conv, name) for name in ("conv_norm_act", "conv_transpose_norm_act")}

    def record(y, scale, out, g, mean=None, rstd=None, **kw):
        calls.append((tuple(y.shape), out.dtype, kw["groups"], kw["act"], kw["leak"]))
        return real(y, scale, out, g, mean, rstd, **kw)

    def record_conv(name):
        def wrapper(x, w, scale, bias, **kw):
            conv_calls.append((name, tuple(x.shape), x.dtype, tuple(w.shape), tuple(sorted(kw.items()))))
            return real_conv[name](x, w, scale, bias, **kw)
        return wrapper

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gn_bwd.gn_act_bwd = record
    for name in real_conv:
        setattr(conv, name, record_conv(name))
    try:
        state, m = step(state, batches[warmup % 4])
        torch.cuda.synchronize()
    finally:
        gn_bwd.gn_act_bwd = real
        for name, fn in real_conv.items():
            setattr(conv, name, fn)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"main path launches (one training step, config1 B={batch} T=1 bf16): {launches}")
    for name, info in KERNEL_INFO.items():
        check(launches[name] == info["per_step"],
              f"{name} launched {launches[name]} times in a training step, want {info['per_step']}")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(steps):
        state, m = step(state, batches[i % 4])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    metrics = {k: float(v) for k, v in m.items()}
    check(all(np.isfinite(v) for v in metrics.values()), f"non-finite training metrics {metrics}")
    moved_g = max(float((state.g_params[k] - v).abs().max()) for k, v in g0.items())
    moved_d = max(float((state.d_params[k] - v).abs().max()) for k, v in d0.items())
    check(moved_g > 0 and moved_d > 0, "a parameter set did not move")
    n_g, n_d = param_count(state)
    train = dict(train_step_ms=ms, frames_per_s=batch / ms * 1e3, batch=batch, steps_timed=steps,
                 peak_memory_gb=peak_gb, g_params=n_g, d_params=n_d, step=state.step,
                 last_metrics=metrics)
    say("training " + json.dumps(train))
    profile_step(step, state, batches[0], ms)
    return launches, calls, conv_calls


def phase_train_conv_parity(conv_calls, worst):
    """Each distinct conv call of the counted training step (the G layers at
    B=128, D at B=256 in its update and B=128 in the G head): the kernel in
    bfloat16 against its plain version in float32 on the same inputs, within
    3e-2 as in phase 2. Folds the errors into ``worst``."""
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    distinct = list(dict.fromkeys(conv_calls))
    with torch.inference_mode():
        for i, (name, x_shape, dtype, w_shape, kw) in enumerate(distinct):
            kw = dict(kw)
            x, w, s, b = call_inputs(x_shape, w_shape, kw["kind"], dtype, seed=600 + i)
            got = getattr(conv, name)(x, w, s, b, **kw)
            want = getattr(conv, f"{name}_plain")(x.float(), w.to(dtype).float(), s, b, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            say(f"train parity {name:24s} x{x_shape} w{w_shape} {kw['kind']:5s} {str(dtype)[6:]} "
                f"max|d|={err:.3e}")
            check(np.isfinite(err) and err <= 3e-2,
                  f"{name} at the training step's x{x_shape}: kernel vs plain beyond 3e-2 ({err})")
            worst[name]["max_abs_err"] = max(worst[name]["max_abs_err"], err)
    say(f"train parity: {len(distinct)} distinct conv calls of the training step within 3e-2")


# Kernel-name fragments of the port's own kernels (csrc/).
OWN_KERNELS = {"conv_wmma_kernel": "conv fwd GEMM", "conv_fma_kernel": "conv fwd GEMM",
               "gn_stats_kernel": "conv fwd GroupNorm stats", "gn_apply_kernel": "conv fwd GroupNorm apply",
               "gn_bwd_": "gn_act_bwd"}


def profile_step(step, state, batch, step_ms, top=14):
    """Device time by kernel over one training step (torch.profiler), and
    the device's busy share: of the profiled step's wall time (which the
    profiler's own host work inflates) and of ``step_ms``, the step's time
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    if not by_name:
        say("profile: torch.profiler recorded no device time; device breakdown not measured")
        return
    groups = {}
    for name, (t, c) in by_name.items():
        label = next((v for k, v in OWN_KERNELS.items() if k in name), "other (cuDNN, cuBLAS, torch)")
        groups[label] = groups.get(label, 0.0) + t
    say("profile " + json.dumps(dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
        busy_share_of_unprofiled_step=busy_ms / step_ms,
        kernels=n_kernels, by_group_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])))))
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"profile_kernel {t:8.4f} ms x{c:3d} {name[:110]}")


def library_gn_bwd(y, scale, bias, g, groups, act):
    """The backward alone of autograd through F.group_norm + the activation,
    on the same values in PyTorch's NCHW layout: the two aten ops autograd
    runs (the activation's backward, then native_group_norm_backward),
    called directly. The yardstick, never called by the port."""
    n, h, w, c = y.shape
    yl = y.permute(0, 3, 1, 2).contiguous()
    gl = g.float().permute(0, 3, 1, 2).contiguous()
    pre, mean, rstd = torch.ops.aten.native_group_norm(yl, scale, bias, n, c, h * w, groups, 1e-5)
    act_bwd = {
        "lrelu": lambda: torch.ops.aten.leaky_relu_backward(gl, pre, 0.2, False),
        "relu": lambda: torch.ops.aten.threshold_backward(gl, torch.relu(pre), 0),
        "tanh": lambda: torch.ops.aten.tanh_backward(gl, torch.tanh(pre)),
        "none": lambda: gl,
    }[act]
    return lambda: torch.ops.aten.native_group_norm_backward(
        act_bwd(), yl, mean, rstd, scale, n, c, h * w, groups, [True, True, True])


def phase_gn_bwd_times(calls):
    """Kernel 4 at each of the training step's calls: kernel, plain and
    library times, the bound, and the bfloat16 error against the plain
    version in float32 on the same inputs."""
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               max_abs_err=0.0)
    for i, (shape, dtype, groups, act, leak) in enumerate(calls):
        got, want, (y, scale, bias, out, g, mean, rstd) = gn_bwd_pair(shape, groups, act, dtype, 500 + i)
        err, ok = within(got[0], want[0], 1e-2, 1e-2)
        check(ok, f"gn_act_bwd at {shape}: bf16 dx vs plain ({err:.3e})")
        # dscale and dbias are float32 sums over B*H*W values on both sides:
        # 1e-4 of their largest magnitude, plus 1e-4 relative.
        for label, a, r in (("dscale", got[1], want[1]), ("dbias", got[2], want[2])):
            e, ok = within(a, r, 1e-4 * float(r.abs().max()), 1e-4)
            check(ok, f"gn_act_bwd at {shape}: {label} vs plain ({e:.3e}, max |{label}| "
                      f"{float(r.abs().max()):.3e})")
        kw = dict(groups=groups, act=act, leak=leak)
        ms = device_time_ms(lambda: gn_bwd.gn_act_bwd(y, scale, out, g, mean, rstd, **kw))
        plain_ms = device_time_ms(lambda: gn_bwd.gn_act_bwd_plain(y, scale, out, g, mean, rstd, **kw))
        library_ms = device_time_ms(library_gn_bwd(y, scale, bias, g, resolve_groups(shape[-1], groups), act))
        n = int(np.prod(shape))
        b, c, gr = shape[0], shape[-1], resolve_groups(shape[-1], groups)
        # y float32 in, out and g in, dx out; scale, mean, rstd in; dscale, dbias out.
        nbytes = n * (4 + 3 * out.element_size()) + 4 * c + 8 * b * gr + 8 * c
        flops = 12 * n  # act', xhat, two sums, dx: float32 on the CUDA cores
        ops_ms, bytes_ms = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(call=i, shape=list(shape), dtype=str(dtype)[6:], groups=gr, act=act, bytes=nbytes,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes", max_abs_err=err)
        say("gnbwd_layer " + json.dumps(row))
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += row[key]
        tot["ops_ms"] += ops_ms
        tot["bytes_ms"] += bytes_ms
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return tot


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
    say(f"card (clocks.sm, clocks.max.sm, temperature, power.draw): {card_state()}")
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    build_s = time.perf_counter() - t0
    say(f"built {sorted(paths)} for sm_90a in {build_s:.1f} s -> {build.BUILD_DIR}")

    predictor = config1_predictor()
    rng = np.random.default_rng(2)
    frame = np.tanh(rng.standard_normal((8, 64, 64, 3))).astype(np.float32)
    action = rng.standard_normal((8, 4)).astype(np.float32)
    layers = capture_layers(predictor.generator, lambda: predictor.predict(frame, action))
    check(len(layers) == 7, f"expected 7 generator layers, saw {len(layers)}")
    d_layers = discriminator_layers()
    check(len(d_layers) == 4, f"expected 4 discriminator layers, saw {len(d_layers)}")
    worst = phase_parity(layers + d_layers)
    phase_parity(edge_layers(), batch=None)
    phase_fixture()
    serving_launches = phase_serving(predictor)
    phase_http(predictor)
    totals = phase_kernel_times(layers, worst)
    phase_gn_bwd_parity()
    phase_autograd_parity(layers + d_layers)
    phase_train_fixture()
    train_launches, calls, conv_calls = phase_training()
    phase_train_conv_parity(conv_calls, totals)
    totals["gn_act_bwd"] = phase_gn_bwd_times(calls)
    say(f"card after the runs (clocks.sm, clocks.max.sm, temperature, power.draw): {card_state()}")

    kernels = []
    for name, info in KERNEL_INFO.items():
        t = totals[name]
        kernels.append(dict(
            name=name, route="cuda", source=info["source"], replaces=info["replaces"],
            launches=serving_launches[name] + train_launches[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"],
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
