"""The plain reference of the action-conditioned GAN: generator, discriminator,
the fused G+D training step with its two Adam optimizers, and the check of
an autoregressive rollout, in plain PyTorch and float32.

It imports nothing of the program and takes nothing the program made: the
benchmark hands both sides the same weights and inputs, made from the seed
(``benchmark/inputs.py``), and this module works everything else out again.
Layouts are NHWC activations and HWIO kernels, SAME padding as XLA pads it,
the conv-transpose as ``lax.conv_transpose`` computes it (the kernel not
flipped), GroupNorm with per-sample statistics over groups of channels (the
largest divisor of the width at most ``group_norm_groups``), then the
affine and the activation.

``rnd`` is the precision the reference computes in: None for float32, or a
rounding function applied to every conv's and the dense layer's inputs and
weights and to their outputs, as the program rounds them to its compute
dtype. The benchmark's control passes an fp8 rounding here
(:func:`fp8_round`), the step below the configuration's bfloat16 that a
later change could be tempted to take.

It supports what the benchmark's configurations use (GroupNorm, no state,
no skips, no spectral norm, teacher-forced rollouts, the cross-entropy GAN
loss with an L2 reconstruction, constant learning rates, Adam's moments
stored in float32 or bfloat16) and refuses the rest.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def check_supported(cfg: Mapping) -> None:
    """Raise naming the first setting of ``cfg`` this reference does not compute."""
    m, t = cfg["model"], cfg["train"]
    want = {"norm": "group", "state_dim": 0, "skip_connections": False,
            "d_spectral_norm": False}
    for key, value in want.items():
        if m.get(key, value) != value:
            raise ValueError(f"the reference computes model.{key}={value!r}, not {m[key]!r}")
    want = {"gan_loss": "ce", "recon_type": "l2", "disc_steps": 1, "r1_weight": 0.0,
            "d_label_smooth": 0.0, "d_augment": "", "scheduled_sampling": False,
            "grad_clip_norm": 0.0, "lr_schedule": "constant", "warmup_steps": 0,
            "ema_decay": 0.0, "disc_microbatch": 0}
    for key, value in want.items():
        if t.get(key, value) != value:
            raise ValueError(f"the reference computes train.{key}={value!r}, not {t[key]!r}")
    if t.get("adam_moment_dtype", "float32") not in ("float32", "bfloat16"):
        raise ValueError("the reference stores Adam's moments in float32 or bfloat16, not "
                         f"{t['adam_moment_dtype']!r}")


@contextlib.contextmanager
def float32_math():
    """TF32 off for the reference's own computation, the flags restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class _Round(torch.autograd.Function):
    """``fn`` on the value and on its gradient."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per tensor (its largest
    magnitude at the format's largest, 448), back in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def _q(x: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    return x if rnd is None else _Round.apply(x, rnd)


# -- the architecture ---------------------------------------------------------------------


def _channels(level: int, base: int, cap: int) -> int:
    return min(base * 2**level, cap)


def _groups(c: int, groups: int) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def _blocks(m: Mapping, which: str) -> List[Tuple[str, dict]]:
    """(name, block) in call order: kernel size, stride, transpose, channels,
    whether it has a GroupNorm, and its activation."""
    out = []
    if which == "g":
        ch, levels = m["image_channels"], m["g_levels"]
        base, cap = m["g_base_channels"], m["g_max_channels"]
        for i in range(levels):
            c = _channels(i, base, cap)
            out.append((f"enc_{i}", dict(k=4, s=2, t=False, cin=ch, cout=c, gn=i > 0, act="lrelu")))
            ch = c
        bott = _channels(levels - 1, base, cap)
        out.append(("bottleneck", dict(k=3, s=1, t=False, cin=ch + m["action_dim"], cout=bott,
                                       gn=True, act="relu")))
        ch = bott
        for i in reversed(range(levels)):
            last = i == 0
            c = m["image_channels"] if last else _channels(i - 1, base, cap)
            out.append((f"dec_{i}", dict(k=4, s=2, t=True, cin=ch, cout=c, gn=not last,
                                         act="tanh" if last else "relu")))
            ch = c
        return out
    ch = m["image_channels"] * (2 if m["d_condition_frame"] else 1)
    ch += m["action_dim"] if m["d_condition_action"] else 0
    for i in range(m["d_levels"]):
        c = _channels(i, m["d_base_channels"], m["d_max_channels"])
        out.append((f"conv_{i}", dict(k=4, s=2, t=False, cin=ch, cout=c, gn=i > 0, act="lrelu")))
        ch = c
        for j in range(m["d_extra_layers"]):
            out.append((f"conv_{i}_extra_{j}", dict(k=3, s=1, t=False, cin=ch, cout=ch, gn=True,
                                                    act="lrelu")))
    return out


def param_spec(m: Mapping) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """G's and D's parameters: name -> (shape, init), init one of
    "normal" (the Flax truncated normal, std 0.02), "ones", "zeros"."""
    specs = []
    for which in ("g", "d"):
        spec = {}
        for name, b in _blocks(m, which):
            spec[f"{name}.kernel"] = ((b["k"], b["k"], b["cin"], b["cout"]), "normal")
            if b["gn"]:
                spec[f"{name}.scale"] = ((b["cout"],), "ones")
            spec[f"{name}.bias"] = ((b["cout"],), "zeros")
        specs.append(spec)
    size = m["image_size"]
    for _ in range(m["d_levels"]):
        size = -(-size // 2)
    last = _blocks(m, "d")[-1][1]["cout"]
    specs[1]["logit_kernel"] = ((size * size * last, 1), "normal")
    specs[1]["logit_bias"] = ((1,), "zeros")
    return specs[0], specs[1]


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: dict) -> torch.Tensor:
    xn = x.permute(0, 3, 1, 2)
    if b["t"]:
        # lax.conv_transpose(SAME, k=4, s=2): the stride-dilated input padded
        # by 2 and correlated with w as given, which is conv_transpose2d with
        # the kernel flipped, (I, O, kh, kw), padding 1.
        y = F.conv_transpose2d(xn, w.flip(0, 1).permute(2, 3, 0, 1), stride=2, padding=1)
    else:
        plo, phi = _same(x.shape[1], b["k"], b["s"])
        qlo, qhi = _same(x.shape[2], b["k"], b["s"])
        y = F.conv2d(F.pad(xn, (qlo, qhi, plo, phi)), w.permute(3, 2, 0, 1), stride=b["s"])
    return y.permute(0, 2, 3, 1)


def _group_norm(y: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    n, h, w, c = y.shape
    g = _groups(c, groups)
    yg = y.reshape(n, h * w, g, c // g)
    mean = yg.mean(dim=(1, 3), keepdim=True)
    var = (yg - mean).square().mean(dim=(1, 3), keepdim=True)
    return ((yg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)


def _act(y: torch.Tensor, act: str, leak: float) -> torch.Tensor:
    if act == "lrelu":
        return torch.where(y >= 0, y, y * leak)
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    return torch.tanh(y)


def _block(x, p: Params, name: str, b: dict, m: Mapping, rnd: Rounding) -> torch.Tensor:
    y = _conv(_q(x, rnd), _q(p[f"{name}.kernel"], rnd), b)
    if b["gn"]:
        y = _group_norm(y, m["group_norm_groups"]) * p[f"{name}.scale"]
    return _q(_act(y + p[f"{name}.bias"], b["act"], m["leak"]), rnd)


def _tile(action: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return action[:, None, None, :].expand(action.shape[0], h, w, action.shape[1])


def generator(m: Mapping, p: Params, frame: torch.Tensor, action: torch.Tensor,
              rnd: Rounding = None) -> torch.Tensor:
    """Next frame (B, H, W, C) in [-1, 1] from frame (B, H, W, C) and action (B, A)."""
    x = _q(frame.float(), rnd)
    for name, b in _blocks(m, "g"):
        if name == "bottleneck":
            x = torch.cat([x, _tile(action.float(), x.shape[1], x.shape[2])], dim=-1)
        x = _block(x, p, name, b, m, rnd)
    return x


def discriminator(m: Mapping, p: Params, nxt: torch.Tensor, frame: torch.Tensor,
                  action: torch.Tensor, rnd: Rounding = None) -> torch.Tensor:
    """(B,) logits of the transition frame -> nxt under action."""
    parts = [nxt.float()]
    if m["d_condition_frame"]:
        parts.append(frame.float())
    if m["d_condition_action"]:
        parts.append(_tile(action.float(), nxt.shape[1], nxt.shape[2]))
    x = torch.cat(parts, dim=-1)
    for name, b in _blocks(m, "d"):
        x = _block(x, p, name, b, m, rnd)
    logits = _q(x.reshape(x.shape[0], -1), rnd) @ _q(p["logit_kernel"], rnd)
    return _q(logits + p["logit_bias"], rnd)[:, 0]


# -- the training step ----------------------------------------------------------------------


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


class _Adam:
    """Adam with a constant learning rate, computed in float32; the moments
    are stored in ``store`` (float32, or bfloat16 rounded to nearest after
    each update, the update itself reading them unrounded). ``state``
    (mu, nu, count) continues another optimizer's."""

    def __init__(self, params: Params, lr: float, b1: float, b2: float, eps: float = 1e-8,
                 state: Optional[tuple] = None, store: torch.dtype = torch.float32):
        self.lr, self.b1, self.b2, self.eps, self.store = lr, b1, b2, eps, store
        if state is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.count = 0
        else:
            mu, nu, self.count = state
            self.mu = {k: mu[k].detach().float().clone() for k in params}
            self.nu = {k: nu[k].detach().float().clone() for k in params}

    @torch.no_grad()
    def update(self, params: Params, grads: Params) -> None:
        self.count += 1
        bc1, bc2 = 1 - self.b1**self.count, 1 - self.b2**self.count
        for k, g in grads.items():
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            params[k].sub_(self.lr * (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + self.eps))
            if self.store != torch.float32:
                self.mu[k].copy_(self.mu[k].to(self.store))
                self.nu[k].copy_(self.nu[k].to(self.store))


def block_rows(m: Mapping, budget_bytes: float = 24e9) -> int:
    """Transitions a block of the step holds within ``budget_bytes``: about
    a dozen float32 tensors of every layer's output kept for the backward,
    for G and twice for D."""
    size = m["image_size"]
    per = 0
    for which in ("g", "d"):
        s = size
        for _, b in _blocks(m, which):
            s = s * 2 if b["t"] else -(-s // b["s"])
            per += s * s * b["cout"] * (1 if which == "g" else 2)
    return max(1, int(budget_bytes // (per * 4 * 12)))


def train_steps(cfg: Mapping, g0: Params, d0: Params, frames: torch.Tensor,
                actions: torch.Tensor, rnd: Rounding = None, rows: Optional[int] = None,
                keep: Optional[int] = None, g_state: Optional[tuple] = None,
                d_state: Optional[tuple] = None) -> dict:
    """Steps from G's and D's parameters ``g0`` / ``d0`` over stacked
    batches ``frames`` (k, B, T+1, H, W, C) and ``actions`` (k, B, T, A),
    one step a batch: G's teacher-forced rollout over the B*T transitions,
    D's cross-entropy loss on real and detached fake transitions and D's
    Adam update, then G's adversarial loss against the updated D plus
    ``recon_weight`` times the L2 reconstruction, and G's Adam update.
    Sums run over blocks of ``rows`` transitions (:func:`block_rows` when
    None), each block's share of the mean, so that a float32 step of a
    large cell fits on the card alone. ``keep`` takes each batch's first
    rows alone (a planted fault: half the batch). ``g_state`` / ``d_state``
    (mu, nu, count) continue G's / D's Adam from another run's state; None
    starts it fresh.

    Returns each step's ``losses``, the first step's gradient of every leaf
    (``first_grads``, "g."/"d." prefixed) and the state at the end: the
    parameters ``g`` and ``d`` and each Adam's ``*_mu``, ``*_nu`` and
    ``*_count``, float32."""
    check_supported(cfg)
    m, t = cfg["model"], cfg["train"]
    rows = rows or block_rows(m)
    g = {k: v.detach().float().clone() for k, v in g0.items()}
    d = {k: v.detach().float().clone() for k, v in d0.items()}
    store = getattr(torch, t.get("adam_moment_dtype", "float32"))
    g_opt = _Adam(g, t["g_lr"], t["adam_b1"], t["adam_b2"], state=g_state, store=store)
    d_opt = _Adam(d, t["d_lr"], t["adam_b1"], t["adam_b2"], state=d_state, store=store)
    losses, first_grads = [], None
    with float32_math():
        for s in range(frames.shape[0]):
            fr, ac = frames[s], actions[s]
            if keep:
                fr, ac = fr[:keep], ac[:keep]
            b, horizon = ac.shape[:2]
            cond = fr[:, :horizon].reshape(b * horizon, *fr.shape[2:])
            real = fr[:, 1:].reshape(b * horizon, *fr.shape[2:])
            act = ac.reshape(b * horizon, ac.shape[-1])
            n = cond.shape[0]
            chunks = [slice(i, min(i + rows, n)) for i in range(0, n, rows)]

            with torch.no_grad():
                fake = torch.cat([generator(m, g, cond[c], act[c], rnd) for c in chunks])
            d_leaves = {k: v.detach().requires_grad_() for k, v in d.items()}
            d_grads = {k: torch.zeros_like(v) for k, v in d.items()}
            d_loss = 0.0
            for c in chunks:
                lr_ = discriminator(m, d_leaves, real[c], cond[c], act[c], rnd)
                lf_ = discriminator(m, d_leaves, fake[c], cond[c], act[c], rnd)
                loss = (_softplus(-lr_).sum() + _softplus(lf_).sum()) / n
                for k, gr in zip(d_leaves, torch.autograd.grad(loss, list(d_leaves.values()))):
                    d_grads[k] += gr
                d_loss += float(loss.detach())
            del fake
            d_opt.update(d, d_grads)

            g_leaves = {k: v.detach().requires_grad_() for k, v in g.items()}
            g_grads = {k: torch.zeros_like(v) for k, v in g.items()}
            adv_sum = recon_sum = 0.0
            for c in chunks:
                pred = generator(m, g_leaves, cond[c], act[c], rnd)
                adv = _softplus(-discriminator(m, d, pred, cond[c], act[c], rnd)).sum() / n
                recon = (pred - real[c]).square().sum() / real.numel()
                loss = adv + t["recon_weight"] * recon
                for k, gr in zip(g_leaves, torch.autograd.grad(loss, list(g_leaves.values()))):
                    g_grads[k] += gr
                adv_sum += float(adv.detach())
                recon_sum += float(recon.detach())
            if first_grads is None:
                first_grads = {**{f"g.{k}": v.clone() for k, v in g_grads.items()},
                               **{f"d.{k}": v.clone() for k, v in d_grads.items()}}
            g_opt.update(g, g_grads)
            losses.append({"d_loss": d_loss, "g_adv": adv_sum, "g_recon": recon_sum,
                           "g_loss": adv_sum + t["recon_weight"] * recon_sum})
    return {"losses": losses, "first_grads": first_grads, "g": g, "d": d,
            "g_mu": g_opt.mu, "g_nu": g_opt.nu, "g_count": g_opt.count,
            "d_mu": d_opt.mu, "d_nu": d_opt.nu, "d_count": d_opt.count}


# -- serving: the rollout, step by step from the program's own frames ---------------------------


@torch.no_grad()
def rollout_gaps(m: Mapping, g: Params, frame0: torch.Tensor, actions: torch.Tensor,
                 frames: torch.Tensor) -> torch.Tensor:
    """(T, B): the RMS over each candidate's pixels of the gap between the
    served frames ``frames`` (B, T, H, W, C) and the reference's prediction
    from the same input: the request's ``frame0`` at step 0, the served
    frame t-1 after it (the frame the program fed back), under
    ``actions[:, t]``."""
    gaps = []
    with float32_math():
        for t in range(actions.shape[1]):
            prev = frame0 if t == 0 else frames[:, t - 1]
            ref = generator(m, g, prev.float(), actions[:, t].float())
            gaps.append((frames[:, t].float() - ref).square().mean(dim=(1, 2, 3)).sqrt())
    return torch.stack(gaps)


def leaf_gaps(program: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
              skip=()) -> Dict[str, Tuple[float, float]]:
    """Each leaf's (gap of the two sides' norms, norm of their difference),
    both over the larger of that leaf's reference norm and the median
    leaf's."""
    names = [k for k in reference if k not in skip]
    ref = {k: float(reference[k].float().norm()) for k in names}
    median = sorted(ref.values())[len(names) // 2]
    out = {}
    for k in names:
        p = program[k].float()
        scale = max(ref[k], median)
        out[k] = (abs(float(p.norm()) - ref[k]) / scale,
                  float((p - reference[k].float()).norm()) / scale)
    return out
