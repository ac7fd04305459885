"""Fused G+D training steps through the program's own path
(``parallel.mesh.make_mesh`` -> ``parallel.dp.make_dp_train_step``) from
``train.state.state_from_params`` over the seed's weights; a bank of
stacked clip batches cycled one a call, calls back to back, as the training
loop issues them. An attempt is a step; a call's steps fail when its losses
are not finite.

The output check sees only what the entry point hands back: the state
between calls, and each call's metrics (its last step's losses). Two calls
are checked against the float32 reference, each over all its steps:

- the set-up's first call, the window's own call and feed, from the seed:
  the reference starts from the seed's weights with fresh optimizers;
- the window's first call, from the program's state before it (cloned at
  the end of the set-up; the state after it is cloned as the call returns,
  a copy on the device that the window pays).

Readings of a call (the window's call's are prefixed ``warm_``):
``loss_gap`` and ``recon_gap``, the relative gaps of its last step's
d_loss and G's reconstruction loss; ``grad_gap`` and
``grad_norm_gap``, the worst and the median leaf's gap of the norms of the
call's gradients as Adam's first moment takes them, ``mu_after - b1**k *
mu_before`` on each side; ``grad_err`` and ``d_grad_err``, the median
leaf's (of all leaves, of D's) norm of the difference of the same;
``sq_gap`` and ``sq_norm_gap``, the worst and the median leaf's gap of the
norms of their squares as the second moment takes them, ``nu_after -
b2**k * nu_before``; ``update_gap``, the worst leaf's gap of
the norms of the parameters' change over the call, leaving out the leaves
whose reference gradient at the call's first step is under a thousandth of
the median leaf's (moved by round-off alone). Each is over the larger of
the leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Tuple

import torch

from benchmark import flops, inputs
from benchmark.runners import Context, Run, free, memory_peak, sync, traced, weights


def finite(metrics: List[Dict[str, torch.Tensor]]) -> List[bool]:
    if not metrics:
        return []
    losses = torch.stack([torch.stack([m["d_loss"], m["g_loss"]]) for m in metrics])
    return torch.isfinite(losses).all(dim=1).tolist()


def _named(params: Dict[str, torch.Tensor], moment) -> Dict[str, torch.Tensor]:
    """An Adam moment by parameter name: as given where it is a dict; where
    it is one flat vector over parameters that are views of one buffer,
    each parameter's slice at its offset in that buffer."""
    if isinstance(moment, dict):
        return moment
    base = min(p.storage_offset() for p in params.values())
    return {k: moment[p.storage_offset() - base:][:p.numel()].view(p.shape)
            for k, p in params.items()}


def snapshot(state) -> dict:
    """Copies, on the device, of the program's parameters and Adam states."""

    def clone(tensors):
        return {k: v.detach().clone() for k, v in tensors.items()}

    out = {}
    for side, params, opt in (("g", state.g_params, state.g_opt),
                              ("d", state.d_params, state.d_opt)):
        out[side] = clone(params)
        out[f"{side}_mu"] = clone(_named(params, opt.mu))
        out[f"{side}_nu"] = clone(_named(params, opt.nu))
        out[f"{side}_count"] = int(opt.count)
    return out


def run(ctx: Context) -> Run:
    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import make_mesh
    from action_conditioned_gans_tpu_torch.train.state import state_from_params

    dev, tr = ctx.device, ctx.traffic
    cfg = config_from_dict(ctx.cfg)
    t = ctx.cfg["train"]
    k = max(t["steps_per_call"], 1)
    ctx.phase("set-up: the program's modules imported")
    g_w, d_w = weights(ctx, cfg, "gd")
    mesh = make_mesh(cfg.mesh, device=dev)
    state = state_from_params(cfg, g_w, d_w, device=dev)
    step = make_dp_train_step(cfg, mesh)
    bank = inputs.train_bank(ctx.cfg, tr["bank_batches"], ctx.seed, dev)
    ctx.phase("set-up: inputs, weights and step built")

    state, first = step(state, bank[0])
    after_first = snapshot(state)
    ctx.phase("set-up: the first call")
    calls = [first]
    for i in range(tr["warm_calls"]):
        state, m = step(state, bank[(1 + i) % len(bank)])
        calls.append(m)
    before = snapshot(state)
    sync(dev)
    ctx.phase("set-up: warm calls")
    setup_s = time.perf_counter() - ctx.started

    spans: List[float] = []
    window: List[Dict[str, torch.Tensor]] = []
    start = time.perf_counter()
    deadline = start + ctx.seconds
    while True:
        t0 = time.perf_counter()
        state, m = step(state, bank[len(window) % len(bank)])
        spans.append(time.perf_counter() - t0)
        if not window:
            after = snapshot(state)
        window.append(m)
        if time.perf_counter() >= deadline:
            break
    sync(dev)
    window_s = time.perf_counter() - start

    run = Run(kind="train_steps", setup_s=setup_s, window_s=window_s, units=k * len(window),
              attempted=k * (len(window) + len(calls)), failed=0,
              frames_per_unit=t["batch_size"] * max(t["rollout_length"], 1),
              flops_per_unit=float(flops.step_flops(ctx.cfg)), end_to_end={},
              spans={"call": spans}, memory_peak_bytes=0, readings={})
    run.end_to_end["train_frames_per_s"] = run.frames_per_unit * run.units / window_s
    checked = (first, window[0])

    if ctx.trace:
        from torch.profiler import record_function

        def issue() -> int:
            nonlocal state
            with record_function("bench:call"):
                state, m = step(state, bank[0])
            window.append(m)
            run.attempted += k
            return k

        traced(ctx, run, issue, tr["trace_min_calls"] * k, tr["trace_seconds"])
    run.failed = k * sum(not ok for ok in finite(calls + window))
    run.memory_peak_bytes = memory_peak(dev)
    losses = [{name: float(v) for name, v in m.items()} for m in checked]
    frames, actions = bank[0]["frames"], bank[0]["actions"]
    if k == 1:
        frames, actions = frames[None], actions[None]
    del state, step, window, calls, first, checked, m, bank
    free(dev)
    ctx.phase("the window closed, the program's state freed")

    seed_start = {"g": g_w, "d": d_w}
    ref = reference_call(ctx.reference, ctx.cfg, seed_start, frames, actions)
    readings, look = call_readings(ctx.reference, ctx.cfg, seed_start, after_first, losses[0], ref)
    del ref
    ref = reference_call(ctx.reference, ctx.cfg, before, frames, actions)
    warm, warm_look = call_readings(ctx.reference, ctx.cfg, before, after, losses[1], ref)
    run.readings = {**readings, **{f"warm_{n}": v for n, v in warm.items()}}
    run.notes.append(f"check's look: {json.dumps({'first': look, 'warm': warm_look})}")
    ctx.phase("the check")
    return run


def reference_call(reference, cfg: dict, before: dict, frames, actions, **kw) -> dict:
    """The float32 reference's call over ``frames`` / ``actions`` (k, ...)
    from the state ``before``: the seed's weights with fresh optimizers
    where it holds no Adam state. ``kw`` goes to ``train_steps`` (a
    control's rounding, a fault's rows)."""
    states = {}
    for side in ("g", "d"):
        if f"{side}_mu" in before:
            states[f"{side}_state"] = (before[f"{side}_mu"], before[f"{side}_nu"],
                                       before[f"{side}_count"])
    return reference.train_steps(cfg, before["g"], before["d"], frames, actions, **states, **kw)


def _increment(state: dict, before: dict, moment: str, decay: float) -> Dict[str, torch.Tensor]:
    """A moment's increment over the call, ``after - decay * before``, by
    leaf: the call's gradients as Adam's first moment (``mu``, decay
    b1**k) or their squares as its second (``nu``, decay b2**k) take them."""
    out = {}
    for side in ("g", "d"):
        m0 = before.get(f"{side}_{moment}")
        for n, v in state[f"{side}_{moment}"].items():
            out[f"{side}.{n}"] = v.float() - (decay * m0[n].float() if m0 is not None else 0)
    return out


def _change(state: dict, before: dict) -> Dict[str, torch.Tensor]:
    return {f"{side}.{n}": v.float() - before[side][n].float()
            for side in ("g", "d") for n, v in state[side].items()}


def call_readings(reference, cfg: dict, before: dict, after: dict, losses: Dict[str, float],
                  ref: dict) -> Tuple[Dict[str, float], dict]:
    """The numbers a checked call reads, for ``after`` and ``losses`` (the
    program's state after the call and the call's metrics, or a control's
    or a fault's in its place) against ``ref``, the float32 reference's
    call from the same ``before``; and a look at what sets them."""
    k, t = len(ref["losses"]), cfg["train"]
    last = ref["losses"][-1]
    loss_gaps = {name: abs(losses[name] - r) / max(abs(r), 1e-30)
                 for name, r in last.items() if name in losses}
    grads = ref["first_grads"]
    norms = sorted(float(v.norm()) for v in grads.values())
    skip = {n for n, v in grads.items() if float(v.norm()) < 1e-3 * norms[len(norms) // 2]}
    g_leaves = reference.leaf_gaps(*(_increment(x, before, "mu", t["adam_b1"] ** k)
                                     for x in (after, ref)))
    sq_leaves = reference.leaf_gaps(*(_increment(x, before, "nu", t["adam_b2"] ** k)
                                      for x in (after, ref)))
    u_leaves = reference.leaf_gaps(_change(after, before), _change(ref, before), skip)
    d_leaves = {n: v for n, v in g_leaves.items() if n.startswith("d.")}

    def worst(leaves, i):
        name = max(leaves, key=lambda n: leaves[n][i])
        return name, leaves[name][i]

    def median(leaves, i):
        return sorted(v[i] for v in leaves.values())[len(leaves) // 2]

    # g_adv and g_loss come after D's update in the last step and move
    # with the signs Adam gives gradient entries near zero, which rounding
    # flips; d_loss is that step's forward before any update, and g_recon
    # does not pass through D.
    readings = {"loss_gap": loss_gaps["d_loss"], "recon_gap": loss_gaps["g_recon"],
                "grad_gap": worst(g_leaves, 0)[1],
                "grad_norm_gap": median(g_leaves, 0), "grad_err": median(g_leaves, 1),
                "d_grad_err": median(d_leaves, 1), "sq_gap": worst(sq_leaves, 0)[1],
                "sq_norm_gap": median(sq_leaves, 0), "update_gap": worst(u_leaves, 0)[1]}
    look = {"losses": loss_gaps, "ref_losses": last, "grad_worst": worst(g_leaves, 0),
            "grad_err_worst": worst(g_leaves, 1), "update_worst": worst(u_leaves, 0),
            "skipped": sorted(skip)}
    return readings, look
