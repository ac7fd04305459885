"""The standalone GroupNorm+activation kernel's module (``ops/kernels/norm_act.py``)
and the split route of ``ops/api.py`` against the JAX package, on the CPU.

* the plain version against the JAX Pallas ``group_norm_act`` in interpret
  mode, as tests/test_pallas.py runs it: float32 within 1e-4; bfloat16
  within 1e-2 abs + 1e-2 rel (one bfloat16 step of |out| <= 2, and the
  kernel activates before its cast where the plain version casts first);
* ``csrc/group_norm_act.cu``'s one-launch cluster design, emulated in torch
  under its plan (the CUDA kernel cannot run here), against the plain
  version, and its (mean, rstd) against float64 statistics;
* the plan (``ops/kernels/norm_act.py:gn_plan``, the copy of the kernel's
  ``acg_gn_plan``) pinned at every preset layer that runs kernel 3 and at
  the edges;
* :class:`GroupNormActFn` against ``jax.vjp`` of the Pallas op: 1e-3;
* the backward's CPU path with a bfloat16 ``y`` against ``ops/gn.py``'s
  ``gn_act_grads`` on the same bfloat16 input;
* a split layer end to end (config1 float32 D ``conv_3``) against the JAX
  ``ops.api.conv_norm_act(backend="pallas")``, forward and gradients;
* the generator and discriminator at the config5 and config3 geometries at
  narrow widths against the JAX models on their XLA path, float32, 1e-3.

Inputs are numpy arrays from seeds fed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.models import Discriminator as JaxDiscriminator
from action_conditioned_gans_tpu.models import Generator as JaxGenerator
from action_conditioned_gans_tpu.ops import api as japi
from action_conditioned_gans_tpu.ops import gn as JG
from action_conditioned_gans_tpu.ops import pallas as P
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import api, common, envelope
from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd
from action_conditioned_gans_tpu_torch.ops.kernels import norm_act as NA

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
ACTS = ["lrelu", "relu", "tanh", "none"]


def rand(seed, *shape, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def bf16(a):
    """``a`` rounded to bfloat16, as float32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def gn_operands(seed, shape):
    c = shape[-1]
    return (rand(seed, *shape, scale=1.5, offset=0.3), rand(seed + 1, c, scale=0.2, offset=1.0),
            rand(seed + 2, c, scale=0.1))


# -- forward ---------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c,groups", [(32, 8), (64, 32), (96, 20)])  # 96/20 -> 16 groups of 6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_pallas_kernel(act, c, groups, dtype):
    x, scale, bias = gn_operands(0, (2, 6, 5, c))
    if dtype == "bfloat16":
        x = bf16(x)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    got = NA.group_norm_act(t(x).to(tdt), t(scale), t(bias), groups=groups, act=act)
    assert got.dtype == tdt and NA.LAUNCHES == {"group_norm_act": 0}
    want = P.group_norm_act(jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias),
                            groups=groups, act=act)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def emulate_group_norm_act_kernel(x, scale, bias, groups, eps, act, leak, plan_dtype, plan=None):
    """csrc/group_norm_act.cu step by step in torch, float32, with the plan
    the kernel takes for ``plan_dtype`` (``NA.gn_plan``; or ``plan``): each block of a
    sample's cluster holds its share of rows; per chunk of channel units,
    each lane sums S1 = sum x and S2 = sum x^2 over its rows (the rows past
    the kept ones first, as the kernel reads them) and folds its unit's
    channels into per-group slots; lanes, then a group's slots, fold into
    the block's per-group partials; the blocks' partials
    add in rank order; E[x^2] - mean^2 clamped at 0; then every lane
    normalises, applies the affine and the activation to its rows and casts.
    Every row is checked to fall in exactly one lane. Returns (out, stats
    (2, B, G))."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // groups
    p = plan or NA.gn_plan(plan_dtype, b, hw, c, groups)
    x3 = x.reshape(b, hw, c).float()
    units = c // p.vec
    chunks = [(u0 * p.vec, min(NA.NT, units - u0) * p.vec, NA.NT // min(NA.NT, units - u0))
              for u0 in range(0, units, NA.NT)]  # (first channel, channels, lanes)
    shares = [NA.share_rows(hw, p.cluster, q) for q in range(p.cluster)]
    assert [r for rows in shares for r in rows] == list(range(hw))

    def lane_rows(rows, lanes):
        keep = min(len(rows), p.keep_rows)
        out = [[*rows[keep + l::lanes], *rows[l:keep:lanes]] for l in range(lanes)]
        assert sorted(r for lr in out for r in lr) == list(rows)
        return out

    slot = p.vec // NA.unit_slots(p.vec, cg)  # channels a thread folds into one slot
    parts = []
    for rows in shares:
        part = torch.zeros(2, b, groups)
        for ch0, width, lanes in chunks:
            xs = x3[:, :, ch0:ch0 + width]
            red = torch.stack([torch.stack([xs[:, lr].sum(1), (xs[:, lr] ** 2).sum(1)])
                               for lr in lane_rows(rows, lanes)], 2)  # (2, B, lanes, width)
            red = red.reshape(2, b, lanes, width // slot, slot).sum(4)  # a unit's slots
            k_sum = red.sum(2)  # lanes in order
            per_group, k0 = cg // slot, ch0 // slot
            for g in range(k0 // per_group, (k0 + k_sum.shape[2] - 1) // per_group + 1):
                lo = max(k0, g * per_group) - k0
                hi = min(k0 + k_sum.shape[2], (g + 1) * per_group) - k0
                part[:, :, g] += k_sum[:, :, lo:hi].sum(2)
        parts.append(part)
    tot = torch.zeros(2, b, groups)
    for part in parts:  # rank order
        tot += part
    count = hw * cg
    mean = tot[0] / count
    rstd = torch.rsqrt(torch.clamp_min(tot[1] / count - mean * mean, 0.0) + eps)
    m, rs = mean.repeat_interleave(cg, 1)[:, None], rstd.repeat_interleave(cg, 1)[:, None]
    out = torch.full_like(x3, float("nan"))
    for rows in shares:
        for ch0, width, lanes in chunks:
            ch = slice(ch0, ch0 + width)
            for lr in lane_rows(rows, lanes):
                v = (x3[:, lr, ch] - m[..., ch]) * rs[..., ch] * scale[ch] + bias[ch]
                out[:, lr, ch] = common.apply_act(v, act, leak)
    return out.to(x.dtype).reshape(x.shape), torch.stack([mean, rstd])


# (shape, groups): the C >= 32 edges of the plan and its cluster.
EMULATED = [
    ((2, 20, 17, 40), 32),  # 40 -> 20 groups; 5 (bfloat16) or 10 (float32) units a row
    ((3, 7, 5, 36), 32),  # 36 -> 18 groups; no multiple of 8: one-channel units in bfloat16
    ((3, 9, 9, 96), 20),  # 16 groups of 6, astride the 8-channel units
    ((2, 4, 4, 520), 32),  # 26 groups of 20; 65 units, 3 lanes
    ((2, 3, 3, 2560), 32),  # more units than threads: 2 or 3 chunks, a group astride two
    ((5, 3, 1, 64), 32),  # HW 3: a cluster of 2, shares of 1 and 2 rows
    ((1, 128, 128, 64), 32),  # config5 dec_1: shares past shared memory, rows read twice
]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("plan_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,groups", EMULATED)
def test_cluster_kernel_emulation_matches_plain(shape, groups, plan_dtype, act):
    x, scale, bias = gn_operands(10, shape)
    gr = common.resolve_groups(shape[-1], groups)
    got, stats = emulate_group_norm_act_kernel(t(x), t(scale), t(bias), gr, 1e-5, act, 0.2,
                                               getattr(torch, plan_dtype))
    want = NA.group_norm_act_plain(t(x), t(scale), t(bias), groups=groups, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    xg = x.astype(np.float64).reshape(shape[0], -1, gr, shape[-1] // gr)
    np.testing.assert_allclose(stats[0].numpy(), xg.mean(axis=(1, 3)), **F32_TOL)
    np.testing.assert_allclose(stats[1].numpy(), 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5),
                               **F32_TOL)


@pytest.mark.parametrize("act", ACTS)
def test_cluster_of_16_emulation_matches_plain(act):
    """The 16-block cluster the plan takes for 1 MB planes at B = 32, on a
    small plane: 63 rows in shares of 3 and 4, 8 lanes of 8-channel units,
    and shares that keep 2 of their rows in shared memory."""
    shape, groups = (2, 9, 7, 64), 32
    x, scale, bias = gn_operands(15, shape)
    plan = NA._plan_for(2, 63, 64, groups, 16)._replace(keep_rows=2)
    got, stats = emulate_group_norm_act_kernel(t(x), t(scale), t(bias), groups, 1e-5, act, 0.2,
                                               torch.bfloat16, plan)
    want = NA.group_norm_act_plain(t(x), t(scale), t(bias), groups=groups, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    xg = x.astype(np.float64).reshape(2, -1, groups, 2)
    np.testing.assert_allclose(stats[0].numpy(), xg.mean(axis=(1, 3)), **F32_TOL)


# -- the plan -------------------------------------------------------------------------

# NA.gn_plan, a copy of csrc/gn_cluster.cuh's make_plan, at every (dtype, B,
# HW, C, groups) at which a layer of the five presets runs kernel 3:
# (cluster, rows_max, keep_rows, vec, smem, reread). Below 32 samples every
# cluster has 8 blocks; at B = 32 the planes whose 8-block shares take an SM
# each (1 MB and more) go to 16 blocks. The 2 MB bfloat16 plane (config5
# dec_1 and D conv_0_extra_0) at 8 blocks, and the float32 planes of 2 MB and
# more, spill past shared memory.
PRESET_PLANS = {
    ('bfloat16', 1, 16, 512, 32): (8, 2, 2, 8, 4624, 0),
    ('bfloat16', 1, 64, 512, 32): (8, 8, 8, 8, 10768, 0),
    ('bfloat16', 1, 256, 512, 32): (8, 32, 32, 8, 35344, 0),
    ('bfloat16', 1, 1024, 256, 32): (8, 128, 128, 8, 68112, 0),
    ('bfloat16', 1, 4096, 128, 32): (8, 512, 512, 8, 135696, 0),
    ('bfloat16', 1, 16384, 64, 32): (8, 2048, 1747, 8, 232336, 308224),
    ('bfloat16', 8, 16, 512, 32): (8, 2, 2, 8, 4624, 0),
    ('bfloat16', 8, 64, 512, 32): (8, 8, 8, 8, 10768, 0),
    ('bfloat16', 8, 256, 512, 32): (8, 32, 32, 8, 35344, 0),
    ('bfloat16', 8, 1024, 256, 32): (8, 128, 128, 8, 68112, 0),
    ('bfloat16', 8, 4096, 128, 32): (8, 512, 512, 8, 135696, 0),
    ('bfloat16', 8, 16384, 64, 32): (8, 2048, 1747, 8, 232336, 308224),
    ('bfloat16', 32, 16, 512, 32): (8, 2, 2, 8, 4624, 0),
    ('bfloat16', 32, 64, 512, 32): (8, 8, 8, 8, 10768, 0),
    ('bfloat16', 32, 256, 512, 32): (8, 32, 32, 8, 35344, 0),
    ('bfloat16', 32, 1024, 256, 32): (8, 128, 128, 8, 68112, 0),
    ('bfloat16', 32, 4096, 128, 32): (16, 256, 256, 8, 70160, 0),
    ('bfloat16', 32, 16384, 64, 32): (16, 1024, 1024, 8, 139792, 0),
    ('float32', 1, 16, 512, 32): (8, 2, 2, 4, 6672, 0),
    ('float32', 1, 64, 512, 32): (8, 8, 8, 4, 18960, 0),
    ('float32', 1, 256, 256, 32): (8, 32, 32, 4, 35344, 0),
    ('float32', 1, 256, 512, 32): (8, 32, 32, 4, 68112, 0),
    ('float32', 1, 1024, 256, 32): (8, 128, 128, 4, 133648, 0),
    ('float32', 1, 4096, 128, 32): (8, 512, 448, 4, 231952, 262144),
    ('float32', 1, 16384, 64, 32): (8, 2048, 889, 4, 232208, 2373632),
    ('float32', 8, 16, 512, 32): (8, 2, 2, 4, 6672, 0),
    ('float32', 8, 64, 512, 32): (8, 8, 8, 4, 18960, 0),
    ('float32', 8, 256, 256, 32): (8, 32, 32, 4, 35344, 0),
    ('float32', 8, 256, 512, 32): (8, 32, 32, 4, 68112, 0),
    ('float32', 8, 1024, 256, 32): (8, 128, 128, 4, 133648, 0),
    ('float32', 8, 4096, 128, 32): (8, 512, 448, 4, 231952, 262144),
    ('float32', 8, 16384, 64, 32): (8, 2048, 889, 4, 232208, 2373632),
    ('float32', 32, 16, 512, 32): (8, 2, 2, 4, 6672, 0),
    ('float32', 32, 64, 512, 32): (8, 8, 8, 4, 18960, 0),
    ('float32', 32, 256, 256, 32): (8, 32, 32, 4, 35344, 0),
    ('float32', 32, 256, 512, 32): (8, 32, 32, 4, 68112, 0),
    ('float32', 32, 1024, 256, 32): (16, 64, 64, 4, 68112, 0),
    ('float32', 32, 4096, 128, 32): (16, 256, 256, 4, 133648, 0),
    ('float32', 32, 16384, 64, 32): (16, 1024, 889, 4, 232208, 552960),
}


def kernel3_layers(preset, dtype, batch):
    """(name, HW, C, groups) of every layer of ``preset`` that runs kernel 3
    in ``dtype``: the models run on the meta device, routed as on the card."""
    m = dataclasses.replace(tcfg.get_preset(preset).model, compute_dtype=dtype)
    with torch.device("meta"):
        models = {"G": Generator(m), "D": Discriminator(m)}
    s = m.image_size
    frame = torch.empty(batch, s, s, m.image_channels, device="meta")
    action = torch.empty(batch, m.action_dim, device="meta")
    state = torch.empty(batch, m.state_dim, device="meta") if m.state_dim else None
    seen = []
    for prefix, model in models.items():
        hooks = [block.register_forward_hook(
            lambda mod, args, out, name=f"{prefix}.{name}": seen.append(
                (name, mod, tuple(args[0].shape), tuple(out.shape))))
            for name, block in model.named_children()]
        with torch.no_grad():
            model(frame, action, state) if prefix == "G" else model(frame, frame, action, state)
        for h in hooks:
            h.remove()
    return [(name, y[1] * y[2], y[3], common.resolve_groups(y[3], block.groups))
            for name, block, x, y in seen
            if block.norm == "group" and envelope.route(
                x, tuple(block.kernel.shape), block.stride, block.transpose, block.norm,
                block.groups, getattr(torch, dtype)) == "split"]


def check_plan_invariants(plan, dtype, b, hw, c, groups):
    esize = torch.empty((), dtype=dtype).element_size()
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cluster <= hw
    assert plan.cluster >= 8 or b * plan.cluster >= NA.FILL_BLOCKS or 2 * plan.cluster > hw
    if plan.cluster == 16:  # 8 blocks would each take an SM, in more than one round
        at8 = NA._plan_for(esize, hw, c, groups, 8)
        assert at8.smem > NA.TWO_PER_SM and b * 8 > NA.SMS
    assert plan.rows_max == -(-hw // plan.cluster) and 0 <= plan.keep_rows <= plan.rows_max
    assert plan.vec == (16 // esize if c % (16 // esize) == 0 else 1)
    assert 0 < plan.smem <= NA.SMEM_MAX
    slots = NA.unit_slots(plan.vec, c // groups)
    assert plan.smem >= plan.keep_rows * c * esize + 4 * (2 * NA.NT * slots + 4 * groups) + 16
    assert plan.reread == sum(max(len(NA.share_rows(hw, plan.cluster, q)) - plan.keep_rows, 0)
                              for q in range(plan.cluster)) * c * esize
    # A share that does not fit keeps as many rows as shared memory holds.
    assert plan.keep_rows == plan.rows_max or plan.smem + c * esize > NA.SMEM_MAX


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_plan_pinned_for_every_preset_layer_on_kernel_3(preset, dtype, batch):
    layers = kernel3_layers(preset, dtype, batch)
    # Only these run no kernel 3 (tests/test_torch_envelope.py's SPLIT).
    assert (not layers) == (preset in ("config1", "config2", "config4") and dtype == "bfloat16")
    for name, hw, c, groups in layers:
        plan = NA.gn_plan(getattr(torch, dtype), batch, hw, c, groups)
        assert tuple(plan) == PRESET_PLANS[(dtype, batch, hw, c, groups)], (name, plan)
        check_plan_invariants(plan, getattr(torch, dtype), batch, hw, c, groups)


# (dtype, B, HW, C, groups) -> plan at the edges: C no multiple of the unit,
# groups lowered, odd planes, fewer rows than blocks, batches that fill the
# card with smaller clusters, more channels than a row of units, the batch at
# which a 1 MB plane goes to 16 blocks (17), the float32 planes that spill.
EDGE_PLANS = {
    ('bfloat16', 3, 35, 40, 20): (8, 5, 5, 8, 8928, 0),
    ('bfloat16', 3, 35, 36, 18): (8, 5, 5, 1, 2720, 0),
    ('float32', 3, 35, 36, 18): (8, 5, 5, 4, 5120, 0),
    ('bfloat16', 2, 81, 96, 16): (8, 11, 11, 8, 18768, 0),
    ('bfloat16', 2, 35, 520, 26): (8, 5, 5, 8, 22016, 0),
    ('bfloat16', 2, 9, 2560, 32): (8, 2, 2, 8, 12816, 0),
    ('bfloat16', 5, 3, 64, 32): (2, 2, 2, 8, 8976, 0),
    ('float32', 4, 1, 64, 32): (1, 1, 1, 4, 4880, 0),
    ('bfloat16', 64, 256, 512, 32): (4, 64, 64, 8, 68112, 0),
    ('bfloat16', 128, 64, 512, 32): (2, 32, 32, 8, 35344, 0),
    ('bfloat16', 256, 16, 512, 32): (1, 16, 16, 8, 18960, 0),
    ('bfloat16', 256, 16384, 64, 32): (16, 1024, 1024, 8, 139792, 0),
    ('float32', 128, 4096, 128, 32): (16, 256, 256, 4, 133648, 0),
    ('bfloat16', 16, 4096, 128, 32): (8, 512, 512, 8, 135696, 0),
    ('bfloat16', 17, 4096, 128, 32): (16, 256, 256, 8, 70160, 0),
    ('float32', 2, 16384, 64, 32): (8, 2048, 889, 4, 232208, 2373632),
    ('float32', 32, 16384, 64, 32): (16, 1024, 889, 4, 232208, 552960),
}


@pytest.mark.parametrize("key", sorted(EDGE_PLANS))
def test_plan_pinned_at_edges(key):
    dtype, b, hw, c, groups = key
    plan = NA.gn_plan(getattr(torch, dtype), b, hw, c, groups)
    assert tuple(plan) == EDGE_PLANS[key], plan
    check_plan_invariants(plan, getattr(torch, dtype), b, hw, c, groups)


# -- backward --------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c,groups", [(32, 8), (96, 20)])
def test_autograd_function_matches_jax_pallas_vjp(act, c, groups):
    x, scale, bias = gn_operands(20, (2, 6, 5, c))
    ct = rand(23, 2, 6, 5, c)
    tx, ts, tb = (t(a).requires_grad_() for a in (x, scale, bias))
    out = NA.group_norm_act(tx, ts, tb, groups=groups, act=act)
    assert out.grad_fn.name() == "GroupNormActFnBackward"
    got = torch.autograd.grad(out, (tx, ts, tb), t(ct))
    jout, vjp = jax.vjp(lambda a, s, b: P.group_norm_act(a, s, b, groups=groups, act=act),
                        *map(jnp.asarray, (x, scale, bias)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for a, b, name in zip(got, vjp(jnp.asarray(ct)), ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)


def test_no_grad_path_keeps_no_residuals():
    x, scale, bias = (t(a) for a in gn_operands(30, (2, 4, 4, 32)))
    with torch.no_grad():
        out = NA.group_norm_act(x, scale.requires_grad_(), bias, groups=8)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), NA.group_norm_act_plain(x, scale, bias, groups=8)
                                  .detach().numpy())


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("saved_stats", [True, False])
def test_gn_act_bwd_with_bf16_y_matches_jax(act, saved_stats):
    """The backward behind the standalone kernel reads y in the compute
    dtype: the CPU path with a bfloat16 y against gn_act_grads on the same
    bfloat16 input, as the JAX VJP calls it."""
    shape, groups = (2, 5, 6, 64), 32
    y, scale, bias = gn_operands(40, shape)
    y = bf16(y)
    out = bf16(NA.group_norm_act_plain(t(y), t(scale), t(bias), groups=groups, act=act).numpy())
    g = bf16(rand(43, *shape))
    yg = y.astype(np.float64).reshape(2, -1, groups, 2)
    mean = yg.mean(axis=(1, 3)).astype(np.float32)
    rstd = (1 / np.sqrt(yg.var(axis=(1, 3)) + 1e-5)).astype(np.float32)
    stats = (mean, rstd) if saved_stats else (None, None)
    to = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    dx, dscale, dbias = gn_bwd.gn_act_bwd(to(y), t(scale), to(out), to(g), t(stats[0]),
                                          t(stats[1]), groups=groups, act=act)
    assert dx.dtype == torch.bfloat16 and dscale.dtype == torch.float32
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = JG.gn_act_grads(jb(y), jnp.asarray(scale), jb(out), jb(g), groups=groups, eps=1e-5,
                           act=act, leak=0.2,
                           mean=None if stats[0] is None else jnp.asarray(mean),
                           rstd=None if stats[1] is None else jnp.asarray(rstd))
    assert want[0].dtype == jnp.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want[0].astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want[1]), **F32_TOL)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want[2]), **F32_TOL)


# -- the split route ------------------------------------------------------------------


def test_split_layer_matches_jax_pallas_api():
    """config1's float32 D conv_3, (2, 8, 8, 256) -> (2, 4, 4, 512): off the
    fused envelope in both packages, so the plain conv then the GroupNorm
    kernel's op. Forward and dx, dw, dscale, dbias within 1e-3."""
    x = rand(50, 2, 8, 8, 256)
    w = rand(51, 4, 4, 256, 512, scale=1 / 64)
    scale, bias = rand(52, 512, scale=0.1, offset=1.0), rand(53, 512, scale=0.1)
    ct = rand(54, 2, 4, 4, 512)
    kw = dict(stride=2, kind="group", groups=32, act="lrelu")
    ins = [t(a).requires_grad_() for a in (x, w, scale, bias)]
    api.reset_routes()
    out = api.conv_norm_act(*ins, **kw)
    assert api.ROUTES == {**dict.fromkeys(api.ROUTES, 0), "split": 1}
    assert out.grad_fn.name() == "GroupNormActFnBackward"
    got = torch.autograd.grad(out, ins, t(ct))
    jout, vjp = jax.vjp(lambda *a: japi.conv_norm_act(*a, backend="pallas", **kw),
                        *map(jnp.asarray, (x, w, scale, bias)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for a, b, name in zip(got, vjp(jnp.asarray(ct)), ("dx", "dw", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)


def test_split_layer_bf16_matches_jax_pallas_api():
    """config3's bfloat16 D conv_4: the conv output is rounded to bfloat16
    before the norm in both packages."""
    x = bf16(rand(60, 2, 8, 8, 512))
    w = rand(61, 4, 4, 512, 512, scale=1 / 90)
    scale, bias = rand(62, 512, scale=0.1, offset=1.0), rand(63, 512, scale=0.1)
    kw = dict(stride=2, kind="group", groups=32, act="lrelu")
    api.reset_routes()
    with torch.no_grad():
        got = api.conv_norm_act(t(x).to(torch.bfloat16), t(w), t(scale), t(bias), **kw)
    assert api.ROUTES == {**dict.fromkeys(api.ROUTES, 0), "split": 1} and got.dtype == torch.bfloat16
    want = japi.conv_norm_act(jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, (w, scale, bias)),
                              backend="pallas", **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=1e-2)


def test_norm_act_off_the_kernel_envelope_takes_the_plain_composite():
    x, scale, bias = (t(a) for a in gn_operands(70, (2, 4, 4, 16)))  # C < 32
    got = api.norm_act(x, scale, bias, groups=4)
    want = japi.norm_act(*map(jnp.asarray, (x.numpy(), scale.numpy(), bias.numpy())), groups=4,
                         backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# -- model level: the config5 and config3 geometries at narrow widths --------------------

NARROW = {
    # 256x256 frames, 5 G levels, 6 D levels with one extra layer each; at
    # these widths 4 G layers and 3 D layers are off the fused envelope.
    "config5": dict(g_base_channels=32, g_max_channels=64, d_base_channels=32,
                    d_max_channels=64, group_norm_groups=4, compute_dtype="float32"),
    # 128x128 frames, 4 G levels, 5 D levels with one extra layer each.
    "config3": dict(g_base_channels=8, g_max_channels=32, d_base_channels=8, d_max_channels=32,
                    group_norm_groups=4, compute_dtype="float32"),
}
SPLIT_COUNTS = {("config5", "G"): 4, ("config5", "D"): 3, ("config3", "G"): 0, ("config3", "D"): 0}


def narrow_model(preset):
    return dataclasses.replace(jcfg.get_preset(preset).model, **NARROW[preset])


@pytest.mark.parametrize("preset", sorted(NARROW))
def test_generator_at_preset_geometry_matches_jax(preset):
    m = narrow_model(preset)
    s = m.image_size
    frame, action = np.tanh(rand(80, 1, s, s, 3)), rand(81, 1, 4)
    params = jax.jit(JaxGenerator(m).init)(jax.random.PRNGKey(0), frame, action)["params"]
    want = np.asarray(jax.jit(JaxGenerator(m).apply)({"params": params}, frame, action))
    gen = Generator(tcfg.ModelConfig(**dataclasses.asdict(m)))
    gen.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    api.reset_routes()
    with torch.no_grad():
        got = gen(torch.from_numpy(frame), torch.from_numpy(action))
    assert api.ROUTES["split"] == SPLIT_COUNTS[(preset, "G")]
    assert got.shape == (1, s, s, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("preset", sorted(NARROW))
def test_discriminator_at_preset_geometry_matches_jax(preset):
    """Logits, and the gradient of their sum with respect to the next frame
    and every parameter (the split layers through GroupNormActFn)."""
    m = narrow_model(preset)
    assert m.d_extra_layers == 1
    s = m.image_size
    nxt, frame = np.tanh(rand(90, 1, s, s, 3)), np.tanh(rand(91, 1, s, s, 3))
    action = rand(92, 1, 4)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JaxDiscriminator(m).init)(
        jax.random.PRNGKey(1), nxt, frame, action)["params"])

    def jloss(p, x):
        return JaxDiscriminator(m).apply({"params": p}, x, frame, action).sum()

    want, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, nxt)
    d = Discriminator(tcfg.ModelConfig(**dataclasses.asdict(m)))
    d.load_state_dict(flax_to_state_dict(params))
    x = torch.from_numpy(nxt).requires_grad_()
    api.reset_routes()
    logit = d(x, torch.from_numpy(frame), torch.from_numpy(action)).sum()
    assert api.ROUTES["split"] == SPLIT_COUNTS[(preset, "D")]
    logit.backward()
    np.testing.assert_allclose(float(logit.detach()), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **TOL)
    gp = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in d.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gp[name].numpy(), **TOL, err_msg=name)
