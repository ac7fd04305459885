"""Kernel 4's cluster design (``csrc/gn_act_bwd.cu``) on the CPU.

The GroupNorm + activation backward kernel is one thread-block cluster per
sample and a batch sum; the CUDA kernel cannot run here, so:

* its plan (``ops/kernels/gn_bwd.py:gn_bwd_plan``, the copy of
  ``acg_gn_bwd_plan``) is pinned at every GroupNorm layer's kernel-4 call of
  the five presets at their training batches (G at B, D at B*T in the G
  head and 2*B*T in the D update; config1 also at bench.py's B=128), in
  bfloat16 and float32, and at ragged edges;
* the kernel's decomposition is emulated in torch under that plan (shares by
  rank, lanes, copy stages, per-block per-channel sums, the scale-weighted
  group sums, the rank-order reduction, the per-sample partials and the
  batch sum in sample order) and held against the plain version
  (``gn_act_bwd_plain``) and the JAX package's Pallas kernel in interpret
  mode, as tests/test_torch_grad.py runs it.

Inputs are numpy arrays from seeds fed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.ops.pallas.gn_bwd import gn_act_bwd_pallas
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import common, envelope, reference
from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd
from action_conditioned_gans_tpu_torch.ops.kernels import gn_cluster as GC

torch.set_num_threads(1)
GN_TOL = dict(atol=2e-5, rtol=2e-5)  # float32, same formula, other summation order
BF16_DX_TOL = dict(atol=1e-2, rtol=8e-3)  # one bfloat16 step of |dx| (tests/test_torch_grad.py)
ACTS = ["lrelu", "relu", "tanh", "none"]
BF, F32 = torch.bfloat16, torch.float32


def rand(seed, *shape, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def round_to(a, dtype):
    """``a`` rounded to ``dtype`` and back to float32 numpy."""
    return t(a).to(dtype).float().numpy()


def gn_inputs(seed, shape, groups, act, dtype=F32, y_dtype=F32):
    """y (rounded to ``y_dtype``), scale, out = act(GroupNorm(y)) and a
    cotangent g (rounded to ``dtype``), and the forward's (mean, rstd)."""
    b, h, w, c = shape
    y = round_to(rand(seed, *shape, scale=1.5, offset=0.3), y_dtype)
    scale = rand(seed + 1, c, scale=0.2, offset=1.0)
    bias = rand(seed + 2, c, scale=0.1)
    out = round_to(reference.norm_act(t(y), t(scale), t(bias), groups=groups, act=act).numpy(), dtype)
    g = round_to(rand(seed + 3, *shape), dtype)
    gr = common.resolve_groups(c, groups)
    yg = y.astype(np.float64).reshape(b, h * w, gr, c // gr)
    mean = yg.mean(axis=(1, 3)).astype(np.float32)
    rstd = (1.0 / np.sqrt(yg.var(axis=(1, 3)) + 1e-5)).astype(np.float32)
    return y, scale, out, g, mean, rstd


# -- the emulation ------------------------------------------------------------------------


def fold_lanes(red):
    """``gnc::fold_lanes`` over dim 1 (lanes): four running sums over lanes
    l % 4, then added pairwise."""
    s = [red[:, i::4].sum(1) for i in range(4)]
    return (s[0] + s[1]) + (s[2] + s[3])


def emulate_gn_act_bwd_kernel(y, out, g, scale, mean, rstd, groups, act, leak, plan=None):
    """csrc/gn_act_bwd.cu step by step in torch, float32, under the kernel's
    plan for y's and out's dtypes (``gn_bwd.gn_bwd_plan``; or ``plan``).

    Each block of a sample's cluster holds its share of rows; per chunk of
    channel units each lane sums S1 = sum dpre and sum dpre * (y - mean) over
    its rows (the rows past the kept ones first, then the kept rows stage by
    stage), times rstd once; the lanes fold per channel; the block folds its
    per-channel sums, weighted by scale, into per-group sums; the blocks'
    group sums add in rank order into the two group means; block q adds
    channels [q*C/k, (q+1)*C/k) of every block's per-channel sums in rank
    order into the sample's (dbias_b, dscale_b); every lane writes dx for its
    rows; the batch sum adds the per-sample partials in sample order. Every
    row falls in exactly one lane, every channel in one block's slice, and
    every element of dx is written once. Returns (dx in out's dtype, dscale,
    dbias)."""
    b, h, w, c = y.shape
    hw, cg = h * w, c // groups
    p = plan or gn_bwd.gn_bwd_plan(y.dtype, out.dtype, b, hw, c, groups)
    y3, o3, g3 = (a.reshape(b, hw, c).float() for a in (y, out, g))
    mu = mean.float().repeat_interleave(cg, 1)[:, None]
    rs = rstd.float().repeat_interleave(cg, 1)[:, None]
    dpre = common.act_bwd(g3, o3, act, leak)
    centred = dpre * (y3 - mu)
    units = c // p.vec
    chunks = [(u0 * p.vec, min(GC.NT, units - u0) * p.vec, GC.NT // min(GC.NT, units - u0))
              for u0 in range(0, units, GC.NT)]  # (first channel, channels, lanes)
    shares = [GC.share_rows(hw, p.cluster, q) for q in range(p.cluster)]
    assert [r for rows in shares for r in rows] == list(range(hw))

    def lane_rows(rows, lanes):
        keep = min(len(rows), p.keep_rows)
        n_st = min(gn_bwd.STAGES, keep)
        stages = [range(s * keep // n_st, (s + 1) * keep // n_st) for s in range(n_st)]
        got = [[rows[r] for r in range(keep + lane, len(rows), lanes)]
               + [rows[r] for st in stages for r in st if r % lanes == lane] for lane in range(lanes)]
        assert sorted(r for lr in got for r in lr) == list(rows)
        return got

    ch = []  # per block: (B, 2, C) per-channel S1, S2
    for rows in shares:
        part = torch.full((b, 2, c), float("nan"))
        for ch0, width, lanes in chunks:
            sl = slice(ch0, ch0 + width)
            lr = lane_rows(rows, lanes)
            red1 = torch.stack([dpre[:, r, sl].sum(1) for r in lr], 1)  # (B, lanes, width)
            red2 = torch.stack([centred[:, r, sl].sum(1) for r in lr], 1) * rs[:, :, sl]
            part[:, 0, sl], part[:, 1, sl] = fold_lanes(red1), fold_lanes(red2)
        ch.append(part)
    tot = torch.zeros(b, 2, groups)
    for part in ch:  # rank order
        tot += (scale * part).reshape(b, 2, groups, cg).sum(3)
    per_sample = torch.full((b, 2, c), float("nan"))
    slices = [slice(q * c // p.cluster, (q + 1) * c // p.cluster) for q in range(p.cluster)]
    assert sum(s.stop - s.start for s in slices) == c
    for sl in slices:
        acc = torch.zeros(b, 2, sl.stop - sl.start)
        for part in ch:  # rank order
            acc += part[:, :, sl]
        per_sample[:, :, sl] = acc
    count = hw * cg
    m = (rstd * tot[:, 0] / count).repeat_interleave(cg, 1)[:, None]
    sq = (rstd * rstd * tot[:, 1] / count).repeat_interleave(cg, 1)[:, None]
    dx = torch.full_like(y3, float("nan"))
    for rows in shares:
        for ch0, width, lanes in chunks:
            sl = slice(ch0, ch0 + width)
            for r in lane_rows(rows, lanes):
                assert bool(dx[:, r, sl].isnan().all())
                dx[:, r, sl] = (dpre[:, r, sl] * (rs[:, :, sl] * scale[sl])
                                - ((y3[:, r, sl] - mu[:, :, sl]) * sq[:, :, sl] + m[:, :, sl]))
    dbias, dscale = torch.zeros(c), torch.zeros(c)
    for i in range(b):  # sample order
        dbias += per_sample[i, 0]
        dscale += per_sample[i, 1]
    return dx.to(out.dtype).reshape(y.shape), dscale, dbias


def emulate(seed, shape, groups, act, dtype, y_dtype, plan=None):
    """(emulated kernel, plain version in float32 on the same values)."""
    y, scale, out, g, mean, rstd = gn_inputs(seed, shape, groups, act, dtype, y_dtype)
    gr = common.resolve_groups(shape[-1], groups)
    got = emulate_gn_act_bwd_kernel(t(y).to(y_dtype), t(out).to(dtype), t(g).to(dtype), t(scale),
                                    t(mean), t(rstd), gr, act, 0.2, plan)
    want = gn_bwd.gn_act_bwd_plain(t(y), t(scale), t(out), t(g), t(mean), t(rstd), groups=groups,
                                   act=act)
    return got, want


def assert_close(got, want, dtype):
    assert got[0].dtype == dtype
    np.testing.assert_allclose(got[0].float().numpy(), want[0].float().numpy(),
                               **(GN_TOL if dtype == F32 else BF16_DX_TOL), err_msg="dx")
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **GN_TOL, err_msg="dscale")
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), **GN_TOL, err_msg="dbias")


# (dtype of out, g and dx; dtype of y): the fused layers' float32 y in either
# compute dtype, and the split layers' bfloat16 y.
PAIRS = [(F32, F32), (BF, F32), (BF, BF)]

# (shape, groups): the ragged shapes of chip_smoke.py's kernel-4 parity and
# the edges of the plan (one block a sample, but for the 2560-channel plane
# with a float32 y and the one-sample plane).
EMULATED = [
    ((3, 7, 9, 5), 32),  # 5 -> 5 groups of 1; one-channel units
    ((2, 5, 11, 80), 32),  # 80 -> 20 groups of 4, half a unit each
    ((3, 9, 9, 12), 8),  # 12 -> 6 groups of 2; one-channel units in bfloat16
    ((2, 13, 3, 48), 32),  # 48 -> 24 groups
    ((3, 7, 5, 36), 32),  # 36 -> 18 groups; no multiple of 8
    ((2, 3, 3, 2560), 32),  # more units than threads: chunks; 1 to 4 blocks
    ((5, 3, 1, 64), 32),  # HW 3: fewer rows than lanes
    ((1, 16, 16, 512), 32),  # one sample: 4 or 8 blocks, four copy stages
]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype,y_dtype", PAIRS)
@pytest.mark.parametrize("shape,groups", EMULATED)
def test_cluster_kernel_emulation_matches_plain(shape, groups, dtype, y_dtype, act):
    got, want = emulate(10, shape, groups, act, dtype, y_dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("cluster", [2, 8])
@pytest.mark.parametrize("dtype,y_dtype", PAIRS)
@pytest.mark.parametrize("shape,groups", EMULATED[:6])
def test_forced_cluster_emulation_matches_plain(shape, groups, dtype, y_dtype, cluster):
    """The ragged shapes under clusters of 2 and 8 blocks (their own plans
    take one block a sample): shares by rank, the rank-order reductions and
    the per-channel slices of a multi-block cluster."""
    b, h, w, c = shape
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    rows = gn_bwd._rows(size(y_dtype), size(dtype), c, common.resolve_groups(c, groups))
    plan = GC.plan_at(*rows, h * w, cluster)
    got, want = emulate(25, shape, groups, "lrelu", dtype, y_dtype, plan)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype,y_dtype", PAIRS)
def test_rows_read_twice_emulation_matches_plain(dtype, y_dtype, act):
    """A 16-block cluster whose shares keep 3 of their 4 or 5 rows in shared
    memory (the rest read from global memory in both phases), over 70 rows
    of 8-channel units: the reread path of the planes past a cluster."""
    shape, groups = (2, 7, 10, 64), 32
    rows, vec, scratch = gn_bwd._rows(4 if y_dtype == F32 else 2, 4 if dtype == F32 else 2, 64, 32)
    plan = GC.plan_at(rows, vec, scratch, 70, 16)._replace(keep_rows=3)
    got, want = emulate(15, shape, groups, act, dtype, y_dtype, plan)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,groups", [(16, 4), (24, 32), (64, 32)])  # 24/32 -> 24 groups of 1
def test_emulation_matches_jax_pallas_kernel(act, dtype, c, groups):
    """The emulated kernel against the JAX package's Pallas kernel in
    interpret mode on the same inputs: y float32 (the port's forward
    scratch), out and g in the compute dtype; tests/test_torch_grad.py's
    bars."""
    tdt = getattr(torch, dtype)
    y, scale, out, g, mean, rstd = gn_inputs(20, (2, 5, 6, c), groups, act, tdt)
    gr = common.resolve_groups(c, groups)
    dx, dscale, dbias = emulate_gn_act_bwd_kernel(t(y), t(out).to(tdt), t(g).to(tdt), t(scale),
                                                  t(mean), t(rstd), gr, act, 0.2)
    want = gn_act_bwd_pallas(
        jnp.asarray(y), jnp.asarray(scale), jnp.asarray(out).astype(jnp.dtype(dtype)),
        jnp.asarray(g).astype(jnp.dtype(dtype)), jnp.asarray(mean), jnp.asarray(rstd), groups=gr,
        act=act, leak=0.2)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want[0]),
                               **(GN_TOL if dtype == "float32" else BF16_DX_TOL))
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want[1]), **GN_TOL)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want[2]), **GN_TOL)


# -- the plan ---------------------------------------------------------------------------


def k4_calls(preset, dtype):
    """(y dtype, B, HW, C, groups) of every kernel-4 call of one training step
    of ``preset`` in ``dtype``: each GroupNorm layer of G at B and of D at
    B*T (the G head) and 2*B*T (the D update); config1 also at bench.py's
    B = 128. A fused layer's y is float32, a split layer's is in the compute
    dtype. The models run on the meta device, routed as on the card."""
    cfg = tcfg.get_preset(preset)
    m = dataclasses.replace(cfg.model, compute_dtype=dtype)
    with torch.device("meta"):
        models = {"G": Generator(m), "D": Discriminator(m)}
    s = m.image_size
    frame = torch.empty(1, s, s, m.image_channels, device="meta")
    action = torch.empty(1, m.action_dim, device="meta")
    state = torch.empty(1, m.state_dim, device="meta") if m.state_dim else None
    seen = []
    for prefix, model in models.items():
        hooks = [block.register_forward_hook(
            lambda mod, args, out, name=prefix: seen.append((name, mod, tuple(args[0].shape),
                                                             tuple(out.shape))))
            for block in model.children()]
        with torch.no_grad():
            model(frame, action, state) if prefix == "G" else model(frame, frame, action, state)
        for hk in hooks:
            hk.remove()
    b, steps = cfg.train.batch_size, cfg.train.rollout_length
    batches = {"G": [b], "D": [b * steps, 2 * b * steps]}
    if preset == "config1":
        batches = {"G": [b, 128], "D": [b, 2 * b, 128, 256]}
    calls = set()
    for model, block, x, yshape in seen:
        if block.norm != "group":
            continue
        split = envelope.route(x, tuple(block.kernel.shape), block.stride, block.transpose,
                               block.norm, block.groups, getattr(torch, dtype)) == "split"
        for n in batches[model]:
            calls.add((dtype if split else "float32", n, yshape[1] * yshape[2], yshape[3],
                       common.resolve_groups(yshape[3], block.groups)))
    return sorted(calls)


# gn_bwd.gn_bwd_plan at every kernel-4 call of the five presets' training
# steps: (y dtype, out dtype, B, HW, C, groups) -> (cluster, rows_max,
# keep_rows, vec, smem, reread): the smallest cluster whose shares fit. The
# 2 MB planes (64x64x64 with a float32 y) take 16 blocks; the config5 planes
# of 6 MB and more in bfloat16 and 4 MB and more in float32 read rows twice.
PRESET_PLANS = {
    ('bfloat16', 'bfloat16', 32, 16, 512, 32): (1, 16, 16, 8, 80416, 0),
    ('bfloat16', 'bfloat16', 32, 64, 512, 32): (1, 64, 64, 8, 227872, 0),
    ('bfloat16', 'bfloat16', 32, 256, 512, 32): (4, 64, 64, 8, 227872, 0),
    ('bfloat16', 'bfloat16', 32, 1024, 256, 32): (8, 128, 128, 8, 220704, 0),
    ('bfloat16', 'bfloat16', 32, 4096, 128, 32): (16, 256, 256, 8, 217120, 0),
    ('bfloat16', 'bfloat16', 32, 16384, 64, 32): (16, 1024, 556, 8, 232224, 2875392),
    ('bfloat16', 'bfloat16', 64, 16, 512, 32): (1, 16, 16, 8, 80416, 0),
    ('bfloat16', 'bfloat16', 960, 16, 512, 32): (1, 16, 16, 8, 80416, 0),
    ('bfloat16', 'bfloat16', 960, 64, 512, 32): (1, 64, 64, 8, 227872, 0),
    ('bfloat16', 'bfloat16', 960, 256, 512, 32): (4, 64, 64, 8, 227872, 0),
    ('bfloat16', 'bfloat16', 960, 4096, 128, 32): (16, 256, 256, 8, 217120, 0),
    ('bfloat16', 'bfloat16', 960, 16384, 64, 32): (16, 1024, 556, 8, 232224, 2875392),
    ('bfloat16', 'bfloat16', 1920, 16, 512, 32): (1, 16, 16, 8, 80416, 0),
    ('bfloat16', 'bfloat16', 1920, 64, 512, 32): (1, 64, 64, 8, 227872, 0),
    ('bfloat16', 'bfloat16', 1920, 256, 512, 32): (4, 64, 64, 8, 227872, 0),
    ('bfloat16', 'bfloat16', 1920, 4096, 128, 32): (16, 256, 256, 8, 217120, 0),
    ('bfloat16', 'bfloat16', 1920, 16384, 64, 32): (16, 1024, 556, 8, 232224, 2875392),
    ('float32', 'bfloat16', 8, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 8, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 8, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 8, 1024, 64, 32): (4, 256, 256, 8, 149792, 0),
    ('float32', 'bfloat16', 16, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 16, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 16, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 16, 1024, 64, 32): (4, 256, 256, 8, 149792, 0),
    ('float32', 'bfloat16', 32, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 32, 64, 512, 32): (2, 32, 32, 8, 162336, 0),
    ('float32', 'bfloat16', 32, 256, 256, 32): (4, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 32, 1024, 128, 32): (8, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 32, 1024, 256, 32): (16, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 32, 4096, 64, 32): (16, 256, 256, 8, 149792, 0),
    ('float32', 'bfloat16', 64, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 64, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 64, 64, 512, 32): (2, 32, 32, 8, 162336, 0),
    ('float32', 'bfloat16', 64, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 64, 256, 256, 32): (4, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 64, 1024, 64, 32): (4, 256, 256, 8, 149792, 0),
    ('float32', 'bfloat16', 64, 1024, 128, 32): (8, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 64, 4096, 64, 32): (16, 256, 256, 8, 149792, 0),
    ('float32', 'bfloat16', 128, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 128, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 128, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 128, 1024, 64, 32): (4, 256, 256, 8, 149792, 0),
    ('float32', 'bfloat16', 160, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 160, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 160, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 256, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 256, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 256, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 320, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 320, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 320, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 640, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 640, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 640, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 960, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 960, 64, 512, 32): (2, 32, 32, 8, 162336, 0),
    ('float32', 'bfloat16', 960, 1024, 256, 32): (16, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 1280, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 1280, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 'bfloat16', 1280, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 'bfloat16', 1920, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 'bfloat16', 1920, 64, 512, 32): (2, 32, 32, 8, 162336, 0),
    ('float32', 'bfloat16', 1920, 1024, 256, 32): (16, 64, 64, 8, 155168, 0),
    ('float32', 'float32', 8, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 8, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 8, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 8, 1024, 64, 32): (4, 256, 256, 4, 207136, 0),
    ('float32', 'float32', 16, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 16, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 16, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 16, 1024, 64, 32): (4, 256, 256, 4, 207136, 0),
    ('float32', 'float32', 32, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 32, 64, 512, 32): (2, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 32, 256, 256, 32): (4, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 32, 256, 512, 32): (8, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 32, 1024, 128, 32): (8, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 32, 1024, 256, 32): (16, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 32, 4096, 64, 32): (16, 256, 256, 4, 207136, 0),
    ('float32', 'float32', 32, 4096, 128, 32): (16, 256, 143, 4, 231968, 2777088),
    ('float32', 'float32', 32, 16384, 64, 32): (16, 1024, 288, 4, 231712, 9043968),
    ('float32', 'float32', 64, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 64, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 64, 64, 512, 32): (2, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 64, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 64, 256, 256, 32): (4, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 64, 1024, 64, 32): (4, 256, 256, 4, 207136, 0),
    ('float32', 'float32', 64, 1024, 128, 32): (8, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 64, 4096, 64, 32): (16, 256, 256, 4, 207136, 0),
    ('float32', 'float32', 128, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 128, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 128, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 128, 1024, 64, 32): (4, 256, 256, 4, 207136, 0),
    ('float32', 'float32', 160, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 160, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 160, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 256, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 256, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 256, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 320, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 320, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 320, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 640, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 640, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 640, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 960, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 960, 64, 512, 32): (2, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 960, 256, 512, 32): (8, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 960, 1024, 256, 32): (16, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 960, 4096, 128, 32): (16, 256, 143, 4, 231968, 2777088),
    ('float32', 'float32', 960, 16384, 64, 32): (16, 1024, 288, 4, 231712, 9043968),
    ('float32', 'float32', 1280, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 1280, 64, 256, 32): (1, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 1280, 256, 128, 32): (2, 128, 128, 4, 208928, 0),
    ('float32', 'float32', 1920, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'float32', 1920, 64, 512, 32): (2, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 1920, 256, 512, 32): (8, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 1920, 1024, 256, 32): (16, 64, 64, 4, 212512, 0),
    ('float32', 'float32', 1920, 4096, 128, 32): (16, 256, 143, 4, 231968, 2777088),
    ('float32', 'float32', 1920, 16384, 64, 32): (16, 1024, 288, 4, 231712, 9043968),
}


def check_plan_invariants(plan, y_dtype, dtype, b, hw, c, groups):
    yb, tb = (torch.empty((), dtype=d).element_size() for d in (y_dtype, dtype))
    row = c * (yb + 2 * tb)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cluster <= hw
    rows = gn_bwd._rows(yb, tb, c, groups)
    # The smallest cluster whose shares fit: half as many blocks would not.
    if plan.cluster > 1:
        half = GC.plan_at(*rows, hw, plan.cluster // 2)
        assert half.keep_rows < half.rows_max
    # Rows read twice only where no cluster fits them.
    assert plan.reread == 0 or plan.cluster == 16 or 2 * plan.cluster > hw
    assert plan.rows_max == -(-hw // plan.cluster) and 0 <= plan.keep_rows <= plan.rows_max
    assert plan.vec == (16 // tb if c % (16 // tb) == 0 else 1)
    assert 0 < plan.smem <= GC.SMEM_MAX
    scratch = 8 * gn_bwd.STAGES + 4 * (2 * GC.NT * plan.vec + 7 * c + 4 * groups)
    assert plan.smem >= plan.keep_rows * row + scratch
    assert plan.reread == sum(max(len(GC.share_rows(hw, plan.cluster, q)) - plan.keep_rows, 0)
                              for q in range(plan.cluster)) * row
    # A share that does not fit keeps as many rows as shared memory holds.
    assert plan.keep_rows == plan.rows_max or plan.smem + row > GC.SMEM_MAX


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_plan_pinned_at_every_preset_kernel4_call(preset, dtype):
    calls = k4_calls(preset, dtype)
    assert calls
    for y_dtype, b, hw, c, groups in calls:
        args = (getattr(torch, y_dtype), getattr(torch, dtype), b, hw, c, groups)
        plan = gn_bwd.gn_bwd_plan(*args)
        assert tuple(plan) == PRESET_PLANS[(y_dtype, dtype, b, hw, c, groups)], (args, plan)
        check_plan_invariants(plan, *args)


def test_main_path_plans_read_once():
    """The config1 step at B=128 (G and D's G head) and B=256 (D update) and
    the config3 step at B=32 and B=64: no row read twice, every share in
    shared memory; the 2 MB planes (64x64x64, float32 y) take 16 blocks,
    the 8x8x512 layers 2 blocks a sample (the parent's first pass ran 32
    blocks there at B=32, this plan 64)."""
    for preset, batches in (("config1", (128, 256)), ("config3", (32, 64))):
        for y_dtype, b, hw, c, groups in k4_calls(preset, "bfloat16"):
            if preset == "config1" and b not in batches:
                continue
            plan = gn_bwd.gn_bwd_plan(getattr(torch, y_dtype), BF, b, hw, c, groups)
            assert plan.reread == 0 and plan.keep_rows == plan.rows_max, (b, hw, c, plan)
            if (hw, c, y_dtype) == (4096, 64, "float32"):
                assert plan.cluster == 16
            if (hw, c, y_dtype) == (64, 512, "float32"):
                assert plan.cluster == 2


# (y dtype, out dtype, B, HW, C, groups) -> plan at the edges: the ragged
# parity shapes (one block a sample), C no multiple of the unit, more
# channels than a row of units, 3 rows, one sample, the 2 MB plane at B=2
# (16 blocks, every row kept) and a float32 plane past a cluster's shared
# memory (rows read twice).
EDGE_PLANS = {
    ('float32', 'float32', 3, 63, 5, 5): (1, 63, 63, 1, 6096, 0),
    ('float32', 'float32', 2, 55, 80, 20): (1, 55, 55, 4, 63584, 0),
    ('float32', 'float32', 3, 81, 12, 6): (1, 81, 81, 4, 20320, 0),
    ('float32', 'float32', 2, 39, 48, 24): (1, 39, 39, 4, 32416, 0),
    ('float32', 'float32', 3, 35, 36, 18): (1, 35, 35, 4, 24640, 0),
    ('float32', 'float32', 2, 9, 2560, 32): (4, 3, 3, 4, 172576, 0),
    ('float32', 'float32', 5, 3, 64, 32): (1, 3, 3, 4, 12832, 0),
    ('float32', 'float32', 1, 256, 512, 32): (8, 32, 32, 4, 219680, 0),
    ('float32', 'float32', 256, 16, 512, 32): (1, 16, 16, 4, 121376, 0),
    ('float32', 'bfloat16', 3, 63, 5, 5): (1, 63, 63, 1, 4832, 0),
    ('float32', 'bfloat16', 2, 55, 80, 20): (1, 55, 55, 8, 54176, 0),
    ('float32', 'bfloat16', 3, 81, 12, 6): (1, 81, 81, 1, 10288, 0),
    ('float32', 'bfloat16', 2, 39, 48, 24): (1, 39, 39, 8, 33120, 0),
    ('float32', 'bfloat16', 3, 35, 36, 18): (1, 35, 35, 1, 13456, 0),
    ('float32', 'bfloat16', 2, 9, 2560, 32): (2, 5, 5, 8, 191008, 0),
    ('float32', 'bfloat16', 5, 3, 64, 32): (1, 3, 3, 8, 20256, 0),
    ('float32', 'bfloat16', 1, 256, 512, 32): (8, 32, 32, 8, 162336, 0),
    ('float32', 'bfloat16', 256, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('bfloat16', 'bfloat16', 3, 63, 5, 5): (1, 63, 63, 1, 4208, 0),
    ('bfloat16', 'bfloat16', 2, 55, 80, 20): (1, 55, 55, 8, 45376, 0),
    ('bfloat16', 'bfloat16', 3, 81, 12, 6): (1, 81, 81, 1, 8352, 0),
    ('bfloat16', 'bfloat16', 2, 39, 48, 24): (1, 39, 39, 8, 29376, 0),
    ('bfloat16', 'bfloat16', 3, 35, 36, 18): (1, 35, 35, 1, 10944, 0),
    ('bfloat16', 'bfloat16', 2, 9, 2560, 32): (1, 9, 9, 8, 226848, 0),
    ('bfloat16', 'bfloat16', 5, 3, 64, 32): (1, 3, 3, 8, 19872, 0),
    ('bfloat16', 'bfloat16', 1, 256, 512, 32): (4, 64, 64, 8, 227872, 0),
    ('bfloat16', 'bfloat16', 256, 16, 512, 32): (1, 16, 16, 8, 80416, 0),
    ('float32', 'bfloat16', 2, 4096, 64, 32): (16, 256, 256, 8, 149792, 0),
    ('float32', 'float32', 2, 4096, 64, 32): (16, 256, 256, 4, 207136, 0),
    ('float32', 'float32', 2, 16384, 64, 32): (16, 1024, 288, 4, 231712, 9043968),
    ('float32', 'bfloat16', 17, 4096, 64, 32): (16, 256, 256, 8, 149792, 0),
}


@pytest.mark.parametrize("key", sorted(EDGE_PLANS))
def test_plan_pinned_at_edges(key):
    y_dtype, dtype, b, hw, c, groups = key
    args = (getattr(torch, y_dtype), getattr(torch, dtype), b, hw, c, groups)
    plan = gn_bwd.gn_bwd_plan(*args)
    assert tuple(plan) == EDGE_PLANS[key], plan
    check_plan_invariants(plan, *args)


def test_no_plan_when_the_scratch_overflows_a_block():
    """Per-channel sums of 2 x 30000 channels do not fit shared memory: the
    plan says so (smem < 0) and the wrapper raises for a CUDA tensor."""
    assert gn_bwd.gn_bwd_plan(F32, F32, 2, 4, 30000, 32).smem < 0


def test_kernel3_plan_unchanged_by_the_shared_plan():
    """Kernel 3's plan goes through the same gn_cluster.choose_plan: the
    config5 dec_1 plane at B=32 and B=8 as tests/test_torch_norm_act.py pins."""
    from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

    assert tuple(norm_act.gn_plan(BF, 32, 16384, 64, 32)) == (16, 1024, 1024, 8, 139792, 0)
    assert tuple(norm_act.gn_plan(BF, 8, 16384, 64, 32)) == (8, 2048, 1747, 8, 232336, 308224)
