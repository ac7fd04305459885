"""The kernel calls of chip_smoke.py's training and serving paths, derived on
the CPU: each step runs once on the meta device (shapes only, routed as on
the card) with every kernel wrapper recorded.

* ``chip_smoke.EXPECTED`` (launches of kernels 1-5, kernels 1-2 by
  mainloop, routes, kernel-4 calls that read a bfloat16 y) equals what the
  recorded calls give for every path the script holds to it: the config1,
  config2, config3, config4 and config5 steps at the script's sizes and
  overrides, and phase 18's steps (config1 with R1 and with batch norm,
  config5 with the engine knobs), phase 22's flat step (config1 with
  ``train.flatten_optimizer``), and the generator calls of config1,
  config1 with batch norm, config4 and config5 serving; and
  ``chip_smoke.EXPECTED_ROUTES``, the other routes each path takes (bare
  convs, the plain route of R1's inner D call, the engines' rewrites and
  im2col weight gradients).
* Kernel 1's tile plan, kernel 3's plan and kernel 4's plan are pinned at
  every distinct call of the config4 step (B=64, T=10: G at 64, D at 640 and
  1280) and the config5 step (B=32, T=30, time chunks of 2, D in chunks of
  240: G at 64, D at 240 and 480), beside the preset pins of
  tests/test_torch_conv_wgmma.py, test_torch_norm_act.py and
  test_torch_gn_bwd_cluster.py; config5's kernel-4 calls on planes past a
  cluster's shared memory read rows twice.
"""

import collections
import contextlib
import dataclasses
import sys

import pytest
import torch
import torch.distributed as dist
from test_torch_conv_transpose_wgmma import transpose_tile
from test_torch_conv_wgmma import conv_tile

import chip_smoke
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.cli import apply_overrides
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import api
from action_conditioned_gans_tpu_torch.ops.common import resolve_groups, same_pad
from action_conditioned_gans_tpu_torch.ops.kernels import adam, conv, gn_bwd, norm_act
from action_conditioned_gans_tpu_torch.infer import grid_replica
from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
from action_conditioned_gans_tpu_torch.parallel.mesh import Mesh
from action_conditioned_gans_tpu_torch.parallel.tp import shard_state
from action_conditioned_gans_tpu_torch.train.state import state_from_params
from action_conditioned_gans_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)
META = torch.device("meta")

Call = collections.namedtuple("Call", "kernel shape w_shape stride kind groups y_bf16 bf16")


def record(run):
    """``run()`` with every kernel wrapper recorded: (calls, routes). A
    kernel-4 call reads a bfloat16 y on the card when it comes from a split
    layer's GroupNormActFn (the fused blocks keep a float32 y)."""
    calls, real = [], dict(k1=conv.conv_norm_act, k2=conv.conv_transpose_norm_act,
                           k3=norm_act.group_norm_act, k4=gn_bwd.gn_act_bwd, k5=adam.adam_flat)

    def k1(x, w, s, b, **kw):
        calls.append(Call("k1", tuple(x.shape), tuple(w.shape), kw["stride"], kw["kind"],
                          kw["groups"], None, x.dtype == torch.bfloat16))
        return real["k1"](x, w, s, b, **kw)

    def k2(x, w, s, b, **kw):
        calls.append(Call("k2", tuple(x.shape), tuple(w.shape), 2, kw["kind"], kw["groups"], None,
                          x.dtype == torch.bfloat16))
        return real["k2"](x, w, s, b, **kw)

    def k3(x, s, b, **kw):
        calls.append(Call("k3", tuple(x.shape), None, None, "group", kw["groups"], None,
                          x.dtype == torch.bfloat16))
        return real["k3"](x, s, b, **kw)

    def k4(y, *args, **kw):
        split = sys._getframe(1).f_code.co_filename.endswith("norm_act.py")
        calls.append(Call("k4", tuple(y.shape), None, None, "group", kw["groups"], split,
                          y.dtype == torch.bfloat16))
        return real["k4"](y, *args, **kw)

    def k5(p, *args, **kw):
        calls.append(Call("k5", tuple(p.shape), None, None, None, None, None, False))
        return real["k5"](p, *args, **kw)

    conv.conv_norm_act, conv.conv_transpose_norm_act = k1, k2
    norm_act.group_norm_act, gn_bwd.gn_act_bwd, adam.adam_flat = k3, k4, k5
    api.reset_routes()
    try:
        run()
    finally:
        conv.conv_norm_act, conv.conv_transpose_norm_act = real["k1"], real["k2"]
        norm_act.group_norm_act, gn_bwd.gn_act_bwd = real["k3"], real["k4"]
        adam.adam_flat = real["k5"]
    return calls, dict(api.ROUTES)


def step_calls(cfg):
    """One training step of ``cfg`` on meta tensors."""
    m, t = cfg.model, cfg.train
    with META:
        gen, disc = Generator(m), Discriminator(m)
    state = state_from_params(cfg, gen.state_dict(), disc.state_dict(), device=META)
    b, horizon, s = t.batch_size, max(t.rollout_length, 1), m.image_size
    batch = {"frames": torch.zeros((b, horizon + 1, s, s, m.image_channels), device=META),
             "actions": torch.zeros((b, horizon, m.action_dim), device=META)}
    if m.state_dim:
        batch["states"] = torch.zeros((b, horizon, m.state_dim), device=META)
    step = make_train_step(cfg, device=META)
    return record(lambda: step(state, batch))


def generator_calls(preset, batch):
    """One generator call of ``preset`` (a name or a ModelConfig) at
    ``batch`` on meta tensors."""
    m = tcfg.get_preset(preset).model if isinstance(preset, str) else preset
    with META:
        gen = Generator(m)
        s = m.image_size
        args = (torch.empty(batch, s, s, m.image_channels), torch.empty(batch, m.action_dim),
                torch.empty(batch, m.state_dim) if m.state_dim else None)
    with torch.no_grad():
        return record(lambda: gen(*args))


@contextlib.contextmanager
def one_rank_of(size):
    """The collectives of a channel-sharded run seen from rank 0 of every
    group of ``size`` ranks, on meta tensors (shapes only): a gather makes
    ``size`` copies of the shard, a reduce changes nothing."""
    real = {n: getattr(dist, n) for n in ("get_world_size", "get_rank", "all_gather",
                                          "all_reduce")}

    def all_gather(parts, t, group=None):
        for p in parts:
            p.copy_(t)

    dist.get_world_size = lambda group=None: size
    dist.get_rank = lambda group=None: 0
    dist.all_gather = all_gather
    dist.all_reduce = lambda t, op=None, group=None: None
    try:
        yield object()
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def tp_step_calls(cfg, data, model):
    """One training step of ``cfg`` by rank 0 of a (``data``, ``model``)
    mesh on meta tensors: its channel shard of the state and its rows of the
    global batch (one step a call)."""
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, steps_per_call=1))
    m, t = cfg.model, cfg.train
    with META:
        gen, disc = Generator(m), Discriminator(m)
    state = shard_state(state_from_params(cfg, gen.state_dict(), disc.state_dict(), device=META),
                        0, model)
    b, horizon, s = t.batch_size // data, max(t.rollout_length, 1), m.image_size
    batch = {"frames": torch.zeros((b, horizon + 1, s, s, m.image_channels), device=META),
             "actions": torch.zeros((b, horizon, m.action_dim), device=META)}
    if m.state_dim:
        batch["states"] = torch.zeros((b, horizon, m.state_dim), device=META)
    with one_rank_of(model) as group:
        mesh = Mesh(rank=0, world=data * model, data=data, model=model, device=META,
                    group=group, data_group=group if data > 1 else None, model_group=group)
        step = make_dp_train_step(cfg, mesh)
        return record(lambda: step(state, batch))


def grid_generator_calls(preset, batch, columns):
    """One generator call of ``preset`` at ``batch`` by a row of a serving
    grid of ``columns`` meta devices (``infer.grid_replica``)."""
    m = tcfg.get_preset(preset).model
    with META:
        gen = Generator(m)
        s = m.image_size
        args = (torch.empty(batch, s, s, m.image_channels), torch.empty(batch, m.action_dim),
                torch.empty(batch, m.state_dim) if m.state_dim else None)
    row = grid_replica(gen.requires_grad_(False), [META] * columns)
    with torch.no_grad():
        return record(lambda: row(*args))


def mainloop(c):
    b, h, w, cin = c.shape
    cout = c.w_shape[3]
    if c.kernel == "k1":
        pixels = same_pad(h, c.w_shape[0], c.stride)[0] * same_pad(w, c.w_shape[1], c.stride)[0]
        return conv_tile(int(c.bf16), cin, cout, pixels, b)[0]
    return transpose_tile(int(c.bf16), cin, cout, int(c.kind == "group"), h, w, b)[0]


def counts(calls, routes):
    """The calls in EXPECTED's layout."""
    names = dict(k1="conv_norm_act", k2="conv_transpose_norm_act", k3="group_norm_act",
                 k4="gn_act_bwd", k5="adam_flat")
    launches = {n: sum(1 for c in calls if c.kernel == k) for k, n in names.items()}
    by = collections.defaultdict(collections.Counter)
    for c in calls:
        if c.kernel in ("k1", "k2"):
            by[names[c.kernel]][mainloop(c)] += 1
    y_bf16 = sum(1 for c in calls if c.kernel == "k4" and c.y_bf16 and c.bf16)
    return launches, {k: dict(v) for k, v in by.items()}, (routes["fused"], routes["split"]), y_bf16


def smoke_config(preset, overrides):
    return apply_overrides(tcfg.get_preset(preset), overrides)


STEP_PATHS = {
    "config1 step": lambda: chip_smoke.config1_train_config(),
    "config2 step": lambda: tcfg.get_preset("config2"),
    "config3 step": lambda: tcfg.get_preset("config3"),
    "config4 step": lambda: smoke_config("config4", chip_smoke.CONFIG4_OVERRIDES),
    "config5 step": lambda: smoke_config("config5", chip_smoke.CONFIG5_OVERRIDES),
    **{path: (lambda path=path: chip_smoke.phase18_config(path)) for path in chip_smoke.PHASE18_OVERRIDES},
    "config1 flat step": lambda: chip_smoke.flat_train_config(),
}


@pytest.fixture(scope="module")
def steps():
    return {path: step_calls(make()) for path, make in STEP_PATHS.items()}


def other_routes(routes):
    """The routes beside (fused, split), as EXPECTED_ROUTES gives them."""
    return {k: v for k, v in routes.items() if k not in ("fused", "split") and v}


@pytest.mark.parametrize("path", sorted(STEP_PATHS))
def test_expected_step_counts_follow_the_routes(steps, path):
    want = chip_smoke.EXPECTED[path]
    got = counts(*steps[path])
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3], got
    assert got[1] == {k: v for k, v in want[1].items() if sum(v.values())}, got[1]
    assert other_routes(steps[path][1]) == chip_smoke.EXPECTED_ROUTES.get(path, {})


@pytest.mark.parametrize("preset", ["config1", "config1 bn", "config4", "config5"])
def test_expected_serving_counts_follow_the_routes(preset):
    path = f"{preset} serving"
    m = (chip_smoke.phase18_config("config1 bn step").model if preset == "config1 bn"
         else tcfg.get_preset(preset).model)
    calls, routes = generator_calls(m, 8)
    got = counts(calls, routes)
    want = chip_smoke.EXPECTED[path]
    assert got[0] == want[0] and got[2] == want[2], got
    assert got[1] == {k: v for k, v in want[1].items() if sum(v.values())}, got[1]
    assert other_routes(routes) == chip_smoke.EXPECTED_ROUTES.get(path, {})


def test_phase18_paths_keep_the_widths_and_set_their_knobs():
    """Phase 18 changes knobs, never a width, the batch or T: config1 as
    phase 12 trains it, config5 as phase 14 does."""
    c1, c5 = chip_smoke.config1_train_config(), STEP_PATHS["config5 step"]()
    for path in chip_smoke.PHASE18_OVERRIDES:
        cfg, base = chip_smoke.phase18_config(path), c1 if "config1" in path else c5
        knobs = {"r1": cfg.train.r1_weight > 0, "bn": cfg.model.norm == "batch",
                 "engines": (cfg.model.deconv, cfg.model.conv0) == ("subpixel", "s2d"),
                 "patches": cfg.model.wgrad == "patches"}
        assert knobs[path.split()[1]] and sum(knobs.values()) == 1, path
        assert (cfg.train.batch_size, cfg.train.rollout_length, cfg.model.image_size) == (
            base.train.batch_size, base.train.rollout_length, base.model.image_size)


def test_the_smoke_configs_keep_the_presets_widths():
    """Phases 13 and 14 change knobs, never a width, the batch or T."""
    for path, preset in (("config4 step", "config4"), ("config5 step", "config5")):
        cfg, base = STEP_PATHS[path](), tcfg.get_preset(preset)
        assert cfg.model == base.model
        assert (cfg.train.batch_size, cfg.train.rollout_length) == (
            base.train.batch_size, base.train.rollout_length)
    c4 = STEP_PATHS["config4 step"]().train
    assert c4.scheduled_sampling and c4.ema_decay > 0 and c4.d_augment and c4.ss_start_prob > 0
    c5 = STEP_PATHS["config5 step"]().train
    assert c5.remat_rollout and c5.rollout_time_chunk == 2 and c5.disc_microbatch == 240


# -- the plans at the new batches -----------------------------------------------------

# conv_tile at every distinct kernel-1 call of the two steps:
# (B, H, W, Cin, Cout, stride) -> (mainloop, BM, BN, tiles per sample).
K1_PLANS = {
    (64, 8, 8, 263, 256, 1): ('wmma', 64, 64, 1),
    (64, 8, 8, 516, 512, 1): ('wgmma', 64, 256, 1),
    (64, 16, 16, 128, 256, 2): ('wgmma', 64, 128, 1),
    (64, 32, 32, 64, 128, 2): ('wgmma', 128, 128, 2),
    (64, 64, 64, 3, 64, 2): ('wmma', 64, 64, 16),
    (64, 64, 64, 128, 256, 2): ('wgmma', 128, 128, 8),
    (240, 4, 4, 512, 512, 1): ('wgmma', 64, 256, 1),
    (240, 8, 8, 512, 512, 1): ('wgmma', 64, 256, 1),
    (240, 32, 32, 256, 256, 1): ('wgmma', 128, 128, 8),
    (240, 64, 64, 128, 256, 2): ('wgmma', 128, 128, 8),
    (480, 4, 4, 512, 512, 1): ('wgmma', 64, 256, 1),
    (480, 8, 8, 512, 512, 1): ('wgmma', 64, 256, 1),
    (480, 32, 32, 256, 256, 1): ('wgmma', 128, 128, 8),
    (480, 64, 64, 128, 256, 2): ('wgmma', 128, 128, 8),
    (640, 8, 8, 256, 512, 2): ('wgmma', 64, 256, 1),
    (640, 16, 16, 128, 256, 2): ('wgmma', 64, 256, 1),
    (640, 32, 32, 64, 128, 2): ('wgmma', 128, 128, 2),
    (640, 64, 64, 13, 64, 2): ('wmma', 64, 64, 16),
    (1280, 8, 8, 256, 512, 2): ('wgmma', 64, 256, 1),
    (1280, 16, 16, 128, 256, 2): ('wgmma', 64, 256, 1),
    (1280, 32, 32, 64, 128, 2): ('wgmma', 128, 128, 2),
    (1280, 64, 64, 13, 64, 2): ('wmma', 64, 64, 16),
}
# norm_act.gn_plan at every distinct kernel-3 call of the config5 step (bf16):
# (B, HW, C, groups) -> (cluster, rows_max, keep_rows, vec, smem, reread).
K3_PLANS = {
    (64, 64, 512, 32): (4, 16, 16, 8, 18960, 0),
    (64, 256, 512, 32): (4, 64, 64, 8, 68112, 0),
    (64, 1024, 256, 32): (4, 256, 256, 8, 133648, 0),
    (64, 4096, 128, 32): (16, 256, 256, 8, 70160, 0),
    (64, 16384, 64, 32): (16, 1024, 1024, 8, 139792, 0),
    (240, 16, 512, 32): (2, 8, 8, 8, 10768, 0),
    (240, 64, 512, 32): (2, 32, 32, 8, 35344, 0),
    (240, 256, 512, 32): (2, 128, 128, 8, 133648, 0),
    (240, 4096, 128, 32): (16, 256, 256, 8, 70160, 0),
    (240, 16384, 64, 32): (16, 1024, 1024, 8, 139792, 0),
    (480, 16, 512, 32): (1, 16, 16, 8, 18960, 0),
    (480, 64, 512, 32): (1, 64, 64, 8, 68112, 0),
    (480, 256, 512, 32): (2, 128, 128, 8, 133648, 0),
    (480, 4096, 128, 32): (16, 256, 256, 8, 70160, 0),
    (480, 16384, 64, 32): (16, 1024, 1024, 8, 139792, 0),
}
# gn_bwd.gn_bwd_plan at every distinct kernel-4 call of the two steps:
# (y dtype, B, HW, C, groups) -> (cluster, rows_max, keep_rows, vec, smem, reread).
K4_PLANS = {
    ('bfloat16', 64, 64, 512, 32): (1, 64, 64, 8, 227872, 0),
    ('bfloat16', 64, 256, 512, 32): (4, 64, 64, 8, 227872, 0),
    ('bfloat16', 64, 1024, 256, 32): (8, 128, 128, 8, 220704, 0),
    ('bfloat16', 64, 4096, 128, 32): (16, 256, 256, 8, 217120, 0),
    ('bfloat16', 64, 16384, 64, 32): (16, 1024, 556, 8, 232224, 2875392),
    ('bfloat16', 240, 16, 512, 32): (1, 16, 16, 8, 80416, 0),
    ('bfloat16', 240, 64, 512, 32): (1, 64, 64, 8, 227872, 0),
    ('bfloat16', 240, 256, 512, 32): (4, 64, 64, 8, 227872, 0),
    ('bfloat16', 240, 4096, 128, 32): (16, 256, 256, 8, 217120, 0),
    ('bfloat16', 240, 16384, 64, 32): (16, 1024, 556, 8, 232224, 2875392),
    ('bfloat16', 480, 16, 512, 32): (1, 16, 16, 8, 80416, 0),
    ('bfloat16', 480, 64, 512, 32): (1, 64, 64, 8, 227872, 0),
    ('bfloat16', 480, 256, 512, 32): (4, 64, 64, 8, 227872, 0),
    ('bfloat16', 480, 4096, 128, 32): (16, 256, 256, 8, 217120, 0),
    ('bfloat16', 480, 16384, 64, 32): (16, 1024, 556, 8, 232224, 2875392),
    ('float32', 64, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 64, 64, 512, 32): (2, 32, 32, 8, 162336, 0),
    ('float32', 64, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 64, 1024, 64, 32): (4, 256, 256, 8, 149792, 0),
    ('float32', 64, 1024, 256, 32): (16, 64, 64, 8, 155168, 0),
    ('float32', 240, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 240, 64, 512, 32): (2, 32, 32, 8, 162336, 0),
    ('float32', 240, 1024, 256, 32): (16, 64, 64, 8, 155168, 0),
    ('float32', 480, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 480, 64, 512, 32): (2, 32, 32, 8, 162336, 0),
    ('float32', 480, 1024, 256, 32): (16, 64, 64, 8, 155168, 0),
    ('float32', 640, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 640, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 640, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
    ('float32', 1280, 16, 512, 32): (1, 16, 16, 8, 96800, 0),
    ('float32', 1280, 64, 256, 32): (1, 64, 64, 8, 155168, 0),
    ('float32', 1280, 256, 128, 32): (2, 128, 128, 8, 151584, 0),
}


def distinct(steps, kernel, paths=("config4 step", "config5 step")):
    return sorted({c for p in paths for c in steps[p][0] if c.kernel == kernel},
                  key=lambda c: (c.shape, c.w_shape or (), c.stride or 0, c.y_bf16 or False))


def k1_key(c):
    b, h, w, cin = c.shape
    return (b, h, w, cin, c.w_shape[3], c.stride)


def k3_key(c):
    b, h, w, ch = c.shape
    return (b, h * w, ch, resolve_groups(ch, c.groups))


def k4_key(c):
    b, h, w, ch = c.shape
    return ("bfloat16" if c.y_bf16 else "float32", b, h * w, ch, resolve_groups(ch, c.groups))


def test_kernel1_tile_plans_at_the_new_batches(steps):
    got = {k1_key(c): conv_tile(1, c.shape[3], c.w_shape[3],
                                same_pad(c.shape[1], c.w_shape[0], c.stride)[0]
                                * same_pad(c.shape[2], c.w_shape[1], c.stride)[0], c.shape[0])
           for c in distinct(steps, "k1")}
    assert got == K1_PLANS


def test_kernel3_plans_at_the_new_batches(steps):
    got = {k3_key(c): tuple(norm_act.gn_plan(torch.bfloat16, *k3_key(c)))
           for c in distinct(steps, "k3")}
    assert got == K3_PLANS


def test_kernel4_plans_at_the_new_batches(steps):
    got = {}
    for c in distinct(steps, "k4"):
        y, b, hw, ch, g = k4_key(c)
        got[(y, b, hw, ch, g)] = tuple(gn_bwd.gn_bwd_plan(getattr(torch, y), torch.bfloat16,
                                                          b, hw, ch, g))
    assert got == K4_PLANS
    # Only config5's 128x128x64 planes (G dec_1, D conv_0_extra_0: 2 MB a
    # sample in bfloat16) do not fit a cluster of 16 and read rows twice.
    reread = sorted({(y, hw, ch) for (y, _, hw, ch, _), plan in got.items() if plan[5] > 0})
    assert reread == REREAD
    # The plan does not depend on B: a kernel-4 call plans as at B=32.
    for (y, b, hw, ch, g), plan in got.items():
        assert plan == tuple(gn_bwd.gn_bwd_plan(getattr(torch, y), torch.bfloat16, 32, hw, ch, g))


REREAD = [("bfloat16", 16384, 64)]


@pytest.mark.parametrize("path", sorted(chip_smoke.PHASE19_PATHS))
def test_phase19_rank_counts_follow_the_routes(path):
    """What one rank of phase 19's two launches a step, on its half of the
    batch: EXPECTED[path] (the bfloat16 paths' entries are the single-device
    steps', whose routes and mainloops do not depend on the batch; the
    float32 paths run kernels 1-2 on their FMA mainloop and split the
    layers the float32 envelope splits)."""
    cfg = chip_smoke.phase19_config(path, chip_smoke.PHASE19_WORLD)
    assert cfg.train.batch_size * chip_smoke.PHASE19_WORLD == chip_smoke.phase19_config(
        path).train.batch_size
    calls, routes = step_calls(cfg)
    got, want = counts(calls, routes), chip_smoke.EXPECTED[path]
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3], got
    assert got[1] == {k: v for k, v in want[1].items() if sum(v.values())}, got[1]
    assert other_routes(routes) == chip_smoke.EXPECTED_ROUTES.get(path, {})


@pytest.mark.parametrize("path", sorted(chip_smoke.PHASE20_PATHS))
def test_phase20_rank_counts_follow_the_routes(path):
    """What one rank of phase 20's (data, model) meshes launches a step on
    its channel shard and rows of the batch: EXPECTED[path] (each shard
    routed as a layer of its width); every rank's shards have rank 0's
    shapes."""
    cfg = chip_smoke.phase20_config(path)
    calls, routes = tp_step_calls(cfg, cfg.mesh.data, cfg.mesh.model)
    got, want = counts(calls, routes), chip_smoke.EXPECTED[path]
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3], got
    assert got[1] == {k: v for k, v in want[1].items() if sum(v.values())}, got[1]
    assert other_routes(routes) == chip_smoke.EXPECTED_ROUTES.get(path, {})


def test_phase20_grid_serving_counts_follow_the_routes():
    """A generator call of a 1x2 serving grid's row at config5: each sharded
    layer's kernels once a column, dec_0 whole (EXPECTED["config5 tp2
    serving"])."""
    calls, routes = grid_generator_calls("config5", 8, 2)
    got, want = counts(calls, routes), chip_smoke.EXPECTED["config5 tp2 serving"]
    assert got[0] == want[0] and got[2] == want[2], got
    assert got[1] == {k: v for k, v in want[1].items() if sum(v.values())}, got[1]
    assert other_routes(routes) == chip_smoke.EXPECTED_ROUTES.get("config5 tp2 serving", {})
