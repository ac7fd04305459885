"""``train.flatten_optimizer`` in the port (``train/state.py``'s flat layout,
``ops/kernels/adam.py``'s fused Adam, kernel 5) against the JAX package's
``optax.flatten`` path, on the CPU (the kernel's plain version).

* The order: the flat layout is ``jax.tree.flatten`` of the Flax tree, names,
  offsets and shapes, for G and D of every preset (full widths, through
  ``jax.eval_shape``), and its length is the JAX flat moments' length.
* The update alone: the plain flat Adam is the per-tensor ``Adam.update_``
  bit for bit; ``Adam(flat=True)`` follows optax.flatten's chain.
* Steps: the port's flat step follows ``jit_train_step`` with
  ``flatten_optimizer=True`` within the step bars of
  tests/test_torch_checkpoint.py (metrics 1e-5 abs / 1e-4 rel, parameters
  2e-5), and the port's per-tensor step at the reference's bar
  (tests/test_train_step.py's ``atol=1e-9, rtol=1e-6``).
* JAX flat states cross with ``train_state_from_jax`` bit for bit and
  continue as JAX continues them; a layout mismatch raises naming the knob.
* Checkpoints: a flat state round-trips bit for bit with its parameters
  views of one buffer again; the other layout is refused naming the knob;
  a flat ``train`` resumes bit for bit and its checkpoint serves.
* The model axis keeps the per-tensor layout (the reference's rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train import state as JS
from action_conditioned_gans_tpu.train.step import jit_train_step
from action_conditioned_gans_tpu_torch.convert import (
    flax_to_state_dict,
    train_state_from_jax,
    train_state_shard_from_jax,
)
from action_conditioned_gans_tpu_torch.infer import Predictor
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops.kernels import adam as K
from action_conditioned_gans_tpu_torch.train import init_state, make_multi_train_step, make_train_step
from action_conditioned_gans_tpu_torch.train import state as S
from action_conditioned_gans_tpu_torch.train.loop import train
from action_conditioned_gans_tpu_torch.utils import trace_report as tr
from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_loop import loop_config
from tests.test_torch_train import adam_states, np_batch, np_tree, port_config, state_dicts
from tests.test_train_step import make_batch, tiny_config

torch.set_num_threads(1)
PRESETS = ("config1", "config2", "config3", "config4", "config5")


def flat_config(**train_kw):
    return tiny_config(flatten_optimizer=True, **train_kw)


def assert_flat(params):
    """``params`` are views of one buffer in the flat layout."""
    buf = S.flat_buffer(params)
    assert buf.dim() == 1 and buf.numel() == sum(v.numel() for v in params.values())
    return buf


def assert_flat_states_equal(a, b):
    assert a.step == b.step
    for name in ("g_params", "d_params"):
        pa, pb = getattr(a, name), getattr(b, name)
        assert pa.keys() == pb.keys()
        for k in pa:
            assert torch.equal(pa[k], pb[k]), f"{name}/{k}"
    for name in ("g_opt", "d_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert oa.count == ob.count
        for m in ("mu", "nu"):
            x, y = getattr(oa, m), getattr(ob, m)
            assert x.dtype == y.dtype and torch.equal(x, y), f"{name}/{m}"


# -- the order ------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_flat_layout_is_the_jax_tree_flatten_order(preset):
    """Names, offsets and shapes of the port's layout equal the leaves of
    ``jax.tree.flatten`` of the Flax params, for G and D at full width; the
    JAX flat state's moments have the layout's length."""
    jc = jcfg.get_preset(preset)
    jc = dataclasses.replace(jc, train=dataclasses.replace(jc.train, flatten_optimizer=True))
    shapes = jax.eval_shape(lambda k: jax_init_state(jc, k), jax.random.PRNGKey(0))
    cfg = port_config(jc)
    with torch.device("meta"):
        port = {"g_params": Generator(cfg.model).state_dict(),
                "d_params": Discriminator(cfg.model).state_dict()}
    for tree, opt in (("g_params", "g_opt"), ("d_params", "d_opt")):
        leaves, _ = jax.tree_util.tree_flatten_with_path(getattr(shapes, tree))
        names = [".".join(k.key for k in path) for path, _ in leaves]
        sizes = [int(np.prod(leaf.shape)) for _, leaf in leaves]
        layout = S.flat_layout(port[tree])
        assert list(layout.names) == names
        assert list(layout.shapes) == [tuple(leaf.shape) for _, leaf in leaves]
        assert list(layout.offsets) == np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        (adam,) = [s for s in jax.tree_util.tree_leaves(
            getattr(shapes, opt), is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
            if hasattr(s, "mu")]
        assert adam.mu.shape == (layout.numel,) == (sum(sizes),)


def test_the_order_sorts_each_level_not_the_dotted_names():
    """A nested sort differs from a sort of the joined names where a key
    has a character below "." in it."""
    names = ["a-b.x", "a.y", "a.x", "b.z"]
    assert S.jax_leaf_order(names) == ["a.x", "a.y", "a-b.x", "b.z"]
    assert sorted(names) != S.jax_leaf_order(names)


# -- the update alone ----------------------------------------------------------------------


UPDATE_CASES = [dict(moments=m, clip=c) for m in ("float32", "bfloat16") for c in (0.0, 1.0)]


def seeded_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w.kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
            "w.bias": rng.standard_normal(4).astype(np.float32),
            "logit_kernel": rng.standard_normal((6, 1)).astype(np.float32),
            "a.scale": rng.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("case", UPDATE_CASES, ids=lambda c: f"{c['moments']}-clip{c['clip']}")
def test_plain_flat_adam_is_the_per_tensor_update(case):
    """Three updates (the second's gradient large: clipped when clipping is
    on) of kernel 5's plain version on the flat tensors equal the per-tensor
    ``Adam.update_`` bit for bit, given the same global norm."""
    dtype = getattr(torch, case["moments"])
    tx = S.Adam(lambda c: 1e-3 * (c + 1), 0.5, 0.999, 1e-8, dtype, case["clip"])
    params = {k: torch.from_numpy(v) for k, v in seeded_params().items()}
    per = {k: v.clone() for k, v in params.items()}
    flat = S.flat_params(params)
    per_state, flat_state = tx.init(per), S.Adam(0.0, 0.5, 0.999, 1e-8, dtype, flat=True).init(flat)
    rng = np.random.default_rng(1)
    for i in range(3):
        grads = [torch.from_numpy((rng.standard_normal(v.shape) * (5.0 if i == 1 else 0.05))
                                  .astype(np.float32)) for v in per.values()]
        norm = S.global_norm(grads)
        count = per_state.count
        tx.update_(per, grads, per_state, norm=lambda gs: norm)
        K.adam_flat(S.flat_buffer(flat), S.flat_grad(per, grads), flat_state.mu, flat_state.nu,
                    b1=0.5, b2=0.999, eps=1e-8, lr=1e-3 * (count + 1),
                    bc1=1.0 - 0.5 ** (count + 1), bc2=1.0 - 0.999 ** (count + 1),
                    clip=case["clip"], norm=norm if case["clip"] > 0 else None)
    layout = S.flat_layout(flat)
    for k in per:
        assert torch.equal(flat[k], per[k]), k
    for m in ("mu", "nu"):
        want = torch.cat([getattr(per_state, m)[k].reshape(-1) for k in layout.names])
        got = getattr(flat_state, m)
        assert got.dtype == dtype and torch.equal(got, want), m
    assert K.LAUNCHES["adam_flat"] == 0  # CPU tensors run the plain version


ADAM_CASES = [
    dict(adam_moment_dtype="float32"),
    dict(adam_moment_dtype="bfloat16"),
    dict(adam_moment_dtype="float32", grad_clip_norm=0.5, lr_schedule="cosine", warmup_steps=1,
         total_steps=10),
    dict(adam_moment_dtype="bfloat16", grad_clip_norm=0.5, lr_schedule="linear", warmup_steps=1,
         total_steps=10),
]


@pytest.mark.parametrize("kw", ADAM_CASES)
def test_flat_adam_matches_optax_flatten(kw):
    """Four updates of G's flat optimizer against the JAX package's
    ``optax.flatten`` chain (tests/test_torch_train.py's bars)."""
    jc = flat_config(**kw)
    g_tx, _ = JS.make_optimizers(jc)
    tx, _ = S.make_optimizers(port_config(jc))
    assert tx.flat
    params = seeded_params()
    jp, jstate = dict(params), g_tx.init(params)
    tp = S.flat_params({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    tstate = tx.init(tp)
    rng = np.random.default_rng(0)
    for i in range(4):
        grads = {k: (rng.standard_normal(v.shape) * (3.0 if i == 1 else 0.05)).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = g_tx.update(grads, jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        tx.update_(tp, [torch.from_numpy(grads[k]) for k in tp], tstate)
    (adam,) = adam_states(jstate)
    assert tstate.count == int(adam.count) == 4
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-5)
    for mine, theirs in ((tstate.mu, adam.mu), (tstate.nu, adam.nu)):
        assert mine.dtype == getattr(torch, kw["adam_moment_dtype"]) and mine.dim() == 1
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(jnp.asarray(theirs).astype(jnp.float32)),
                                   atol=1e-7, rtol=1e-5)


def test_the_update_bumps_the_version_counter():
    """A tensor autograd saved from a parameter and read after the update
    fails, as after the per-tensor update."""
    params = S.flat_params({k: torch.from_numpy(v) for k, v in seeded_params().items()})
    tx = S.Adam(1e-3, 0.5, 0.999, flat=True)
    state = tx.init(params)
    leaf = params["w.bias"].detach().requires_grad_()
    y = (leaf * leaf).sum()
    tx.update_(params, [torch.ones_like(v) for v in params.values()], state)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        y.backward()


def test_a_copied_parameter_is_refused():
    """The likeliest silent fault: a parameter that is no longer a view of
    the buffer (a clone, a device move) would not be updated."""
    params = S.flat_params({k: torch.from_numpy(v) for k, v in seeded_params().items()})
    tx = S.Adam(1e-3, 0.5, 0.999, flat=True)
    state = tx.init(params)
    params["w.bias"] = params["w.bias"].clone()
    with pytest.raises(ValueError, match="'w.bias' is not a view"):
        tx.update_(params, [torch.ones_like(v) for v in params.values()], state)


# -- steps -----------------------------------------------------------------------


STEP_CASES = {
    "float32": dict(),
    "bf16_moments_clip_schedule": dict(
        adam_moment_dtype="bfloat16", grad_clip_norm=0.5, lr_schedule="cosine", warmup_steps=1,
        total_steps=10, log_grad_norms=True),
    "two_disc_steps_microbatch": dict(disc_steps=2, rollout_length=2, disc_microbatch=2),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_flat_steps_match_jit_train_step(name):
    """Two steps of the port's flat step against ``jit_train_step`` with
    ``flatten_optimizer=True`` from the same state: every metric, the
    parameters, and the flat first moments (mu is (1 - b1) g: gradients
    agree to 1e-3 of it)."""
    jc = flat_config(**STEP_CASES[name])
    cfg = port_config(jc)
    js = jax_init_state(jc, jax.random.PRNGKey(3))
    g_sd, d_sd = state_dicts(js)
    ts = S.state_from_params(cfg, g_sd, d_sd, device="cpu")
    assert_flat(ts.g_params)
    assert_flat(ts.d_params)
    jstep, tstep = jit_train_step(jc), make_train_step(cfg, device="cpu")
    for i in range(2):
        batch = make_batch(jc, seed=10 + i)
        js, jm = jstep(js, batch, jax.random.PRNGKey(0))
        ts, tm = tstep(ts, np_batch(batch))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    g_want, d_want = state_dicts(js)
    for mine, theirs in ((ts.g_params, g_want), (ts.d_params, d_want)):
        for k in theirs:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), atol=2e-5, err_msg=k)
    for opt, jopt in ((ts.g_opt, js.g_opt), (ts.d_opt, js.d_opt)):
        (adam,) = adam_states(np_tree(jopt))
        assert opt.count == int(adam.count) and opt.mu.dim() == 1
        np.testing.assert_allclose(opt.mu.float().numpy(), np.asarray(adam.mu, np.float32),
                                   atol=1e-5, rtol=1e-2)
    assert_flat(ts.g_params)


FLAT_VS_TREE = {
    "float32": dict(),
    "bfloat16_moments": dict(adam_moment_dtype="bfloat16"),
    "ema_two_disc_steps_microbatch_two_a_call": dict(
        disc_steps=2, rollout_length=2, disc_microbatch=2, ema_decay=0.9, steps_per_call=2),
}


@pytest.mark.parametrize("name", sorted(FLAT_VS_TREE))
def test_flat_step_matches_the_per_tensor_step(name):
    """Two steps (one call of ``make_multi_train_step`` with two a call),
    flat against per-tensor from one init: the parameters at
    tests/test_train_step.py's bar for the JAX package's two layouts."""
    states = {}
    for flat in (False, True):
        jc = tiny_config(flatten_optimizer=flat, **FLAT_VS_TREE[name])
        cfg = port_config(jc)
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = make_multi_train_step(cfg, device="cpu")
        batches = [np_batch(make_batch(jc, seed=i)) for i in range(2)]
        if cfg.train.steps_per_call > 1:
            batches = [{k: np.stack([b[k] for b in batches]) for k in batches[0]}]
        for batch in batches:
            state, _ = step(state, batch)
        assert state.step == 2
        states[flat] = state
    tree, flat = states[False], states[True]
    assert isinstance(flat.g_opt.mu, torch.Tensor) and isinstance(tree.g_opt.mu, dict)
    for name_ in ("g_params", "d_params") + (("g_ema",) if tree.g_ema is not None else ()):
        a, b = getattr(tree, name_), getattr(flat, name_)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-9, rtol=1e-6,
                                       err_msg=f"{name_}/{k}")


# -- JAX states carried across -------------------------------------------------------


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_jax_flat_state_crosses_and_continues(moments):
    """Two JAX flat steps; the state crosses bit for bit (the moments in
    their own dtype, the parameters views of one buffer); the port then
    takes steps 3 and 4 as JAX does, within the step bars."""
    jc = flat_config(adam_moment_dtype=moments)
    cfg = port_config(jc)
    jstep = jit_train_step(jc)
    js = jax_init_state(jc, jax.random.PRNGKey(1))
    batches = [make_batch(jc, seed=20 + i) for i in range(4)]
    for b in batches[:2]:
        js, _ = jstep(js, b, jax.random.PRNGKey(0))
    jn = np_tree(js)
    ts = train_state_from_jax(cfg, jn, device="cpu")
    for params, opt, jtree, jopt in ((ts.g_params, ts.g_opt, jn.g_params, jn.g_opt),
                                     (ts.d_params, ts.d_opt, jn.d_params, jn.d_opt)):
        buf = assert_flat(params)
        want = flax_to_state_dict(jtree)
        for k in want:
            assert torch.equal(params[k], want[k]), k
        (adam,) = adam_states(jopt)
        assert opt.count == int(adam.count) == 2
        for mine, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            assert mine.dtype == getattr(torch, moments) and mine.shape == buf.shape
            bits = np.asarray(theirs).view(np.int16 if moments == "bfloat16" else np.int32)
            np.testing.assert_array_equal(
                mine.view(torch.int16 if moments == "bfloat16" else torch.int32).numpy(), bits)
    tstep = make_train_step(cfg, device="cpu")
    for b in batches[2:]:
        js, jm = jstep(js, b, jax.random.PRNGKey(0))
        ts, tm = tstep(ts, np_batch(b))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    g_sd, d_sd = state_dicts(js)
    for mine, theirs in ((ts.g_params, g_sd), (ts.d_params, d_sd)):
        for k in theirs:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), atol=2e-5, err_msg=k)


def test_a_layout_mismatch_is_refused_naming_the_knob():
    """A flat JAX state into a per-tensor config, a per-tensor one into a
    flat config, a flat one into a model axis (which the JAX package cannot
    make either), and moments of the wrong length are refused."""
    flat_js = np_tree(jax_init_state(flat_config(), jax.random.PRNGKey(2)))
    tree_js = np_tree(jax_init_state(tiny_config(), jax.random.PRNGKey(2)))
    with pytest.raises(ValueError, match="flatten_optimizer"):
        train_state_from_jax(port_config(tiny_config()), flat_js, device="cpu")
    with pytest.raises(ValueError, match="flatten_optimizer"):
        train_state_from_jax(port_config(flat_config()), tree_js, device="cpu")
    tp = port_config(flat_config())
    tp = dataclasses.replace(tp, mesh=dataclasses.replace(tp.mesh, model=2))
    with pytest.raises(ValueError, match="flatten_optimizer"):
        train_state_shard_from_jax(tp, flat_js, 0, 2, device="cpu")
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    cut = dataclasses.replace(flat_js, g_opt=jax.tree_util.tree_map(
        lambda a: a._replace(mu=a.mu[:-1], nu=a.nu[:-1]) if is_adam(a) else a, flat_js.g_opt,
        is_leaf=is_adam))
    with pytest.raises(ValueError, match="parameters hold"):
        train_state_from_jax(port_config(flat_config()), cut, device="cpu")


# -- checkpoints -------------------------------------------------------------------


def flat_state(moments="bfloat16", steps=1):
    cfg = port_config(flat_config(adam_moment_dtype=moments))
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, device="cpu")
    for i in range(steps):
        state, _ = step(state, np_batch(make_batch(tiny_config(), seed=i)))
    return cfg, state


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_flat_checkpoint_round_trips_with_its_views(tmp_path, moments):
    """Bit for bit, the moments as flat vectors on disk and the parameters
    by name; after restore the parameters are views of one buffer again, so
    one update changes the dict's tensors; the checkpoint serves."""
    cfg, state = flat_state(moments, steps=2)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    assert mgr.save(2, S.state_to_host(state, cfg))
    on_disk = mgr.load(2)
    assert on_disk["g_opt"]["mu"].dim() == 1 and isinstance(on_disk["g_params"], dict)
    template = init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    restored = S.restore_state(cfg, mgr, template=template)
    assert_flat_states_equal(restored, state)
    assert_flat(restored.g_params)
    assert_flat(restored.d_params)
    before = {k: v.clone() for k, v in restored.g_params.items()}
    restored, _ = make_train_step(cfg, device="cpu")(
        restored, np_batch(make_batch(tiny_config(), seed=5)))
    assert all(not torch.equal(before[k], restored.g_params[k]) for k in before
               if k.endswith("kernel"))
    p = Predictor.from_checkpoint(cfg, workdir=str(tmp_path), device="cpu")
    for k, v in p.generator.state_dict().items():
        assert torch.equal(v, state.g_params[k]), k


def test_the_other_layout_is_refused_naming_the_knob(tmp_path):
    cfg, state = flat_state(steps=0)
    tree_cfg = port_config(tiny_config(adam_moment_dtype="bfloat16"))
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(0, S.state_to_host(state, cfg))
    with pytest.raises(ValueError, match="flatten_optimizer"):
        S.restore_state(tree_cfg, mgr, template=init_state(
            tree_cfg, torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match="flatten_optimizer"):
        Predictor.from_checkpoint(tree_cfg, workdir=str(tmp_path), device="cpu")
    other = CheckpointManager(str(tmp_path / "other"))
    tree_state = init_state(tree_cfg, torch.Generator().manual_seed(0), device="cpu")
    other.save(0, S.state_to_host(tree_state, tree_cfg))
    with pytest.raises(ValueError, match="flatten_optimizer"):
        S.restore_state(cfg, other, template=init_state(
            cfg, torch.Generator().manual_seed(0), device="cpu"))


def test_flat_train_resumes_bit_for_bit(tmp_path):
    """``train`` to 4 steps, against 2 steps, a stop and a resume to 4."""
    def run(workdir, steps):
        cfg = loop_config(workdir, flatten_optimizer=True, steps_per_call=2, checkpoint_every=2,
                          log_every=2, adam_moment_dtype="bfloat16")
        return train(cfg, steps, workdir=str(workdir), device="cpu")

    whole = run(tmp_path / "whole", 4)
    run(tmp_path / "cut", 2)
    resumed = run(tmp_path / "cut", 4)
    assert_flat_states_equal(resumed, whole)
    assert_flat(resumed.g_params)


# -- the model axis, the counts ------------------------------------------------------


def test_a_model_axis_keeps_the_per_tensor_layout():
    cfg = port_config(flat_config())
    assert S.flatten_optimizer(cfg)
    tp = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, model=2))
    assert not S.flatten_optimizer(tp)
    assert not any(tx.flat for tx in S.make_optimizers(tp))
    state = init_state(tp, torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(state.g_opt.mu, dict) and isinstance(state.d_opt.nu, dict)
    with pytest.raises(ValueError, match="not a view"):
        S.flat_buffer(state.g_params)


def test_profile_report_counts_kernel_5():
    """A trace's adam_flat kernels are kernel 5's launches and group."""
    name = "void (anonymous namespace)::adam_flat_kernel<float, true, false>(float*)"
    events = [{"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": 4, "pid": 0, "tid": 7,
               "args": {"stream": 7}} for t in (0, 10)]
    s = tr.summarize({"traceEvents": events})
    assert s.kernels["adam_flat"]["launches"] == 2 and s.kernels["adam_flat"]["device_us"] == 8
    assert s.group_us["acgan adam_flat (kernel 5)"] == 8
    assert s.kernels["adam_flat"]["roof_us"] is None
