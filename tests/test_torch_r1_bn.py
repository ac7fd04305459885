"""The R1 penalty and batch norm of the port's training step against the
JAX package's, on the CPU.

* R1: one step's ``d_r1`` against the penalty computed outside the step
  (tests/test_train_step.py::test_r1_penalty_matches_independent_computation),
  two steps' metrics, parameters and first moments against
  ``jit_train_step`` (1e-5 / 2e-5, as the other knobs), microbatching
  (``test_r1_microbatch_equivalence``), each engine knob alone and combined
  with batch norm, and the refusal of R1 with ``backend="pallas"``. The
  inner D call runs on ``ops.api.plain_route`` (``ROUTES["plain"]``).
* Batch norm: the generator and the discriminator forward against the JAX
  modules, steps against ``jit_train_step``, the fold at time chunk 1, two
  D calls, microbatching ignored bit for bit
  (``test_batch_norm_disables_fold_and_microbatch``), and a batch-norm
  layer's split route: its conv on kernel 1 or 2 as a bare conv where it
  fits (``ROUTES["bare"]``), as the reference's Pallas ``conv2d`` runs it.
* The committed fixture ``tests/fixtures/torch_port_tiny_r1_bn.npz`` (two
  tiny four-step JAX runs, one with R1 and one with batch norm; replayed on
  the GPU by chip_smoke.py phase 18): regenerated here with JAX and
  replayed by the port.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_discriminator import TINY as D_TINY
from test_torch_discriminator import jax_params as d_jax_params
from test_torch_discriminator import run_both as d_run_both
from test_torch_generator import TINY as G_TINY
from test_torch_generator import jax_params as g_jax_params
from test_torch_generator import port_generator

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.models import Discriminator as JaxDiscriminator
from action_conditioned_gans_tpu.models import Generator as JaxGenerator
from action_conditioned_gans_tpu.ops import api as japi
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train.step import jit_train_step
from action_conditioned_gans_tpu_torch.convert import flatten_flax
from action_conditioned_gans_tpu_torch.models import Discriminator
from action_conditioned_gans_tpu_torch.ops import api, envelope
from action_conditioned_gans_tpu_torch.train import make_train_step
from tests.test_torch_train import (
    GOLDEN_TOL,
    TRAJECTORY,
    adam_states,
    make_train_fixture,
    np_batch,
    np_tree,
    port_config,
    port_state,
    replay,
    state_dicts,
)
from tests.test_train_step import make_batch, tiny_config

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_tiny_r1_bn.npz")
# The two runs of the fixture: (config, the metrics of its trajectory).
FIXTURE_RUNS = {"r1": (dict(r1_weight=7.0), {}, TRAJECTORY + ("d_r1",)),
                "bn": ({}, dict(norm="batch"), TRAJECTORY)}


def config(train_kw=None, model_kw=None):
    jc = tiny_config(**(train_kw or {}))
    return dataclasses.replace(jc, model=dataclasses.replace(jc.model, **(model_kw or {})))


def fresh(jc, seed=0):
    """The JAX init state and the port's state converted from it."""
    js = jax_init_state(jc, jax.random.PRNGKey(seed))
    return js, port_state(jc, js)


def assert_steps_match(jc, steps=2):
    """``steps`` steps of the port against ``jit_train_step`` on the same
    batches: every metric within 1e-5 abs / 1e-4 rel, the updated
    parameters within 2e-5, D's first moments within 1e-5 abs + 1e-2 rel.
    Returns the port's last metrics."""
    js, ts = fresh(jc, seed=3)
    jstep, tstep = jit_train_step(jc), make_train_step(port_config(jc), device="cpu")
    for i in range(steps):
        batch = make_batch(jc, seed=10 + i)
        js, jm = jstep(js, batch, jax.random.PRNGKey(0))
        ts, tm = tstep(ts, np_batch(batch))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    g_sd, d_sd = state_dicts(js)
    for mine, theirs in ((ts.g_params, g_sd), (ts.d_params, d_sd)):
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), atol=2e-5, err_msg=k)
    (adam,) = adam_states(js.d_opt)
    for k, v in flatten_flax(np_tree(adam.mu)).items():
        np.testing.assert_allclose(ts.d_opt.mu[k.replace("/", ".")].float().numpy(), v,
                                   atol=1e-5, rtol=1e-2, err_msg=k)
    return tm


# -- R1 ------------------------------------------------------------------------------


def test_r1_penalty_matches_independent_computation():
    """d_r1 at step 1 equals the penalty computed outside the step, by JAX
    on the init D params and the real transitions, within rtol 1e-5; the D
    loss carries the (r1_weight / 2)-weighted term; the inner D call ran its
    conv blocks on the plain route."""
    jc = config(dict(r1_weight=7.0))
    js, ts = fresh(jc)
    d0 = jax.tree_util.tree_map(np.asarray, jax.device_get(js.d_params))
    batch = make_batch(jc)
    api.reset_routes()
    _, m = make_train_step(port_config(jc), device="cpu")(ts, np_batch(batch))
    assert api.ROUTES["plain"] == 2  # D's two conv blocks, once
    assert np.isfinite(float(m["d_r1"])) and float(m["d_r1"]) > 0
    disc = JaxDiscriminator(jc.model)
    real, cond = (np.asarray(batch["frames"][:, i]) for i in (1, 0))
    act = np.asarray(batch["actions"][:, 0])
    gx = jax.grad(lambda x: disc.apply({"params": d0}, x, cond, act, None).sum())(jnp.asarray(real))
    manual = float(jnp.mean(jnp.sum(jnp.square(gx), axis=(1, 2, 3))))
    np.testing.assert_allclose(float(m["d_r1"]), manual, rtol=1e-5)
    _, m0 = make_train_step(port_config(config()), device="cpu")(fresh(jc)[1], np_batch(batch))
    assert "d_r1" not in m0
    np.testing.assert_allclose(float(m["d_loss"]) - float(m0["d_loss"]), 3.5 * manual, rtol=1e-4)


@pytest.mark.parametrize("train_kw", [dict(r1_weight=7.0),
                                      dict(r1_weight=3.0, rollout_length=2, disc_steps=2,
                                           gan_loss="hinge")],
                         ids=["r1", "r1_two_disc_steps_hinge"])
def test_r1_steps_match_jit_train_step(train_kw):
    assert_steps_match(config(train_kw))


def test_r1_microbatch_equivalence():
    """tests/test_train_step.py::test_r1_microbatch_equivalence on the port:
    disc_microbatch=2 against 0, d_r1 within rtol 1e-5 / atol 1e-7 and D's
    updated parameters within atol 5e-6 / rtol 1e-4; and the microbatched
    step against jit_train_step's."""
    def run(mb):
        jc = config(dict(rollout_length=4, batch_size=2, r1_weight=3.0, disc_microbatch=mb))
        return make_train_step(port_config(jc), device="cpu")(fresh(jc)[1],
                                                              np_batch(make_batch(jc)))

    (full, m_full), (chunked, m_chunk) = run(0), run(2)
    np.testing.assert_allclose(float(m_chunk["d_r1"]), float(m_full["d_r1"]), rtol=1e-5, atol=1e-7)
    for k, v in full.d_params.items():
        np.testing.assert_allclose(chunked.d_params[k].numpy(), v.numpy(), atol=5e-6, rtol=1e-4,
                                   err_msg=k)
    assert_steps_match(config(dict(rollout_length=4, batch_size=2, r1_weight=3.0,
                                   disc_microbatch=2)), steps=1)


ENGINES = {
    "patches": dict(wgrad="patches"),
    "subpixel": dict(deconv="subpixel"),
    "s2d": dict(conv0="s2d"),
    "subpixel_s2d": dict(deconv="subpixel", conv0="s2d"),
}


@pytest.mark.parametrize("engine,split", [(e, True) for e in sorted(ENGINES)] + [("patches", False)],
                         ids=[f"{e}_all_split" for e in sorted(ENGINES)] + ["patches_routed"])
def test_r1_with_each_engine_matches_jit_train_step(engine, split, monkeypatch):
    """R1 with each engine knob (the reference trains every combination on
    its XLA backend). "all_split" sets the routing budget to 0, so every
    layer is split and the rewrites run in the main D and G calls too;
    "routed" keeps the reference's routing (at this size every layer
    fused: the kernels' backward takes wgrad; a fused layer runs no
    rewrite)."""
    if split:
        monkeypatch.setattr(envelope, "VMEM_BUDGET", 0)
    api.reset_routes()
    assert_steps_match(config(dict(r1_weight=3.0, rollout_length=2), ENGINES[engine]))
    route = {"patches": "patches", "subpixel": "subpixel", "s2d": "s2d", "subpixel_s2d": "s2d"}
    assert api.ROUTES[route[engine]] > 0


def test_r1_with_pallas_backend_raises():
    cfg = port_config(config(dict(r1_weight=1.0)))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, backend="pallas"))
    with pytest.raises(ValueError, match="differentiate its Pallas kernels twice.*backend='xla'"):
        make_train_step(cfg, device="cpu")


# -- batch norm ----------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_batch_norm_generator_matches_jax(backend):
    m = jcfg.ModelConfig(norm="batch", backend=backend, **G_TINY)
    params = g_jax_params(m)
    rng = np.random.default_rng(4)
    frame = np.tanh(rng.standard_normal((3, 16, 16, 3))).astype(np.float32)
    action = rng.standard_normal((3, 4)).astype(np.float32)
    want = np.asarray(JaxGenerator(m).apply({"params": params}, frame, action))
    api.reset_routes()
    with torch.no_grad():
        got = port_generator(m, params)(torch.from_numpy(frame), torch.from_numpy(action))
    # enc_1, the bottleneck and dec_1 are batch-norm layers: split, their
    # convs bare on kernels 1-2; enc_0 and dec_0 (no norm) fused.
    assert (api.ROUTES["fused"], api.ROUTES["split"], api.ROUTES["bare"]) == (2, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("extra", [dict(), dict(d_extra_layers=1, state_dim=3)],
                         ids=["plain", "extra_layers_state"])
def test_batch_norm_discriminator_matches_jax(extra):
    m = jcfg.ModelConfig(norm="batch", **D_TINY, **extra)
    got, want = d_run_both(m, d_jax_params(m), b=4)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("case", ["T1", "T2_state_extra", "hinge_two_disc_steps"])
def test_batch_norm_steps_match_jit_train_step(case):
    train_kw, model_kw = {
        "T1": ({}, {}),
        "T2_state_extra": (dict(rollout_length=2), dict(state_dim=3, d_extra_layers=1)),
        "hinge_two_disc_steps": (dict(gan_loss="hinge", disc_steps=2, rollout_length=2), {}),
    }[case]
    assert_steps_match(config(train_kw, dict(norm="batch", **model_kw)))


def test_batch_norm_with_r1_and_engines_matches_jit_train_step(monkeypatch):
    """Batch norm, R1 and the two rewrites together, every layer split."""
    monkeypatch.setattr(envelope, "VMEM_BUDGET", 0)
    assert_steps_match(config(dict(r1_weight=3.0, rollout_length=2),
                              dict(norm="batch", deconv="subpixel", conv0="s2d")))


def test_batch_norm_disables_fold_and_microbatch():
    """tests/test_train_step.py::test_batch_norm_disables_fold_and_microbatch
    on the port: with norm="batch" a step with disc_microbatch set equals one
    without, bit for bit; the fold runs one generator call per time step at
    B; D runs twice in the update (real, fake) and once in the G head."""
    def run(mb):
        jc = config(dict(rollout_length=2, disc_microbatch=mb, rollout_time_chunk=2),
                    dict(norm="batch"))
        cfg = port_config(jc)
        calls = {"G": [], "D": []}
        step = make_train_step(cfg, device="cpu")
        js, ts = fresh(jc)
        from action_conditioned_gans_tpu_torch.models import Generator

        real_g, real_d = Generator.forward, Discriminator.forward

        def g_spy(self, frame, *a, **kw):
            calls["G"].append(frame.shape[0])
            return real_g(self, frame, *a, **kw)

        def d_spy(self, nxt, *a, **kw):
            calls["D"].append(nxt.shape[0])
            return real_d(self, nxt, *a, **kw)

        Generator.forward, Discriminator.forward = g_spy, d_spy
        try:
            out = step(ts, np_batch(make_batch(jc)))
        finally:
            Generator.forward, Discriminator.forward = real_g, real_d
        return out, calls

    (a, ma), calls = run(0)
    (b, mb_), calls_mb = run(2)
    assert calls == calls_mb == {"G": [2, 2], "D": [4, 4, 4]}
    assert float(ma["d_loss"]) == float(mb_["d_loss"])
    for name in ("g_params", "d_params"):
        for k, v in getattr(a, name).items():
            assert torch.equal(getattr(b, name)[k], v), k


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("split", [False, True], ids=["bare", "plain_conv"])
def test_batch_norm_layer_split_route_matches_jax_pallas_api(transpose, split, monkeypatch):
    """A batch-norm layer takes the split route in both packages; its conv is
    the reference's Pallas ``conv2d`` / ``conv2d_transpose``: kernel 1 or 2
    as a bare conv (kind "none", act "none", no bias) where it fits, else
    the plain conv. Forward and dx, dw, dscale, dbias within 1e-3 of jax.vjp
    of the JAX api with backend="pallas"."""
    rng = np.random.default_rng(7)
    cin, cout = 6, 8
    x = rng.standard_normal((3, 4 if transpose else 8, 4 if transpose else 8, cin)).astype(np.float32)
    w = (rng.standard_normal((4, 4, cin, cout)) * 0.2).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    kw = dict(stride=2, transpose=transpose, kind="batch", groups=4,
              act="relu" if transpose else "lrelu")
    if split:
        monkeypatch.setattr(envelope, "VMEM_BUDGET", 0)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, bias)]
    api.reset_routes()
    out = api.conv_norm_act(*ins, **kw)
    assert (api.ROUTES["split"], api.ROUTES["bare"]) == (1, 0 if split else 1)
    ct = rng.standard_normal(out.shape).astype(np.float32)
    got = torch.autograd.grad(out, ins, torch.from_numpy(ct))
    jout, vjp = jax.vjp(lambda *a: japi.conv_norm_act(*a, backend="pallas", **kw),
                        *map(jnp.asarray, (x, w, scale, bias)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-3, rtol=1e-3)
    for a, b, name in zip(got, vjp(jnp.asarray(ct)), ("dx", "dw", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3, rtol=1e-3, err_msg=name)


# -- the committed fixture -------------------------------------------------------------


def make_r1_bn_fixture() -> dict:
    """The two tiny four-step JAX runs of FIXTURE_RUNS, each in
    ``make_train_fixture``'s layout under its prefix ("r1/", "bn/")."""
    arrays = {}
    for name, (train_kw, model_kw, keys) in FIXTURE_RUNS.items():
        run = make_train_fixture(config(dict(rollout_length=2, **train_kw), model_kw), keys)
        arrays.update({f"{name}/{k}": v for k, v in run.items()})
    return arrays


def runs_of(arrays):
    return {name: {k[len(name) + 1:]: v for k, v in arrays.items() if k.startswith(name + "/")}
            for name in FIXTURE_RUNS}


def test_committed_r1_bn_fixture_matches_jax_regeneration():
    fresh_arrays = make_r1_bn_fixture()
    with np.load(FIXTURE) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(committed) == sorted(fresh_arrays)
    for k, v in fresh_arrays.items():
        if k.endswith("trajectory"):
            np.testing.assert_allclose(committed[k], v, atol=1e-6, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(committed[k], v, err_msg=k)


@pytest.mark.parametrize("name", sorted(FIXTURE_RUNS))
def test_port_reproduces_the_r1_bn_fixture(name):
    """The port's four steps hold each run's trajectory within
    tests/test_golden.py's tolerances (d_r1 at d_loss's)."""
    with np.load(FIXTURE) as z:
        arrays = runs_of({k: z[k] for k in z.files})[name]
    keys = FIXTURE_RUNS[name][2]
    traj = replay(arrays, keys)
    tols = list(GOLDEN_TOL) + [GOLDEN_TOL[0]] * (len(keys) - len(GOLDEN_TOL))
    for got, want in zip(traj, arrays["trajectory"]):
        for a, b, tol in zip(got, want, tols):
            np.testing.assert_allclose(a, b, **tol)
