"""The port's config, converter, Generator and Predictor against the JAX
package's, on the CPU.

Weights are the JAX ``init`` params carried across by ``convert.py`` or by
a JAX ``export_generator`` archive; inputs are numpy arrays from a seed fed
to both. float32, tolerance 1e-3 (the bar of tests/test_pallas.py).
"""

import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.infer import Predictor as JaxPredictor
from action_conditioned_gans_tpu.infer import export_generator as jax_export
from action_conditioned_gans_tpu.models import Generator as JaxGenerator
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from action_conditioned_gans_tpu_torch.infer import Predictor, export_generator, rollout_scan
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.ops import api, envelope

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_tiny_generator.npz")
TINY = dict(image_size=16, g_levels=2, g_base_channels=8, group_norm_groups=4,
            compute_dtype="float32")


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_params(model_cfg, seed=0, batch=1):
    m = model_cfg
    frame = np.zeros((batch, m.image_size, m.image_size, m.image_channels), np.float32)
    action = np.zeros((batch, m.action_dim), np.float32)
    state = np.zeros((batch, m.state_dim), np.float32) if m.state_dim else None
    params = JaxGenerator(m).init(jax.random.PRNGKey(seed), frame, action, state)["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_generator(jax_model_cfg, params):
    gen = Generator(tcfg.ModelConfig(**dataclasses.asdict(jax_model_cfg)))
    gen.load_state_dict(flax_to_state_dict(params))
    return gen.eval()


# -- config ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "TrainConfig", "MeshConfig", "Config"])
def test_config_fields_and_defaults_match_jax(name):
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, name))}
    assert list(jf) == list(tf)
    for key in jf:
        if jf[key].default is not dataclasses.MISSING:
            assert jf[key].default == tf[key].default, key


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_presets_match_jax(preset):
    assert dataclasses.asdict(tcfg.get_preset(preset)) == dataclasses.asdict(jcfg.get_preset(preset))


@pytest.mark.parametrize(
    "bad",
    [dict(backend="cuda"), dict(gn_backward="x"), dict(wgrad="patches", backend="pallas"),
     dict(deconv="subpixel", backend="pallas"), dict(conv0="s2d", wgrad="patches"),
     dict(sn_iters=0)],
)
def test_config_post_init_checks_match_jax(bad):
    with pytest.raises(ValueError):
        jcfg.ModelConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.ModelConfig(**bad)


def test_config_dtype_is_a_torch_dtype():
    assert tcfg.ModelConfig().dtype == torch.bfloat16
    assert tcfg.ModelConfig(compute_dtype="float32").dtype == torch.float32


@pytest.mark.parametrize(
    "knob", [dict(wgrad="patches"), dict(deconv="subpixel"), dict(conv0="s2d")],
)
def test_archive_engine_values_are_kept_and_serve_the_same_forward(knob, tmp_path, monkeypatch):
    """An archive that records an engine knob loads with the knob kept, as
    the JAX package's ``from_npz`` keeps it, and serves the default
    engine's forward (the engines compute one function), within 1e-3 of
    the JAX Predictor on the same archive. The routing budget is set to 0,
    so every layer is split and the rewrites run."""
    monkeypatch.setattr(envelope, "VMEM_BUDGET", 0)
    jm = jcfg.ModelConfig(**TINY, **knob)
    path = str(tmp_path / "g.npz")
    params = jax_params(jm)
    jax_export(jcfg.Config(model=jm), params, path)
    p = Predictor.from_npz(path, device="cpu")
    assert p.cfg.model.image_size == 16
    assert all(getattr(p.cfg.model, k) == v for k, v in knob.items())
    plain = Predictor(tcfg.Config(model=tcfg.ModelConfig(**TINY)), params, device="cpu")
    frame, action = np.tanh(rand(5, 3, 16, 16, 3)), rand(6, 3, 4)
    api.reset_routes()
    got = p.predict(frame, action).numpy()
    rewrites = {"conv0": ("s2d", 1), "deconv": ("subpixel", 2), "wgrad": ("patches", 0)}
    route, n = rewrites[next(iter(knob))]
    assert api.ROUTES["split"] == 5 and api.ROUTES[route] == n
    np.testing.assert_allclose(got, plain.predict(frame, action).numpy(), atol=1e-5, rtol=1e-5)
    want = JaxPredictor.from_npz(path).predict(frame, action)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# -- converter -----------------------------------------------------------------


@pytest.mark.parametrize("skip", [False, True])
def test_converter_round_trip_is_bit_exact(skip):
    m = jcfg.ModelConfig(**TINY, skip_connections=skip, state_dim=3)
    params = jax_params(m)
    sd = flax_to_state_dict(params)
    gen = Generator(tcfg.ModelConfig(**dataclasses.asdict(m)))
    assert set(sd) == set(gen.state_dict())  # names and presence of scale match
    for k, v in gen.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    back = state_dict_to_flax(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        layer, name = (p.key for p in path)
        assert back[layer][name].dtype == np.float32
        np.testing.assert_array_equal(back[layer][name], leaf)


def test_port_init_follows_the_flax_distribution():
    gen = Generator(tcfg.ModelConfig(**TINY), generator=torch.Generator().manual_seed(0))
    k = gen.enc_1.kernel.detach()
    assert float(k.abs().max()) <= 0.04 and 0.015 < float(k.std()) < 0.02
    assert torch.equal(gen.enc_1.scale, torch.ones(16)) and gen.enc_0.scale is None
    assert torch.equal(gen.dec_0.bias, torch.zeros(3))


# -- generator -----------------------------------------------------------------


def test_generator_matches_jax_pallas_path_tiny():
    """The tiny config of tests/test_pallas.py through the JAX Pallas kernels
    (interpret mode) and through the port."""
    jm = jcfg.ModelConfig(backend="pallas", **TINY)
    params = jax_params(jm)
    frame, action = rand(0, 2, 16, 16, 3), rand(1, 2, 4)
    want = np.asarray(JaxGenerator(jm).apply({"params": params}, frame, action))
    with torch.no_grad():
        got = port_generator(jm, params)(torch.from_numpy(frame), torch.from_numpy(action))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_generator_matches_jax_xla_path_config1_full_width():
    jm = dataclasses.replace(jcfg.get_preset("config1").model, compute_dtype="float32")
    params = jax_params(jm)
    frame, action = np.tanh(rand(2, 2, 64, 64, 3)), rand(3, 2, 4)
    want = np.asarray(JaxGenerator(jm).apply({"params": params}, frame, action))
    with torch.no_grad():
        got = port_generator(jm, params)(torch.from_numpy(frame), torch.from_numpy(action))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_generator_with_state_and_skips_matches_jax():
    jm = jcfg.ModelConfig(**TINY, state_dim=3, skip_connections=True)
    params = jax_params(jm, seed=3)
    frame, action, state = rand(4, 2, 16, 16, 3), rand(5, 2, 4), rand(6, 2, 3)
    want = np.asarray(JaxGenerator(jm).apply({"params": params}, frame, action, state))
    with torch.no_grad():
        got = port_generator(jm, params)(*(torch.from_numpy(a) for a in (frame, action, state)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- predictor -----------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jm = jcfg.ModelConfig(**TINY)
    cfg = jcfg.Config(model=jm)
    params = jax_params(jm, seed=1)
    path = str(tmp_path_factory.mktemp("export") / "generator.npz")
    jax_export(cfg, params, path)
    return cfg, params, path


def test_from_npz_of_a_jax_export_matches_the_jax_predictor(exported):
    cfg, params, path = exported
    jp, tp = JaxPredictor(cfg, params), Predictor.from_npz(path, device="cpu")
    frame, action, actions = rand(7, 2, 16, 16, 3), rand(8, 2, 4), rand(9, 2, 3, 4)
    np.testing.assert_allclose(
        tp.predict(frame, action).numpy(), np.asarray(jp.predict(frame, action)), **TOL
    )
    clip = tp.rollout(frame, actions)
    assert clip.shape == (2, 3, 16, 16, 3)
    np.testing.assert_allclose(clip.numpy(), np.asarray(jp.rollout(frame, actions)), **TOL)


def test_port_export_loads_in_the_jax_predictor(exported, tmp_path):
    cfg, params, _ = exported
    tp = Predictor(tcfg.Config(model=tcfg.ModelConfig(**TINY)), params, device="cpu")
    path = str(tmp_path / "port.npz")
    export_generator(tp.cfg, tp.generator.state_dict(), path)
    jp = JaxPredictor.from_npz(path)
    frame, action = rand(10, 2, 16, 16, 3), rand(11, 2, 4)
    np.testing.assert_allclose(
        tp.predict(frame, action).numpy(), np.asarray(jp.predict(frame, action)), **TOL
    )


def test_from_npz_keeps_the_callers_runtime_knobs(exported):
    _, _, path = exported
    cfg = tcfg.Config(model=tcfg.ModelConfig(compute_dtype="bfloat16", image_size=999))
    p = Predictor.from_npz(path, cfg=cfg, device="cpu")
    assert p.cfg.model.compute_dtype == "bfloat16"  # runtime-only: caller's
    assert p.cfg.model.image_size == 16  # architecture: the archive's
    out = p.predict(np.zeros((1, 16, 16, 3), np.float32), np.zeros((1, 4), np.float32))
    assert out.dtype == torch.bfloat16


def test_rollout_feeds_back_cast_predictions():
    calls = []

    def apply_fn(prev, action, state):
        calls.append(prev.dtype)
        return (prev + action[:, None, None, :1]).to(torch.bfloat16)

    out = rollout_scan(apply_fn, torch.zeros(2, 4, 4, 3), torch.ones(2, 3, 4))
    assert calls == [torch.float32] * 3 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out[:, :, 0, 0, 0].float().numpy(), [[1, 2, 3]] * 2)


def test_predictor_rejects_bad_shapes_and_needs_an_explicit_cpu(exported):
    _, params, path = exported
    p = Predictor.from_npz(path, device="cpu")
    with pytest.raises(ValueError, match="frame"):
        p.predict(np.zeros((2, 8, 8, 3), np.float32), np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="action"):
        p.predict(np.zeros((2, 16, 16, 3), np.float32), np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="batch"):
        p.predict(np.zeros((2, 16, 16, 3), np.float32), np.zeros((3, 4), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor.from_npz(path)


# -- the committed fixture for chip_smoke.py -----------------------------------


def make_fixture(workdir) -> dict:
    """A JAX-exported tiny generator (export_generator's keys), its inputs,
    and the JAX Predictor's predict and rollout outputs under "fixture/"."""
    jm = jcfg.ModelConfig(**TINY)
    cfg = jcfg.Config(model=jm)
    params = jax_params(jm, seed=7)
    path = os.path.join(str(workdir), "generator.npz")
    jax_export(cfg, params, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    frame, action, actions = np.tanh(rand(12, 2, 16, 16, 3)), rand(13, 2, 4), rand(14, 2, 3, 4)
    jp = JaxPredictor(cfg, params)
    arrays["fixture/frame"] = frame
    arrays["fixture/action"] = action
    arrays["fixture/actions"] = actions
    arrays["fixture/predict"] = np.asarray(jp.predict(frame, action))
    arrays["fixture/rollout"] = np.asarray(jp.rollout(frame, actions))
    return arrays


def test_committed_fixture_matches_jax_regeneration(tmp_path):
    fresh = make_fixture(tmp_path)
    with np.load(FIXTURE) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(committed) == sorted(fresh)
    for k, v in fresh.items():
        if k in ("fixture/predict", "fixture/rollout"):
            np.testing.assert_allclose(committed[k], v, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(committed[k], v)


def test_port_reproduces_the_fixture_on_cpu():
    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    gen = {k: v for k, v in arrays.items() if not k.startswith("fixture/")}
    buf = io.BytesIO()
    np.savez(buf, **gen)
    buf.seek(0)
    p = Predictor.from_npz(buf, device="cpu")
    np.testing.assert_allclose(
        p.predict(arrays["fixture/frame"], arrays["fixture/action"]).numpy(),
        arrays["fixture/predict"], **TOL,
    )
    np.testing.assert_allclose(
        p.rollout(arrays["fixture/frame"], arrays["fixture/actions"]).numpy(),
        arrays["fixture/rollout"], **TOL,
    )
