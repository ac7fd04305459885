"""The plain reference (``benchmark/reference/acgan.py``) against the port on
the CPU at a tiny size, both in float32: the generator, the discriminator,
two calls of fused training steps with both Adam updates, the second from
the program's state after the first, and the
step-by-step check of a rollout. Also: nothing the harness loads is JAX or
the JAX package, by whole top-level names."""

import dataclasses
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.func import functional_call

from benchmark import harness, inputs
from benchmark.runners import train_steps
from benchmark.reference import acgan as ref

from conftest import ROOT, tiny

torch.set_num_threads(2)


def float32(found):
    found["config"]["config"]["model"]["compute_dtype"] = "float32"
    return found


@pytest.fixture(params=["config5", "config1"])
def cell(request):
    """The training cell's traffic over each configuration: config5's, and
    config1's, whose Adam keeps bfloat16 moments."""
    found = harness.find_cell("config5.train")
    path = os.path.join(ROOT, "benchmark", "configs", f"{request.param}.json")
    found["config"] = harness.load_json(path)
    return float32(tiny(found))


def port_cfg(cfg):
    from action_conditioned_gans_tpu_torch.config import config_from_dict

    return config_from_dict(cfg)


def test_models_match_the_port(cell):
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator

    cfg = cell["config"]["config"]
    m = cfg["model"]
    g_spec, d_spec = ref.param_spec(m)
    g = inputs.make_params(g_spec, 3, "g", "cpu")
    d = inputs.make_params(d_spec, 3, "d", "cpu")
    gen, disc = Generator(port_cfg(cfg).model), Discriminator(port_cfg(cfg).model)
    assert {k: tuple(v.shape) for k, v in gen.state_dict().items()} == {
        k: s for k, (s, _) in g_spec.items()}
    assert {k: tuple(v.shape) for k, v in disc.state_dict().items()} == {
        k: s for k, (s, _) in d_spec.items()}
    gen_ = torch.Generator().manual_seed(0)
    frame = torch.rand(5, m["image_size"], m["image_size"], 3, generator=gen_) * 2 - 1
    nxt = torch.rand(5, m["image_size"], m["image_size"], 3, generator=gen_) * 2 - 1
    action = torch.rand(5, m["action_dim"], generator=gen_) * 2 - 1
    with torch.no_grad():
        torch.testing.assert_close(ref.generator(m, g, frame, action),
                                   functional_call(gen, g, (frame, action)), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ref.discriminator(m, d, nxt, frame, action),
                                   functional_call(disc, d, (nxt, frame, action)),
                                   rtol=1e-5, atol=1e-5)


def test_training_call_matches_the_port(cell):
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import make_mesh
    from action_conditioned_gans_tpu_torch.train.state import state_from_params

    cfg = cell["config"]["config"]
    c = port_cfg(cfg)
    g_spec, d_spec = ref.param_spec(cfg["model"])
    g = inputs.make_params(g_spec, 5, "g", "cpu")
    d = inputs.make_params(d_spec, 5, "d", "cpu")
    batch = inputs.train_bank(cfg, 1, 5, "cpu")[0]
    state = state_from_params(c, g, d, device="cpu")
    step = make_dp_train_step(c, make_mesh(c.mesh, device="cpu"))
    k = batch["frames"].shape[0]
    before = {"g": g, "d": d}
    for call in range(2):
        state, metrics = step(state, batch)
        # Two blocks of rows: the sums over blocks are the step's means. The
        # second call continues from the program's state after the first.
        out = train_steps.reference_call(ref, cfg, before, batch["frames"], batch["actions"],
                                         rows=5)
        for name, v in out["losses"][-1].items():
            assert float(metrics[name]) == pytest.approx(v, rel=1e-4), (call, name)
        after = train_steps.snapshot(state)
        assert out["d_count"] == after["d_count"] == out["g_count"] == (call + 1) * k
        for key in ("g", "d", "g_mu", "g_nu", "d_mu", "d_nu"):
            # Moments stored in bfloat16 may round the two sides' float32
            # values to neighbouring bfloat16 numbers: one unit apart.
            rtol = 2**-7 if key.endswith(("mu", "nu")) and after[key][
                next(iter(after[key]))].dtype == torch.bfloat16 else 1e-3
            for leaf in out[key]:
                torch.testing.assert_close(out[key][leaf], after[key][leaf].float(), rtol=rtol,
                                           atol=1e-5, msg=f"call {call} {key} {leaf}")
        before = after


def test_rollout_check_reads_nothing_on_the_ports_frames():
    from action_conditioned_gans_tpu_torch.infer import Predictor

    found = float32(tiny(harness.find_cell("config5.serve")))
    cfg = found["config"]["config"]
    g = inputs.make_params(ref.param_spec(cfg["model"])[0], 9, "g", "cpu")
    r = inputs.requests(cfg, 1, 4, 5, 9, "cpu")[0]
    frames = Predictor(port_cfg(cfg), g, device="cpu").rollout(r["frame0"], r["actions"])
    gaps = ref.rollout_gaps(cfg["model"], g, torch.from_numpy(r["frame0"]),
                            torch.from_numpy(r["actions"]), frames)
    assert gaps.shape == (5, 4)
    assert float(gaps.max()) < 1e-5


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "action_conditioned_gans_tpu_torch_x", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "action_conditioned_gans_tpu.ops", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["action_conditioned_gans_tpu", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of a cell, in a fresh process, at a tiny size on the CPU."""
    code = f"""
import sys, time
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {ROOT + '/benchmark/tests'!r})
from benchmark import harness
from conftest import tiny
for name in ("config5.train", "config5.serve"):
    harness.run_cell(name, 1, 0.2, True, time.perf_counter(), device="cpu",
                     config=tiny(harness.find_cell(name))["config"]["config"])
assert "action_conditioned_gans_tpu_torch" in sys.modules
print("FORBIDDEN", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_a_flat_moment_is_read_by_parameter_name():
    """In the program's flat optimizer layout (``train.flatten_optimizer``)
    the parameters are views of one buffer and each moment is one vector:
    the check reads each parameter's slice at its offset in the buffer."""
    from action_conditioned_gans_tpu_torch.train.state import flat_params

    tensors = {"b.kernel": torch.arange(6.0).view(2, 3), "a.bias": torch.arange(4.0) + 10}
    params = flat_params(tensors)
    moment = torch.cat([v.reshape(-1) for v in params.values()]) * 2
    named = train_steps._named(params, moment)
    for name, value in tensors.items():
        torch.testing.assert_close(named[name], value * 2)
    assert train_steps._named(params, {"x": moment}) == {"x": moment}
