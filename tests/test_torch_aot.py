"""The AOT artifact (``aot.py``) on the CPU: export, load, parity.

An artifact exported on the CPU serves, from one file, batches of 1, 3 and
8 with the live port Predictor's bits, and matches the JAX package's
``AotPredictor`` on the same weights within 1e-3 in float32. Its graphs hold
the ``acgan::`` custom ops (counted); a process that loads and serves it
never imports the model code. The cases are tests/test_aot.py's:
round trip with a symbolic batch, a state-conditioned artifact, the error
paths, ``export --format pt2`` (the JAX package's ``--format stablehlo``)
and a multi-horizon artifact.
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu import aot as jaot
from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.models import Generator as JaxGenerator
from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.aot import AotPredictor, export_aot
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
from action_conditioned_gans_tpu_torch.infer import Predictor
from action_conditioned_gans_tpu_torch.models.common import ConvBlock
from action_conditioned_gans_tpu_torch.ops import api
from action_conditioned_gans_tpu_torch.train.state import init_state, state_to_host
from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, g_levels=2, g_base_channels=8, d_levels=2, d_base_channels=8,
            group_norm_groups=4, compute_dtype="float32")


def configs(state_dim=0):
    j = jcfg.Config(name="tiny-aot", model=jcfg.ModelConfig(**TINY, state_dim=state_dim),
                    data=jcfg.DataConfig(seq_len=2), train=jcfg.TrainConfig(batch_size=2))
    return j, tcfg.Config(model=tcfg.ModelConfig(**TINY, state_dim=state_dim))


def jax_params(m, seed=0):
    args = (np.zeros((1, 16, 16, 3), np.float32), np.zeros((1, 4), np.float32),
            np.zeros((1, m.state_dim), np.float32) if m.state_dim else None)
    params = JaxGenerator(m).init(jax.random.PRNGKey(seed), *args)["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def inputs(b, t=0, state_dim=0, seed=0):
    rng = np.random.default_rng(seed)
    frame = np.tanh(rng.standard_normal((b, 16, 16, 3))).astype(np.float32)
    lead = (b, t) if t else (b,)
    action = rng.standard_normal((*lead, 4)).astype(np.float32)
    state = rng.standard_normal((*lead, state_dim)).astype(np.float32) if state_dim else None
    return frame, action, state


def program_ops(path, member):
    """{acgan op name: node count} of one program of an artifact."""
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read(member)))
    counts = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("acgan."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


@pytest.fixture(scope="module", params=[0, 3], ids=["no_state", "state_dim3"])
def artifact(request, tmp_path_factory):
    """(path, JAX config, params, live Predictor, routes traced) of an
    artifact exported on the CPU with rollouts T=2 and T=3."""
    state_dim = request.param
    jc, tc = configs(state_dim)
    params = jax_params(jc.model, seed=state_dim)
    path = str(tmp_path_factory.mktemp("aot") / "g.aot")
    api.reset_routes()
    meta = export_aot(tc, flax_to_state_dict(params), path, rollout_length=[3, 2], device="cpu")
    routes = dict(api.ROUTES)
    assert meta["rollout_lengths"] == [2, 3] and meta["bytes"] == os.path.getsize(path)
    return path, jc, params, Predictor(tc, params, device="cpu"), routes


def test_roundtrip_parity_and_symbolic_batch(artifact):
    """Batches 1, 3 and 8 from one artifact, bit for bit the live predictor."""
    path, jc, params, live, _ = artifact
    sd = jc.model.state_dim
    p = AotPredictor(path, device="cpu")
    assert p.device.type == "cpu" and p.rollout_lengths == [2, 3]
    for b in (1, 3, 8):
        args = inputs(b, state_dim=sd, seed=b)
        got = p.predict(*args)
        assert got.dtype == torch.float32 and got.shape == (b, 16, 16, 3)
        assert torch.equal(got, live.predict(*args)), b
        for t in (2, 3):
            frame, actions, states = inputs(b, t, sd, seed=10 * b + t)
            assert torch.equal(p.rollout(frame, actions, states),
                               live.rollout(frame, actions, states)), (b, t)


def test_matches_the_jax_aot_predictor(artifact, tmp_path):
    path, jc, params, _, _ = artifact
    sd = jc.model.state_dim
    jpath = str(tmp_path / "jax.aot")
    jaot.export_stablehlo(jc, params, jpath, platforms=("cpu",), rollout_length=2)
    jp, p = jaot.AotPredictor(jpath), AotPredictor(path, device="cpu")
    args = inputs(3, state_dim=sd, seed=5)
    np.testing.assert_allclose(p.predict(*args).numpy(), np.asarray(jp.predict(*args)),
                               atol=1e-3, rtol=1e-3)
    frame, actions, states = inputs(3, 2, sd, seed=6)
    np.testing.assert_allclose(p.rollout(frame, actions, states).numpy(),
                               np.asarray(jp.rollout(frame, actions, states)),
                               atol=1e-3, rtol=1e-3)


def test_graphs_hold_the_custom_ops(artifact):
    """Every layer of the tiny generator is fused: five acgan:: conv nodes a
    generator call (enc_0, enc_1, bottleneck; dec_1, dec_0), T calls in a
    rollout program; the export traced exactly those routes."""
    path, _, _, _, routes = artifact
    assert program_ops(path, "predict.pt2") == {"conv_norm_act": 3, "conv_transpose_norm_act": 2}
    for t in (2, 3):
        assert program_ops(path, f"rollout_T{t}.pt2") == {"conv_norm_act": 3 * t,
                                                          "conv_transpose_norm_act": 2 * t}
    assert routes == {**dict.fromkeys(routes, 0), "fused": 5 * (1 + 2 + 3)}


def test_a_split_layer_exports_kernel_3(tmp_path):
    """A layer off the fused envelope (a float32 3x3 conv, 512 -> 512: its
    weights alone pass the budget) exports as the plain conv then the
    acgan::group_norm_act node, and serves the live block's bits."""
    block = ConvBlock(512, 512, kernel=3, stride=1, groups=32, act="lrelu",
                      generator=torch.Generator().manual_seed(0)).eval().requires_grad_(False)
    x = torch.from_numpy(np.tanh(np.random.default_rng(0).standard_normal((2, 8, 8, 512))
                                 ).astype(np.float32))
    with torch.no_grad():
        program = torch.export.export(block, (x,), strict=False,
                                      dynamic_shapes=({0: torch.export.Dim("batch", min=1)},))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("acgan.group_norm_act.default") == 1
    assert not any(t.startswith("acgan.conv") for t in targets)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    loaded = torch.export.load(buf).module()
    with torch.no_grad():
        assert torch.equal(loaded(x[:1]), block(x[:1]))


def test_error_paths(artifact, tmp_path):
    path, jc, params, _, _ = artifact
    sd = jc.model.state_dim
    p = AotPredictor(path, device="cpu")
    frame, action, state = inputs(2, state_dim=sd)
    if sd:
        with pytest.raises(ValueError, match="pass `state`"):
            p.predict(frame, action)
        frame, actions, states = inputs(2, 2, sd)
        with pytest.raises(ValueError, match="states horizon"):
            p.rollout(frame, actions, states[:, :1])
    else:
        with pytest.raises(ValueError, match="without a state"):
            p.predict(frame, action, np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match=r"horizons are \[2, 3\], got actions with T=4"):
        p.rollout(frame, inputs(2, 4, sd)[1], inputs(2, 4, sd)[2])
    with pytest.raises(ValueError, match="frame must have shape"):
        p.predict(frame[:, :8], action, state)

    _, tc = configs(sd)
    only = str(tmp_path / "predict-only.aot")
    export_aot(tc, flax_to_state_dict(params), only, device="cpu")
    assert sorted(zipfile.ZipFile(only).namelist()) == ["meta.json", "predict.pt2"]
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    with pytest.raises(ValueError, match="no rollout program"):
        AotPredictor(only, device="cpu").rollout(frame, inputs(2, 3, sd)[1], inputs(2, 3, sd)[2])
    with pytest.raises(ValueError, match="negative rollout_length"):
        export_aot(tc, flax_to_state_dict(params), only, rollout_length=[2, -1], device="cpu")

    bad = str(tmp_path / "bad.aot")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(bad, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), "format_version": 999}).encode()
            zout.writestr(name, data)
    with pytest.raises(ValueError, match="unsupported artifact format"):
        AotPredictor(bad, device="cpu")


def test_meta_json(artifact):
    path, jc, _, _, _ = artifact
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        names = sorted(z.namelist())
    assert names == ["meta.json", "predict.pt2", "rollout_T2.pt2", "rollout_T3.pt2"]
    assert meta["format_version"] == 1 and meta["rollout_lengths"] == [2, 3]
    assert meta["state_dim"] == jc.model.state_dim and meta["torch_version"] == torch.__version__
    assert tcfg.ModelConfig(**meta["model_config"]) == tcfg.ModelConfig(
        **TINY, state_dim=jc.model.state_dim)


def test_loads_and_serves_without_the_model_code(artifact, tmp_path):
    """A fresh process serves the artifact with only aot.py (and the ops it
    registers) imported: ``action_conditioned_gans_tpu_torch.models`` never
    is. Its output is the live predictor's."""
    path, jc, _, live, _ = artifact
    args = inputs(3, state_dim=jc.model.state_dim, seed=9)
    np.savez(tmp_path / "in.npz", frame=args[0], action=args[1],
             **({"state": args[2]} if args[2] is not None else {}))
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)  # the parent's: CPU convs sum in thread order\n"
        "from action_conditioned_gans_tpu_torch.aot import AotPredictor\n"
        f"z = np.load({str(tmp_path / 'in.npz')!r})\n"
        f"p = AotPredictor({path!r}, device='cpu')\n"
        "out = p.predict(z['frame'], z['action'], z['state'] if 'state' in z.files else None)\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "bad = sorted(m for m in sys.modules if m.startswith('action_conditioned_gans_tpu_torch.models')"
        " or m == 'action_conditioned_gans_tpu' or m.startswith('action_conditioned_gans_tpu.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=300,
                   env=dict(os.environ, PYTHONPATH=REPO))
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), live.predict(*args).numpy())


def tiny_sets():
    sets = []
    for k, v in TINY.items():
        sets += ["--set", f"model.{k}={v}"]
    return sets + ["--set", "train.batch_size=2"]


def test_cli_export_pt2(tmp_path, capsys):
    """``export --format pt2`` of a checkpoint (the JAX package's
    ``--format stablehlo`` case), the argument rules, and the artifact
    serving the checkpoint's parameters."""
    cfg = cli.apply_overrides(tcfg.get_preset("config1"), tiny_sets()[1::2])
    cfg = tcfg.Config(**{**cfg.__dict__, "workdir": str(tmp_path)})
    state = init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    base = ["--preset", "config1", "--workdir", str(tmp_path), "--device", "cpu", *tiny_sets()]
    out = str(tmp_path / "generator.aot")
    for argv, msg in ((["--out", out], "needs a checkpoint"),
                      (["--rollout-length", "2"], "requires --format pt2"),
                      (["--format", "stablehlo"], "--format pt2")):
        with pytest.raises(SystemExit) as e:
            cli.main(["export", *base, *argv])
        assert e.value.code == 2 and msg in capsys.readouterr().err
    CheckpointManager(f"{tmp_path}/checkpoints").save(3, state_to_host(state, cfg))
    with pytest.raises(SystemExit):  # --ema needs EMA weights in the checkpoint
        cli.main(["export", *base, "--ema", "--format", "pt2"])
    capsys.readouterr()
    assert cli.main(["export", *base, "--out", out, "--format", "pt2",
                     "--rollout-length", "2,3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"exported": out, "ema": False, "format": "pt2", "platforms": ["cpu", "cuda"],
                   "rollout_lengths": [2, 3], "bytes": os.path.getsize(out)}
    live = Predictor(cfg, state.g_params, device="cpu")
    p = AotPredictor(out, device="cpu")
    args = inputs(2, seed=4)
    assert torch.equal(p.predict(*args), live.predict(*args))
    frame, actions, _ = inputs(2, 3, seed=5)
    assert torch.equal(p.rollout(frame, actions), live.rollout(frame, actions))


def test_multi_horizon_artifact(artifact):
    """rollout() dispatches on T; an unexported T lists the horizons."""
    path, jc, _, live, _ = artifact
    p = AotPredictor(path, device="cpu")
    sd = jc.model.state_dim
    for t in (3, 2):
        frame, actions, states = inputs(2, t, sd, seed=20 + t)
        assert torch.equal(p.rollout(frame, actions, states), live.rollout(frame, actions, states))
    frame, actions, states = inputs(2, 1, sd)
    with pytest.raises(ValueError, match=r"horizons are \[2, 3\]"):
        p.rollout(frame, actions, states)
