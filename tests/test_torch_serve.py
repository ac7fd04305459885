"""The port's HTTP server and CLI on the CPU: round trips equal to the direct
predictor calls, the uint8 wire encoding, bfloat16 responses, error paths,
and a served JAX export answering like the JAX predictor."""

import dataclasses
import http.client
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.infer import Predictor as JaxPredictor
from action_conditioned_gans_tpu.infer import export_generator as jax_export
from action_conditioned_gans_tpu.models import Generator as JaxGenerator
from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.config import Config, ModelConfig
from action_conditioned_gans_tpu_torch.infer import Predictor
from action_conditioned_gans_tpu_torch.serve import (
    _dump_npz,
    build_predictor,
    client_predict,
    client_rollout,
    make_server,
)

torch.set_num_threads(1)
TINY = dict(image_size=16, g_levels=2, g_base_channels=8, group_norm_groups=4,
            compute_dtype="float32")


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_params(m):
    frame = np.zeros((1, m.image_size, m.image_size, m.image_channels), np.float32)
    action = np.zeros((1, m.action_dim), np.float32)
    state = np.zeros((1, m.state_dim), np.float32) if m.state_dim else None
    params = JaxGenerator(m).init(jax.random.PRNGKey(0), frame, action, state)["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


class Served:
    def __init__(self, predictor):
        self.predictor = predictor
        self.srv = make_server(predictor, port=0)
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_port}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jm = jcfg.ModelConfig(**TINY)
    params = jax_params(jm)
    path = str(tmp_path_factory.mktemp("serve") / "generator.npz")
    jax_export(jcfg.Config(model=jm), params, path)
    return jm, params, path


@pytest.fixture(scope="module")
def live(exported):
    _, _, path = exported
    served = Served(Predictor.from_npz(path, device="cpu"))
    yield served
    served.close()


def test_healthz(live):
    with urllib.request.urlopen(live.url + "/healthz") as r:
        meta = json.loads(r.read())
    assert meta == {"ok": True, "device": "cpu", "backend": "Predictor", "image_size": 16,
                    "image_channels": 3, "action_dim": 4, "state_dim": 0}


def test_predict_and_rollout_match_direct_calls_and_jax(live, exported):
    jm, params, _ = exported
    frame, action, actions = rand(0, 2, 16, 16, 3), rand(1, 2, 4), rand(2, 2, 3, 4)
    via_p = client_predict(live.url, frame, action)
    via_r = client_rollout(live.url, frame, actions)
    np.testing.assert_array_equal(via_p, live.predictor.predict(frame, action).numpy())
    np.testing.assert_array_equal(via_r, live.predictor.rollout(frame, actions).numpy())
    jp = JaxPredictor(jcfg.Config(model=jm), params)
    np.testing.assert_allclose(via_p, np.asarray(jp.predict(frame, action)), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(via_r, np.asarray(jp.rollout(frame, actions)), atol=1e-3, rtol=1e-3)


def test_uint8_encoding(live):
    frame, action, actions = rand(3, 4, 16, 16, 3), rand(4, 4, 4), rand(5, 2, 3, 4)
    exact = client_predict(live.url, frame, action)
    quant = client_predict(live.url, frame, action, encoding="uint8")
    assert quant.dtype == np.float32
    assert np.max(np.abs(quant - exact)) <= 1.0 / 255.0 + 1e-6
    body = _dump_npz(frame=frame, action=action)

    def body_len(path):
        with urllib.request.urlopen(urllib.request.Request(live.url + path, data=body)) as r:
            return len(r.read())

    assert body_len("/predict?encoding=uint8") < body_len("/predict") / 3.5
    out = client_rollout(live.url, frame[:2], actions, encoding="uint8")
    direct = live.predictor.rollout(frame[:2], actions).numpy()
    assert np.max(np.abs(out - direct)) <= 1.0 / 255.0 + 1e-6


def test_bfloat16_predictor_answers_in_float32(exported):
    _, _, path = exported
    cfg = Config(model=dataclasses.replace(ModelConfig(), compute_dtype="bfloat16"))
    served = Served(Predictor.from_npz(path, cfg=cfg, device="cpu"))
    try:
        frame, action = rand(6, 2, 16, 16, 3), rand(7, 2, 4)
        out = client_predict(served.url, frame, action)
        assert out.dtype == np.float32
        direct = served.predictor.predict(frame, action)
        assert direct.dtype == torch.bfloat16
        np.testing.assert_array_equal(out, direct.float().numpy())
    finally:
        served.close()


@pytest.mark.parametrize(
    "path,body,code,needle",
    [
        ("/nope", _dump_npz(frame=np.zeros((1, 16, 16, 3), np.float32)), 404, "unknown path"),
        ("/predict", b"not-npz", 400, "npz"),
        ("/predict", _dump_npz(frame=np.zeros((2, 16, 16, 3), np.float32)), 400, "missing input array"),
        ("/predict?encoding=float16", _dump_npz(frame=np.zeros((1, 16, 16, 3), np.float32)), 400, "encoding"),
        ("/predict", _dump_npz(frame=np.zeros((2, 8, 8, 3), np.float32),
                               action=np.zeros((2, 4), np.float32)), 400, "frame must have shape"),
        ("/rollout", _dump_npz(frame0=np.zeros((2, 16, 16, 3), np.float32),
                               actions=np.zeros((2, 4), np.float32)), 400, "actions must have shape"),
    ],
)
def test_error_paths(live, path, body, code, needle):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(urllib.request.Request(live.url + path, data=body))
    assert e.value.code == code
    assert needle in json.loads(e.value.read())["error"]


def test_keepalive_connection_survives_errors(live):
    conn = http.client.HTTPConnection(live.url.split("//")[1], timeout=30)
    try:
        conn.request("POST", "/nope", body=_dump_npz(frame=np.zeros((1, 16, 16, 3), np.float32)))
        r1 = conn.getresponse()
        assert r1.status == 404
        r1.read()
        conn.request("GET", "/healthz")
        r2 = conn.getresponse()
        assert r2.status == 200
        r2.read()
    finally:
        conn.close()


@pytest.mark.parametrize("length,code", [(str(50 * 2**30), 413), ("-1", 400)])
def test_bad_content_length_is_refused(live, length, code):
    conn = http.client.HTTPConnection(live.url.split("//")[1], timeout=30)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        assert conn.getresponse().status == code
    finally:
        conn.close()


TINY_SETS = [f"model.{k}={v}" for k, v in TINY.items()]


@pytest.fixture(scope="module")
def sources(tmp_path_factory, exported):
    """The three sources ``serve`` takes, of one tiny generator: a workdir
    whose checkpoint holds EMA weights (the parameters + 0.01), an AOT
    artifact of its parameters and the JAX export of ``exported``; with
    the direct predictors on the parameters and on the EMA weights."""
    from action_conditioned_gans_tpu_torch.aot import export_aot
    from action_conditioned_gans_tpu_torch.train.state import init_state, state_to_host
    from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("sources")
    cfg = cli.apply_overrides(Config(workdir=str(root / "w")),
                              TINY_SETS + ["train.ema_decay=0.5", "train.batch_size=2"])
    state = init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    state.g_ema = {k: v + 0.01 for k, v in state.g_params.items()}
    CheckpointManager(f"{cfg.workdir}/checkpoints").save(7, state_to_host(state, cfg))
    aot = str(root / "g.aot")
    export_aot(cfg, state.g_params, aot, rollout_length=3, device="cpu")
    return dict(cfg=cfg, workdir=cfg.workdir, aot=aot, npz=exported[2],
                raw=Predictor(cfg, state.g_params, device="cpu"),
                ema=Predictor(cfg, state.g_ema, device="cpu"))


def test_build_predictor_takes_npz_and_refuses_the_rest(sources):
    """The three routes: an .npz archive to ``from_npz``, any other artifact
    to the AOT predictor, no artifact to ``from_checkpoint`` of --workdir
    (--ema: its EMA weights); a source that holds nothing is refused."""
    import argparse

    from action_conditioned_gans_tpu_torch.aot import AotPredictor

    cfg = Config(model=ModelConfig(compute_dtype="float32"))
    args = lambda **kw: argparse.Namespace(**{"artifact": None, "device": "cpu", **kw})  # noqa: E731
    p = build_predictor(args(artifact=sources["npz"]), cfg)
    assert isinstance(p, Predictor) and p.cfg.model.image_size == 16
    p = build_predictor(args(artifact=sources["aot"]), cfg)
    assert isinstance(p, AotPredictor) and p.device.type == "cpu"
    frame, action, actions = rand(20, 2, 16, 16, 3), rand(21, 2, 4), rand(22, 2, 3, 4)
    assert torch.equal(p.predict(frame, action), sources["raw"].predict(frame, action))
    for ema, want in ((False, sources["raw"]), (True, sources["ema"])):
        p = build_predictor(args(workdir=sources["workdir"], ema=ema), sources["cfg"])
        assert isinstance(p, Predictor)
        assert torch.equal(p.predict(frame, action), want.predict(frame, action))
        assert torch.equal(p.rollout(frame, actions), want.rollout(frame, actions))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        build_predictor(args(workdir=str(sources["workdir"]) + "-empty"), sources["cfg"])
    with pytest.raises(FileNotFoundError):
        build_predictor(args(artifact=sources["aot"] + "-missing"), cfg)


@pytest.mark.parametrize("source", ["workdir", "workdir --ema", "aot"])
def test_serve_workdir_and_aot_over_http(sources, source):
    """``serve --workdir <dir> [--ema]`` and ``serve --artifact x.aot`` in a
    process of their own: /predict and /rollout equal the direct calls."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if source == "aot":
        argv, want = ["--artifact", sources["aot"]], sources["raw"]
    else:
        argv = ["--workdir", sources["workdir"]] + [a for s in TINY_SETS for a in ("--set", s)]
        want = sources["ema" if "--ema" in source else "raw"]
        argv += ["--ema"] if "--ema" in source else []
    code = "import torch, sys; torch.set_num_threads(1); from action_conditioned_gans_tpu_torch.cli import main; sys.exit(main(sys.argv[1:]))"
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "serve", *argv, "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
    )
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["backend"] == ("AotPredictor" if source == "aot" else "Predictor")
        frame, action, actions = rand(23, 2, 16, 16, 3), rand(24, 2, 4), rand(25, 2, 3, 4)
        np.testing.assert_array_equal(client_predict(banner["serving"], frame, action),
                                      want.predict(frame, action).numpy())
        np.testing.assert_array_equal(client_rollout(banner["serving"], frame, actions),
                                      want.rollout(frame, actions).numpy())
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_configs_and_serve_argument_checks(capsys):
    assert cli.main(["configs"]) == 0
    assert "config1: 64px" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        cli.main(["serve"])
    assert e.value.code == 2
    cfg = cli.apply_overrides(Config(), ["model.compute_dtype=float32", "train.batch_size=3"])
    assert cfg.model.compute_dtype == "float32" and cfg.train.batch_size == 3


def test_cli_serve_subprocess(exported):
    """``python -m action_conditioned_gans_tpu_torch serve --artifact g.npz
    --device cpu --port 0`` prints its banner and answers."""
    import os
    import subprocess
    import sys

    _, _, path = exported
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "action_conditioned_gans_tpu_torch", "serve", "--artifact", path,
         "--device", "cpu", "--port", "0", "--set", "model.compute_dtype=float32"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
    )
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["backend"] == "Predictor" and banner["device"] == "cpu"
        out = client_predict(banner["serving"], np.zeros((2, 16, 16, 3), np.float32),
                             np.zeros((2, 4), np.float32))
        assert out.shape == (2, 16, 16, 3) and out.dtype == np.float32
    finally:
        proc.terminate()
        proc.wait(timeout=30)
