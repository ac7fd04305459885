"""The port's checkpoints (``utils/checkpoint.py``, ``train/state.py``'s
``restore_state``, which reconciles an EMA tree with the config as the JAX
package does) and the state carried across from the JAX package
(``convert.train_state_from_jax``, EMA included), on the CPU."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train.step import jit_train_step
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict, train_state_from_jax
from action_conditioned_gans_tpu_torch.train import init_state, make_train_step
from action_conditioned_gans_tpu_torch.train.state import restore_state, state_to_host, state_tree
from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_train import adam_states, np_batch, np_tree, port_config, state_dicts
from tests.test_train_step import make_batch, tiny_config

torch.set_num_threads(1)


def tiny_state(moments="bfloat16", steps=1, seed=0, **train_kw):
    cfg = port_config(tiny_config(adam_moment_dtype=moments, **train_kw))
    state = init_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    step = make_train_step(cfg, device="cpu")
    for i in range(steps):
        state, _ = step(state, np_batch(make_batch(tiny_config(), seed=i)))
    return cfg, state


def assert_states_equal(a, b):
    assert a.step == b.step
    for name in ("g_params", "d_params"):
        pa, pb = getattr(a, name), getattr(b, name)
        assert pa.keys() == pb.keys()
        for k in pa:
            assert pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k]), f"{name}/{k}"
    assert (a.g_ema is None) == (b.g_ema is None)
    if a.g_ema is not None:
        assert a.g_ema.keys() == b.g_ema.keys()
        for k in a.g_ema:
            assert torch.equal(a.g_ema[k], b.g_ema[k]), f"g_ema/{k}"
    for name in ("g_opt", "d_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert oa.count == ob.count, name
        for moments in ("mu", "nu"):
            ma, mb = getattr(oa, moments), getattr(ob, moments)
            assert ma.keys() == mb.keys()
            for k in ma:
                assert ma[k].dtype == mb[k].dtype and torch.equal(ma[k], mb[k]), f"{name}/{moments}/{k}"


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_round_trip_is_bit_exact(tmp_path, moments):
    cfg, state = tiny_state(moments, steps=2)
    state.g_opt.count, state.d_opt.count = 2, 3  # distinct counts must both cross
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(2, state_to_host(state, cfg))
    template = init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    restored = restore_state(cfg, mgr, template=template)
    assert_states_equal(restored, state)
    assert restored.g_opt.mu["enc_0.kernel"].dtype == getattr(torch, moments)
    on_disk = torch.load(os.path.join(str(tmp_path), "2", "state.pt"), weights_only=True)
    assert json.loads(on_disk["config"])["train"]["adam_moment_dtype"] == moments
    # The host copy owns its storage: a later in-place step does not reach it.
    host = state_to_host(state, cfg)
    state.g_params["enc_0.kernel"].add_(1.0)
    assert not torch.equal(host["g_params"]["enc_0.kernel"], state.g_params["enc_0.kernel"])


def test_ema_round_trips_and_is_reconciled_both_ways(tmp_path):
    """g_ema crosses a checkpoint bit for bit; a checkpoint without one
    restores into an EMA config with g_ema seeded from its parameters, and
    one with an EMA tree into a config without EMA with the tree dropped, as
    the JAX package's restore_state reconciles them."""
    cfg, state = tiny_state("float32", steps=2, ema_decay=0.9)
    assert state.g_ema is not None
    assert not torch.equal(state.g_ema["enc_0.kernel"], state.g_params["enc_0.kernel"])
    with_ema = CheckpointManager(str(tmp_path / "ema"))
    with_ema.save(2, state_to_host(state, cfg))
    assert sorted(state_tree(state)) == ["d_opt", "d_params", "g_ema", "g_opt", "g_params", "step"]
    restored = restore_state(cfg, with_ema, template=init_state(cfg, torch.Generator(),
                                                                 device="cpu"))
    assert_states_equal(restored, state)

    plain_cfg, plain = tiny_state("float32", steps=2)
    dropped = restore_state(plain_cfg, with_ema, template=init_state(
        plain_cfg, torch.Generator(), device="cpu"))
    assert dropped.g_ema is None
    state.g_ema = None
    assert_states_equal(dropped, state)

    without = CheckpointManager(str(tmp_path / "plain"))
    without.save(2, state_to_host(plain, plain_cfg))
    seeded = restore_state(cfg, without, template=init_state(cfg, torch.Generator(),
                                                              device="cpu"))
    for k, v in plain.g_params.items():
        assert torch.equal(seeded.g_ema[k], v) and seeded.g_ema[k].data_ptr() != v.data_ptr()
    seeded.g_ema = None
    assert_states_equal(seeded, plain)


def test_reconciling_keeps_the_first_error(tmp_path):
    """A mismatch that is not the EMA tree's raises the error of the
    config's own template, not the toggled one's."""
    cfg, state = tiny_state("float32", steps=0, ema_decay=0.9)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state_to_host(state, cfg))
    bf16 = port_config(tiny_config(adam_moment_dtype="bfloat16", ema_decay=0.9))
    with pytest.raises(ValueError, match=r"g_opt/mu/\S+ has dtype torch.float32"):
        restore_state(bf16, mgr, template=init_state(bf16, torch.Generator(), device="cpu"))


def test_only_the_newest_keep_steps_stay(tmp_path):
    cfg, state = tiny_state(steps=0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 10, 11):
        assert mgr.save(step, state_to_host(state, cfg))
    assert mgr.all_steps() == [10, 11] and mgr.latest_step() == 11
    assert sorted(os.listdir(str(tmp_path))) == ["10", "11"]
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(str(tmp_path), keep=0)


def test_a_stray_temporary_directory_is_ignored(tmp_path):
    """A process killed mid-save leaves ``N.tmp-<pid>``; it is no step."""
    cfg, state = tiny_state(steps=0)
    os.makedirs(tmp_path / "50.tmp-123")
    (tmp_path / "50.tmp-123" / "state.pt").write_bytes(b"half a file")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state_tree(state, cfg))
    assert mgr.save(4, state_to_host(state, cfg))
    assert mgr.all_steps() == [4]
    restore_state(cfg, mgr, template=state)


def test_saving_an_existing_step_returns_false_and_writes_nothing(tmp_path):
    cfg, state = tiny_state(steps=1)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, state_to_host(state, cfg))
    path = tmp_path / "1" / "state.pt"
    before = path.read_bytes(), os.stat(path).st_mtime_ns
    state.g_params["enc_0.kernel"].add_(1.0)
    assert mgr.save(1, state_to_host(state, cfg), force=True) is False
    assert (path.read_bytes(), os.stat(path).st_mtime_ns) == before
    assert sorted(os.listdir(str(tmp_path))) == ["1"]


def test_a_template_that_differs_raises_naming_the_key(tmp_path):
    cfg, state = tiny_state(steps=0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state_to_host(state, cfg))
    wider = port_config(dataclasses.replace(
        tiny_config(adam_moment_dtype="bfloat16"),
        model=dataclasses.replace(tiny_config().model, g_base_channels=16)))
    with pytest.raises(ValueError, match=r"g_params/enc_0\.kernel has shape"):
        restore_state(wider, mgr, template=init_state(wider, torch.Generator().manual_seed(0),
                                                      device="cpu"))
    f32 = port_config(tiny_config(adam_moment_dtype="float32"))
    with pytest.raises(ValueError, match=r"g_opt/mu/\S+ has dtype torch.bfloat16"):
        restore_state(f32, mgr, template=init_state(f32, torch.Generator().manual_seed(0),
                                                    device="cpu"))
    tree = state_tree(state, cfg)
    del tree["d_opt"]
    with pytest.raises(ValueError, match="key d_opt is not in the template"):
        mgr.restore(tree)


def test_restore_without_a_template_needs_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda")
    cfg, state = tiny_state(steps=0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state_to_host(state, cfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_state(cfg, mgr)


# -- the state carried across from the JAX package -----------------------------------


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_state_carried_across_continues_the_jax_run(moments):
    """Two JAX steps, then the state crosses with ``train_state_from_jax``
    and the port takes steps 3 and 4 on the same batches: JAX's own four
    steps within the step bars (metrics 1e-5 abs / 1e-4 rel, parameters
    2e-5), equal Adam counts, moments in their own dtype."""
    jc = tiny_config(adam_moment_dtype=moments)
    cfg = port_config(jc)
    jstep = jit_train_step(jc)
    js = jax_init_state(jc, jax.random.PRNGKey(1))
    batches = [make_batch(jc, seed=20 + i) for i in range(4)]
    for b in batches[:2]:
        js, _ = jstep(js, b, jax.random.PRNGKey(0))
    ts = train_state_from_jax(cfg, np_tree(js), device="cpu")
    assert ts.step == 2 and ts.g_opt.count == ts.d_opt.count == 2
    for opt in (ts.g_opt, ts.d_opt):
        assert {v.dtype for v in (*opt.mu.values(), *opt.nu.values())} == {getattr(torch, moments)}
    tstep = make_train_step(cfg, device="cpu")
    for b in batches[2:]:
        js, jm = jstep(js, b, jax.random.PRNGKey(0))
        ts, tm = tstep(ts, np_batch(b))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    assert ts.step == int(js.step) == 4
    g_sd, d_sd = state_dicts(js)
    for mine, theirs in ((ts.g_params, g_sd), (ts.d_params, d_sd)):
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), atol=2e-5, err_msg=k)
    for opt, jopt in ((ts.g_opt, js.g_opt), (ts.d_opt, js.d_opt)):
        (adam,) = adam_states(jopt)
        assert opt.count == int(adam.count) == 4
        assert {v.dtype for v in opt.mu.values()} == {getattr(torch, moments)}


def test_carried_state_keeps_its_ema():
    """A JAX state with EMA on crosses with its g_ema, bit for bit."""
    jc = tiny_config(ema_decay=0.9)
    js = jax_init_state(jc, jax.random.PRNGKey(4))
    js, _ = jit_train_step(jc)(js, make_batch(jc), jax.random.PRNGKey(0))
    ts = train_state_from_jax(port_config(jc), np_tree(js), device="cpu")
    want = flax_to_state_dict(np_tree(js.g_ema))
    assert ts.g_ema.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(ts.g_ema[k], v), k
    assert train_state_from_jax(port_config(tiny_config()), np_tree(
        jax_init_state(tiny_config(), jax.random.PRNGKey(4))), device="cpu").g_ema is None


def test_carried_state_is_exact_and_checked():
    """Leaves cross bit for bit (bfloat16 moments by their bit pattern);
    moments in another dtype than the config's are refused."""
    jc = tiny_config(adam_moment_dtype="bfloat16")
    js = np_tree(jax_init_state(jc, jax.random.PRNGKey(2)))
    (adam,) = adam_states(js.g_opt)
    ts = train_state_from_jax(port_config(jc), js, device="cpu")
    want = np.asarray(adam.mu["enc_0"]["kernel"])
    assert ts.g_opt.mu["enc_0.kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.g_opt.mu["enc_0.kernel"].view(torch.int16).numpy(),
                                  want.view(np.int16))
    np.testing.assert_array_equal(ts.g_params["enc_0.kernel"].numpy(),
                                  np.asarray(js.g_params["enc_0"]["kernel"]))
    with pytest.raises(ValueError, match="adam_moment_dtype"):
        train_state_from_jax(port_config(tiny_config(adam_moment_dtype="float32")), js,
                             device="cpu")
