"""The port's channel tensor parallelism (``parallel/tp.py``, the JAX
package's ``parallel/gspmd.py``) on the CPU.

* (a) ``tp_param_spec`` against the JAX ``tp_param_pspec`` on every
  parameter of the five presets at model axes of 2 and 4.
* (b) ``shard_state`` / ``gather_state`` round trips, bit for bit, and
  ``convert.train_state_shard_from_jax`` into shards.
* (c) The port's dp1 x tp2 and dp2 x tp2 steps on ``gloo`` ranks
  (tests/torch_dist_worker.py, one spawn per world size for all the
  scenarios and ``train`` runs below) against the JAX
  ``make_gspmd_train_step`` on a (1, 2) and a (2, 2) mesh of the conftest's
  virtual CPU devices: the tiny config in float32 from carried weights,
  the global batch's JAX draws given through ``randoms=``, two steps;
  metrics within 1e-5 relative and parameters within 2e-5 (the bars of
  the port's knob tests against ``jit_train_step``). Scenarios: GroupNorm
  with aligned groups and with groups the axis does not divide, batch
  norm, R1, ``d_spectral_norm``, scheduled sampling with EMA and
  ``d_augment``, remat with ``disc_microbatch``, ``grad_clip_norm`` with
  ``log_grad_norms``.
* (d) The same ranks against the port's one-rank step on the whole batch
  (the reference's DP bars, tests/test_parallel.py), and the replicated
  parameters bit-equal across the ranks.
* (e) ``train`` on 2 and 4 ranks: rank 0 writes the one-rank checkpoint
  format; resume within the mesh bit for bit; across meshes (tp2 -> one
  rank, one rank -> tp2) the restored state is the checkpoint's, bit for
  bit; on a 2x2 mesh the ranks read file shards by data index.
* (f) ``Predictor`` over a (data, model) grid of CPU devices against the
  unmeshed predictor, directly and over HTTP.
* (g) Refusals: an indivisible batch, a world that data x model does not
  fill.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from action_conditioned_gans_tpu.config import MeshConfig as JaxMeshConfig
from action_conditioned_gans_tpu.parallel import make_mesh as jax_make_mesh
from action_conditioned_gans_tpu.parallel.gspmd import make_gspmd_train_step, tp_param_pspec
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import (
    train_state_from_jax,
    train_state_shard_from_jax,
)
from action_conditioned_gans_tpu_torch.infer import Predictor, mesh_grid
from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
from action_conditioned_gans_tpu_torch.parallel.mesh import Mesh, make_mesh
from action_conditioned_gans_tpu_torch.parallel.tp import (
    make_tp_train_step,
    shard_state,
    state_shardings,
    tp_param_spec,
)
from action_conditioned_gans_tpu_torch.serve import client_predict, client_rollout
from action_conditioned_gans_tpu_torch.train.loop import train
from action_conditioned_gans_tpu_torch.train.state import init_state, state_from_params
from action_conditioned_gans_tpu_torch.train.step import StepRandoms, make_train_step
from tests.test_torch_loop import loop_config, metric_lines, steps_on_disk
from tests.test_torch_native_tfrecord import write_files
from tests.test_torch_resume_data import file_config
from tests.test_torch_train import jax_randoms, np_batch, port_config, state_dicts
from tests.test_train_step import make_batch, tiny_config
from tests.torch_dist_worker import leaves, run_ranks

torch.set_num_threads(1)
BATCH, STEPS, SEED, MODEL = 4, 2, 5, 2
MESHES = {2: 1, 4: 2}  # world: data axis (the model axis is MODEL)
SCENARIOS = {  # name: (train knobs, model knobs)
    "group_norm": ({}, {}),
    "group_norm_ragged": ({}, dict(group_norm_groups=3, g_base_channels=6, d_base_channels=6)),
    "batch_norm": (dict(rollout_length=3), dict(norm="batch")),
    "r1": (dict(r1_weight=7.0), {}),
    "spectral_norm": ({}, dict(d_spectral_norm=True)),
    "ss_ema_augment": (dict(scheduled_sampling=True, ss_start_prob=0.5, rollout_length=3,
                            ema_decay=0.9, d_augment="color,translation,cutout"),
                       dict(state_dim=3)),
    "remat_microbatch": (dict(rollout_length=4, rollout_time_chunk=2, remat_rollout=True,
                              disc_microbatch=3), {}),
    "clip_norms": (dict(grad_clip_norm=0.05, log_grad_norms=True), {}),
}
DRAWS = ("ss_ema_augment",)  # whose draws the port's one-rank step would make otherwise


def jax_config(name):
    train_kw, model_kw = SCENARIOS[name]
    jc = tiny_config(batch_size=BATCH, **train_kw)
    return dataclasses.replace(jc, model=dataclasses.replace(jc.model, **model_kw))


def tp(cfg, data=-1, model=MODEL):
    return cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=data, model=model))


def reference_runs(name, directory):
    """The JAX GSPMD step on the (1, 2) and (2, 2) meshes from one carried
    state; writes the port ranks' inputs (the converted state, the global
    batches, the global batch's JAX draws) to ``<directory>/<name>.npz``."""
    jc = jax_config(name)
    g_sd, d_sd = state_dicts(jax_init_state(jc, jax.random.PRNGKey(3)))
    inputs = {"n_steps": np.asarray(STEPS)}
    inputs.update({f"g/{k}": v.numpy() for k, v in g_sd.items()})
    inputs.update({f"d/{k}": v.numpy() for k, v in d_sd.items()})
    rng, batches, randoms = jax.random.PRNGKey(SEED), [], []
    for i in range(STEPS):
        batch = np_batch(make_batch(jc, seed=20 + i))
        batches.append(batch)
        inputs.update({f"batch{i}/{k}": v for k, v in batch.items()})
        randoms.append(jax_randoms(jc, rng, i, BATCH, batch["actions"].shape[1]))
        inputs.update({f"step{i}/{k}": v.numpy()
                       for k, v in dataclasses.asdict(randoms[-1]).items() if v is not None})
    np.savez(os.path.join(directory, f"{name}.npz"), **inputs)
    out = dict(cfg=tp(port_config(jc)), batches=batches, randoms=randoms, g_sd=g_sd, d_sd=d_sd,
               jax={})
    for world, data in MESHES.items():
        mesh = jax_make_mesh(JaxMeshConfig(data=data, model=MODEL),
                             devices=jax.devices()[:world])
        js = jax_init_state(jc, jax.random.PRNGKey(3))
        step, metrics = make_gspmd_train_step(jc, mesh, js), []
        for batch in batches:
            js, jm = step(js, batch, rng)
            metrics.append({k: float(v) for k, v in jm.items()})
        g_final, d_final = state_dicts(js)
        out["jax"][world] = dict(metrics=metrics, params={"g_params": g_final,
                                                          "d_params": d_final})
    return out


def train_plan(root):
    """The ``train`` runs of each spawn: {world: [(name, config, steps, workdir)]}."""
    syn = tp(loop_config(root / "syn"), data=-1)
    syn = syn.replace(train=dataclasses.replace(syn.train, batch_size=4, steps_per_call=2,
                                                log_every=2, checkpoint_every=4, sample_every=4))
    files = file_config(root, "tfrecord_native", batch_size=4, log_every=2, checkpoint_every=4,
                        sample_every=0)
    return syn, files, {
        2: [("tp_whole", syn, 8, "whole"), ("tp_first", syn, 4, "resumed"),
            ("tp_resumed", syn, 8, "resumed"), ("tp_restore_one", syn, 4, "from_one"),
            ("tp_from_one", syn, 8, "from_one"), ("dp_files", tp(files, model=1), 8, "dp_files")],
        4: [("dp_tp_files", tp(files), 8, "dp_tp_files")]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario's JAX references; a one-rank 4-step run (the checkpoint
    a tp2 run resumes); then one spawn of 2 ranks and one of 4, each running
    the scenarios' steps and its ``train`` runs; and the port's one-rank
    step on the whole batch."""
    directory = tmp_path_factory.mktemp("tp")
    refs = {name: reference_runs(name, str(directory)) for name in SCENARIOS}
    write_files(directory, n=24, files=2)
    syn, files, plan = train_plan(directory)
    one_syn = tp(syn, data=1, model=1)
    train(one_syn, max_steps=4, workdir=str(directory / "from_one"), device="cpu")
    logs = {}
    for world in MESHES:
        jobs = [{"mode": "tp_steps", "dir": str(directory), "seed": SEED,
                 "scenarios": {n: dataclasses.asdict(r["cfg"]) for n, r in refs.items()}},
                {"mode": "train", "runs": [
                    dict(config=dataclasses.asdict(cfg), steps=steps,
                         workdir=str(directory / workdir), out=str(directory / name))
                    for name, cfg, steps, workdir in plan[world]]}]
        logs[world] = run_ranks({"jobs": jobs}, directory, world=world, timeout=240)
    for name, ref in refs.items():
        ref["ranks"] = {world: [dict(np.load(os.path.join(str(directory),
                                                          f"{name}.w{world}.rank{r}.npz")))
                                for r in range(world)] for world in MESHES}
        state = state_from_params(ref["cfg"], ref["g_sd"], ref["d_sd"], device="cpu")
        step, metrics = make_train_step(tp(ref["cfg"], data=1, model=1), device="cpu"), []
        for batch, randoms in zip(ref["batches"], ref["randoms"]):
            state, m = step(state, batch, randoms)
            metrics.append({k: float(v) for k, v in m.items()})
        ref["one_rank"] = dict(metrics=metrics, params={"g_params": state.g_params,
                                                        "d_params": state.d_params})
    trained = {name: [dict(np.load(str(directory / f"{name}.rank{r}.npz"))) for r in range(world)]
               for world, runs_ in plan.items() for name, *_ in runs_}
    return dict(refs=refs, dir=directory, syn=one_syn, files=files, trained=trained, logs=logs)


def rank_metrics(out, i):
    prefix = f"metrics/step{i}/"
    return {k[len(prefix):]: float(v) for k, v in out.items() if k.startswith(prefix)}


def rank_params(out, tree, prefix=""):
    head = f"{prefix}{tree}/"
    return {k[len(head):]: v for k, v in out.items() if k.startswith(head)}


# -- (a) the sharding rule ---------------------------------------------------------------------


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_tp_param_spec_is_the_jax_rule_on_every_preset_parameter(preset, model):
    """Every G and D parameter of the preset (shapes from the JAX init,
    abstract): the port's spec names the dimension the JAX
    ``tp_param_pspec`` shards over ``model``, or None where it replicates."""
    from action_conditioned_gans_tpu import config as jcfg

    jc = jcfg.get_preset(preset)
    shapes = jax.eval_shape(lambda: jax_init_state(jc, jax.random.PRNGKey(0)))
    n_sharded = 0
    for tree in ("g_params", "d_params"):
        flat = jax.tree_util.tree_flatten_with_path(getattr(shapes, tree))[0]
        for path, leaf in flat:
            spec = tp_param_pspec(leaf, "model", model)
            want = next((i for i, axis in enumerate(spec) if axis == "model"), None)
            if spec != P() and want is None:
                raise AssertionError(f"unexpected spec {spec}")
            assert tp_param_spec(leaf.shape, model) == want, (path, leaf.shape)
            n_sharded += want is not None
    assert n_sharded > 0


def test_state_shardings_follow_the_parameters():
    cfg = tcfg.get_preset("config1")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, ema_decay=0.99))
    with torch.device("meta"):
        state = init_state(cfg, device="meta")
    specs = state_shardings(state, 2)
    assert specs.step is None and specs.g_opt.count is None
    assert specs.g_params["enc_1.kernel"] == 3 and specs.g_params["enc_1.scale"] == 0
    assert specs.g_params["dec_0.kernel"] is None and specs.d_params["logit_kernel"] is None
    for tree in ("mu", "nu"):
        assert getattr(specs.g_opt, tree) == specs.g_params
        assert getattr(specs.d_opt, tree) == specs.d_params
    assert specs.g_ema == specs.g_params


# -- (b) round trips ---------------------------------------------------------------------------


def concat_shards(shards, specs):
    """The full tensors of per-index shards, concatenated along each spec."""
    return {k: shards[0][k] if dim is None else torch.cat([s[k] for s in shards], dim=dim)
            for k, dim in specs.items()}


@pytest.mark.parametrize("model", [2, 4])
def test_shard_state_concatenates_back_bit_for_bit(model):
    """The model axis's shards, concatenated along their specs, are the
    state, bit for bit (bfloat16 moments included); replicated tensors are
    copies, the same on every index."""
    cfg = port_config(tiny_config(batch_size=2, adam_moment_dtype="bfloat16", ema_decay=0.9))
    state = init_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    for t in ("g_opt", "d_opt"):
        for m in ("mu", "nu"):
            for v in getattr(getattr(state, t), m).values():
                v.copy_(torch.randn(v.shape))
    shards = [shard_state(state, i, model) for i in range(model)]
    specs = state_shardings(state, model)
    for tree in ("g_params", "d_params", "g_ema"):
        back = concat_shards([getattr(s, tree) for s in shards], getattr(specs, tree))
        for k, v in getattr(state, tree).items():
            assert torch.equal(back[k], v), k
    for tree in ("g_opt", "d_opt"):
        for m in ("mu", "nu"):
            back = concat_shards([getattr(getattr(s, tree), m) for s in shards],
                                 getattr(getattr(specs, tree), m))
            for k, v in getattr(getattr(state, tree), m).items():
                assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], v), k
    assert shards[0].g_params["dec_0.kernel"].data_ptr() != state.g_params["dec_0.kernel"].data_ptr()


def test_convert_carries_a_jax_state_into_shards():
    """``train_state_shard_from_jax`` is the converted state's shard: the
    shards of every index concatenate back to ``train_state_from_jax``'s
    state, bit for bit."""
    jc = tiny_config(batch_size=2, ema_decay=0.9)
    js = jax.tree_util.tree_map(np.asarray, jax_init_state(jc, jax.random.PRNGKey(3)))
    cfg = port_config(jc)
    whole = train_state_from_jax(cfg, js, device="cpu")
    shards = [train_state_shard_from_jax(cfg, js, i, MODEL, device="cpu") for i in range(MODEL)]
    specs = state_shardings(whole, MODEL)
    for tree in ("g_params", "d_params", "g_ema"):
        back = concat_shards([getattr(s, tree) for s in shards], getattr(specs, tree))
        for k, v in getattr(whole, tree).items():
            assert torch.equal(back[k], v), k
    assert shards[1].g_params["enc_1.kernel"].shape[-1] == whole.g_params["enc_1.kernel"].shape[-1] // 2


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gather_then_shard_is_the_identity(runs, name, world):
    """On every rank, after the steps: ``gather_state`` over the model group
    and ``shard_state`` again give the rank's state back bit for bit, with
    float32 and with bfloat16 moments."""
    for out in runs["refs"][name]["ranks"][world]:
        assert bool(out["round_trip/float32"]) and bool(out["round_trip/bfloat16"])


# -- (c) against the JAX GSPMD step, (d) against the one-rank step -----------------------------


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tp_step_matches_the_jax_gspmd_step(runs, name, world):
    """The port's ranks on a (data, 2) mesh against ``make_gspmd_train_step``
    on the same mesh of CPU devices: every metric of both steps within 1e-5
    relative (1e-6 absolute near 0) on every rank, the gathered parameters
    after them within 2e-5."""
    ref = runs["refs"][name]
    want = ref["jax"][world]
    for out in ref["ranks"][world]:
        for i, wm in enumerate(want["metrics"]):
            got = rank_metrics(out, i)
            assert sorted(got) == sorted(wm)
            for k in wm:
                np.testing.assert_allclose(got[k], wm[k], rtol=1e-5, atol=1e-6, err_msg=k)
        for tree, theirs in want["params"].items():
            mine = rank_params(out, tree)
            assert mine.keys() == theirs.keys()
            for k in mine:
                np.testing.assert_allclose(mine[k], theirs[k].numpy(), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tp_step_matches_the_one_rank_step(runs, name, world):
    """The ranks' step equals the port's step without a group on the whole
    batch with the same draws: losses within 2e-4 relative, parameters
    within 5e-5 (the reference's DP bars)."""
    ref = runs["refs"][name]
    out = ref["ranks"][world][0]
    for i, want in enumerate(ref["one_rank"]["metrics"]):
        got = rank_metrics(out, i)
        for k in {"d_loss", "g_loss", "g_adv", "g_recon", "d_r1", "g_grad_norm",
                  "d_grad_norm"} & set(want):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
    for tree, theirs in ref["one_rank"]["params"].items():
        mine = rank_params(out, tree)
        for k in mine:
            np.testing.assert_allclose(mine[k], theirs[k].numpy(), atol=5e-5, err_msg=k)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ranks_agree_bit_for_bit(runs, name, world):
    """Every rank holds the replicated parameters (and their first moments)
    bit-equal to every other rank's; the ranks of one model index hold one
    shard; all report the same metrics and gather the same state."""
    outs = runs["refs"][name]["ranks"][world]
    cfg = runs["refs"][name]["cfg"]
    n_rep = 0
    for r, out in enumerate(outs):
        same_shard = outs[r % MODEL]
        for k, v in out.items():
            if k.startswith("shard/"):
                tree = k.split("/")[1]
                key = k.split("/")[-1]
                full = outs[0][f"{'g' if tree.startswith('g') else 'd'}_params/{key}"]
                if tp_param_spec(full.shape, MODEL) is None:
                    np.testing.assert_array_equal(v, outs[0][k], err_msg=k)
                    n_rep += 1
                else:
                    np.testing.assert_array_equal(v, same_shard[k], err_msg=k)
            elif k.startswith(("metrics/", "g_params/", "d_params/")):
                np.testing.assert_array_equal(v, outs[0][k], err_msg=k)
    assert n_rep > 0 and cfg.mesh.model == MODEL


# -- (e) train on 2 and 4 ranks ---------------------------------------------------------------


def checkpoint(workdir, step):
    return torch.load(os.path.join(str(workdir), "checkpoints", str(step), "state.pt"))


def test_tp_train_writes_the_one_rank_checkpoint_format(runs):
    """Rank 0 of the tp2 run writes the gathered state in the one-rank
    format (the same keys, shapes and dtypes as a one-rank run's), which a
    one-rank ``Predictor.from_checkpoint`` serves; its parameters are the
    ranks' final shards, concatenated, bit for bit. Rank 0 alone prints."""
    root = runs["dir"]
    tp_tree, one_tree = checkpoint(root / "whole", 8), checkpoint(root / "from_one", 4)
    for key in ("g_params", "d_params"):
        assert {k: (v.shape, v.dtype) for k, v in tp_tree[key].items()} == {
            k: (v.shape, v.dtype) for k, v in one_tree[key].items()}
    for m in ("mu", "nu"):
        assert {k: v.shape for k, v in tp_tree["g_opt"][m].items()} == {
            k: v.shape for k, v in one_tree["g_opt"][m].items()}
    ranks = runs["trained"]["tp_whole"]
    assert [int(o["step"]) for o in ranks] == [8, 8]
    specs = {k: tp_param_spec(v.shape, MODEL) for k, v in tp_tree["g_params"].items()}
    for k, dim in specs.items():
        parts = [torch.from_numpy(o[f"g_params/{k}"]) for o in ranks]
        whole = parts[0] if dim is None else torch.cat(parts, dim=dim)
        assert torch.equal(whole, tp_tree["g_params"][k]), k
    served = Predictor.from_checkpoint(runs["syn"], str(root / "whole"), device="cpu")
    for k, v in served.generator.state_dict().items():
        assert torch.equal(v, tp_tree["g_params"][k]), k
    log = runs["logs"][2]
    assert "mesh data=1 model=2" in log[0] and "model-parallel mesh" in log[0]
    assert "[acgan]" not in log[1] and not metric_lines(log[1])


def test_tp_train_resumes_within_its_mesh_bit_for_bit(runs):
    """tp2: 4 steps, then resumed to 8, ends with the uninterrupted run's
    shards on both ranks and its checkpoint, bit for bit."""
    whole, resumed = runs["trained"]["tp_whole"], runs["trained"]["tp_resumed"]
    for a, b in zip(whole, resumed):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    root = runs["dir"]
    assert steps_on_disk(root / "resumed") == steps_on_disk(root / "whole") == [4, 8]
    a, b = checkpoint(root / "whole", 8), checkpoint(root / "resumed", 8)
    for tree in ("g_params", "d_params"):
        for k, v in a[tree].items():
            assert torch.equal(v, b[tree][k]), k


def test_resume_across_meshes(runs, tmp_path):
    """tp2 -> one rank: a one-rank ``train`` on the tp2 run's step-4
    checkpoint restores the tp2 ranks' state at step 4, concatenated, bit
    for bit, and trains on to 8 within 5e-5 of the tp2 run. One rank ->
    tp2: the tp2 ranks resuming a one-rank step-4 checkpoint hold its
    shards bit for bit, and reach step 8 within 5e-5 of the one-rank run."""
    root = runs["dir"]
    work = tmp_path / "tp_to_one"
    shutil.copytree(root / "resumed" / "checkpoints", work / "checkpoints")
    shutil.rmtree(work / "checkpoints" / "8")
    restored = train(runs["syn"], max_steps=4, workdir=str(work), device="cpu")
    first = runs["trained"]["tp_first"]
    for k, v in restored.g_params.items():
        dim = tp_param_spec(v.shape, MODEL)
        parts = [torch.from_numpy(o[f"g_params/{k}"]) for o in first]
        assert torch.equal(parts[0] if dim is None else torch.cat(parts, dim=dim), v), k
    on = train(runs["syn"], max_steps=8, workdir=str(work), device="cpu")
    tp8 = checkpoint(root / "whole", 8)
    for tree in ("g_params", "d_params"):
        for k, v in getattr(on, tree).items():
            np.testing.assert_allclose(v.numpy(), tp8[tree][k].numpy(), atol=5e-5, err_msg=k)

    one4 = checkpoint(root / "from_one", 4)
    for r, out in enumerate(runs["trained"]["tp_restore_one"]):
        assert int(out["step"]) == 4
        for k, v in one4["g_params"].items():
            dim = tp_param_spec(v.shape, MODEL)
            want = v if dim is None else v.chunk(MODEL, dim=dim)[r]
            assert torch.equal(torch.from_numpy(out[f"g_params/{k}"]), want), k
    one8 = train(runs["syn"], max_steps=8, workdir=str(tmp_path / "one8"), device="cpu")
    tp_from_one = checkpoint(root / "from_one", 8)
    for tree in ("g_params", "d_params"):
        for k, v in getattr(one8, tree).items():
            np.testing.assert_allclose(tp_from_one[tree][k].numpy(), v.numpy(), atol=5e-5,
                                       err_msg=k)


def test_dp_tp_ranks_read_file_shards_by_data_index(runs):
    """On a 2x2 mesh over two clip files, the ranks of data index d read file
    d: the run ends within 5e-5 of the dp2 run on the same files (each of
    its two ranks reads its file), and the ranks of a model group hold the
    same replicated parameters."""
    four, two = runs["trained"]["dp_tp_files"], runs["trained"]["dp_files"]
    assert [int(o["step"]) for o in four] == [8] * 4
    tree = checkpoint(runs["dir"] / "dp_tp_files", 8)
    for key in ("g_params", "d_params"):
        for k, v in tree[key].items():
            np.testing.assert_allclose(v.numpy(), two[0][f"{key}/{k}"], atol=5e-5, err_msg=k)
    for r in range(4):
        np.testing.assert_array_equal(four[r]["d_params/logit_kernel"],
                                      four[0]["d_params/logit_kernel"])
    lines = metric_lines(runs["logs"][4][0])
    assert lines and all(np.isfinite(v) for row in lines for v in row.values())


# -- (f) serving over a grid -------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    from tests.test_torch_aot import configs, jax_params

    jc, cfg = configs(3)
    return cfg, Predictor(cfg, jax_params(jc.model), device="cpu")


@pytest.mark.parametrize("grid", [[["cpu", "cpu"], ["cpu", "cpu"]], [["cpu", "cpu"]],
                                  [["cpu"] * 4]], ids=["2x2", "1x2", "1x4"])
def test_grid_predictor_serves_the_one_device_outputs(served, grid):
    """A Predictor over a (data, model) grid of CPU devices: predict and a
    3-step rollout within 1e-5 of the one-device predictor; its sharded
    layers hold each column's shard, its replicated ``dec_0`` whole."""
    from tests.test_torch_aot import inputs

    cfg, one = served
    p = one.with_mesh(grid)
    assert p.device == torch.device("cpu") and p.grid == [[torch.device(d) for d in r]
                                                          for r in grid]
    m = len(grid[0])
    assert p.generator.enc_1.kernel.shape[-1] == one.generator.enc_1.kernel.shape[-1] // m
    assert p.generator.dec_0.columns is None and len(p.generator.enc_1.columns) == m
    frame, action, state = inputs(8, state_dim=3, seed=1)
    frame0, actions, states = inputs(8, t=3, state_dim=3, seed=2)
    torch.testing.assert_close(p.predict(frame, action, state), one.predict(frame, action, state),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(p.rollout(frame0, actions, states),
                               one.rollout(frame0, actions, states), rtol=0, atol=1e-5)


def test_grid_predictor_serves_over_http(served):
    """serve x grid (the reference's tests/test_serve.py dp4 x tp2 case): a
    rollout and a predict through the HTTP server of a 4 x 2 grid Predictor
    equal the unmeshed predictor's within 1e-5."""
    from tests.test_torch_aot import inputs
    from tests.test_torch_serve import Served

    cfg, one = served
    live = Served(one.with_mesh([["cpu", "cpu"]] * 4))
    try:
        frame0, actions, states = inputs(4, t=3, state_dim=3, seed=5)
        np.testing.assert_allclose(client_rollout(live.url, frame0, actions, states),
                                   one.rollout(frame0, actions, states).numpy(), atol=1e-5)
        frame, action, state = inputs(4, state_dim=3, seed=6)
        np.testing.assert_allclose(client_predict(live.url, frame, action, state),
                                   one.predict(frame, action, state).numpy(), atol=1e-5)
    finally:
        live.close()


def test_mesh_grid_reads_axes_and_refuses_ragged_rows():
    assert mesh_grid(["cpu", "cpu"], None) == [[torch.device("cpu")]] * 2
    assert mesh_grid([("cpu", "cpu")], "cpu") == [[torch.device("cpu")] * 2]
    with pytest.raises(ValueError, match="rows of one length"):
        mesh_grid([["cpu", "cpu"], ["cpu"]], None)
    with pytest.raises(ValueError, match="not the mesh's first device"):
        mesh_grid([["cpu", "cpu"]], "meta")
    from action_conditioned_gans_tpu_torch.aot import AotPredictor

    with pytest.raises(ValueError, match="shards the batch only"):
        AotPredictor("unused.aot", mesh=[["cpu", "cpu"]])


# -- (g) refusals ----------------------------------------------------------------------------


def test_refusals():
    """A batch the data axis does not divide; a world that data x model does
    not fill; the TP step on a mesh without a model axis."""
    cfg = port_config(tiny_config(batch_size=3))
    mesh = Mesh(rank=0, world=4, data=2, model=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must be divisible by the data mesh axis"):
        make_tp_train_step(cfg, mesh)
    with pytest.raises(ValueError, match="must be divisible by the data mesh axis"):
        make_dp_train_step(cfg, mesh)
    with pytest.raises(ValueError, match="mesh data=1 x model=2 needs a process group of 2"):
        make_mesh(tcfg.MeshConfig(data=1, model=2), device="cpu")
    with pytest.raises(ValueError, match="mesh data=-1 x model=2 needs a multiple of 2 ranks"):
        make_mesh(tcfg.MeshConfig(data=-1, model=2), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh with a model axis"):
        make_tp_train_step(port_config(tiny_config(batch_size=2)),
                           Mesh(rank=0, world=1, data=1, model=1, device=torch.device("cpu")))
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    assert (dataclasses.replace(mesh, rank=3).data_index,
            dataclasses.replace(mesh, rank=3).model_index) == (1, 1)


def test_draws_under_tp_are_the_global_batch_rows():
    """With a model axis the step takes its data index's rows of the global
    batch's draws (given, or the one-rank draw)."""
    from action_conditioned_gans_tpu_torch.train.step import _rows, draw_step_randoms

    cfg = port_config(jax_config("ss_ema_augment"))
    whole = draw_step_randoms(cfg, 6, 1, 8, 3, "cpu")
    halves = [_rows(whole, i, 2) for i in range(2)]
    for k in ("use_pred", "u_real", "u_fake", "u_g"):
        assert torch.equal(torch.cat([getattr(h, k) for h in halves]), getattr(whole, k)), k
    assert halves[1].u_g.shape[0] == 4 * 3
    assert isinstance(halves[0], StepRandoms)
    assert len(list(leaves(init_state(cfg, device="cpu")))) > 0
