"""The port's data-parallel step (``parallel/``) against the JAX package's
``make_dp_train_step`` on a two-device CPU mesh, and DP serving.

Two ``gloo`` ranks on the CPU (tests/torch_dist_worker.py, one spawn for
every scenario) each take their rows of the batch, with the draws the JAX
step makes on that rank (its key folded with the step, then the rank's
``axis_index``). Scenarios: GroupNorm, batch norm (moments synced over the
ranks), scheduled sampling, ``disc_microbatch``, R1, ``remat_rollout``,
batch norm with R1 (the sync in a double backward) and with remat (the sync
again in the recompute), and ``train.flatten_optimizer`` (the flat gradient
averaged by one all-reduce in place). Two steps each, held to the JAX step at 1e-5
relative on the metrics and 2e-5 absolute on the parameters (the bars of
the port's single-device step against ``jit_train_step``), and to the
port's own step without a group on the whole batch at the reference's DP
bars (tests/test_parallel.py: 2e-4 relative on the losses, 5e-5 on the
parameters). The ranks end with one state, bit for bit, having issued the
same all-reduces in the same order.

Also the mesh record and the batch layout, the step's refusals, the
differentiable average, and ``Predictor`` / ``AotPredictor`` over a mesh
of devices against one device.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.config import MeshConfig as JaxMeshConfig
from action_conditioned_gans_tpu.parallel import make_dp_train_step as jax_dp_step
from action_conditioned_gans_tpu.parallel import make_mesh as jax_make_mesh
from action_conditioned_gans_tpu.parallel import shard_batch
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.parallel import comm
from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
from action_conditioned_gans_tpu_torch.parallel.mesh import Mesh, batch_slice, make_mesh, shard_rows
from action_conditioned_gans_tpu_torch.train.state import state_from_params
from action_conditioned_gans_tpu_torch.train.step import StepRandoms, draw_step_randoms, make_train_step
from tests.test_torch_train import (jax_randoms, np_batch, port_config, port_state,
                                   state_dicts)
from tests.test_train_step import make_batch, tiny_config
from tests.torch_dist_worker import run_ranks

torch.set_num_threads(1)
WORLD, BATCH, STEPS, SEED = 2, 4, 2, 5
SCENARIOS = {  # name: (train knobs, model knobs)
    "group_norm": ({}, {}),
    "batch_norm": (dict(rollout_length=3), dict(norm="batch")),
    "scheduled_sampling": (dict(scheduled_sampling=True, ss_start_prob=0.5, rollout_length=3),
                           dict(state_dim=3)),
    "disc_microbatch": (dict(rollout_length=4, disc_microbatch=3, log_grad_norms=True),
                        dict(state_dim=3)),
    "r1": (dict(r1_weight=7.0), {}),
    "remat": (dict(rollout_length=4, rollout_time_chunk=2, remat_rollout=True), {}),
    "r1_batch_norm": (dict(rollout_length=3, r1_weight=7.0), dict(norm="batch")),
    "remat_batch_norm": (dict(rollout_length=3, remat_rollout=True), dict(norm="batch")),
    "flatten_optimizer": (dict(flatten_optimizer=True, rollout_length=2, disc_microbatch=2,
                               grad_clip_norm=0.5, adam_moment_dtype="bfloat16",
                               log_grad_norms=True), {}),
}
DRAWS = ("scheduled_sampling",)  # whose draws depend on the rank


def jax_config(name, gn_backward="fused"):
    """The scenario's tiny config. ``gn_backward="fused"`` (the same gradient
    as "ad", a custom VJP) takes the JAX DP step off ``check_vma``, whose
    gradients are the devices' sum, W times the mean
    (:func:`test_the_jax_dp_step_sums_the_gradients_under_check_vma`); the
    port averages, as both JAX paths' contract says."""
    train_kw, model_kw = SCENARIOS[name]
    jc = tiny_config(batch_size=BATCH, **train_kw)
    return dataclasses.replace(jc, model=dataclasses.replace(jc.model, gn_backward=gn_backward,
                                                             **model_kw))


def reference_run(name, directory):
    """The JAX DP step on two devices from ``jax_init_state``; writes the
    port ranks' inputs (the converted state, the global batches, each
    rank's JAX draws) to ``<directory>/<name>.npz``. Returns the port's
    config, its initial state's arrays, the batches, and the JAX metrics
    per step and final parameters."""
    jc = jax_config(name)
    mesh = jax_make_mesh(JaxMeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    js = jax_init_state(jc, jax.random.PRNGKey(3))
    g_sd, d_sd = state_dicts(js)
    inputs = {"n_steps": np.asarray(STEPS)}
    inputs.update({f"g/{k}": v.numpy() for k, v in g_sd.items()})
    inputs.update({f"d/{k}": v.numpy() for k, v in d_sd.items()})
    step, rng = jax_dp_step(jc, mesh), jax.random.PRNGKey(SEED)
    batches, jax_metrics = [], []
    for i in range(STEPS):
        batch = np_batch(make_batch(jc, seed=20 + i))
        batches.append(batch)
        inputs.update({f"batch{i}/{k}": v for k, v in batch.items()})
        b, horizon = batch["actions"].shape[0] // WORLD, batch["actions"].shape[1]
        for r in range(WORLD):
            randoms = jax_randoms(jc, rng, i, b, horizon, rank=r)
            inputs.update({f"rank{r}/step{i}/{k}": v.numpy()
                           for k, v in dataclasses.asdict(randoms).items() if v is not None})
        js, jm = step(js, shard_batch(batch, mesh), rng)
        jax_metrics.append({k: float(v) for k, v in jm.items()})
    np.savez(os.path.join(directory, f"{name}.npz"), **inputs)
    g_final, d_final = state_dicts(js)
    return dict(cfg=port_config(jc), jc=jc, batches=batches, jax_metrics=jax_metrics,
                jax_params={"g_params": g_final, "d_params": d_final}, g_sd=g_sd, d_sd=d_sd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario: the JAX reference, the two ranks (one spawn), and the
    port's step without a group on the whole batch."""
    directory = tmp_path_factory.mktemp("dp")
    refs = {name: reference_run(name, str(directory)) for name in SCENARIOS}
    run_ranks({"mode": "steps", "dir": str(directory), "seed": SEED,
               "scenarios": {n: dataclasses.asdict(r["cfg"]) for n, r in refs.items()}},
              directory, world=WORLD, timeout=240)
    for name, ref in refs.items():
        ref["ranks"] = []
        for r in range(WORLD):
            with np.load(os.path.join(str(directory), f"{name}.rank{r}.npz")) as z:
                ref["ranks"].append({k: z[k] for k in z.files})
        if name not in DRAWS:
            state = state_from_params(ref["cfg"], ref["g_sd"], ref["d_sd"], device="cpu")
            step, metrics = make_train_step(ref["cfg"], device="cpu"), []
            for batch in ref["batches"]:
                state, m = step(state, batch, StepRandoms())
                metrics.append({k: float(v) for k, v in m.items()})
            ref["one_rank"] = dict(metrics=metrics, params={
                "g_params": state.g_params, "d_params": state.d_params})
    return refs


def rank_metrics(out, i):
    prefix = f"metrics/step{i}/"
    return {k[len(prefix):]: float(v) for k, v in out.items() if k.startswith(prefix)}


def rank_params(out, tree):
    return {k[len(tree) + 1:]: v for k, v in out.items() if k.startswith(tree + "/")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dp_step_matches_the_jax_dp_step(runs, name):
    """Two port ranks against ``make_dp_train_step`` on a two-device mesh:
    every metric of both steps within 1e-5 relative (1e-6 absolute near 0),
    the parameters after them within 2e-5. The JAX step runs with
    ``gn_backward="fused"`` (:func:`jax_config`)."""
    ref = runs[name]
    for out in ref["ranks"]:
        for i, want in enumerate(ref["jax_metrics"]):
            got = rank_metrics(out, i)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        for tree, theirs in ref["jax_params"].items():
            mine = rank_params(out, tree)
            assert mine.keys() == theirs.keys()
            for k in mine:
                np.testing.assert_allclose(mine[k], theirs[k].numpy(), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(set(SCENARIOS) - set(DRAWS)))
def test_dp_step_matches_one_rank_on_the_whole_batch(runs, name):
    """The two ranks' step equals the port's step without a group on the
    concatenated batch: losses within 2e-4 relative, parameters within 5e-5
    (tests/test_parallel.py's bars for the JAX DP step)."""
    ref = runs[name]
    for i, want in enumerate(ref["one_rank"]["metrics"]):
        got = rank_metrics(ref["ranks"][0], i)
        for k in {"d_loss", "g_loss", "g_adv", "g_recon", "d_r1", "g_grad_norm",
                  "d_grad_norm"} & set(want):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
    for tree, theirs in ref["one_rank"]["params"].items():
        mine = rank_params(ref["ranks"][0], tree)
        for k in mine:
            np.testing.assert_allclose(mine[k], theirs[k].numpy(), atol=5e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ranks_hold_one_state_and_issue_the_same_collectives(runs, name):
    """Both ranks end with the same parameters and first moments, bit for
    bit, report the same metrics, and issued the same all-reduces (sizes, in
    order) in each step: D's gradients, G's, the metrics, and one a
    batch-norm call (forward) and one a cotangent (backward)."""
    a, b = runs[name]["ranks"]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    d_n = sum(v.numel() for v in runs[name]["d_sd"].values())
    g_n = sum(v.numel() for v in runs[name]["g_sd"].values())
    for i in range(STEPS):
        sizes = list(a[f"all_reduce_sizes/step{i}"])
        assert d_n in sizes and g_n in sizes, sizes
        assert sizes.index(d_n) < sizes.index(g_n)
        assert sizes[-1] == len(rank_metrics(a, i)) - 1 - 2 * ("g_grad_norm" in rank_metrics(a, i))


def test_batch_norm_syncs_again_in_the_recompute_and_the_double_backward(runs):
    """With remat the generator's batch-norm moments are reduced again in the
    recompute: T time steps x G's batch-norm layers more all-reduces than
    the same step without remat. R1's inner D call reduces in its forward,
    in the input gradient's graph and in that graph's backward: more than
    without R1."""
    m = runs["batch_norm"]["cfg"].model
    g_bn = sum(1 for mod in Generator(m).modules() if getattr(mod, "norm", None) == "batch")
    horizon = runs["batch_norm"]["cfg"].train.rollout_length
    for i in range(STEPS):
        n = {k: len(runs[k]["ranks"][0][f"all_reduce_sizes/step{i}"])
             for k in ("batch_norm", "remat_batch_norm", "r1_batch_norm")}
        assert n["remat_batch_norm"] - n["batch_norm"] == horizon * g_bn, n
        assert n["r1_batch_norm"] > n["batch_norm"] + 2, n


def test_the_jax_dp_step_sums_the_gradients_under_check_vma(runs):
    """A fault of the reference, pinned (ROADMAP Queue 3): with
    ``gn_backward="ad"`` its DP step runs ``shard_map`` under ``check_vma``,
    where ``jax.grad`` with respect to the replicated parameters already
    sums the devices' cotangents and the ``pmean`` keeps that sum: the
    gradient norms it reports (and the gradients Adam takes) are W times
    those of the step on the whole batch. With ``"fused"`` they are the
    mean, the port's, to 1e-5."""
    jc = jax_config("disc_microbatch", gn_backward="ad")
    mesh = jax_make_mesh(JaxMeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    batch = np_batch(make_batch(jc, seed=20))
    _, jm = jax_dp_step(jc, mesh)(jax_init_state(jc, jax.random.PRNGKey(3)),
                                  shard_batch(batch, mesh), jax.random.PRNGKey(SEED))
    got = rank_metrics(runs["disc_microbatch"]["ranks"][0], 0)
    for k in ("g_grad_norm", "d_grad_norm"):
        np.testing.assert_allclose(float(jm[k]), WORLD * got[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(runs["disc_microbatch"]["jax_metrics"][0][k], got[k],
                                   rtol=1e-5, err_msg=k)


# -- the mesh, the batch layout, the step's refusals ---------------------------------------


def test_make_mesh_without_a_group_is_one_rank():
    mesh = make_mesh(tcfg.MeshConfig(), device="cpu")
    assert (mesh.rank, mesh.world, mesh.data, mesh.model, mesh.group) == (0, 1, 1, 1, None)
    assert make_mesh(tcfg.MeshConfig(data=1), device="cpu").data == 1
    with pytest.raises(ValueError, match="mesh data=2 needs a process group of 2 ranks"):
        make_mesh(tcfg.MeshConfig(data=2), device="cpu")
    with pytest.raises(ValueError, match="mesh data=1 x model=2 needs a process group of 2"):
        make_mesh(tcfg.MeshConfig(data=1, model=2), device="cpu")


@pytest.mark.parametrize("stacked", [False, True])
def test_batch_slice_takes_the_ranks_rows(stacked):
    """Rank r's rows [r*B/W, (r+1)*B/W) of the batch axis (axis 1 when
    stacked), as JAX's ``batch_pspec`` lays a batch over the data axis; the
    ranks' rows in order are the batch."""
    x = np.arange(2 * 6 * 3).reshape(2, 6, 3) if stacked else np.arange(6 * 3).reshape(6, 3)
    meshes = [Mesh(rank=r, world=3, data=3, model=1, device=torch.device("cpu")) for r in range(3)]
    parts = [batch_slice({"x": x}, m, stacked)["x"] for m in meshes]
    np.testing.assert_array_equal(np.concatenate(parts, axis=int(stacked)), x)
    np.testing.assert_array_equal(parts[1], x[:, 2:4] if stacked else x[2:4])
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        batch_slice({"x": x[:5] if not stacked else x[:, :5]}, meshes[0], stacked)
    assert shard_rows(8, 3, 4) == slice(6, 8)


def test_each_rank_draws_its_own_randoms():
    """Under a group the step's draws come from SeedSequence([seed, step],
    spawn_key=(rank,)), rank 0 included (the JAX step folds ``axis_index``
    in on every rank); without one from SeedSequence([seed, step]), as
    before."""
    cfg = port_config(jax_config("scheduled_sampling"))

    def mask(rank):
        return draw_step_randoms(cfg, 6, 1, 64, 3, "cpu", rank).use_pred

    none, zero, one = mask(None), mask(0), mask(1)
    assert not torch.equal(none, zero) and not torch.equal(zero, one)
    assert torch.equal(zero, mask(0)) and torch.equal(none, mask(None))


def test_dp_step_refuses_an_indivisible_batch_and_a_model_axis():
    """An indivisible batch is refused with or without a model axis; a model
    axis itself is taken (the dp x tp step, tests/test_torch_tp.py)."""
    cfg = port_config(tiny_config(batch_size=3))
    one = make_mesh(cfg.mesh, device="cpu")
    two = dataclasses.replace(one, world=2, data=2)
    with pytest.raises(ValueError, match="must be divisible by the data mesh axis"):
        make_dp_train_step(cfg, two)
    with pytest.raises(ValueError, match="must be divisible by the data mesh axis"):
        make_dp_train_step(cfg, dataclasses.replace(two, world=4, model=2))
    assert callable(make_dp_train_step(cfg, dataclasses.replace(one, world=2, model=2)))
    cfg = port_config(tiny_config(batch_size=4))
    step = make_dp_train_step(cfg, one)
    with pytest.raises(ValueError, match="got a batch of 2 clips"):
        step(None, {"actions": np.zeros((2, 1, 4), np.float32)})


def test_the_dp_step_without_a_group_is_the_step():
    """On one rank without a group the DP step is the single-device step,
    bit for bit (the loop takes this path on one device)."""
    jc = tiny_config(batch_size=2)
    js = jax_init_state(jc, jax.random.PRNGKey(0))
    batch = np_batch(make_batch(jc))
    cfg = port_config(jc)
    a, ma = make_train_step(cfg, device="cpu")(port_state(jc, js), batch)
    b, mb = make_dp_train_step(cfg, make_mesh(cfg.mesh, device="cpu"))(port_state(jc, js), batch)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for tree in ("g_params", "d_params"):
        for k, v in getattr(a, tree).items():
            assert torch.equal(v, getattr(b, tree)[k]), k


def test_mean_reduce_without_peers_is_the_identity():
    """One all-reduce over a world of one changes nothing (gloo, in-process)."""
    import torch.distributed as dist

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        xs = [torch.randn(3, 2), torch.randn(5)]
        want = [x.clone() for x in xs]
        comm.mean_reduce_(xs, dist.group.WORLD)
        for x, w in zip(xs, want):
            assert torch.equal(x, w)
        x = torch.randn(4, requires_grad=True)
        y = comm.all_reduce_mean(x * x, dist.group.WORLD)
        (g,) = torch.autograd.grad(y.sum(), x, create_graph=True)
        torch.testing.assert_close(g, 2 * x)
        (gg,) = torch.autograd.grad(g.sum(), x)
        torch.testing.assert_close(gg, torch.full_like(x, 2.0))
        assert comm.any_rank(True, dist.group.WORLD, torch.device("cpu"))
        assert not comm.any_rank(False, dist.group.WORLD, torch.device("cpu"))
        mesh = make_mesh(tcfg.MeshConfig(), device="cpu")
        assert (mesh.world, mesh.data, mesh.group) == (1, 1, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


# -- data-parallel serving -------------------------------------------------------------------


@pytest.fixture(scope="module", params=[0, 3], ids=["no_state", "state_dim3"])
def served(request, tmp_path_factory):
    """A tiny float32 generator's live Predictor and its AOT artifact
    (predict and a 3-step rollout), from seeded JAX init weights."""
    from tests.test_torch_aot import configs, jax_params

    from action_conditioned_gans_tpu_torch.aot import export_aot
    from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
    from action_conditioned_gans_tpu_torch.infer import Predictor

    jc, cfg = configs(request.param)
    params = jax_params(jc.model)
    path = str(tmp_path_factory.mktemp("aot") / "g.aot")
    export_aot(cfg, flax_to_state_dict(params), path, rollout_length=3, device="cpu")
    return request.param, Predictor(cfg, params, device="cpu"), path


@pytest.mark.parametrize("devices", [2, 4])
def test_predictors_over_a_mesh_serve_the_one_device_outputs(served, devices):
    """``Predictor(mesh=)`` / ``with_mesh`` and ``AotPredictor(mesh=)`` on a
    mesh of CPU devices: the batch split over the devices, the outputs
    gathered on the first, equal to the one-device predictor's (each
    sample's output is its own: bit for bit)."""
    from tests.test_torch_aot import inputs

    from action_conditioned_gans_tpu_torch.aot import AotPredictor

    state_dim, live, path = served
    mesh = ["cpu"] * devices
    frame, action, state = inputs(8, state_dim=state_dim, seed=1)
    frame0, actions, states = inputs(8, t=3, state_dim=state_dim, seed=2)
    one_aot, mesh_aot = AotPredictor(path, device="cpu"), AotPredictor(path, mesh=mesh)
    for one, sharded in ((live, live.with_mesh(mesh)), (one_aot, mesh_aot)):
        assert sharded.device == torch.device("cpu")
        got, want = sharded.predict(frame, action, state), one.predict(frame, action, state)
        assert got.shape == want.shape == (8, 16, 16, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got = sharded.rollout(frame0, actions, states)
        torch.testing.assert_close(got, one.rollout(frame0, actions, states), rtol=0, atol=0)
    with pytest.raises(ValueError, match="pad or resize the batch"):
        live.with_mesh(["cpu"] * 3).predict(frame, action, state)
    with pytest.raises(ValueError, match="pad or resize the batch"):
        mesh_aot.predict(*inputs(devices + 1, state_dim=state_dim))


# Batch-norm serving over a mesh: the port's meshes and the reference's (data, model) shapes.
BN_MESHES = {"dp2": (["cpu"] * 2, (2, 1)), "dp4": (["cpu"] * 4, (4, 1)),
             "2x2": ([["cpu", "cpu"], ["cpu", "cpu"]], (2, 2)), "aot_dp2": (["cpu"] * 2, (2, 1))}


@pytest.fixture(scope="module")
def bn_served(tmp_path_factory):
    """A tiny float32 batch-norm generator (state_dim 3) from seeded JAX init
    weights: the port's one-device Predictor, its AOT artifact (predict and
    a 3-step rollout), and the JAX config and weights."""
    from tests.test_torch_aot import TINY, jax_params

    from action_conditioned_gans_tpu import config as jcfg
    from action_conditioned_gans_tpu_torch.aot import export_aot
    from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
    from action_conditioned_gans_tpu_torch.infer import Predictor

    jc = jcfg.Config(name="tiny-bn", model=jcfg.ModelConfig(**TINY, state_dim=3, norm="batch"),
                     data=jcfg.DataConfig(seq_len=2), train=jcfg.TrainConfig(batch_size=2))
    cfg = tcfg.Config(model=tcfg.ModelConfig(**TINY, state_dim=3, norm="batch"))
    params = jax_params(jc.model, seed=4)
    path = str(tmp_path_factory.mktemp("aot_bn") / "g.aot")
    export_aot(cfg, flax_to_state_dict(params), path, rollout_length=3, device="cpu")
    return Predictor(cfg, params, device="cpu"), path, jc, params


@pytest.mark.parametrize("case", sorted(BN_MESHES))
def test_batch_norm_predictors_over_a_mesh_serve_the_whole_batch(bn_served, case):
    """Batch norm normalises with the whole batch's moments, so a predictor
    over a data mesh, a 2x2 grid or ``AotPredictor(mesh=)`` serves the batch
    whole on its first row: predict and a 3-step rollout within 1e-5 of the
    one-device predictor and of the reference's ``Predictor(mesh=)`` on a
    virtual CPU mesh of the same shape (whose GSPMD program takes the
    moments over the sharded batch)."""
    from tests.test_torch_aot import inputs

    from action_conditioned_gans_tpu.infer import Predictor as JaxPredictor
    from action_conditioned_gans_tpu_torch.aot import AotPredictor

    one, path, jc, params = bn_served
    mesh, (data, model) = BN_MESHES[case]
    served = AotPredictor(path, mesh=mesh) if case.startswith("aot") else one.with_mesh(mesh)
    ref = JaxPredictor(jc, params, mesh=jax_make_mesh(JaxMeshConfig(data=data, model=model),
                                                      devices=jax.devices()[:data * model]))
    predict_args = inputs(8, state_dim=3, seed=1)
    rollout_args = inputs(8, t=3, state_dim=3, seed=2)
    for call, args in (("predict", predict_args), ("rollout", rollout_args)):
        got = getattr(served, call)(*args)
        assert got.device == torch.device("cpu")
        torch.testing.assert_close(got, getattr(one, call)(*args), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, call)(*args)),
                                   rtol=0, atol=1e-5, err_msg=f"{case} {call}")


def test_shard_batches_splits_in_order_and_passes_none():
    from action_conditioned_gans_tpu_torch.infer import mesh_devices, shard_batches

    x = torch.arange(12.0).reshape(6, 2)
    parts = shard_batches([torch.device("cpu")] * 3, x, None)
    assert [p[1] for p in parts] == [None] * 3
    torch.testing.assert_close(torch.cat([p[0] for p in parts]), x)
    torch.testing.assert_close(parts[1][0], x[2:4])
    with pytest.raises(ValueError, match="not the mesh's first device"):
        mesh_devices(["cpu", "cpu"], "meta")
    with pytest.raises(ValueError, match="no device"):
        mesh_devices([], None)
