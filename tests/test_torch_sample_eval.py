"""``train/sample.py``'s ``sample`` and ``evaluate`` against the JAX
package's, on the CPU.

On one numpy batch with weights carried from JAX, the port's fully
autoregressive rollout plus ``eval_metrics`` gives the reference's
``make_rollout_fn`` plus ``eval_metrics`` within 1e-4 relative on each metric
(float32). ``sample`` writes the reference's files, and each PNG equals, pixel
for pixel, the one the JAX package's ``utils/images.py`` writes from the same
arrays. The metric cases are tests/test_sample_eval.py's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train import sample as jsample
from action_conditioned_gans_tpu.utils import images as jimages
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import train_state_from_jax
from action_conditioned_gans_tpu_torch.train import sample as tsample
from action_conditioned_gans_tpu_torch.train.state import init_state

torch.set_num_threads(1)
TINY = dict(image_size=16, g_levels=2, g_base_channels=8, d_levels=2, d_base_channels=8,
            group_norm_groups=4, compute_dtype="float32")


def configs(state_dim=0, rollout_length=2):
    j = jcfg.Config(name="tiny-sample", model=jcfg.ModelConfig(**TINY, state_dim=state_dim),
                    train=jcfg.TrainConfig(batch_size=2, rollout_length=rollout_length))
    return j, tcfg.config_from_dict(dataclasses.asdict(j))


def port_state(cfg):
    return init_state(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("state_dim", [0, 3])
def test_rollout_metrics_match_jax(state_dim):
    jc, tc = configs(state_dim, rollout_length=3)
    jstate = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jax_init_state(jc, jax.random.PRNGKey(0))))
    state = train_state_from_jax(tc, jstate, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"frames": np.tanh(rng.standard_normal((3, 4, 16, 16, 3))).astype(np.float32),
             "actions": rng.standard_normal((3, 3, 4)).astype(np.float32)}
    if state_dim:
        batch["states"] = rng.standard_normal((3, 3, state_dim)).astype(np.float32)
    want_preds = jsample.make_rollout_fn(jc)(
        jstate.g_params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = jsample.eval_metrics(want_preds, batch["frames"][:, 1:])
    preds = tsample.make_rollout_fn(tc, "cpu")(
        state.g_params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_preds), atol=1e-3, rtol=1e-3)
    got = tsample.eval_metrics(preds, torch.from_numpy(batch["frames"][:, 1:]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_sample_writes_the_reference_files(tmp_path):
    """The port's file set is the JAX package's; each PNG is the one the
    JAX writers make from the port's arrays; the metrics are those arrays'."""
    jc, tc = configs()
    jsample.sample(jc, jax_init_state(jc, jax.random.PRNGKey(0)), str(tmp_path / "jax"),
                   num_clips=5, horizon=2)
    state = port_state(tc)
    got = tsample.sample(tc, state, str(tmp_path / "port"), num_clips=5, horizon=2)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 2 + 2 * 4

    batch = next(tsample.held_out_batches(tc, 5, 2, 1234, device="cpu"))
    preds = tsample.make_rollout_fn(tc, "cpu")(state.g_params, batch).numpy()
    targets = batch["frames"][:, 1:].numpy()
    ref = tmp_path / "ref"
    jimages.save_image_grid(str(ref / "pred_final_frame.png"), preds[:, -1])
    jimages.save_image_grid(str(ref / "gt_final_frame.png"), targets[:, -1])
    for i in range(4):
        jimages.save_rollout_strip(str(ref / f"strip_{i}.png"), targets[i], preds[i])
    for name in os.listdir(ref):
        with Image.open(ref / name) as a, Image.open(tmp_path / "port" / name) as b:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
    for i in range(4):
        with Image.open(tmp_path / "port" / f"rollout_{i}.gif") as im:
            assert im.n_frames == 2 and im.size == (16, 16)
    assert got == tsample.eval_metrics(preds, targets)


def test_evaluate_synthetic_averages_the_batches():
    jc, tc = configs()
    state = port_state(tc)
    m = tsample.evaluate(tc, state, num_batches=2, batch_size=2, horizon=2)
    assert m["eval_batches"] == 2 and m["eval_horizon"] == 2
    assert set(m) == {"eval_l2", "eval_l1", "eval_psnr", "eval_ssim", "eval_batches",
                      "eval_horizon"}
    assert np.isfinite(m["eval_psnr"])
    fn, stream = tsample.make_rollout_fn(tc, "cpu"), tsample.held_out_batches(tc, 2, 2, 1234,
                                                                              device="cpu")
    each = [tsample.eval_metrics(fn(state.g_params, b), b["frames"][:, 1:])
            for b in (next(stream), next(stream))]
    for k in ("eval_l2", "eval_l1", "eval_psnr", "eval_ssim"):
        np.testing.assert_allclose(m[k], sum(e[k] / 2 for e in each), rtol=1e-12)
    # The rollout length of the config is the default horizon.
    assert tsample.evaluate(tc, state, num_batches=1, batch_size=2)["eval_horizon"] == 2


# -- the metric cases of tests/test_sample_eval.py ------------------------------------


def test_eval_metrics_perfect_prediction():
    x = np.clip(np.random.RandomState(0).randn(2, 3, 16, 16, 3), -1, 1).astype(np.float32)
    m = tsample.eval_metrics(x, x)
    assert m["eval_l2"] == 0.0 and m["eval_l1"] == 0.0
    assert m["eval_psnr"] > 100
    assert m["eval_ssim"] > 0.99


def test_eval_metrics_worse_prediction_scores_worse():
    rng = np.random.RandomState(0)
    t = np.clip(rng.randn(2, 3, 16, 16, 3), -1, 1).astype(np.float32)
    near = np.clip(t + 0.05 * rng.randn(*t.shape), -1, 1).astype(np.float32)
    far = np.clip(t + 0.5 * rng.randn(*t.shape), -1, 1).astype(np.float32)
    m_near, m_far = tsample.eval_metrics(near, t), tsample.eval_metrics(far, t)
    assert m_near["eval_psnr"] > m_far["eval_psnr"]
    assert m_near["eval_ssim"] > m_far["eval_ssim"]


def test_ssim_matches_direct_windowed_computation():
    """The separable SSIM equals a direct loop over 11x11 Gaussian windows."""
    rng = np.random.RandomState(3)
    p = np.clip(rng.randn(18, 18, 1), -1, 1).astype(np.float32)
    t = np.clip(p + 0.2 * rng.randn(18, 18, 1), -1, 1).astype(np.float32)
    win, sigma = 11, 1.5
    r = np.arange(win) - (win - 1) / 2.0
    g1 = np.exp(-(r**2) / (2 * sigma**2))
    g2 = np.outer(g1, g1)
    g2 = g2 / g2.sum()
    c1, c2 = (0.01 * 2) ** 2, (0.03 * 2) ** 2
    vals = []
    for i in range(18 - win + 1):
        for j in range(18 - win + 1):
            pw = p[i:i + win, j:j + win, 0].astype(np.float64)
            tw = t[i:i + win, j:j + win, 0].astype(np.float64)
            mp, mt = (g2 * pw).sum(), (g2 * tw).sum()
            vp = (g2 * pw * pw).sum() - mp**2
            vt = (g2 * tw * tw).sum() - mt**2
            cov = (g2 * pw * tw).sum() - mp * mt
            vals.append(((2 * mp * mt + c1) * (2 * cov + c2))
                        / ((mp**2 + mt**2 + c1) * (vp + vt + c2)))
    assert abs(tsample._ssim(p, t) - np.mean(vals)) < 1e-9


def test_ssim_constant_shift_analytic():
    a, c = 0.2, 0.3
    p = np.full((1, 32, 32, 3), a, np.float32)
    t = np.full((1, 32, 32, 3), a + c, np.float32)
    c1 = (0.01 * 2) ** 2
    expected = (2 * a * (a + c) + c1) / (a**2 + (a + c) ** 2 + c1)
    assert abs(tsample._ssim(p, t) - expected) < 1e-6


def test_ssim_tiny_image_degrades_gracefully():
    x = np.clip(np.random.RandomState(0).randn(1, 8, 8, 3), -1, 1).astype(np.float32)
    assert tsample._ssim(x, x) > 0.999
