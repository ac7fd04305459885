"""The port's synthetic clips (``data/synthetic.py``, ``data/pipeline.py``)
against the JAX package's, on the CPU.

The JAX stream draws from threefry, the port's from a ``torch.Generator``,
so the two streams cannot agree clip for clip. What can:

* the physics and the render, exactly: the five random arrays of each clip
  are drawn with JAX, with ``_single_clip``'s key splits reproduced here,
  and fed through the port's ``render_clips``;
* the streams, statistically: the five statistics of
  ``tests/test_golden.py``, over 256 clips of each stream, within 4
  standard errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.data import generate_clips as jax_generate_clips
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.data import SyntheticClips, generate_clips, make_dataset
from action_conditioned_gans_tpu_torch.data.synthetic import batch_seed, draw_clip_randoms, render_clips

torch.set_num_threads(1)
MARGIN = 0.08  # the JAX package's synthetic._MARGIN


def jax_clip_randoms(key, n, seq_len, action_dim):
    """The random arrays of ``jax_generate_clips(key, n, ...)``: the key
    splits of its vmap and of ``_single_clip``, in the same order."""

    def one(k):
        k_bg, k_obj, k_pos, k_act = jax.random.split(k, 4)
        k_grad, k_base = jax.random.split(k_bg)
        return dict(
            g=jax.random.uniform(k_grad, (2, 3), minval=0.0, maxval=0.35),
            base=jax.random.uniform(k_base, (3,), minval=0.15, maxval=0.45),
            obj_color=jax.random.uniform(k_obj, (3,), minval=0.3, maxval=1.0),
            positions=jax.random.uniform(k_pos, (2, 2), minval=2 * MARGIN, maxval=1 - 2 * MARGIN),
            noise=jax.random.normal(k_act, (seq_len - 1, action_dim)) * 0.6,
        )

    return jax.vmap(one)(jax.random.split(key, n))


@pytest.mark.parametrize("action_dim", [4, 3, 2])
def test_render_matches_jax_on_the_same_randoms(action_dim):
    """Frames, actions and states within 1e-5 abs; with A < 4 the push
    strength is 1, with A < 3 the grip is 0."""
    key = jax.random.PRNGKey(5 + action_dim)
    randoms = {k: torch.from_numpy(np.array(v))
               for k, v in jax_clip_randoms(key, 4, 6, action_dim).items()}
    got = render_clips(randoms, 6, 32, action_dim)
    want = jax_generate_clips(key, 4, 6, 32, action_dim)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)
    # The clips move: the object is carried in some clip, the pusher in all.
    assert float(got["frames"].amax()) <= 1.0 and float(got["frames"].amin()) >= -1.0
    assert float((got["states"][:, 1:, :2] - got["states"][:, :-1, :2]).abs().amax()) > 0


def test_randoms_have_their_shapes_and_ranges():
    r = draw_clip_randoms(torch.Generator().manual_seed(0), 64, 5, 4)
    shapes = dict(g=(64, 2, 3), base=(64, 3), obj_color=(64, 3), positions=(64, 2, 2),
                  noise=(64, 4, 4))
    for k, shape in shapes.items():
        assert tuple(r[k].shape) == shape and r[k].dtype == torch.float32, k
    for k, lo, hi in (("g", 0.0, 0.35), ("base", 0.15, 0.45), ("obj_color", 0.3, 1.0),
                      ("positions", 2 * MARGIN, 1 - 2 * MARGIN)):
        assert lo <= float(r[k].amin()) and float(r[k].amax()) < hi, k
    assert 0.4 < float(r["noise"].std()) < 0.8  # N(0, 1) * 0.6


def clip_summaries(frames, actions, states):
    """Per-clip sufficient statistics of test_golden.py's five statistics:
    frame mean and mean square, action mean and mean |a|, state mean."""
    f = frames.reshape(frames.shape[0], -1).astype(np.float64)
    a = actions.reshape(actions.shape[0], -1).astype(np.float64)
    s = states.reshape(states.shape[0], -1).astype(np.float64)
    return dict(m1=f.mean(1), m2=(f * f).mean(1), a_mean=a.mean(1), a_abs=np.abs(a).mean(1),
                s_mean=s.mean(1))


def statistics_and_errors(c):
    """The five statistics over all clips and their standard errors, from
    the per-clip spread. Every clip has as many values as the next, so the
    mean-type statistics are means of per-clip values (error std / sqrt(n));
    f_std = sqrt(mean m2 - mean m1^2) takes the delta method's per-clip
    influence."""
    n = len(c["m1"])
    m1, m2 = c["m1"].mean(), c["m2"].mean()
    f_std = np.sqrt(m2 - m1**2)
    influence = -(m1 / f_std) * (c["m1"] - m1) + (c["m2"] - m2) / (2 * f_std)
    se = lambda x: x.std(ddof=1) / np.sqrt(n)  # noqa: E731
    return dict(
        f_mean=(m1, se(c["m1"])),
        f_std=(f_std, se(influence)),
        a_mean=(c["a_mean"].mean(), se(c["a_mean"])),
        a_absmean=(c["a_abs"].mean(), se(c["a_abs"])),
        s_mean=(c["s_mean"].mean(), se(c["s_mean"])),
    )


def test_stream_statistics_match_the_jax_stream():
    """256 clips (T 6, 32 px) of each stream: the five statistics agree
    within 4 standard errors of their difference. test_golden.py's 2e-3 bar
    pins 4 fixed clips of one stream against recorded values; two different
    streams of 256 clips differ by their sampling error, which this bar
    measures."""
    b = jax_generate_clips(jax.random.PRNGKey(42), 256, 6, 32, 4)
    theirs = statistics_and_errors(clip_summaries(*(np.asarray(b[k]) for k in
                                                    ("frames", "actions", "states"))))
    ours = SyntheticClips(256, 6, 32, seed=42, device="cpu").batch_at(0)
    mine = statistics_and_errors(clip_summaries(*(ours[k].numpy() for k in
                                                  ("frames", "actions", "states"))))
    for k, (want, se_w) in theirs.items():
        got, se_g = mine[k]
        bound = 4 * np.hypot(se_w, se_g)
        assert abs(got - want) <= bound, f"{k}: port {got:.5f} JAX {want:.5f}, 4 SE {bound:.5f}"


def test_batch_at_is_a_pure_function_of_seed_and_index():
    ds = SyntheticClips(3, 4, 16, seed=7, device="cpu")
    later_first = [ds.batch_at(i) for i in (5, 2)]
    fresh = SyntheticClips(3, 4, 16, seed=7, device="cpu")
    in_order = [fresh.batch_at(i) for i in (2, 5)]
    for a, b in zip(later_first, in_order[::-1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert not torch.equal(in_order[0]["frames"], in_order[1]["frames"])
    other_seed = SyntheticClips(3, 4, 16, seed=8, device="cpu").batch_at(2)
    assert not torch.equal(other_seed["frames"], in_order[0]["frames"])
    assert batch_seed(7, 2) != batch_seed(7, 5) != batch_seed(8, 5)
    first = next(iter(fresh))
    assert torch.equal(first["actions"], fresh.batch_at(0)["actions"])


def test_stack_dtype_and_device():
    plain = SyntheticClips(2, 3, 16, action_dim=4, seed=1, stack=3, device="cpu").batch_at(4)
    assert tuple(plain["frames"].shape) == (3, 2, 3, 16, 16, 3)
    assert tuple(plain["actions"].shape) == (3, 2, 2, 4)
    assert tuple(plain["states"].shape) == (3, 2, 2, 3)
    # stack=k is k*B clips of one call, reshaped.
    flat = generate_clips(torch.Generator().manual_seed(batch_seed(1, 4)), 6, 3, 16, 4)
    assert torch.equal(plain["frames"].reshape(flat["frames"].shape), flat["frames"])
    bf16 = SyntheticClips(2, 3, 16, seed=1, stack=3, frames_dtype="bfloat16",
                          with_state=False, device="cpu").batch_at(4)
    assert bf16["frames"].dtype == torch.bfloat16 and "states" not in bf16
    assert torch.equal(bf16["frames"], plain["frames"].to(torch.bfloat16))
    assert bf16["actions"].dtype == torch.float32
    for v in (*plain.values(), *bf16.values()):
        assert v.device.type == "cpu"
    with pytest.raises(ValueError, match="frames_dtype"):
        SyntheticClips(2, 3, 16, frames_dtype="float16", device="cpu")


def test_stream_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticClips(2, 3, 16)


def port_config(**train):
    cfg = tcfg.get_preset("config2")
    return cfg.replace(train=dataclasses.replace(cfg.train, **train),
                       data=dataclasses.replace(cfg.data, device_dtype="bfloat16"))


def test_make_dataset_synthetic_branch():
    cfg = port_config(batch_size=2, rollout_length=3, seed=11)
    ds = make_dataset(cfg, stack=2, start_call=5, device="cpu")
    assert (ds.batch, ds.seq_len, ds.image_size, ds.action_dim, ds.seed, ds.stack) == (
        2, 4, 64, 4, 11, 2)
    assert ds.frames_dtype == torch.bfloat16 and ds.with_state
    # start_call does not shift the index-addressed stream.
    same = make_dataset(cfg, stack=2, device="cpu")
    assert torch.equal(ds.batch_at(1)["actions"], same.batch_at(1)["actions"])


@pytest.mark.parametrize("source", ["tfrecord", "tfrecord_native"])
def test_file_sources_are_refused(source, tmp_path):
    """A file source without files, or with a batch its hosts cannot share,
    is refused (the JAX package's errors); with files it is a reader behind
    a Prefetcher, also per host (tests/test_torch_resume_data.py)."""
    cfg = port_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, source=source))
    with pytest.raises(ValueError, match="data_dir"):
        make_dataset(cfg, device="cpu")
    empty = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=str(tmp_path)))
    with pytest.raises(FileNotFoundError, match="no TFRecord files match"):
        make_dataset(empty, device="cpu")
    with pytest.raises(FileNotFoundError, match="no TFRecord files match"):
        make_dataset(empty, device="cpu", host_id=1, num_hosts=2)
    with pytest.raises(ValueError, match=f"batch_size={cfg.train.batch_size} must be divisible "
                                         "by num_hosts=3 for file sources"):
        make_dataset(empty, device="cpu", num_hosts=3)


@pytest.mark.parametrize("stack", [1, 3])
def test_synthetic_hosts_take_their_rows_of_the_one_host_batch(stack):
    """Host r of W gets rows [r*B/W, (r+1)*B/W) of each step's batch of the
    one-host stream, bit for bit (each renders only its clips); the JAX
    package makes the global batch and shards it the same way."""
    cfg = port_config(batch_size=4, rollout_length=2, seed=3)
    one = make_dataset(cfg, stack=stack, device="cpu").batch_at(5)
    parts = [make_dataset(cfg, stack=stack, device="cpu", host_id=r, num_hosts=2).batch_at(5)
             for r in range(2)]
    axis = int(stack > 1)
    for key, whole in one.items():
        assert parts[0][key].shape[axis] == 2
        assert torch.equal(torch.cat([p[key] for p in parts], dim=axis), whole), key
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        make_dataset(cfg, device="cpu", num_hosts=3)


def test_unknown_source_raises():
    cfg = port_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, source="parquet"))
    with pytest.raises(ValueError, match="unknown data source"):
        make_dataset(cfg, device="cpu")


def test_frames_match_jax_golden_layout():
    """The port's clip dict has the JAX package's keys, shapes and dtypes."""
    want = jax_generate_clips(jax.random.PRNGKey(0), 2, 3, 16, 4)
    got = SyntheticClips(2, 3, 16, seed=0, device="cpu").batch_at(0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[1] == jnp.dtype(want[k].dtype).name, k
