"""The port's standard-library PNG and GIF writers (``utils/images.py``)
against the JAX package's Pillow writers, decoded with Pillow (installed on
this machine; the port does not import it).

PNG grids and strips decode pixel for pixel to what the JAX package writes
from the same arrays. A GIF decodes to its frame count, size, duration and
loop, with pixels within one palette step of ``frames_to_uint8`` of the
input: exact for one channel, at most 26 per channel for RGB.
"""

import io

import numpy as np
import pytest
from PIL import Image

from action_conditioned_gans_tpu.utils import images as jimages
from action_conditioned_gans_tpu_torch.utils import images


def frames(seed, *shape):
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def decoded(path):
    with Image.open(path) as im:
        return np.asarray(im)


def test_frames_to_uint8_and_tile_grid_match_jax():
    x = frames(0, 5, 6, 7, 3)
    np.testing.assert_array_equal(images.frames_to_uint8(x), jimages.frames_to_uint8(x))
    u = images.frames_to_uint8(x)
    for cols in (1, 2, 8):
        np.testing.assert_array_equal(images.tile_grid(u, cols), jimages.tile_grid(u, cols))


@pytest.mark.parametrize("shape", [(4, 16, 16, 3), (3, 9, 7, 1), (1, 5, 4, 4), (10, 8, 8, 3)])
def test_image_grid_png_equals_jax(tmp_path, shape):
    x = frames(1, *shape)
    images.save_image_grid(str(tmp_path / "port.png"), x)
    jimages.save_image_grid(str(tmp_path / "jax.png"), x)
    np.testing.assert_array_equal(decoded(tmp_path / "port.png"), decoded(tmp_path / "jax.png"))


@pytest.mark.parametrize("channels", [1, 3])
def test_rollout_strip_png_equals_jax(tmp_path, channels):
    gt, pred = frames(2, 5, 12, 10, channels), frames(3, 5, 12, 10, channels)
    images.save_rollout_strip(str(tmp_path / "port.png"), gt, pred)
    jimages.save_rollout_strip(str(tmp_path / "jax.png"), gt, pred)
    np.testing.assert_array_equal(decoded(tmp_path / "port.png"), decoded(tmp_path / "jax.png"))


def test_png_refuses_what_it_cannot_write():
    with pytest.raises(ValueError):
        images.encode_png(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError):
        images.encode_png(np.zeros((4, 4, 3), np.float32))


@pytest.mark.parametrize("shape,fps", [((5, 16, 16, 3), 5), ((3, 9, 7, 1), 5), ((2, 20, 30, 3), 4)])
def test_gif_decodes_to_its_frames(tmp_path, shape, fps):
    x = frames(4, *shape)
    path = str(tmp_path / "clip.gif")
    images.save_gif(path, x, fps=fps)
    want = images.frames_to_uint8(x).astype(np.int64)
    with Image.open(path) as im:
        assert im.format == "GIF" and im.n_frames == shape[0]
        assert im.size == (shape[2], shape[1])
        assert im.info["duration"] == int(1000 / fps) and im.info["loop"] == 0
        for t in range(shape[0]):
            im.seek(t)
            got = np.asarray(im.convert("L" if shape[3] == 1 else "RGB")).astype(np.int64)
            err = np.abs(got.reshape(want[t].shape) - want[t]).max()
            assert err == 0 if shape[3] == 1 else err <= 26, (t, err)


def test_gif_matches_the_jax_writer_in_what_pillow_reads(tmp_path):
    """Frame count, size, duration and loop as the JAX package's GIF."""
    x = frames(5, 4, 16, 16, 3)
    images.save_gif(str(tmp_path / "port.gif"), x)
    jimages.save_gif(str(tmp_path / "jax.gif"), x)
    with Image.open(tmp_path / "port.gif") as a, Image.open(tmp_path / "jax.gif") as b:
        assert (a.n_frames, a.size, a.info["duration"], a.info["loop"]) == (
            b.n_frames, b.size, b.info["duration"], b.info["loop"])


@pytest.mark.parametrize("kind", ["noise", "runs", "flat"])
def test_lzw_round_trips_through_pillow(kind):
    """Past the 4096-code table (a clear code mid-stream) and through every
    code width: gray frames decode exactly."""
    rng = np.random.default_rng(6)
    if kind == "noise":
        x = rng.integers(0, 256, (2, 150, 140, 1))
    elif kind == "runs":
        x = np.repeat(rng.integers(0, 4, (2, 150, 7, 1)) * 60, 20, axis=2)
    else:
        x = np.full((2, 64, 64, 1), 77)
    data = images.encode_gif(x.astype(np.uint8), 200)
    with Image.open(io.BytesIO(data)) as im:
        for t in range(2):
            im.seek(t)
            np.testing.assert_array_equal(np.asarray(im.convert("L")), x[t, ..., 0])


def test_rgb_palette_holds_the_cube_and_grays():
    pal = images.gif_palette(3)
    assert pal.shape == (256, 3) and pal.dtype == np.uint8
    assert {tuple(v) for v in pal[:216]} == {(r, g, b) for r in range(0, 256, 51)
                                            for g in range(0, 256, 51) for b in range(0, 256, 51)}
    assert all(r == g == b for r, g, b in pal[216:])
    np.testing.assert_array_equal(images.gif_palette(1)[:, 0], np.arange(256))
