"""The port's TF-free TFRecord reader and writer (``data/native_tfrecord.py``)
and its PNG decoder (``utils/images.decode_png``) against the JAX package's
``data/native_tfrecord.py`` on the CPU: the same file bytes, and batches
bit for bit for the same files and seed."""

import hashlib
import io
import os
import struct
import sys
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.data import native_tfrecord as ref
from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt
from action_conditioned_gans_tpu_torch.data.pipeline import place_batch
from action_conditioned_gans_tpu_torch.utils.images import decode_png

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clip_arrays(n=6, t=6, hw=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, size=(n, t, hw, hw, 3), dtype=np.uint8),
            rng.randn(n, t, 4).astype(np.float32), rng.randn(n, t, 3).astype(np.float32))


def write_files(tmp_path, encoding="raw", n=12, t=6, hw=16, files=2, seed=0):
    """``files`` TFRecords of ``n`` clips in all, written by the JAX
    package's writer (the port's writes the same bytes)."""
    frames, actions, states = clip_arrays(n, t, hw, seed)
    per = n // files
    for i in range(files):
        sl = slice(i * per, (i + 1) * per)
        ref.write_clips_tfrecord_native(str(tmp_path / f"c{i}.tfrecord"), frames[sl],
                                        actions[sl], states[sl], encoding=encoding)
    return frames, actions, states


def png_with_filters(img: np.ndarray, filters) -> bytes:
    """PNG bytes of (H, W, C) uint8 with scanline y filtered by
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = b""
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    colour = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


def pil_decode(data: bytes) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(data)))
    return img[..., None] if img.ndim == 2 else img


def dir_state(path):
    return {n: (os.stat(os.path.join(path, n)).st_mtime_ns,
                hashlib.sha256(open(os.path.join(path, n), "rb").read()).hexdigest())
            for n in sorted(os.listdir(path))}


# -- the writer --------------------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["raw", "png"])
def test_writer_bytes_equal_the_reference(tmp_path, encoding):
    frames, actions, states = clip_arrays(n=3, t=4)
    floats = frames.astype(np.float32) / 127.5 - 1  # the float branch rounds back to these
    for name, fn in (("port", nt.write_clips_tfrecord_native),
                     ("ref", ref.write_clips_tfrecord_native)):
        fn(str(tmp_path / f"{name}.tfrecord"), frames, actions, states, encoding=encoding)
        fn(str(tmp_path / f"{name}_f.tfrecord"), floats, actions, states, encoding=encoding)
    for suffix in ("", "_f"):
        mine = (tmp_path / f"port{suffix}.tfrecord").read_bytes()
        assert mine == (tmp_path / f"ref{suffix}.tfrecord").read_bytes()
    assert (tmp_path / "port_f.tfrecord").read_bytes() == (tmp_path / "port.tfrecord").read_bytes()


def test_encode_example_equals_the_reference():
    feats = {"0/a/encoded": b"\x00\x01" * 300, "0/action": [0.5, -1.25, 3.0],
             "k": b"", "f": [1e-3] * 200}
    assert nt.encode_example(feats) == ref.encode_example(feats)


# -- the reader, bit for bit ------------------------------------------------------------

CASES = {
    "raw": dict(encoding="raw"),
    "raw-shuffle8": dict(encoding="raw", shuffle_buffer=8),
    "raw-crop-centre": dict(encoding="raw", crop=12),
    "raw-crop-random-shuffle8": dict(encoding="raw", crop=12, crop_random=True, shuffle_buffer=8),
    "raw-resize": dict(encoding="raw", image_size=8),
    "raw-crop-random-resize": dict(encoding="raw", crop=10, crop_random=True, image_size=12),
    "raw-threads3-shuffle8": dict(encoding="raw", decode_threads=3, shuffle_buffer=8),
    "auto-on-raw-threads3": dict(encoding="auto", decode_threads=3),
    "png-image": dict(encoding="image", files="png"),
    "png-auto-shuffle8": dict(encoding="auto", files="png", shuffle_buffer=8),
    "png-auto-threads3-crop-resize": dict(encoding="auto", files="png", decode_threads=3,
                                          crop=10, crop_random=True, image_size=12),
    "png-image-resume": dict(encoding="image", files="png", shuffle_buffer=8, start_batch=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_bit_identical_to_the_reference(tmp_path, case):
    kw = dict(CASES[case])
    files = kw.pop("files", "raw")
    threads = kw.pop("decode_threads", 0)
    write_files(tmp_path, "png" if files == "png" else "raw")
    common = dict(data_dir=str(tmp_path), batch=3, seq_len=3, image_size=16, clip_len=6,
                  raw_image_size=16, seed=5)
    common.update(kw)
    mine = nt.NativeTFRecordClips(**common, decode_threads=threads)
    theirs = ref.NativeTFRecordClips(**common, decode_threads=threads)
    for i in range(6):  # 18 clips of 12: the stream wraps
        a, b = mine.batch_at(i), theirs.batch_at(i)
        assert sorted(a) == sorted(b)
        for key in a:
            want = np.asarray(b[key])
            assert a[key].dtype == want.dtype and np.array_equal(a[key], want), (i, key)


def test_bfloat16_frames_equal_the_reference_cast(tmp_path):
    """Frames cast to bf16 on the host: the port's torch cast and the JAX
    package's ml_dtypes cast give the same bits."""
    write_files(tmp_path)
    common = dict(data_dir=str(tmp_path), batch=4, seq_len=3, image_size=12, clip_len=6,
                  raw_image_size=16, seed=1, shuffle_buffer=4)
    mine = nt.NativeTFRecordClips(**common, device="cpu", frames_dtype="bfloat16")
    theirs = ref.NativeTFRecordClips(**common, frames_dtype="bfloat16")
    for i in range(3):
        a, b = mine.batch_at(i), theirs.batch_at(i)
        assert a["frames"].dtype == torch.bfloat16 and b["frames"].dtype == ml_dtypes.bfloat16
        assert np.array_equal(a["frames"].view(torch.int16).numpy(),
                              np.asarray(b["frames"]).view(np.int16))
        for key in ("actions", "states"):
            assert a[key].dtype == torch.float32
            assert np.array_equal(a[key].numpy(), np.asarray(b[key]))
    host = place_batch({"frames": np.float32([[0.1, -0.3]])}, "cpu", "bfloat16")["frames"]
    assert not host.is_pinned()


def test_mixed_encoding_clip(tmp_path):
    """A clip whose frame 0 is raw and frame 1 PNG: "auto" decodes it as the
    JAX package does."""
    lib = nt.load_library()
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
    payload = nt.encode_example({
        "0/image_aux1/encoded": frames[0].tobytes(), "0/action": [0.0, 1.0, 2.0, 3.0],
        "0/endeffector_pos": [0.1, 0.2, 0.3],
        "1/image_aux1/encoded": nt._pillow_png(frames[1]), "1/action": [4.0, 5.0, 6.0, 7.0],
        "1/endeffector_pos": [0.4, 0.5, 0.6]})
    path = str(tmp_path / "mixed.tfrecord")
    w = lib.acgan_writer_open(path.encode())
    assert w and lib.acgan_writer_write(w, payload, len(payload)) == 0
    lib.acgan_writer_close(w)
    (mf, ma, ms), = list(nt.read_clips(path, 2, 16, 16, encoding="auto"))
    (rf, ra, rs), = list(ref.read_clips(path, 2, 16, 16, encoding="auto"))
    np.testing.assert_array_equal(mf, frames)
    for x, y in ((mf, rf), (ma, ra), (ms, rs)):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError, match="missing timestep 1"):
        list(nt.read_clips(path, 2, 16, 16, encoding="raw"))


def test_corrupt_crc_same_error_at_the_same_position(tmp_path):
    frames, actions, states = clip_arrays(n=5)
    path = str(tmp_path / "clips.tfrecord")
    nt.write_clips_tfrecord_native(path, frames, actions, states)
    raw = bytearray(open(path, "rb").read())
    raw[3 * len(raw) // 5 + 100] ^= 0xFF  # a payload byte of the fourth record
    open(path, "wb").write(bytes(raw))
    outcomes = []
    for mod in (nt, ref):
        got = []
        with pytest.raises(IOError) as err:
            for clip in mod.read_clips(path, 6, 16, 16):
                got.append(clip[0])
        outcomes.append((len(got), str(err.value)))
    assert outcomes[0] == outcomes[1] and outcomes[0][0] == 3, outcomes
    # The same position through the batch reader, serial and on 3 threads.
    for threads in (0, 3):
        reader = nt.NativeTFRecordClips(str(tmp_path), 1, 3, 16, clip_len=6, raw_image_size=16,
                                        repeat=False, decode_threads=threads)
        read = 0
        with pytest.raises(IOError, match="corrupt TFRecord framing"):
            while True:
                reader.batch_at(read)
                read += 1
        assert read == 3


def test_empty_shards(tmp_path):
    frames, actions, states = clip_arrays(n=1)
    nt.write_clips_tfrecord_native(str(tmp_path / "a.tfrecord"), frames, actions, states)
    for mod in (nt, ref):
        with pytest.raises(ValueError, match="empty TFRecord shard"):
            mod.NativeTFRecordClips(str(tmp_path), 1, 2, 16, clip_len=6, raw_image_size=16,
                                    host_id=1, num_hosts=2)
        with pytest.raises(FileNotFoundError, match="no TFRecord files match"):
            mod.NativeTFRecordClips(str(tmp_path / "none"), 1, 2, 16)
    # A file of no records: the same end of a non-repeating stream.
    empty = tmp_path / "empty"
    empty.mkdir()
    nt.write_clips_tfrecord_native(str(empty / "e.tfrecord"), frames[:0], actions[:0], states[:0])
    assert (empty / "e.tfrecord").read_bytes() == b""
    for mod in (nt, ref):
        assert list(mod.read_clips(str(empty / "e.tfrecord"), 6, 16, 16)) == []
        reader = mod.NativeTFRecordClips(str(empty), 1, 2, 16, clip_len=6, raw_image_size=16,
                                         repeat=False)
        with pytest.raises(StopIteration):
            reader.batch_at(0)


# -- decoders ------------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_decoder_against_pillow(channels, filters):
    rng = np.random.RandomState(channels * 10 + len(filters))
    img = rng.randint(0, 256, size=(9, 7, channels), dtype=np.uint8)
    img[:, 1:] = (img[:, :-1].astype(np.int64) + img[:, 1:] // 8) % 256  # correlated rows
    data = png_with_filters(img, filters)
    np.testing.assert_array_equal(pil_decode(data), img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decoder_reads_pillows_files(mode):
    """Pillow's own PNGs (adaptive filters, one IDAT) of each colour type."""
    from PIL import Image

    rng = np.random.RandomState(7)
    c = len(mode)
    img = np.cumsum(rng.randint(0, 40, size=(23, 31, c)), axis=1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if c == 1 else img, mode).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)


def test_png_decoder_refuses_what_it_does_not_decode():
    from PIL import Image

    rgb = Image.fromarray(np.arange(16 * 16 * 3, dtype=np.uint8).reshape(16, 16, 3))
    for img, what in ((rgb.convert("P", palette=Image.Palette.ADAPTIVE, colors=256),
                       "colour type 3"), (Image.new("LA", (4, 3)), "colour type 4"),
                      (Image.new("I;16", (4, 3)), "bit depth 16")):
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        with pytest.raises(ValueError, match=what):
            decode_png(buf.getvalue())
    data = bytearray(png_with_filters(np.zeros((2, 2, 3), np.uint8), (0,)))
    data[28] = 1  # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bytes(data))
    data = bytearray(png_with_filters(np.zeros((2, 2, 3), np.uint8), (0,)))
    data[20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_channel_conversion_is_pillows(channels):
    """A PNG of any decoded colour type, read at 1, 3 or 4 channels, as
    Pillow's convert gives it."""
    from PIL import Image

    rng = np.random.RandomState(channels)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    for c in (1, 3, 4):
        img = rng.randint(0, 256, size=(5, 6, c), dtype=np.uint8)
        data = png_with_filters(img, (0, 4))
        want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
        want = want[..., None] if channels == 1 else want
        np.testing.assert_array_equal(nt.decode_frame(data, channels), want)


def jpeg_file(tmp_path):
    from PIL import Image

    lib = nt.load_library()
    rng = np.random.RandomState(2)
    frames = np.cumsum(rng.randint(0, 30, size=(3, 24, 24, 3)), axis=2).astype(np.uint8)
    feats = {}
    for t in range(3):
        buf = io.BytesIO()
        Image.fromarray(frames[t]).save(buf, format="JPEG", quality=90)
        feats.update({f"{t}/image_aux1/encoded": buf.getvalue(), f"{t}/action": [t, 0, 0, 1.0],
                      f"{t}/endeffector_pos": [0.0, t, 0.5]})
    path = str(tmp_path / "jpeg.tfrecord")
    payload = nt.encode_example(feats)
    w = lib.acgan_writer_open(path.encode())
    assert w and lib.acgan_writer_write(w, payload, len(payload)) == 0
    lib.acgan_writer_close(w)
    return path


def test_jpeg_through_pillow_as_the_reference(tmp_path):
    path = jpeg_file(tmp_path)
    (mf, ma, _), = list(nt.read_clips(path, 3, 16, 16, encoding="auto"))
    (rf, ra, _), = list(ref.read_clips(path, 3, 16, 16, encoding="auto"))
    assert mf.shape == (3, 16, 16, 3)
    assert np.array_equal(mf, rf) and np.array_equal(ma, ra)


def test_jpeg_without_pillow_raises_naming_it(tmp_path, monkeypatch):
    path = jpeg_file(tmp_path)
    png = png_with_filters(np.zeros((16, 16, 3), np.uint8), (1,))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG frame needs Pillow"):
        list(nt.read_clips(path, 3, 16, 16, encoding="auto"))
    with pytest.raises(ImportError, match="GIF frame needs Pillow"):
        nt.decode_frame(b"GIF89a" + bytes(20), 3)
    # PNG needs no Pillow; an unknown payload is no image at all.
    assert nt.decode_frame(png, 3).shape == (16, 16, 3)
    with pytest.raises(ImportError, match="Pillow"):
        nt.decode_frame(b"\x00" * 40, 3)
    with pytest.raises(ImportError, match="Pillow"):
        nt._pillow_png(np.zeros((2, 2, 3), np.uint8))


# -- the build ---------------------------------------------------------------------------


def test_build_writes_only_under_its_build_dir(tmp_path, monkeypatch):
    """A fresh build of the C reader leaves ``native/`` (source and the
    prebuilt library) as it was and writes ``<build dir>/libacgan_tfrecord-
    <hash of the source>.so``; a library of another ABI is refused."""
    native = os.path.join(REPO, "native")
    before = dir_state(native)
    monkeypatch.setattr(nt, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(nt, "_lib", None)
    path = nt.build_library()
    digest = hashlib.sha256(open(nt.SOURCE, "rb").read()).hexdigest()[:12]
    assert path == str(tmp_path / "native" / f"libacgan_tfrecord-{digest}.so")
    assert os.listdir(tmp_path / "native") == [os.path.basename(path)]
    lib = nt.load_library()
    assert nt._lib_abi(lib) == nt._EXPECTED_ABI == 2
    assert dir_state(native) == before
    monkeypatch.setattr(nt, "_lib", None)
    monkeypatch.setattr(nt, "_lib_abi", lambda lib: 3)
    with pytest.raises(RuntimeError, match="ABI version 3"):
        nt.load_library()


def test_file_pattern_and_resize_are_the_reference():
    for d in ("/data/bair", "/data/bair/*.tfrecord", "/data/x?", "/d/[ab]*"):
        assert nt.tfrecord_file_pattern(d) == ref.tfrecord_file_pattern(d)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 13, 9, 3).astype(np.float32)
    for out, out_w in ((16, None), (7, 5), (13, 9), (8, 20)):
        assert np.array_equal(nt.bilinear_resize(x, out, out_w), ref.bilinear_resize(x, out, out_w))
