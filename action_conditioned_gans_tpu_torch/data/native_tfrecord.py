"""TensorFlow-free TFRecord clips over the repo's C library (port of the JAX
package's ``data/native_tfrecord.py``).

``native/tfrecord_io.cc`` does the record framing, CRC32C and the
``tf.train.Example`` parse; numpy does the window, crop, resize and
normalisation. ``source="tfrecord_native"`` selects this reader. Batches are
the unified clip dict: ``frames`` (B, T, H, W, C) in [-1, 1], ``actions``
and ``states``, on the host as float32 numpy arrays, or placed on a device
by ``data.pipeline.place_batch``. For the same files and seed they are the
JAX package's, bit for bit.

The library is compiled on first use with ``g++`` into
``build/native/libacgan_tfrecord-<hash>.so`` at the root of the checkout, the
hash being that of the C source, and loaded with ctypes; ``native/`` is only
read. Frames stored as raw RGB24 need no decoder. PNG frames decode in
``utils/images.decode_png``; other image formats need Pillow, and where it
is missing a record that holds one raises an ImportError that names it.

Also a pure-Python ``tf.train.Example`` encoder, so that data can be written
without TensorFlow (``write_clips_tfrecord_native``, ``make-data``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import struct
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from action_conditioned_gans_tpu_torch.data.cropping import crop_offsets
from action_conditioned_gans_tpu_torch.utils.images import PNG_SIGNATURE, decode_png

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "tfrecord_io.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# The binary contract this binding targets: the library's acgan_abi_version().
_EXPECTED_ABI = 2
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_abi(lib: ctypes.CDLL) -> int:
    try:
        f = lib.acgan_abi_version
    except AttributeError:
        return 1  # the first builds exported no version symbol
    f.restype = ctypes.c_int
    f.argtypes = []
    return int(f())


def library_path() -> str:
    """Where the library of the current C source is built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libacgan_tfrecord-{digest}.so")


def build_library() -> str:
    """Compile ``native/tfrecord_io.cc`` unless its library is built;
    returns the library's path. Raises with the compiler's output."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SOURCE} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The loaded library, built on first use; its ABI version must be the
    one this binding declares."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            if _lib_abi(lib) != _EXPECTED_ABI:
                raise RuntimeError(f"{SOURCE} builds ABI version {_lib_abi(lib)}, but this "
                                   f"binding needs {_EXPECTED_ABI}")
            _lib = declare_api(lib)
        return _lib


def declare_api(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare restype / argtypes of every C entry point on ``lib``."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.acgan_reader_open.restype = ctypes.c_void_p
    lib.acgan_reader_open.argtypes = [ctypes.c_char_p]
    lib.acgan_reader_next.restype = ctypes.c_long
    lib.acgan_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p)]
    lib.acgan_reader_close.argtypes = [ctypes.c_void_p]
    lib.acgan_writer_open.restype = ctypes.c_void_p
    lib.acgan_writer_open.argtypes = [ctypes.c_char_p]
    lib.acgan_writer_write.restype = ctypes.c_int
    lib.acgan_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.acgan_writer_close.argtypes = [ctypes.c_void_p]
    lib.acgan_get_bytes.restype = ctypes.c_int
    lib.acgan_get_bytes.argtypes = [u8p, ctypes.c_uint64, ctypes.c_char_p, ctypes.POINTER(u8p),
                                    ctypes.POINTER(ctypes.c_uint64)]
    lib.acgan_parse_clip_floats.restype = ctypes.c_int
    lib.acgan_parse_clip_floats.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int, f32p,
                                            ctypes.c_int, f32p, ctypes.c_int]
    lib.acgan_parse_clip.restype = ctypes.c_int
    lib.acgan_parse_clip.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_uint64, u8p, f32p, ctypes.c_int, f32p, ctypes.c_int]
    return lib


# -- the tf.train.Example encoder (write side) --------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _bytes_feature(value: bytes) -> bytes:
    return _len_delim(1, _len_delim(1, value))  # Feature{bytes_list{value}}


def _float_feature(values) -> bytes:
    packed = struct.pack(f"<{len(values)}f", *values)
    return _len_delim(2, _len_delim(1, packed))  # Feature{float_list{packed}}


def encode_example(features: Dict[str, object]) -> bytes:
    """features: key -> bytes (a BytesList) or a sequence of floats (a
    FloatList) -> a serialised ``tf.train.Example``."""
    entries = b""
    for key, val in features.items():
        feat = (_bytes_feature(val) if isinstance(val, (bytes, bytearray))
                else _float_feature(list(val)))
        entries += _len_delim(1, _len_delim(1, key.encode()) + _len_delim(2, feat))
    return _len_delim(1, entries)  # Example{features{...}}


def _pillow_png(img: np.ndarray) -> bytes:
    """PNG bytes of (H, W, C) uint8 as Pillow's ``save(format="PNG")`` writes
    them (the JAX package's writer stores these)."""
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("encoding='png' writes Pillow's PNG bytes and needs Pillow, which "
                          "is not installed; write encoding='raw'") from e
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def write_clips_tfrecord_native(path: str, frames: np.ndarray, actions: np.ndarray,
                                states: np.ndarray, image_key: str = "image_aux1",
                                encoding: str = "raw") -> None:
    """Clips in the BAIR schema (``{t}/{image_key}/encoded``, ``{t}/action``,
    ``{t}/endeffector_pos``), one record a clip, without TensorFlow.

    ``frames`` (N, T, H, W, 3) uint8, or floats in [-1, 1] rounded to uint8.
    ``encoding`` "raw" stores RGB24 bytes; "png" stores Pillow's PNG of each
    frame (the JAX package's writer, byte for byte; Pillow is needed)."""
    if encoding not in ("raw", "png"):
        raise ValueError(f"unknown encoding {encoding!r}")
    lib = load_library()
    if frames.dtype != np.uint8:
        frames = np.round((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)
    payload_of = (lambda img: img.tobytes()) if encoding == "raw" else _pillow_png
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    w = lib.acgan_writer_open(path.encode())
    if not w:
        raise OSError(f"cannot open {path}")
    try:
        for n in range(frames.shape[0]):
            feats: Dict[str, object] = {}
            for t in range(frames.shape[1]):
                feats[f"{t}/{image_key}/encoded"] = payload_of(frames[n, t])
                feats[f"{t}/action"] = actions[n, t].tolist()
                feats[f"{t}/endeffector_pos"] = states[n, t].tolist()
            payload = encode_example(feats)
            if lib.acgan_writer_write(w, payload, len(payload)) != 0:
                raise OSError(f"short write to {path}")
    finally:
        lib.acgan_writer_close(w)


# -- the reader ---------------------------------------------------------------------------


def tfrecord_file_pattern(data_dir: str) -> str:
    """The one glob rule of the file sources (both readers and ``doctor``):
    a path with a glob character in its last component is used as it is;
    any other is a directory of ``*.tfrecord*`` files."""
    if any(ch in os.path.basename(data_dir) for ch in "*?["):
        return data_dir
    return os.path.join(data_dir, "*.tfrecord*")


def bilinear_resize(frames_f: np.ndarray, out: int, out_w: Optional[int] = None) -> np.ndarray:
    """Separable bilinear resize of (T, H, W, C) float frames to (out,
    ``out_w`` or out), as ``tf.image.resize`` does by default (half-pixel
    centres, no antialiasing), each axis on its own grid."""
    out_w = out if out_w is None else out_w
    in_h, in_w = frames_f.shape[1], frames_f.shape[2]
    if (in_h, in_w) == (out, out_w):
        return frames_f

    def grid(in_sz, out_sz):
        src = (np.arange(out_sz, dtype=np.float64) + 0.5) * (in_sz / out_sz) - 0.5
        lo = np.floor(src).astype(np.int64)
        frac = (src - lo).astype(frames_f.dtype)
        return np.clip(lo, 0, in_sz - 1), np.clip(lo + 1, 0, in_sz - 1), frac

    lo_r, hi_r, fr_r = grid(in_h, out)
    lo_c, hi_c, fr_c = grid(in_w, out_w)
    a = (frames_f[:, lo_r] * (1 - fr_r)[None, :, None, None]
         + frames_f[:, hi_r] * fr_r[None, :, None, None])
    return (a[:, :, lo_c] * (1 - fr_c)[None, None, :, None]
            + a[:, :, hi_c] * fr_c[None, None, :, None])


# Signatures of the image formats Pillow reads that are not PNG.
_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
            (b"MM\x00*", "TIFF"))


def _image_format(buf: bytes) -> Optional[str]:
    if buf.startswith(PNG_SIGNATURE):
        return "PNG"
    if buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        return "WEBP"
    return next((name for sig, name in _FORMATS if buf.startswith(sig)), None)


def _to_channels(img: np.ndarray, channels: int) -> np.ndarray:
    """(H, W, 1|3|4) uint8 as Pillow's ``convert`` to L / RGB / RGBA gives
    it: gray repeated, alpha dropped or set to 255, RGB to L by ITU-R 601-2
    luma in Pillow's fixed point."""
    have = img.shape[-1]
    if have == channels:
        return img
    rgb = np.repeat(img, 3, axis=-1) if have == 1 else img[..., :3]
    if channels == 3:
        return rgb
    if channels == 4:
        return np.concatenate([rgb, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    if have == 1:
        return img
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)[..., None]


def decode_frame(buf: bytes, channels: int) -> np.ndarray:
    """One compressed frame -> (h, w, ``channels``) uint8 at its stored
    size: PNG by ``decode_png``; the other formats by Pillow."""
    fmt = _image_format(buf)
    if fmt == "PNG":
        return _to_channels(decode_png(buf), channels)
    try:
        from PIL import Image
    except ImportError as e:
        what = f"a {fmt} frame" if fmt else "a frame in no format the port decodes itself (PNG)"
        raise ImportError(f"{what} needs Pillow, which is not installed; store frames raw "
                          "(RGB24) or as PNG to read them without it") from e
    import io

    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    img = np.asarray(Image.open(io.BytesIO(buf)).convert(mode), np.uint8)
    return img[..., None] if channels == 1 else img


def _decode_frames(lib, path, data, n, n_steps, image_key, height, width,
                   channels) -> np.ndarray:
    """Each timestep's frame bytes (``acgan_get_bytes``), decoded and resized
    to the stored grid as the tf.data reader does (bilinear, rounded to
    nearest); a frame of exactly H*W*C bytes is raw."""
    if channels not in (1, 3, 4):
        raise ValueError(f"compressed frames support channels in (1, 3, 4); got {channels}")
    frames = np.empty((n_steps, height, width, channels), np.uint8)
    raw_bytes = height * width * channels
    for t in range(n_steps):
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        if lib.acgan_get_bytes(data, n, f"{t}/{image_key}/encoded".encode(), ctypes.byref(ptr),
                               ctypes.byref(ln)) != 0:
            raise ValueError(f"record missing timestep {t} image feature")
        buf = ctypes.string_at(ptr, ln.value)
        if len(buf) == raw_bytes:  # a raw frame in a mixed-encoding clip
            frames[t] = np.frombuffer(buf, np.uint8).reshape(height, width, channels)
            continue
        try:
            img = decode_frame(buf, channels)
        except (OSError, ValueError) as e:  # Pillow's UnidentifiedImageError is an OSError
            raise ValueError(f"record in {path}: frame payload is neither {raw_bytes}-byte "
                             f"raw RGB24 nor a decodable image ({e})") from e
        if img.shape[:2] != (height, width):
            img = np.clip(np.round(bilinear_resize(img[None].astype(np.float32), height,
                                                   width)[0]), 0, 255).astype(np.uint8)
        frames[t] = img
    return frames


def iter_record_buffers(lib, path: str):
    """(data pointer, byte count) of each framed record of ``path``. A
    pointer is valid only until the next iteration: parse or copy at once.
    The resume skim walks records with this and decodes none."""
    r = lib.acgan_reader_open(path.encode())
    if not r:
        raise FileNotFoundError(path)
    try:
        while True:
            data = ctypes.POINTER(ctypes.c_uint8)()
            n = lib.acgan_reader_next(r, ctypes.byref(data))
            if n == 0:
                return
            if n < 0:
                raise IOError(f"corrupt TFRecord framing in {path}")
            yield data, n
    finally:
        lib.acgan_reader_close(r)


def parse_clip_record(lib, path: str, data, n: int, n_steps: int, height: int, width: int,
                      action_dim: int = 4, state_dim: int = 3, image_key: str = "image_aux1",
                      channels: int = 3, encoding: str = "auto"):
    """One record -> (frames uint8 (T, H, W, C), actions (T, A), states
    (T, S)). ``encoding`` "raw" needs H*W*C-byte frames (one C pass);
    "image" decodes every frame; "auto" takes the raw pass and decodes a
    record whose frames are not raw. ``path`` is for messages only."""
    frame_bytes = height * width * channels
    f32p = ctypes.POINTER(ctypes.c_float)
    if encoding in ("raw", "auto"):
        frames = np.empty((n_steps, height, width, channels), np.uint8)
        actions = np.empty((n_steps, action_dim), np.float32)
        states = np.empty((n_steps, max(state_dim, 1)), np.float32)
        rc = lib.acgan_parse_clip(data, n, n_steps, image_key.encode(), frame_bytes,
                                  frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                  actions.ctypes.data_as(f32p), action_dim,
                                  states.ctypes.data_as(f32p), state_dim)
        if rc == 0:
            return frames, actions, states[:, :state_dim]
        t_bad = -rc - 1
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        found = lib.acgan_get_bytes(data, n, f"0/{image_key}/encoded".encode(),
                                    ctypes.byref(ptr), ctypes.byref(ln))
        stored = int(ln.value) if found == 0 else None
        if encoding == "raw" or stored is None:
            # "raw" is strict; with no frame at timestep 0 nothing can decode.
            hint = (f" (stored frame is {stored} bytes, expected {frame_bytes} raw RGB24 — "
                    "compressed frames need encoding='auto' or 'image')"
                    if stored is not None and stored != frame_bytes else "")
            raise ValueError(f"record in {path} missing timestep {t_bad} "
                             f"(schema/shape mismatch){hint}")
        # "auto" with frame bytes present: compressed or mixed frames.
    frames = _decode_frames(lib, path, data, n, n_steps, image_key, height, width, channels)
    actions = np.empty((n_steps, action_dim), np.float32)
    states = np.empty((n_steps, max(state_dim, 1)), np.float32)
    rc = lib.acgan_parse_clip_floats(data, n, n_steps, actions.ctypes.data_as(f32p), action_dim,
                                     states.ctypes.data_as(f32p), state_dim)
    if rc != 0:
        raise ValueError(f"record in {path} missing timestep {-rc - 1} action/state")
    return frames, actions, states[:, :state_dim]


def read_clips(path: str, n_steps: int, height: int, width: int, action_dim: int = 4,
               state_dim: int = 3, image_key: str = "image_aux1", channels: int = 3,
               encoding: str = "auto"):
    """(frames uint8 (T, H, W, C), actions (T, A), states (T, S)) of each
    record of ``path``, in file order (``parse_clip_record``)."""
    lib = load_library()
    for data, n in iter_record_buffers(lib, path):
        yield parse_clip_record(lib, path, data, n, n_steps, height, width, action_dim,
                                state_dim, image_key, channels, encoding)


def shard_files(data_dir: str, host_id: int = 0, num_hosts: int = 1):
    """The sorted files of ``data_dir`` (``tfrecord_file_pattern``) that host
    ``host_id`` of ``num_hosts`` reads; raises where none match or the
    host's share is empty."""
    if not data_dir:
        raise ValueError("file sources need data.data_dir")
    pattern = tfrecord_file_pattern(data_dir)
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no TFRecord files match {pattern}")
    mine = files[host_id::num_hosts]
    if not mine:
        # A repeating reader over no file would spin forever.
        raise ValueError(f"host {host_id} of {num_hosts} gets an empty TFRecord shard: only "
                         f"{len(files)} file(s) match {pattern}; provide at least num_hosts "
                         "files (or a shared pattern per host)")
    return mine


class NativeTFRecordClips:
    """Clip batches from BAIR-schema TFRecords without TensorFlow.

    ``batch_at(i)`` is stream-ordered (``i`` is ignored). A seeded buffer
    shuffle (``shuffle_buffer`` > 1, tf.data's ``shuffle`` in kind), one
    window start a clip from ``RandomState(seed)``, crops keyed on the
    clip's stream position. ``start_batch`` fast-forwards a resumed stream
    to where the uninterrupted one stood, decoding only the clips still in
    the shuffle buffer there. ``decode_threads`` > 1 parses on a thread pool
    in stream order (the C parse and the decoders release the GIL), with
    batches identical to the serial reader's.

    Batches are float32 numpy arrays on the host when ``device`` is None,
    else tensors on ``device`` with frames in ``frames_dtype``
    (``data.pipeline.place_batch``).
    """

    def __init__(self, data_dir: str, batch: int, seq_len: int, image_size: int,
                 action_dim: int = 4, state_dim: int = 3, clip_len: int = 30,
                 image_key: str = "image_aux1", encoding: str = "auto",
                 raw_image_size: int = 64, crop: int = 0, crop_random: bool = False,
                 shuffle_buffer: int = 0, seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 repeat: bool = True, device=None, start_batch: int = 0,
                 frames_dtype: str = "float32", decode_threads: int = 0):
        self._files = shard_files(data_dir, host_id, num_hosts)
        if crop and not 0 < crop <= raw_image_size:
            raise ValueError(f"crop={crop} must be in [1, raw_image_size={raw_image_size}]")
        self.batch, self.seq_len, self.image_size = batch, seq_len, image_size
        self.action_dim, self.state_dim, self.clip_len = action_dim, state_dim, clip_len
        self.image_key, self.encoding, self.raw_image_size = image_key, encoding, raw_image_size
        self.crop, self.crop_random, self.seed = crop, crop_random, seed
        self.repeat, self.shuffle_buffer = repeat, shuffle_buffer
        self._rng = np.random.RandomState(seed)
        # The shuffle draws from a stream of their own, so that the window
        # starts are those of the unshuffled reader with the same seed.
        self._shuffle_rng = np.random.RandomState(seed + 1)
        self.device, self.frames_dtype = device, frames_dtype
        self.start_batch, self.decode_threads = start_batch, decode_threads
        self._clip_index = 0  # the stream position of the next clip (keys its crop)
        self._gen = None

    def _raw_records(self):
        """(path, data pointer, byte count) of each record of the shard; a
        pointer is valid only until the next iteration."""
        lib = load_library()
        while True:
            for f in self._files:
                for data, n in iter_record_buffers(lib, f):
                    yield f, data, n
            if not self.repeat:
                return

    def _parse(self, path, data, n):
        return parse_clip_record(load_library(), path, data, n, self.clip_len,
                                 self.raw_image_size, self.raw_image_size, self.action_dim,
                                 self.state_dim, self.image_key, encoding=self.encoding)

    @staticmethod
    def _next_raw(raw):
        try:
            return next(raw)
        except StopIteration:
            raise ValueError("resume fast-forward ran past the end of a non-repeating "
                             "dataset (start_batch exceeds the data)") from None

    def _records(self):
        """Parsed clips in shuffled order: a buffer of ``shuffle_buffer``
        clips, one drawn and replaced by the next of the stream at a time.

        The resume skip decodes nothing it drops: the buffer's positions are
        simulated with the shuffle draws first, then one walk over the
        consumed records parses only those still in the buffer."""
        raw = self._raw_records()
        skip = self.start_batch * self.batch
        if self.shuffle_buffer <= 1:
            for _ in range(skip):
                self._next_raw(raw)  # framing only, no parse
            yield from self._parse_stream(raw)
            return
        buf = []
        if skip:
            pos, buf_pos, emitted = 0, [], 0
            while emitted < skip:
                if len(buf_pos) < self.shuffle_buffer:
                    buf_pos.append(pos)
                else:
                    buf_pos[self._shuffle_rng.randint(len(buf_pos))] = pos
                    emitted += 1
                pos += 1
            survivors, parsed = set(buf_pos), {}
            for p in range(pos):
                path, data, n = self._next_raw(raw)
                if p in survivors:
                    parsed[p] = self._parse(path, data, n)
            buf = [parsed[p] for p in buf_pos]
        for item in self._parse_stream(raw):
            if len(buf) < self.shuffle_buffer:
                buf.append(item)
                continue
            j = self._shuffle_rng.randint(len(buf))
            out, buf[j] = buf[j], item
            yield out
        while buf:  # repeat=False: the rest, still shuffled
            yield buf.pop(self._shuffle_rng.randint(len(buf)))

    def _parse_stream(self, raw):
        """Parsed clips in the raw stream's order. With ``decode_threads`` >
        1, an ordered map on a pool with a lookahead of twice the threads:
        each record's bytes are copied out of the reader's window first
        (its pointer dies at the next record); a framing error surfaces
        after the clips before it, as in the serial reader."""
        if self.decode_threads <= 1:
            for path, data, n in raw:
                yield self._parse(path, data, n)
            return
        import collections
        from concurrent.futures import ThreadPoolExecutor

        lookahead = 2 * self.decode_threads
        with ThreadPoolExecutor(self.decode_threads) as pool:
            pending = collections.deque()
            it = iter(raw)
            while True:
                try:
                    path, data, n = next(it)
                except StopIteration:
                    break
                except Exception:
                    while pending:
                        yield pending.popleft().result()
                    raise
                src = ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8 * n))
                buf = (ctypes.c_uint8 * n).from_buffer_copy(src.contents)
                pending.append(pool.submit(self._parse, path, buf, n))
                if len(pending) >= lookahead:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def _window_start(self) -> int:
        max_start = self.clip_len - self.seq_len
        return self._rng.randint(0, max_start + 1) if max_start > 0 else 0

    def host_batch(self) -> Dict[str, np.ndarray]:
        """The next batch on the host: float32 arrays."""
        if self._gen is None:
            # _records() fast-forwards the stream and the shuffle; the window
            # draws and the crop positions of the skipped clips are replayed here.
            self._gen = self._records()
            for _ in range(self.start_batch * self.batch):
                self._window_start()
                self._clip_index += 1
        fs, as_, ss = [], [], []
        for _ in range(self.batch):
            frames_u8, actions, states = next(self._gen)
            s = self._window_start()
            if self.crop:
                oy, ox = crop_offsets(self.seed, self._clip_index, self.raw_image_size,
                                      self.crop, self.crop_random)
                frames_u8 = frames_u8[:, oy:oy + self.crop, ox:ox + self.crop]
            self._clip_index += 1
            f = frames_u8[s:s + self.seq_len].astype(np.float32) / 255.0 * 2 - 1
            fs.append(bilinear_resize(f, self.image_size))
            as_.append(actions[s:s + self.seq_len - 1])
            ss.append(states[s:s + self.seq_len - 1])
        return {"frames": np.stack(fs), "actions": np.stack(as_), "states": np.stack(ss)}

    def batch_at(self, index):
        del index  # stream-ordered
        out = self.host_batch()
        if self.device is None:
            return out
        from action_conditioned_gans_tpu_torch.data.pipeline import place_batch

        return place_batch(out, self.device, self.frames_dtype)

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1
