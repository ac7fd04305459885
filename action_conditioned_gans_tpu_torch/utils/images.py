"""PNG grids, GIFs and comparison strips of frames (port of the JAX package's
``utils/images.py``), written with the standard library alone.

The JAX package writes through Pillow; the port does not depend on it. PNG
is 8-bit grayscale, RGB or RGBA, one unfiltered scanline per row, zlib
compressed. GIF89a has one global palette (256 grays for one channel; for
colour, the 6x6x6 cube of levels 0, 51, ..., 255 and 40 grays, each pixel
taking its nearest cube colour, or its nearest gray where the gray's largest
channel difference is smaller, so no channel is off by more than 25), the
NETSCAPE loop block (loop forever) and an LZW encoder of its own. Host-side
only: never on the training hot path.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def frames_to_uint8(frames) -> np.ndarray:
    """[-1, 1] float frames -> uint8, any leading batch/time dims kept."""
    x = np.asarray(frames, dtype=np.float32)
    x = (np.clip(x, -1.0, 1.0) + 1.0) * 127.5
    return np.round(x).astype(np.uint8)


def tile_grid(images: np.ndarray, cols: int = 8) -> np.ndarray:
    """(N, H, W, C) uint8 -> one tiled (rows*H, cols*W, C) grid image."""
    n, h, w, c = images.shape
    cols = min(cols, n)
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, c), dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return grid


# -- PNG ------------------------------------------------------------------------------

_PNG_COLOUR = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (gray, RGB, RGBA)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, C) uint8 with C in 1, 3, 4 -> PNG bytes."""
    h, w, c = image.shape
    if image.dtype != np.uint8 or c not in _PNG_COLOUR:
        raise ValueError(f"PNG needs (H, W, 1|3|4) uint8, got {image.shape} {image.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOUR[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


_PNG_CHANNELS = {v: k for k, v in _PNG_COLOUR.items()}  # colour type -> channels
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes before filter ``kind`` (0-4) was applied, given
    the previous scanline's (zeros above the first)."""
    if kind == 0:
        return row
    if kind == 1:  # Sub: a running sum along each channel
        return (row.reshape(-1, bpp).astype(np.int64).cumsum(axis=0) % 256).astype(
            np.uint8).reshape(-1)
    if kind == 2:  # Up
        return row + prev
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind} is not one of 0-4")
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:  # Average
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, up[i], c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C 1 (gray), 3 (RGB) or 4 (RGBA): 8-bit
    samples, colour types 0, 2 and 6, filters 0-4, no interlace. Chunk CRCs
    are checked. Any other PNG raises a ValueError that says what is
    unsupported."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG (no PNG signature)")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG {kind!r} chunk fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"unsupported PNG bit depth {depth} (only 8-bit samples are decoded)")
    if colour not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG colour type {colour} (decoded: 0 gray, 2 RGB, "
                         "6 RGBA; not 3 palette or 4 gray + alpha)")
    if interlace:
        raise ValueError("unsupported interlaced (Adam7) PNG")
    c = _PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * c + 1
    if raw.size != h * stride:
        raise ValueError(f"PNG image data holds {raw.size} bytes, not {h} rows of {stride}")
    rows = raw.reshape(h, stride)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, c)
    return out.reshape(h, w, c)


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_image_grid(path: str, images, cols: int = 8) -> None:
    """Save (N, H, W, C) frames in [-1, 1] as one tiled PNG."""
    _write(path, encode_png(tile_grid(frames_to_uint8(images), cols)))


def save_rollout_strip(path: str, gt_clip, pred_clip) -> None:
    """Two-row comparison strip: ground truth (top) vs prediction (bottom),
    time along the horizontal axis. Shapes (T, H, W, C) in [-1, 1]."""
    gt, pred = frames_to_uint8(gt_clip), frames_to_uint8(pred_clip)
    strip = np.concatenate(
        [np.concatenate(list(gt), axis=1), np.concatenate(list(pred), axis=1)], axis=0)
    _write(path, encode_png(strip))


# -- GIF ------------------------------------------------------------------------------

_CUBE = np.arange(6) * 51
_GRAYS = np.round(np.linspace(0, 255, 40)).astype(np.int64)


def gif_palette(channels: int) -> np.ndarray:
    """The (256, 3) uint8 global palette for ``channels`` (1 or 3)."""
    if channels == 1:
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    r, g, b = np.meshgrid(_CUBE, _CUBE, _CUBE, indexing="ij")
    cube = np.stack([r.ravel(), g.ravel(), b.ravel()], axis=1)
    grays = np.repeat(_GRAYS[:, None], 3, axis=1)
    return np.concatenate([cube, grays]).astype(np.uint8)


def _palette_indices(frame: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W) indices into :func:`gif_palette` (C)."""
    if frame.shape[-1] == 1:
        return frame[..., 0]
    x = frame.astype(np.int64)
    q = np.round(x / 51.0).astype(np.int64)  # nearest cube level per channel
    cube_idx = q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]
    cube_err = np.abs(x - q * 51).max(-1)
    gray = np.abs(x.mean(-1, keepdims=True) - _GRAYS).argmin(-1)
    gray_err = np.abs(x - _GRAYS[gray][..., None]).max(-1)
    return np.where(gray_err < cube_err, 216 + gray, cube_idx).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a byte string of palette indices: codes
    from ``min_code_size + 1`` bits up to 12, packed least significant bit
    first, a clear code first and whenever the table is full, then the end
    code."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    width = min_code_size + 1
    table, next_code = {}, end + 1
    emit(clear, width)
    prefix = None
    for byte in indices:
        if prefix is None:
            prefix = byte
            continue
        key = (prefix, byte)
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear, width)
            table, next_code, width = {}, end + 1, min_code_size + 1
        prefix = byte
    if prefix is not None:
        emit(prefix, width)
        # The decoder adds an entry after this code too: widen as it will.
        if next_code >= (1 << width) and width < 12:
            width += 1
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames: np.ndarray, duration_ms: int) -> bytes:
    """(T, H, W, C) uint8 with C in 1, 3 -> an animated GIF89a that loops
    forever, each frame shown ``duration_ms`` (stored in hundredths)."""
    t, h, w, c = frames.shape
    if frames.dtype != np.uint8 or c not in (1, 3):
        raise ValueError(f"GIF needs (T, H, W, 1|3) uint8, got {frames.shape} {frames.dtype}")
    delay = int(round(duration_ms / 10))
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), gif_palette(c).tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for frame in frames:
        parts.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        parts.append(b"\x08" + _sub_blocks(lzw_encode(_palette_indices(frame).tobytes())))
    parts.append(b"\x3b")
    return b"".join(parts)


def save_gif(path: str, clip, fps: int = 5) -> None:
    """Save a (T, H, W, C) clip in [-1, 1] as an animated GIF."""
    _write(path, encode_gif(frames_to_uint8(clip), int(1000 / fps)))
