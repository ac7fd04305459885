"""Kernel 1's Hopper mainloop (csrc/conv_wgmma.cuh) and its dispatch
(csrc/conv_norm_act.cu), emulated on the CPU.

The CUDA kernel cannot run here, so its address maps are copied into
Python: which mainloop and tile a call takes, the per-copy im2col gather
with zero-fill, the 128-byte swizzle of the shared-memory ring, the stage
schedule over K (the last stage partial), the packing of the weights into
the K-major B operand, and the wgmma accumulator layout written back to the
epilogue's tile. Every (row, depth) of a stage must be written exactly once,
padding and out-of-range entries must be zero, and the de-swizzled tiles,
multiplied and run through the epilogue of tests/test_torch_ops.py, must
equal the plain version and the JAX package's XLA oracle (float32, 1e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_ops import emulate_epilogue

import jax.numpy as jnp
from action_conditioned_gans_tpu.ops import xla as X
from action_conditioned_gans_tpu_torch.config import PRESETS, get_preset
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import envelope
from action_conditioned_gans_tpu_torch.ops.common import same_pad
from action_conditioned_gans_tpu_torch.ops.kernels import conv as K

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
NT = 256  # threads per block (gn_common.cuh)
BK, ROW_BYTES = 64, 128  # conv_wgmma.cuh

# -- dispatch and tile count, from conv_norm_act.cu and conv_common.cuh --------


def tile_rows(bf16, cout):
    return 128 if bf16 and cout <= 16 else 64


def wgmma_av(cin, x_addr=0):
    if cin % 8 == 0 and x_addr % 16 == 0:
        return 8
    if cin % 4 == 0 and x_addr % 8 == 0:
        return 4
    return 0


def conv_path(bf16, cin, cout, x_addr=0):
    if not bf16:
        return "fma"
    return "wgmma" if cout % 64 == 0 and wgmma_av(cin, x_addr) else "wmma"


def wgmma_bn(cout, bm, blocks):
    if bm == 64 and cout % 256 == 0 and blocks * (cout // 256) >= 128:
        return 256
    return 128 if cout % 128 == 0 else 64


def conv_tile(bf16, cin, cout, pixels, batch, x_addr=0):
    """(mainloop, BM, BN, tiles) of one kernel-1 call."""
    path = conv_path(bf16, cin, cout, x_addr)
    if path == "wgmma":
        bm = 128 if pixels >= 128 else 64
        bn = wgmma_bn(cout, bm, batch * -(-pixels // bm))
    else:
        bm, bn = tile_rows(bf16, cout), (16 if bf16 and cout <= 16 else 64)
    return path, bm, bn, -(-pixels // bm)


def stage_shape(bm, bn):
    """(columns per warpgroup, ring stages): Shape<BM, BN>."""
    return (bn if bm == 128 else bn // 2), (3 if bm + bn >= 256 else 4)


def test_dispatch_envelope():
    # bfloat16 with Cin % 4 == 0 and Cout % 64 == 0 (and x aligned to the copy).
    assert conv_path(1, 64, 128) == "wgmma" and wgmma_av(64) == 8
    assert conv_path(1, 260, 256) == "wgmma" and wgmma_av(260) == 4
    assert conv_path(1, 263, 256) == "wmma"  # config4's bottleneck
    assert conv_path(1, 3, 64) == conv_path(1, 10, 64) == "wmma"  # first layers
    assert conv_path(1, 64, 3) == conv_path(1, 64, 96) == "wmma"  # Cout % 64 != 0
    assert conv_path(0, 64, 128) == "fma"
    assert conv_path(1, 64, 128, x_addr=8) == "wgmma" and wgmma_av(64, 8) == 4
    assert conv_path(1, 12, 64, x_addr=4) == "wmma"
    assert conv_tile(1, 64, 128, 256, 8) == ("wgmma", 128, 128, 2)
    assert conv_tile(1, 12, 192, 25, 8) == ("wgmma", 64, 64, 1)
    assert conv_tile(1, 20, 128, 144, 8) == ("wgmma", 128, 128, 2)
    assert conv_tile(1, 3, 3, 4096, 8) == ("wmma", 128, 16, 32)
    # 256 columns only for 64-row tiles, and only with >= 128 blocks of them.
    assert conv_tile(1, 128, 256, 64, 128) == ("wgmma", 64, 256, 1)
    assert conv_tile(1, 128, 256, 64, 127) == ("wgmma", 64, 128, 1)
    assert conv_tile(1, 256, 512, 16, 64) == ("wgmma", 64, 256, 1)
    assert conv_tile(1, 128, 256, 1024, 128) == ("wgmma", 128, 128, 8)
    # The ring fits a block (two of them for every tile but 64 x 256); the
    # epilogue's float32 tile fits the ring.
    for bm, bn in ((64, 64), (64, 128), (64, 256), (128, 64), (128, 128)):
        wn, stages = stage_shape(bm, bn)
        ring = stages * (bm + bn) * ROW_BYTES
        assert (1 if bn == 256 else 2) * (ring + 1024) <= 232448 - 2 * 1024
        assert bm * (bn + 4) * 4 <= ring and wn in (32, 64, 128)


# -- every kernel-1 layer of the five presets ----------------------------------


def fused_conv_layers(preset, dtype, batch):
    """(name, block, x shape, output shape) of every G and D layer that runs
    kernel 1 (fused, not transposed), from the models on the meta device."""
    m = dataclasses.replace(get_preset(preset).model, compute_dtype=dtype)
    with torch.device("meta"):
        models = {"G": Generator(m), "D": Discriminator(m)}
    s = m.image_size
    frame = torch.empty(batch, s, s, m.image_channels, device="meta")
    action = torch.empty(batch, m.action_dim, device="meta")
    state = torch.empty(batch, m.state_dim, device="meta") if m.state_dim else None
    seen = []
    for prefix, model in models.items():
        hooks = [
            block.register_forward_hook(
                lambda mod, args, out, name=f"{prefix}.{name}": seen.append(
                    (name, mod, tuple(args[0].shape), tuple(out.shape)))
            )
            for name, block in model.named_children()
        ]
        with torch.no_grad():
            model(frame, action, state) if prefix == "G" else model(frame, frame, action, state)
        for h in hooks:
            h.remove()
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    return [(name, block, x, out) for name, block, x, out in seen
            if not block.transpose and envelope.route(
                x, tuple(block.kernel.shape), block.stride, False, block.norm, block.groups,
                dt) == "fused"]


# (layer, mainloop, BM, BN, tiles per sample) of every bfloat16 kernel-1
# layer at the batches below.
BF16_PLAN = {
    "config1": [
        ("G.enc_0", "wmma", 64, 64, 16), ("G.enc_1", "wgmma", 128, 128, 2),
        ("G.enc_2", "wgmma", 64, 256, 1), ("G.bottleneck", "wgmma", 64, 256, 1),
        ("D.conv_0", "wmma", 64, 64, 16), ("D.conv_1", "wgmma", 128, 128, 2),
        ("D.conv_2", "wgmma", 64, 256, 1), ("D.conv_3", "wgmma", 64, 256, 1),
    ],
    "config2": [
        ("G.enc_0", "wmma", 64, 64, 16), ("G.enc_1", "wgmma", 128, 128, 2),
        ("G.enc_2", "wgmma", 64, 128, 1), ("G.bottleneck", "wgmma", 64, 128, 1),
        ("D.conv_0", "wmma", 64, 64, 16), ("D.conv_1", "wgmma", 128, 128, 2),
        ("D.conv_2", "wgmma", 64, 128, 1), ("D.conv_3", "wgmma", 64, 128, 1),
    ],
    "config3": [
        ("G.enc_0", "wmma", 64, 64, 64), ("G.enc_1", "wgmma", 128, 128, 8),
        ("G.enc_2", "wgmma", 128, 128, 2), ("G.enc_3", "wgmma", 64, 128, 1),
        ("G.bottleneck", "wgmma", 64, 128, 1), ("D.conv_0", "wmma", 64, 64, 64),
        ("D.conv_0_extra_0", "wgmma", 128, 64, 32), ("D.conv_1", "wgmma", 128, 128, 8),
        ("D.conv_1_extra_0", "wgmma", 128, 128, 8), ("D.conv_2", "wgmma", 128, 128, 2),
        ("D.conv_2_extra_0", "wgmma", 128, 128, 2), ("D.conv_3", "wgmma", 64, 128, 1),
        ("D.conv_3_extra_0", "wgmma", 64, 128, 1), ("D.conv_4_extra_0", "wgmma", 64, 128, 1),
    ],
    "config4": [
        ("G.enc_0", "wmma", 64, 64, 16), ("G.enc_1", "wgmma", 128, 128, 2),
        ("G.enc_2", "wgmma", 64, 128, 1), ("G.bottleneck", "wmma", 64, 64, 1),
        ("D.conv_0", "wmma", 64, 64, 16), ("D.conv_1", "wgmma", 128, 128, 2),
        ("D.conv_2", "wgmma", 64, 128, 1), ("D.conv_3", "wgmma", 64, 128, 1),
    ],
    "config5": [
        ("G.enc_2", "wgmma", 128, 128, 8), ("G.bottleneck", "wgmma", 64, 128, 1),
        ("D.conv_2", "wgmma", 128, 128, 8), ("D.conv_2_extra_0", "wgmma", 128, 128, 8),
        ("D.conv_4_extra_0", "wgmma", 64, 128, 1), ("D.conv_5_extra_0", "wgmma", 64, 128, 1),
    ],
}
# chip_smoke.py's batches per preset (config2 / config4 have no main path there).
BATCH = {"config1": 128, "config2": 32, "config3": 32, "config4": 32, "config5": 32}


def plans(preset, dtype):
    bf16 = int(dtype == "bfloat16")
    rows = []
    for name, block, x, out in fused_conv_layers(preset, dtype, BATCH[preset]):
        _, _, cin, cout = block.kernel.shape
        rows.append((name, *conv_tile(bf16, cin, cout, out[1] * out[2], x[0])))
    return rows


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bf16_plan_of_every_kernel1_layer(preset):
    assert plans(preset, "bfloat16") == BF16_PLAN[preset]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_f32_plan_of_every_kernel1_layer_and_slots_match_the_launcher(preset):
    for dtype in ("float32", "bfloat16"):
        bf16 = int(dtype == "bfloat16")
        rows = plans(preset, dtype)
        assert rows or (preset, dtype) == ("config5", "float32")  # every layer split
        for (name, path, bm, bn, tiles), (_, block, x, out) in zip(
                rows, fused_conv_layers(preset, dtype, BATCH[preset])):
            pixels, cout = out[1] * out[2], block.kernel.shape[3]
            if not bf16:
                assert (path, bm, bn) == ("fma", 64, 64), name
            # The wrapper sizes psum / psq from acg_conv_tiles; the launcher
            # that runs the call grids over the same count: g.tiles for
            # wgmma, launch_conv_norm_act's own ceil(P / tile_rows) otherwise.
            launcher = tiles if path == "wgmma" else -(-pixels // tile_rows(bf16, cout))
            assert tiles == launcher and (tiles - 1) * bm < pixels <= tiles * bm, name


def test_mainloop_counts_per_main_path():
    """chip_smoke.py's per-path counts: (kernel-1 launches, of them on wgmma)
    per generator call or training step (G once, D on real + fake, then D
    again in the G head)."""
    def count(preset, parts):
        rows = [r for r in plans(preset, "bfloat16") if r[0].split(".")[0] in parts]
        per = {"G": 1, "D": 2}
        total = sum(per[r[0][0]] for r in rows)
        return total, sum(per[r[0][0]] for r in rows if r[1] == "wgmma")

    assert count("config1", "G") == (4, 3)
    assert count("config1", "GD") == (12, 9)
    assert count("config3", "GD") == (23, 20)
    assert count("config5", "G") == (2, 2)


# -- the mainloop's address maps ---------------------------------------------------


@dataclasses.dataclass
class Geom:
    B: int
    H: int
    W: int
    Cin: int
    OH: int
    OW: int
    Cout: int
    KH: int
    KW: int
    stride: int
    pad_h: int
    pad_w: int

    @property
    def K(self):
        return self.KH * self.KW * self.Cin


def geom(x_shape, w_shape, stride):
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    oh, pad_h, _ = same_pad(h, kh, stride)
    ow, pad_w, _ = same_pad(wd, kw, stride)
    return Geom(b, h, wd, cin, oh, ow, cout, kh, kw, stride, pad_h, pad_w)


def row_at(g, p):
    oy, ox = divmod(p, g.OW)
    return oy * g.stride - g.pad_h, ox * g.stride - g.pad_w, p < g.OH * g.OW


def tap_at(g, k):
    if k >= g.K:
        return 0, 0, 0, False
    tap, ci = divmod(k, g.Cin)
    dih, diw = divmod(tap, g.KW)
    return dih, diw, ci, True


def a_offset(g, row, tap):
    ih0, iw0, rok = row
    dih, diw, ci, tok = tap
    ih, iw = ih0 + dih, iw0 + diw
    if not (rok and tok and 0 <= ih < g.H and 0 <= iw < g.W):
        return -1
    return (ih * g.W + iw) * g.Cin + ci


def swizzle(r, c):
    """Byte offset of row r's 16-byte chunk c in a 128-byte-swizzled tile."""
    return r * ROW_BYTES + ((c ^ (r & 7)) << 4)


def unswizzle(offset):
    """(row, byte within the logical row) of a swizzled byte offset."""
    r, rem = divmod(offset, ROW_BYTES)
    return r, (((rem >> 4) ^ (r & 7)) << 4) | (rem & 15)


def test_swizzle_is_a_bijection_and_its_inverse():
    seen = set()
    for r in range(128):
        for byte in range(0, ROW_BYTES, 2):
            off = swizzle(r, byte >> 4) + (byte & 15)
            assert unswizzle(off) == (r, byte)
            assert r * ROW_BYTES <= off < (r + 1) * ROW_BYTES  # a row stays in its row
            seen.add(off)
    assert seen == set(range(0, 128 * ROW_BYTES, 2))
    # Rows r and r + 8 share the pattern: an 8-row x 128-byte atom repeats.
    assert all(swizzle(r + 8, c) - swizzle(r, c) == 8 * ROW_BYTES for r in range(8) for c in range(8))


def pack_weights(w, g):
    """pack_weights_kernel: HWIO (K, Cout) -> (Cout, K) through 32x32 tiles."""
    src = w.reshape(-1)
    wt = np.full(g.Cout * g.K, np.nan, dtype=np.float32)
    for bx in range(-(-g.K // 32)):
        for by in range(-(-g.Cout // 32)):
            for tid in range(NT):
                tx, ty = tid % 32, tid // 32
                for i in range(ty, 32, NT // 32):
                    n, k = by * 32 + i, bx * 32 + tx
                    if n < g.Cout and k < g.K:
                        wt[n * g.K + k] = src[k * g.Cout + n]
    return wt


def im2col(x, g):
    """(B, OH*OW, K) with depth order (kh, kw, ci), built independently of
    the kernel's maps: shifted, strided views of the zero-padded input."""
    xp = F.pad(x, (0, 0, g.pad_w, g.KW + g.stride * g.OW, g.pad_h, g.KH + g.stride * g.OH))
    cols = [xp[:, dih:dih + g.stride * g.OH:g.stride, diw:diw + g.stride * g.OW:g.stride, :]
            for dih in range(g.KH) for diw in range(g.KW)]
    return torch.cat(cols, dim=-1).reshape(g.B, g.OH * g.OW, g.K)


def load_stage(xb, wt, g, bm, bn, av, p0, n0, kt):
    """One stage of the ring as conv_wgmma_kernel's `load` fills it: the
    swizzled A and B tiles (as bfloat16 element slots) and how many copies
    wrote each slot."""
    cpr = BK // av
    rstep = NT // cpr
    chunk = av * 2
    a, na = np.full(bm * BK, np.nan, dtype=np.float32), np.zeros(bm * BK, dtype=np.int32)
    b, nb = np.full(bn * BK, np.nan, dtype=np.float32), np.zeros(bn * BK, dtype=np.int32)
    for tid in range(NT):
        c, r0 = tid % cpr, tid // cpr
        cc, cb = (c * chunk) >> 4, (c * chunk) & 15
        k = kt * BK + c * av
        tap = tap_at(g, k)
        for i in range(bm // rstep):
            r = r0 + rstep * i
            o = a_offset(g, row_at(g, p0 + r), tap)
            dst = (swizzle(r, cc) + cb) // 2
            a[dst:dst + av] = xb[o:o + av] if o >= 0 else 0.0
            na[dst:dst + av] += 1
        for i in range(bn // rstep):
            r = r0 + rstep * i
            dst = (swizzle(r, cc) + cb) // 2
            src = (n0 + r) * g.K + k
            b[dst:dst + av] = wt[src:src + av] if k < g.K else 0.0
            nb[dst:dst + av] += 1
    return a, na, b, nb


def deswizzle(tile, rows):
    idx = [(swizzle(r, e >> 3) + 2 * (e & 7)) // 2 for r in range(rows) for e in range(BK)]
    return tile[idx].reshape(rows, BK)


def ring_schedule(kt_total, stages):
    """The order of conv_wgmma_kernel's copies and reads; checks that every
    read finds its step's copy landed and that no copy overwrites a stage
    before the read of its previous step has finished."""
    committed, landed = [], 0  # committed: k-step of each cp.async group (None: empty)
    holds = {}  # stage -> k-step whose copy was issued into it last
    reading_done = {}  # stage -> whether the last read of it finished
    for s in range(stages - 1):
        if s < kt_total:
            assert reading_done.get(s % stages, True)
            holds[s % stages] = s
        committed.append(s if s < kt_total else None)
    for kt in range(kt_total):
        landed = max(landed, len(committed) - (stages - 2))  # cp.async.wait_group STAGES-2
        st = kt % stages
        assert holds[st] == kt and kt in committed[:landed], (kt, committed, landed)
        reading_done[st] = False  # wgmma issued on the stage
        nk = kt + stages - 1
        if nk < kt_total:
            assert reading_done.get(nk % stages, True), (kt, nk)  # its last read finished
            holds[nk % stages] = nk
        committed.append(nk if nk < kt_total else None)
        reading_done[st] = True  # wgmma.wait_group 0
    return len(committed)


@pytest.mark.parametrize("kt_total", [1, 2, 3, 4, 5, 37])
@pytest.mark.parametrize("stages", [3, 4])
def test_ring_schedule(kt_total, stages):
    assert ring_schedule(kt_total, stages) == kt_total + stages - 1


def wgmma_fragment(t, i):
    """(row, column) of accumulator register i of thread t (0..127) of a
    warpgroup in the m64nN float32 layout (PTX ISA, wgmma .f32 D)."""
    return (t // 32) * 16 + (t % 32) // 4 + 8 * ((i % 4) // 2), (i // 4) * 8 + (t % 4) * 2 + i % 2


def cs_position(tid, j, q, bm, wn):
    """Where conv_wgmma_kernel stores acc[4j + q] of thread tid into Cs."""
    wgi, lane, warp = tid // 128, tid % 32, (tid % 128) // 32
    row = (wgi * 64 if bm == 128 else 0) + warp * 16 + lane // 4
    col = (0 if bm == 128 else wgi * wn) + (lane % 4) * 2
    return row + 8 * (q // 2), col + 8 * j + q % 2


def accumulators_to_cs(d, bm, bn):
    """d: the block's (BM, BN) product. Each warpgroup's accumulators as
    wgmma leaves them, stored to Cs as the kernel stores them."""
    wn, _ = stage_shape(bm, bn)
    cs = np.full((bm, bn), np.nan, dtype=np.float32)
    for tid in range(NT):
        wgi = tid // 128
        r0, c0 = (wgi * 64, 0) if bm == 128 else (0, wgi * wn)
        for i in range(wn // 2):
            r, c = wgmma_fragment(tid % 128, i)
            at = cs_position(tid, i // 4, i % 4, bm, wn)
            assert np.isnan(cs[at])
            cs[at] = d[r0 + r, c0 + c]
    assert not np.isnan(cs).any()
    return cs


def emulate_wgmma_conv(x, w, stride, bn=None):
    """conv_wgmma_kernel over every block: pre-norm y (B, OH, OW, Cout).
    ``bn`` overrides the tile width the dispatch picks for this batch."""
    g = geom(tuple(x.shape), tuple(w.shape), stride)
    path, bm, picked, tiles = conv_tile(1, g.Cin, g.Cout, g.OH * g.OW, g.B)
    bn = bn or picked
    assert path == "wgmma"
    av = wgmma_av(g.Cin)
    wn = w.numpy()
    wt = pack_weights(wn, g)
    np.testing.assert_array_equal(wt.reshape(g.Cout, g.K), wn.reshape(g.K, g.Cout).T)
    wk = wn.reshape(g.K, g.Cout)
    cols = im2col(x, g).numpy()
    y = np.zeros((g.B, g.OH * g.OW, g.Cout), dtype=np.float32)
    kt_total = -(-g.K // BK)
    for b in range(g.B):
        xb = x[b].reshape(-1).numpy()
        for tile in range(tiles):
            p0 = tile * bm
            for n0 in range(0, g.Cout, bn):
                d = np.zeros((bm, bn), dtype=np.float64)
                for kt in range(kt_total):
                    a, na, bt, nb = load_stage(xb, wt, g, bm, bn, av, p0, n0, kt)
                    assert (na == 1).all() and (nb == 1).all(), "a slot not written once"
                    at, btt = deswizzle(a, bm), deswizzle(bt, bn)
                    # Rows past the plane and depths k >= K are zero.
                    want_a = np.zeros((bm, BK), dtype=np.float32)
                    rows = min(bm, g.OH * g.OW - p0)
                    depth = min(BK, g.K - kt * BK)
                    want_a[:rows, :depth] = cols[b, p0:p0 + rows, kt * BK:kt * BK + depth]
                    np.testing.assert_array_equal(at, want_a)
                    want_b = np.zeros((bn, BK), dtype=np.float32)
                    want_b[:, :depth] = wk[kt * BK:kt * BK + depth, n0:n0 + bn].T
                    np.testing.assert_array_equal(btt, want_b)
                    d += at.astype(np.float64) @ btt.T.astype(np.float64)
                cs = accumulators_to_cs(d, bm, bn)
                rows = min(bm, g.OH * g.OW - p0)
                y[b, p0:p0 + rows, n0:n0 + bn] = cs[:rows]  # tile_epilogue's y
    return torch.from_numpy(y.reshape(g.B, g.OH, g.OW, g.Cout))


# (x shape, w shape, stride, kind, act, BN override): the mainloop's edges.
EDGE = [
    ((2, 5, 5, 12), (3, 3, 12, 192), 1, "group", "lrelu", None),  # AV 4, K 108, 25 rows, BN 64 x 3
    ((2, 12, 12, 20), (3, 3, 20, 128), 1, "group", "relu", None),  # BM 128 (144 rows), AV 4
    ((2, 9, 9, 16), (4, 4, 16, 64), 2, "none", "tanh", None),  # AV 8, odd plane pads (1, 2)
    ((1, 24, 24, 16), (4, 4, 16, 192), 2, "group", "lrelu", None),  # BM 128, BN 64 x 3
    ((1, 3, 3, 8), (3, 3, 8, 256), 1, "group", "lrelu", 256),  # the 64 x 256 tile, 9 rows
]


@pytest.mark.parametrize("x_shape,w_shape,stride,kind,act,bn", EDGE)
def test_wgmma_mainloop_emulation_matches_plain_and_jax(x_shape, w_shape, stride, kind, act, bn):
    rng = np.random.default_rng(sum(x_shape) + sum(w_shape))
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.1).astype(np.float32)
    cout = w_shape[3]
    scale = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32) if kind == "group" else None
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ts = None if scale is None else torch.from_numpy(scale)
    tb = torch.from_numpy(bias)
    y = emulate_wgmma_conv(tx, tw, stride, bn)
    got = emulate_epilogue(y, ts, tb, kind, 32, act)
    want = K.conv_norm_act_plain(tx, tw, ts, tb, stride=stride, kind=kind, groups=32, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    oracle = X.norm_act(X.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride),
                        None if scale is None else jnp.asarray(scale), jnp.asarray(bias),
                        kind=kind, groups=32, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
