"""Kernel 2's mainloops (csrc/conv_transpose_norm_act.cu) emulated on the CPU.

The CUDA kernels cannot run here, so their address maps are copied into
Python from the sources:

* the dispatch and tile plan of every conv-transpose layer of the five
  presets (wgmma, narrow, WMMA, FMA) and the GroupNorm slot count that sizes
  the wrapper's psum / psq (acg_conv_transpose_tiles);
* the wgmma ring with TRANSPOSE = true (csrc/conv_wgmma.cuh): the per-phase
  packing of the weights, the transposed cp.async gather with zero-fill and
  the 128-byte swizzle (every (row, depth) of a stage written once), the
  accumulator layout and tile_epilogue's depth-to-space writes and partial
  sums;
* the narrow design (csrc/conv_transpose_narrow.cuh): the band with its halo,
  the shared-memory weights, the mma.sync m16n8k16 fragments, the staged
  output band and its copy-out (every output element written exactly once).

The emulated GEMMs plus the epilogue of tests/test_torch_ops.py must equal
the plain version and the JAX package (its XLA oracle, and the Pallas kernel
in interpret mode for the narrow layer) in float32 within 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_conv_wgmma import (
    BATCH,
    BK,
    NT,
    accumulators_to_cs,
    deswizzle,
    stage_shape,
    swizzle,
    tile_rows,
    wgmma_av,
    wgmma_bn,
)
from test_torch_ops import emulate_epilogue

from action_conditioned_gans_tpu.ops import pallas as P
from action_conditioned_gans_tpu.ops import xla as X
from action_conditioned_gans_tpu_torch.config import PRESETS, get_preset
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.ops import envelope
from action_conditioned_gans_tpu_torch.ops.common import apply_act
from action_conditioned_gans_tpu_torch.ops.kernels import conv as K

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)

# -- dispatch, tile plan and slots, from conv_transpose_norm_act.cu -------------

BAND_PIXELS, MPW, SMEM_MAX = 128, 4, 113 * 1024  # conv_transpose_narrow.cuh


@dataclasses.dataclass
class NarrowPlan:
    rows: int
    cp: int
    np: int
    cs: int
    ws: int
    x_bytes: int
    w_bytes: int
    out_bytes: int  # the staged output band, float32

    @property
    def smem(self):
        return self.x_bytes + self.w_bytes + self.out_bytes


def narrow_plan(h, w, cin, cout):
    rows = min(h, 1 if w >= BAND_PIXELS else BAND_PIXELS // w)
    cp, np_ = -(-cin // 16) * 16, -(-cout // 8) * 8
    cs, ws = cp + 8, 4 * cp + 8
    return NarrowPlan(rows, cp, np_, cs, ws, (rows + 2) * (w + 2) * cs * 2, 4 * np_ * ws * 2,
                      4 * rows * w * cout * 4)


def narrow_fits(h, w, cin, cout):
    return cout <= 16 and narrow_plan(h, w, cin, cout).smem <= SMEM_MAX


def transpose_path(bf16, cin, cout, group_norm, h, w, x_addr=0):
    if not bf16:
        return "fma"
    if not group_norm and narrow_fits(h, w, cin, cout):
        return "narrow"
    return "wgmma" if cout % 64 == 0 and wgmma_av(cin, x_addr) else "wmma"


def transpose_tile(bf16, cin, cout, group_norm, h, w, batch, x_addr=0):
    """(mainloop, BM, BN, row tiles per (sample, phase)) of one kernel-2
    call; for the narrow mainloop (mainloop, band rows, NP, bands)."""
    path = transpose_path(bf16, cin, cout, group_norm, h, w, x_addr)
    pixels = h * w
    if path == "narrow":
        p = narrow_plan(h, w, cin, cout)
        return path, p.rows, p.np, -(-h // p.rows)
    if path == "wgmma":
        bm = 128 if pixels >= 128 else 64
        tiles = -(-pixels // bm)
        return path, bm, wgmma_bn(cout, bm, batch * 4 * tiles), tiles
    bm = tile_rows(bf16, cout)
    return path, bm, (16 if bf16 and cout <= 16 else 64), -(-pixels // bm)


def transpose_slots(bf16, cin, cout, group_norm, h, w, x_addr=0):
    """acg_conv_transpose_tiles: GroupNorm slots per sample."""
    path, _, _, tiles = transpose_tile(bf16, cin, cout, group_norm, h, w, 1, x_addr)
    return 0 if path == "narrow" else 4 * tiles


def test_dispatch_envelope():
    assert transpose_path(1, 256, 128, 1, 8, 8) == "wgmma"
    assert transpose_path(1, 12, 192, 1, 5, 6) == "wgmma" and wgmma_av(12) == 4
    assert transpose_path(1, 64, 3, 0, 32, 32) == "narrow"  # dec_0
    assert transpose_path(1, 64, 3, 0, 128, 128) == "narrow"  # config5's dec_0, were it fused
    assert transpose_path(1, 6, 8, 1, 5, 6) == "wmma"  # GroupNorm, Cout <= 16: 128x16 WMMA
    assert transpose_path(1, 20, 80, 1, 3, 3) == "wmma"  # Cout % 64 != 0
    assert transpose_path(1, 10, 64, 1, 4, 4) == "wmma"  # Cin % 4 != 0
    assert transpose_path(1, 64, 128, 1, 8, 8, x_addr=4) == "wmma"
    assert transpose_path(1, 64, 3, 0, 4, 1024) == "wmma"  # the band does not fit
    assert transpose_path(0, 64, 3, 0, 32, 32) == transpose_path(0, 256, 128, 1, 8, 8) == "fma"
    assert transpose_path(1, 64, 17, 0, 32, 32) == "wmma"
    # The tile plan sees H*W rows per (sample, phase) and B*4 planes.
    assert transpose_tile(1, 512, 256, 1, 8, 8, 32) == ("wgmma", 64, 256, 1)
    assert transpose_tile(1, 512, 256, 1, 8, 8, 31) == ("wgmma", 64, 128, 1)
    assert transpose_tile(1, 128, 64, 1, 16, 16, 128) == ("wgmma", 128, 64, 2)
    assert transpose_tile(1, 64, 3, 0, 10, 16, 3) == ("narrow", 8, 8, 2)
    assert transpose_tile(1, 16, 16, 0, 7, 9, 2) == ("narrow", 7, 16, 1)


def transposed_layers(preset, dtype, batch):
    """(name, block, x shape) of every fused conv-transpose layer of
    ``preset``'s generator, from the model on the meta device."""
    m = dataclasses.replace(get_preset(preset).model, compute_dtype=dtype)
    with torch.device("meta"):
        gen = Generator(m)
    s = m.image_size
    frame = torch.empty(batch, s, s, m.image_channels, device="meta")
    action = torch.empty(batch, m.action_dim, device="meta")
    state = torch.empty(batch, m.state_dim, device="meta") if m.state_dim else None
    seen = []
    hooks = [block.register_forward_pre_hook(
        lambda mod, args, name=name: seen.append((name, mod, tuple(args[0].shape))))
        for name, block in gen.named_children()]
    with torch.no_grad():
        gen(frame, action, state)
    for h in hooks:
        h.remove()
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    return [(name, block, x) for name, block, x in seen
            if block.transpose and envelope.route(
                x, tuple(block.kernel.shape), 2, True, block.norm, block.groups, dt) == "fused"]


def transpose_plans(preset, dtype):
    bf16 = int(dtype == "bfloat16")
    rows = []
    for name, block, x in transposed_layers(preset, dtype, BATCH[preset]):
        _, _, cin, cout = block.kernel.shape
        rows.append((name, *transpose_tile(bf16, cin, cout, int(block.norm == "group"), x[1], x[2],
                                           x[0])))
    return rows


_C1 = [("dec_2", "wgmma", 64, 128, 1), ("dec_1", "wgmma", 128, 64, 2),
       ("dec_0", "narrow", 4, 8, 8)]
# (layer, mainloop, BM or band rows, BN or NP, tiles per phase or bands) of
# every bfloat16 conv-transpose layer at chip_smoke.py's batches.
BF16_PLAN = {
    "config1": _C1,
    "config2": _C1,
    "config3": [("dec_3", "wgmma", 64, 256, 1), ("dec_2", "wgmma", 128, 128, 2),
                ("dec_1", "wgmma", 128, 64, 8), ("dec_0", "narrow", 2, 8, 32)],
    "config4": _C1,
    "config5": [],  # every decoder layer is split (ops/envelope.py)
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_bf16_plan_of_every_transposed_layer(preset):
    assert transpose_plans(preset, "bfloat16") == BF16_PLAN[preset]


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_f32_plan_of_every_transposed_layer_and_slots(preset):
    for dtype in ("float32", "bfloat16"):
        bf16 = int(dtype == "bfloat16")
        layers = transposed_layers(preset, dtype, BATCH[preset])
        assert layers or preset == "config5"
        for (name, path, bm, bn, tiles), (_, block, x) in zip(transpose_plans(preset, dtype), layers):
            _, h, w, cin = x
            cout, gn = block.kernel.shape[3], int(block.norm == "group")
            if not bf16:
                assert (path, bm, bn) == ("fma", 64, 64), name
            slots = transpose_slots(bf16, cin, cout, gn, h, w)
            if path == "narrow":
                assert slots == 0 and not gn, name
                continue
            # The launcher grids over (tiles, Cout / BN, B * 4) and each block
            # writes slot ((b * 4 + phase) * tiles + tile): per sample, the
            # 4 * tiles slots the wrapper allocates, each once.
            assert slots == 4 * tiles and (tiles - 1) * bm < h * w <= tiles * bm, name
            seen = sorted((ph * tiles + t) for ph in range(4) for t in range(tiles))
            assert seen == list(range(slots)), name


def test_mainloop_counts_per_main_path():
    """chip_smoke.py's kernel-2 counts per generator call (the generator
    runs once per training step): (wgmma, narrow)."""
    def count(preset):
        paths = [r[1] for r in transpose_plans(preset, "bfloat16")]
        return paths.count("wgmma"), paths.count("narrow"), len(paths)

    assert count("config1") == (2, 1, 3)
    assert count("config3") == (3, 1, 4)
    assert count("config5") == (0, 0, 0)


# -- the wgmma ring with TRANSPOSE = true ------------------------------------------


@dataclasses.dataclass
class TGeom:
    B: int
    H: int
    W: int
    Cin: int
    Cout: int

    @property
    def K(self):
        return 4 * self.Cin


def row_at(g, p, pr, pc):
    oy, ox = divmod(p, g.W)
    return oy + pr - 1, ox + pc - 1, p < g.H * g.W


def tap_at(g, k):
    if k >= g.K:
        return 0, 0, 0, False
    tap, ci = divmod(k, g.Cin)
    return tap >> 1, tap & 1, ci, True


def a_offset(g, row, tap):
    ih0, iw0, rok = row
    dih, diw, ci, tok = tap
    ih, iw = ih0 + dih, iw0 + diw
    if not (rok and tok and 0 <= ih < g.H and 0 <= iw < g.W):
        return -1
    return (ih * g.W + iw) * g.Cin + ci


def w_row(g, k, pr, pc):
    tap, ci = divmod(k, g.Cin)
    return ((2 * (tap >> 1) + pr) * 4 + 2 * (tap & 1) + pc) * g.Cin + ci


def phase_kernels(w):
    """(4, 4*Cin, Cout): phase (r, c)'s depth k = (2dy + dx)*Cin + ci reads
    w[2dy + r, 2dx + c, ci], built independently of the kernel's maps."""
    return np.stack([np.concatenate([w[2 * dy + r, 2 * dx + c] for dy in range(2) for dx in range(2)])
                     for r in range(2) for c in range(2)])


def pack_weights(w, g):
    """pack_weights_kernel<true>: grid (ceil(K/32), ceil(Cout/32), 4)."""
    src = w.reshape(-1)
    wt = np.full(4 * g.Cout * g.K, np.nan, dtype=np.float32)
    written = np.zeros(wt.size, dtype=np.int32)
    for phase in range(4):
        for bx in range(-(-g.K // 32)):
            for by in range(-(-g.Cout // 32)):
                for tid in range(NT):
                    tx, ty = tid % 32, tid // 32
                    for i in range(ty, 32, NT // 32):
                        n, k = by * 32 + i, bx * 32 + tx
                        if n < g.Cout and k < g.K:
                            dst = (phase * g.Cout + n) * g.K + k
                            wt[dst] = src[w_row(g, k, phase >> 1, phase & 1) * g.Cout + n]
                            written[dst] += 1
    assert (written == 1).all()
    return wt


@pytest.mark.parametrize("cin,cout", [(12, 192), (8, 64), (40, 128)])
def test_pack_weights_per_phase(cin, cout):
    g = TGeom(1, 2, 2, cin, cout)
    w = np.random.default_rng(cin + cout).standard_normal((4, 4, cin, cout)).astype(np.float32)
    wt = pack_weights(w, g).reshape(4, cout, 4 * cin)
    np.testing.assert_array_equal(wt, phase_kernels(w).transpose(0, 2, 1))


def phase_im2col(x):
    """(4, B, H*W, 4*Cin): phase (r, c)'s A = shifted views of the input
    padded by one pixel, built independently of the kernel's maps."""
    b, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([
        torch.cat([xp[:, dy + r:dy + r + h, dx + c:dx + c + w, :]
                   for dy in range(2) for dx in range(2)], dim=-1).reshape(b, h * w, 4 * cin)
        for r in range(2) for c in range(2)])


def load_stage(xb, wt, g, bm, bn, av, phase, p0, n0, kt):
    """One stage of the ring as conv_wgmma_kernel<true, ...>'s `load` fills
    it for (sample, phase): the swizzled A and B tiles and how many copies
    wrote each slot."""
    cpr = BK // av
    rstep = NT // cpr
    chunk = av * 2
    pr, pc = phase >> 1, phase & 1
    a, na = np.full(bm * BK, np.nan, dtype=np.float32), np.zeros(bm * BK, dtype=np.int32)
    b, nb = np.full(bn * BK, np.nan, dtype=np.float32), np.zeros(bn * BK, dtype=np.int32)
    for tid in range(NT):
        c, r0 = tid % cpr, tid // cpr
        cc, cb = (c * chunk) >> 4, (c * chunk) & 15
        k = kt * BK + c * av
        tap = tap_at(g, k)
        for i in range(bm // rstep):
            r = r0 + rstep * i
            o = a_offset(g, row_at(g, p0 + r, pr, pc), tap)
            dst = (swizzle(r, cc) + cb) // 2
            a[dst:dst + av] = xb[o:o + av] if o >= 0 else 0.0
            na[dst:dst + av] += 1
        for i in range(bn // rstep):
            r = r0 + rstep * i
            dst = (swizzle(r, cc) + cb) // 2
            src = (phase * g.Cout + n0 + r) * g.K + k
            b[dst:dst + av] = wt[src:src + av] if k < g.K else 0.0
            nb[dst:dst + av] += 1
    return a, na, b, nb


def emulate_wgmma_transpose(x, w, bn=None):
    """conv_wgmma_kernel<true, ...> over every block: the pre-norm y
    (B, 2H, 2W, Cout) that tile_epilogue writes at the depth-to-space
    positions, and the (B, slots, Cout) partial sums psum / psq."""
    g = TGeom(*x.shape, w.shape[3])
    path, bm, picked, tiles = transpose_tile(1, g.Cin, g.Cout, 1, g.H, g.W, g.B)
    assert path == "wgmma"
    bn = bn or picked
    av = wgmma_av(g.Cin)
    wt = pack_weights(w.numpy(), g)
    wk = phase_kernels(w.numpy())
    cols = phase_im2col(x).numpy()
    rows_total = g.H * g.W
    y = np.full((g.B, 2 * g.H, 2 * g.W, g.Cout), np.nan, dtype=np.float32)
    slots = transpose_slots(1, g.Cin, g.Cout, 1, g.H, g.W)
    psum = np.full(g.B * slots * g.Cout, np.nan, dtype=np.float64)
    psq = np.full_like(psum, np.nan)
    kt_total = -(-g.K // BK)
    for b in range(g.B):  # blockIdx.z = b * 4 + phase
        xb = x[b].reshape(-1).numpy()
        for phase in range(4):
            pr, pc = phase >> 1, phase & 1
            for tile in range(tiles):
                p0 = tile * bm
                for n0 in range(0, g.Cout, bn):
                    d = np.zeros((bm, bn), dtype=np.float64)
                    for kt in range(kt_total):
                        a, na, bt, nb = load_stage(xb, wt, g, bm, bn, av, phase, p0, n0, kt)
                        assert (na == 1).all() and (nb == 1).all(), "a slot not written once"
                        at, btt = deswizzle(a, bm), deswizzle(bt, bn)
                        rows = min(bm, rows_total - p0)
                        depth = min(BK, g.K - kt * BK)
                        want_a = np.zeros((bm, BK), dtype=np.float32)
                        want_a[:rows, :depth] = cols[phase, b, p0:p0 + rows, kt * BK:kt * BK + depth]
                        np.testing.assert_array_equal(at, want_a)
                        want_b = np.zeros((bn, BK), dtype=np.float32)
                        want_b[:, :depth] = wk[phase, kt * BK:kt * BK + depth, n0:n0 + bn].T
                        np.testing.assert_array_equal(btt, want_b)
                        d += at.astype(np.float64) @ btt.T.astype(np.float64)
                    cs = accumulators_to_cs(d, bm, bn)
                    rows = min(bm, rows_total - p0)
                    for r in range(rows):  # tile_epilogue: out_offset<true>
                        oy, ox = divmod(p0 + r, g.W)
                        y[b, 2 * oy + pr, 2 * ox + pc, n0:n0 + bn] = cs[r]
                    slot = ((b * 4 + phase) * tiles + tile) * g.Cout + n0
                    assert np.isnan(psum[slot:slot + bn]).all()
                    psum[slot:slot + bn] = cs[:rows].astype(np.float64).sum(0)
                    psq[slot:slot + bn] = (cs[:rows].astype(np.float64) ** 2).sum(0)
    assert not np.isnan(y).any() and not np.isnan(psum).any()
    return torch.from_numpy(y), psum.reshape(g.B, slots, g.Cout), psq.reshape(g.B, slots, g.Cout)


def oracle(x, w, scale, bias, kind, groups, act):
    return np.asarray(X.norm_act(X.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), stride=2),
                                 None if scale is None else jnp.asarray(scale), jnp.asarray(bias),
                                 kind=kind, groups=groups, act=act))


def rand_inputs(x_shape, cout, kind):
    rng = np.random.default_rng(sum(x_shape) + cout)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((4, 4, x_shape[3], cout)) * 0.1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32) if kind == "group" else None
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, scale, bias


# (x shape, Cout, kind, act, BN override): the transposed mainloop's edges.
EDGE = [
    ((2, 5, 6, 12), 192, "group", "relu", None),  # 5x6 plane, AV 4, K 48 (one partial stage), BN 64 x 3
    ((1, 12, 12, 16), 64, "group", "lrelu", None),  # BM 128 over 144 rows, AV 8, K 64
    ((2, 3, 3, 32), 256, "none", "tanh", 256),  # the 64 x 256 tile, K 128 in two stages
    ((1, 4, 4, 8), 128, "group", "relu", None),  # 64 x 128, K 32
]


@pytest.mark.parametrize("x_shape,cout,kind,act,bn", EDGE)
def test_wgmma_transpose_emulation_matches_plain_and_jax(x_shape, cout, kind, act, bn):
    x, w, scale, bias = rand_inputs(x_shape, cout, kind)
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias)
    ts = None if scale is None else torch.from_numpy(scale)
    y, psum, psq = emulate_wgmma_transpose(tx, tw, bn)
    # gn_stats_kernel's per-channel sums over the slots equal the plane's.
    flat = y.double().reshape(x_shape[0], -1, cout).numpy()
    np.testing.assert_allclose(psum.sum(1), flat.sum(1), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(psq.sum(1), (flat ** 2).sum(1), rtol=1e-9, atol=1e-9)
    got = emulate_epilogue(y, ts, tb, kind, 32, act)
    want = K.conv_transpose_norm_act_plain(tx, tw, ts, tb, kind=kind, groups=32, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), oracle(x, w, scale, bias, kind, 32, act), **TOL)


# -- the narrow design ---------------------------------------------------------------


@pytest.mark.parametrize("x_shape,cout", [((128, 32, 32, 64), 3), ((32, 64, 64, 64), 3),
                                          ((3, 10, 16, 20), 3), ((2, 7, 9, 16), 16),
                                          ((1, 5, 300, 8), 3)])
def test_narrow_bands_and_halo_cover_the_plane(x_shape, cout):
    """Bands of ``rows`` input rows cover [0, H) once; each reads rows
    a0-1 .. a0+rows (the halo); their output rows 2*a0 .. 2*(a0+rows)-1
    cover [0, 2H) once; the m-tiles of every phase are shared out to the
    warps once; two blocks fit an SM (three at dec_0's 64-wide plane, four at
    its 32-wide one); the shared-memory areas stay 16-byte aligned."""
    b, h, w, cin = x_shape
    p = narrow_plan(h, w, cin, cout)
    per_sm = 232448 // (p.smem + 1024)
    assert p.smem <= SMEM_MAX and per_sm >= {32: 4, 64: 3}.get(w, 2)
    assert p.x_bytes % 16 == p.w_bytes % 16 == p.out_bytes % 16 == 0
    assert p.rows * w <= BAND_PIXELS or p.rows == 1
    bands = -(-h // p.rows)
    own, out_rows = np.zeros(h, dtype=int), np.zeros(2 * h, dtype=int)
    for band in range(bands):
        a0 = band * p.rows
        rows = min(p.rows, h - a0)
        assert rows >= 1 and rows + 2 <= p.rows + 2
        own[a0:a0 + rows] += 1
        out_rows[2 * a0:2 * (a0 + rows)] += 1
        mt = -(-rows * w // 16)
        for phase in range(4):
            got = sorted(j0 + 2 * i for warp in range(8) if warp & 3 == phase
                         for j0 in range(warp >> 2, mt, 2 * MPW) for i in range(MPW)
                         if j0 + 2 * i < mt)
            assert got == list(range(mt))
    assert (own == 1).all() and (out_rows == 1).all()
    # Fragment loads stay inside the band (rows 0 .. rows + 1, columns
    # 0 .. W + 1) and hit 32 different banks per 32-bit load.
    lanes = np.arange(32)
    word = (lanes >> 2) * (p.cs // 2) + (lanes & 3)
    assert len(set(word % 32)) == 32
    word = (lanes >> 2) * (p.ws // 2) + (lanes & 3)
    assert len(set(word % 32)) == 32


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 34, 64, 66, 130, 1026])
def test_fast_div_is_exact_where_the_kernel_divides(d):
    """FastDiv: n / d as the high word of n * ceil(2^32 / d) (d == 1 passes
    n through), exact for n * d < 2^32; the band copy keeps n * d < 2^28."""
    m = 0 if d == 1 else -(-(1 << 32) // d)
    n = np.unique(np.concatenate([np.arange(4096), np.random.default_rng(d).integers(0, (1 << 28) // d, 4096),
                                  [(1 << 28) // d - 1]])).astype(np.uint64)
    got = n if d == 1 else (n * np.uint64(m)) >> np.uint64(32)
    np.testing.assert_array_equal(got, n // np.uint64(d))


def ldmatrix_x4(xs, addr):
    """ldmatrix.x4: lanes 8m .. 8m+7 name the eight 16-byte rows of matrix m;
    lane l receives, in register m, row l // 4 of matrix m, elements
    2 * (l % 4) and + 1: (32, 4, 2)."""
    lanes = np.arange(32)
    rows = np.stack([addr[8 * m + lanes // 4] for m in range(4)], 1) + 2 * (lanes % 4)[:, None]
    return np.stack([xs[rows], xs[rows + 1]], -1)


def mma(acc, af, bf):
    """mma.sync m16n8k16 from the PTX fragment layouts: lane (gq, tq) holds
    A[gq(+8), 2tq(+1)(+8)] and B[2tq(+1)(+8), gq]; D rows gq / gq + 8,
    columns 2tq, 2tq + 1. Every element of A and B is held exactly once."""
    lanes = np.arange(32)
    gq, tq = lanes >> 2, lanes & 3
    a = np.full((16, 16), np.nan)
    b = np.full((16, 8), np.nan)
    for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in range(2):
            assert np.isnan(a[gq + dr, 2 * tq + dc + e]).all()
            a[gq + dr, 2 * tq + dc + e] = af[:, reg, e]
    for reg in range(2):
        for e in range(2):
            assert np.isnan(b[2 * tq + 8 * reg + e, gq]).all()
            b[2 * tq + 8 * reg + e, gq] = bf[:, reg, e]
    assert not np.isnan(a).any() and not np.isnan(b).any()
    d = a @ b
    for q in range(4):
        acc[:, q] += d[gq + 8 * (q >> 1), 2 * tq + (q & 1)]


def emulate_narrow(x, w, bias, act, leak=0.2, x_addr=0):
    """narrow_transpose_kernel over every block, from its shared-memory
    layout and fragment addresses: the (B, 2H, 2W, Cout) output."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    p = narrow_plan(h, wd, cin, cout)
    v = 8 if cin % 8 == 0 and x_addr % 16 == 0 else 1
    ntiles, w2 = p.np // 8, wd + 2
    lanes = np.arange(32)
    gq, tq = lanes >> 2, lanes & 3
    out = np.full(bsz * 4 * h * wd * cout, np.nan)
    out_n = np.zeros(out.size, dtype=int)
    # 2. The weights, as every block places them: zeros, then one HWIO row
    # (kh, kw, ci) of Cout values at a time.
    ws = np.zeros(4 * p.np * p.ws)
    ws_n = np.zeros(ws.size, dtype=int)
    wflat = w.numpy().reshape(16 * cin, cout)
    for r in range(16 * cin):
        kk, ci = divmod(r, cin)
        kh, kw = kk >> 2, kk & 3
        dst = ((kh & 1) * 2 + (kw & 1)) * p.np * p.ws + ((kh >> 1) * 2 + (kw >> 1)) * p.cp + ci
        ws[dst + np.arange(cout) * p.ws] = wflat[r]
        ws_n[dst + np.arange(cout) * p.ws] += 1
    assert ws_n.max() == 1 and ws_n.sum() == 16 * cin * cout
    for b in range(bsz):
        for band in range(-(-h // p.rows)):
            a0 = band * p.rows
            rows = min(p.rows, h - a0)
            # 1. The band with its halo: every slot written once.
            xs = np.full((p.rows + 2) * w2 * p.cs, np.nan)
            xs_n = np.zeros(xs.size, dtype=int)
            i = np.arange((rows + 2) * w2 * (p.cp // v))
            pix, c0 = i // (p.cp // v), (i % (p.cp // v)) * v
            s, col = pix // w2, pix % w2
            ih, iw = a0 - 1 + s, col - 1
            inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd) & (c0 < cin)
            for j in range(v):
                src = x[b].numpy()[np.clip(ih, 0, h - 1), np.clip(iw, 0, wd - 1),
                                   np.minimum(c0 + j, cin - 1)]
                xs[pix * p.cs + c0 + j] = np.where(inside, src, 0.0)
                np.add.at(xs_n, pix * p.cs + c0 + j, 1)
            used = np.zeros(xs.size, dtype=bool)
            for s_ in range(rows + 2):
                for c_ in range(w2):
                    used[(s_ * w2 + c_) * p.cs:(s_ * w2 + c_) * p.cs + p.cp] = True
            assert (xs_n[used] == 1).all() and (xs_n[~used] == 0).all()
            # 3. The warps' GEMMs.
            os_ = np.full(4 * p.rows * wd * cout, np.nan)
            os_n = np.zeros(os_.size, dtype=int)
            pp = rows * wd
            mt = -(-pp // 16)
            lrow, lk = (lanes & 7) + 8 * ((lanes >> 3) & 1), 8 * (lanes >> 4)
            for warp in range(8):
                phase = warp & 3
                pr, pc = phase >> 1, phase & 1
                wph = phase * p.np * p.ws + 2 * tq
                for j0 in range(warp >> 2, mt, 2 * MPW):
                    tiles = [j0 + 2 * i for i in range(MPW) if j0 + 2 * i < mt]
                    acc = np.zeros((len(tiles), ntiles, 32, 4))
                    base = []
                    for j in tiles:
                        q = np.minimum(16 * j + lrow, pp - 1)
                        base.append(((q // wd + pr) * w2 + q % wd + pc) * p.cs + lk)
                    for tap in range(4):
                        toff = ((tap >> 1) * w2 + (tap & 1)) * p.cs
                        for c16 in range(0, p.cp, 16):
                            k = tap * p.cp + c16
                            bfr = []
                            for t in range(ntiles):
                                bp = wph + (t * 8 + gq) * p.ws + k
                                bfr.append(np.stack([np.stack([ws[bp], ws[bp + 1]], -1),
                                                     np.stack([ws[bp + 8], ws[bp + 9]], -1)], 1))
                            for ii in range(len(tiles)):
                                af = ldmatrix_x4(xs, base[ii] + toff + c16)
                                for t in range(ntiles):
                                    mma(acc[ii, t], af, bfr[t])
                    # 4a. The float32 accumulators into the staged band.
                    for ii, j in enumerate(tiles):
                        for hh in range(2):
                            q = 16 * j + gq + 8 * hh
                            ok = q < pp
                            al, bc = q // wd, q % wd
                            o = ((2 * al + pr) * 2 * wd + 2 * bc + pc) * cout
                            for t in range(ntiles):
                                for e2 in range(2):
                                    nn = t * 8 + 2 * tq + e2
                                    m = ok & (nn < cout)
                                    os_[(o + nn)[m]] = acc[ii, t, m, 2 * hh + e2]
                                    np.add.at(os_n, (o + nn)[m], 1)
            n_out = 4 * rows * wd * cout
            assert (os_n[:n_out] == 1).all() and (os_n[n_out:] == 0).all()
            # 4b. Bias and activation, 8 consecutive outputs per thread and
            # step, into output rows 2*a0 .. 2*(a0+rows)-1.
            ob = (b * 2 * h + 2 * a0) * 2 * wd * cout
            for tid in range(NT):
                for e0 in range(tid * 8, n_out, NT * 8):
                    q = np.arange(e0, min(e0 + 8, n_out))
                    n = (e0 % cout + np.arange(q.size)) % cout
                    val = torch.from_numpy(os_[q] + bias.numpy()[n].astype(np.float64))
                    out[ob + q] = apply_act(val, act, leak).numpy()
                    out_n[ob + q] += 1
    assert (out_n == 1).all()
    return torch.from_numpy(out.reshape(bsz, 2 * h, 2 * wd, cout).astype(np.float32))


# (x shape, Cout, act, x address): the narrow mainloop at dec_0's channels
# on a small plane, bands that do not divide H, Cin copied by channel (20),
# Cout 16 (two n-tiles), and a misaligned x (copies by channel).
NARROW = [
    ((2, 4, 8, 64), 3, "tanh", 0),
    ((3, 10, 16, 20), 3, "tanh", 0),
    ((2, 7, 9, 16), 16, "lrelu", 0),
    ((1, 3, 5, 8), 3, "relu", 8),
]


@pytest.mark.parametrize("x_shape,cout,act,x_addr", NARROW)
def test_narrow_emulation_matches_plain_and_jax(x_shape, cout, act, x_addr):
    assert transpose_path(1, x_shape[3], cout, 0, x_shape[1], x_shape[2]) == "narrow"
    x, w, _, bias = rand_inputs(x_shape, cout, "none")
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias)
    got = emulate_narrow(tx, tw, tb, act, x_addr=x_addr).numpy()
    want = K.conv_transpose_norm_act_plain(tx, tw, None, tb, kind="none", act=act).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle(x, w, None, bias, "none", 32, act), **TOL)
    if x_shape[0] <= 2:
        pallas = P.conv_transpose_norm_act(jnp.asarray(x), jnp.asarray(w), None, jnp.asarray(bias),
                                           kind="none", act=act)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_wrapper_counts_and_scratch_on_cpu_stay_untouched():
    """On the CPU the wrapper takes the plain version: no launch counted in
    either table, whatever mainloop the card would take."""
    before = (dict(K.LAUNCHES), dict(K.LAUNCHES_BY_MAINLOOP))
    x, w, _, bias = rand_inputs((1, 4, 4, 8), 3, "none")
    K.conv_transpose_norm_act(torch.from_numpy(x), torch.from_numpy(w), None, torch.from_numpy(bias),
                              kind="none", act="tanh")
    assert (K.LAUNCHES, K.LAUNCHES_BY_MAINLOOP) == before
    assert set(K.LAUNCHES_BY_MAINLOOP) == {
        "conv_norm_act:fma", "conv_norm_act:wmma", "conv_norm_act:wgmma",
        "conv_transpose_norm_act:fma", "conv_transpose_norm_act:wmma",
        "conv_transpose_norm_act:wgmma", "conv_transpose_norm_act:narrow"}


@pytest.mark.parametrize("bm,bn", [(64, 64), (64, 128), (64, 256), (128, 64), (128, 128)])
def test_transposed_ring_fits(bm, bn):
    """Shape<BM, BN, true>: three stages for every transposed tile; the ring
    fits a block (two, but for 64 x 256; three for 128 x 64 and 64 x 128), and
    the epilogue's float32 tile fits the ring."""
    wn, _ = stage_shape(bm, bn)
    ring = 3 * (bm + bn) * BK * 2
    per_sm = (232448 - 1024) // (ring + 1024 + 1024)
    assert per_sm >= {(64, 256): 1, (64, 128): 3, (128, 64): 3}.get((bm, bn), 2)
    assert bm * (bn + 4) * 4 <= ring and wn in (32, 64, 128)
