// Fused k=4 / stride-2 SAME conv-transpose -> GroupNorm (or bias only) ->
// affine -> activation.
//
// Replaces the TPU kernel of action_conditioned_gans_tpu/ops/pallas/conv.py
// (conv_transpose_norm_act: fwd_pallas / _kernel_t), which computes the four
// 2x2 subpixel-phase convs into a phase-tiled (H*W, 4*Cout) accumulator,
// keys the GroupNorm statistics by ch % Cout and leaves the depth-to-space
// shuffle to the host. Here each result is written straight to its
// depth-to-space position in NHWC (conv_common.cuh's out_offset), which
// removes the host shuffle and makes the ch % Cout keying automatic.
//
// What bounds it on an H100, and the mainloop each call takes (path below):
//   wgmma   bfloat16, Cin % 4 == 0, Cout % 64 == 0 (dec_3 .. dec_1 of the
//           presets): each phase is a GEMM of depth 4*Cin (512 to 2048),
//           far above the card's FLOP/byte ridge, so the bound is
//           operations. Kernel 1's wgmma ring (conv_wgmma.cuh) with
//           TRANSPOSE = true: the grid's z axis walks (sample, phase), a
//           tile never mixes phases, and B is the phase kernel
//           w[2dy+r, 2dx+c] packed K-major per phase.
//   narrow  bfloat16, Cout <= 16, no GroupNorm (every preset's dec_0, 3
//           channels): bound by bytes; one block per band of input rows
//           reads x once for all four phases (conv_transpose_narrow.cuh).
//   wmma    the other bfloat16 calls on conv_common.cuh's WMMA tiles: Cout
//           no multiple of 64, and GroupNorm with Cout <= 16 on the narrow
//           128x16 tile (no preset layer; the edge shape edge_t_gn8 of
//           chip_smoke.py).
//   fma     float32 on the CUDA cores (full float32 products).
// GroupNorm runs as the deterministic partial-sum design of conv_common.cuh,
// one slot per (phase, row tile) of a sample. A launch that fails returns
// its error; nothing falls back to another mainloop.
#include "conv_transpose_narrow.cuh"

namespace {

// Values of acg_conv_transpose_path: which mainloop a call takes.
constexpr int PATH_FMA = 0, PATH_WMMA = 1, PATH_WGMMA = 2, PATH_NARROW = 3;

int path(int bf16, int cin, int cout, int group_norm, int h, int w, const void* x) {
  if (!bf16) return PATH_FMA;
  if (!group_norm && acg::narrow::fits(h, w, cin, cout)) return PATH_NARROW;
  return cout % 64 == 0 && acg::wg::wgmma_av(cin, x) ? PATH_WGMMA : PATH_WMMA;
}

// Row tiles of one (sample, phase) plane of H*W rows. The FMA and WMMA
// launcher (conv_common.cuh) derives the same count from acg::tile_rows.
int phase_tiles(int bf16, int cin, int cout, int group_norm, int h, int w, const void* x) {
  const int p = path(bf16, cin, cout, group_norm, h, w, x);
  if (p == PATH_NARROW) return 0;
  const int bm = p == PATH_WGMMA ? acg::wg::wgmma_bm(h * w) : acg::tile_rows(bf16, cout);
  return (h * w + bm - 1) / bm;
}

}  // namespace

extern "C" int acg_conv_transpose_path(int bf16, int cin, int cout, int group_norm, int h, int w,
                                       const void* x) {
  return path(bf16, cin, cout, group_norm, h, w, x);
}

// The one source of the GroupNorm slot count: 4 phases x row tiles per
// sample; psum and psq hold B * slots * Cout floats each. 0 on the narrow
// path, which takes no GroupNorm.
extern "C" int acg_conv_transpose_tiles(int bf16, int cin, int cout, int group_norm, int h, int w,
                                        const void* x) {
  return 4 * phase_tiles(bf16, cin, cout, group_norm, h, w, x);
}

// w is HWIO (4, 4, Cin, Cout). wt is scratch for the wgmma mainloop's packed
// (4, Cout, 4*Cin) weights, 16*Cin*Cout bfloat16 (null on the other paths).
extern "C" int acg_conv_transpose_norm_act(const void* x, const void* w, void* wt,
                                           const void* scale, const void* bias, void* out,
                                           void* y, void* psum, void* psq, void* stats,
                                           int bf16, int B, int H, int W, int Cin, int Cout,
                                           int group_norm, int groups, float eps, int act,
                                           float leak, void* stream) {
  const auto s = (cudaStream_t)stream;
  const int p = path(bf16, Cin, Cout, group_norm, H, W, x);
  if (p == PATH_NARROW)
    return acg::narrow::launch(x, w, bias, out, B, H, W, Cin, Cout, act, leak, s);
  acg::Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin;
  g.OH = 2 * H; g.OW = 2 * W; g.Cout = Cout;
  g.KH = 4; g.KW = 4; g.stride = 2; g.pad_h = 0; g.pad_w = 0;
  g.PH = H; g.PW = W; g.phases = 4;
  g.K = 4 * Cin;
  g.tiles = phase_tiles(bf16, Cin, Cout, group_norm, H, W, x);
  if (p != PATH_WGMMA)
    return acg::launch_conv_norm_act<true>(g, bf16, x, w, scale, bias, out, y, psum, psq, stats,
                                           group_norm, groups, eps, act, leak, s);
  namespace wg = acg::wg;
  const int bm = wg::wgmma_bm(H * W);
  return wg::launch_conv_norm_act<true>(g, bm, wg::wgmma_bn(Cout, bm, B * g.phases * g.tiles),
                                        wg::wgmma_av(Cin, x), x, w, wt, scale, bias, out, y,
                                        psum, psq, stats, group_norm, groups, eps, act, leak, s);
}
