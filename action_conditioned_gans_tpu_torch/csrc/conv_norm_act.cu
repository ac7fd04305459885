// Fused SAME conv -> GroupNorm (or bias only) -> affine -> activation.
//
// Replaces the TPU kernel of action_conditioned_gans_tpu/ops/pallas/conv.py
// (conv_norm_act: fwd_pallas / _kernel), which rewrites a k=4 / stride-2 conv
// as a k'=2 conv over the space-to-depth input and keeps one sample's output
// resident in VMEM for the GroupNorm epilogue. The space-to-depth rewrite is
// not needed here: the kernel indexes the strided window directly (the same
// function).
//
// What bounds it on an H100: at the models' widths the conv is an implicit
// GEMM of depth K = KH*KW*Cin (1024 to 4644 on the layers with Cin >= 64)
// whose arithmetic intensity is far above the card's ~295 FLOP/byte ridge,
// so the bound is operations: the tensor cores' rate. Those layers (bfloat16,
// Cin % 4 == 0, Cout % 64 == 0) take the Hopper mainloop of conv_wgmma.cuh:
// wgmma, the only instruction that reaches that rate, reading a 3-4 stage
// ring of 128-byte-swizzled tiles that cp.async fills with the im2col gather
// while the previous stage multiplies. Every other call keeps the mainloops
// of conv_common.cuh: float32 on the CUDA cores (FMA, full float32 products);
// bfloat16 with Cout <= 16 on the narrow 128x16 WMMA tile; the first layers
// with Cin 3 or 10 on the 64x64 WMMA tile, whose gather moves single
// channels (those layers are bound by bytes: 0.8 of config1's 27.8 GFLOP).
//
// The GroupNorm epilogue, which the TPU kernel fits in VMEM, does not fit one
// block's shared memory, so every mainloop ends in conv_common.cuh's
// tile_epilogue and the deterministic partial-sum passes of gn_common.cuh.
#include "conv_wgmma.cuh"

namespace {

// Values of acg_conv_path: which mainloop a call takes.
constexpr int PATH_FMA = 0, PATH_WMMA = 1, PATH_WGMMA = 2;

int path(int bf16, int cin, int cout, const void* x) {
  if (!bf16) return PATH_FMA;
  return cout % 64 == 0 && acg::wg::wgmma_av(cin, x) ? PATH_WGMMA : PATH_WMMA;
}

// Row tiles per sample. The FMA and WMMA launcher (conv_common.cuh) derives
// the same count from acg::tile_rows.
int tiles(int bf16, int cin, int cout, int pixels, const void* x) {
  const int bm = path(bf16, cin, cout, x) == PATH_WGMMA ? acg::wg::wgmma_bm(pixels)
                                                        : acg::tile_rows(bf16, cout);
  return (pixels + bm - 1) / bm;
}

}  // namespace

extern "C" int acg_conv_path(int bf16, int cin, int cout, const void* x) {
  return path(bf16, cin, cout, x);
}

// The one source of the tile count: psum and psq hold B * tiles * Cout
// floats each.
extern "C" int acg_conv_tiles(int bf16, int cin, int cout, int pixels, const void* x) {
  return tiles(bf16, cin, cout, pixels, x);
}

// w is HWIO. wt is scratch for the wgmma mainloop's packed (Cout, K) weights,
// KH*KW*Cin*Cout bfloat16 (null on the other paths).
extern "C" int acg_conv_norm_act(const void* x, const void* w, void* wt, const void* scale,
                                 const void* bias, void* out, void* y, void* psum, void* psq,
                                 void* stats, int bf16, int B, int H, int W, int Cin, int OH,
                                 int OW, int Cout, int KH, int KW, int stride, int pad_h,
                                 int pad_w, int group_norm, int groups, float eps, int act,
                                 float leak, void* stream) {
  acg::Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin;
  g.OH = OH; g.OW = OW; g.Cout = Cout;
  g.KH = KH; g.KW = KW; g.stride = stride; g.pad_h = pad_h; g.pad_w = pad_w;
  g.PH = OH; g.PW = OW; g.phases = 1;
  g.K = KH * KW * Cin;
  g.tiles = tiles(bf16, Cin, Cout, OH * OW, x);
  if (path(bf16, Cin, Cout, x) != PATH_WGMMA)
    return acg::launch_conv_norm_act<false>(g, bf16, x, w, scale, bias, out, y, psum, psq, stats,
                                            group_norm, groups, eps, act, leak,
                                            (cudaStream_t)stream);
  namespace wg = acg::wg;
  const int bm = wg::wgmma_bm(OH * OW);
  return wg::launch_conv_norm_act<false>(g, bm, wg::wgmma_bn(Cout, bm, B * g.tiles),
                                         wg::wgmma_av(Cin, x), x, w, wt, scale, bias, out, y,
                                         psum, psq, stats, group_norm, groups, eps, act, leak,
                                         (cudaStream_t)stream);
}
