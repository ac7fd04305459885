// Fused SAME conv -> GroupNorm (or bias only) -> affine -> activation.
//
// Replaces the TPU kernel of action_conditioned_gans_tpu/ops/pallas/conv.py
// (conv_norm_act: fwd_pallas / _kernel), which rewrites a k=4 / stride-2 conv
// as a k'=2 conv over the space-to-depth input and keeps one sample's output
// resident in VMEM for the GroupNorm epilogue.
//
// What bounds it on an H100: at the generator's widths the conv is a GEMM of
// depth K = 16*Cin (48 to 2340) with arithmetic intensity far above the
// card's ~295 FLOP/byte ridge, so the bound is operations. bfloat16 runs on
// the tensor cores through WMMA from one shared-memory stage fed by scalar
// gathers, which keeps it well above that bound; TMA-fed stages and wgmma
// are the next step. The space-to-depth rewrite is not needed here: the
// kernel indexes the strided window directly (the same function). The
// GroupNorm epilogue, which the TPU kernel fits in VMEM, does not fit one
// block's shared memory, so it runs as the deterministic partial-sum design
// in conv_common.cuh.
#include "conv_common.cuh"

extern "C" int acg_tile_rows(int bf16, int cout) { return acg::tile_rows(bf16, cout); }

extern "C" int acg_conv_norm_act(const void* x, const void* w, const void* scale,
                                 const void* bias, void* out, void* y, void* psum,
                                 void* psq, void* stats, int bf16, int B, int H, int W,
                                 int Cin, int OH, int OW, int Cout, int KH, int KW,
                                 int stride, int pad_h, int pad_w, int group_norm,
                                 int groups, float eps, int act, float leak, void* stream) {
  acg::Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin;
  g.OH = OH; g.OW = OW; g.Cout = Cout;
  g.KH = KH; g.KW = KW; g.stride = stride; g.pad_h = pad_h; g.pad_w = pad_w;
  g.PH = OH; g.PW = OW; g.phases = 1;
  g.K = KH * KW * Cin;
  g.tiles = 0;  // set by the launcher
  return acg::launch_conv_norm_act<false>(g, bf16, x, w, scale, bias, out, y, psum, psq, stats,
                                          group_norm, groups, eps, act, leak,
                                          (cudaStream_t)stream);
}
