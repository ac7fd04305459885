// Fused k=4 / stride-2 SAME conv-transpose -> GroupNorm (or bias only) ->
// affine -> activation.
//
// Replaces the TPU kernel of action_conditioned_gans_tpu/ops/pallas/conv.py
// (conv_transpose_norm_act: fwd_pallas / _kernel_t), which computes the four
// 2x2 subpixel-phase convs into a phase-tiled (H*W, 4*Cout) accumulator,
// keys the GroupNorm statistics by ch % Cout and leaves the depth-to-space
// shuffle to the host.
//
// What bounds it on an H100: each phase is a GEMM of depth 4*Cin (256 to
// 1024 at the generator's widths), far above the card's FLOP/byte ridge, so
// the bound is operations. bfloat16 runs on the tensor cores through WMMA
// from one shared-memory stage fed by scalar gathers; TMA-fed stages and
// wgmma are the next step. The grid's z axis walks (sample, phase), so a
// tile never mixes phases and reads one phase kernel w[2dy+r, 2dx+c]
// straight from the HWIO weights. Each result is written straight to its
// depth-to-space position in NHWC, which removes the host shuffle and makes
// the ch % Cout keying of the statistics automatic. The 3-channel output
// layer takes a narrow 128x16 tile. GroupNorm runs as the deterministic
// partial-sum design in conv_common.cuh.
#include "conv_common.cuh"

extern "C" int acg_tile_rows(int bf16, int cout) { return acg::tile_rows(bf16, cout); }

extern "C" int acg_conv_transpose_norm_act(const void* x, const void* w, const void* scale,
                                           const void* bias, void* out, void* y, void* psum,
                                           void* psq, void* stats, int bf16, int B, int H,
                                           int W, int Cin, int Cout, int group_norm,
                                           int groups, float eps, int act, float leak,
                                           void* stream) {
  acg::Geom g;
  g.B = B; g.H = H; g.W = W; g.Cin = Cin;
  g.OH = 2 * H; g.OW = 2 * W; g.Cout = Cout;
  g.KH = 4; g.KW = 4; g.stride = 2; g.pad_h = 0; g.pad_w = 0;
  g.PH = H; g.PW = W; g.phases = 4;
  g.K = 4 * Cin;
  g.tiles = 0;  // set by the launcher
  return acg::launch_conv_norm_act<true>(g, bf16, x, w, scale, bias, out, y, psum, psq, stats,
                                         group_norm, groups, eps, act, leak,
                                         (cudaStream_t)stream);
}
