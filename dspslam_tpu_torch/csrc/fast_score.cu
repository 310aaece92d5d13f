// Two-tier FAST-9/16 score map over a batch of zero-padded images.
//
// Replaces the Pallas TPU kernel dspslam_tpu/ops/pallas/fast_kernel.py:41
// (`_kernel`, launched by `fast_score_map_pallas`) and computes exactly what
// it computes, per image of a (B, H, W) float32 batch:
//
//  * the 16 Bresenham-circle neighbours (dx, dy) of frontend/orb.py's
//    _CIRCLE give d = neighbour - center, the image zero-padded outside;
//  * bright / dark bits are packed per tier into one 32-bit word (t_lo in
//    bits 0..15, t_hi in bits 16..31);
//  * a circular run of >= 9 set bits among 16 is found by AND-ing shifts of
//    the doubled 16-bit word: bit p of AND_{s=0..8} (x >> s) is set iff bits
//    p..p+8 are all set;
//  * the score is sum |d| over all 16 neighbours at low-tier corners, plus
//    `boost` at high-tier corners, 0 elsewhere.
//
// The TPU kernel streamed 48-row blocks with an 8-row DMA halo, shapes set
// by the TPU's (8, 128) tiling. Here one thread owns one output pixel: a
// 32 x 8 block stages its tile plus a 3-pixel halo (38 x 14 floats) in
// shared memory, zero-filled outside the image, and each thread reads its 16
// neighbours from there. Words are uint32_t, so no shift sign-extends.
// |d| is summed in neighbour order k = 0..15, as the plain PyTorch version
// (kernels/fast_score.py::fast_score_map_plain) sums it, so both give the
// same bits.
//
// What bounds it on this card: 4 B read and 4 B written per pixel, and the
// instructions each pixel issues. Compiled for sm_90a, the section after the
// barrier is ~390 SASS instructions per pixel, ~170 of them integer or logic
// ones on the ALU pipe (chip_smoke.py counts them from `cuobjdump -sass`).
// The card issues one warp instruction per scheduler per clock, 33.5 T
// lane-instructions/s (the fp32 peak without the FMA's factor 2), and the ALU
// pipe takes half that. At 376 x 1241 that is ~5.5 us of issue against
// ~1.1 us of HBM traffic: the kernel is bound by its instruction count. One
// KITTI stereo frame is 16 level maps (two 8-level pyramids from 376 x 1241
// down to 105 x 346), ~2.9 M pixels, ~34 us of issue; the small levels are a
// few us of work each, so the time per frame is set by the 16 launches as
// much as by the work in them. Fusing levels and images into fewer launches
// is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 3;
constexpr int SW = TX + 2 * R;  // 38
constexpr int SH = TY + 2 * R;  // 14

// _CIRCLE of frontend/orb.py, (dx, dy), clockwise from the top
__constant__ int8_t kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int8_t kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool has_run9(uint32_t word16) {
  uint32_t x = word16 | (word16 << 16);
  uint32_t y = x;
#pragma unroll
  for (int s = 1; s < 9; ++s) y &= x >> s;
  return (y & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(TX * TY)
fast_score_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int H, int W, float t_lo, float t_hi, float boost) {
  __shared__ float tile[SH][SW];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * TX - R;
  const int y0 = blockIdx.y * TY - R;
  for (int i = threadIdx.y * TX + threadIdx.x; i < SH * SW; i += TX * TY) {
    const int ly = i / SW, lx = i - ly * SW;
    const int gy = y0 + ly, gx = x0 + lx;
    tile[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? im[static_cast<size_t>(gy) * W + gx] : 0.0f;
  }
  __syncthreads();

  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + R, cx = threadIdx.x + R;
  const float c = tile[cy][cx];
  const float nt_lo = -t_lo, nt_hi = -t_hi;
  uint32_t bright = 0u, dark = 0u;
  float abs_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = tile[cy + kDy[k]][cx + kDx[k]] - c;
    abs_sum = __fadd_rn(abs_sum, fabsf(d));
    bright |= (d > t_lo ? 1u : 0u) << k;
    bright |= (d > t_hi ? 1u : 0u) << (16 + k);
    dark |= (d < nt_lo ? 1u : 0u) << k;
    dark |= (d < nt_hi ? 1u : 0u) << (16 + k);
  }
  const bool corner_lo = has_run9(bright & 0xFFFFu) || has_run9(dark & 0xFFFFu);
  const bool corner_hi = has_run9(bright >> 16) || has_run9(dark >> 16);
  float score = corner_lo ? abs_sum : 0.0f;
  if (corner_hi) score = __fadd_rn(score, boost);
  out[blockIdx.z * plane + static_cast<size_t>(y) * W + x] = score;
}

}  // namespace

extern "C" int dsp_fast_score(const float* img, float* out, int B, int H, int W,
                              float t_lo, float t_hi, float boost, void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, t_lo, t_hi, boost);
  return static_cast<int>(cudaGetLastError());
}
