// Two-tier FAST-9/16 score maps: every level of a stereo frame's two
// pyramids in one launch.
//
// Replaces the Pallas TPU kernel dspslam_tpu/ops/pallas/fast_kernel.py:41
// (`_kernel`, launched by `fast_score_map_pallas`) and computes exactly what
// it computes, per map of f32 (h, w) images:
//
//  * the 16 Bresenham-circle neighbours (dx, dy) of frontend/orb.py's
//    _CIRCLE give d = neighbour - center, the image zero-padded outside;
//  * a corner at threshold t is a circular run of >= 9 neighbours with
//    d > t (bright) or d < -t (dark);
//  * the score is sum |d| over all 16 neighbours (in neighbour order) at
//    t_lo corners, plus `boost` at t_hi corners, 0 elsewhere.
//
// The TPU kernel streamed 48-row blocks of one image with an 8-row DMA
// halo; a frame took one call per level and image. Here one launch covers up
// to MAX_MAPS maps of any shapes (the 8 levels x 2 images of a KITTI frame
// are 16): the maps' descriptors (source, output offset, shape, first tile)
// travel by value in the kernel's parameters, the grid is the flat list of
// all maps' 32 x 16 tiles, and each block finds its map by a binary search
// over the first-tile prefix table, then stages its tile plus a 3-pixel halo
// (38 x 22 floats), zero-filled outside its own image, in shared memory. A
// thread owns two pixels of a column, 8 rows apart.
//
// What bounds it on this card: every pixel needs 16 subtractions, 32
// low-tier compares and the run test of its two words (a popcount and a
// compare each), 52 lane operations; only a low-tier corner also needs the
// 16 |d| accumulations and 32 high-tier compares (48 more). At 33.5 T lane
// operations/s (one warp instruction per scheduler per clock) that is less
// time than the 8 bytes of HBM traffic per pixel at 3.35 TB/s whenever
// fewer than 58% of the pixels are corners, so it is bound by bytes:
// 1.1 us at 376 x 1241 and 6.9 us for a KITTI frame's 2.9 M pixels. The
// launch itself (a few us of host time) outweighs that, hence one launch per
// frame. To keep the instructions near the work:
//  * the bright / dark words of the low tier are built by funnel shifts of
//    the sign bits of t - d and t + d (2 FADD + 2 SHF per neighbour; a sign
//    is set iff d > t, resp. d < -t, exactly, with no flush to zero);
//  * a word with fewer than 9 bits set cannot hold a run (one POPC);
//  * the run test ANDs 4 shifts of the doubled word (runs of 2, 4, 8, 9);
//  * |d| is summed, and the high tier tested, only at low-tier corners
//    (the high tier implies the low one when t_hi >= t_lo; otherwise every
//    pixel tests both).
// Bit-exactness with the plain version (kernels/fast_score.py): d and the
// sum are the same IEEE operations in the same order (`__fadd_rn`).

#include <cstdint>
#include <cuda_runtime.h>

namespace dsp_fast {

constexpr int TX = 32;  // threads per block: TX x TY
constexpr int TY = 8;
constexpr int PY = 2;   // pixels per thread, TY rows apart
constexpr int TILE_W = TX;
constexpr int TILE_H = TY * PY;
constexpr int R = 3;
constexpr int SW = TILE_W + 2 * R;  // 38
constexpr int SH = TILE_H + 2 * R;  // 22
constexpr int MAX_MAPS = 16;

struct MapDesc {
  const float* src;  // (h, w) contiguous
  long long out;     // offset of the map in the output buffer
  int h, w, tiles_x, first_tile;
};
struct MapTable {
  MapDesc map[MAX_MAPS];
  int count;
};

// bit p of AND_{s=0..8} (x >> s), x the doubled 16-bit word: a run of 9
__device__ __forceinline__ bool has_run9(uint32_t word16) {
  const uint32_t x = __byte_perm(word16, 0u, 0x1010);  // word16 | word16 << 16
  uint32_t y = x & (x >> 1);
  y &= y >> 2;
  y &= y >> 4;
  y &= x >> 8;
  return (y & 0xFFFFu) != 0u;
}

__device__ __forceinline__ bool corner(uint32_t bright, uint32_t dark) {
  return (__popc(bright) >= 9 && has_run9(bright)) || (__popc(dark) >= 9 && has_run9(dark));
}

// w <- (w << 1) | sign bit of v
__device__ __forceinline__ uint32_t push_sign(uint32_t w, float v) {
  return __funnelshift_l(__float_as_uint(v), w, 1);
}

__global__ void __launch_bounds__(TX* TY)
    fast_score_maps_kernel(const __grid_constant__ MapTable table, float* __restrict__ out,
                           float t_lo, float t_hi, float boost) {
  __shared__ float tile[SH][SW];
  const int block = blockIdx.x;
  int m = 0;
#pragma unroll
  for (int step = MAX_MAPS / 2; step > 0; step >>= 1)
    if (m + step < table.count && block >= table.map[m + step].first_tile) m += step;
  const float* __restrict__ src = table.map[m].src;
  const int h = table.map[m].h, w = table.map[m].w;
  const int t = block - table.map[m].first_tile;
  const int by = t / table.map[m].tiles_x;
  const int bx = t - by * table.map[m].tiles_x;
  float* __restrict__ dst = out + table.map[m].out;

  const int x0 = bx * TILE_W - R, y0 = by * TILE_H - R;
  for (int ly = threadIdx.y; ly < SH; ly += TY) {
    const int gy = y0 + ly;
    const bool row_in = gy >= 0 && gy < h;
    for (int lx = threadIdx.x; lx < SW; lx += TX) {
      const int gx = x0 + lx;
      tile[ly][lx] = row_in && gx >= 0 && gx < w ? src[static_cast<size_t>(gy) * w + gx] : 0.0f;
    }
  }
  __syncthreads();

  const bool hi_alone = t_hi < t_lo;
  const int x = bx * TILE_W + threadIdx.x;
#pragma unroll
  for (int py = 0; py < PY; ++py) {
    const int ty = threadIdx.y + TY * py;
    const int y = by * TILE_H + ty;
    // threads past the image edge compute on the zero-filled tile too and
    // only skip the store: no branch around the pixel's work
    const float* p = &tile[ty + R][threadIdx.x + R];
    const float c = p[0];
    float d[16];
    uint32_t bright = 0u, dark = 0u;
    // _CIRCLE of frontend/orb.py, (dx, dy), clockwise from the top
#define NB(k, DX, DY)                      \
  d[k] = p[(DY) * SW + (DX)] - c;          \
  bright = push_sign(bright, t_lo - d[k]); \
  dark = push_sign(dark, t_lo + d[k]);
    NB(0, 0, -3) NB(1, 1, -3) NB(2, 2, -2) NB(3, 3, -1)
    NB(4, 3, 0) NB(5, 3, 1) NB(6, 2, 2) NB(7, 1, 3)
    NB(8, 0, 3) NB(9, -1, 3) NB(10, -2, 2) NB(11, -3, 1)
    NB(12, -3, 0) NB(13, -3, -1) NB(14, -2, -2) NB(15, -1, -3)
#undef NB
    const bool lo = corner(bright, dark);
    float score = 0.0f;
    if (lo || hi_alone) {
      uint32_t bright_hi = 0u, dark_hi = 0u;
      float abs_sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        abs_sum = __fadd_rn(abs_sum, fabsf(d[k]));
        bright_hi = push_sign(bright_hi, t_hi - d[k]);
        dark_hi = push_sign(dark_hi, t_hi + d[k]);
      }
      if (lo) score = abs_sum;
      if (corner(bright_hi, dark_hi)) score = __fadd_rn(score, boost);
    }
    if (x < w && y < h) dst[static_cast<size_t>(y) * w + x] = score;
  }
}

}  // namespace dsp_fast

using dsp_fast::MapTable;

// The tiling the caller's map table must use: tile width and height in
// pixels, and the most maps one launch takes.
extern "C" void dsp_fast_score_geometry(int* tile_w, int* tile_h, int* max_maps) {
  *tile_w = dsp_fast::TILE_W;
  *tile_h = dsp_fast::TILE_H;
  *max_maps = dsp_fast::MAX_MAPS;
}

// `table` (host memory) holds `table->count` maps whose tiles are numbered
// 0 .. n_tiles - 1 in map order; every source and `out` are f32 device
// buffers. Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int dsp_fast_score_maps(const MapTable* table, int n_tiles, float* out, float t_lo,
                                   float t_hi, float boost, void* stream) {
  using namespace dsp_fast;
  if (table->count < 1 || table->count > MAX_MAPS) return (int)cudaErrorInvalidValue;
  fast_score_maps_kernel<<<n_tiles, dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      *table, out, t_lo, t_hi, boost);
  return (int)cudaGetLastError();
}
