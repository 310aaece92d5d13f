// Fixed-K greedy non-maximum suppression over a precomputed overlap matrix,
// all k rounds in one launch.
//
// Replaces no TPU kernel. The JAX package runs this loop as a
// `lax.fori_loop` inside jit (dspslam_tpu/detect/maskrcnn.py `greedy_nms`,
// dspslam_tpu/detect/pointpillars.py `select_detections`): one XLA while
// loop, no host work per round. The port's eager loop
// (kernels/greedy_nms.py `greedy_suppress_plain`) launches ~9 small ops a
// round, and Mask R-CNN runs 1100 rounds a keyframe, so the host's enqueue,
// not the card, set the detectors' pace. This kernel does what the loop
// does, round for round and bit for bit:
//
//  * masked = alive ? score : dead; the pick j is its maximum, the lowest
//    index among equal values, NaN above every number (torch.argmax's
//    order);
//  * ok = masked[j] > keep_thresh (>= when keep_inclusive), in f32;
//  * an ok pick kills every candidate i with iou[j * n + i] > iou_thresh;
//    the pick's own slot dies in every round, ok or not;
//  * a round with no live candidate left picks index 0 at `dead` (every
//    slot holds `dead`), as the loop's argmax does.
//
// What bounds it on this card: each round depends on the last one's pick,
// so the k rounds are a serial chain. One round is a block-wide argmax over
// n values (a warp shuffle reduction, one barrier, a second shuffle
// reduction over the warps' winners) and, for an ok pick, one dependent read
// of row j (4n bytes, coalesced) from L2 or device memory. Its latency, not
// its bytes or operations (n * (k + 1) * 4 bytes over a call), sets the
// time: about a microsecond a round. The design keeps everything else off
// that chain:
//  * one block of up to 1024 threads; thread t owns candidates t, t + T,
//    t + 2T, ... (T = blockDim.x) and keeps their masked scores in
//    registers, so suppression touches no shared memory and needs no
//    barrier: a thread updates only its own slots;
//  * every warp reduces the warps' winners itself, from a double-buffered
//    shared array, so a round has one barrier;
//  * candidates that already hold `dead` skip the row read (suppressing
//    them changes nothing).
// Up to MAX_ITEMS candidates a thread: n <= 8192.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace dsp_nms {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_ITEMS = 8;
constexpr int MAX_N = MAX_THREADS * MAX_ITEMS;

// (va, ia) before (vb, ib) in torch.argmax's order: NaN first, then the
// larger value, then the lower index
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  if (isnan(va)) return !isnan(vb) || ia < ib;
  if (isnan(vb)) return false;
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(MAX_THREADS)
    greedy_nms_kernel(const float* __restrict__ iou, const float* __restrict__ scores, int n, int k,
                      float iou_thresh, float dead, float keep_thresh, int keep_inclusive,
                      long long* __restrict__ picks, float* __restrict__ vals,
                      unsigned char* __restrict__ oks) {
  __shared__ float win_v[2][32];
  __shared__ int win_i[2][32];
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  float v[ITEMS];
#pragma unroll
  for (int t = 0; t < ITEMS; ++t) {
    const int i = t * T + tid;
    v[t] = i < n ? scores[i] : dead;
  }
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int i = t * T + tid;
      if (i < n && before(v[t], i, bv, bi)) {
        bv = v[t];
        bi = i;
      }
    }
    warp_best(bv, bi);
    const int p = r & 1;  // a warp may run a round ahead: rounds alternate buffers
    if (lane == 0) {
      win_v[p][warp] = bv;
      win_i[p][warp] = bi;
    }
    __syncthreads();
    bv = lane < warps ? win_v[p][lane] : -INFINITY;
    bi = lane < warps ? win_i[p][lane] : INT_MAX;
    warp_best(bv, bi);
    const bool ok = keep_inclusive ? bv >= keep_thresh : bv > keep_thresh;
    if (tid == 0) {
      picks[r] = bi;
      vals[r] = bv;
      oks[r] = ok;
    }
    const float* __restrict__ row = iou + static_cast<size_t>(bi) * n;
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int i = t * T + tid;
      if (i < n && (i == bi || (ok && v[t] != dead && row[i] > iou_thresh))) v[t] = dead;
    }
  }
}

}  // namespace dsp_nms

// `iou` (n, n) and `scores` (n,) f32, contiguous, on the device; writes
// picks (k,) int64, vals (k,) f32 and oks (k,) bool (one byte each). One
// block, launched on `stream`. Returns the CUDA error code (0 = ok).
extern "C" int dsp_greedy_nms(const float* iou, const float* scores, int n, int k, float iou_thresh,
                              float dead, float keep_thresh, int keep_inclusive, long long* picks,
                              float* vals, unsigned char* oks, void* stream) {
  using namespace dsp_nms;
  if (n < 1 || n > MAX_N || k < 1) return (int)cudaErrorInvalidValue;
  const int threads = n < MAX_THREADS ? (n + 31) / 32 * 32 : MAX_THREADS;
  const int items = (n + threads - 1) / threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(I)                                                                          \
  case I:                                                                                  \
    greedy_nms_kernel<I><<<1, threads, 0, s>>>(iou, scores, n, k, iou_thresh, dead,        \
                                              keep_thresh, keep_inclusive, picks, vals, oks); \
    break;
  switch (items) {
    LAUNCH(1) LAUNCH(2) LAUNCH(3) LAUNCH(4) LAUNCH(5) LAUNCH(6) LAUNCH(7) LAUNCH(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
