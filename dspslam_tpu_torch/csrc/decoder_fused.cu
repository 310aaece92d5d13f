// Fused DeepSDF value + input gradient for the canonical DSP-SLAM decoder
// (64-d code + xyz = 67 inputs, 8 x 512 ReLU layers, the input re-injected
// at layer 4, linear output, final tanh), forward and backward in one launch.
//
// Replaces the Pallas TPU kernel dspslam_tpu/ops/pallas/decoder_kernel.py
// (`_kernel`, launched by `fused_sdf_and_input_grad`). That kernel holds all
// ~7 MB of f32 weights in VMEM next to a 256-row tile; an H100 block has at
// most 227 KB of shared memory, so the design here is different:
//
//  * a block owns TM = 32 rows (16 when 16-row blocks still fit one per SM,
//    i.e. N <= 16 x SMs). Their activations live in ONE shared
//    buffer (32 x 512 f32 = 64 KB): a layer accumulates its whole output in
//    registers, waits for every thread to finish reading the input, then
//    overwrites the buffer in place;
//  * weights stay in L2 (the forward copy plus a transposed copy for the
//    backward, ~15 MB of the card's 50 MB) and stream through two 16-row
//    shared-memory stages, one layer at a time: while the block computes on
//    one stage, 16-byte cp.async copies fill the other. Every packed weight
//    row is zero-padded to a multiple of 32 floats, so a stage is one
//    contiguous, aligned run of memory and needs no column bounds;
//  * the backward needs only the ReLU masks of z0..z7, kept as bits
//    (8 layers x 512 bits per row), not the activations;
//  * the layer-4 re-injection is split as on the TPU: w4h (445 rows) acts on
//    h3 and w4x (67 rows) on the input; in the backward, g4 @ w4x^T is parked
//    in the input tile's buffer (the input is dead by then) and added to the
//    final g0 @ w0^T.
//
// What bounds it on this card: plain f32 FMA on the CUDA cores (no tensor
// cores) with operands read from shared memory. Each thread owns TM / 8 rows
// x 16 columns, so at TM = 32 every k step is 20 shared loads for 64 FMAs,
// and each block re-reads all the weights from L2 per TM rows. wgmma/TF32,
// TMA multicast of the weight stages and persistent blocks are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int IN = 67;       // code 64 + xyz 3
constexpr int HID = 512;
constexpr int NARROW = 445;  // layer-3 width: HID - IN
constexpr int LD_IN = 96;    // packed row lengths: widths padded to 32
constexpr int LD_NARROW = 448;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // a warp owns TM / WARPS rows
constexpr int KC = 16;               // weight rows per shared-memory stage
constexpr int MASK_WORDS = HID / 32;

// Packed parameter layout (floats, in this order). dspslam_tpu_torch/kernels/
// decoder_fused.py::pack_params writes the same order and checks the total
// against dsp_decoder_fused_param_floats(). Matrices are row-major with rows
// padded to a multiple of 32 floats; vectors are padded to a multiple of 4.
//   forward, (in, out): W0 B0 W1 B1 W2 B2 W3 B3 W4H W4X B4 W5 B5 W6 B6 W7 B7 W8 B8
//   backward, (out, in) = torch nn.Linear layout: T0 T1 T2 T3 T4H T4X T5 T6 T7
constexpr long long SZ_W0 = IN * HID, SZ_WH = HID * HID, SZ_W3 = HID * LD_NARROW;
constexpr long long SZ_W4H = NARROW * HID, SZ_W4X = IN * HID;
constexpr long long SZ_T0 = HID * LD_IN, SZ_T3 = NARROW * HID;
constexpr long long SZ_T4H = HID * LD_NARROW, SZ_T4X = HID * LD_IN;
constexpr long long O_W0 = 0;
constexpr long long O_B0 = O_W0 + SZ_W0;
constexpr long long O_W1 = O_B0 + HID;
constexpr long long O_B1 = O_W1 + SZ_WH;
constexpr long long O_W2 = O_B1 + HID;
constexpr long long O_B2 = O_W2 + SZ_WH;
constexpr long long O_W3 = O_B2 + HID;
constexpr long long O_B3 = O_W3 + SZ_W3;
constexpr long long O_W4H = O_B3 + LD_NARROW;
constexpr long long O_W4X = O_W4H + SZ_W4H;
constexpr long long O_B4 = O_W4X + SZ_W4X;
constexpr long long O_W5 = O_B4 + HID;
constexpr long long O_B5 = O_W5 + SZ_WH;
constexpr long long O_W6 = O_B5 + HID;
constexpr long long O_B6 = O_W6 + SZ_WH;
constexpr long long O_W7 = O_B6 + HID;
constexpr long long O_B7 = O_W7 + SZ_WH;
constexpr long long O_W8 = O_B7 + HID;
constexpr long long O_B8 = O_W8 + HID;
constexpr long long O_T0 = O_B8 + 4;
constexpr long long O_T1 = O_T0 + SZ_T0;
constexpr long long O_T2 = O_T1 + SZ_WH;
constexpr long long O_T3 = O_T2 + SZ_WH;
constexpr long long O_T4H = O_T3 + SZ_T3;
constexpr long long O_T4X = O_T4H + SZ_T4H;
constexpr long long O_T5 = O_T4X + SZ_T4X;
constexpr long long O_T6 = O_T5 + SZ_WH;
constexpr long long O_T7 = O_T6 + SZ_WH;
constexpr long long P_TOTAL = O_T7 + SZ_WH;

// shared memory per block: activations | input tile | 2 weight stages |
// ReLU mask bits
constexpr int SMEM_STAGE = KC * HID;
template <int TM>
struct Smem {
  static constexpr int ACT = TM * HID;
  static constexpr int X = TM * IN;
  static constexpr int MASK = 8 * TM * MASK_WORDS;
  static constexpr size_t BYTES =
      sizeof(float) * (ACT + X + 2 * SMEM_STAGE) + sizeof(uint32_t) * MASK;
  static_assert((ACT + X) % 4 == 0, "weight stages must be 16-byte aligned");
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Starts copying `kc` packed weight rows (row length ldb) into a stage.
__device__ __forceinline__ void load_stage(float* stage, const float* src,
                                           int kc, int ldb) {
  const int n4 = (kc * ldb) >> 2;
#pragma unroll
  for (int q = 0; q < SMEM_STAGE / 4 / THREADS; ++q) {
    const int i = threadIdx.x + THREADS * q;
    if (i < n4) cp_async16(stage + 4 * i, src + 4 * i);
  }
  cp_async_commit();
}

// acc[i][j] += sum_k A[row_i, k] * B[k, col_j] for k < K, where row_i =
// warp * RPT + i and col_j = lane + 32 j (j < ldb / 32). A is in shared
// memory (leading dimension lda); B is a packed (K, ldb) row-major matrix in
// global memory, streamed KC rows at a time through the two stages.
// Every thread must call it; it ends with a barrier, so the caller may then
// overwrite A.
template <int RPT, int NJ>
__device__ __forceinline__ void mm_accum(float (&acc)[RPT][NJ], const float* A,
                                         int lda, int K,
                                         const float* __restrict__ B, int ldb,
                                         float* stages) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nj = ldb >> 5;
  const int nstages = (K + KC - 1) / KC;
  load_stage(stages, B, min(KC, K), ldb);
  for (int s = 0; s < nstages; ++s) {
    const int k0 = s * KC;
    const int kc = min(KC, K - k0);
    if (s + 1 < nstages) {
      // the other stage was last read in iteration s - 1, which ended with
      // a barrier
      load_stage(stages + ((s + 1) & 1) * SMEM_STAGE, B + (size_t)(k0 + KC) * ldb,
                 min(KC, K - k0 - KC), ldb);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage s (and the writes that produced A) are visible
    const float* w = stages + (s & 1) * SMEM_STAGE;
    for (int kk = 0; kk < kc; ++kk) {
      float a[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = A[(warp * RPT + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float wv = w[kk * ldb + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // stage s and A are no longer read
  }
}

template <int RPT, int NJ>
__device__ __forceinline__ void zero(float (&acc)[RPT][NJ]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// z = acc + bias; act <- relu(z) (columns < N); mask <- bits of (z > 0).
template <int RPT>
__device__ __forceinline__ void forward_epilogue(float (&acc)[RPT][MASK_WORDS],
                                                 const float* __restrict__ bias,
                                                 int N, float* act,
                                                 uint32_t* mask) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = warp * RPT + i;
#pragma unroll
    for (int j = 0; j < MASK_WORDS; ++j) {
      const int c = lane + 32 * j;
      const float z = c < N ? acc[i][j] + __ldg(bias + c) : 0.f;
      const bool on = z > 0.f;
      const uint32_t bits = __ballot_sync(0xffffffffu, on);
      if (lane == 0) mask[r * MASK_WORDS + j] = bits;
      if (c < N) act[r * HID + c] = on ? z : 0.f;
    }
  }
}

// act <- acc * (z > 0) for columns < N, the mask taken from the forward.
template <int RPT, int NJ>
__device__ __forceinline__ void backward_epilogue(float (&acc)[RPT][NJ], int N,
                                                  float* act,
                                                  const uint32_t* mask) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = warp * RPT + i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < N) {
        const bool on = (mask[r * MASK_WORDS + j] >> lane) & 1u;
        act[r * HID + c] = on ? acc[i][j] : 0.f;
      }
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(THREADS, 1)
    decoder_fused_kernel(const float* __restrict__ x,
                         const float* __restrict__ p, float* __restrict__ sdf,
                         float* __restrict__ grad, int n) {
  constexpr int RPT = TM / WARPS;
  extern __shared__ float smem[];
  float* act = smem;
  float* xs = act + Smem<TM>::ACT;
  float* stages = xs + Smem<TM>::X;
  uint32_t* masks = reinterpret_cast<uint32_t*>(stages + 2 * SMEM_STAGE);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * TM;
  const long long first = row0 * IN;
  const long long last = (long long)n * IN;

  // input tile; rows past n (the ragged last tile) are zeros and never stored
  for (int idx = tid; idx < TM * IN; idx += THREADS)
    xs[idx] = first + idx < last ? __ldg(x + first + idx) : 0.f;

  float acc[RPT][MASK_WORDS];

  // ---- forward: z_l = h_{l-1} W_l + b_l, h_l = relu(z_l), bits of z_l > 0
  zero(acc);
  mm_accum(acc, xs, IN, IN, p + O_W0, HID, stages);
  forward_epilogue(acc, p + O_B0, HID, act, masks + 0 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_W1, HID, stages);
  forward_epilogue(acc, p + O_B1, HID, act, masks + 1 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_W2, HID, stages);
  forward_epilogue(acc, p + O_B2, HID, act, masks + 2 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_W3, LD_NARROW, stages);
  forward_epilogue(acc, p + O_B3, NARROW, act, masks + 3 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, NARROW, p + O_W4H, HID, stages);
  mm_accum(acc, xs, IN, IN, p + O_W4X, HID, stages);
  forward_epilogue(acc, p + O_B4, HID, act, masks + 4 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_W5, HID, stages);
  forward_epilogue(acc, p + O_B5, HID, act, masks + 5 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_W6, HID, stages);
  forward_epilogue(acc, p + O_B6, HID, act, masks + 6 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_W7, HID, stages);
  forward_epilogue(acc, p + O_B7, HID, act, masks + 7 * TM * MASK_WORDS);
  __syncthreads();

  // ---- output layer + tanh, then the seed of the backward:
  // g7 = (1 - y^2) w8 * (z7 > 0), each warp on its own rows
  {
    const uint32_t* mask7 = masks + 7 * TM * MASK_WORDS;
    const float b8 = __ldg(p + O_B8);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp * RPT + i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < MASK_WORDS; ++j)
        part = fmaf(act[r * HID + lane + 32 * j], __ldg(p + O_W8 + lane + 32 * j),
                    part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float y = tanhf(part + b8);
      if (lane == 0 && row0 + r < n) sdf[row0 + r] = y;
      const float g8 = 1.f - y * y;
#pragma unroll
      for (int j = 0; j < MASK_WORDS; ++j) {
        const int c = lane + 32 * j;
        const bool on = (mask7[r * MASK_WORDS + j] >> lane) & 1u;
        act[r * HID + c] = on ? g8 * __ldg(p + O_W8 + c) : 0.f;
      }
    }
  }

  // ---- backward: g_{l-1} = (g_l W_l^T) * (z_{l-1} > 0)
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_T7, HID, stages);
  backward_epilogue(acc, HID, act, masks + 6 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_T6, HID, stages);
  backward_epilogue(acc, HID, act, masks + 5 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_T5, HID, stages);
  backward_epilogue(acc, HID, act, masks + 4 * TM * MASK_WORDS);

  // layer 4 splits: the input re-injection g4 w4x^T goes to the (dead) input
  // tile, the hidden part continues down through layers 3..0
  constexpr int NJ_IN = LD_IN / 32;
  float acc_in[RPT][NJ_IN];
  zero(acc_in);
  mm_accum(acc_in, act, HID, HID, p + O_T4X, LD_IN, stages);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ_IN; ++j) {
      const int c = lane + 32 * j;
      if (c < IN) xs[(warp * RPT + i) * IN + c] = acc_in[i][j];
    }
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_T4H, LD_NARROW, stages);
  backward_epilogue(acc, NARROW, act, masks + 3 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, NARROW, p + O_T3, HID, stages);
  backward_epilogue(acc, HID, act, masks + 2 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_T2, HID, stages);
  backward_epilogue(acc, HID, act, masks + 1 * TM * MASK_WORDS);
  zero(acc);
  mm_accum(acc, act, HID, HID, p + O_T1, HID, stages);
  backward_epilogue(acc, HID, act, masks + 0 * TM * MASK_WORDS);

  // ---- input gradient: g0 w0^T + the layer-4 injection term (this thread
  // wrote exactly these xs entries above)
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ_IN; ++j) {
      const int c = lane + 32 * j;
      acc_in[i][j] = c < IN ? xs[(warp * RPT + i) * IN + c] : 0.f;
    }
  mm_accum(acc_in, act, HID, HID, p + O_T0, LD_IN, stages);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long row = row0 + warp * RPT + i;
    if (row < n)
#pragma unroll
      for (int j = 0; j < NJ_IN; ++j) {
        const int c = lane + 32 * j;
        if (c < IN) grad[row * IN + c] = acc_in[i][j];
      }
  }
}

}  // namespace

extern "C" long long dsp_decoder_fused_param_floats() { return P_TOTAL; }

template <int TM>
static int launch(const float* x, const float* params, float* sdf, float* grad,
                  int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_fused_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<TM>::BYTES);
  if (err != cudaSuccess) return (int)err;
  decoder_fused_kernel<TM><<<(n + TM - 1) / TM, THREADS, Smem<TM>::BYTES, stream>>>(
      x, params, sdf, grad, n);
  return (int)cudaGetLastError();
}

// x (n, 67), params (P_TOTAL,), sdf (n,), grad (n, 67): contiguous f32 device
// buffers, params 16-byte aligned. Launches on `stream` and returns the CUDA
// error code (0 = ok).
extern "C" int dsp_decoder_fused(const float* x, const float* params,
                                 float* sdf, float* grad, int n, void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // A 16-row block alone on an SM finishes sooner than a 32-row one, but two
  // 16-row blocks sharing an SM are slower than one 32-row block (they
  // stream every weight twice): take 16 rows only while they fit one per SM.
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (n + 15) / 16 <= sms ? launch<16>(x, params, sdf, grad, n, s)
                              : launch<32>(x, params, sdf, grad, n, s);
}
