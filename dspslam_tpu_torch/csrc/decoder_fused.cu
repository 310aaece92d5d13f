// Fused DeepSDF value + input gradient for the canonical DSP-SLAM decoder
// (64-d code + xyz = 67 inputs, 8 x 512 ReLU layers, the input re-injected
// at layer 4, linear output, final tanh), forward and backward in one launch,
// on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel dspslam_tpu/ops/pallas/decoder_kernel.py
// (`_kernel`, launched by `fused_sdf_and_input_grad`). That kernel holds all
// ~7 MB of f32 weights in VMEM next to a 256-row tile; an H100 block has at
// most 227 KB of shared memory, so the weights stream from L2 instead.
//
// What bounds it on this card:
//  * operations. Each row costs 7.34 MFLOP (forward + backward to the
//    input). The products must stay f32-accurate, so each one is three TF32
//    products (3xTF32): a = a_hi + a_lo, b = b_hi + b_lo with hi = tf32(x) and
//    lo = tf32(x - hi), acc += a_hi b_hi + a_hi b_lo + a_lo b_hi. At 495
//    TFLOP/s of dense TF32 that is 0.36 ms at N = 8192 rows and 0.09 ms at
//    N = 2048;
//  * L2 bytes. The CTAs of a 64-row tile stream all packed weights once
//    between them: the forward (out, in) copy and the backward (in, out)
//    copy, each as hi and lo parts, 29.7 MB, i.e. 464 KB of L2 reads per row
//    (3.8 GB per call at N = 8192, 0.95 GB at N = 2048), whatever the
//    cluster width.
//
// The design:
//  * a 64-row tile (one wgmma M) is owned by a cluster of CW = 1 or 2 CTAs;
//    each CTA computes 512 / CW of every layer's output columns, in groups
//    of 256 columns, two consumer warpgroups taking 128 columns of a group
//    each (m64n128k8). A third warpgroup, the
//    producer, streams the CTA's columns of the weights: one thread issues
//    the copies, and setmaxnreg moves the warpgroup's registers to the
//    consumers. The caller takes the widest cluster whose tiles the card
//    runs in one wave (dsp_decoder_fused_clusters): one CTA per 64-row tile
//    leaves most SMs idle at N = 2048;
//  * after each layer the CTAs of a cluster exchange their columns: each
//    writes its outputs into every CTA's activation tile through
//    distributed shared memory. Two mbarriers per CTA order it: "free"
//    (every CTA has read its tile, so it may be overwritten) and "fill"
//    (every CTA has written), one arrival per consumer warp of the cluster,
//    release / acquire at cluster scope;
//  * the tensor cores add into their f32 accumulator with truncation, so
//    192 adds per 512-deep product (64 k8 blocks x 3) leave ~2e-5 relative
//    error, twice the sdf tolerance. Every CHUNK k8 blocks the accumulator
//    is added into an f32 total in registers (round to nearest) and
//    restarted; that is why a group is 256 columns (64 + 64 registers). The chunk's 3 x CHUNK wgmma are issued back to back and
//    waited on once, so the tensor pipe drains once per chunk;
//  * the hi/lo split of the weights is done once, on the host side
//    (kernels/decoder_fused.py::pack_params), in the shared-memory order
//    that wgmma reads: K-major, no swizzle, one stage = 8 weight rows (k) x
//    256 columns (n), hi then lo. A stage is one contiguous run of 16 KB, so
//    the producer moves it with a single bulk copy (cp.async.bulk, the TMA
//    engine) into a ring of STAGES buffers guarded by full / empty
//    mbarriers;
//  * A (the activations) comes from registers: each thread loads its
//    fragment of the f32 activation tile (64 x 512, padded rows) from shared
//    memory and splits it into tf32 hi / lo in registers. Keeping hi and lo
//    tiles of A in shared memory would need 256 KB;
//  * the forward computes z = h W^T with the (out, in) copy as B, the
//    backward g W with the (in, out) copy as B (TF32 wgmma takes B only
//    K-major);
//  * with CW = 1 a CTA computes two groups; the first group's results wait
//    in a per-CTA global scratch (L2) until the second has read the tile.
//    The scratch also keeps the ReLU masks as bits: the backward of layer l
//    produces g_{l-1} in the same fragment layout (and the same CTA) as the
//    forward produced z_{l-1}, so each thread reads back its own words;
//  * layer 3's 445 outputs are padded to 512 with zero weights, and the
//    epilogue writes the input x into columns 445..511, so layer 4 is one
//    plain K = 512 product over [h3 | x] with the whole w4 (no w4h / w4x
//    split). In the backward, columns 445..511 of g4 w4 are the input's
//    re-injection term: they are parked in the output gradient and added to
//    the final g0 w0 (72 columns, one warpgroup of the cluster's first CTA)
//    at the end;
//  * the output layer, tanh and the seed of the backward (1 - y^2) w8 are
//    plain warp reductions over the shared activation tile, done by every
//    CTA of a cluster on its own copy.
//
// Shared memory per CTA: STAGES x 16 KB weight stages (96 KB) + the 64 x 516
// f32 activation tile (129 KB) + 14 mbarriers = 230,512 B of the 232,448 an
// H100 block may use. Global scratch per CTA: 28 KB of masks at CW = 1
// (+ 64 KB of parked results), 14 KB at CW = 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int IN = 67;       // code 64 + xyz 3
constexpr int HID = 512;
constexpr int NARROW = 445;  // layer-3 width: HID - IN
constexpr int IN_PAD = 72;   // input width padded to a multiple of 8
constexpr int ROWS = 64;     // rows per tile: one wgmma M
constexpr int LDA = HID + 4; // activation row stride: conflict-free A loads
constexpr int HALF = 256;    // columns per group, and per block of the packed weights
constexpr int NW = 128;      // columns per consumer warpgroup in a group
constexpr int ACC = NW / 2;  // accumulator floats per thread
constexpr int CONSUMERS = 256;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 128;  // two consumer + one producer warpgroup
// Registers per thread after setmaxnreg. The warpgroups can only trade the
// block's launch allocation (65,536 / THREADS per thread, rounded down to 8),
// or setmaxnreg.inc waits forever.
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
static_assert(CONSUMERS * CONSUMER_REGS + 128 * PRODUCER_REGS <=
                  THREADS * ((65536 / THREADS) & ~7),
              "setmaxnreg budget");
constexpr int STAGES = 6;
constexpr int STAGE_FLOATS = 2 * 8 * HALF;  // hi + lo of 8 k-rows x 256 n
constexpr int CHUNK = 4;  // k8 blocks in flight, and per accumulator flush
constexpr int NPASS = 16;

constexpr size_t SMEM_BYTES = sizeof(float) * (STAGES * STAGE_FLOATS + ROWS * LDA) +
                              (2 * STAGES + 2) * sizeof(uint64_t);
static_assert(SMEM_BYTES <= 232448, "shared memory budget");

// The work of one CTA in a cluster of CW that shares a 64-row tile.
template <int CW>
struct Cfg {
  static_assert(CW == 1 || CW == 2, "cluster width");
  static constexpr int SPAN = HID / CW;        // its columns of a 512-wide product
  static constexpr int NG = SPAN / HALF;       // groups of 256 columns per product
  static constexpr int MASKW = NG * ACC / 32;  // mask words per thread and layer
  static constexpr int PARK = (NG - 1) * ACC;  // parked floats per thread
  static constexpr int SCRATCH_FLOATS = (PARK + 7 * MASKW) * CONSUMERS;
};

// Pass p: 0..7 forward layers 0..7, then 8..15 backward layers 7..0. Each
// pass is a (K, N) product: K8 blocks of 8 along k, N output columns
// streamed as N / 256 groups (the last pass: 72 columns at once).
__host__ __device__ constexpr int pass_layer(int p) { return p < 8 ? p : 15 - p; }
__host__ __device__ constexpr int pass_k8(int p) {
  return p == 0 ? IN_PAD / 8 : (p >= 8 && pass_layer(p) == 3) ? 448 / 8 : HID / 8;
}
__host__ __device__ constexpr int pass_n(int p) { return p == 15 ? IN_PAD : HID; }
constexpr long long pass_floats(int p) { return (long long)pass_k8(p) * 16 * pass_n(p); }
constexpr long long pass_offset(int p) {
  return p == 0 ? 0 : pass_offset(p - 1) + pass_floats(p - 1);
}

// Packed parameter layout (floats, in this order); pack_params writes the
// same and checks the total against dsp_decoder_fused_param_floats():
//   16 passes; in each, per group of 256 columns (one of 72 for the last
//     pass), per k8 block: hi (n x 8) then lo (n x 8), each as n / 8 groups
//     of [2 k-halves][8 rows][4 floats];
//   b0..b7 (512 each, b3 zero-padded), w8 (512), b8 (padded to 4).
constexpr long long O_BIAS = pass_offset(NPASS);
constexpr long long O_W8 = O_BIAS + 8 * HID;
constexpr long long O_B8 = O_W8 + HID;
constexpr long long P_TOTAL = O_B8 + 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int CW>
__device__ __forceinline__ int cluster_rank() {
  if constexpr (CW == 1) {
    return 0;
  } else {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return static_cast<int>(r);
  }
}

// ---- mbarriers and the bulk copy

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
// The same wait, acquiring what the cluster's other CTAs released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrival on a barrier of any CTA of the cluster (a shared::cluster address),
// releasing this thread's earlier writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- distributed shared memory

// The same shared variable in CTA `rank` of the cluster: a generic address,
// and a shared::cluster one.
template <typename T>
__device__ __forceinline__ T* map_rank(T* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(out);
}
__device__ __forceinline__ uint32_t map_rank_u32(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// ---- wgmma (TF32, A from registers, B K-major in shared memory)

// No-swizzle K-major descriptor: a core matrix is 8 n-rows x 16 bytes (4 k);
// the two k-halves of a k8 block lie 128 B apart (leading byte offset), the
// 8-row groups 256 B apart (stride byte offset).
__device__ __forceinline__ uint64_t desc_b(const float* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(256 >> 4) << 32);
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F16(a, i) F4(a, i), F4(a, i + 4), F4(a, i + 8), F4(a, i + 12)

__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[36], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16), F4(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef F16
#undef F4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Ties a register to this point of the program, so the compiler neither
// reads an accumulator before the wgmma that writes it has been waited on
// nor reuses an operand register while a wgmma may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// bar.sync over the two consumer warpgroups only (the producer never
// joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The ring of weight stages, as each consumer thread tracks it.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// total (64 x N columns of this warpgroup) = act[:, :8 k8] @ B, B streamed
// from the ring (stages n_stage columns wide, this warpgroup's columns from
// col0): for every k8 block, 3 wgmma (hi hi, hi lo, lo hi) into acc. The
// wgmma of CHUNK blocks are issued back to back and waited on once; then
// acc is added into total and the chunk's stages are released. Row fragment
// of this thread: rows 16 (warp % 4) + lane / 4 (+ 8), k columns lane % 4
// (+ 4), as the m64k8 TF32 A fragment lays them out.
template <int N>
__device__ __forceinline__ void mma_pass(float (&total)[N], const float* act, int k8,
                                         int n_stage, int col0, const float* stages,
                                         uint64_t* full, uint64_t* empty, Ring& ring) {
  const int lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) total[i] = 0.f;
  const float* arow = act + (16 * wq + (lane >> 2)) * LDA + (lane & 3);
  for (int kb = 0; kb < k8; kb += CHUNK) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    uint32_t hi[CHUNK][4], lo[CHUNK][4];
    Ring r = ring;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (kb + j < k8) {
        const float* a = arow + 8 * (kb + j);
        const float v[4] = {a[0], a[8 * LDA], a[4], a[8 * LDA + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[j][i] = tf32_rna(v[i]);
          lo[j][i] = tf32_rna(v[i] - __uint_as_float(hi[j][i]));
        }
        mbar_wait(&full[r.stage], r.phase);
        __syncwarp();  // wgmma is .aligned: the warp must be converged again
        const float* b = stages + r.stage * STAGE_FLOATS + col0 * 8;
        const float* b_lo = b + n_stage * 8;
        wgmma_fence();
        wgmma(acc, hi[j], desc_b(b));
        wgmma(acc, hi[j], desc_b(b_lo));
        wgmma(acc, lo[j], desc_b(b));
        wgmma_commit();
        r.advance();
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
      if (kb + j < k8) {
        if (lane == 0) mbar_arrive(&empty[ring.stage]);
        ring.advance();
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) total[i] += acc[i];
  }
}

// A warpgroup with no columns in a pass still takes every stage off the ring.
__device__ __forceinline__ void skip_pass(int k8, uint64_t* full, uint64_t* empty, Ring& ring) {
  const int lane = threadIdx.x & 31;
  for (int kb = 0; kb < k8; ++kb) {
    mbar_wait(&full[ring.stage], ring.phase);
    if (lane == 0) mbar_arrive(&empty[ring.stage]);
    ring.advance();
  }
}

// Accumulator element i of an m64nN f32 fragment: row and column.
__device__ __forceinline__ int frag_row(int i) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Per-CTA global scratch, laid out [slot][consumer thread] so that a warp's
// accesses are coalesced: PARK slots of parked first-group results, then
// 7 x MASKW slots of ReLU mask words.
template <int CW>
struct Scratch {
  float* base;
  __device__ __forceinline__ float& park(int i) const { return base[i * CONSUMERS + threadIdx.x]; }
  __device__ __forceinline__ uint32_t& mask(int w) const {
    return reinterpret_cast<uint32_t*>(base)[(Cfg<CW>::PARK + w) * CONSUMERS + threadIdx.x];
  }
};

// The exchange of a layer's outputs between the CTAs of a cluster (with
// CW = 1, two barriers over the CTA's consumers): each CTA writes its
// columns into its own tile, then copies them into the other CTAs' tiles in
// 16-byte stores.
template <int CW>
struct Exchange {
  uint64_t* local;  // this CTA's "free" barrier; "fill" is the next one
  uint32_t parity;

  // Returns once every CTA of the cluster has read its tile for this layer.
  __device__ __forceinline__ void begin() {
    if constexpr (CW == 1) {
      consumers_sync();
    } else {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int r = 0; r < CW; ++r) mbar_arrive_cluster(map_rank_u32(local, r));
      }
      mbar_wait_cluster(local, parity);
    }
  }
  // Once every thread has written this CTA's columns into `act`: copies
  // them into the other CTAs' tiles and returns once every CTA's columns
  // are in every tile.
  __device__ __forceinline__ void end(float* act, int rank) {
    consumers_sync();
    if constexpr (CW > 1) {
      constexpr int SPAN = HID / CW, V = SPAN / 4;
#pragma unroll
      for (int d = 1; d < CW; ++d) {
        float* peer = map_rank(act, (rank + d) % CW);
#pragma unroll 4
        for (int i = threadIdx.x; i < ROWS * V; i += CONSUMERS) {
          const int idx = (i / V) * LDA + rank * SPAN + 4 * (i % V);
          *reinterpret_cast<float4*>(peer + idx) = *reinterpret_cast<const float4*>(act + idx);
        }
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int r = 0; r < CW; ++r) mbar_arrive_cluster(map_rank_u32(local + 1, r));
      }
      mbar_wait_cluster(local + 1, parity);
      parity ^= 1;
    }
  }
};

template <int CW>
struct Ctx {
  const float* __restrict__ p;
  const float* __restrict__ x;
  float* __restrict__ grad;
  long long row0;
  int n, rank;
  float* act;
  const float* stages;
  uint64_t* full;
  uint64_t* empty;
  Scratch<CW> scratch;
};

// One layer of the forward: z = h W^T + b over this CTA's columns; every
// tile of the cluster <- relu(z) (layer 3: the input x in columns
// 445..511); mask bits of z > 0 kept for layers 0..6.
template <int CW, int L>
__device__ __forceinline__ void forward_layer(const Ctx<CW>& s, Ring& ring,
                                              Exchange<CW>& ex) {
  using C = Cfg<CW>;
  const int wg_col = NW * (threadIdx.x >> 7);  // this warpgroup's columns in a group
  const float* bias = s.p + O_BIAS + L * HID;
  float total[ACC];
  uint32_t mask[C::MASKW];
#pragma unroll
  for (int w = 0; w < C::MASKW; ++w) mask[w] = 0u;
#pragma unroll
  for (int g = 0; g < C::NG; ++g) {
    mma_pass(total, s.act, pass_k8(L), HALF, wg_col, s.stages, s.full, s.empty, ring);
    if (g == C::NG - 1) ex.begin();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = frag_row(i), c = s.rank * C::SPAN + HALF * g + wg_col + frag_col(i);
      const float z = total[i] + __ldg(bias + c);
      const bool on = z > 0.f;
      mask[g * (ACC / 32) + (i >> 5)] |= (on ? 1u : 0u) << (i & 31);
      float out = on ? z : 0.f;
      if (L == 3 && c >= NARROW)
        out = s.row0 + r < s.n ? __ldg(s.x + (s.row0 + r) * IN + (c - NARROW)) : 0.f;
      if (g + 1 < C::NG) {
        s.scratch.park(i) = out;
      } else {
        s.act[r * LDA + c] = out;
        if constexpr (C::NG == 2) s.act[r * LDA + c - HALF] = s.scratch.park(i);
      }
    }
  }
  if (L < 7) {
#pragma unroll
    for (int w = 0; w < C::MASKW; ++w) s.scratch.mask(C::MASKW * L + w) = mask[w];
  }
  ex.end(s.act, s.rank);
}

// One layer of the backward (L >= 1): every tile <- (g W) * (z_{L-1} > 0)
// over this CTA's columns. For L == 4, columns 445..511 are d sdf / d x
// through the re-injection: parked in the output gradient (read back by the
// last pass).
template <int CW, int L>
__device__ __forceinline__ void backward_layer(const Ctx<CW>& s, Ring& ring,
                                               Exchange<CW>& ex) {
  using C = Cfg<CW>;
  const int wg_col = NW * (threadIdx.x >> 7);
  uint32_t mask[C::MASKW];
#pragma unroll
  for (int w = 0; w < C::MASKW; ++w) mask[w] = s.scratch.mask(C::MASKW * (L - 1) + w);
  float total[ACC];
#pragma unroll
  for (int g = 0; g < C::NG; ++g) {
    mma_pass(total, s.act, pass_k8(15 - L), HALF, wg_col, s.stages, s.full, s.empty, ring);
    if (g == C::NG - 1) ex.begin();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = frag_row(i), c = s.rank * C::SPAN + HALF * g + wg_col + frag_col(i);
      const bool on = (mask[g * (ACC / 32) + (i >> 5)] >> (i & 31)) & 1u;
      const float out = on ? total[i] : 0.f;
      if (L == 4 && c >= NARROW && s.row0 + r < s.n)
        s.grad[(s.row0 + r) * IN + (c - NARROW)] = total[i];
      if (g + 1 < C::NG) {
        s.scratch.park(i) = out;
      } else {
        s.act[r * LDA + c] = out;
        if constexpr (C::NG == 2) s.act[r * LDA + c - HALF] = s.scratch.park(i);
      }
    }
  }
  ex.end(s.act, s.rank);
}

// Output layer, tanh, and the seed of the backward, on the shared h7 tile:
// each consumer warp owns 8 rows; g7 = (1 - y^2) w8 where h7 > 0. Every CTA
// of a cluster does it on its own tile; the first stores the sdf.
template <int CW>
__device__ __forceinline__ void output_layer(const Ctx<CW>& s, float* __restrict__ sdf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* w8 = s.p + O_W8;
  const float b8 = __ldg(s.p + O_B8);
#pragma unroll 1
  for (int k = 0; k < ROWS / 8; ++k) {
    const int r = warp * (ROWS / 8) + k;
    float* h = s.act + r * LDA;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < HID / 32; ++j) part = fmaf(h[lane + 32 * j], __ldg(w8 + lane + 32 * j), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const float y = tanhf(part + b8);
    if (s.rank == 0 && lane == 0 && s.row0 + r < s.n) sdf[s.row0 + r] = y;
    const float g8 = 1.f - y * y;
#pragma unroll
    for (int j = 0; j < HID / 32; ++j) {
      const int c = lane + 32 * j;
      h[c] = h[c] > 0.f ? g8 * __ldg(w8 + c) : 0.f;
    }
  }
  consumers_sync();
}

// Stage: 8 k-rows x n columns, hi then lo, one contiguous run in the packed
// buffer.
__device__ __forceinline__ void produce_stage(float* stages, uint64_t* full, uint64_t* empty,
                                              int& stage, uint32_t& phase, const float* src,
                                              int n) {
  const uint32_t bytes = static_cast<uint32_t>(sizeof(float) * 16 * n);
  mbar_wait(&empty[stage], phase ^ 1);  // a fresh barrier passes at parity 1
  mbar_expect_tx(&full[stage], bytes);
  bulk_load(stages + stage * STAGE_FLOATS, src, bytes, &full[stage]);
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// The producer thread: this CTA's columns of every pass, group by group, in
// the order the consumers take them; the last pass only in the first CTA.
template <int CW>
__device__ __forceinline__ void produce(const float* __restrict__ p, float* stages,
                                        uint64_t* full, uint64_t* empty, int rank) {
  int stage = 0;
  uint32_t phase = 0;
  const float* base = p;  // this pass's packed products
  for (int pass = 0; pass < NPASS - 1; ++pass) {
    const int k8 = pass_k8(pass);
    const float* src = base + rank * Cfg<CW>::NG * k8 * 16 * HALF;
    for (int s = 0; s < Cfg<CW>::NG * k8; ++s)
      produce_stage(stages, full, empty, stage, phase, src + s * 16 * HALF, HALF);
    base += k8 * 16 * HID;
  }
  if (rank == 0) {
    for (int kb = 0; kb < pass_k8(NPASS - 1); ++kb)
      produce_stage(stages, full, empty, stage, phase, base + kb * 16 * IN_PAD, IN_PAD);
  }
}

template <int CW>
__global__ void __launch_bounds__(THREADS, 1)
    decoder_fused_kernel(const float* __restrict__ x, const float* __restrict__ p,
                         float* __restrict__ sdf, float* __restrict__ grad,
                         float* __restrict__ scratch_all, int n) {
  using C = Cfg<CW>;
  extern __shared__ __align__(128) float smem[];
  float* stages = smem;
  float* act = smem + STAGES * STAGE_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(act + ROWS * LDA);
  uint64_t* empty = full + STAGES;
  uint64_t* bars = empty + STAGES;  // the exchange's "free" and "fill"

  const int tid = threadIdx.x;
  const int rank = cluster_rank<CW>();
  const long long row0 = static_cast<long long>(blockIdx.x / CW) * ROWS;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(&bars[0], CONSUMER_WARPS * CW);
    mbar_init(&bars[1], CONSUMER_WARPS * CW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the input tile in columns 0..71; rows past n (the ragged last tile) are
  // zeros and never stored
  for (int i = tid; i < ROWS * IN_PAD; i += THREADS) {
    const int r = i / IN_PAD, c = i - r * IN_PAD;
    act[r * LDA + c] = c < IN && row0 + r < n ? __ldg(x + (row0 + r) * IN + c) : 0.f;
  }
  // every CTA's barriers are initialised before any CTA arrives on them
  if constexpr (CW == 1) {
    __syncthreads();
  } else {
    cluster_sync();
  }

  if (tid >= CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) produce<CW>(p, stages, full, empty, rank);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  Ring ring;
  Exchange<CW> ex{bars, 0u};
  const Ctx<CW> s{p, x, grad, row0, n, rank, act, stages, full, empty,
                  Scratch<CW>{scratch_all + static_cast<long long>(blockIdx.x) * C::SCRATCH_FLOATS}};
  forward_layer<CW, 0>(s, ring, ex);
  forward_layer<CW, 1>(s, ring, ex);
  forward_layer<CW, 2>(s, ring, ex);
  forward_layer<CW, 3>(s, ring, ex);
  forward_layer<CW, 4>(s, ring, ex);
  forward_layer<CW, 5>(s, ring, ex);
  forward_layer<CW, 6>(s, ring, ex);
  forward_layer<CW, 7>(s, ring, ex);
  output_layer<CW>(s, sdf);
  backward_layer<CW, 7>(s, ring, ex);
  backward_layer<CW, 6>(s, ring, ex);
  backward_layer<CW, 5>(s, ring, ex);
  backward_layer<CW, 4>(s, ring, ex);
  backward_layer<CW, 3>(s, ring, ex);
  backward_layer<CW, 2>(s, ring, ex);
  backward_layer<CW, 1>(s, ring, ex);
  // every write into this CTA's tile has landed (the last exchange), so the
  // other CTAs may leave; the first does the last pass
  if (rank != 0) return;

  // input gradient: g0 w0 (72 columns, the first warpgroup) + the parked
  // re-injection term, which the CTA owning columns 445..511 wrote before
  // the exchanges above
  if (tid < 128) {
    float total[IN_PAD / 2];
    mma_pass(total, act, pass_k8(15), IN_PAD, 0, stages, full, empty, ring);
#pragma unroll
    for (int i = 0; i < IN_PAD / 2; ++i) {
      const int r = frag_row(i), c = frag_col(i);
      const long long row = row0 + r;
      if (c < IN && row < n) grad[row * IN + c] += total[i];
    }
  } else {
    skip_pass(pass_k8(15), full, empty, ring);
  }
}

template <int CW>
cudaLaunchConfig_t launch_config(int n, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + ROWS - 1) / ROWS) * CW);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CW;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CW>
int launch(const float* x, const float* p, float* sdf, float* grad, float* scratch, int n,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_fused_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<CW>(n, SMEM_BYTES, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, decoder_fused_kernel<CW>, x, p, sdf, grad, scratch, n);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Clusters of CW the current device runs at once (0 on error).
template <int CW>
int max_clusters() {
  if (cudaFuncSetAttribute(decoder_fused_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<CW>(ROWS, SMEM_BYTES, nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, decoder_fused_kernel<CW>, &cfg) != cudaSuccess)
    return 0;
  return clusters;
}

}  // namespace

extern "C" long long dsp_decoder_fused_param_floats() { return P_TOTAL; }

// Clusters of cw CTAs (1 or 2), i.e. 64-row tiles, that the current
// device runs at once (0 on error).
extern "C" int dsp_decoder_fused_clusters(int cw) {
  switch (cw) {
    case 1: return max_clusters<1>();
    case 2: return max_clusters<2>();
    default: return 0;
  }
}

// Floats of global scratch the kernel needs for n rows at cluster width cw.
extern "C" long long dsp_decoder_fused_scratch_floats(int n, int cw) {
  const long long tiles = (n + ROWS - 1) / ROWS;
  switch (cw) {
    case 1: return tiles * Cfg<1>::SCRATCH_FLOATS;
    case 2: return tiles * 2 * Cfg<2>::SCRATCH_FLOATS;
    default: return -1;
  }
}

// x (n, 67), params (P_TOTAL,), sdf (n,), grad (n, 67), scratch
// (dsp_decoder_fused_scratch_floats(n, cw),): contiguous f32 device buffers,
// params 16-byte aligned; cw (1 or 2) CTAs per 64-row tile. Launches on
// `stream` and returns the CUDA error code (0 = ok).
extern "C" int dsp_decoder_fused(const float* x, const float* params, float* sdf, float* grad,
                                 float* scratch, int n, int cw, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cw) {
    case 1: return launch<1>(x, params, sdf, grad, scratch, n, s);
    case 2: return launch<2>(x, params, sdf, grad, scratch, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
