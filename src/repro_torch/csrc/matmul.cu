// Tiled fp32 GEMM for Hopper (sm_90a) on the tensor cores: C = A · B,
// row-major, fp32 in and out, fp32-accurate products by 3xTF32.
//
// Replaces the Pallas TPU kernel `matmul` of src/repro/kernels/matmul/kernel.py
// (body `_matmul_kernel`).  That kernel keeps one (BLOCK_M, BLOCK_N) fp32
// accumulator in VMEM per grid program and sweeps K in BLOCK_K steps,
// masking the K tail.  This kernel computes the same function to fp32
// accuracy: each product is three TF32 tensor-core products of the
// operands' big and small parts (tf32x3.cuh), accumulated in fp32; ragged
// M, N and K edges are masked.
//
// What bounds each shape on the H100, and what the design does about it.
// * 2048^3: 2n^3 = 1.72e10 operations on 50 MB.  On the fp32 pipes that is
//   0.256 ms; by 3xTF32 on the tensor cores 3 x 1.72e10 / 495e12 = 0.104 ms.
//   The tensor cores then bind; through mma.sync they sustain about two
//   thirds of the data sheet's TF32 rate (chip_smoke.py's probe), so 0.16 ms
//   is that instruction's floor, and only wgmma reaches the full rate.  So
//   the 128 x 128 sub-tile runs on wgmma fed by TMA wherever the operands
//   allow it ("The wgmma path", below).  Everywhere else the sub-tiles run
//   on mma.sync.  Shared memory and the threads that split the
//   operands must feed them: 128 x 128 block sub-tiles of 4 warps, each
//   warp a 64 x 64 tile of m16n8k8 products (32 accumulators), so that a
//   split A fragment feeds 8 products and a split B fragment 4 (3 mma each);
//   tiles padded so fragment reads hit 32 distinct banks (A rows of 36
//   floats, B rows of 136); K comes in 32-deep chunks through a ring of 3
//   cp.async stages, two chunks in flight while one is used.  105 KB of
//   shared memory and 255 registers a thread (ptxas spills about 100 bytes
//   to keep it) keep two blocks on an SM.  Sub-tiles that lie
//   inside M and N take their products with no test on each m16 or n8
//   tile.
// * 16 x 4096 x 4096 (and 4096 x 16 x 4096): bound by reading B (or A)
//   once, 67 MB in 0.020 ms at 3.35 TB/s.  M = 16 is one m16 tile: rows past
//   M are neither loaded nor multiplied, and warps whose rows all lie past
//   M skip their products.  With BLOCK_N tiles of N there are at most 64
//   output tiles for the 264 blocks one wave holds (2 on each of 132 SMs),
//   so the K sweep is split (split-K, below) until the wave is full; every
//   block streams its share of B through the cp.async ring.
//
// Split-K.  When the output tiles fill less than half a wave, the wrapper
// splits the K sweep across blocks in whole BLOCK_K steps (the split count
// follows from the grid and the card, it is not a knob): block (split,
// tile) sums its steps and writes its partial tile to a workspace of
// splits x M x N floats; a second kernel adds the partials in split order.
// The order is fixed, so two runs give the same bits; there are no atomics
// on C.
//
// Unaligned rows.  16-byte cp.async needs K and N (and the split's K
// offset) to be multiples of 4 floats and 16-byte aligned operands; where
// they are not, the same kernel is compiled with 4-byte copies.
//
// The wgmma path.  Taken where the sub-tile is 128 x 128 (BLOCK_M and
// BLOCK_N >= 128), the operands take 16-byte copies (above), M >= 128,
// N >= 128, K > 0, and a split's K is a whole number of 32-deep chunks (so
// that no chunk straddles two splits; TMA zero-fills past K only).  TF32
// wgmma reads its shared-memory operand K-major only.  A (M x K, row-major)
// lands K-major; B (K x N) does not.  So the block computes each sub-tile
// transposed, C^T = B^T A^T:
// * A's chunk is wgmma's shared-memory operand, its 128 rows wgmma's N.
//   TMA lands it with the 128-byte swizzle.  Three splitter warps then
//   rewrite it in place as its big parts and write the small parts to a
//   second tile at the same offsets.  The split is elementwise, so the
//   swizzle needs no thought.  fence.proxy.async and an mbarrier hand the
//   chunk to wgmma.
// * B^T is wgmma's register operand, 64 rows (of N) a consumer warpgroup.
//   Each thread reads its fragment from the landed B chunk (four 32 x 32
//   boxes, swizzled) and splits it in registers.  Fragment row r of a warp
//   stands for the column whose place in its box makes the 32 lanes'
//   reads hit 32 banks; the epilogue writes each accumulator to that
//   column.
// * Each 8-deep step takes three m64n128k8 products, small . big,
//   big . small, big . big, as tf32x3.cuh's mma3 takes them, into one fp32
//   accumulator of 64 registers a thread.
// Splitting A in the kernel, and not in a pre-pass over B, costs shared
// memory bandwidth only.  A pre-pass would write B's two parts K-major to
// 2 x K x N floats of scratch that the wrapper would have to allocate
// (32 MB and about 15 us at 2048^3, each call), in a launch of its own.
// The block: one lane of a loading warp keeps a ring of 4 chunks (48 KB
// each: A, A's small part, B) in flight through mbarriers; three splitter
// warps split each landed chunk; two consumer warpgroups each issue a
// chunk's 12 wgmma as one group and free the chunk before once it is
// issued (wait_group 1).  The register fragments alternate between two
// sets, so that a group in flight never reads registers that the next
// chunk's reads overwrite.  Splitting in the consumers instead, with a
// barrier of both warpgroups on each chunk, took 0.162 ms at 2048^3 on an
// H100 SXM at 700 W, where this takes 0.153 ms.  Shared memory is the
// likely bound now: each chunk moves 192 KB through it (TMA 32, the split
// 48, the fragments 16, wgmma's reads of A 96), and taking away either
// the split or one of the three products brings 2048^3 to about 0.13 ms
// alike.  192 KB and 384 threads: one block an SM.  The grid, the raster,
// split-K and the workspace are the mma.sync path's.  The TMA descriptors
// are made in the C entry for each call.
//
// Tuning parameters and the code path:
//   BLOCK_M, BLOCK_N  the output tile of one block, hence the grid, the
//                     split count, the number of sub-tiles a block walks and
//                     the sub-tile: 128 x 128 (4 warps, or 12 on the wgmma
//                     path) where both are >= 128, else 64 on the short
//                     side (8 warps, so that a 64 x 64 tile keeps all of
//                     them busy);
//   LOOP_ORDER        the raster: "mnk" (0) lets consecutive blocks walk N
//                     tiles, "nmk" (1) M tiles;
//   BLOCK_K           the unit of split-K: a split is a run of whole BLOCK_K
//                     steps, so BLOCK_K sets how finely the K sweep can be
//                     shared out when the tiles fill less than half a wave
//                     (with more tiles it changes nothing; chunks stay 32
//                     deep);
//   ACC_F32           is ignored, as the Pallas kernel ignores it;
//   OUT_SWIZZLE, K_UNROLL, PREFETCH_DEPTH (GEMM-full) are priced by the
//                     workload model only.
//
// Entry: repro_matmul_f32 (plain C, loaded with ctypes).  It launches on the
// given stream, does not synchronise, and returns cudaGetLastError(), or
// kWgmmaLaunched where the launch went through without error on the wgmma
// path.

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kChunk = 32;               // K depth of one cp.async stage
constexpr int kStages = 3;               // the cp.async ring
constexpr int kLdA = kChunk + 4;         // 36: 4 mod 32, conflict-free
constexpr int kReduceThreads = 256;

// A sub-tile of kSubM x kSubN outputs.  Its warps stand 2 (M) x kWarpsN
// (N): the 128 x 128 sub-tile has 4 warps of 64 x 64 outputs (32
// accumulators a warp, so that each split fragment feeds 8 or 4 products);
// the 64-wide ones have 8 warps, which keeps more copies in flight for
// skinny products.
template <int kSubM, int kSubN>
struct Tile {
  static constexpr int kWarpsN = kSubM == 128 && kSubN == 128 ? 2 : 4;
  static constexpr int kThreads = 64 * kWarpsN;
  static constexpr int kLdB = kSubN + 8;            // 8 mod 32
  static constexpr int kWarpM = kSubM / 2;          // rows of a warp's tile
  static constexpr int kWarpN = kSubN / kWarpsN;    // columns of a warp's tile
  static constexpr int kMT = kWarpM / 16;           // m16 tiles a warp
  static constexpr int kNT = kWarpN / 8;            // n8 tiles a warp
  static constexpr int kStageA = kSubM * kLdA;
  static constexpr int kStageB = kChunk * kLdB;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
};

// One K chunk [kc, kc + 32) of the sub-tile at (sm, sn) into a stage.  A
// rows are copied up to the m16 tile that holds the last row (rows past M
// zero-filled), B columns up to the n8 tile that holds the last column; K
// past k_hi is zero-filled.
template <int kSubM, int kSubN, bool kVec>
__device__ __forceinline__ void load_chunk(
    float* stage, const float* __restrict__ A, const float* __restrict__ B,
    int N, int K, int sm, int sn, int m_end, int n_end, int kc, int k_hi,
    int a_rows, int b_cols) {
  using T = Tile<kSubM, kSubN>;
  float* As = stage;
  float* Bs = stage + T::kStageA;
  constexpr int kChunksA = kSubM * (kChunk / 4);
  constexpr int kChunksB = kChunk * (kSubN / 4);
#pragma unroll
  for (int e = 0; e < kChunksA / T::kThreads; ++e) {
    const int idx = threadIdx.x + e * T::kThreads;
    const int r = idx / (kChunk / 4);
    const int c = (idx % (kChunk / 4)) * 4;
    if (r >= a_rows) continue;
    const int gr = sm + r;
    const int gk = kc + c;
    float* dst = As + r * kLdA + c;
    if (kVec) {
      const int valid = gr < m_end ? max(0, min(4, k_hi - gk)) : 0;
      const float* src =
          valid ? A + static_cast<size_t>(gr) * K + gk : A;
      async_copy::cp_async16(dst, src, 4 * valid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gr < m_end && gk + j < k_hi;
        async_copy::cp_async4(dst + j,
                          ok ? A + static_cast<size_t>(gr) * K + gk + j : A,
                          ok);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kChunksB / T::kThreads; ++e) {
    const int idx = threadIdx.x + e * T::kThreads;
    const int r = idx / (kSubN / 4);
    const int c = (idx % (kSubN / 4)) * 4;
    if (c >= b_cols) continue;
    const int gk = kc + r;
    const int gc = sn + c;
    float* dst = Bs + r * T::kLdB + c;
    if (kVec) {
      const int valid = gk < k_hi ? max(0, min(4, n_end - gc)) : 0;
      const float* src =
          valid ? B + static_cast<size_t>(gk) * N + gc : B;
      async_copy::cp_async16(dst, src, 4 * valid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gk < k_hi && gc + j < n_end;
        async_copy::cp_async4(dst + j,
                          ok ? B + static_cast<size_t>(gk) * N + gc + j : B,
                          ok);
      }
    }
  }
}

// The products of one staged chunk into the warp's accumulators.  kFull:
// the sub-tile lies inside M and N, so no m16 or n8 tile is tested (the
// tests would otherwise split the straight-line products into branches).
// Else m16 tiles wholly past M and n8 tiles wholly past N are skipped.
template <int kSubM, int kSubN, bool kFull>
__device__ __forceinline__ void chunk_products(
    float (&acc)[Tile<kSubM, kSubN>::kMT][Tile<kSubM, kSubN>::kNT][4],
    const float* As, int wm, int wn, int g, int t, int m_rows, int n_cols) {
  using T = Tile<kSubM, kSubN>;
  const float* Bs = As + T::kStageA;
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 8) {
    tf32x3::FragB b[T::kNT];
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
      if (kFull || wn + 8 * j < n_cols)
        b[j] = tf32x3::load_b_kn(Bs, T::kLdB, kk, wn + 8 * j, g, t);
#pragma unroll
    for (int i = 0; i < T::kMT; ++i) {
      if (!kFull && wm + 16 * i >= m_rows) continue;  // rows past M: none
      const tf32x3::FragA a = tf32x3::load_a(As, kLdA, wm + 16 * i, kk, g, t);
#pragma unroll
      for (int j = 0; j < T::kNT; ++j)
        if (kFull || wn + 8 * j < n_cols) tf32x3::mma3(acc[i][j], a, b[j]);
    }
  }
}

template <int kSubM, int kSubN, bool kVec>
__global__ void __launch_bounds__(Tile<kSubM, kSubN>::kThreads, 2)
matmul_tf32x3_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ out, int M, int N, int K,
                     int block_m, int block_n, int tiles_m, int tiles_n,
                     int n_fastest, int split_k) {
  using T = Tile<kSubM, kSubN>;
  extern __shared__ __align__(16) float smem[];

  const int tiles = tiles_m * tiles_n;
  const int split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  int tm, tn;
  if (n_fastest) {
    tn = tile % tiles_n;
    tm = tile / tiles_n;
  } else {
    tm = tile % tiles_m;
    tn = tile / tiles_m;
  }
  // a split's partial tile goes to its slice of the workspace
  out += static_cast<size_t>(split) * M * N;
  const int k_lo = static_cast<int>(
      min(static_cast<long long>(K), static_cast<long long>(split) * split_k));
  const int k_hi = static_cast<int>(
      min(static_cast<long long>(K), static_cast<long long>(k_lo) + split_k));
  const int n_chunks = (k_hi - k_lo + kChunk - 1) / kChunk;

  const int m_begin = tm * block_m;
  const int n_begin = tn * block_n;
  const int m_end = min(m_begin + block_m, M);
  const int n_end = min(n_begin + block_n, N);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / T::kWarpsN) * T::kWarpM;  // warp tile origin
  const int wn = (warp % T::kWarpsN) * T::kWarpN;

  for (int sm = m_begin; sm < m_end; sm += kSubM) {
    for (int sn = n_begin; sn < n_end; sn += kSubN) {
      const int m_rows = min(kSubM, m_end - sm);
      const int n_cols = min(kSubN, n_end - sn);
      // interior sub-tiles take the products without a test on each tile
      const bool full = m_rows == kSubM && n_cols == kSubN;
      const int a_rows = min(kSubM, (m_rows + 15) / 16 * 16);
      const int b_cols = min(kSubN, (n_cols + 7) / 8 * 8);

      float acc[T::kMT][T::kNT][4];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < T::kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_chunks)
          load_chunk<kSubM, kSubN, kVec>(smem + s * T::kStage, A, B, N, K, sm,
                                         sn, m_end, n_end, k_lo + s * kChunk,
                                         k_hi, a_rows, b_cols);
        async_copy::cp_async_commit();
      }

      for (int c = 0; c < n_chunks; ++c) {
        async_copy::cp_async_wait<kStages - 2>();   // chunk c has landed
        __syncthreads();                        // and chunk c - 1 is used
        const int next = c + kStages - 1;
        if (next < n_chunks)
          load_chunk<kSubM, kSubN, kVec>(smem + (next % kStages) * T::kStage,
                                         A, B, N, K, sm, sn, m_end, n_end,
                                         k_lo + next * kChunk, k_hi, a_rows,
                                         b_cols);
        async_copy::cp_async_commit();

        const float* As = smem + (c % kStages) * T::kStage;
        if (full)
          chunk_products<kSubM, kSubN, true>(acc, As, wm, wn, g, t, m_rows,
                                             n_cols);
        else
          chunk_products<kSubM, kSubN, false>(acc, As, wm, wn, g, t, m_rows,
                                              n_cols);
      }
      async_copy::cp_async_wait<0>();
      __syncthreads();                 // the ring is free for the next sub-tile

#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) {
          const int col = sn + wn + 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = sm + wm + 16 * i + g + 8 * h;
            if (row >= m_end) continue;
            float* dst = out + static_cast<size_t>(row) * N + col;
            if (col < n_end) dst[0] = acc[i][j][2 * h];
            if (col + 1 < n_end) dst[1] = acc[i][j][2 * h + 1];
          }
        }
      }
    }
  }
}

// C = sum of the splits' partials, in split order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ C,
                     size_t mn, int splits) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < mn; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < splits; ++p) s += ws[static_cast<size_t>(p) * mn + i];
    C[i] = s;
  }
}

template <int kSubM, int kSubN, bool kVec>
cudaError_t launch_gemm(const float* a, const float* b, float* out, int m,
                        int n, int k, int block_m, int block_n, int tiles_m,
                        int tiles_n, int n_fastest, int split_k,
                        unsigned grid, cudaStream_t stream) {
  using T = Tile<kSubM, kSubN>;
  auto kernel = matmul_tf32x3_kernel<kSubM, kSubN, kVec>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (set != cudaSuccess) return set;
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      a, b, out, m, n, k, block_m, block_n, tiles_m, tiles_n, n_fastest,
      split_k);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch(const float* a, const float* b, float* out, int m, int n,
                     int k, int block_m, int block_n, int tiles_m,
                     int tiles_n, int n_fastest, int split_k, unsigned grid,
                     cudaStream_t stream) {
  const bool wide_m = block_m >= 128, wide_n = block_n >= 128;
  if (wide_m && wide_n)
    return launch_gemm<128, 128, kVec>(a, b, out, m, n, k, block_m, block_n,
                                       tiles_m, tiles_n, n_fastest, split_k,
                                       grid, stream);
  if (wide_m)
    return launch_gemm<128, 64, kVec>(a, b, out, m, n, k, block_m, block_n,
                                      tiles_m, tiles_n, n_fastest, split_k,
                                      grid, stream);
  if (wide_n)
    return launch_gemm<64, 128, kVec>(a, b, out, m, n, k, block_m, block_n,
                                      tiles_m, tiles_n, n_fastest, split_k,
                                      grid, stream);
  return launch_gemm<64, 64, kVec>(a, b, out, m, n, k, block_m, block_n,
                                   tiles_m, tiles_n, n_fastest, split_k,
                                   grid, stream);
}

// --- The wgmma path (the header says why it is shaped so) ------------------

namespace wg {

constexpr int kStages = 4;                       // chunks in the ring
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kSplitters = 96;                   // three warps split A
constexpr int kThreads = kConsumers + 32 + kSplitters;  // and one loads
constexpr int kTileBytes = 128 * kChunk * 4;     // a 128 x 32 chunk of A
constexpr int kBoxBytes = 32 * kChunk * 4;       // a 32 x 32 box of B
constexpr int kStageBytes = 3 * kTileBytes;      // A (big), A small, B
constexpr uint32_t kLanded = 2 * kTileBytes;     // bytes TMA lands a stage
constexpr size_t kSmem = kStages * kStageBytes + 3 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The producer's arrival, expecting `bytes` from TMA.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A box of the tensor `map` at (c0 innermost, c1) into shared memory at
// `dst`, counted on the barrier `bar`; past the tensor's edges, zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The descriptor of a K-major tile with the 128-byte swizzle that TMA
// writes: rows of 128 bytes (32 tf32), 8-row groups 1024 bytes apart.
// `addr` points at the 8-deep step's first column (step s: + 32 s bytes).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // 8-row groups
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Tells the compiler that the registers may change here (an asynchronous
// product reads or writes them), so that no access moves across.
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void hold(tf32x3::FragA (&f)[4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" : "+r"(f[s].big[i]), "+r"(f[s].small[i])::"memory");
}

// d (64 x 128, fp32) += a (64 x 8, tf32, registers) * the tile at `desc`.
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The splitters' work on one landed chunk (in `stage`): A's values
// rewritten in place as their big parts, the small parts written beside.
__device__ __forceinline__ void split_chunk(uint8_t* stage, int tid) {
  uint4* big = reinterpret_cast<uint4*>(stage);
  uint4* small = reinterpret_cast<uint4*>(stage + kTileBytes);
#pragma unroll 4
  for (int i = tid; i < kTileBytes / 16; i += kSplitters) {
    const uint4 v = big[i];
    const tf32x3::FragA p = tf32x3::split_a(
        __uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
        __uint_as_float(v.w));
    big[i] = make_uint4(p.big[0], p.big[1], p.big[2], p.big[3]);
    small[i] = make_uint4(p.small[0], p.small[1], p.small[2], p.small[3]);
  }
}

// The consumers' work on one split chunk (ring position `it`): read and
// split the B^T fragments into `f`, issue the 12 products as one group, and
// free the chunk before, whose group read the fragments `before`.  `frag`
// holds the byte offsets of the fragment's four values (a0..a3) in a
// stage's B region at k = 0; `first`: no chunk of this sub-tile before.
__device__ __forceinline__ void consume(float (&acc)[64],
                                        tf32x3::FragA (&f)[4],
                                        tf32x3::FragA (&before)[4],
                                        uint8_t* smem, uint32_t bars, int it,
                                        const uint32_t (&frag)[4],
                                        bool first) {
  const int s = it % kStages;
  const uint32_t parity = (it / kStages) & 1;
  uint8_t* stage = smem + s * kStageBytes;
  bar_wait(bars + 8 * s, parity);                   // B landed
  bar_wait(bars + 8 * (kStages + s), parity);       // A split

  const uint8_t* b = stage + 2 * kTileBytes;
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    const uint8_t* p = b + kk * 8 * 128;   // 8 rows of 128 bytes a step
    f[kk] = tf32x3::split_a(*reinterpret_cast<const float*>(p + frag[0]),
                            *reinterpret_cast<const float*>(p + frag[1]),
                            *reinterpret_cast<const float*>(p + frag[2]),
                            *reinterpret_cast<const float*>(p + frag[3]));
  }

  const uint32_t a_big = shared_addr(stage);
  const uint32_t a_small = a_big + kTileBytes;
  mma_fence();
#pragma unroll
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    mma(acc, f[kk].small, tile_desc(a_big + 32 * kk));
    mma(acc, f[kk].big, tile_desc(a_small + 32 * kk));
    mma(acc, f[kk].big, tile_desc(a_big + 32 * kk));
  }
  mma_commit();
  mma_wait<1>();                       // the chunk before is done
  hold(before);
  if (!first && threadIdx.x % 32 == 0)
    bar_arrive(bars + 8 * (2 * kStages + (it + kStages - 1) % kStages));
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    float* __restrict__ out, int M, int N, int K,
                    int block_m, int block_n, int tiles_m, int tiles_n,
                    int n_fastest, int split_k) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - shared_addr(smem_raw) % 1024) % 1024);
  // at bars + 8 (i kStages + s): full (i = 0, TMA landed), split (1, A
  // split), empty (2, the chunk's products done)
  const uint32_t bars = shared_addr(smem + kStages * kStageBytes);

  const int tiles = tiles_m * tiles_n;
  const int split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  int tm, tn;
  if (n_fastest) {
    tn = tile % tiles_n;
    tm = tile / tiles_n;
  } else {
    tm = tile % tiles_m;
    tn = tile / tiles_m;
  }
  out += static_cast<size_t>(split) * M * N;
  const int k_lo = static_cast<int>(
      min(static_cast<long long>(K), static_cast<long long>(split) * split_k));
  const int k_hi = static_cast<int>(
      min(static_cast<long long>(K), static_cast<long long>(k_lo) + split_k));
  const int n_chunks = (k_hi - k_lo + kChunk - 1) / kChunk;
  const int m_begin = tm * block_m;
  const int n_begin = tn * block_n;
  const int m_end = min(m_begin + block_m, M);
  const int n_end = min(n_begin + block_n, N);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(bars + 8 * s, 1);
      bar_init(bars + 8 * (kStages + s), kSplitters);
      bar_init(bars + 8 * (2 * kStages + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = n_chunks * ((m_end - m_begin + 127) / 128) *
                     ((n_end - n_begin + 127) / 128);
  if (threadIdx.x >= kConsumers + 32) {         // the splitters
    const int tid = threadIdx.x - kConsumers - 32;
    for (int it = 0; it < chunks; ++it) {
      const int s = it % kStages;
      bar_wait(bars + 8 * s, (it / kStages) & 1);
      split_chunk(smem + s * kStageBytes, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(bars + 8 * (kStages + s));
    }
    return;
  }
  if (threadIdx.x >= kConsumers) {     // the loading warp: one lane
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int sm = m_begin; sm < m_end; sm += 128) {
      for (int sn = n_begin; sn < n_end; sn += 128) {
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int s = it % kStages;
          const uint32_t full = bars + 8 * s;
          bar_wait(bars + 8 * (2 * kStages + s), ((it / kStages) & 1) ^ 1);
          bar_expect(full, kLanded);
          const uint32_t stage = shared_addr(smem + s * kStageBytes);
          const int k = k_lo + c * kChunk;
          tma_load(stage, &map_a, full, k, sm);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load(stage + 2 * kTileBytes + j * kBoxBytes, &map_b, full,
                     sn + 32 * j, k);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wgi = tid / 128;           // columns 64 wgi .. + 63 of a sub-tile
  const int w = tid / 32 % 4;          // the warp's 16 fragment rows
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  // Fragment row g + 8 h of warp w is column col[h] of the sub-tile: in box
  // 2 wgi + w / 2 of B's chunk, at (g % 4) + 16 (g / 4) + 4 (2 (w % 2) + h).
  // Its 16-byte group x + 4 (g / 4), x = 2 (w % 2) + h, is stored at
  // group ^ (k % 8) in row k; over the 32 lanes (t, g) of one read that
  // makes 32 banks.
  int col[2];
  uint32_t frag[4];                    // a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = 2 * (w % 2) + h;
    col[h] = 64 * wgi + 32 * (w / 2) + (g % 4) + 16 * (g / 4) + 4 * x;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = t + 4 * q;
      frag[h + 2 * q] = (2 * wgi + w / 2) * kBoxBytes + k * 128 +
                        (((x + 4 * (g / 4)) ^ k) << 4) + (g % 4) * 4;
    }
  }

  int it = 0;
  for (int sm = m_begin; sm < m_end; sm += 128) {
    for (int sn = n_begin; sn < n_end; sn += 128) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      tf32x3::FragA f0[4], f1[4];      // two sets: see consume
      for (int c = 0; c < n_chunks; c += 2) {
        consume(acc, f0, f1, smem, bars, it++, frag, c == 0);
        if (c + 1 < n_chunks)
          consume(acc, f1, f0, smem, bars, it++, frag, false);
      }
      mma_wait<0>();
      hold(f0);
      hold(f1);
      hold(acc);
      if (tid % 32 == 0)
        bar_arrive(bars + 8 * (2 * kStages + (it + kStages - 1) % kStages));

      // acc[4 j + 2 h + e] is C[sm + 8 j + 2 t + e][sn + col[h]]
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = sm + 8 * j + 2 * t + e;
          if (row >= m_end) continue;
          float* dst = out + static_cast<size_t>(row) * N + sn;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (sn + col[h] < n_end) dst[col[h]] = acc[4 * j + 2 * h + e];
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (this
// library does not link libcuda); null where libcuda lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major rows x cols fp32 matrix read in boxes of box_rows x box_cols
// (box_cols x 4 = 128 bytes, the swizzle's span).
bool tensor_map(CUtensorMap* map, const float* base, int rows, int cols,
                int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const float* a, const float* b, float* out, int m, int n,
                   int k, int block_m, int block_n, int tiles_m, int tiles_n,
                   int n_fastest, int split_k, unsigned grid,
                   cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, m, k, 128, kChunk) ||
      !tensor_map(&map_b, b, k, n, kChunk, 32))
    return cudaErrorNotSupported;
  const cudaError_t set = cudaFuncSetAttribute(
      matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (set != cudaSuccess) return set;
  matmul_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      map_a, map_b, out, m, n, k, block_m, block_n, tiles_m, tiles_n,
      n_fastest, split_k);
  return cudaGetLastError();
}

}  // namespace wg

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// What repro_matmul_f32 returns for a launch without error on the wgmma
// path (a cudaError_t is never negative).
constexpr int kWgmmaLaunched = -1;

// loop_order: 0 = "mnk", 1 = "nmk".  splits: the number of blocks that share
// each output tile's K sweep, each a run of ceil(steps / splits) whole
// BLOCK_K steps (steps = ceil(k / block_k)); every split must hold at least
// one step.  workspace: splits x m x n floats when splits > 1, else unused.
// Returns a cudaError_t as int, or kWgmmaLaunched (see the header).
extern "C" int repro_matmul_f32(const float* a, const float* b, float* c,
                                float* workspace, int m, int n, int k,
                                int block_m, int block_n, int block_k,
                                int loop_order, int splits, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || block_m <= 0 || block_n <= 0 ||
      block_k <= 0 || (loop_order != 0 && loop_order != 1) || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long steps = (static_cast<long long>(k) + block_k - 1) / block_k;
  const long long per = splits > 1 ? (steps + splits - 1) / splits : steps;
  if (splits > 1 && (workspace == nullptr || per == 0 ||
                     (steps + per - 1) / per != splits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long split_k = splits > 1 ? per * block_k : k;
  const int tiles_m = (m + block_m - 1) / block_m;
  const int tiles_n = (n + block_n - 1) / block_n;
  const long long grid = static_cast<long long>(tiles_m) * tiles_n * splits;
  if (grid > INT_MAX || split_k > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? workspace : c;
  const bool vec = k % 4 == 0 && n % 4 == 0 && block_n % 4 == 0 &&
                   split_k % 4 == 0 && aligned16(a) && aligned16(b);
  const bool wgmma = vec && block_m >= 128 && block_n >= 128 && m >= 128 &&
                     n >= 128 && k > 0 &&
                     (splits == 1 || split_k % kChunk == 0);
  const int n_fastest = loop_order == 0 ? 1 : 0;
  const int sk = static_cast<int>(split_k);
  cudaError_t err =
      wgmma ? wg::launch(a, b, out, m, n, k, block_m, block_n, tiles_m,
                         tiles_n, n_fastest, sk, static_cast<unsigned>(grid),
                         st)
      : vec ? dispatch<true>(a, b, out, m, n, k, block_m, block_n, tiles_m,
                             tiles_n, n_fastest, sk,
                             static_cast<unsigned>(grid), st)
            : dispatch<false>(a, b, out, m, n, k, block_m, block_n, tiles_m,
                              tiles_n, n_fastest, sk,
                              static_cast<unsigned>(grid), st);
  if (err == cudaSuccess && splits > 1) {
    const size_t mn = static_cast<size_t>(m) * n;
    const size_t blocks = (mn + kReduceThreads - 1) / kReduceThreads;
    reduce_splits_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                               : 4096),
                           kReduceThreads, 0, st>>>(workspace, c, mn, splits);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return wgmma ? kWgmmaLaunched : 0;
}
