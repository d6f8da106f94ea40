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
//   is the practical floor.  Shared memory and the threads that split the
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
// Tuning parameters and the code path:
//   BLOCK_M, BLOCK_N  the output tile of one block, hence the grid, the
//                     split count, the number of sub-tiles a block walks and
//                     the sub-tile: 128 x 128 (4 warps) where both are
//                     >= 128, else 64 on the short side (8 warps, so that a
//                     64 x 64 tile keeps all of them busy);
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
// given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// loop_order: 0 = "mnk", 1 = "nmk".  splits: the number of blocks that share
// each output tile's K sweep, each a run of ceil(steps / splits) whole
// BLOCK_K steps (steps = ceil(k / block_k)); every split must hold at least
// one step.  workspace: splits x m x n floats when splits > 1, else unused.
// Returns a cudaError_t as int.
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
  const int n_fastest = loop_order == 0 ? 1 : 0;
  const int sk = static_cast<int>(split_k);
  cudaError_t err =
      vec ? dispatch<true>(a, b, out, m, n, k, block_m, block_n, tiles_m,
                           tiles_n, n_fastest, sk,
                           static_cast<unsigned>(grid), st)
          : dispatch<false>(a, b, out, m, n, k, block_m, block_n, tiles_m,
                            tiles_n, n_fastest, sk,
                            static_cast<unsigned>(grid), st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t blocks = (mn + kReduceThreads - 1) / kReduceThreads;
  reduce_splits_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                         kReduceThreads, 0, st>>>(workspace, c, mn, splits);
  return static_cast<int>(cudaGetLastError());
}
