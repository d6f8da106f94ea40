// Tiled fp32 GEMM for Hopper (sm_90a): C = A · B, row-major, fp32 in and out.
//
// Replaces the Pallas TPU kernel `matmul` of src/repro/kernels/matmul/kernel.py
// (body `_matmul_kernel`).  That kernel keeps one (BLOCK_M, BLOCK_N) fp32
// accumulator in VMEM per grid program and sweeps K in BLOCK_K steps,
// masking the K tail.  This kernel computes the same function: fp32
// accumulation with IEEE fused multiply-adds (no TF32), ragged M, N and K
// edges masked on load and on store.
//
// What bounds it on the H100.  An n³ product does 2n³ operations on 12n²
// bytes; at 2048³ that is 17.2 GFLOP against 50 MB, far above the card's
// 67 TFLOP/s : 3.35 TB/s balance, so the fp32 pipes bound it (0.256 ms at
// peak).  Skinny products (16 x 4096 x 4096) are bound by reading B once
// (0.020 ms at 3.35 TB/s).  The tensor cores are not used: the TPU kernel
// is an fp32 product and TF32 would change its numbers.
//
// The design.  A TPU tile of up to 512 x 512 x 1024 (6 MiB) does not fit a
// block's 227 KB of shared memory and 255 registers a thread, so a block
// covers its BLOCK_M x BLOCK_N output tile in 64 x 64 sub-tiles, one after
// another.  256 threads each hold a 4 x 4 register micro-tile of a sub-tile.
// K is swept in BLOCK_K steps; each step is staged through static shared
// memory in 32-deep chunks (A transposed, 17 KB per chunk), and every value
// staged there feeds 64 fused multiply-adds from registers.
//
// Tuning parameters and the code path:
//   BLOCK_M, BLOCK_N  set the output tile of one block, hence the grid size,
//                     the number of 64 x 64 sub-tiles a block walks, and how
//                     often A and B are re-read through L2;
//   LOOP_ORDER        sets the raster: "mnk" (0) lets consecutive blocks walk
//                     N tiles, "nmk" (1) M tiles;
//   BLOCK_K           only sets the K sweep step (chunks stay 32 deep);
//   ACC_F32           is ignored, as the Pallas kernel ignores it;
//   OUT_SWIZZLE, K_UNROLL, PREFETCH_DEPTH (GEMM-full) are priced by the
//                     workload model only.
//
// Entry: repro_matmul_f32 (plain C, loaded with ctypes).  It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kSub = 64;                 // sub-tile edge
constexpr int kChunk = 32;               // K depth staged in shared memory
constexpr int kThreads = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPadA = 4;                 // keeps float4 reads of As aligned
constexpr int kLoads = kSub * kChunk / kThreads;  // elements per thread per chunk

__global__ void __launch_bounds__(kThreads)
matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, int block_m,
                  int block_n, int block_k, int tiles_m, int tiles_n,
                  int n_fastest) {
  __shared__ __align__(16) float As[kChunk][kSub + kPadA];  // As[k][m]
  __shared__ __align__(16) float Bs[kChunk][kSub];          // Bs[k][n]

  const int tile = blockIdx.x;
  int tm, tn;
  if (n_fastest) {
    tn = tile % tiles_n;
    tm = tile / tiles_n;
  } else {
    tm = tile % tiles_m;
    tn = tile / tiles_m;
  }
  const int m_begin = tm * block_m;
  const int n_begin = tn * block_n;
  const int m_end = min(m_begin + block_m, M);
  const int n_end = min(n_begin + block_n, N);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  for (int sm = m_begin; sm < m_end; sm += kSub) {
    for (int sn = n_begin; sn < n_end; sn += kSub) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < K; k0 += block_k) {
        const int k_end = min(k0 + block_k, K);
        for (int kc = k0; kc < k_end; kc += kChunk) {
          // A[sm:sm+64, kc:kc+32] -> As, transposed; a warp reads one row
          // segment of 32 consecutive floats
#pragma unroll
          for (int e = 0; e < kLoads; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            const int r = idx / kChunk;
            const int c = idx % kChunk;
            const int gr = sm + r;
            const int gk = kc + c;
            As[c][r] = (gr < m_end && gk < k_end)
                           ? A[static_cast<size_t>(gr) * K + gk]
                           : 0.f;
          }
          // B[kc:kc+32, sn:sn+64] -> Bs
#pragma unroll
          for (int e = 0; e < kLoads; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            const int r = idx / kSub;
            const int c = idx % kSub;
            const int gk = kc + r;
            const int gc = sn + c;
            Bs[r][c] = (gk < k_end && gc < n_end)
                           ? B[static_cast<size_t>(gk) * N + gc]
                           : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < kChunk; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float a[4] = {av.x, av.y, av.z, av.w};
            const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = sm + ty * 4 + i;
        if (row >= m_end) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = sn + tx * 4 + j;
          if (col < n_end) C[static_cast<size_t>(row) * N + col] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

// loop_order: 0 = "mnk", 1 = "nmk".  Returns a cudaError_t as int.
extern "C" int repro_matmul_f32(const float* a, const float* b, float* c,
                                int m, int n, int k, int block_m, int block_n,
                                int block_k, int loop_order, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || block_m <= 0 || block_n <= 0 ||
      block_k <= 0 || (loop_order != 0 && loop_order != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_m = (m + block_m - 1) / block_m;
  const int tiles_n = (n + block_n - 1) / block_n;
  const long long grid = static_cast<long long>(tiles_m) * tiles_n;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  matmul_f32_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, k, block_m, block_n, block_k, tiles_m, tiles_n,
      loop_order == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
