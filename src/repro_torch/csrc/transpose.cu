// Out-of-place fp32 transpose for Hopper (sm_90a): out (N, M) = in (M, N)^T,
// both row-major.
//
// Replaces the Pallas TPU kernel `transpose` of
// src/repro/kernels/transpose/kernel.py (body `_transpose_kernel`), which
// moves one (BLOCK_M, BLOCK_N) tile a program through VMEM and writes it
// back as a (BLOCK_N, BLOCK_M) tile.  The result is exact: nothing but
// loads and stores.
//
// What bounds it on the H100.  Each byte is read once and written once:
// 8192 x 8192 fp32 moves 2 x 256 MiB, 0.160 ms at 3.35 TB/s.  Nothing else
// comes close, so the design is about keeping both the reads and the
// writes coalesced (a warp touching 32 consecutive floats).
//
// The design.  A TPU tile reaches 1024 x 1024 floats (4 MiB), far beyond a
// block's 227 KB of shared memory, so a block of 256 threads (32 x 8) walks
// its BLOCK_M x BLOCK_N tile in 32 x 32 sub-tiles, each thread moving four
// elements of a sub-tile.  Sub-tiles and tiles are clipped to the matrix,
// so ragged M and N need no padding.
//
// Tuning parameters and the code path:
//   BLOCK_M, BLOCK_N  set the tile of one block, hence the grid size and
//                     how many sub-tiles a block walks (tiles under 32 on
//                     a side leave threads of the block idle);
//   STAGE_OUT = 1     stages each sub-tile through shared memory padded to
//                     [32][33] (no bank conflicts on the transposed read),
//                     so that reads and writes are both coalesced: the
//                     paper's CUDA transpose axis;
//   STAGE_OUT = 0     writes each element direct: reads coalesced, writes
//                     strided by M (32 sectors per warp store).
//
// Entry: repro_transpose_f32 (plain C, loaded with ctypes).  It launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kSub = 32;                 // sub-tile edge
constexpr int kRows = 8;                 // thread rows: 32 x 8 threads
constexpr int kThreads = kSub * kRows;

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
transpose_f32_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int M, int N, int block_m, int block_n, int tiles_n) {
  __shared__ float buf[kSub][kSub + 1];

  const int m_begin = (blockIdx.x / tiles_n) * block_m;
  const int n_begin = (blockIdx.x % tiles_n) * block_n;
  const int m_end = min(m_begin + block_m, M);
  const int n_end = min(n_begin + block_n, N);
  const int tx = threadIdx.x % kSub;
  const int ty = threadIdx.x / kSub;

  for (int sm = m_begin; sm < m_end; sm += kSub) {
    for (int sn = n_begin; sn < n_end; sn += kSub) {
      if (kStage) {
        // a warp reads 32 consecutive floats of one row of `in`
#pragma unroll
        for (int i = 0; i < kSub; i += kRows) {
          const int r = sm + ty + i;
          const int c = sn + tx;
          if (r < m_end && c < n_end) {
            buf[ty + i][tx] = in[static_cast<size_t>(r) * N + c];
          }
        }
        __syncthreads();
        // and writes 32 consecutive floats of one row of `out`
#pragma unroll
        for (int i = 0; i < kSub; i += kRows) {
          const int c = sn + ty + i;   // row of out
          const int r = sm + tx;       // column of out
          if (c < n_end && r < m_end) {
            out[static_cast<size_t>(c) * M + r] = buf[tx][ty + i];
          }
        }
        __syncthreads();
      } else {
#pragma unroll
        for (int i = 0; i < kSub; i += kRows) {
          const int r = sm + ty + i;
          const int c = sn + tx;
          if (r < m_end && c < n_end) {
            out[static_cast<size_t>(c) * M + r] =
                in[static_cast<size_t>(r) * N + c];
          }
        }
      }
    }
  }
}

}  // namespace

// Returns a cudaError_t as int.
extern "C" int repro_transpose_f32(const float* in, float* out, int m, int n,
                                   int block_m, int block_n, int stage_out,
                                   void* stream) {
  if (m <= 0 || n <= 0 || block_m <= 0 || block_n <= 0 ||
      (stage_out != 0 && stage_out != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_m = (m + block_m - 1) / block_m;
  const int tiles_n = (n + block_n - 1) / block_n;
  const long long grid = static_cast<long long>(tiles_m) * tiles_n;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage_out) {
    transpose_f32_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        in, out, m, n, block_m, block_n, tiles_n);
  } else {
    transpose_f32_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        in, out, m, n, block_m, block_n, tiles_n);
  }
  return static_cast<int>(cudaGetLastError());
}
