// Single-channel "same" 2-D correlation for Hopper (sm_90a):
// out[y][x] = sum_{dy,dx} flt[dy][dx] * img[y + dy - F/2][x + dx - F/2],
// the image taken as zero outside its (H, W) bounds; fp32, row-major.
//
// Replaces the Pallas TPU kernel `conv2d` of
// src/repro/kernels/conv2d/kernel.py (body `_conv2d_kernel`).  That kernel
// copies one (BY + F - 1, BX + F - 1) halo tile a program from a zero-padded
// copy of the image into VMEM and sums F x F shifted multiply-adds.  This
// kernel computes the same function without the padded copy: its halo
// copies zero-fill what lies outside the image, which saves a whole extra
// pass over the image in device memory.
//
// What bounds it on the H100.  4096 x 4096 with F = 5 reads 64 MiB and
// writes 64 MiB: 0.040 ms at 3.35 TB/s; its 0.84 GFLOP take 0.013 ms at
// 67 TFLOP/s.  So it is bound by bytes.  Two things stood between a staged
// design and that bound: shared-memory reads (25 words an output, 1.68 GB
// at 4096^2, 0.050 ms at 33.45 TB/s) and halo loads that nothing overlapped
// inside a block.
//
// The design.  A TPU tile reaches 512 x 1024 outputs (a 2.1 MB halo tile),
// beyond a block's 227 KB of shared memory, so a block of 128 threads
// (32 x 4) walks its BY x BX tile in 32 x 128 output sub-tiles.
//   - A ring of DMA_DEPTH halo stages, each (32 + F - 1) rows of the
//     sub-tile's columns widened by m = round_up(F / 2, 4) on each side,
//     filled by cp.async: the next DMA_DEPTH - 1 sub-tiles' halos are in
//     flight while this one's taps run.  A 4-column chunk of an image row
//     that lies inside the image and starts on a 16-byte boundary is one
//     16-byte copy (every chunk of the interior when W % 4 == 0); one that
//     lies wholly outside is one 16-byte zero fill (src-size 0); the rest,
//     the chunks of unaligned rows and those across the image's edge, take
//     four 4-byte copies, each zero-filled outside (`load_halo`).
//   - Register-blocked taps (UNROLL_TAPS = 1, F <= 13): each thread owns
//     8 rows x 4 contiguous columns of outputs.  It reads each of its 8 + F - 1 halo
//     rows once, as three 16-byte words (one at F = 1) at 16-byte offsets,
//     conflict-free across the warp, and sums every tap that row feeds from
//     registers: 36 reads for 32 outputs at F = 5, about 4.5 words an
//     output instead of 25.
//   - Looped taps (UNROLL_TAPS = 0): one tap an iteration at run time, as
//     the Pallas fori_loop does, for any odd F up to 31; each thread owns 8
//     rows x 4 columns 32 apart, so that its scalar reads are conflict-free.
// Taps are summed in row-major order for each output, as the Pallas kernel
// sums them.  A thread's 4 outputs of a row are one 16-byte store where
// they start on a 16-byte boundary (every row when W % 4 == 0).
//
// Tuning parameters and the code path:
//   BY, BX         set the tile of one block, hence the grid size and how
//                  many sub-tiles a block walks (BY < 32 leaves thread rows
//                  idle, and fewer halo rows are copied);
//   UNROLL_TAPS=1  a template on F: register-blocked taps, compiled for
//                  F = 1, 3, ..., 13 (the C entry's switch); 0 the run-time
//                  tap loop.  The register-blocked kernel holds a row of
//                  4 + F - 1 words, 32 accumulators and, with the filter in
//                  device memory, F * F weights in registers, and its code
//                  grows with F * F, so it is compiled only where ptxas
//                  reports no spill: F = 15 spills in the constant-filter
//                  kernel (chip_smoke.py builds a probe with
//                  -DREPRO_CONV2D_PROBE_F=15 and prints its report; PERF.md,
//                  section 6).  For a larger odd F (up to 31) the
//                  C entry lowers UNROLL_TAPS = 1 to the looped kernel: there
//                  the two values of UNROLL_TAPS are one code path under two
//                  configurations of the space and the model (the wrapper's
//                  `taps_kernel` says which kernel runs);
//   FILTER_SMEM=1  the filter in __constant__ memory, copied there on the
//                  stream before the launch (on the TPU "SMEM" is scalar
//                  memory, whose counterpart is the constant cache) and read
//                  as an operand of each FFMA; 0 the filter read from device
//                  memory by each block into shared memory (and from there
//                  into registers for unrolled taps);
//   DMA_DEPTH      the stages of the cp.async ring (1, 2 or 4; 1 loads each
//                  sub-tile only after the last one's taps are done).
//
// Entry: repro_conv2d_f32 (plain C, loaded with ctypes).  It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kSubY = 32;                // output rows of a sub-tile
constexpr int kSubX = 128;               // output columns of a sub-tile
constexpr int kRows = 8;                 // outputs a thread owns: 8 x 4
constexpr int kCols = 4;
constexpr int kThreadsX = kSubX / kCols; // 32: one warp across a sub-tile
constexpr int kThreadsY = kSubY / kRows; // 4
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMaxF = 31;
constexpr int kMaxDepth = 4;
constexpr int kMaxSmem = 232448;         // 227 KB a block

__constant__ float c_filter[kMaxF * kMaxF];

// Columns staged on each side of a sub-tile: F / 2 rounded up to a whole
// 16-byte chunk (a chunk starts on a 4-column boundary when BX % 4 == 0).
__host__ __device__ constexpr int margin(int f) { return ((f / 2) + 3) & ~3; }
__host__ __device__ constexpr int pitch(int f) { return kSubX + 2 * margin(f); }
__host__ __device__ constexpr int stage_floats(int f) {
  return (kSubY + f - 1) * pitch(f);
}

// Issues the copies of one sub-tile's halo (rows sy - F/2 .. sy + rows - 1
// + F/2, columns sx - margin .. sx + 128 + margin - 1) into `stage`.
// wide: the image starts on a 16-byte boundary.
__device__ __forceinline__ void load_halo(float* stage,
                                          const float* __restrict__ img,
                                          int H, int W, int F, int sy, int sx,
                                          int rows, bool wide) {
  const int m = margin(F);
  const int chunks = pitch(F) / 4;
  const int gx0 = sx - m;
  const int gy0 = sy - F / 2;
  for (int k = threadIdx.x; k < rows * chunks; k += kThreads) {
    const int r = k / chunks;
    const int c = k - r * chunks;
    const int gy = gy0 + r;
    const int gx = gx0 + 4 * c;
    float* dst = stage + r * pitch(F) + 4 * c;
    if (gy < 0 || gy >= H || gx + 4 <= 0 || gx >= W) {
      async_copy::cp_async16(dst, img, 0);                  // zero fill
      continue;
    }
    const size_t at = static_cast<size_t>(gy) * W;
    if (wide && gx >= 0 && gx + 4 <= W && ((at + gx) & 3) == 0) {
      async_copy::cp_async16(dst, img + at + gx, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = gx + e >= 0 && gx + e < W;
        async_copy::cp_async4(dst + e, in ? img + at + gx + e : img, in);
      }
    }
  }
}

// kF > 0: register-blocked taps for that F; kF == 0: taps looped, F = f.
template <int kF, bool kConstFilter>
__global__ void __launch_bounds__(kThreads)
conv2d_f32_kernel(const float* __restrict__ img,
                  const float* __restrict__ flt, float* __restrict__ out,
                  int H, int W, int f, int by, int bx, int tiles_x, int depth,
                  int wide_in, int wide_out) {
  extern __shared__ __align__(16) float smem[];
  const int F = kF > 0 ? kF : f;
  const int pad = F / 2;
  const int ld = pitch(F);
  const int stage_size = stage_floats(F);
  float* s_flt = smem + depth * stage_size;   // [F * F], device-memory filter

  const int y_begin = (blockIdx.x / tiles_x) * by;
  const int x_begin = (blockIdx.x % tiles_x) * bx;
  const int y_end = min(y_begin + by, H);
  const int x_end = min(x_begin + bx, W);
  const int subs_x = (x_end - x_begin + kSubX - 1) / kSubX;
  const int n_sub = ((y_end - y_begin + kSubY - 1) / kSubY) * subs_x;
  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const int row0 = ty * kRows;               // the thread's first output row

  // the filter in shared memory and, for unrolled taps, in registers
  float w[kF > 0 && !kConstFilter ? kF * kF : 1];
  if constexpr (!kConstFilter) {
    for (int k = threadIdx.x; k < F * F; k += kThreads) s_flt[k] = flt[k];
    __syncthreads();
    if constexpr (kF > 0) {
#pragma unroll
      for (int t = 0; t < kF * kF; ++t) w[t] = s_flt[t];
    }
  }
  auto issue = [&](int s) {
    const int sy = y_begin + (s / subs_x) * kSubY;
    const int sx = x_begin + (s % subs_x) * kSubX;
    load_halo(smem + (s % depth) * stage_size, img, H, W, F, sy, sx,
              min(kSubY, y_end - sy) + F - 1, wide_in != 0);
  };
  for (int s = 0; s < depth - 1; ++s) {
    if (s < n_sub) issue(s);
    async_copy::cp_async_commit();
  }


  for (int s = 0; s < n_sub; ++s) {
    if (s + depth - 1 < n_sub) issue(s + depth - 1);
    async_copy::cp_async_commit();
    async_copy::cp_async_wait_pending(depth - 1);   // sub-tile s has landed
    __syncthreads();

    const int sy = y_begin + (s / subs_x) * kSubY;
    const int sx = x_begin + (s % subs_x) * kSubX;
    const float* stage = smem + (s % depth) * stage_size;
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

    if (sy + row0 < y_end) {
      if constexpr (kF > 0) {
        // the thread's window starts at column 4 tx + off of the stage; it
        // reads the 16-byte words from column 4 tx on
        constexpr int off = margin(kF) - kF / 2;
        constexpr int words = (off + kCols + kF - 1 + 3) / 4;
        const float* base = stage + row0 * ld + kCols * tx;
#pragma unroll
        for (int h = 0; h < kRows + kF - 1; ++h) {
          float win[4 * words];
#pragma unroll
          for (int q = 0; q < words; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(base + h * ld + 4 * q);
            win[4 * q] = v.x;
            win[4 * q + 1] = v.y;
            win[4 * q + 2] = v.z;
            win[4 * q + 3] = v.w;
          }
          // halo row h feeds output row r through filter row h - r; rows
          // come in order, so each output's taps are summed row-major
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int dy = h - r;
            if (dy < 0 || dy >= kF) continue;
#pragma unroll
            for (int dx = 0; dx < kF; ++dx) {
              const float wt = kConstFilter ? c_filter[dy * kF + dx]
                                            : w[dy * kF + dx];
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                acc[r][c] = fmaf(wt, win[off + c + dx], acc[r][c]);
            }
          }
        }
      } else {
        // columns tx + 32 c: neighbouring lanes read neighbouring words
        const float* base = stage + row0 * ld + margin(F) - pad + tx;
#pragma unroll 1
        for (int dy = 0; dy < F; ++dy) {
#pragma unroll 1
          for (int dx = 0; dx < F; ++dx) {
            const float wt = kConstFilter ? c_filter[dy * F + dx]
                                          : s_flt[dy * F + dx];
            const float* p = base + dy * ld + dx;
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                acc[r][c] = fmaf(wt, p[r * ld + kThreadsX * c], acc[r][c]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int y = sy + row0 + r;
      if (y >= y_end) break;
      float* row = out + static_cast<size_t>(y) * W;
      if constexpr (kF > 0) {
        const int x = sx + kCols * tx;
        if (wide_out && x + kCols <= x_end &&
            ((static_cast<size_t>(y) * W + x) & 3) == 0) {
          *reinterpret_cast<float4*>(row + x) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (x + c < x_end) row[x + c] = acc[r][c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int x = sx + tx + kThreadsX * c;
          if (x < x_end) row[x] = acc[r][c];
        }
      }
    }
    __syncthreads();   // every thread is done with stage s % depth
  }
  async_copy::cp_async_wait_pending(0);
}

template <int kF>
cudaError_t launch(bool const_filter, unsigned grid, size_t smem,
                   cudaStream_t s, const float* img, const float* flt,
                   float* out, int h, int w, int f, int by, int bx,
                   int tiles_x, int depth, int wide_in, int wide_out) {
  auto kernel = const_filter ? conv2d_f32_kernel<kF, true>
                             : conv2d_f32_kernel<kF, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, s>>>(img, flt, out, h, w, f, by, bx,
                                      tiles_x, depth, wide_in, wide_out);
  return cudaGetLastError();
}

}  // namespace

// dma_depth: the stages of the halo ring, 1 to 4.  Returns a cudaError_t as
// int.
extern "C" int repro_conv2d_f32(const float* img, const float* flt,
                                float* out, int h, int w, int f, int by,
                                int bx, int unroll_taps, int filter_smem,
                                int dma_depth, void* stream) {
  if (h <= 0 || w <= 0 || f <= 0 || f % 2 == 0 || f > kMaxF || by <= 0 ||
      bx <= 0 || (unroll_taps != 0 && unroll_taps != 1) ||
      (filter_smem != 0 && filter_smem != 1) || dma_depth < 1 ||
      dma_depth > kMaxDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_y = (h + by - 1) / by;
  const int tiles_x = (w + bx - 1) / bx;
  const long long grid = static_cast<long long>(tiles_y) * tiles_x;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool const_filter = filter_smem == 1;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(dma_depth) * stage_floats(f) +
       (const_filter ? 0 : f * f));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (const_filter) {
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_filter, flt, sizeof(float) * f * f, 0, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int wide_in = reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const int wide_out = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned g = static_cast<unsigned>(grid);
  cudaError_t err;
#define REPRO_CONV2D_F(F)                                                  \
  case F:                                                                  \
    err = launch<F>(const_filter, g, smem, s, img, flt, out, h, w, f, by,  \
                    bx, tiles_x, dma_depth, wide_in, wide_out);            \
    break;
  switch (unroll_taps ? f : 0) {
    REPRO_CONV2D_F(1)
    REPRO_CONV2D_F(3)
    REPRO_CONV2D_F(5)
    REPRO_CONV2D_F(7)
    REPRO_CONV2D_F(9)
    REPRO_CONV2D_F(11)
    REPRO_CONV2D_F(13)
#ifdef REPRO_CONV2D_PROBE_F   // one more F, built only to read ptxas's report
    REPRO_CONV2D_F(REPRO_CONV2D_PROBE_F)
#endif
    default:   // looped taps; UNROLL_TAPS = 1 above the compiled F lowers here
      err = launch<0>(const_filter, g, smem, s, img, flt, out, h, w, f, by,
                      bx, tiles_x, dma_depth, wide_in, wide_out);
  }
#undef REPRO_CONV2D_F
  return static_cast<int>(err);
}
