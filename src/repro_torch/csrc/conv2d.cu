// Single-channel "same" 2-D correlation for Hopper (sm_90a):
// out[y][x] = sum_{dy,dx} flt[dy][dx] * img[y + dy - F/2][x + dx - F/2],
// the image taken as zero outside its (H, W) bounds; fp32, row-major.
//
// Replaces the Pallas TPU kernel `conv2d` of
// src/repro/kernels/conv2d/kernel.py (body `_conv2d_kernel`).  That kernel
// copies one (BY + F - 1, BX + F - 1) halo tile a program from a zero-padded
// copy of the image into VMEM and sums F x F shifted multiply-adds.  This
// kernel computes the same function without the padded copy: its halo
// loads are masked at the image's edges (zeros), which saves a whole extra
// pass over the image in device memory.
//
// What bounds it on the H100.  4096 x 4096 with F = 5 reads 64 MiB and
// writes 64 MiB: 0.040 ms at 3.35 TB/s; its 0.84 GFLOP take 0.013 ms at
// 67 TFLOP/s.  So it is bound by bytes, and the halo tile is staged in
// shared memory so that each image element is read from device memory
// about once (the halo overlap adds (32 + F - 1)(128 + F - 1) / (32 x 128),
// 16 % at F = 5, mostly from L2).
//
// The design.  A TPU tile reaches 512 x 1024 outputs (a 2.1 MB halo tile),
// beyond a block's 227 KB of shared memory, so a block of 256 threads
// (32 x 8) walks its BY x BX tile in 32 x 128 output sub-tiles.  For each,
// the block loads the (32 + F - 1) x (128 + F - 1) halo sub-tile into
// dynamic shared memory, then each thread sums F x F taps for a 4 x 4 set
// of outputs (rows ty + 8i, columns tx + 32j: neighbouring threads read
// neighbouring words, free of bank conflicts).  Taps are summed in
// row-major order, as the Pallas kernel sums them.
//
// Tuning parameters and the code path:
//   BY, BX         set the tile of one block, hence the grid size and how
//                  many sub-tiles a block walks (BY < 32 leaves thread rows
//                  idle);
//   UNROLL_TAPS=1  a template on F unrolls the taps at compile time
//                  (F = 1, 3, 5, 7); 0 loops over the F x F taps at run
//                  time, one tap an iteration, as the Pallas fori_loop does;
//   FILTER_SMEM=1  the filter in __constant__ memory, copied there on the
//                  stream before the launch (on the TPU "SMEM" is scalar
//                  memory, whose counterpart is the constant cache); 0 the
//                  filter read from device memory by each block into shared
//                  memory;
//   DMA_DEPTH      is priced by the workload model only: the halo load is
//                  not pipelined (one stage).
//
// Entry: repro_conv2d_f32 (plain C, loaded with ctypes).  It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kSubY = 32;                // output rows of a sub-tile
constexpr int kSubX = 128;               // output columns of a sub-tile
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kOutY = kSubY / kThreadsY; // outputs a thread holds: 4 x 4
constexpr int kOutX = kSubX / kThreadsX;
constexpr int kMaxF = 31;                // keeps shared memory under 48 KB

__constant__ float c_filter[kMaxF * kMaxF];

// kF > 0: taps unrolled for that F; kF == 0: taps looped, F = f.
template <int kF, bool kConstFilter>
__global__ void __launch_bounds__(kThreads)
conv2d_f32_kernel(const float* __restrict__ img,
                  const float* __restrict__ flt, float* __restrict__ out,
                  int H, int W, int f, int by, int bx, int tiles_x) {
  extern __shared__ float smem[];
  const int F = kF > 0 ? kF : f;
  const int pad = (F - 1) / 2;
  const int pitch = kSubX + F - 1;
  const int halo_rows = kSubY + F - 1;
  const int halo_elems = halo_rows * pitch;
  float* tile = smem;                    // [halo_rows][pitch]
  float* s_flt = smem + halo_elems;      // [F * F], device-memory filter

  const int y_begin = (blockIdx.x / tiles_x) * by;
  const int x_begin = (blockIdx.x % tiles_x) * bx;
  const int y_end = min(y_begin + by, H);
  const int x_end = min(x_begin + bx, W);
  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;

  if constexpr (!kConstFilter) {
    for (int k = threadIdx.x; k < F * F; k += kThreads) s_flt[k] = flt[k];
  }

  for (int sy = y_begin; sy < y_end; sy += kSubY) {
    for (int sx = x_begin; sx < x_end; sx += kSubX) {
      __syncthreads();   // the previous sub-tile's reads are done
      for (int k = threadIdx.x; k < halo_elems; k += kThreads) {
        const int r = k / pitch;
        const int c = k - r * pitch;
        const int gy = sy - pad + r;
        const int gx = sx - pad + c;
        tile[k] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                      ? img[static_cast<size_t>(gy) * W + gx]
                      : 0.f;
      }
      __syncthreads();

      float acc[kOutY][kOutX];
#pragma unroll
      for (int i = 0; i < kOutY; ++i)
#pragma unroll
        for (int j = 0; j < kOutX; ++j) acc[i][j] = 0.f;

      if constexpr (kF > 0) {
#pragma unroll
        for (int dy = 0; dy < kF; ++dy) {
#pragma unroll
          for (int dx = 0; dx < kF; ++dx) {
            const int t = dy * F + dx;
            const float w = kConstFilter ? c_filter[t] : s_flt[t];
#pragma unroll
            for (int i = 0; i < kOutY; ++i)
#pragma unroll
              for (int j = 0; j < kOutX; ++j)
                acc[i][j] += w * tile[(ty + kThreadsY * i + dy) * pitch +
                                      tx + kThreadsX * j + dx];
          }
        }
      } else {
#pragma unroll 1
        for (int t = 0; t < F * F; ++t) {
          const int dy = t / F;
          const int dx = t - dy * F;
          const float w = kConstFilter ? c_filter[t] : s_flt[t];
#pragma unroll
          for (int i = 0; i < kOutY; ++i)
#pragma unroll
            for (int j = 0; j < kOutX; ++j)
              acc[i][j] += w * tile[(ty + kThreadsY * i + dy) * pitch +
                                    tx + kThreadsX * j + dx];
        }
      }

#pragma unroll
      for (int i = 0; i < kOutY; ++i) {
        const int y = sy + ty + kThreadsY * i;
        if (y >= y_end) continue;
#pragma unroll
        for (int j = 0; j < kOutX; ++j) {
          const int x = sx + tx + kThreadsX * j;
          if (x < x_end) out[static_cast<size_t>(y) * W + x] = acc[i][j];
        }
      }
    }
  }
}

template <int kF>
void launch(bool const_filter, unsigned grid, size_t smem, cudaStream_t s,
            const float* img, const float* flt, float* out, int h, int w,
            int f, int by, int bx, int tiles_x) {
  if (const_filter) {
    conv2d_f32_kernel<kF, true><<<grid, kThreads, smem, s>>>(
        img, flt, out, h, w, f, by, bx, tiles_x);
  } else {
    conv2d_f32_kernel<kF, false><<<grid, kThreads, smem, s>>>(
        img, flt, out, h, w, f, by, bx, tiles_x);
  }
}

}  // namespace

// Returns a cudaError_t as int.
extern "C" int repro_conv2d_f32(const float* img, const float* flt,
                                float* out, int h, int w, int f, int by,
                                int bx, int unroll_taps, int filter_smem,
                                void* stream) {
  if (h <= 0 || w <= 0 || f <= 0 || f % 2 == 0 || f > kMaxF || by <= 0 ||
      bx <= 0 || (unroll_taps != 0 && unroll_taps != 1) ||
      (filter_smem != 0 && filter_smem != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_y = (h + by - 1) / by;
  const int tiles_x = (w + bx - 1) / bx;
  const long long grid = static_cast<long long>(tiles_y) * tiles_x;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool const_filter = filter_smem == 1;
  if (const_filter) {
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_filter, flt, sizeof(float) * f * f, 0, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) *
      ((kSubY + f - 1) * (kSubX + f - 1) + (const_filter ? 0 : f * f));
  const unsigned g = static_cast<unsigned>(grid);
  if (!unroll_taps) {
    launch<0>(const_filter, g, smem, s, img, flt, out, h, w, f, by, bx, tiles_x);
  } else if (f == 1) {
    launch<1>(const_filter, g, smem, s, img, flt, out, h, w, f, by, bx, tiles_x);
  } else if (f == 3) {
    launch<3>(const_filter, g, smem, s, img, flt, out, h, w, f, by, bx, tiles_x);
  } else if (f == 5) {
    launch<5>(const_filter, g, smem, s, img, flt, out, h, w, f, by, bx, tiles_x);
  } else if (f == 7) {
    launch<7>(const_filter, g, smem, s, img, flt, out, h, w, f, by, bx, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
