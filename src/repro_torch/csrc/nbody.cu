// O(N^2) gravitational accelerations for Hopper (sm_90a): for bodies given
// as rows (x, y, z, m),
//   a_i = sum_j m_j d_ij (|d_ij|^2 + eps)^(-3/2),   d_ij = p_j - p_i,
// with eps added unsquared (as the JAX oracle adds it); out is (N, 4) fp32
// with column 3 zero.
//
// Replaces the Pallas TPU kernel `nbody` of src/repro/kernels/nbody/kernel.py
// (body `_nbody_kernel`).  That kernel gives each program BLOCK_I bodies and
// marches over all bodies in BLOCK_J tiles on a sequential grid axis,
// accumulating in VMEM and zeroing the tail tile.  Here the sequential axis
// is a loop inside the block and the accumulators are registers.
//
// What bounds it on the H100.  Each pair costs one rsqrt on the
// special-function units (4.2 T/s on the SXM part) and 18 fp32 operations
// on the fp32 lanes (67 TFLOP/s): at N = 16384, 0.064 ms and 0.072 ms, so
// the fp32 pipes bound it, with the special-function units close behind;
// bodies are 256 KB, nothing.  The design keeps each body's position and
// acceleration in registers and feeds every thread of a block the same
// streamed body at once (a shared-memory broadcast).
//
// The design.  One thread a body i: a block of BLOCK_I threads (8 to 1024)
// loads BLOCK_J bodies (up to 2048 x 16 B = 32 KB) into dynamic shared
// memory, zeroing the tail past N (a zero mass adds exactly zero), then
// every thread sums their pull on its body; repeat until all N are
// streamed.  Threads past N take part in the loads and barriers and store
// nothing.
//
// Tuning parameters and the code path:
//   BLOCK_I        threads a block, hence the grid size, the occupancy and,
//                  under 32, idle lanes of each warp;
//   BLOCK_J        the shared-memory tile: how often a block loads and
//                  synchronises;
//   J_UNROLL       the unroll factor of the inner loop over the tile, a
//                  template (1, 2, 4);
//   KEEP_PAIRWISE  has no register-file counterpart worth building in this
//                  design (nothing pairwise outlives one iteration); it is
//                  priced by the workload model only.
//
// Entry: repro_nbody_f32 (plain C, loaded with ctypes).  It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlockI = 1024;
constexpr int kMaxBlockJ = 2048;         // 32 KB of shared memory

template <int kUnroll>
__global__ void __launch_bounds__(kMaxBlockI)
nbody_f32_kernel(const float4* __restrict__ bodies, float4* __restrict__ out,
                 int n, int block_j, float softening) {
  extern __shared__ float4 s_bodies[];   // [block_j]

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float4 bi = i < n ? bodies[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float ax = 0.f, ay = 0.f, az = 0.f;

  for (int j0 = 0; j0 < n; j0 += block_j) {
    __syncthreads();   // the previous tile's reads are done
    for (int k = threadIdx.x; k < block_j; k += blockDim.x) {
      s_bodies[k] = j0 + k < n ? bodies[j0 + k]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int k = 0; k < block_j; k += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 bj = s_bodies[k + u];
        const float dx = bj.x - bi.x;
        const float dy = bj.y - bi.y;
        const float dz = bj.z - bi.z;
        const float r2 = dx * dx + dy * dy + dz * dz + softening;
        const float inv_r = rsqrtf(r2);
        const float s = bj.w * inv_r * inv_r * inv_r;
        ax += s * dx;
        ay += s * dy;
        az += s * dz;
      }
    }
  }
  if (i < n) out[i] = make_float4(ax, ay, az, 0.f);
}

}  // namespace

// bodies, out: (n, 4) fp32.  Returns a cudaError_t as int.
extern "C" int repro_nbody_f32(const float* bodies, float* out, int n,
                               int block_i, int block_j, int j_unroll,
                               float softening, void* stream) {
  if (n <= 0 || block_i <= 0 || block_i > kMaxBlockI || block_j <= 0 ||
      block_j > kMaxBlockJ || j_unroll <= 0 || block_j % j_unroll != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((n + block_i - 1) / block_i);
  const size_t smem = sizeof(float4) * block_j;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(bodies);
  float4* o4 = reinterpret_cast<float4*>(out);
  switch (j_unroll) {
    case 1:
      nbody_f32_kernel<1><<<grid, block_i, smem, s>>>(b4, o4, n, block_j, softening);
      break;
    case 2:
      nbody_f32_kernel<2><<<grid, block_i, smem, s>>>(b4, o4, n, block_j, softening);
      break;
    case 4:
      nbody_f32_kernel<4><<<grid, block_i, smem, s>>>(b4, o4, n, block_j, softening);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
