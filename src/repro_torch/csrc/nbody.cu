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
// is a loop inside the block, the accumulators are registers, and the j
// range may be shared among blocks.
//
// What bounds it on the H100.  Each pair costs one rsqrt on the
// special-function units (4.2 T/s on the SXM part) and 18 fp32 operations
// (67 TFLOP/s): at N = 16384, 0.064 ms and 0.072 ms; bodies are 256 KB,
// nothing.  The instruction stream is the tighter floor: a pair takes at
// least 12 instructions on the fp32 pipes (3 FADD for d, 3 FFMA for r^2 with
// eps folded into the first, 3 FMUL for m r^-3, 3 FFMA into the sums) and
// one MUFU.RSQ, and an SM issues one warp instruction a clock on each of its
// 4 schedulers: 12 N^2 / (128 lanes x 132 SMs x 1.98 GHz) = 0.0963 ms at
// 16384 and 6.16 ms at 131072.  The design spends as little as it can
// beside those 13 instructions.
//
// The design.
//   - Register-resident bodies: each thread holds 4 bodies i (positions and
//     sums in registers), so one 16-byte shared-memory read of a j body
//     feeds 4 pairs.  The 4 bodies of thread g of a block are g, g + G,
//     g + 2G, g + 3G (G = BLOCK_I / 4 body groups).
//   - Full warps at small BLOCK_I: below 128 bodies a block, the G groups
//     take 32 / G j lanes each, so that a block is one full warp; lane l
//     takes bodies l, l + lanes, ... of each tile and the lanes' sums are
//     added in lane order through shared memory at the end.
//   - Filling the card (the j-split): when the blocks of BLOCK_I bodies
//     make fewer than 8 waves of the 24 warps an SM holds, the j range is
//     cut into runs of whole BLOCK_J tiles, one a block along grid.y, until
//     they do (`split_count` of kernels/nbody/kernel.py): at N = 16384 this
//     fills the card at all, at 131072 it shortens the last wave's tail.
//     Each run writes its partial sums to a workspace the wrapper
//     allocates, and a second kernel adds them in run order: two launches
//     give the same bits.  No float atomics.
//   - Registers: __launch_bounds__(256, NBODY_MIN_BLOCKS = 3) lets a
//     thread take up to 85 registers (79 with J_UNROLL 4), three blocks of
//     256 threads an SM.  chip_smoke.py builds a variant with
//     -DNBODY_MIN_BLOCKS=4 (64 registers) and times the two, and the
//     j-split's waves, side by side (PERF.md).
//   - Per pair: eps is folded into the first FFMA of r^2, and the rsqrt is
//     `rsqrt.approx.ftz.f32` (inline PTX), a lone MUFU.RSQ; rsqrtf without
//     -ftz adds a denormal fix-up that r^2 >= eps never needs.
// A block stages BLOCK_J bodies (up to 2048 x 16 B = 32 KB) in shared
// memory, zeroing the tail past N (a zero mass adds exactly zero), and every
// thread sums their pull on its 4 bodies; bodies past N are zeros, take
// part in the loads and barriers, and store nothing.
//
// Tuning parameters and the code path:
//   BLOCK_I        bodies a block owns: max(32, BLOCK_I / 4) threads, the
//                  grid, the j lanes below 128 and, through the grid, the
//                  j-split (a power of two, 4 to 1024);
//   BLOCK_J        the shared-memory tile: how often a block loads and
//                  synchronises, and the unit of the j-split;
//   J_UNROLL       the unroll factor of the loop over a lane's bodies of a
//                  tile, a template (1, 2, 4), lowered to the largest that
//                  divides a lane's share of a tile: of the space's
//                  configurations only BLOCK_I 8 with BLOCK_J 32 (16 lanes,
//                  2 bodies a lane) has less than 4, so there J_UNROLL 4
//                  runs the J_UNROLL 2 kernel;
//   KEEP_PAIRWISE  has no register-file counterpart worth building in this
//                  design (nothing pairwise outlives one pair); it is
//                  priced by the workload model only.
//
// Entries: repro_nbody_f32, and repro_nbody_sum_splits_f32 (the second
// kernel alone, which repro_nbody_f32 launches after the first; exposed so
// that it can be timed alone).  Plain C, loaded with ctypes; each launches
// on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBodies = 4;               // bodies i a thread holds
constexpr int kWarp = 32;
constexpr int kMaxBlockI = 1024;
constexpr int kMaxThreads = kMaxBlockI / kBodies;
constexpr int kMaxBlockJ = 2048;         // 32 KB of shared memory
constexpr int kMaxSplits = 65535;        // grid.y

#ifndef NBODY_MIN_BLOCKS
#define NBODY_MIN_BLOCKS 3               // blocks of 256 threads an SM
#endif

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kOneLane: BLOCK_I >= 128, every thread reads every body of a tile, so the
// reads of an unrolled step sit at fixed offsets.
template <int kUnroll, bool kOneLane>
__global__ void __launch_bounds__(kMaxThreads, NBODY_MIN_BLOCKS)
nbody_f32_kernel(const float4* __restrict__ bodies, float4* __restrict__ out,
                 int n, int block_i, int block_j, int lanes_arg,
                 int tiles_per_split, float softening) {
  extern __shared__ float4 s_bodies[];   // [max(block_j, threads * 4)]

  const int lanes = kOneLane ? 1 : lanes_arg;
  const int groups = block_i / kBodies;
  const int g = kOneLane ? threadIdx.x : threadIdx.x % groups;
  const int lane = kOneLane ? 0 : threadIdx.x / groups;
  const int i0 = blockIdx.x * block_i + g;

  float px[kBodies], py[kBodies], pz[kBodies];
  float ax[kBodies], ay[kBodies], az[kBodies];
#pragma unroll
  for (int q = 0; q < kBodies; ++q) {
    const int i = i0 + q * groups;
    const float4 b = i < n ? bodies[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    px[q] = b.x;
    py[q] = b.y;
    pz[q] = b.z;
    ax[q] = ay[q] = az[q] = 0.f;
  }

  const int j_begin = blockIdx.y * tiles_per_split * block_j;
  const int j_end = min(n, j_begin + tiles_per_split * block_j);
  const int step = lanes * kUnroll;
  for (int j0 = j_begin; j0 < j_end; j0 += block_j) {
    __syncthreads();   // the previous tile's reads are done
    for (int k = threadIdx.x; k < block_j; k += blockDim.x) {
      s_bodies[k] = j0 + k < n ? bodies[j0 + k]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 1
    for (int k = lane; k < block_j; k += step) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 bj = s_bodies[k + u * lanes];
#pragma unroll
        for (int q = 0; q < kBodies; ++q) {
          const float dx = bj.x - px[q];
          const float dy = bj.y - py[q];
          const float dz = bj.z - pz[q];
          const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, softening)));
          const float inv_r = rsqrt_ftz(r2);
          const float s = bj.w * inv_r * inv_r * inv_r;
          ax[q] = fmaf(s, dx, ax[q]);
          ay[q] = fmaf(s, dy, ay[q]);
          az[q] = fmaf(s, dz, az[q]);
        }
      }
    }
  }

  if constexpr (!kOneLane) {
    // lane l's sums, added in lane order by lane 0
    float4* sums = s_bodies;             // [kBodies][threads]
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kBodies; ++q) {
      sums[q * blockDim.x + threadIdx.x] = make_float4(ax[q], ay[q], az[q],
                                                       0.f);
    }
    __syncthreads();
    if (lane != 0) return;
#pragma unroll
    for (int q = 0; q < kBodies; ++q) {
      for (int l = 1; l < lanes; ++l) {
        const float4 p = sums[q * blockDim.x + l * groups + g];
        ax[q] += p.x;
        ay[q] += p.y;
        az[q] += p.z;
      }
    }
  }
  // one run of the j range: its partial sums go to its own slice
  float4* dst = out + static_cast<size_t>(blockIdx.y) * n;
#pragma unroll
  for (int q = 0; q < kBodies; ++q) {
    const int i = i0 + q * groups;
    if (i < n) dst[i] = make_float4(ax[q], ay[q], az[q], 0.f);
  }
}

// out[i] = the runs' partial sums of body i, added in run order.  Each
// thread issues the loads of kSumBatch runs before their adds, so that that
// many are in flight at once (one at a time, the kernel waited on device
// memory's latency once a run); the adds keep their order: the same bits.
constexpr int kSumBatch = 8;
constexpr int kSumThreads = 128;

__global__ void __launch_bounds__(kSumThreads)
nbody_sum_splits(const float4* __restrict__ partial, float4* __restrict__ out,
                 int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 acc = partial[i];
  for (int s0 = 1; s0 < splits; s0 += kSumBatch) {
    float4 p[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) {
      if (s0 + k < splits) p[k] = partial[static_cast<size_t>(s0 + k) * n + i];
    }
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) {
      if (s0 + k < splits) {
        acc.x += p[k].x;
        acc.y += p[k].y;
        acc.z += p[k].z;
      }
    }
  }
  out[i] = make_float4(acc.x, acc.y, acc.z, 0.f);
}

template <int kUnroll>
void launch(bool one_lane, dim3 grid, int threads, size_t smem,
            cudaStream_t s, const float4* bodies, float4* out, int n,
            int block_i, int block_j, int lanes, int per, float softening) {
  if (one_lane) {
    nbody_f32_kernel<kUnroll, true><<<grid, threads, smem, s>>>(
        bodies, out, n, block_i, block_j, lanes, per, softening);
  } else {
    nbody_f32_kernel<kUnroll, false><<<grid, threads, smem, s>>>(
        bodies, out, n, block_i, block_j, lanes, per, softening);
  }
}

bool power_of_two(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

extern "C" int repro_nbody_sum_splits_f32(const float* partial, float* out,
                                          int n, int splits, void* stream);

// bodies, out: (n, 4) fp32, 16-byte aligned.  splits: the runs of whole
// BLOCK_J tiles the j range is cut into (grid.y), none of them empty; with
// more than one, workspace holds splits x n x 4 fp32 for their partial sums
// (else it may be null).  Returns a cudaError_t as int.
extern "C" int repro_nbody_f32(const float* bodies, float* out,
                               float* workspace, int n, int block_i,
                               int block_j, int j_unroll, int splits,
                               float softening, void* stream) {
  if (n <= 0 || block_i < kBodies || block_i > kMaxBlockI ||
      !power_of_two(block_i) || block_j <= 0 || block_j > kMaxBlockJ ||
      (j_unroll != 1 && j_unroll != 2 && j_unroll != 4) ||
      block_j % j_unroll != 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = block_i / kBodies;
  const int threads = groups < kWarp ? kWarp : groups;
  const int lanes = threads / groups;
  if (block_j % lanes != 0) return static_cast<int>(cudaErrorInvalidValue);
  int unroll = j_unroll;
  while ((block_j / lanes) % unroll != 0) unroll /= 2;
  const int tiles = (n + block_j - 1) / block_j;
  const int per = (tiles + splits - 1) / splits;
  if (splits > tiles || (tiles + per - 1) / per != splits) {
    return static_cast<int>(cudaErrorInvalidValue);   // an empty run
  }
  const dim3 grid(static_cast<unsigned>((n + block_i - 1) / block_i),
                  static_cast<unsigned>(splits));
  const int staged = lanes > 1 && threads * kBodies > block_j
                         ? threads * kBodies : block_j;
  const size_t smem = sizeof(float4) * staged;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b4 = reinterpret_cast<const float4*>(bodies);
  float4* o4 = reinterpret_cast<float4*>(splits > 1 ? workspace : out);
  const bool one_lane = lanes == 1;
  switch (unroll) {
    case 1:
      launch<1>(one_lane, grid, threads, smem, s, b4, o4, n, block_i,
                block_j, lanes, per, softening);
      break;
    case 2:
      launch<2>(one_lane, grid, threads, smem, s, b4, o4, n, block_i,
                block_j, lanes, per, softening);
      break;
    default:
      launch<4>(one_lane, grid, threads, smem, s, b4, o4, n, block_i,
                block_j, lanes, per, softening);
      break;
  }
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return repro_nbody_sum_splits_f32(workspace, out, n, splits, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n x 4) = the sums of partial's splits slices (splits x n x 4), added
// in slice order, column 3 zero.  Returns a cudaError_t as int.
extern "C" int repro_nbody_sum_splits_f32(const float* partial, float* out,
                                          int n, int splits, void* stream) {
  if (n <= 0 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int t = kSumThreads;
  nbody_sum_splits<<<(n + t - 1) / t, t, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out),
      n, splits);
  return static_cast<int>(cudaGetLastError());
}
