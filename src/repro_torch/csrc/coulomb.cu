// Direct Coulomb summation for Hopper (sm_90a), the paper's running example
// (Listing 1): on a gs x gs x gs grid of spacing s,
//   V[z][y][x] = sum_j w_j * rsqrt(max(|p - a_j|^2, 1e-12)),  p = (x, y, z) s,
// atoms given as rows (x, y, z, w); fp32, V row-major with x fastest.
//
// Replaces the Pallas TPU kernel `coulomb` of
// src/repro/kernels/coulomb/kernel.py (body `_coulomb_kernel`).  That kernel
// gives each program a (Z_IT, BY, BX) block of grid points and streams the
// atoms in ATOM_CHUNK tiles on a sequential grid axis, accumulating in VMEM
// and masking the atom tail.  Here the sequential axis is a loop inside the
// block and the accumulators are registers.
//
// What bounds it on the H100.  Every point-atom pair needs one rsqrt on the
// special-function units (16 lanes an SM a clock, 4.2 T/s on the SXM part)
// and about 6 fp32 operations on the 128 fp32 lanes; at 256^3 points and
// 256 atoms that is 4.3 G rsqrt, 1.03 ms, against 0.38 ms of fp32 work and
// 64 MiB of output (0.02 ms).  So the special-function units bound it, and
// the design keeps everything else off their way: coordinates and
// accumulators in registers, atoms broadcast to a whole warp at once.
//
// The design.  A block of 256 threads (32 x 8) walks its (Z_IT, BY, BX)
// block, whose (BY, BX) face reaches 64 x 1024, in 8 x 32 steps; a thread
// owns one (y, x) column of Z_IT points, whose Z_IT accumulators stay in
// registers (Z_IT is a template).  Per atom it computes dx^2 + dy^2 once and
// reuses it for its Z_IT points: the paper's z coarsening.  Threads outside
// the block or the grid take part in the shared-memory loads and barriers
// and store nothing.
//
// Tuning parameters and the code path:
//   Z_IT           z coarsening: accumulators a thread keeps in registers,
//                  and the reuse of dx^2 + dy^2 (a template, 1 to 64);
//   BY, BX         the block's face, hence the grid size and the steps a
//                  block walks (BY < 8 or BX < 32 leaves threads idle);
//   ATOMS_IN_SMEM  1: atoms in __constant__ memory, read by all threads of a
//                  warp at once (a broadcast), as in the paper's Listing 1;
//                  0: atoms streamed from device memory through shared
//                  memory, ATOM_CHUNK at a time, the tail zeroed.  (On the
//                  TPU "SMEM" is scalar memory, whose counterpart is the
//                  constant cache.)  Constant memory holds 4096 atoms
//                  (64 KB): with more, the entry copies and launches once
//                  per 4096 atoms, each launch adding to the output;
//   ATOM_CHUNK     the shared-memory tile when ATOMS_IN_SMEM = 0 (how often
//                  the block loads and synchronises); priced by the
//                  workload model only when ATOMS_IN_SMEM = 1.
//
// Entry: repro_coulomb_f32 (plain C, loaded with ctypes).  It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kConstAtoms = 4096;        // 64 KB of constant memory
constexpr int kMaxChunk = 2048;          // 32 KB of shared memory

__constant__ float4 c_atoms[kConstAtoms];

template <int kZ>
__device__ __forceinline__ void add_atom(const float4 a, float fx, float fy,
                                         const float (&fz)[kZ],
                                         float (&acc)[kZ]) {
  const float dx = fx - a.x;
  const float dy = fy - a.y;
  const float dxy2 = dx * dx + dy * dy;
#pragma unroll
  for (int z = 0; z < kZ; ++z) {
    const float dz = fz[z] - a.z;
    acc[z] += a.w * rsqrtf(fmaxf(dxy2 + dz * dz, 1e-12f));
  }
}

template <int kZ, bool kConst>
__global__ void __launch_bounds__(kThreads)
coulomb_f32_kernel(const float4* __restrict__ atoms, float* __restrict__ out,
                   int gs, int n_atoms, int by, int bx, int chunk,
                   int tiles_y, int tiles_x, float spacing, int accumulate) {
  extern __shared__ float4 s_atoms[];    // [chunk], when !kConst

  const int tile_x = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int tile_y = rest % tiles_y;
  const int z0 = (rest / tiles_y) * kZ;
  const int y0 = tile_y * by;
  const int x0 = tile_x * bx;
  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const size_t plane = static_cast<size_t>(gs) * gs;

  float fz[kZ];
#pragma unroll
  for (int z = 0; z < kZ; ++z) fz[z] = static_cast<float>(z0 + z) * spacing;

  for (int py = 0; py < by; py += kThreadsY) {
    for (int px = 0; px < bx; px += kThreadsX) {
      const int y = y0 + py + ty;
      const int x = x0 + px + tx;
      const bool active =
          py + ty < by && px + tx < bx && y < gs && x < gs;
      const float fx = static_cast<float>(x) * spacing;
      const float fy = static_cast<float>(y) * spacing;
      float acc[kZ];
#pragma unroll
      for (int z = 0; z < kZ; ++z) acc[z] = 0.f;

      if constexpr (kConst) {
        if (active) {
          for (int j = 0; j < n_atoms; ++j) add_atom<kZ>(c_atoms[j], fx, fy, fz, acc);
        }
      } else {
        for (int c0 = 0; c0 < n_atoms; c0 += chunk) {
          __syncthreads();   // the previous tile's reads are done
          for (int k = threadIdx.x; k < chunk; k += kThreads) {
            s_atoms[k] = c0 + k < n_atoms ? atoms[c0 + k]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          __syncthreads();
          if (active) {
            for (int k = 0; k < chunk; ++k) add_atom<kZ>(s_atoms[k], fx, fy, fz, acc);
          }
        }
      }

      if (active) {
#pragma unroll
        for (int z = 0; z < kZ; ++z) {
          if (z0 + z < gs) {
            float* p = out + (z0 + z) * plane + static_cast<size_t>(y) * gs + x;
            *p = accumulate ? *p + acc[z] : acc[z];
          }
        }
      }
    }
  }
}

template <int kZ>
void launch(bool in_const, unsigned grid, cudaStream_t s, const float4* atoms,
            float* out, int gs, int n_atoms, int by, int bx, int chunk,
            int tiles_y, int tiles_x, float spacing, int accumulate) {
  if (in_const) {
    coulomb_f32_kernel<kZ, true><<<grid, kThreads, 0, s>>>(
        atoms, out, gs, n_atoms, by, bx, chunk, tiles_y, tiles_x, spacing,
        accumulate);
  } else {
    coulomb_f32_kernel<kZ, false><<<grid, kThreads, sizeof(float4) * chunk, s>>>(
        atoms, out, gs, n_atoms, by, bx, chunk, tiles_y, tiles_x, spacing,
        accumulate);
  }
}

int launch_z(int z_it, bool in_const, unsigned grid, cudaStream_t s,
             const float4* atoms, float* out, int gs, int n_atoms, int by,
             int bx, int chunk, int tiles_y, int tiles_x, float spacing,
             int accumulate) {
#define REPRO_COULOMB_Z(Z)                                                  \
  case Z:                                                                   \
    launch<Z>(in_const, grid, s, atoms, out, gs, n_atoms, by, bx, chunk,    \
              tiles_y, tiles_x, spacing, accumulate);                       \
    break;
  switch (z_it) {
    REPRO_COULOMB_Z(1)
    REPRO_COULOMB_Z(2)
    REPRO_COULOMB_Z(4)
    REPRO_COULOMB_Z(8)
    REPRO_COULOMB_Z(16)
    REPRO_COULOMB_Z(32)
    REPRO_COULOMB_Z(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_COULOMB_Z
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// atoms: (n_atoms, 4) fp32 rows (x, y, z, w); out: (gs, gs, gs) fp32.
// Returns a cudaError_t as int.
extern "C" int repro_coulomb_f32(const float* atoms, float* out, int gs,
                                 int n_atoms, int z_it, int by, int bx,
                                 int atom_chunk, int atoms_in_smem,
                                 float spacing, void* stream) {
  if (gs <= 0 || n_atoms <= 0 || by <= 0 || bx <= 0 || atom_chunk <= 0 ||
      atom_chunk > kMaxChunk || (atoms_in_smem != 0 && atoms_in_smem != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_z = (gs + z_it - 1) / z_it;
  const int tiles_y = (gs + by - 1) / by;
  const int tiles_x = (gs + bx - 1) / bx;
  const long long grid =
      static_cast<long long>(tiles_z) * tiles_y * tiles_x;
  if (z_it <= 0 || grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a4 = reinterpret_cast<const float4*>(atoms);
  const unsigned g = static_cast<unsigned>(grid);
  if (!atoms_in_smem) {
    return launch_z(z_it, false, g, s, a4, out, gs, n_atoms, by, bx,
                    atom_chunk, tiles_y, tiles_x, spacing, 0);
  }
  for (int off = 0; off < n_atoms; off += kConstAtoms) {
    const int count = n_atoms - off < kConstAtoms ? n_atoms - off : kConstAtoms;
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_atoms, a4 + off, sizeof(float4) * count, 0,
        cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rc = launch_z(z_it, true, g, s, a4, out, gs, count, by, bx,
                            atom_chunk, tiles_y, tiles_x, spacing, off > 0);
    if (rc != 0) return rc;
  }
  return 0;
}
