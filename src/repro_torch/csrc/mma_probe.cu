// A throughput probe, not a port of a TPU kernel: how many TF32 operations a
// second the card's tensor cores sustain through mma.sync.m16n8k8, the
// instruction the GEMM and attention issue (tf32x3.cuh).  The data sheet's
// 495 TFLOP/s dense TF32 is reached only by wgmma; chip_smoke.py reports
// this rate beside the kernels' bounds, so that their times can be read
// against what mma.sync can give.
//
// Each warp runs 16 independent accumulators (enough products in flight to
// hide the instruction's latency) through `iters` rounds of 16 products on
// fixed operands; nothing is read from memory, one value a thread is
// written so that the products are not removed.
//
// Entry: repro_mma_tf32_probe (plain C, loaded with ctypes).  It launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = 16;

__global__ void __launch_bounds__(kThreads)
mma_tf32_probe_kernel(float* __restrict__ out, int iters) {
  float d[kAcc][4];
#pragma unroll
  for (int n = 0; n < kAcc; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
  uint32_t a[4], b[2];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = __float_as_uint(1.f + 0.001f * ((threadIdx.x + e) % 7));
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < kAcc; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < kAcc; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += d[n][e];
  out[static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x] = s;
}

}  // namespace

// out: blocks x 256 floats.  The launch does blocks * 8 warps * iters * 16
// products of 2 * 16 * 8 * 8 operations.  Returns a cudaError_t as int.
extern "C" int repro_mma_tf32_probe(float* out, int blocks, int iters,
                                    void* stream) {
  if (out == nullptr || blocks <= 0 || iters <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mma_tf32_probe_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
