// A gate on a stream: the card waits at it until the host has queued what
// comes after it.  Replaces no TPU kernel; the card evaluator
// (core/evaluate.py, DeviceKernelEvaluator) puts one before each timed
// launch and opens it once the launch and the event after it are queued.
//
// Why.  A timed launch is bracketed by CUDA events recorded before and
// after the wrapper's host path.  When the card has run out of queued work,
// the window between the events holds the card waiting for that host path:
// on a card host that shares its cores, the path now and then takes ten
// times its usual 40 us, and a 0.15 ms GEMM then reads 0.2 ms or more.
// Behind the gate the window runs whole, whatever the host does meanwhile,
// and the waiting falls before it.  Where the host is ahead, as it usually
// is, the gate is open when the card reaches it and costs a launch of one
// thread.  (One gate before all of a test's timed launches, opened once all
// were queued, kept the card waiting for the last of them: 3.1 s of a
// 51 s window on an H100 SXM.)
//
// The gate is one thread polling an int in mapped host memory
// (cudaHostAlloc), every 0.5 us, until it holds at least the gate's number;
// the host writes the numbers in increasing order.  It gives up after
// kTimeoutNs, so that a gate the host never opens costs the card that time
// and cannot hang it.
//
// Entries (plain C, loaded with ctypes): repro_gate_flag (the int, made once
// in a process) and repro_gate (queue a gate; returns cudaGetLastError()).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kTimeoutNs = 50ull * 1000 * 1000;   // 50 ms

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void gate_kernel(const volatile int* flag, int number) {
  const unsigned long long start = now_ns();
  while (*flag < number && now_ns() - start < kTimeoutNs) __nanosleep(500);
}

}  // namespace

// The int the host writes to open gates, zero at first; null if it cannot
// be made.
extern "C" int* repro_gate_flag() {
  static int* const flag = [] {
    void* p = nullptr;
    if (cudaHostAlloc(&p, sizeof(int),
                      cudaHostAllocMapped | cudaHostAllocPortable) !=
        cudaSuccess)
      return static_cast<int*>(nullptr);
    *static_cast<volatile int*>(p) = 0;
    return static_cast<int*>(p);
  }();
  return flag;
}

// A gate on `stream` that opens when the flag holds `number` or more.
extern "C" int repro_gate(int number, void* stream) {
  int* flag = repro_gate_flag();
  if (flag == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  int* on_card = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(
      reinterpret_cast<void**>(&on_card), flag, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(on_card,
                                                               number);
  return static_cast<int>(cudaGetLastError());
}
