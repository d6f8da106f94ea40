// Causal flash attention for Hopper (sm_90a), fp32 in and out: for each of
// the B*H heads of q, k, v (B, H, S, D),
//   O = softmax(mask(Q K^T * sm_scale)) V,
// with the online softmax of FlashAttention: a running row max m, a running
// denominator l and an output accumulator, all fp32, rescaled by
// exp(m_old - m_new) as each key tile arrives; O = acc / max(l, 1e-30).
//
// Replaces the Pallas TPU kernel `flash_attention_single_head` of
// src/repro/kernels/attention/kernel.py (body `_flash_kernel`), which
// `flash_attention` vmaps over batch and heads.  That kernel runs a grid of
// (S / BLOCK_Q, S / BLOCK_K) programs, the kv axis sequential, and skips kv
// blocks that lie wholly above the diagonal (ki*BLOCK_K > last q row of the
// block).  Here the heads are a grid axis (no vmap) and the kv axis is a
// loop inside the block.  The arithmetic is the TPU kernel's, step for step:
// the score is scaled after the product, then masked (keys >= S and, when
// causal, keys after the query) to NEG_INF = -1e30, not -inf.  With -inf a
// row masked everywhere in a tile would give exp(-inf - -inf) = NaN; with
// -1e30 it gives exp(0) = 1 for masked keys, which is harmless only because
// a row's first visited tile always holds key 0, a real key, so m is finite
// from then on.  The kv walk therefore runs from key 0 upwards.
//
// What bounds it on the H100.  At (B, H, S, D) = (4, 16, 4096, 128) a causal
// head has S(S+1)/2 useful (query, key) pairs, each 4*D fp32 operations
// (two products): 2.75e11 operations, 4.10 ms at 67 TFLOP/s.  The exp on the
// special-function units (5.4e8 of them) takes 0.13 ms; q, k, v and o are
// 537 MB, 0.16 ms at 3.35 TB/s.  So the fp32 pipes bound it.  The tensor
// cores are not used: the TPU kernel's products are fp32 and TF32 or bf16
// would change its numbers (they belong to the kernel's redesign).
//
// The design.  A TPU tile (BLOCK_Q or BLOCK_K up to 1024 rows; at D = 128 a
// 512 KB fp32 tile) does not fit a block's 227 KB of shared memory, so each
// block walks its BLOCK_Q query rows in 64-row sub-tiles, and for each of
// them walks the keys in 64-row K and V sub-tiles ([64][D + 4] floats each,
// 33 KB at D = 128), loaded with cp.async; rows past S are zero-filled, not
// read.  256 threads as 16 x 16: thread (ty, tx) owns query rows ty + 16i
// and keys tx + 16j (i, j < 4) of the 64 x 64 score tile, and output columns
// 64c + 4tx .. + 3 (c < D / 64) of its four rows.  The row max and sum of a
// score tile are reduced over the 16 lanes that share ty with warp shuffles;
// P (or S) goes through a [64][68] shared tile for the PV product.  The
// block index along y runs the query blocks in reverse, so the blocks with
// the most keys (the bottom of the causal triangle) start first.
//
// Tuning parameters and the code path:
//   BLOCK_Q     the query rows a block owns: the grid (B*H x S / BLOCK_Q)
//               and the work of one block, nothing more (unlike the TPU
//               kernel, it adds no masked work: the causal skip is decided
//               per 64-row query sub-tile);
//   BLOCK_K     the granularity of causal skipping, as on the TPU: a 64-row
//               query sub-tile visits every whole BLOCK_K tile that starts
//               at or before its last row, so larger tiles do more masked
//               work;
//   KEEP_P      1: the probabilities p = exp(s - m) are computed once and
//               kept in shared memory for the PV product; 0: the scores are
//               kept and p is recomputed in the PV product by each of the 16
//               threads that reads it (16 times the exp);
//   Q_PREFETCH  the cp.async stages of the K and V sub-tiles: 1 loads a tile
//               and waits for it; 2 loads the next tile while the current
//               one is used (double the K/V shared memory: 182 KB in all at
//               D = 128, against 116 KB).
// Every parameter changes the code path; none is priced only.  D is a
// template (64 or 128); KEEP_P and Q_PREFETCH too.
//
// Entry: repro_attention_f32 (plain C, loaded with ctypes).  It launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 64;                 // rows of a Q, K, V or P sub-tile
constexpr int kThreads = 256;            // 16 x 16
constexpr int kPad = 4;                  // keeps float4 rows aligned, spreads banks
constexpr int kLdP = kSub + kPad;        // row stride of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;          // 0: write 16 zero bytes, read none
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + kSub) of one (S, D) head into a [kSub][D + kPad] tile;
// rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* head,
                                          int row0, int S) {
  constexpr int kChunks = kSub * D / 4;  // 16-byte chunks
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    const int row = row0 + r;
    const bool valid = row < S;
    const float* src =
        head + (valid ? static_cast<size_t>(row) * D + col : size_t{0});
    cp_async16(tile + r * (D + kPad) + col, src, valid);
  }
}

// Max and sum over the 16 lanes that share ty (lanes 0-15 or 16-31); every
// lane gets the same value.
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lane(const float4& f, int e) {
  return e == 0 ? f.x : e == 1 ? f.y : e == 2 ? f.z : f.w;
}

template <int D, bool kKeepP, int kStages>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int block_q, int block_k, int causal, float sm_scale) {
  constexpr int kLd = D + kPad;          // row stride of the Q, K, V tiles
  constexpr int kGroups = D / 64;        // float4 column groups a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                              // [kSub][kLd]
  float* Ks = Qs + kSub * kLd;                   // [kStages][kSub][kLd]
  float* Vs = Ks + kStages * kSub * kLd;         // [kStages][kSub][kLd]
  float* Ps = Vs + kStages * kSub * kLd;         // [kSub][kLdP]

  const size_t head = static_cast<size_t>(blockIdx.x) * S * D;
  q += head;
  k += head;
  v += head;
  o += head;
  const int qb = gridDim.y - 1 - blockIdx.y;     // heaviest blocks first
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q_begin = qb * block_q;
  const int q_end = min(q_begin + block_q, S);

  for (int q0 = q_begin; q0 < q_end; q0 += kSub) {
    int kv_end = S;
    if (causal) {
      const int last = q0 + kSub - 1;    // block_q is a multiple of kSub
      kv_end = min(S, (last / block_k + 1) * block_k);
    }
    const int n_kv = (kv_end + kSub - 1) / kSub;

    __syncthreads();                     // the last sub-tile's reads are done
    load_tile<D>(Qs, q, q0, S);
    if (kStages == 2) {
      load_tile<D>(Ks, k, 0, S);
      load_tile<D>(Vs, v, 0, S);
    }
    cp_async_commit();

    float m[4], l[4], acc[4][kGroups][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
    }

    for (int t = 0; t < n_kv; ++t) {
      const int kv0 = t * kSub;
      const int stage = kStages == 2 ? (t & 1) : 0;
      const float* Kt = Ks + stage * kSub * kLd;
      const float* Vt = Vs + stage * kSub * kLd;

      __syncthreads();                   // buffers about to be refilled are free
      if (kStages == 2) {
        if (t + 1 < n_kv) {
          load_tile<D>(Ks + (stage ^ 1) * kSub * kLd, k, kv0 + kSub, S);
          load_tile<D>(Vs + (stage ^ 1) * kSub * kLd, v, kv0 + kSub, S);
        }
        cp_async_commit();
        cp_async_wait<1>();              // all but the newest group: tile t
      } else {
        load_tile<D>(Ks, k, kv0, S);
        load_tile<D>(Vs, v, kv0, S);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();

      // s = Q K^T on the thread's 4 x 4 scores
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(Kt + (tx + 16 * j) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
      }

      // scale, mask, online softmax
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        float mc = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = kv0 + tx + 16 * j;
          const bool ok = kj < S && (!causal || kj <= qi);
          s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
          mc = fmaxf(mc, s[i][j]);
        }
        mc = max16(mc);
        const float mn = fmaxf(m[i], mc);
        const float alpha = __expf(m[i] - mn);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = __expf(s[i][j] - mn);
          ps += p;
          Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = kKeepP ? p : s[i][j];
        }
        l[i] = l[i] * alpha + sum16(ps);
        m[i] = mn;
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
      }
      __syncthreads();

      // acc += P V
#pragma unroll 2
      for (int kk = 0; kk < kSub; kk += 4) {
        float4 p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLdP + kk);
          if (!kKeepP) {
            p4[i].x = __expf(p4[i].x - m[i]);
            p4[i].y = __expf(p4[i].y - m[i]);
            p4[i].z = __expf(p4[i].z - m[i]);
            p4[i].w = __expf(p4[i].w - m[i]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const float4 w = *reinterpret_cast<const float4*>(
                Vt + (kk + e) * kLd + 64 * g + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = lane(p4[i], e);
              acc[i][g][0] = fmaf(p, w.x, acc[i][g][0]);
              acc[i][g][1] = fmaf(p, w.y, acc[i][g][1]);
              acc[i][g][2] = fmaf(p, w.z, acc[i][g][2]);
              acc[i][g][3] = fmaf(p, w.w, acc[i][g][3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= S) continue;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 out = make_float4(acc[i][g][0] / den, acc[i][g][1] / den,
                                       acc[i][g][2] / den, acc[i][g][3] / den);
        *reinterpret_cast<float4*>(o + static_cast<size_t>(row) * D + 64 * g +
                                   4 * tx) = out;
      }
    }
  }
}

template <int D, bool kKeepP, int kStages>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int s, int block_q, int block_k, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(1 + 2 * kStages) * kSub * (D + kPad) +
                       static_cast<size_t>(kSub) * kLdP);
  auto kernel = flash_f32_kernel<D, kKeepP, kStages>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((s + block_q - 1) / block_q));
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, s, block_q, block_k,
                                           causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const float* q, const float* k, const float* v, float* o,
             int bh, int s, int block_q, int block_k, int keep_p,
             int q_prefetch, int causal, float sm_scale,
             cudaStream_t stream) {
  if (keep_p) {
    return q_prefetch == 2
        ? launch<D, true, 2>(q, k, v, o, bh, s, block_q, block_k, causal, sm_scale, stream)
        : launch<D, true, 1>(q, k, v, o, bh, s, block_q, block_k, causal, sm_scale, stream);
  }
  return q_prefetch == 2
      ? launch<D, false, 2>(q, k, v, o, bh, s, block_q, block_k, causal, sm_scale, stream)
      : launch<D, false, 1>(q, k, v, o, bh, s, block_q, block_k, causal, sm_scale, stream);
}

}  // namespace

// q, k, v, o: (bh, s, d) fp32, contiguous, 16-byte aligned; d is 64 or 128;
// block_q and block_k are multiples of 64.  Returns a cudaError_t as int.
extern "C" int repro_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int bh, int s,
                                   int d, int block_q, int block_k,
                                   int keep_p, int q_prefetch, int causal,
                                   float sm_scale, void* stream) {
  if (bh <= 0 || s <= 0 || block_q <= 0 ||
      block_q % kSub != 0 || block_k <= 0 || block_k % kSub != 0 ||
      (keep_p != 0 && keep_p != 1) || (q_prefetch != 1 && q_prefetch != 2) ||
      (s + block_q - 1) / block_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return dispatch<64>(q, k, v, o, bh, s, block_q, block_k, keep_p,
                          q_prefetch, causal, sm_scale, st);
    case 128:
      return dispatch<128>(q, k, v, o, bh, s, block_q, block_k, keep_p,
                           q_prefetch, causal, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
