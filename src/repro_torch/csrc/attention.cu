// Causal flash attention for Hopper (sm_90a) on the tensor cores, fp32 in
// and out: for each of the B*H heads of q, k, v (B, H, S, D),
//   O = softmax(mask(Q K^T * sm_scale)) V,
// with the online softmax of FlashAttention: a running row max m, a running
// denominator l and an output accumulator, all fp32, rescaled by
// exp(m_old - m_new) as each key tile arrives; O = acc / max(l, 1e-30).
// Both products are fp32-accurate: three TF32 tensor-core products of the
// operands' big and small parts (3xTF32, tf32x3.cuh).
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
// head has S(S+1)/2 useful (query, key) pairs, each 4*D operations (two
// products): 2.75e11 operations, 4.10 ms on the fp32 pipes at 67 TFLOP/s,
// 3 x 2.75e11 / 495e12 = 1.67 ms by 3xTF32 on the tensor cores.  The exp on
// the special-function units (5.4e8 of them) takes 0.13 ms; q, k, v and o
// are 537 MB, 0.16 ms at 3.35 TB/s.  So the tensor cores bind, and with
// them the threads that split every operand into its two TF32 parts.
//
// The design (FlashAttention-2's shape).  Grid (B*H, S / BLOCK_Q), 4 warps a
// block; the block index along y runs the query blocks in reverse, so the
// blocks with the most keys (the bottom of the causal triangle) start first.
// A block walks its BLOCK_Q rows in 128-row query sub-tiles, each warp
// owning 32 query rows (two m16 tiles), and for each sub-tile walks the keys
// from key 0 in 32-row K and V sub-tiles, loaded with cp.async into
// [32][D + 4] tiles (rows past S zero-filled, not read).  Every operand is
// split into its big and small parts as its fragment is read from shared
// memory; a warp with two m16 tiles splits each K and V fragment once for
// both, which halves those splits against one m16 tile a warp.  Q stays in
// shared memory ([128][D + 4]) and is split as its fragments are read,
// since its split fragments for D = 128 would take 256 registers beside the
// 128 of the O accumulators.  Row strides of D + 4 floats make every
// fragment read hit 32 distinct banks.  S = Q K^T is a 32 x 32 tile of
// m16n8k8 products per warp.  The online softmax runs on the accumulator
// fragments, a row's max reduced by shuffles over the 4 lanes that share it
// (the row sum is kept per lane and reduced once at the end).  P goes into
// the second product without moving: the accumulator gives a lane keys 2t
// and 2t + 1 of rows g and g + 8, and the A fragment of an m16n8k8 product
// wants its k indices t and t + 4, so the PV product takes its k index
// permuted (k = t is key 2t, k = t + 4 is key 2t + 1) and reads V's rows in
// the same permuted order; a sum over k does not depend on the order of its
// terms.  Shared memory a block at D = 128:
// 99 KB with one K/V stage, 132 KB with two (2 blocks, 8 warps, an SM, or
// 1 block, 4 warps), with 236-255 registers a thread and no spills; at
// D = 64, 51 or 68 KB and 164-187 registers (2 blocks an SM, set by the
// registers).
//
// Tuning parameters and the code path:
//   BLOCK_Q     the query rows a block owns: the grid (B*H x S / BLOCK_Q)
//               and the work of one block (a multiple of 64; a block whose
//               last sub-tile runs past its rows computes them and stores
//               none of them);
//   BLOCK_K     the granularity of causal skipping, as on the TPU: a query
//               sub-tile visits every whole BLOCK_K tile that starts at or
//               before its last row, so larger tiles do more masked work;
//   KEEP_P      1: the probabilities p = exp(s - m) are computed once and
//               kept in the score registers for the PV product; 0: the
//               scores are kept and p is computed again, by the same lane,
//               when the PV product reads it (twice the exp);
//   Q_PREFETCH  the cp.async stages of the K and V sub-tiles: 1 keeps one K
//               and one V buffer and refills each as soon as every warp is
//               done with it (the next K loads during the softmax and the
//               PV product, the next V during the next QK^T product); 2
//               loads the next K and V into a second stage while the current
//               ones are used (at D = 128 the second stage leaves room for
//               one block an SM instead of two).
// Every parameter changes the code path; none is priced only.  KEEP_P and
// Q_PREFETCH are templates.
//
// Head dims.  D is a template too, compiled at 16, 32, 64, 80, 128, 192 and
// 256 (the C entry's switch; mma.sync.m16n8k8 reads D in steps of 8).  The
// wrapper zero-pads any other D up to 256 to the next compiled one and
// slices the padding off the output: zero columns of Q and K add nothing to a score,
// zero columns of V give zero output columns, and sm_scale stays 1/sqrt of
// the caller's D.  Up to D = 128 a warp owns two m16 tiles (a 128-row query
// sub-tile).  Above 128 a warp owns one (kMT = 1, a 64-row sub-tile): at
// D = 256 two m16 tiles would hold 256 accumulator floats a thread, and the
// shared tile (D + 4) x (128 + 2 kStages 32) fp32 would take 266 KB at two
// stages, beyond the 227 KB a block can use; with one m16 tile they take
// 128 floats and 195 KB.  So every configuration of the space launches at
// every compiled D.  Registers and spills at each D: PERF.md, section 6,
// from the ptxas report chip_smoke.py prints.
//
// Entry: repro_attention_f32 (plain C, loaded with ctypes).  It launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kBlockUnit = 64;           // BLOCK_Q and BLOCK_K are multiples
constexpr int kWarps = 4;
constexpr int kKeys = 32;                // key rows of a K or V sub-tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

// m16 tiles a warp owns at head dim D, and the query rows of a sub-tile
__host__ __device__ constexpr int m_tiles(int d) { return d > 128 ? 1 : 2; }
__host__ __device__ constexpr int sub_rows(int d) {
  return 16 * m_tiles(d) * kWarps;
}

// Rows [row0, row0 + rows) of one (S, D) head into a [rows][D + 4] tile;
// rows at or past S are zero-filled.
template <int D, int rows>
__device__ __forceinline__ void load_tile(float* tile, const float* head,
                                          int row0, int S) {
  constexpr int kChunks = rows * D / 4;  // 16-byte chunks
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    const int row = row0 + r;
    const bool valid = row < S;
    const float* src =
        head + (valid ? static_cast<size_t>(row) * D + col : size_t{0});
    async_copy::cp_async16(tile + r * (D + 4) + col, src, valid ? 16 : 0);
  }
}

// Max and sum over the 4 lanes that share a row (lanes 4g .. 4g + 3).
__device__ __forceinline__ float max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The scores of a warp's 32 rows x 32 keys times sm_scale; with kMask, keys
// at or past S and (when causal) keys after the row set to NEG_INF.
// Element e of n8 tile j of m16 tile i is row row0 + 16 i + 8 (e / 2), key
// kv0 + 8 j + 2 t + e % 2.
template <bool kMask, int kMT>
__device__ __forceinline__ void scale_and_mask(float (&s)[kMT][kKeys / 8][4],
                                               int kv0, int row0, int t,
                                               int S, int causal,
                                               float sm_scale) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + 16 * i + 8 * (e >> 1);
        const bool ok = !kMask || (key < S && (!causal || key <= row));
        s[i][j][e] = ok ? s[i][j][e] * sm_scale : kNegInf;
      }
}

template <int D, bool kKeepP, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int S,
                    int block_q, int block_k, int causal, float sm_scale) {
  constexpr int kMT = m_tiles(D);
  constexpr int kSub = sub_rows(D);
  constexpr int kLd = D + 4;             // row stride: fragment reads hit
                                         // 32 distinct banks at every D
  constexpr int kTileKV = kKeys * kLd;
  constexpr int kNS = kKeys / 8;         // n8 tiles of scores a warp
  constexpr int kNO = D / 8;             // n8 tiles of output a warp
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                              // [kSub][kLd]
  float* Ks = Qs + kSub * kLd;                   // [kStages][kKeys][kLd]
  float* Vs = Ks + kStages * kTileKV;            // [kStages][kKeys][kLd]

  const size_t head = static_cast<size_t>(blockIdx.x) * S * D;
  q += head;
  k += head;
  v += head;
  o += head;
  const int qb = gridDim.y - 1 - blockIdx.y;     // heaviest blocks first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q_begin = qb * block_q;
  const int q_end = min(q_begin + block_q, S);

  for (int q0 = q_begin; q0 < q_end; q0 += kSub) {
    int kv_end = S;
    if (causal) {
      const int last = min(q0 + kSub, q_end) - 1;
      kv_end = min(S, (last / block_k + 1) * block_k);
    }
    const int n_kv = (kv_end + kKeys - 1) / kKeys;
    // this lane's rows: row0 + 16 i + 8 r for m16 tile i, half r
    const int row0 = q0 + 16 * kMT * warp + g;

    __syncthreads();                     // the last sub-tile's reads are done
    load_tile<D, kSub>(Qs, q, q0, S);
    load_tile<D, kKeys>(Ks, k, 0, S);
    if (kStages == 2) load_tile<D, kKeys>(Vs, v, 0, S);
    async_copy::cp_async_commit();
    if (kStages == 1) {
      load_tile<D, kKeys>(Vs, v, 0, S);
      async_copy::cp_async_commit();
    }

    float m[kMT][2], l[kMT][2], acc[kMT][kNO][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[i][r] = kNegInf;
        l[i][r] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kNO; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }

    for (int it = 0; it < n_kv; ++it) {
      const int kv0 = it * kKeys;
      const int stage = kStages == 2 ? (it & 1) : 0;
      const float* Kt = Ks + stage * kTileKV;
      const float* Vt = Vs + stage * kTileKV;

      if (kStages == 2) {
        __syncthreads();                 // the buffers to be refilled are free
        if (it + 1 < n_kv) {
          load_tile<D, kKeys>(Ks + (stage ^ 1) * kTileKV, k, kv0 + kKeys, S);
          load_tile<D, kKeys>(Vs + (stage ^ 1) * kTileKV, v, kv0 + kKeys, S);
        }
        async_copy::cp_async_commit();
      }
      async_copy::cp_async_wait<1>();    // K of tile it (and V with 2 stages)
      __syncthreads();

      // s = Q K^T: the warp's 32 rows x 32 keys; a K fragment, split once,
      // serves both m16 tiles
      float s[kMT][kNS][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 8) {
        tf32x3::FragA qa[kMT];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          qa[i] = tf32x3::load_a(Qs, kLd, 16 * (kMT * warp + i), d0, g, t);
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const tf32x3::FragB kb = tf32x3::load_b_nk(Kt, kLd, d0, 8 * j, g, t);
#pragma unroll
          for (int i = 0; i < kMT; ++i) tf32x3::mma3(s[i][j], qa[i], kb);
        }
      }

      if (kStages == 1) {
        __syncthreads();                 // every warp is done with K
        if (it + 1 < n_kv) load_tile<D, kKeys>(Ks, k, kv0 + kKeys, S);
        async_copy::cp_async_commit();
      }

      // scale, then mask unless every key of the tile is real and (when
      // causal) at or before the warp's first row
      const bool whole = kv0 + kKeys <= S &&
                         (!causal || kv0 + kKeys - 1 <= row0 - g);
      if (whole)
        scale_and_mask<false, kMT>(s, kv0, row0, t, S, causal, sm_scale);
      else
        scale_and_mask<true, kMT>(s, kv0, row0, t, S, causal, sm_scale);

      // online softmax
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        float mc[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mc[e >> 1] = fmaxf(mc[e >> 1], s[i][j][e]);
        float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[i][r], max4(mc[r]));
          alpha[r] = __expf(m[i][r] - mn);
          m[i][r] = mn;
        }
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[i][j][e] - m[i][e >> 1]);
            ps[e >> 1] += p;
            if (kKeepP) s[i][j][e] = p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[i][r] = l[i][r] * alpha[r] + ps[r];
        // alpha is exactly 1 where the row max did not move
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int c = 0; c < kNO; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[e >> 1];
        }
      }

      if (kStages == 1) {
        async_copy::cp_async_wait<1>();      // V of tile it
        __syncthreads();
      }

      // acc += P V, the k index permuted: k = t is key 2t, k = t + 4 key
      // 2t + 1; a V fragment, split once, serves both m16 tiles
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        tf32x3::FragA pa[kMT];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[e] = kKeepP ? s[i][j][e] : __expf(s[i][j][e] - m[i][e >> 1]);
          pa[i] = tf32x3::split_a(p[0], p[2], p[1], p[3]);
        }
        const float* v0 = Vt + (8 * j + 2 * t) * kLd + g;
#pragma unroll
        for (int c = 0; c < kNO; ++c) {
          const tf32x3::FragB vb = tf32x3::split_b(v0[8 * c], v0[kLd + 8 * c]);
#pragma unroll
          for (int i = 0; i < kMT; ++i) tf32x3::mma3(acc[i][c], pa[i], vb);
        }
      }
      if (kStages == 1) {
        __syncthreads();                 // every warp is done with V
        if (it + 1 < n_kv) load_tile<D, kKeys>(Vs, v, kv0 + kKeys, S);
        async_copy::cp_async_commit();
      }
    }

#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * i + 8 * r;
        const float den = fmaxf(sum4(l[i][r]), 1e-30f);
        if (row >= q_end) continue;      // past S, or the next block's row
        float* dst = o + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
        for (int c = 0; c < kNO; ++c)
          *reinterpret_cast<float2*>(dst + 8 * c) =
              make_float2(acc[i][c][2 * r] / den, acc[i][c][2 * r + 1] / den);
      }
  }
}

template <int D, bool kKeepP, int kStages>
int launch(const float* q, const float* k, const float* v, float* o, int bh,
           int s, int block_q, int block_k, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D + 4) *
                      (static_cast<size_t>(sub_rows(D)) + 2 * kStages * kKeys);
  auto kernel = flash_tf32x3_kernel<D, kKeepP, kStages>;
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

// q, k, v, o: (bh, s, d) fp32, contiguous, 16-byte aligned; d is one of the
// compiled head dims (16, 32, 64, 80, 128, 192, 256: the wrapper pads any
// other); block_q and block_k are multiples of 64.  Returns a cudaError_t as
// int.
extern "C" int repro_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int bh, int s,
                                   int d, int block_q, int block_k,
                                   int keep_p, int q_prefetch, int causal,
                                   float sm_scale, void* stream) {
  if (bh <= 0 || s <= 0 || block_q <= 0 ||
      block_q % kBlockUnit != 0 || block_k <= 0 ||
      block_k % kBlockUnit != 0 ||
      (keep_p != 0 && keep_p != 1) || (q_prefetch != 1 && q_prefetch != 2) ||
      (s + block_q - 1) / block_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ATTENTION_D(D)                                             \
  case D:                                                                \
    return dispatch<D>(q, k, v, o, bh, s, block_q, block_k, keep_p,      \
                       q_prefetch, causal, sm_scale, st);
  switch (d) {
    REPRO_ATTENTION_D(16)
    REPRO_ATTENTION_D(32)
    REPRO_ATTENTION_D(64)
    REPRO_ATTENTION_D(80)
    REPRO_ATTENTION_D(128)
    REPRO_ATTENTION_D(192)
    REPRO_ATTENTION_D(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ATTENTION_D
}
