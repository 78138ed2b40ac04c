// Flash attention for Hopper, sm_90a: the forward and the two backward
// passes.
//
// flash_fwd replaces the Pallas TPU kernel _fwd_kernel (flash_fwd) of
// src/repro/kernels/flash_attention/flash_attention.py: online-softmax
// attention that never stores the (S, T) logits, with GQA (q head h reads
// kv head h / qpk, no repeated KV), causal and sliding-window masks by
// absolute position, dead kv blocks skipped, and the tanh logit softcap.
//   q (B, Hq, S, D), k/v (B, Hkv, T, D) -> out (B, Hq, S, D) in q's type,
//   lse (B, Hq, S) float32; rows with no allowed key get l = 0, out 0 and
//   lse = NEG_INF, as the TPU kernel's flush.
//
// flash_bwd_dq and flash_bwd_dkv replace the Pallas TPU kernels _dq_kernel
// and _dkv_kernel (flash_bwd) of the same file: the standard two-pass
// backward, both recomputing p = exp(z - lse) from the forward's saved
// logsumexp, so nothing quadratic is stored. With delta = sum(do * out)
// per query row (computed by the caller, as the TPU wrapper does outside
// its kernels) and the softcap's exact derivative 1 - tanh(z_raw / cap)^2:
//   dz = p * (do . v - delta) * (1 - tanh^2),
//   dq = scale * sum_k dz k,   dk = scale * sum_q dz q,   dv = sum_q p do.
// GQA by h / qpk, causal and window masks by absolute position, dead tiles
// skipped, ragged S and T masked. The backward's q, k, v, do are
// contiguous.
//
// What bounds all three: ~4 S T D (forward), ~6 S T D (dq) and ~8 S T D
// (dk, dv) flops a head, halved by the causal mask, against their bytes
// (each operand read once, each result written once): operations, at 989
// TFLOP/s for bf16 operands on the tensor cores. At the prefill's S =
// 1024, D = 256 the forward's bytes come close (50 MB: 0.015 ms at 3.35
// TB/s against 0.0174 ms of operations).
//
// Two designs.
//
// (1) Tensor cores, bf16: flash_fwd (flash_fwd_wgmma_kernel) on wgmma,
// flash_bwd_dkv (flash_bwd_dkv_mma_kernel) and flash_bwd_dq
// (flash_bwd_dq_mma_kernel) on mma.sync.m16n8k16, all with f32
// accumulators and tiles staged by cp.async in a 2-stage ring, so tile
// j + 1 lands while tile j is computed. Softmax, p and dz are f32 in
// registers; exponentials by exp2f with log2(e) folded into one FMA; the
// softcap with tanhf (not tanh.approx), its division as a product by 1 /
// cap. The forward rounds p to bf16 only as the A operand of P.V, as
// FlashAttention-2 does, and l sums the f32 p: dividing by l bounds the
// error by 2^-9 max |v|. The dk, dv pass has no such divisor: dv sums up to
// qpk S terms p do of either sign, and at the causal mask's first keys,
// where a few queries put p near 1, p rounded once to bf16 missed the 1e-2
// tolerance by an ulp; so p and dz enter P^T.dO and dZ^T.Q as a bf16 pair,
// the rounded value and its rounding residue (~16 bits), each B fragment
// loaded once for both. The dq pass rounds dz once, as dQ = dZ.K's A
// operand: dq is a sum that ends in its own bf16 rounding, and a CPU
// emulation of the design at head dim 256 finds the pair no closer to the
// f32 result. These take D a multiple of 16 up to 256 (templated
// on D rounded up to 64, 128 or 256; the tiles' columns past D are
// zero-filled, so no product loop tests D) and 16-byte aligned rows (every
// pointer and stride a multiple of 8 elements); the C entries send other
// shapes to design (2) by that explicit test. The building blocks below
// (stage_async, stage_async_sw, frag_a, frag_b, frag_b_t, mma_abt, mma_az,
// c_to_a, c_to_a2, logit, gmma_desc, wgmma_ss, wgmma_rs_t, pair_sync) are
// shared by the three.
//
//   flash_fwd_wgmma_kernel: one block of two warpgroups per (q head, batch
//   row, 128-query tile), the heaviest causal tiles launched first; each
//   warpgroup owns 64 query rows (each warp 16). Q, K and V tiles sit in
//   shared memory in wgmma's 128-byte swizzle (atoms of 8 rows x 64
//   columns, each row's 16-byte chunks XOR-permuted by the row, so the
//   rows a wgmma reads fall in distinct banks). Per 64 keys: S = Q.K^T by
//   D / 16 wgmma m64n64k16 with both operands from shared memory (32 f32
//   registers a thread), the mask only on diagonal, window-edge and ragged
//   tiles, the online softmax in f32, then O += P.V by D / 16 wgmma
//   m64n64k16 with P's bf16 A fragments from registers (the accumulator's
//   layout is mma.sync's C fragment, which converts to the A fragment in
//   place) and V read transposed from shared memory; O in registers (128
//   f32 at D = 256). A warpgroup skips a tile none of its rows may see.
//   Shared memory at D = 256: Q 128 x 256 bf16 (64 KB) + K and V, 2
//   stages of 64 x 256 each (128 KB) + 1 KB for the atoms' alignment = 193
//   KB, one block per SM.
//
//   flash_bwd_dkv_mma_kernel: one block of 8 warps per (kv head, batch
//   row, 64-key tile), the heaviest causal tiles launched first; it loops
//   over the qpk q heads and every live 64-query tile, so GQA needs no
//   atomics (the TPU grid's (B, Hkv, nk, qpk, nq) with the last two axes
//   as loops). mma.sync with ldmatrix from plain row-major tiles padded by
//   16 bytes (pitch D + 8: the 8 rows an ldmatrix reads fall in distinct
//   banks); its C fragments become A fragments in registers. Registers
//   decide the split: dk and dv at D = 256 are 64 x 256 x 2 f32, 128 a
//   thread, so D is split across the two warpgroups. Warps w and w + 4
//   share keys 16 w .. + 15 and own dk, dv columns [0, D/2) and [D/2, D)
//   in f32 registers. For each 32 queries warp w computes S^T = K.Q^T and
//   warp w + 4 dP^T = V.dO^T over the whole D; the pair trades half of
//   each through shared memory (named barrier 1 + w), each rebuilds p and
//   dz in f32 from lse and delta for 16 of the queries, turns them into
//   bf16-pair A fragments and adds their dV += P^T.dO and dK += dZ^T.Q on
//   its columns while the pair trades those fragments, then adds the
//   other warp's. Shared memory at D = 256: K and V 64 x 264 bf16 each (66
//   KB), Q and dO 2 stages of 64 x 264 each (132 KB), lse and delta 2 x 64
//   f32 a stage, the pairs' exchange 24 KB = 223 KB, one block per SM.
//
//   flash_bwd_dq_mma_kernel replaces _dq_kernel: the dkv design with the
//   roles of queries and keys swapped. Its bound at the training shapes
//   (B = 4, Hq 8 / Hkv 4, S = 1024, D = 256, causal) is 6 D flops a live
//   (query, key) pair at 989 TFLOP/s, 0.026 ms; its bytes (q, do, k, v
//   read once, dq written once) take less. One block of 8 warps per (q
//   head, batch row, 64-query tile), the heaviest causal tiles (the last)
//   launched first, so the tail of the grid is short tiles. Q and dO stay
//   resident; K and V stream in 64-key tiles through the 2-stage ring,
//   live tiles only. Warps w and w + 4 share queries 16 w .. + 15 and own
//   dq columns [0, D/2) and [D/2, D) in f32 registers (64 a thread at D =
//   256). For each 32 keys warp w computes S = Q.K^T and warp w + 4 dP =
//   dO.V^T over the whole D; the pair trades half of each through shared
//   memory (named barrier 1 + w), each rebuilds p and dz in f32 from lse
//   and delta (held in registers: the query tile never changes) for 16 of
//   the keys, turns dz into a bf16 A fragment and adds dQ += dZ.K on its
//   columns with K read transposed by ldmatrix, then adds the other warp's
//   16 keys once their fragment has crossed. dq is scaled and rounded to
//   bf16 once. Shared memory at D = 256: Q and dO 64 x 264 bf16 each (66
//   KB), K and V 2 stages of 64 x 264 each (132 KB), the pairs' exchange
//   12 KB = 210 KB, one block per SM.
//
// (2) FP32 FMA: every float32 call, and bf16 shapes outside (1). f32
// math on the CUDA cores from f32 shared tiles, as the TPU kernels cast q,
// k and v to f32; results rounded once to the operands' type.
//
//   flash_fwd_kernel: one block of 256 threads per (64-query tile, q
//   head, batch row); four threads per query row. The q tile stays in
//   shared memory as f32; each step stages 32 keys and values. Shared
//   reads are float4: q and k rows are padded to D + 4 floats, so the 8
//   rows a warp reads at one depth, and the 4 keys of a quad, fall in
//   distinct banks. A thread scores 8 keys of its row, the row's max and
//   sum go through quad shuffles, and the thread's D/4 output columns (4
//   consecutive ones in every 16; up to 64 f32 registers at D = 256) are
//   rescaled and accumulated from the 32 p values, fetched by shuffle
//   from the quad. Shared memory at D = 256: 132.6 KB.
//
//   flash_bwd_dq_kernel: one block of 256 threads per (64-query tile, q
//   head, batch row), streaming 32 keys and values a step, four threads
//   per query row as in the forward: a thread scores q.k and do.v for 8
//   keys, the 32 dz values go round the quad by shuffle, and the thread
//   accumulates its D/4 dq columns in registers. Shared memory at
//   D = 256: q and do 64 x 260 floats each, k and v 32 x 260 each =
//   199.7 KB.
//
//   flash_bwd_dkv_kernel: one block of 256 threads per (32-key tile, kv
//   head, batch row), looping over the qpk q heads and every live
//   32-query tile. Eight threads per key: a thread scores 4 of the 32
//   queries, p and dz go round the octet by shuffle, and the thread
//   accumulates D/8 columns of dk and of dv in registers. Shared memory
//   at D = 256: 133.4 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBKV = 32;         // keys per step
constexpr int kThreads = 256;    // 4 threads per query row
constexpr int kKeysPerThread = kBKV / 4;
constexpr int kMaxD = 256;
constexpr int kMaxGroups = kMaxD / 16;  // float4 output groups per thread
constexpr float kNegInf = -2.3819763e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int hq, int hkv, int s, int t,
                 int d, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, float scale, int causal,
                 int window, float softcap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = d + 4;
  float* qs = smem;                  // kBQ x dp
  float* ks = qs + kBQ * dp;         // kBKV x dp
  float* vs = ks + kBKV * dp;        // kBKV x d

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;            // query row of this thread in the tile
  const int tq = tid & 3;            // position within the row's quad
  const int lane = tid & 31;
  const int qpos = q0 + r;

  const T* qg = q + bi * qsb + h * qsh;
  const T* kg = k + bi * ksb + hk * ksh;
  const T* vg = v + bi * vsb + hk * vsh;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int rr = e / d, c = e % d;
    const int qi = q0 + rr;
    qs[rr * dp + c] = qi < s ? to_f(qg[qi * qss + c]) : 0.0f;
  }

  float4 acc[kMaxGroups];             // columns 16 * cc + 4 * tq + 0..3
#pragma unroll
  for (int cc = 0; cc < kMaxGroups; ++cc) acc[cc] = make_float4(0, 0, 0, 0);
  float m_i = kNegInf, l_i = 0.0f;

  // Live kv blocks only: keys above the tile's last query are dead under
  // the causal mask, keys at or below (first query - window) under the
  // window.
  int k_end = t;
  if (causal) k_end = min(t, q0 + kBQ);
  int k_beg = 0;
  if (window > 0) k_beg = max(0, q0 - window + 1) / kBKV * kBKV;

  for (int k0 = k_beg; k0 < k_end; k0 += kBKV) {
    __syncthreads();                 // the previous tile is consumed
    for (int e = tid; e < kBKV * d; e += kThreads) {
      const int j = e / d, c = e % d;
      const int kj = k0 + j;
      const bool in = kj < t;
      ks[j * dp + c] = in ? to_f(kg[kj * kss + c]) : 0.0f;
      vs[j * d + c] = in ? to_f(vg[kj * vss + c]) : 0.0f;
    }
    __syncthreads();

    float sc[kKeysPerThread];
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) sc[jj] = 0.0f;
    const float* qrow = qs + r * dp;
    for (int c = 0; c < d; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + c);
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (tq + 4 * jj) * dp + c);
        float z = fmaf(qv.x, kv.x, sc[jj]);
        z = fmaf(qv.y, kv.y, z);
        z = fmaf(qv.z, kv.z, z);
        sc[jj] = fmaf(qv.w, kv.w, z);
      }
    }

    float mx = kNegInf;
    unsigned live = 0;
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      const int kpos = k0 + tq + 4 * jj;
      float z = sc[jj] * scale;
      if (softcap > 0.0f) z = tanhf(z / softcap) * softcap;
      bool ok = kpos < t;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      sc[jj] = ok ? z : kNegInf;
      if (ok) {
        live |= 1u << jj;
        mx = fmaxf(mx, z);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      const float p = (live >> jj & 1u) ? expf(sc[jj] - m_new) : 0.0f;
      sc[jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;

#pragma unroll
    for (int cc = 0; cc < kMaxGroups; ++cc) {
      acc[cc].x *= alpha;
      acc[cc].y *= alpha;
      acc[cc].z *= alpha;
      acc[cc].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBKV; ++j) {
      // key j's p lives with quad lane j % 4, in its slot j / 4
      const float pj = __shfl_sync(0xffffffffu, sc[j / 4],
                                   (lane & ~3) | (j & 3));
      const float4* vrow = reinterpret_cast<const float4*>(vs + j * d);
#pragma unroll
      for (int cc = 0; cc < kMaxGroups; ++cc) {
        if (16 * cc + 4 * tq < d) {
          const float4 vv = vrow[4 * cc + tq];
          acc[cc].x = fmaf(pj, vv.x, acc[cc].x);
          acc[cc].y = fmaf(pj, vv.y, acc[cc].y);
          acc[cc].z = fmaf(pj, vv.z, acc[cc].z);
          acc[cc].w = fmaf(pj, vv.w, acc[cc].w);
        }
      }
    }
  }

  if (qpos < s) {
    const float l_safe = l_i == 0.0f ? 1.0f : l_i;
    T* orow = out + ((static_cast<size_t>(bi) * hq + h) * s + qpos) * d;
#pragma unroll
    for (int cc = 0; cc < kMaxGroups; ++cc) {
      const int c = 16 * cc + 4 * tq;
      if (c < d) {
        from_f(acc[cc].x / l_safe, orow + c);
        from_f(acc[cc].y / l_safe, orow + c + 1);
        from_f(acc[cc].z / l_safe, orow + c + 2);
        from_f(acc[cc].w / l_safe, orow + c + 3);
      }
    }
    if (tq == 0)
      lse[(static_cast<size_t>(bi) * hq + h) * s + qpos] =
          l_i == 0.0f ? kNegInf : m_i + logf(l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int hq, int hkv, int s, int t, int d, long long qsb,
           long long qsh, long long qss, long long ksb, long long ksh,
           long long kss, long long vsb, long long vsh, long long vss,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ) * (d + 4) + static_cast<size_t>(kBKV) * (d + 4)
       + static_cast<size_t>(kBKV) * d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), hq, hkv, s, t, d, qsb, qsh, qss, ksb, ksh,
      kss, vsb, vsh, vss, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Whether query qpos may attend key kpos, both in range.
__device__ __forceinline__ bool allowed(int qpos, int kpos, int s, int t,
                                        int causal, int window) {
  bool ok = qpos < s && kpos < t;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// (p, dz) of one (query, key) pair from its raw score q.k and do.v.
__device__ __forceinline__ void p_dz(float qk, float dov, float lse_q,
                                     float delta_q, bool ok, float scale,
                                     float softcap, float* p, float* dz) {
  const float z_raw = qk * scale;
  float z = z_raw, dcap = 1.0f;
  if (softcap > 0.0f) {
    const float th = tanhf(z_raw / softcap);
    z = th * softcap;
    dcap = 1.0f - th * th;
  }
  *p = ok ? expf(z - lse_q) : 0.0f;
  *dz = *p * (dov - delta_q) * dcap;
}

// rows [r0, r0 + n) of a contiguous (len, d) matrix into a (n, dp) f32
// tile; rows past len are zero
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int r0, int n, int len, int d, int dp) {
  for (int e = threadIdx.x; e < n * d; e += kThreads) {
    const int rr = e / d, c = e % d;
    const int ri = r0 + rr;
    dst[rr * dp + c] = ri < len ? to_f(src[static_cast<size_t>(ri) * d + c])
                                : 0.0f;
  }
}

constexpr int kDkvBK = 32;       // keys per dkv block
constexpr int kDkvBQ = 32;       // queries per dkv step
constexpr int kDkvGroups = kMaxD / 32;  // float4 column groups per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int hq, int hkv, int s, int t, int d, float scale,
                    int causal, int window, float softcap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = d + 4;
  float* qs = smem;                  // kBQ x dp
  float* dos = qs + kBQ * dp;        // kBQ x dp
  float* ks = dos + kBQ * dp;        // kBKV x dp
  float* vs = ks + kBKV * dp;        // kBKV x dp

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int tq = tid & 3;
  const int lane = tid & 31;
  const int qpos = q0 + r;

  const size_t qrow0 = (static_cast<size_t>(bi) * hq + h) * s;
  const size_t krow0 = (static_cast<size_t>(bi) * hkv + hk) * t;
  stage(q + qrow0 * d, qs, q0, kBQ, s, d, dp);
  stage(dout + qrow0 * d, dos, q0, kBQ, s, d, dp);
  const float lse_q = qpos < s ? lse[qrow0 + qpos] : 0.0f;
  const float delta_q = qpos < s ? delta[qrow0 + qpos] : 0.0f;

  float4 acc[kMaxGroups];
#pragma unroll
  for (int cc = 0; cc < kMaxGroups; ++cc) acc[cc] = make_float4(0, 0, 0, 0);

  int k_end = t;
  if (causal) k_end = min(t, q0 + kBQ);
  int k_beg = 0;
  if (window > 0) k_beg = max(0, q0 - window + 1) / kBKV * kBKV;

  for (int k0 = k_beg; k0 < k_end; k0 += kBKV) {
    __syncthreads();
    stage(k + krow0 * d, ks, k0, kBKV, t, d, dp);
    stage(v + krow0 * d, vs, k0, kBKV, t, d, dp);
    __syncthreads();

    float qk[kKeysPerThread], dv[kKeysPerThread];
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) qk[jj] = dv[jj] = 0.0f;
    const float* qrow = qs + r * dp;
    const float* dorow = dos + r * dp;
    for (int c = 0; c < d; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + c);
      const float4 o = *reinterpret_cast<const float4*>(dorow + c);
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const int j = tq + 4 * jj;
        const float4 kv = *reinterpret_cast<const float4*>(ks + j * dp + c);
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * dp + c);
        float z = fmaf(a.x, kv.x, qk[jj]);
        z = fmaf(a.y, kv.y, z);
        z = fmaf(a.z, kv.z, z);
        qk[jj] = fmaf(a.w, kv.w, z);
        float y = fmaf(o.x, vv.x, dv[jj]);
        y = fmaf(o.y, vv.y, y);
        y = fmaf(o.z, vv.z, y);
        dv[jj] = fmaf(o.w, vv.w, y);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kKeysPerThread; ++jj) {
      const int kpos = k0 + tq + 4 * jj;
      float p, dz;
      p_dz(qk[jj], dv[jj], lse_q, delta_q,
           allowed(qpos, kpos, s, t, causal, window), scale, softcap, &p,
           &dz);
      qk[jj] = dz;
    }
#pragma unroll
    for (int j = 0; j < kBKV; ++j) {
      // key j's dz lives with quad lane j % 4, in its slot j / 4
      const float dzj = __shfl_sync(0xffffffffu, qk[j / 4],
                                    (lane & ~3) | (j & 3));
      const float4* krow = reinterpret_cast<const float4*>(ks + j * dp);
#pragma unroll
      for (int cc = 0; cc < kMaxGroups; ++cc) {
        if (16 * cc + 4 * tq < d) {
          const float4 kv = krow[4 * cc + tq];
          acc[cc].x = fmaf(dzj, kv.x, acc[cc].x);
          acc[cc].y = fmaf(dzj, kv.y, acc[cc].y);
          acc[cc].z = fmaf(dzj, kv.z, acc[cc].z);
          acc[cc].w = fmaf(dzj, kv.w, acc[cc].w);
        }
      }
    }
  }

  if (qpos < s) {
    T* orow = dq + (qrow0 + qpos) * d;
#pragma unroll
    for (int cc = 0; cc < kMaxGroups; ++cc) {
      const int c = 16 * cc + 4 * tq;
      if (c < d) {
        from_f(acc[cc].x * scale, orow + c);
        from_f(acc[cc].y * scale, orow + c + 1);
        from_f(acc[cc].z * scale, orow + c + 2);
        from_f(acc[cc].w * scale, orow + c + 3);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int hq, int hkv, int s, int t, int d,
                     float scale, int causal, int window, float softcap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = d + 4;
  float* ks = smem;                  // kDkvBK x dp
  float* vs = ks + kDkvBK * dp;      // kDkvBK x dp
  float* qs = vs + kDkvBK * dp;      // kDkvBQ x dp
  float* dos = qs + kDkvBQ * dp;     // kDkvBQ x dp
  float* lses = dos + kDkvBQ * dp;   // kDkvBQ
  float* deltas = lses + kDkvBQ;     // kDkvBQ

  const int k0 = blockIdx.x * kDkvBK;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  const int qpk = hq / hkv;
  const int tid = threadIdx.x;
  const int r = tid >> 3;            // key row of this thread in the tile
  const int to = tid & 7;            // position within the key's octet
  const int lane = tid & 31;
  const int kpos = k0 + r;

  const size_t krow0 = (static_cast<size_t>(bi) * hkv + g) * t;
  stage(k + krow0 * d, ks, k0, kDkvBK, t, d, dp);
  stage(v + krow0 * d, vs, k0, kDkvBK, t, d, dp);

  float4 dk_acc[kDkvGroups], dv_acc[kDkvGroups];  // columns 32 * cc + 4 * to
#pragma unroll
  for (int cc = 0; cc < kDkvGroups; ++cc) {
    dk_acc[cc] = make_float4(0, 0, 0, 0);
    dv_acc[cc] = make_float4(0, 0, 0, 0);
  }

  // Live query tiles only: under the causal mask no query before k0 sees
  // the tile; under the window none at or past (last key + window).
  int q_beg = 0;
  if (causal) q_beg = min(k0, s) / kDkvBQ * kDkvBQ;
  int q_end = s;
  if (window > 0) q_end = min(s, k0 + kDkvBK - 1 + window);

  for (int hg = 0; hg < qpk; ++hg) {
    const size_t qrow0 = (static_cast<size_t>(bi) * hq + g * qpk + hg) * s;
    for (int q0 = q_beg; q0 < q_end; q0 += kDkvBQ) {
      __syncthreads();               // the previous tile is consumed
      stage(q + qrow0 * d, qs, q0, kDkvBQ, s, d, dp);
      stage(dout + qrow0 * d, dos, q0, kDkvBQ, s, d, dp);
      if (tid < kDkvBQ) {
        const int qi = q0 + tid;
        lses[tid] = qi < s ? lse[qrow0 + qi] : 0.0f;
        deltas[tid] = qi < s ? delta[qrow0 + qi] : 0.0f;
      }
      __syncthreads();

      float pk[4], dzk[4];           // queries to + 8 * ii
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pk[ii] = dzk[ii] = 0.0f;
      const float* krow = ks + r * dp;
      const float* vrow = vs + r * dp;
      for (int c = 0; c < d; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + c);
        const float4 vv = *reinterpret_cast<const float4*>(vrow + c);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = to + 8 * ii;
          const float4 a = *reinterpret_cast<const float4*>(qs + i * dp + c);
          const float4 o = *reinterpret_cast<const float4*>(dos + i * dp + c);
          float z = fmaf(a.x, kv.x, pk[ii]);
          z = fmaf(a.y, kv.y, z);
          z = fmaf(a.z, kv.z, z);
          pk[ii] = fmaf(a.w, kv.w, z);
          float y = fmaf(o.x, vv.x, dzk[ii]);
          y = fmaf(o.y, vv.y, y);
          y = fmaf(o.z, vv.z, y);
          dzk[ii] = fmaf(o.w, vv.w, y);
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = to + 8 * ii;
        float p, dz;
        p_dz(pk[ii], dzk[ii], lses[i], deltas[i],
             allowed(q0 + i, kpos, s, t, causal, window), scale, softcap, &p,
             &dz);
        pk[ii] = p;
        dzk[ii] = dz;
      }
#pragma unroll
      for (int i = 0; i < kDkvBQ; ++i) {
        // query i's p and dz live with octet lane i % 8, in slot i / 8
        const int src = (lane & ~7) | (i & 7);
        const float pi = __shfl_sync(0xffffffffu, pk[i / 8], src);
        const float dzi = __shfl_sync(0xffffffffu, dzk[i / 8], src);
        const float4* qrow = reinterpret_cast<const float4*>(qs + i * dp);
        const float4* dorow = reinterpret_cast<const float4*>(dos + i * dp);
#pragma unroll
        for (int cc = 0; cc < kDkvGroups; ++cc) {
          if (32 * cc + 4 * to < d) {
            const float4 a = qrow[8 * cc + to];
            const float4 o = dorow[8 * cc + to];
            dk_acc[cc].x = fmaf(dzi, a.x, dk_acc[cc].x);
            dk_acc[cc].y = fmaf(dzi, a.y, dk_acc[cc].y);
            dk_acc[cc].z = fmaf(dzi, a.z, dk_acc[cc].z);
            dk_acc[cc].w = fmaf(dzi, a.w, dk_acc[cc].w);
            dv_acc[cc].x = fmaf(pi, o.x, dv_acc[cc].x);
            dv_acc[cc].y = fmaf(pi, o.y, dv_acc[cc].y);
            dv_acc[cc].z = fmaf(pi, o.z, dv_acc[cc].z);
            dv_acc[cc].w = fmaf(pi, o.w, dv_acc[cc].w);
          }
        }
      }
    }
  }

  if (kpos < t) {
    T* krow_out = dk + (krow0 + kpos) * d;
    T* vrow_out = dv + (krow0 + kpos) * d;
#pragma unroll
    for (int cc = 0; cc < kDkvGroups; ++cc) {
      const int c = 32 * cc + 4 * to;
      if (c < d) {
        from_f(dk_acc[cc].x * scale, krow_out + c);
        from_f(dk_acc[cc].y * scale, krow_out + c + 1);
        from_f(dk_acc[cc].z * scale, krow_out + c + 2);
        from_f(dk_acc[cc].w * scale, krow_out + c + 3);
        from_f(dv_acc[cc].x, vrow_out + c);
        from_f(dv_acc[cc].y, vrow_out + c + 1);
        from_f(dv_acc[cc].z, vrow_out + c + 2);
        from_f(dv_acc[cc].w, vrow_out + c + 3);
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int b, int hq, int hkv, int s, int t, int d,
               float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  const size_t dp = static_cast<size_t>(d) + 4;
  const size_t dq_smem = sizeof(float) * (2 * kBQ + 2 * kBKV) * dp;
  const size_t dkv_smem =
      sizeof(float) * ((2 * kDkvBK + 2 * kDkvBQ) * dp + 2 * kDkvBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  if (dq != nullptr) {
    const dim3 grid((s + kBQ - 1) / kBQ, hq, b);
    flash_bwd_dq_kernel<T><<<grid, kThreads, dq_smem, stream>>>(
        qp, kp, vp, dop, lp, dlp, static_cast<T*>(dq), hq, hkv, s, t, d,
        scale, causal, window, softcap);
  } else {
    const dim3 grid((t + kDkvBK - 1) / kDkvBK, hkv, b);
    flash_bwd_dkv_kernel<T><<<grid, kThreads, dkv_smem, stream>>>(
        qp, kp, vp, dop, lp, dlp, static_cast<T*>(dk), static_cast<T*>(dv),
        hq, hkv, s, t, d, scale, causal, window, softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core design (bf16): building blocks
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcBQ = 128;       // forward: query rows per block, 16 a warp
constexpr int kTcBK = 64;        // forward, dq: keys a step; dkv: keys a block
constexpr int kTcBQd = 64;       // dkv: queries per step, in two halves; dq:
                                 // queries a block
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

// rows [r0, r0 + rows) of a (len, d) bf16 matrix with row stride rs
// (elements) into the first kD columns of a (rows, kD + 8) shared tile,
// one 16-byte cp.async a chunk; rows at or past len and columns at or
// past d are zero-filled, so products may run over all kD columns.
// d, rs and src 16-byte multiples.
template <int kD>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            long long rs, int r0, int rows,
                                            int len, int d) {
  constexpr int kChunks = kD / 8;              // per row
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = r0 + r < len && c < d;
    cp_async16(dst + r * (kD + 8) + c, in ? src + (r0 + r) * rs + c : src,
               in);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Fragments of mma.m16n8k16 (PTX ISA): lane = 4 g + tq holds A's rows g
// and g + 8, B's column g, C's rows g and g + 8 at columns 2 tq, 2 tq + 1.
// A (16 x 16) at (r0, c0) of a row-major shared tile x.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* x,
                                       int pitch, int r0, int c0,
                                       int lane) {
  ldsm_x4(a, x + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8);
}
// B of the n8 tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) at depth
// k0 .. k0 + 16, from a tile y stored [n][k] (K.Q^T: the keys' rows).
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* y,
                                       int pitch, int n0, int k0,
                                       int lane) {
  ldsm_x4(b, y + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 +
                 ((lane >> 3) & 1) * 8);
}
// The same from a tile z stored [k][n] (P.V: V's rows), transposed by
// the load.
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], const bf16* z,
                                         int pitch, int k0, int n0,
                                         int lane) {
  ldsm_x4_t(b, z + (k0 + (lane & 15)) * pitch + n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a barrier of the 64 threads of warps w and w + 4 (named barrier 1 + w)
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + w) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the 16-column chunk made of the f32 results c0, c1
// (two n8 tiles) of a product: the one place they are rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// As c_to_a, split in two: a[0] the values rounded to bf16, a[1] what
// that rounding lost, rounded to bf16 too; a[0] + a[1] holds ~16 bits of
// each f32 value.
__device__ __forceinline__ void c_to_a2(uint32_t (&a)[2][4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  c_to_a(a[0], c0, c1);
  float r0[4], r1[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a[0][h]: c0[2h], c0[2h + 1]; a[0][2 + h]: c1[2h], c1[2h + 1]
    r0[2 * h] = c0[2 * h] - __uint_as_float(a[0][h] << 16);
    r0[2 * h + 1] = c0[2 * h + 1] - __uint_as_float(a[0][h] & 0xffff0000u);
    r1[2 * h] = c1[2 * h] - __uint_as_float(a[0][2 + h] << 16);
    r1[2 * h + 1] =
        c1[2 * h + 1] - __uint_as_float(a[0][2 + h] & 0xffff0000u);
  }
  c_to_a(a[1], r0, r1);
}

// c (16 x 8 nt) += x[xr0 .. + 16, :depth] . y[yn0 .. + 8 nt, :depth]^T,
// both tiles stored row by row along the depth (a multiple of 16).
template <int nt, int depth>
__device__ __forceinline__ void mma_abt(float (&c)[nt][4], const bf16* x,
                                        const bf16* y, int pitch, int xr0,
                                        int yn0, int lane) {
#pragma unroll
  for (int kk = 0; kk < depth / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, x, pitch, xr0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < nt / 2; ++np) {
      uint32_t b[4];
      frag_b(b, y, pitch, yn0 + np * 16, kk * 16, lane);
      mma_bf16(c[2 * np], a, b[0], b[1]);
      mma_bf16(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// c (16 x 8 nt) += (a[0] + .. + a[parts - 1]) (16 x 16: one fragment
// from c_to_a, or a bf16 pair from c_to_a2) . z[k0 .. + 16, n0 .. + 8 nt)
// for z stored [k][n]; each B fragment is loaded once for all the parts.
template <int nt, int parts>
__device__ __forceinline__ void mma_az(float (&c)[nt][4],
                                       const uint32_t (&a)[parts][4],
                                       const bf16* z, int pitch, int k0,
                                       int n0, int lane) {
#pragma unroll
  for (int np = 0; np < nt / 2; ++np) {
    uint32_t b[4];
    frag_b_t(b, z, pitch, k0, n0 + np * 16, lane);
#pragma unroll
    for (int x = 0; x < parts; ++x) {
      mma_bf16(c[2 * np], a[x], b[0], b[1]);
      mma_bf16(c[2 * np + 1], a[x], b[2], b[3]);
    }
  }
}

// The logit z of a raw score q.k, scaled, then softcapped by the TPU
// kernel's formula cap * tanh(z / cap) with the division as a product by
// inv_cap = 1 / cap; *dcap = dz / d(q.k scale) = 1 - tanh^2.
__device__ __forceinline__ float logit(float qk, float scale, float softcap,
                                       float inv_cap, float* dcap) {
  const float z = qk * scale;
  if (softcap > 0.0f) {
    const float th = tanhf(z * inv_cap);
    *dcap = 1.0f - th * th;
    return th * softcap;
  }
  *dcap = 1.0f;
  return z;
}

// wgmma operands in shared memory, in the 128-byte swizzle: a tile of
// kRows x kD bf16 kept as atoms of 8 rows x 64 columns (1,024 bytes,
// 1,024-aligned), where row r's 16-byte chunk c sits at chunk c ^ (r % 8)
// of its 128-byte line, so the 8 rows of a column chunk fall in distinct
// banks. Atoms run down the rows, then across the 64-column blocks.
// stage_async into it: a thread's chunks run along shared memory, so 8
// threads fill one 128-byte line from one contiguous row segment; zeros
// past len rows and past d columns.
template <int kD, int kRows>
__device__ __forceinline__ void stage_async_sw(bf16* dst, const bf16* src,
                                               long long rs, int r0,
                                               int len, int d) {
  char* base = reinterpret_cast<char*>(dst);
  for (int e = threadIdx.x; e < kRows * kD / 8; e += kThreads) {
    const int rr = (e >> 3) & 7, atom = e >> 6;
    const int r = (atom % (kRows / 8)) * 8 + rr;
    const int c = (atom / (kRows / 8)) * 8 + ((e & 7) ^ rr);
    const bool in = r0 + r < len && c * 8 < d;
    cp_async16(base + e * 16, in ? src + (r0 + r) * rs + c * 8 : src, in);
  }
}

// The wgmma descriptor of an operand at p in that layout: 128-byte
// swizzle, 1,024 bytes from one 8-row group to the next (K-major, for Q
// and K, and MN-major, for V read transposed, alike); the other stride is
// not used by a 16-deep, 64-wide step inside one atom column.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                      << 62;
}

#define REPRO_D32(i)                                                   \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3]),          \
      "+f"(d[i + 1][0]), "+f"(d[i + 1][1]), "+f"(d[i + 1][2]),         \
      "+f"(d[i + 1][3])
#define REPRO_D32_ALL REPRO_D32(0), REPRO_D32(2), REPRO_D32(4), REPRO_D32(6)
#define REPRO_D32_REGS                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d (64 x 64 over the warpgroup; a warp's 16 rows as 8 n8 C fragments,
// the mma.sync layout) = or += A . B^T from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32_ALL
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A . B with A (64 x 16) from registers, each warp's 16
// rows as an mma.sync A fragment, and B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_t(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_D32_ALL
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_D32_REGS
#undef REPRO_D32_ALL
#undef REPRO_D32

// ---------------------------------------------------------------------------
// Tensor-core design (bf16): the kernels
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int hq, int hkv, int s, int t,
                       int d, long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       float scale, int causal, int window, float softcap) {
  constexpr int kTile = kTcBK * kD;            // elements of a K or V tile
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  base += (1024 - (smem_addr(base) & 1023)) & 1023;  // atoms 1,024-aligned
  bf16* qs = reinterpret_cast<bf16*>(base);    // kTcBQ x kD, swizzled
  bf16* ks = qs + kTcBQ * kD;                  // 2 stages of kTcBK x kD
  bf16* vs = ks + 2 * kTile;                   // 2 stages of kTcBK x kD

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQ;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wg0 = q0 + (warp >> 2) * 64;       // the warpgroup's first query
  const int row0 = q0 + warp * 16;             // the warp's first query
  const bf16* kg = k + bi * ksb + hk * ksh;
  const bf16* vg = v + bi * vsb + hk * vsh;

  // Live kv tiles only: keys above the tile's last query are dead under
  // the causal mask, keys at or below (first query - window) under the
  // window.
  int k_end = t;
  if (causal) k_end = min(t, q0 + kTcBQ);
  int k_beg = 0;
  if (window > 0) k_beg = max(0, q0 - window + 1) / kTcBK * kTcBK;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kTcBK - 1) / kTcBK
                                    : 0;

  stage_async_sw<kD, kTcBQ>(qs, q + bi * qsb + h * qsh, qss, q0, s, d);
  if (n_tiles > 0) {
    stage_async_sw<kD, kTcBK>(ks, kg, kss, k_beg, t, d);
    stage_async_sw<kD, kTcBK>(vs, vg, vss, k_beg, t, d);
  }
  cp_async_commit();

  float acc[kD / 64][8][4];                    // O: 64-column chunks
#pragma unroll
  for (int c = 0; c < kD / 64; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[c][i][0] = acc[c][i][1] = acc[c][i][2] = acc[c][i][3] = 0.0f;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  float m_r[2] = {kNegInf, kNegInf};         // rows g and g + 8
  float l_r[2] = {0.0f, 0.0f};               // this thread's columns only
  const char* qa = reinterpret_cast<const char*>(qs) +
                   (warp >> 2) * 8 * 1024;     // the warpgroup's 64 rows

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_beg + j * kTcBK;
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      stage_async_sw<kD, kTcBK>(ks + st * kTile, kg, kss, k0 + kTcBK, t, d);
      stage_async_sw<kD, kTcBK>(vs + st * kTile, vg, vss, k0 + kTcBK, t, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_proxy();
    __syncthreads();                          // tile j has landed
    const char* kt = reinterpret_cast<const char*>(ks + (j & 1) * kTile);
    const char* vt = reinterpret_cast<const char*>(vs + (j & 1) * kTile);
    // a warpgroup skips a tile none of its 64 rows may see
    const bool dead = wg0 >= s || (causal && k0 > wg0 + 63) ||
                      (window > 0 && k0 + kTcBK - 1 <= wg0 - window);
    if (!dead) {
      float sc[kTcBK / 8][4];
#pragma unroll
      for (int i = 0; i < kTcBK / 8; ++i)
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.0f;
      wgmma_fence();
      // step kk: columns 16 kk .. + 15, atom column kk / 4, 32 bytes in
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss(sc,
                 gmma_desc(qa + (kk / 4) * kTcBQ * 128 + (kk % 4) * 32),
                 gmma_desc(kt + (kk / 4) * kTcBK * 128 + (kk % 4) * 32),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // masks only where some (row, key) pair of the warp is not allowed
      const bool edge = k0 + kTcBK > t ||
                        (causal && k0 + kTcBK - 1 > row0) ||
                        (window > 0 && k0 <= row0 + 15 - window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kTcBK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dcap;
          float z = logit(sc[i][e], scale, softcap, inv_cap, &dcap);
          if (edge && !allowed(row0 + g + (e >> 1) * 8,
                               k0 + i * 8 + 2 * tq + (e & 1), s, t, causal,
                               window))
            z = -INFINITY;
          sc[i][e] = z;
          mx[e >> 1] = fmaxf(mx[e >> 1], z);
        }
      }
      float alpha[2], m2[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m_r[rr], mx[rr]);
        alpha[rr] = exp2f((m_r[rr] - m_new) * kLog2e);
        m_r[rr] = m_new;
        // m log2(e), 0 while m is NEG_INF (whose product overflows): the
        // row's keys so far are all masked, -inf, so p = 0 either way
        m2[rr] = m_new == kNegInf ? 0.0f : m_new * kLog2e;
        l_r[rr] *= alpha[rr];
      }
      uint32_t pa[kTcBK / 16][4];             // P as A fragments (bf16)
#pragma unroll
      for (int i = 0; i < kTcBK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(sc[i][e], kLog2e, -m2[e >> 1]));
          sc[i][e] = p;
          l_r[e >> 1] += p;
        }
      }
#pragma unroll
      for (int kc = 0; kc < kTcBK / 16; ++kc)
        c_to_a(pa[kc], sc[2 * kc], sc[2 * kc + 1]);
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[c][i][0] *= alpha[0];
          acc[c][i][1] *= alpha[0];
          acc[c][i][2] *= alpha[1];
          acc[c][i][3] *= alpha[1];
        }
#pragma unroll
      for (int c = 0; c < kD / 64; ++c) fence_regs(acc[c]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kTcBK / 16; ++kc)
#pragma unroll
        for (int c = 0; c < kD / 64; ++c)
          // keys 16 kc .. + 15 (row groups 2 kc, 2 kc + 1), columns
          // 64 c .. + 63 (atom column c)
          wgmma_rs_t(acc[c], pa[kc],
                     gmma_desc(vt + c * kTcBK * 128 + kc * 2 * 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kD / 64; ++c) fence_regs(acc[c]);
    }
    __syncthreads();                          // stage j & 1 is free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_r[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = row0 + g + rr * 8;
    if (qpos < s) {
      const float l_safe = l == 0.0f ? 1.0f : l;
      const size_t row = (static_cast<size_t>(bi) * hq + h) * s + qpos;
      bf16* orow = out + row * d;
#pragma unroll
      for (int c = 0; c < kD / 64; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = c * 64 + i * 8 + 2 * tq;
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[c][i][2 * rr] / l_safe,
                                      acc[c][i][2 * rr + 1] / l_safe);
        }
      if (tq == 0) lse[row] = l == 0.0f ? kNegInf : m_r[rr] + logf(l_safe);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int hq,
                         int hkv, int s, int t, int d, float scale,
                         int causal, int window, float softcap) {
  constexpr int P = kD + 8;
  constexpr int kHalf = kD / 2;               // dk, dv columns a warpgroup
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);  // kTcBK x P
  bf16* vs = ks + kTcBK * P;                   // kTcBK x P
  bf16* qs = vs + kTcBK * P;                   // 2 stages of kTcBQd x P
  bf16* dos = qs + 2 * kTcBQd * P;             // 2 stages of kTcBQd x P
  float* ls = reinterpret_cast<float*>(dos + 2 * kTcBQd * P);  // 2 x kTcBQd
  float* dls = ls + 2 * kTcBQd;                                // 2 x kTcBQd
  // what each warp hands its pair's other warp: half of its product (8
  // f32 a lane) and its half of the A fragments of P^T and dZ^T, each a
  // bf16 pair (16 words a lane), lane-major so a warp's access is one
  // 128-byte row
  float* xdp = dls + 2 * kTcBQd;                         // 8 x 8 x 32
  uint32_t* xpz = reinterpret_cast<uint32_t*>(xdp + 8 * 8 * 32);  // 8x16x32

  const int gk = blockIdx.x;                   // kv head
  const int bi = blockIdx.y;
  const int k0 = blockIdx.z * kTcBK;
  const int qpk = hq / hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int pair = warp & 3;                   // warps pair and pair + 4
  const int kr0 = pair * 16;                   // the pair's keys in the tile
  const int kw0 = k0 + kr0;
  const bool dp_warp = warp >= 4;              // computes dP^T, not S^T
  const int c0 = (warp >> 2) * kHalf;          // its dk, dv columns
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  const size_t krow0 = (static_cast<size_t>(bi) * hkv + gk) * t;
  stage_async<kD>(ks, k + krow0 * d, d, k0, kTcBK, t, d);
  stage_async<kD>(vs, v + krow0 * d, d, k0, kTcBK, t, d);

  // Live query tiles only: under the causal mask no query before k0 sees
  // the tile; under the window none at or past (last key + window).
  int q_beg = 0;
  if (causal) q_beg = min(k0, s) / kTcBQd * kTcBQd;
  int q_end = s;
  if (window > 0) q_end = min(s, k0 + kTcBK - 1 + window);
  const int n_qt = q_end > q_beg ? (q_end - q_beg + kTcBQd - 1) / kTcBQd
                                 : 0;
  const int n_steps = qpk * n_qt;             // (q head, query tile) pairs

  auto issue = [&](int i) {
    const int hg = i / n_qt, q0 = q_beg + (i - hg * n_qt) * kTcBQd;
    const int st = i & 1;
    const size_t qrow0 = (static_cast<size_t>(bi) * hq + gk * qpk + hg) * s;
    stage_async<kD>(qs + st * kTcBQd * P, q + qrow0 * d, d, q0, kTcBQd, s,
                    d);
    stage_async<kD>(dos + st * kTcBQd * P, dout + qrow0 * d, d, q0, kTcBQd,
                    s, d);
    const int r = tid & (kTcBQd - 1);
    const bool in = q0 + r < s;
    const float* src = tid < kTcBQd ? lse : delta;
    if (tid < 2 * kTcBQd)
      cp_async4((tid < kTcBQd ? ls : dls) + st * kTcBQd + r,
                src + qrow0 + (in ? q0 + r : 0), in);
  };
  if (n_steps > 0) issue(0);
  cp_async_commit();

  float dka[kHalf / 8][4], dva[kHalf / 8][4];
#pragma unroll
  for (int i = 0; i < kHalf / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                          // step i has landed
    const int q0 = q_beg + (i % n_qt) * kTcBQd;
    const bf16* qt = qs + (i & 1) * kTcBQd * P;
    const bf16* dot = dos + (i & 1) * kTcBQd * P;
    const float* lt = ls + (i & 1) * kTcBQd;
    const float* dlt = dls + (i & 1) * kTcBQd;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qr0 = half * 32;              // the half's queries in the tile
      const int qh0 = q0 + qr0;
      const bool dead = qh0 >= s || kw0 >= t ||
                        (causal && qh0 + 31 < kw0) ||
                        (window > 0 && qh0 >= kw0 + 15 + window);
      if (dead) continue;
      // S^T (warp pair) or dP^T (warp pair + 4): 16 keys x 32 queries
      float c[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
      mma_abt<4, kD>(c, dp_warp ? vs : ks, dp_warp ? dot : qt, P, kr0, qr0,
                     lane);
      // Each warp of the pair makes p and dz for 16 of the 32 queries (n8
      // tiles nm, nm + 1) from its own product and the other's.
      const int nm = dp_warp ? 2 : 0;
      const bool edge = qh0 + 32 > s || kw0 + 16 > t ||
                        (causal && qh0 < kw0 + 15) ||
                        (window > 0 && kw0 <= qh0 + 31 - window);
      float mine[2][4];
      float* give = xdp + (pair * 2 + dp_warp) * 8 * 32 + lane;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[j][e] = dp_warp ? c[2 + j][e] : c[j][e];
          give[(j * 4 + e) * 32] = dp_warp ? c[j][e] : c[2 + j][e];
        }
      pair_sync(pair);                        // the products have crossed
      const float* take = xdp + (pair * 2 + !dp_warp) * 8 * 32 + lane;
      float pm[2][4], dzm[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = take[(j * 4 + e) * 32];
          const int qi = qr0 + (nm + j) * 8 + 2 * tq + (e & 1);
          const int kpos = kw0 + g + (e >> 1) * 8;
          const bool ok =
              !edge || allowed(q0 + qi, kpos, s, t, causal, window);
          float dcap;
          const float z = logit(dp_warp ? other : mine[j][e], scale, softcap,
                                inv_cap, &dcap);
          const float p =
              ok ? exp2f(fmaf(z, kLog2e, -lt[qi] * kLog2e)) : 0.0f;
          pm[j][e] = p;
          dzm[j][e] = p * ((dp_warp ? mine[j][e] : other) - dlt[qi]) * dcap;
        }
      }
      // dV += P^T.dO and dK += dZ^T.Q with P and dZ each as a bf16 pair
      // (rounded value and rounding residue): first this warp's 16
      // queries, then the other warp's, whose fragments cross meanwhile
      const int kc = dp_warp ? 1 : 0;
      {
        uint32_t ap[2][4], az[2][4];
        c_to_a2(ap, pm[0], pm[1]);
        c_to_a2(az, dzm[0], dzm[1]);
        uint32_t* give_a = xpz + (pair * 2 + dp_warp) * 16 * 32 + lane;
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            give_a[(x * 4 + r) * 32] = ap[x][r];
            give_a[(8 + x * 4 + r) * 32] = az[x][r];
          }
        mma_az<kHalf / 8>(dva, ap, dot, P, qr0 + kc * 16, c0, lane);
        mma_az<kHalf / 8>(dka, az, qt, P, qr0 + kc * 16, c0, lane);
      }
      pair_sync(pair);                        // the fragments have crossed
      {
        const uint32_t* take_a =
            xpz + (pair * 2 + !dp_warp) * 16 * 32 + lane;
        uint32_t ap[2][4], az[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ap[x][r] = take_a[(x * 4 + r) * 32];
            az[x][r] = take_a[(8 + x * 4 + r) * 32];
          }
        mma_az<kHalf / 8>(dva, ap, dot, P, qr0 + (1 - kc) * 16, c0,
                             lane);
        mma_az<kHalf / 8>(dka, az, qt, P, qr0 + (1 - kc) * 16, c0,
                             lane);
      }
    }
    __syncthreads();                          // stage i & 1 is free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kpos = kw0 + g + rr * 8;
    if (kpos < t) {
      bf16* dkr = dk + (krow0 + kpos) * d;
      bf16* dvr = dv + (krow0 + kpos) * d;
#pragma unroll
      for (int i = 0; i < kHalf / 8; ++i) {
        const int c = c0 + i * 8 + 2 * tq;
        if (c < d) {
          *reinterpret_cast<__nv_bfloat162*>(dkr + c) = __floats2bfloat162_rn(
              dka[i][2 * rr] * scale, dka[i][2 * rr + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dvr + c) =
              __floats2bfloat162_rn(dva[i][2 * rr], dva[i][2 * rr + 1]);
        }
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int hq, int hkv, int s, int t,
                        int d, float scale, int causal, int window,
                        float softcap) {
  constexpr int P = kD + 8;
  constexpr int kHalf = kD / 2;               // dq columns a warpgroup
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // kTcBQd x P
  bf16* dos = qs + kTcBQd * P;                 // kTcBQd x P
  bf16* ks = dos + kTcBQd * P;                 // 2 stages of kTcBK x P
  bf16* vs = ks + 2 * kTcBK * P;               // 2 stages of kTcBK x P
  // what each warp hands its pair's other warp: half of its product (8
  // f32 a lane), then its dZ A fragment (4 words a lane), lane-major so a
  // warp's access is one 128-byte row
  float* xdp = reinterpret_cast<float*>(vs + 2 * kTcBK * P);   // 8 x 8 x 32
  uint32_t* xz = reinterpret_cast<uint32_t*>(xdp + 8 * 8 * 32);  // 8x4x32

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQd;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int pair = warp & 3;                   // warps pair and pair + 4
  const int qr0 = pair * 16;                   // the pair's queries in the tile
  const int qw0 = q0 + qr0;
  const bool dp_warp = warp >= 4;              // computes dP, not S
  const int c0 = (warp >> 2) * kHalf;          // its dq columns
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  const size_t qrow0 = (static_cast<size_t>(bi) * hq + h) * s;
  const size_t krow0 = (static_cast<size_t>(bi) * hkv + hk) * t;
  // lse log2(e) and delta of this thread's query rows g and g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = qw0 + g + rr * 8;
    l2[rr] = qpos < s ? lse[qrow0 + qpos] * kLog2e : 0.0f;
    dl[rr] = qpos < s ? delta[qrow0 + qpos] : 0.0f;
  }

  // Live key tiles only: keys above the tile's last query are dead under
  // the causal mask, keys at or below (first query - window) under the
  // window.
  int k_end = t;
  if (causal) k_end = min(t, q0 + kTcBQd);
  int k_beg = 0;
  if (window > 0) k_beg = max(0, q0 - window + 1) / kTcBK * kTcBK;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kTcBK - 1) / kTcBK
                                    : 0;

  stage_async<kD>(qs, q + qrow0 * d, d, q0, kTcBQd, s, d);
  stage_async<kD>(dos, dout + qrow0 * d, d, q0, kTcBQd, s, d);
  if (n_tiles > 0) {
    stage_async<kD>(ks, k + krow0 * d, d, k_beg, kTcBK, t, d);
    stage_async<kD>(vs, v + krow0 * d, d, k_beg, kTcBK, t, d);
  }
  cp_async_commit();

  float acc[kHalf / 8][4];
#pragma unroll
  for (int i = 0; i < kHalf / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_beg + j * kTcBK;
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      stage_async<kD>(ks + st * kTcBK * P, k + krow0 * d, d, k0 + kTcBK,
                      kTcBK, t, d);
      stage_async<kD>(vs + st * kTcBK * P, v + krow0 * d, d, k0 + kTcBK,
                      kTcBK, t, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                          // tile j has landed
    const bf16* kt = ks + (j & 1) * kTcBK * P;
    const bf16* vt = vs + (j & 1) * kTcBK * P;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr0 = half * 32;              // the half's keys in the tile
      const int kh0 = k0 + kr0;
      const bool dead = qw0 >= s || kh0 >= t ||
                        (causal && kh0 > qw0 + 15) ||
                        (window > 0 && kh0 + 31 <= qw0 - window);
      if (dead) continue;
      // S (warp pair) or dP (warp pair + 4): 16 queries x 32 keys
      float c[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.0f;
      mma_abt<4, kD>(c, dp_warp ? dos : qs, dp_warp ? vt : kt, P, qr0, kr0,
                     lane);
      // Each warp of the pair makes p and dz for 16 of the 32 keys (n8
      // tiles nm, nm + 1) from its own product and the other's.
      const int nm = dp_warp ? 2 : 0;
      const bool edge = qw0 + 16 > s || kh0 + 32 > t ||
                        (causal && qw0 < kh0 + 31) ||
                        (window > 0 && kh0 <= qw0 + 15 - window);
      float mine[2][4];
      float* give = xdp + (pair * 2 + dp_warp) * 8 * 32 + lane;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[jj][e] = dp_warp ? c[2 + jj][e] : c[jj][e];
          give[(jj * 4 + e) * 32] = dp_warp ? c[jj][e] : c[2 + jj][e];
        }
      pair_sync(pair);                        // the products have crossed
      const float* take = xdp + (pair * 2 + !dp_warp) * 8 * 32 + lane;
      float dzm[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = take[(jj * 4 + e) * 32];
          const int rr = e >> 1;
          const int kpos = kh0 + (nm + jj) * 8 + 2 * tq + (e & 1);
          const bool ok =
              !edge || allowed(qw0 + g + rr * 8, kpos, s, t, causal, window);
          float dcap;
          const float z = logit(dp_warp ? other : mine[jj][e], scale,
                                softcap, inv_cap, &dcap);
          const float p = ok ? exp2f(fmaf(z, kLog2e, -l2[rr])) : 0.0f;
          dzm[jj][e] =
              p * ((dp_warp ? mine[jj][e] : other) - dl[rr]) * dcap;
        }
      }
      // dQ += dZ.K, dZ rounded once to bf16: first this warp's 16 keys,
      // then the other warp's, whose fragment crosses meanwhile
      const int kc = dp_warp ? 1 : 0;
      {
        uint32_t az[1][4];
        c_to_a(az[0], dzm[0], dzm[1]);
        uint32_t* give_a = xz + (pair * 2 + dp_warp) * 4 * 32 + lane;
#pragma unroll
        for (int r = 0; r < 4; ++r) give_a[r * 32] = az[0][r];
        mma_az<kHalf / 8>(acc, az, kt, P, kr0 + kc * 16, c0, lane);
      }
      pair_sync(pair);                        // the fragments have crossed
      {
        const uint32_t* take_a = xz + (pair * 2 + !dp_warp) * 4 * 32 + lane;
        uint32_t az[1][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) az[0][r] = take_a[r * 32];
        mma_az<kHalf / 8>(acc, az, kt, P, kr0 + (1 - kc) * 16, c0, lane);
      }
    }
    __syncthreads();                          // stage j & 1 is free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = qw0 + g + rr * 8;
    if (qpos < s) {
      bf16* dqr = dq + (qrow0 + qpos) * d;
#pragma unroll
      for (int i = 0; i < kHalf / 8; ++i) {
        const int c = c0 + i * 8 + 2 * tq;
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(dqr + c) = __floats2bfloat162_rn(
              acc[i][2 * rr] * scale, acc[i][2 * rr + 1] * scale);
      }
    }
  }
}

template <int kD>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                   void* lse, int b, int hq, int hkv, int s, int t, int d,
                   long long qsb, long long qsh, long long qss, long long ksb,
                   long long ksh, long long kss, long long vsb, long long vsh,
                   long long vss, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (kTcBQ + 4 * kTcBK) * kD + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the query tile on the slowest axis, last (heaviest causal) tile first
  const dim3 grid(hq, b, (s + kTcBQ - 1) / kTcBQ);
  flash_fwd_wgmma_kernel<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), hq, hkv, s, t, d, qsb, qsh, qss, ksb, ksh,
      kss, vsb, vsh, vss, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int hq, int hkv, int s, int t,
                   int d, float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kTcBK + 4 * kTcBQd) * (kD + 8) +
                      sizeof(float) * (4 * kTcBQd + 8 * 8 * 32 +
                                       8 * 16 * 32);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the key tile on the slowest axis, first (heaviest causal) tile first
  const dim3 grid(hkv, b, (t + kTcBK - 1) / kTcBK);
  flash_bwd_dkv_mma_kernel<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, s, t, d,
      scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int b, int hq, int hkv, int s, int t, int d,
                  float scale, int causal, int window, float softcap,
                  cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kTcBQd + 4 * kTcBK) * (kD + 8) +
                      sizeof(float) * (8 * 8 * 32 + 8 * 4 * 32);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the query tile on the slowest axis, last (heaviest causal) tile first
  const dim3 grid(hq, b, (s + kTcBQd - 1) / kTcBQd);
  flash_bwd_dq_mma_kernel<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), hq, hkv, s, t, d, scale, causal, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether bf16 operands of head dim d with these pointers and strides
// (elements) take the tensor-core design: d a multiple of 16 up to 256,
// every row 16-byte aligned.
bool tc_shape(int d, std::initializer_list<const void*> ptrs,
              std::initializer_list<long long> strides) {
  if (d % 16 || d > kMaxD) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  for (long long st : strides)
    if (st % 8) return false;
  return true;
}

int bwd_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int b, int hq, int hkv, int s, int t, int d,
              float scale, int causal, int window, float softcap, int is_bf16,
              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > kMaxD || d < 4 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && tc_shape(d, {q, k, v, dout}, {})) {
    if (dq != nullptr)
      return (d <= 64 ? &launch_dq_mma<64>
              : d <= 128 ? &launch_dq_mma<128> : &launch_dq_mma<256>)(
          q, k, v, dout, lse, delta, dq, b, hq, hkv, s, t, d, scale, causal,
          window, softcap, st);
    return (d <= 64 ? &launch_dkv_mma<64>
            : d <= 128 ? &launch_dkv_mma<128> : &launch_dkv_mma<256>)(
        q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, s, t, d, scale,
        causal, window, softcap, st);
  }
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b,
                                     hq, hkv, s, t, d, scale, causal, window,
                                     softcap, st);
  return launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, hq, hkv,
                           s, t, d, scale, causal, window, softcap, st);
}

}  // namespace

extern "C" {

// q: (B, Hq, S, D), k/v: (B, Hkv, T, D), each with a unit last stride and
// the given (batch, head, position) strides in elements; out: contiguous
// (B, Hq, S, D) of q's type; lse: contiguous (B, Hq, S) float32.
// bf16 when is_bf16 else float32; D <= 256 and a multiple of 4; Hq a
// multiple of Hkv. bf16 with D a multiple of 16 and 16-byte aligned rows
// runs on the tensor cores, anything else on FP32 FMA.
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int b, int hq, int hkv, int s, int t, int d,
              long long qsb, long long qsh, long long qss, long long ksb,
              long long ksh, long long kss, long long vsb, long long vsh,
              long long vss, float scale, int causal, int window,
              float softcap, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > kMaxD || d < 4 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && tc_shape(d, {q, k, v},
                          {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss}))
    return (d <= 64 ? &launch_fwd_wgmma<64>
            : d <= 128 ? &launch_fwd_wgmma<128> : &launch_fwd_wgmma<256>)(
        q, k, v, out, lse, b, hq, hkv, s, t, d, qsb, qsh, qss, ksb, ksh, kss,
        vsb, vsh, vss, scale, causal, window, softcap, st);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, lse, b, hq, hkv, s, t, d, qsb,
                                 qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
                                 scale, causal, window, softcap, st);
  return launch<float>(q, k, v, out, lse, b, hq, hkv, s, t, d, qsb, qsh, qss,
                       ksb, ksh, kss, vsb, vsh, vss, scale, causal, window,
                       softcap, st);
}

// q, dout, dq: (B, Hq, S, D); k, v: (B, Hkv, T, D); lse, delta: (B, Hq, S)
// float32; every tensor contiguous; q, k, v, dout and dq of one type
// (bf16 when is_bf16 else float32). dq = the gradient of q. bf16 with D a
// multiple of 16 and 16-byte aligned rows runs on the tensor cores.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int b, int hq, int hkv, int s, int t, int d,
                 float scale, int causal, int window, float softcap,
                 int is_bf16, void* stream) {
  return bwd_entry(q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, hq,
                   hkv, s, t, d, scale, causal, window, softcap, is_bf16,
                   stream);
}

// As flash_bwd_dq; dk, dv: contiguous (B, Hkv, T, D), the gradients of k
// and v summed over the qpk q heads of each kv head. bf16 with D a
// multiple of 16 and 16-byte aligned rows runs on the tensor cores.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int b, int hq, int hkv, int s, int t,
                  int d, float scale, int causal, int window, float softcap,
                  int is_bf16, void* stream) {
  return bwd_entry(q, k, v, dout, lse, delta, nullptr, dk, dv, b, hq, hkv, s,
                   t, d, scale, causal, window, softcap, is_bf16, stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
