// Flash attention for Hopper, sm_90a: the forward and the two backward
// passes.
//
// Replaces the Pallas TPU kernel _fwd_kernel (flash_fwd) of
// src/repro/kernels/flash_attention/flash_attention.py: online-softmax
// attention that never stores the (S, T) logits, with GQA (q head h reads
// kv head h / qpk, no repeated KV), causal and sliding-window masks by
// absolute position, dead kv blocks skipped, and the tanh logit softcap.
//   q (B, Hq, S, D), k/v (B, Hkv, T, D) -> out (B, Hq, S, D) in q's type,
//   lse (B, Hq, S) float32; rows with no allowed key get l = 0, out 0 and
//   lse = NEG_INF, as the TPU kernel's flush.
//
// The math is float32 throughout, as in the TPU kernel (which casts q, k
// and v to f32): q.k products, softcap, the running max and sum, p and the
// p.v products are FP32 FMA on the CUDA cores, not the tensor cores.
//
// Design. One block of 256 threads per (64-query tile, q head, batch row);
// four threads per query row. The q tile stays in shared memory as f32;
// each step stages 32 keys and values. Shared reads are float4: q and k
// rows are padded to D + 4 floats, so the 8 rows a warp reads at one
// depth, and the 4 keys of a quad, fall in distinct banks. A thread
// scores 8 keys of its row, the row's max and sum go through quad
// shuffles, and the thread's D/4 output columns (4 consecutive ones in
// every 16; up to 64 f32 registers at D = 256) are rescaled and
// accumulated from the 32 p values, fetched by shuffle from the quad.
// Shared memory at D = 256: 64 x 260 + 32 x 260 + 32 x 256 floats =
// 132.6 KB (dynamic, above the 48 KB default), one block per SM.
// What bounds it: at the prefill's shapes (S = 1024, D = 256) the work is
// ~2*S*S*D flops a head, far above the bytes (q, k, v, out once), so
// operations bound it; this first version runs them on FP32 FMA fed from
// shared memory, not on the bf16 tensor cores (wgmma is later work).
// S and T need not be multiples of the tiles: the tails are masked here.
//
// flash_bwd_dq and flash_bwd_dkv replace the Pallas TPU kernels _dq_kernel
// and _dkv_kernel (flash_bwd) of the same file: the standard two-pass
// backward, both recomputing p = exp(z - lse) from the forward's saved
// logsumexp, so nothing quadratic is stored. With delta = sum(do * out)
// per query row (computed by the caller, as the TPU wrapper does outside
// its kernels) and the softcap's exact derivative 1 - tanh(z_raw / cap)^2:
//   dz = p * (do . v - delta) * (1 - tanh^2),
//   dq = scale * sum_k dz k,   dk = scale * sum_q dz q,   dv = sum_q p do.
// f32 math on FP32 FMA from f32 shared tiles, as the TPU kernels cast to
// f32; dq, dk and dv are rounded once to the operands' type. GQA by
// h / qpk, causal and window masks by absolute position, dead tiles
// skipped, ragged S and T masked. q, k, v, do contiguous.
//
// flash_bwd_dq: one block of 256 threads per (64-query tile, q head,
// batch row), streaming 32 keys and values a step, four threads per query
// row as in the forward: a thread scores q.k and do.v for 8 keys, the 32
// dz values go round the quad by shuffle, and the thread accumulates its
// D/4 dq columns in registers. Shared memory at D = 256: q and do
// 64 x 260 floats each, k and v 32 x 260 each = 199.7 KB (dynamic), one
// block per SM.
//
// flash_bwd_dkv: one block of 256 threads per (32-key tile, kv head, batch
// row) owns its dk and dv tiles and loops over the qpk q heads of that kv
// head and over every live 32-query tile, so the GQA sum needs no atomics
// (the TPU grid's (B, Hkv, nk, qpk, nq) with the last two axes as loops).
// Eight threads per key: a thread scores 4 of the 32 queries, p and dz go
// round the octet by shuffle, and the thread accumulates D/8 columns of
// dk and of dv in registers. Shared memory at D = 256: k, v, q and do
// 32 x 260 floats each plus lse and delta = 133.4 KB (dynamic), one block
// per SM.
// What bounds both: ~6 S T D (dq) and ~8 S T D (dk, dv) flops a head,
// halved by the causal mask, far above their bytes, so operations; this
// first version runs them on FP32 FMA, not on the bf16 tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

int bwd_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int b, int hq, int hkv, int s, int t, int d,
              float scale, int causal, int window, float softcap, int is_bf16,
              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > kMaxD || d < 4 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
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
// multiple of Hkv.
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int b, int hq, int hkv, int s, int t, int d,
              long long qsb, long long qsh, long long qss, long long ksb,
              long long ksh, long long kss, long long vsb, long long vsh,
              long long vss, float scale, int causal, int window,
              float softcap, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > kMaxD || d < 4 || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
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
// (bf16 when is_bf16 else float32). dq = the gradient of q.
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
// and v summed over the qpk q heads of each kv head.
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
