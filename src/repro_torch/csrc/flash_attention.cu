// Flash-attention forward for Hopper, sm_90a.
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
