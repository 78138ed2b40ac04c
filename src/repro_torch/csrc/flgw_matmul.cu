// Grouped (block-diagonal) batched matmul for FLGW on Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel _bmm_kernel (grouped_bmm) of
// src/repro/kernels/flgw_matmul/flgw_matmul.py:
//   y[g] = x[g] @ w[g],  x (G, B, K), w (G, K, N) -> y (G, B, N), float32.
//
// Plain FP32 FMA on the CUDA cores, accumulated in a float32 register per
// output, never TF32: the MARL path runs this product in f32 and must
// agree with the f32 reference to ~1e-6.
//
// What bounds it on this card: at the MARL path's shapes (B = 128 rows,
// K <= 40, N <= 160, G = 4) one call moves at most ~0.5 MB and does at
// most ~6.6 MFLOP, ~0.15 us of HBM time or ~0.1 us of f32 ALU time, so
// the launch (microseconds) is the bound, not the arithmetic. The design
// is a simple, correct tiling: one block per (g, 64-row tile, 64-column
// tile), 256 threads each owning a 4x4 patch of outputs, x and w staged
// through shared memory 16 deep along K. Ragged edges (B, K, N not
// multiples of the tile) are masked here, so the caller pads nothing.
// wgmma/TMA tiles are later work: they pay only at far larger shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // rows of x per block
constexpr int kBN = 64;   // columns of w per block
constexpr int kBK = 16;   // depth staged per shared-memory pass
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__global__ void __launch_bounds__(kThreads)
grouped_bmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int b, int k, int n) {
  __shared__ float xs[kBK][kBM + 1];  // x tile, stored k-major
  __shared__ float ws[kBK][kBN];

  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const float* xg = x + static_cast<size_t>(g) * b * k;
  const float* wg = w + static_cast<size_t>(g) * k * n;
  float* yg = y + static_cast<size_t>(g) * b * n;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < b && gc < k) ? xg[static_cast<size_t>(gr) * k + gc]
                                    : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < k && gc < n) ? wg[static_cast<size_t>(gr) * n + gc]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = ws[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= b) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx * kTN + j;
      if (gc < n) yg[static_cast<size_t>(gr) * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x: (G, B, K), w: (G, K, N), y: (G, B, N); contiguous float32.
int grouped_bmm_f32(const void* x, const void* w, void* y, int g, int b,
                    int k, int n, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (b + kBM - 1) / kBM, g);
  grouped_bmm_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), b, k, n);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
