// Compact FLGW matmuls for Hopper, sm_90a: the grouped (block-diagonal)
// batched product and its fused-gather variant.
//
// grouped_bmm_f32 and grouped_bmm_bf16 replace the Pallas TPU kernel
// _bmm_kernel (grouped_bmm) of src/repro/kernels/flgw_matmul/flgw_matmul.py:
//   y[g] = x[g] @ w[g],  x (G, B, K), w (G, K, N) -> y (G, B, N) in x's
//   type, f32 accumulation.
//
// grouped_bmm_f32: plain FP32 FMA on the CUDA cores, accumulated in a
// float32 register per output, never TF32: the MARL path runs this
// product in f32 and must agree with the f32 reference to ~1e-6.
//
// What bounds grouped_bmm_f32 on this card: at the MARL path's shapes
// (B = 128 rows, K <= 40, N <= 160, G = 4) one call moves at most
// ~0.5 MB and does at most ~6.6 MFLOP, ~0.15 us of HBM time or ~0.1 us
// of f32 ALU time, so the launch (microseconds) is the bound, not the
// arithmetic. The design
// is a simple, correct tiling: one block per (g, 64-row tile, 64-column
// tile), 256 threads each owning a 4x4 patch of outputs, x and w staged
// through shared memory 16 deep along K. Ragged edges (B, K, N not
// multiples of the tile) are masked here, so the caller pads nothing.
// wgmma/TMA tiles are later work: they pay only at far larger shapes.
//
// grouped_bmm_bf16: the LM training path's product (bf16 models' plans
// carry no compact weights, so every FLGW projection gathers its operands
// and lands here). bf16 operands on the tensor cores through wmma
// 16x16x16 with f32 accumulators, the output rounded once to bf16, as
// the TPU kernel's bf16 x bf16 -> f32 dot. Tiles as fused_bmm's: 64 rows,
// 128 columns wide when there are more than 64 rows (64 otherwise), 4
// warps, 32 deep per shared-memory pass, 16-byte loads where the widths
// are multiples of 8 and the base is 16-byte aligned. At gemma2-2b's
// training shapes (B = 4096 rows, K x N = 720 x 2880 up/gate, 2880 x 720
// down, G = 4) one call is ~68 GFLOP against ~134 MB, so the tensor cores'
// operations bound it; this version neither pipelines its loads nor uses
// wgmma/TMA. Ragged B, K and N are masked here.
//
// fused_bmm replaces the Pallas TPU kernel _fused_kernel (fused_bmm) of
// the same file, the serving path's product on compact weights:
//   y[g] = x[:, ids[g]] @ wc[g],  x (B, M) given transposed with a zero
//   sink row as xt (M+1, B), wc (G, capM, capN), ids (G, capM) int32 ->
//   y (G, B, capN) in x's dtype, f32 accumulation.
// Every invalid slot's id is M, the zero row, so the gather itself masks.
// The TPU kernel stages the whole (bb, M+1) x block in VMEM; at M = 9216
// in bf16 that is ten times Hopper's shared memory, so here each k-tile
// of x is gathered from device memory by that tile's ids (staged in
// shared memory first). x comes transposed so that one gathered id is a
// run of consecutive rows: the gather's loads coalesce instead of
// fetching a 32-byte sector for every 2-byte element. bf16 runs on the
// tensor cores (wmma 16x16x16, f32 accumulators): 64-row tiles, 128
// columns wide when there are more than 64 rows (64 wide otherwise),
// 4 warps, 32 deep per shared-memory pass, operands staged with 16-byte
// loads where the widths are multiples of 8. f32 runs the FP32-FMA tiling
// of grouped_bmm (no TF32). What bounds it: a decode step (B = 4 rows)
// streams every compact weight once, so it is bound by bytes (~1.6 GB a
// forward of gemma2-2b at G = 4); a prefill (B = 4096 rows) is bound by
// the tensor cores' operations. A few rows give a few dozen column tiles,
// each walking up to 90 serial k-steps, so the caller may split K across
// blocks (f32 partials, summed in split order by a second kernel). This
// version neither pipelines its loads nor uses wgmma/TMA; ragged B, capM
// and capN are masked here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// xt (M+1, B) gathered by ids, f32 FMA; same tiling as grouped_bmm_kernel.
__global__ void __launch_bounds__(kThreads)
fused_bmm_f32_kernel(const float* __restrict__ xt, const float* __restrict__ w,
                     const int* __restrict__ ids, float* __restrict__ y,
                     int b, int k, int n) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];
  __shared__ int idk[kBK];

  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int* idg = ids + static_cast<size_t>(g) * k;
  const float* wg = w + static_cast<size_t>(g) * k * n;
  float* yg = y + static_cast<size_t>(g) * b * n;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    if (tid < kBK) idk[tid] = (k0 + tid < k) ? idg[k0 + tid] : -1;
    __syncthreads();
    // one gathered row of xt is a run of consecutive activations
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int c = e / kBM, r = e % kBM;
      const int gr = row0 + r, id = idk[c];
      xs[c][r] = (gr < b && id >= 0) ? xt[static_cast<size_t>(id) * b + gr]
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

// bf16 on the tensor cores through wmma; f32 accumulators. A block owns
// 64 rows x BN columns; its 4 warps (2 x 2) own 32 x BN/2 each.
constexpr int kWM = 64;                 // rows of x per block
constexpr int kWK = 32;                 // depth per shared-memory pass
constexpr int kWThreads = 128;

// blockIdx.z = split * G + g: split s takes k-rows [s * k_split, ...) and,
// when there are several splits, writes f32 partial sums to part
// (splits, G, B, N) for reduce_splits_kernel instead of y.
template <int BN>
__global__ void __launch_bounds__(kWThreads)
fused_bmm_bf16_kernel(const __nv_bfloat16* __restrict__ xt,
                      const __nv_bfloat16* __restrict__ w,
                      const int* __restrict__ ids,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ part, int ng, int b, int k, int n,
                      int k_split) {
  using namespace nvcuda;
  constexpr int kFN = BN / 32;          // 16-wide fragments per warp along N
  // Padded leading dims: multiples of 8 bf16 / 4 f32, and every fragment
  // starts 32-byte aligned. The x tile is stored k-major (the A fragments
  // load it column-major), so the coalesced gather stores conflict-free.
  constexpr int kXsLd = kWM + 8;
  constexpr int kWsLd = BN + 8;
  constexpr int kCsLd = BN + 4;
  constexpr int kLoadBytes = (kWK * kXsLd + kWK * kWsLd) * 2;
  constexpr int kStoreBytes = kWM * kCsLd * 4;
  constexpr int kSmem = kLoadBytes > kStoreBytes ? kLoadBytes : kStoreBytes;
  // the epilogue's f32 tile reuses the operand tiles' memory
  __shared__ __align__(128) unsigned char smem[kSmem];
  __shared__ int idk[kWK];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + kWK * kXsLd;
  float* cs = reinterpret_cast<float*>(smem);

  const int g = blockIdx.z % ng;
  const int split = blockIdx.z / ng;
  const int k_beg = split * k_split;
  const int k_end = min(k, k_beg + k_split);
  const int row0 = blockIdx.y * kWM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int* idg = ids + static_cast<size_t>(g) * k;
  const __nv_bfloat16* wg = w + static_cast<size_t>(g) * k * n;
  __nv_bfloat16* yg = y + static_cast<size_t>(g) * b * n;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // 16-byte loads of 8 bf16 where the widths allow (every real layer's
  // do); element loads for ragged widths
  const bool vec_x = b % 8 == 0;
  const bool vec_w = n % 8 == 0;
  const uint4 zero8 = make_uint4(0, 0, 0, 0);

  for (int k0 = k_beg; k0 < k_end; k0 += kWK) {
    if (tid < kWK) idk[tid] = (k0 + tid < k_end) ? idg[k0 + tid] : -1;
    __syncthreads();
    if (vec_x) {
      for (int e = tid; e < kWK * (kWM / 8); e += kWThreads) {
        const int c = e / (kWM / 8), r = e % (kWM / 8) * 8;
        const int gr = row0 + r, id = idk[c];
        *reinterpret_cast<uint4*>(xs + c * kXsLd + r) = (gr < b && id >= 0)
            ? *reinterpret_cast<const uint4*>(
                  xt + static_cast<size_t>(id) * b + gr)
            : zero8;
      }
    } else {
      for (int e = tid; e < kWK * kWM; e += kWThreads) {
        const int c = e / kWM, r = e % kWM;
        const int gr = row0 + r, id = idk[c];
        xs[c * kXsLd + r] = (gr < b && id >= 0)
            ? xt[static_cast<size_t>(id) * b + gr] : zero;
      }
    }
    if (vec_w) {
      for (int e = tid; e < kWK * (BN / 8); e += kWThreads) {
        const int r = e / (BN / 8), c = e % (BN / 8) * 8;
        const int gr = k0 + r, gc = col0 + c;
        *reinterpret_cast<uint4*>(ws + r * kWsLd + c) = (gr < k_end && gc < n)
            ? *reinterpret_cast<const uint4*>(
                  wg + static_cast<size_t>(gr) * n + gc)
            : zero8;
      }
    } else {
      for (int e = tid; e < kWK * BN; e += kWThreads) {
        const int r = e / BN, c = e % BN;
        const int gr = k0 + r, gc = col0 + c;
        ws[r * kWsLd + c] = (gr < k_end && gc < n)
            ? wg[static_cast<size_t>(gr) * n + gc] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[kFN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + kk * kXsLd + wm * 32 + i * 16,
                               kXsLd);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * kWsLd + wn * (BN / 2)
                                          + j * 16, kWsLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kCsLd
                                  + wn * (BN / 2) + j * 16,
                              acc[i][j], kCsLd, wmma::mem_row_major);
  __syncthreads();
  float* pg = part == nullptr ? nullptr
      : part + (static_cast<size_t>(split) * ng + g) * b * n;
  for (int e = tid; e < kWM * BN; e += kWThreads) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= b || gc >= n) continue;
    const size_t at = static_cast<size_t>(gr) * n + gc;
    if (pg != nullptr)
      pg[at] = cs[r * kCsLd + c];
    else
      yg[at] = __float2bfloat16(cs[r * kCsLd + c]);
  }
}

// x (G, B, K) row-major, bf16 on the tensor cores; same tiling and
// epilogue as fused_bmm_bf16_kernel, with the x tile stored row-major.
template <int BN>
__global__ void __launch_bounds__(kWThreads)
grouped_bmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y, int b, int k, int n) {
  using namespace nvcuda;
  constexpr int kFN = BN / 32;
  constexpr int kXsLd = kWK + 8;
  constexpr int kWsLd = BN + 8;
  constexpr int kCsLd = BN + 4;
  constexpr int kLoadBytes = (kWM * kXsLd + kWK * kWsLd) * 2;
  constexpr int kStoreBytes = kWM * kCsLd * 4;
  constexpr int kSmem = kLoadBytes > kStoreBytes ? kLoadBytes : kStoreBytes;
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + kWM * kXsLd;
  float* cs = reinterpret_cast<float*>(smem);

  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kWM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const __nv_bfloat16* xg = x + static_cast<size_t>(g) * b * k;
  const __nv_bfloat16* wg = w + static_cast<size_t>(g) * k * n;
  __nv_bfloat16* yg = y + static_cast<size_t>(g) * b * n;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const bool vec_x = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = n % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const uint4 zero8 = make_uint4(0, 0, 0, 0);

  for (int k0 = 0; k0 < k; k0 += kWK) {
    if (vec_x) {
      for (int e = tid; e < kWM * (kWK / 8); e += kWThreads) {
        const int r = e / (kWK / 8), c = e % (kWK / 8) * 8;
        const int gr = row0 + r, gc = k0 + c;
        *reinterpret_cast<uint4*>(xs + r * kXsLd + c) = (gr < b && gc < k)
            ? *reinterpret_cast<const uint4*>(
                  xg + static_cast<size_t>(gr) * k + gc)
            : zero8;
      }
    } else {
      for (int e = tid; e < kWM * kWK; e += kWThreads) {
        const int r = e / kWK, c = e % kWK;
        const int gr = row0 + r, gc = k0 + c;
        xs[r * kXsLd + c] = (gr < b && gc < k)
            ? xg[static_cast<size_t>(gr) * k + gc] : zero;
      }
    }
    if (vec_w) {
      for (int e = tid; e < kWK * (BN / 8); e += kWThreads) {
        const int r = e / (BN / 8), c = e % (BN / 8) * 8;
        const int gr = k0 + r, gc = col0 + c;
        *reinterpret_cast<uint4*>(ws + r * kWsLd + c) = (gr < k && gc < n)
            ? *reinterpret_cast<const uint4*>(
                  wg + static_cast<size_t>(gr) * n + gc)
            : zero8;
      }
    } else {
      for (int e = tid; e < kWK * BN; e += kWThreads) {
        const int r = e / BN, c = e % BN;
        const int gr = k0 + r, gc = col0 + c;
        ws[r * kWsLd + c] = (gr < k && gc < n)
            ? wg[static_cast<size_t>(gr) * n + gc] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[kFN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * kXsLd + kk,
                               kXsLd);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * kWsLd + wn * (BN / 2)
                                          + j * 16, kWsLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kCsLd
                                  + wn * (BN / 2) + j * 16,
                              acc[i][j], kCsLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kWM * BN; e += kWThreads) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < b && gc < n)
      yg[static_cast<size_t>(gr) * n + gc] = __float2bfloat16(cs[r * kCsLd + c]);
  }
}

// y = the sum of the splits' f32 partials, in split order, as bf16.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     __nv_bfloat16* __restrict__ y,
                                     int splits, size_t count) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int j = 0; j < splits; ++j) acc += part[j * count + i];
  y[i] = __float2bfloat16(acc);
}

template <int BN>
void launch_bf16(const void* xt, const void* wc, const void* ids, void* y,
                 void* part, int g, int b, int k, int n, int splits,
                 int k_split, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (b + kWM - 1) / kWM, g * splits);
  fused_bmm_bf16_kernel<BN><<<grid, kWThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(xt),
      static_cast<const __nv_bfloat16*>(wc), static_cast<const int*>(ids),
      static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(part) : nullptr, g, b, k, n, k_split);
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

// x: (G, B, K), w: (G, K, N), y: (G, B, N); contiguous bf16.
int grouped_bmm_bf16(const void* x, const void* w, void* y, int g, int b,
                     int k, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  if (b > kWM) {
    const dim3 grid((n + 127) / 128, (b + kWM - 1) / kWM, g);
    grouped_bmm_bf16_kernel<128><<<grid, kWThreads, 0, st>>>(xp, wp, yp, b,
                                                            k, n);
  } else {
    const dim3 grid((n + 63) / 64, (b + kWM - 1) / kWM, g);
    grouped_bmm_bf16_kernel<64><<<grid, kWThreads, 0, st>>>(xp, wp, yp, b, k,
                                                           n);
  }
  return static_cast<int>(cudaGetLastError());
}

// xt: (M+1, B), the activations transposed with the zero sink row M;
// wc: (G, K, N); ids: (G, K) int32 in [0, M]; y: (G, B, N). Contiguous,
// bf16 when is_bf16 else float32. bf16 only: split s of `splits` takes
// k-rows [s * k_split, (s + 1) * k_split), with splits * k_split >= K, a
// multiple of 32, and then part is f32 scratch of (splits, G, B, N).
int fused_bmm(const void* xt, const void* wc, const void* ids, void* y,
              void* part, int g, int b, int k, int n, int is_bf16, int splits,
              int k_split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // wide column tiles halve how often a gathered x tile is re-read when
    // there are many rows; narrow ones keep more blocks busy for a few
    if (b > kWM)
      launch_bf16<128>(xt, wc, ids, y, part, g, b, k, n, splits, k_split, st);
    else
      launch_bf16<64>(xt, wc, ids, y, part, g, b, k, n, splits, k_split, st);
    if (splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const size_t count = static_cast<size_t>(g) * b * n;
      reduce_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256,
                             0, st>>>(static_cast<const float*>(part),
                                      static_cast<__nv_bfloat16*>(y), splits,
                                      count);
    }
  } else {
    const dim3 grid((n + kBN - 1) / kBN, (b + kBM - 1) / kBM, g);
    fused_bmm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(xt), static_cast<const float*>(wc),
        static_cast<const int*>(ids), static_cast<float*>(y), b, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
