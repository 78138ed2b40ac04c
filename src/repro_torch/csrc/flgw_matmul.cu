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
// tensor cores with f32 accumulators; f32 runs the FP32-FMA tiling of
// grouped_bmm (no TF32). What bounds it: a decode step (B = 4 rows)
// streams every compact weight once, so it is bound by bytes (one layer's
// 60.8 MB of wc at gemma2-2b's widths and G = 4: 0.018 ms at 3.35 TB/s);
// a prefill (B = 4096 rows) is bound by the tensor cores' operations (one
// layer's 7 projections: 249 GFLOP, 0.25 ms at 989 TFLOP/s). Three bf16
// routes, chosen in the C entry by an explicit shape test:
//
//   fused_bmm_wgmma_kernel (prefill: B > 64, B and capN multiples of 8,
//   16-byte aligned operands, capM up to 8,704, whose ids fit in shared
//   memory). One block of two warpgroups per (256-row x 128-column output
//   tile, g); each warpgroup owns 128 rows and runs two wgmma m64n128k16
//   a k-step with f32 accumulators in registers (128 a thread), both
//   operands from shared memory in the 128-byte swizzle. Both are MN-major
//   there: a k-tile of the gathered x is 64 ids x 256 rows, each id a run
//   of 256 consecutive B-rows of xt (512 contiguous bytes), and wc's tile
//   is 64 k-rows x 128 columns of wc's rows; wgmma reads them with its
//   transpose bits. The tile is 256 rows tall because the operands come
//   from L2 (x is re-read by every column tile, wc by every row tile): a
//   128 x 128 tile moves 32 KB a k-tile for 2.1 MFLOP, more than L2 feeds
//   the tensor cores at their rate; 256 x 128 moves 48 KB for 4.2 MFLOP,
//   and keeps capN's ragged last tile as narrow.
//   Both operands are staged by 16-byte cp.async, x gathered by the
//   k-tile's ids (Hopper's TMA has no gather; wc takes the same cp.async
//   path so one load loop fills a stage) through a ring of 4 stages (48 KB
//   each): k-tile j's wgmmas are issued before k-tile j - 1's are waited
//   for, so the tensor cores do not idle between k-tiles, while the loads
//   of k-tiles j + 1 and j + 2 are in flight. The group's ids sit in
//   shared memory from the start, so no gather waits on an id's load.
//   Rows past B, ids past capM and columns past capN are zero-filled by
//   the copies and masked at the store, so the caller pads nothing. 193 KB
//   of shared memory and 4 capM bytes of ids (204 KB at capM = 2880), one
//   block per SM.
//
//   fused_bmm_stream_kernel (decode: B <= 64, capN a multiple of 8, wc
//   16-byte aligned). A few rows do ~B flops per 2-byte weight, so the
//   tensor cores do not matter; bytes in flight do. FP32 FMA: a block of
//   256 threads covers 64 columns of one group's split of K for up to 8
//   rows (4 when B <= 4); 8 threads share a k-row's 128 bytes of wc (one
//   16-byte streaming load each), 32 k-lanes walk the split, each with 4
//   rows' loads in flight while it multiplies the previous 4 (the first 4
//   while the rows' gathered x values are staged once in shared memory as
//   f32). The k-lanes' sums meet by warp shuffle and shared memory. K is
//   split across blocks until the card holds about two blocks per SM (the
//   wrapper plans it from the SM count), f32 partials summed in split
//   order by reduce_splits_kernel, so the sum has one order whatever the
//   launch.
//
//   fused_bmm_bf16_kernel (any other bf16 shape: B or capN not a multiple
//   of 8, or unaligned operands): the first design, kept for those. wmma
//   16x16x16, 64-row tiles 128 columns wide when there are more than 64
//   rows (64 otherwise), 4 warps, 32 deep per shared-memory pass, no
//   pipelining, split K as the stream kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// bf16 prefill on wgmma (fused_bmm_wgmma_kernel)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kGM = 256;                // rows of x per block, 128 a warpgroup
constexpr int kGN = 128;                // columns of wc per block
constexpr int kGK = 64;                 // k-rows (ids) per stage
constexpr int kGStages = 4;
constexpr int kGThreads = 256;
constexpr int kGXTile = kGK * kGM * 2;  // bytes of a stage's x tile
constexpr int kGWTile = kGK * kGN * 2;  // bytes of a stage's wc tile
constexpr int kGStage = kGXTile + kGWTile;
constexpr int kGSmem = kGStages * kGStage + 1024;  // + atom alignment
// the group's ids follow the stages in shared memory, up to 227 KB
constexpr int kGMaxK = (232448 - kGSmem) / 4;

// A stage's operand tile: 64 k-rows x 256 (x: rows of B) or 128 (wc:
// columns of capN) MN-columns of bf16, MN-major, in wgmma's 128-byte
// swizzle: 8 KB blocks of 64 columns, each 8 atoms of 8 k-rows x 128
// bytes (1,024-aligned), where row r's 16-byte chunk c sits at chunk c ^
// (r % 8) of its line, so the rows a wgmma reads fall in distinct banks.
// The byte offset of (k-row kr, 16-byte chunk ch of the MN-columns):
__device__ __forceinline__ int sw_offset(int kr, int ch) {
  return (ch >> 3) * 8192 + (kr >> 3) * 1024 + (kr & 7) * 128 +
         (((ch & 7) ^ (kr & 7)) << 4);
}

// The wgmma descriptor of an MN-major operand at p in that layout:
// 128-byte swizzle, 1,024 bytes from one 8-row k-group to the next
// (stride byte offset), 8,192 from one 64-column block to the next
// (leading byte offset).
__device__ __forceinline__ uint64_t gmma_desc_mn(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(8192 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                      << 62;
}

// d (64 x 128 over the warpgroup; a warp's 16 rows as 16 n8 C fragments,
// the mma.sync layout) += A . B, both from shared memory, MN-major
// (wgmma's transpose bits set for both).
__device__ __forceinline__ void wgmma_128_tt(float (&d)[16][4], uint64_t da,
                                             uint64_t db) {
#define REPRO_D4(i) \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : REPRO_D4(0), REPRO_D4(1), REPRO_D4(2), REPRO_D4(3), REPRO_D4(4),
        REPRO_D4(5), REPRO_D4(6), REPRO_D4(7), REPRO_D4(8), REPRO_D4(9),
        REPRO_D4(10), REPRO_D4(11), REPRO_D4(12), REPRO_D4(13),
        REPRO_D4(14), REPRO_D4(15)
      : "l"(da), "l"(db), "r"(1));
#undef REPRO_D4
}

// y[g] (B, N) = xt[ids[g]]^T (B, K) . wc[g] (K, N), bf16 out, f32 sums;
// blockIdx = (column tile, row tile, g).
__global__ void __launch_bounds__(kGThreads, 1)
fused_bmm_wgmma_kernel(const bf16* __restrict__ xt,
                       const bf16* __restrict__ w,
                       const int* __restrict__ ids, bf16* __restrict__ y,
                       int b, int k, int n) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  base += (1024 - (smem_addr(base) & 1023)) & 1023;  // atoms 1,024-aligned

  const int col0 = blockIdx.x * kGN;
  const int row0 = blockIdx.y * kGM;
  const int g = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                    // the warpgroup's 128 rows
  const int* idg = ids + static_cast<size_t>(g) * k;
  const bf16* wg_ = w + static_cast<size_t>(g) * k * n;
  const int nk = (k + kGK - 1) / kGK;

  // the group's ids, read once, so no gather waits on an id load
  int* ids_s = reinterpret_cast<int*>(base + kGStages * kGStage);
  for (int e = tid; e < k; e += kGThreads) ids_s[e] = idg[e];
  __syncthreads();

  // k-tile i into stage st, 16-byte chunks of 8 rows of x or 8 columns
  // of wc: a warp copies one id's 512 contiguous bytes of xt, half a warp
  // one k-row's 256 of wc
  auto issue = [&](int i, int st) {
    char* xs = base + st * kGStage;
    char* ws = xs + kGXTile;
#pragma unroll
    for (int j = 0; j < kGXTile / 16 / kGThreads; ++j) {
      const int e = tid + j * kGThreads;
      const int kr = e >> 5, ch = e & 31;
      const int kk = i * kGK + kr;
      const bool in = kk < k && row0 + ch * 8 < b;
      const int id = in ? ids_s[kk] : 0;
      cp_async16(xs + sw_offset(kr, ch),
                 in ? xt + static_cast<size_t>(id) * b + row0 + ch * 8 : xt,
                 in);
    }
#pragma unroll
    for (int j = 0; j < kGWTile / 16 / kGThreads; ++j) {
      const int e = tid + j * kGThreads;
      const int kr = e >> 4, ch = e & 15;
      const int kk = i * kGK + kr;
      const bool in = kk < k && col0 + ch * 8 < n;
      cp_async16(ws + sw_offset(kr, ch),
                 in ? wg_ + static_cast<size_t>(kk) * n + col0 + ch * 8
                    : wg_,
                 in);
    }
  };
#pragma unroll
  for (int i = 0; i < kGStages - 2; ++i) {
    if (i < nk) issue(i, i);
    cp_async_commit();
  }

  float acc[2][16][4];                          // the warpgroup's two m64
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc[h][i][0] = acc[h][i][1] = acc[h][i][2] = acc[h][i][3] = 0.0f;

  // k-tile j's products run while k-tile j - 1's finish and the loads of
  // k-tiles j + 1 .. j + 3 are in flight
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<kGStages - 3>();
    fence_async_proxy();
    // k-tile j has landed; k-tile j - 2's products are done in both
    // warpgroups, so its stage is free
    __syncthreads();
    const char* xs = base + (j % kGStages) * kGStage;
    const char* ws = xs + kGXTile;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
    // step kk: k-rows 16 kk .. + 15, two 8-row k-groups; rows 64 h .. + 63
    // of the warpgroup's 128 are x's 64-column block 2 wg + h
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_128_tt(acc[h],
                     gmma_desc_mn(xs + (2 * wg + h) * 8192 + kk * 2048),
                     gmma_desc_mn(ws + kk * 2048));
    wgmma_commit();
    if (j + kGStages - 2 < nk)
      issue(j + kGStages - 2, (j + kGStages - 2) % kGStages);
    cp_async_commit();
    wgmma_wait<1>();           // k-tile j - 1's products are done
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  cp_async_wait<0>();

  const int gq = lane >> 2, tq = lane & 3;
  bf16* yg = y + static_cast<size_t>(g) * b * n;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row =
          row0 + wg * 128 + h * 64 + (warp & 3) * 16 + gq + rr * 8;
      if (row >= b) continue;
      bf16* yr = yg + static_cast<size_t>(row) * n;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = col0 + i * 8 + 2 * tq;
        if (c < n)
          *reinterpret_cast<__nv_bfloat162*>(yr + c) = __floats2bfloat162_rn(
              acc[h][i][2 * rr], acc[h][i][2 * rr + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// bf16 decode on FP32 FMA (fused_bmm_stream_kernel)
// ---------------------------------------------------------------------------

constexpr int kSCols = 64;              // columns of wc per block, 8 a thread
constexpr int kSLanes = 32;             // k-lanes per block
constexpr int kSUnroll = 4;             // wc rows a k-lane has in flight
constexpr int kSThreads = 256;
constexpr int kSMaxSplit = 512;         // k-rows a block stages

// 8 bf16 (one 16-byte word) as f32
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// blockIdx = (column tile, split, row chunk * G + g): rows [RB rc, +RB)
// of split s's k-rows [s k_split, (s + 1) k_split); with several splits
// the f32 sums go to part (splits, G, B, N) for reduce_splits_kernel.
template <int RB>
__global__ void __launch_bounds__(kSThreads)
fused_bmm_stream_kernel(const bf16* __restrict__ xt,
                        const bf16* __restrict__ w,
                        const int* __restrict__ ids, bf16* __restrict__ y,
                        float* __restrict__ part, int ng, int b, int k,
                        int n, int k_split) {
  extern __shared__ float smf[];
  const int col0 = blockIdx.x * kSCols;
  const int split = blockIdx.y;
  const int g = blockIdx.z % ng;
  const int r0 = blockIdx.z / ng * RB;
  const int k_beg = split * k_split;
  const int kn = min(k, k_beg + k_split) - k_beg;
  float* xs = smf;                      // kn x RB: the rows' x values
  float* red = xs + kn * RB;            // 8 warps x RB x kSCols
  const int tid = threadIdx.x;
  const int cl = tid & 7, kl = tid >> 3;
  const int* idg = ids + static_cast<size_t>(g) * k + k_beg;
  const bf16* wg_ = w + (static_cast<size_t>(g) * k + k_beg) * n;

  // a k-lane's next kSUnroll rows of wc (16 bytes each), in flight while
  // the previous ones are multiplied; the first while x is staged
  const int col = col0 + cl * 8;
  const bool cin = col < n;
  uint4 wv[kSUnroll];
  auto load = [&](int kk) {
#pragma unroll
    for (int u = 0; u < kSUnroll; ++u) {
      const int kr = kk + u * kSLanes;
      wv[u] = cin && kr < kn
          ? __ldcs(reinterpret_cast<const uint4*>(
                wg_ + static_cast<size_t>(kr) * n + col))
          : make_uint4(0, 0, 0, 0);
    }
  };
  load(kl);

  for (int e = tid; e < kn * RB; e += kSThreads) {
    const int kk = e / RB, r = e % RB;
    xs[e] = r0 + r < b
        ? __bfloat162float(xt[static_cast<size_t>(idg[kk]) * b + r0 + r])
        : 0.0f;
  }
  __syncthreads();

  float acc[RB][8];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  constexpr int kStep = kSLanes * kSUnroll;
  for (int kk = kl; kk < kn; kk += kStep) {
    uint4 cur[kSUnroll];
#pragma unroll
    for (int u = 0; u < kSUnroll; ++u) cur[u] = wv[u];
    if (kk + kStep < kn) load(kk + kStep);
#pragma unroll
    for (int u = 0; u < kSUnroll; ++u) {
      const int kr = kk + u * kSLanes;
      if (kr >= kn) break;
      float wf[8];
      unpack8(cur[u], wf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float xv = xs[kr * RB + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
      }
    }
  }

  // the 4 k-lanes of a warp (lanes 8 apart), then the 8 warps
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 8);
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
    }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        red[(warp * RB + r) * kSCols + lane * 8 + c] = acc[r][c];
  }
  __syncthreads();
  float* pg = part == nullptr ? nullptr
      : part + (static_cast<size_t>(split) * ng + g) * b * n;
  bf16* yg = y + static_cast<size_t>(g) * b * n;
  for (int e = tid; e < RB * kSCols; e += kSThreads) {
    const int r = e / kSCols, c = e % kSCols;
    const int row = r0 + r, cc = col0 + c;
    if (row >= b || cc >= n) continue;
    float sum = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kSThreads / 32; ++wi)
      sum += red[(wi * RB + r) * kSCols + c];
    const size_t at = static_cast<size_t>(row) * n + cc;
    if (pg != nullptr)
      pg[at] = sum;
    else
      yg[at] = __float2bfloat16(sum);
  }
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

int launch_wgmma(const void* xt, const void* wc, const void* ids, void* y,
                 int g, int b, int k, int n, cudaStream_t stream) {
  const int smem = kGSmem + 4 * k;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_bmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kGN - 1) / kGN, (b + kGM - 1) / kGM, g);
  fused_bmm_wgmma_kernel<<<grid, kGThreads, smem, stream>>>(
      static_cast<const bf16*>(xt), static_cast<const bf16*>(wc),
      static_cast<const int*>(ids), static_cast<bf16*>(y), b, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <int RB>
void launch_stream(const void* xt, const void* wc, const void* ids, void* y,
                   void* part, int g, int b, int k, int n, int splits,
                   int k_split, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(k < k_split ? k : k_split) * RB +
                       (kSThreads / 32) * RB * kSCols);
  const dim3 grid((n + kSCols - 1) / kSCols, splits, g * ((b + RB - 1) / RB));
  fused_bmm_stream_kernel<RB><<<grid, kSThreads, smem, stream>>>(
      static_cast<const bf16*>(xt), static_cast<const bf16*>(wc),
      static_cast<const int*>(ids), static_cast<bf16*>(y),
      splits > 1 ? static_cast<float*>(part) : nullptr, g, b, k, n, k_split);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
// multiple of 32 and at most 512 when B <= 64, and then part is f32
// scratch of (splits, G, B, N); B > 64 takes no split. bf16 routes: B >
// 64 with B and N multiples of 8, 16-byte aligned xt and wc and K at most
// 8,704 on wgmma; B <= 64 with N a multiple of 8 and wc 16-byte aligned
// on the streaming FP32 FMA kernel; anything else on wmma.
int fused_bmm(const void* xt, const void* wc, const void* ids, void* y,
              void* part, int g, int b, int k, int n, int is_bf16, int splits,
              int k_split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (splits < 1 || (splits > 1 && (k_split % kWK || k_split > kSMaxSplit)))
      return static_cast<int>(cudaErrorInvalidValue);
    const bool wide = n % 8 == 0 && aligned16(wc);
    if (b > kWM && wide && b % 8 == 0 && aligned16(xt) && k <= kGMaxK) {
      if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch_wgmma(xt, wc, ids, y, g, b, k, n, st);
    }
    if (b <= kWM && wide && (splits > 1 || k <= kSMaxSplit)) {
      if (b <= 4)
        launch_stream<4>(xt, wc, ids, y, part, g, b, k, n, splits, k_split,
                         st);
      else
        launch_stream<8>(xt, wc, ids, y, part, g, b, k, n, splits, k_split,
                         st);
    } else if (b > kWM) {
      // wide column tiles halve how often a gathered x tile is re-read
      // when there are many rows; narrow ones keep more blocks busy for a
      // few
      launch_bf16<128>(xt, wc, ids, y, part, g, b, k, n, splits, k_split, st);
    } else {
      launch_bf16<64>(xt, wc, ids, y, part, g, b, k, n, splits, k_split, st);
    }
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
