// Compact FLGW matmuls for Hopper, sm_90a: the grouped (block-diagonal)
// batched product and its fused-gather variant.
//
// grouped_bmm_f32 and grouped_bmm_bf16 replace the Pallas TPU kernel
// _bmm_kernel (grouped_bmm) of src/repro/kernels/flgw_matmul/flgw_matmul.py:
//   y[g] = x[g] @ w[g],  x (G, B, K), w (G, K, N) -> y (G, B, N) in x's
//   type, f32 accumulation.
//
// grouped_bmm_f32: plain FP32 FMA on the CUDA cores, each output summed
// over k in ascending order in one float32 register, never TF32: the MARL
// path runs this product in f32 and must agree with the f32 reference to
// ~1e-6. What bounds it: at the MARL path's shapes (B = 128 rows, K 10-40,
// N 3-160, G = 4) one call moves at most ~0.5 MB and does at most ~6.6
// MFLOP, ~0.15 us of HBM time or ~0.1 us of f32 ALU time, so latency
// bounds it: the launch, then one round of loads, then K dependent FMAs.
// The design cuts the rounds: blocks of 32 rows x 32 columns (64 when 32
// would not fit the card in one wave; the wrapper picks), 256 threads,
// the whole of K <= 64 fetched in one cp.async stage (larger K through a
// 2-stage ring of 64-deep k-tiles), 16-byte copies where the widths allow.
// Ragged B, K and N are masked here, so the caller pads nothing.
//
// grouped_bmm_bf16: the LM training path's product (bf16 models' plans
// carry no compact weights, so every FLGW projection gathers its operands
// and lands here). At gemma2-2b's training shapes (B = 4096 rows, K x N =
// 720 x 2880 up/gate, 2880 x 720 down, G = 4) one call is ~68 GFLOP
// against ~134 MB, so the tensor cores' operations bound it. bf16
// operands, f32 accumulators, the output rounded once to bf16, as the TPU
// kernel's bf16 x bf16 -> f32 dot. Two routes, which the wrapper chooses
// by an explicit shape test and passes in (the C entry refuses a route
// the shapes do not allow):
//
//   grouped_bmm_tma_kernel (B > 64, K and N multiples of 8, x, w and y
//   16-byte aligned: TMA's 16-byte strides). The operands are dense, so
//   TMA loads them: a producer lane keeps a ring of 4 stages full (x's
//   128 rows x 64 k, K-major; w's 64 k x 256 columns as four 64-column
//   boxes, MN-major; both in the 128-byte swizzle wgmma reads), with a
//   full and an empty mbarrier per stage, and gives its registers to the
//   two consumer warpgroups (setmaxnreg), each of which owns 64 rows x
//   256 columns on wgmma m64n256k16 (128 f32 accumulators a thread),
//   k-tile j's products issued before k-tile j - 1's are waited for. The
//   tile is 128 x 256, not 256 x 128: with m64n256 each warpgroup reads
//   a k-tile's w once a k-step (80 KB of shared-memory reads a k-tile for
//   both, against 96 KB for two m64n128 each), and N = 2880 and 720 waste
//   as much on the last column tile (6.7 %) as 128-wide tiles would on
//   720. L2 feeds the operands: 48 KB a k-tile for 4.2 MFLOP on every
//   SM asks ~7 TB/s of L2 reads at 60 % of the tensor cores' rate, about
//   what L2 gives, and the first version of this kernel (one CTA a tile)
//   stalled there on the card. So CTAs pair up in clusters of 2 that take
//   two row tiles of one column tile, each loading half of w's boxes by
//   TMA multicast to both (32 KB a k-tile a CTA). Persistent clusters,
//   one CTA per SM, walk the pairs, so the producer loads the next tile
//   while the consumers store this one; the consumers store 16-byte words
//   after a 4 x 4 transpose within each quad of lanes. TMA zero-fills
//   past each group's rows and columns; the epilogue masks rows past B
//   and columns past N.
//
//   grouped_bmm_bf16_kernel (any other shape: B <= 64, ragged widths,
//   unaligned views): the first design, kept for those. wmma 16x16x16,
//   64-row tiles 128 columns wide when there are more than 64 rows (64
//   otherwise), 4 warps, 32 deep per shared-memory pass, 16-byte loads
//   where the widths are multiples of 8 and the base is 16-byte aligned.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// fused_bmm_f32_kernel's tiling: 64 x 64 outputs a block, a 4 x 4 patch a
// thread, x and w staged 16 deep along K.
constexpr int kBM = 64;   // rows of x per block
constexpr int kBN = 64;   // columns of w per block
constexpr int kBK = 16;   // depth staged per shared-memory pass
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

// grouped_bmm_f32: a block owns 32 rows x BN (32 or 64) columns of one
// group; warp w its rows 4 w .. 4 w + 3, lane l its columns l BN/32 ..
// (l + 1) BN/32 - 1, so a warp's x reads are broadcasts and its w reads
// consecutive. K comes in 64-deep k-tiles by cp.async, the whole of K in
// one when K <= 64, else through a ring of 2 (one loading while the other
// is multiplied); 16-byte copies where the widths are multiples of 4 and
// the operand 16-byte aligned, 4-byte copies otherwise, zeros past the
// edges.
constexpr int kFM = 32;                 // rows per block
constexpr int kFK = 64;                 // k-rows per k-tile
constexpr int kFThreads = 256;

template <int BN>
__global__ void __launch_bounds__(kFThreads)
grouped_bmm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ y,
                       int b, int k, int n) {
  constexpr int kCN = BN / 32;          // columns a lane owns
  constexpr int kRM = kFM / (kFThreads / 32);  // rows a warp owns: 4
  __shared__ __align__(16) float xs[2][kFM * kFK];
  __shared__ __align__(16) float ws[2][kFK * BN];

  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kFM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * kRM, c0 = (tid & 31) * kCN;
  const float* xg = x + static_cast<size_t>(g) * b * k;
  const float* wg = w + static_cast<size_t>(g) * k * n;
  const bool vec_x = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int nk = (k + kFK - 1) / kFK;

  // k-tile j's kn valid k-rows into stage st; rows past B and columns
  // past N as zeros (the compute reads no k past kn)
  auto load = [&](int j, int st) {
    const int k0 = j * kFK, kn = min(kFK, k - k0);
    if (vec_x) {
      const int kv = (kn + 3) / 4;
      for (int e = tid; e < kFM * kv; e += kFThreads) {
        const int r = e / kv, c = e % kv * 4;
        const bool in = row0 + r < b;
        cp_async16(&xs[st][r * kFK + c],
                   in ? xg + static_cast<size_t>(row0 + r) * k + k0 + c : xg,
                   in);
      }
    } else {
      for (int e = tid; e < kFM * kn; e += kFThreads) {
        const int r = e / kn, c = e % kn;
        const bool in = row0 + r < b;
        cp_async4(&xs[st][r * kFK + c],
                  in ? xg + static_cast<size_t>(row0 + r) * k + k0 + c : xg,
                  in);
      }
    }
    if (vec_w) {
      for (int e = tid; e < kn * (BN / 4); e += kFThreads) {
        const int r = e / (BN / 4), c = e % (BN / 4) * 4;
        const bool in = col0 + c < n;
        cp_async16(&ws[st][r * BN + c],
                   in ? wg + static_cast<size_t>(k0 + r) * n + col0 + c : wg,
                   in);
      }
    } else {
      for (int e = tid; e < kn * BN; e += kFThreads) {
        const int r = e / BN, c = e % BN;
        const bool in = col0 + c < n;
        cp_async4(&ws[st][e],
                  in ? wg + static_cast<size_t>(k0 + r) * n + col0 + c : wg,
                  in);
      }
    }
    cp_async_commit();
  };

  float acc[kRM][kCN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCN; ++j) acc[i][j] = 0.0f;

  if (nk > 0) load(0, 0);
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      load(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xa = xs[j & 1];
    const float* wa = ws[j & 1] + c0;
    const int kn = min(kFK, k - j * kFK);
    // each output sums over k in ascending order, in one register
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float a[kRM], bv[kCN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) a[i] = xa[(r0 + i) * kFK + kk];
#pragma unroll
      for (int c = 0; c < kCN; ++c) bv[c] = wa[kk * BN + c];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int c = 0; c < kCN; ++c) acc[i][c] = fmaf(a[i], bv[c], acc[i][c]);
    }
    __syncthreads();         // the stage is free for k-tile j + 2
  }

  float* yg = y + static_cast<size_t>(g) * b * n;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int gr = row0 + r0 + i;
    if (gr >= b) continue;
#pragma unroll
    for (int c = 0; c < kCN; ++c) {
      const int gc = col0 + c0 + c;
      if (gc < n) yg[static_cast<size_t>(gr) * n + gc] = acc[i][c];
    }
  }
}

// xt (M+1, B) gathered by ids, f32 FMA.
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
// bf16 grouped product on TMA + wgmma (grouped_bmm_tma_kernel)
// ---------------------------------------------------------------------------

constexpr int kAM = 128;                // rows of x per output tile
constexpr int kAN = 256;                // columns of w per output tile
constexpr int kAK = 64;                 // k-rows per stage (128 bytes of x)
constexpr int kAStages = 4;
constexpr int kAThreads = 384;          // 2 consumer warpgroups + producer
constexpr int kAXTile = kAM * kAK * 2;  // bytes of a stage's x tile: 16 KB
constexpr int kAWBox = kAK * 64 * 2;    // bytes of one 64-column w box: 8 KB
constexpr int kAStage = kAXTile + (kAN / 64) * kAWBox;   // 48 KB
constexpr int kASmem = kAStages * kAStage + 2 * kAStages * 8 + 1024;

// The wgmma descriptor of a K-major operand at p in the 128-byte swizzle
// (TMA's SWIZZLE_128B with a 64-element inner box): 1,024 bytes from one
// 8-row group to the next; the leading offset is not used when a 16-deep
// step stays inside one 128-byte line.
__device__ __forceinline__ uint64_t gmma_desc_k(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                      << 62;
}

// d (64 x 256 over the warpgroup; a warp's 16 rows as 32 n8 C fragments,
// the mma.sync layout) += A . B, A K-major and B MN-major (wgmma's
// transpose bit set for B only), both from shared memory.
__device__ __forceinline__ void wgmma_256_nt(float (&d)[32][4], uint64_t da,
                                             uint64_t db) {
#define REPRO_D4(i) \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : REPRO_D4(0), REPRO_D4(1), REPRO_D4(2), REPRO_D4(3), REPRO_D4(4), REPRO_D4(5),
        REPRO_D4(6), REPRO_D4(7), REPRO_D4(8), REPRO_D4(9), REPRO_D4(10), REPRO_D4(11),
        REPRO_D4(12), REPRO_D4(13), REPRO_D4(14), REPRO_D4(15), REPRO_D4(16), REPRO_D4(17),
        REPRO_D4(18), REPRO_D4(19), REPRO_D4(20), REPRO_D4(21), REPRO_D4(22), REPRO_D4(23),
        REPRO_D4(24), REPRO_D4(25), REPRO_D4(26), REPRO_D4(27), REPRO_D4(28), REPRO_D4(29),
        REPRO_D4(30), REPRO_D4(31)
      : "l"(da), "l"(db), "r"(1));
#undef REPRO_D4
}

// y[g] (B, N) = x[g] (B, K) . w[g] (K, N), bf16 out, f32 sums. Clusters
// of 2 CTAs on neighbouring SMs take the two row tiles 2 p and 2 p + 1 of
// one pair p (in (g, row pair, column tile) order, so the pairs in flight
// share x's rows and w[g] in L2), persistently: cluster i takes pairs i,
// i + clusters, ... Each CTA loads its own x tile and half of w's boxes,
// multicast to both, so a k-tile moves 32 KB out of L2 a CTA, not 48.
// Warps 0-7 are two consumer warpgroups, each owning 64 of the tile's 128
// rows with 128 f32 accumulators a thread; warp 8's first lane is the
// producer, which keeps the ring of kAStages stages full while the
// consumers multiply, and runs ahead into the next pair while they store
// this one. A stage is refilled once the consumers of both CTAs have
// released it: each consumer warp arrives on its own CTA's empty barrier
// and on the other's.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kAThreads, 1)
grouped_bmm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       bf16* __restrict__ y, int ng, int b, int k, int n) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  base += (1024 - (smem_addr(base) & 1023)) & 1023;  // swizzle atoms aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kAStages * kAStage);
  uint64_t* empty = full + kAStages;

  const uint32_t rank = cluster_ctarank();      // the pair's row tile
  const int ct = (n + kAN - 1) / kAN;
  const int per_g = (b + 2 * kAM - 1) / (2 * kAM) * ct;
  const int pairs = per_g * ng;
  const int cluster = blockIdx.x >> 1, clusters = gridDim.x >> 1;
  const int nk = (k + kAK - 1) / kAK;
  // this cluster's k-tile loads; the last kAStages are never followed by
  // a refill of their stage, so they are not released (no arrive can then
  // reach the other CTA after it has finished)
  const int loads =
      (pairs > cluster ? (pairs - cluster + clusters - 1) / clusters : 0) *
      nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], 16);                 // both CTAs' consumer warps
    }
    mbar_fence_init();
  }
  cluster_sync();              // both CTAs' barriers exist before any use

  if (warp >= 8) {
    setmaxnreg_dec<40>();
    if (warp != 8 || lane != 0) return;
    int st = 0;
    uint32_t ph = 0;
    for (int p = cluster; p < pairs; p += clusters) {
      const int g = p / per_g, rem = p % per_g;
      const int row0 = (rem / ct * 2 + static_cast<int>(rank)) * kAM;
      const int col0 = rem % ct * kAN;
      // w's 64-column boxes wholly past N are not loaded: their columns
      // only reach outputs the epilogue masks
      const int boxes = min(kAN / 64, (n - col0 + 63) / 64);
      const uint32_t bytes = kAXTile + boxes * kAWBox;
      for (int j = 0; j < nk; ++j) {
        mbar_wait(&empty[st], ph ^ 1);          // a fresh ring passes
        mbar_expect_tx(&full[st], bytes);
        char* xs = base + st * kAStage;
        // x's rows past B (all of them in a pair's second tile when the
        // row tiles are odd) arrive as zeros
        tma_load_3d(xs, &xmap, &full[st], j * kAK, row0, g);
        for (int c = static_cast<int>(rank); c < boxes; c += 2)
          tma_load_3d_multicast(xs + kAXTile + c * kAWBox, &wmap, &full[st],
                                col0 + c * 64, j * kAK, g, 0x3);
        if (++st == kAStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp >> 2;                     // the warpgroup's 64 rows
  const int gq = lane >> 2, tq = lane & 3;
  int st = 0, q = 0;                            // q: this k-tile's load
  uint32_t ph = 0;
  // k-tile q's stage goes back to both producers once its products are
  // done in this warp
  auto release = [&](int stage, int load) {
    if (lane == 0 && load + kAStages < loads) {
      mbar_arrive(&empty[stage]);
      mbar_arrive_cluster(&empty[stage], rank ^ 1);
    }
  };
  for (int p = cluster; p < pairs; p += clusters) {
    const int g = p / per_g, rem = p % per_g;
    const int row0 = (rem / ct * 2 + static_cast<int>(rank)) * kAM;
    const int col0 = rem % ct * kAN;
    float acc[32][4];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    int prev = 0;
    // k-tile j's products run while k-tile j - 1's finish
    for (int j = 0; j < nk; ++j, ++q) {
      mbar_wait(&full[st], ph);
      const char* xs = base + st * kAStage;
      const char* ws = xs + kAXTile;
      fence_regs(acc);
      wgmma_fence();
      // step kk: k-rows 16 kk .. + 15, 32 bytes along x's 128-byte rows
      // and two 8-row k-groups (2 KB) down w's boxes
#pragma unroll
      for (int kk = 0; kk < kAK / 16; ++kk)
        wgmma_256_nt(acc, gmma_desc_k(xs + wg * 8192 + kk * 32),
                     gmma_desc_mn(ws + kk * 2048));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (j > 0) release(prev, q - 1);
      prev = st;
      if (++st == kAStages) {
        st = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) release(prev, q - 1);

    // A quad's 4 threads hold columns 2 tq, 2 tq + 1 of each n8 block; a
    // 4 x 4 transpose in the quad gives thread tq the 8 columns of block
    // 4 m + tq, stored as one 16-byte word (a quarter of the stores of
    // 4-byte pairs). Every lane shuffles; the stores are masked.
    bf16* yg = y + static_cast<size_t>(g) * b * n;
    const unsigned quad = lane & ~3u;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + wg * 64 + (warp & 3) * 16 + gq + rr * 8;
      bf16* yr = yg + static_cast<size_t>(row) * n;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        uint32_t v[4], u[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(
              acc[4 * m + i][2 * rr], acc[4 * m + i][2 * rr + 1]);
          v[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
        // round r: thread s sends its pair of block (s - r) & 3, thread t
        // receives thread (t + r) & 3's pair of block t
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int si = (tq - r) & 3, di = (tq + r) & 3;
          const uint32_t send = si == 0 ? v[0] : si == 1 ? v[1]
                                : si == 2 ? v[2] : v[3];
          const uint32_t got = __shfl_sync(0xffffffffu, send, quad | di);
#pragma unroll
          for (int i = 0; i < 4; ++i) u[i] = di == i ? got : u[i];
        }
        const int c = col0 + (4 * m + tq) * 8;
        if (row < b && c < n)
          *reinterpret_cast<uint4*>(yr + c) = make_uint4(u[0], u[1], u[2],
                                                         u[3]);
      }
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

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point so that the library needs no -lcuda; null if the driver lacks it.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a contiguous bf16 (G, rows, cols) tensor in boxes of
// box_rows x 64 columns (128 bytes) with the 128-byte swizzle; the group
// is the outer dimension, so a box past a group's last row or column
// reads zeros, never the next group. Needs cols % 8 == 0 (16-byte row
// strides) and a 16-byte aligned base.
cudaError_t encode_bf16_map(CUtensorMap* map, const void* p, int g,
                            int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(g)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int launch_tma(const void* x, const void* w, void* y, int g, int b, int k,
               int n, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  cudaError_t err = encode_bf16_map(&xmap, x, g, b, k, kAM);
  if (err == cudaSuccess) err = encode_bf16_map(&wmap, w, g, k, n, kAK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_bmm_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kASmem);
  // as many clusters as the card holds at once (one CTA an SM)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(kAThreads, 1, 1);
  cfg.dynamicSmemBytes = kASmem;
  cfg.stream = stream;
  int resident = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&resident, grouped_bmm_tma_kernel,
                                         &cfg);
  if (err == cudaSuccess && resident < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = g * ((b + 2 * kAM - 1) / (2 * kAM)) * ((n + kAN - 1) / kAN);
  const int clusters = pairs < resident ? pairs : resident;
  grouped_bmm_tma_kernel<<<2 * clusters, kAThreads, kASmem, stream>>>(
      xmap, wmap, static_cast<bf16*>(y), g, b, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
void launch_f32(const void* x, const void* w, void* y, int g, int b, int k,
                int n, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (b + kFM - 1) / kFM, g);
  grouped_bmm_f32_kernel<BN><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), b, k, n);
}

}  // namespace

extern "C" {

// x: (G, B, K), w: (G, K, N), y: (G, B, N); contiguous float32. cols,
// the output tile's columns, is 32 or 64 (ops.bmm_f32_cols); anything
// else is refused.
int grouped_bmm_f32(const void* x, const void* w, void* y, int g, int b,
                    int k, int n, int cols, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols == 32)
    launch_f32<32>(x, w, y, g, b, k, n, st);
  else if (cols == 64)
    launch_f32<64>(x, w, y, g, b, k, n, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x: (G, B, K), w: (G, K, N), y: (G, B, N); contiguous bf16. route
// (ops.bmm_bf16_route): 1, TMA + wgmma, only for B > 64, K > 0, K and N
// multiples of 8 and 16-byte aligned x, w and y, else refused; 0, wmma,
// for any shape.
int grouped_bmm_bf16(const void* x, const void* w, void* y, int g, int b,
                     int k, int n, int route, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (b <= kWM || k <= 0 || k % 8 || n % 8 || !aligned16(x) ||
        !aligned16(w) || !aligned16(y))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tma(x, w, y, g, b, k, n, st);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
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
