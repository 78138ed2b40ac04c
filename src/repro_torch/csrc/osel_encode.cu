// OSEL mask encode (the comparator array) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel _encode_kernel of
// src/repro/kernels/osel_encode/osel_encode.py (encode_mask):
//   mask[i, j] = (ig_idx[i] == og_idx[j])   (M, N) uint8
// from the (M,) and (N,) int32 grouping-index vectors, bitwise equal to it.
//
// What bounds it on this card: the work is an outer equality, one compare
// per output byte, so it writes M*N bytes and reads 4(M+N): the memory
// rate bounds it (2304 x 9216 is 21.2 MB out, ~6.3 us at 3.35 TB/s).
// The design keeps every store wide and coalesced and reads each og index
// from device memory about once per R rows:
//   * one work item = 16 consecutive columns of R = 4 consecutive rows;
//     the thread loads its 16 og values once (four 16-byte loads), keeps
//     them in registers and, for each of its rows, compares them with
//     that row's ig value (a broadcast load: the neighbouring threads
//     share the row) and writes the 16 mask bytes with one 16-byte store;
//   * neighbouring threads take neighbouring 16-column chunks of the same
//     rows, so a warp writes 512 contiguous bytes of a row at once;
//   * items are numbered flat over (row group, column chunk) and walked
//     by a grid-stride loop on blockIdx.x, so no M or N is limited by the
//     65,535 blocks of gridDim.y/z;
//   * the ragged edge is masked here, not padded: a chunk that runs past
//     N, or a row whose start is not 16-byte aligned (N not a multiple of
//     16), takes byte stores of the valid columns only. The TPU version's
//     -1 / -2 padding exists only because its tiles are fixed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;     // columns (mask bytes) per work item
constexpr int kRows = 4;       // rows per work item
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void osel_encode_kernel(const int* __restrict__ ig,
                                   const int* __restrict__ og,
                                   uint8_t* __restrict__ mask, int m, int n,
                                   bool wide) {
  const size_t n_chunks = (static_cast<size_t>(n) + kChunk - 1) / kChunk;
  const size_t n_rgroups = (static_cast<size_t>(m) + kRows - 1) / kRows;
  const size_t items = n_chunks * n_rgroups;
  const bool og_aligned = (reinterpret_cast<uintptr_t>(og) & 15) == 0;
  for (size_t w = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < items; w += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>(w % n_chunks) * kChunk;
    const int r0 = static_cast<int>(w / n_chunks) * kRows;
    const bool full = c0 + kChunk <= n;
    int o[kChunk];
    if (full && og_aligned) {
      const int4* src = reinterpret_cast<const int4*>(og + c0);
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const int4 v = __ldg(src + q);
        o[4 * q] = v.x;
        o[4 * q + 1] = v.y;
        o[4 * q + 2] = v.z;
        o[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        o[k] = c0 + k < n ? __ldg(og + c0 + k) : 0;  // never stored
    }
    const int r1 = min(r0 + kRows, m);
    for (int r = r0; r < r1; ++r) {
      const int v = __ldg(ig + r);
      uint8_t* dst = mask + static_cast<size_t>(r) * n + c0;
      if (full && wide) {
        uint32_t word[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t x = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            x |= static_cast<uint32_t>(o[4 * q + b] == v) << (8 * b);
          word[q] = x;
        }
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(word[0], word[1], word[2], word[3]);
      } else {
        const int valid = min(kChunk, n - c0);
        for (int k = 0; k < valid; ++k)
          dst[k] = static_cast<uint8_t>(o[k] == v);
      }
    }
  }
}

}  // namespace

extern "C" {

// ig: (M,) int32; og: (N,) int32; mask: (M, N) uint8, row-major. M, N > 0.
int osel_encode(const void* ig, const void* og, void* mask, int m, int n,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t items = ((static_cast<size_t>(n) + kChunk - 1) / kChunk) *
                       ((static_cast<size_t>(m) + kRows - 1) / kRows);
  const size_t want = (items + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
  // 16-byte stores need every row start aligned: N a multiple of 16 and
  // the mask's base on a 16-byte boundary.
  const bool wide =
      n % kChunk == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  osel_encode_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const int*>(ig), static_cast<const int*>(og),
      static_cast<uint8_t*>(mask), m, n, wide);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
