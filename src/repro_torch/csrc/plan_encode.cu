// Plan encode (capacity-balanced group assignment) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/plan_encode/plan_encode.py:
//   plan_rank  <- _rank_kernel  (comparator-rank pass)
//   plan_place <- _place_kernel (cross-tile placement pass)
// and returns slot ids bitwise equal to them, padding items included.
//
// Inputs per layer l: pref[l, i] (argmax group, int32; padding items
// carry pref == G) and strength[l, i] (float32; padding carries -inf),
// both (L, Mp) with Mp a multiple of the tile side bi.
//
// What bounds it on this card: at the FLGW layer shapes of the MARL path
// (Mp <= 512, L = 1) the whole pass is a few KB and ~0.3 M comparisons,
// far under a microsecond of memory or ALU time, so the launch itself
// (a few microseconds) is the bound. The design keeps each pass to one
// launch and no host work: the TPU's sequential j grid axis and its VMEM
// accumulator become a loop inside the block over j-tiles staged in
// shared memory (blocks carry no state from one to the next on a GPU),
// every thread counts for one item in a register, and the per-tile group
// histogram is built with integer shared-memory atomics (order-free, so
// deterministic). Shared-memory reads in the inner loop are broadcasts
// (all threads read the same j), so they are conflict-free.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileJ = 1024;  // j items staged in shared memory per pass

// grid (n_it, L), block bi threads: thread t counts for item it*bi + t.
__global__ void rank_kernel(const int* __restrict__ pref,
                            const float* __restrict__ strength,
                            int* __restrict__ rank, int* __restrict__ hist,
                            int mp, int g) {
  __shared__ int pref_s[kTileJ];
  __shared__ float str_s[kTileJ];
  extern __shared__ int hist_s[];  // (g,) group histogram of this i-tile

  const int l = blockIdx.y;
  const int it = blockIdx.x;
  const int bi = blockDim.x;
  const int tid = threadIdx.x;
  const int i = it * bi + tid;
  const int* pl = pref + static_cast<size_t>(l) * mp;
  const float* sl = strength + static_cast<size_t>(l) * mp;
  const int pi = pl[i];
  const float si = sl[i];

  for (int k = tid; k < g; k += bi) hist_s[k] = 0;

  int acc = 0;
  for (int j0 = 0; j0 < mp; j0 += kTileJ) {
    const int jn = min(kTileJ, mp - j0);
    __syncthreads();  // previous tile consumed (and hist_s zeroed)
    for (int t = tid; t < jn; t += bi) {
      pref_s[t] = pl[j0 + t];
      str_s[t] = sl[j0 + t];
    }
    __syncthreads();
    for (int t = 0; t < jn; ++t) {
      const float sj = str_s[t];
      const int j = j0 + t;
      acc += (pref_s[t] == pi) & ((sj > si) | ((sj == si) & (j < i)));
    }
  }
  rank[static_cast<size_t>(l) * mp + i] = acc;

  // Padding items carry the sentinel group g and drop out of the count.
  if (pi >= 0 && pi < g) atomicAdd(&hist_s[pi], 1);
  __syncthreads();
  const int n_it = gridDim.x;
  int* hl = hist + (static_cast<size_t>(l) * n_it + it) * g;
  for (int k = tid; k < g; k += bi) hl[k] = hist_s[k];
}

// grid (n_it, L), block bi threads: thread t places item it*bi + t.
// The arithmetic follows _place_kernel term by term, including its sums
// over the one-hot group matches, so padding items get the same values.
__global__ void place_kernel(const int* __restrict__ pref,
                             const int* __restrict__ rank,
                             const int* __restrict__ hist,
                             int* __restrict__ slot, int mp, int g, int cap) {
  extern __shared__ int sh[];
  int* kcount = sh;            // (g,) kept count of each group
  int* ovf_before = sh + g;    // (g,) exclusive prefix of overflow counts
  int* free_before = sh + 2 * g;  // (g,) exclusive prefix of free slots
  int* counts = sh + 3 * g;    // (g,) total preference count

  const int l = blockIdx.y;
  const int it = blockIdx.x;
  const int bi = blockDim.x;
  const int tid = threadIdx.x;
  const int n_it = gridDim.x;
  const int* hl = hist + static_cast<size_t>(l) * n_it * g;

  for (int k = tid; k < g; k += bi) {
    int c = 0;
    for (int t = 0; t < n_it; ++t) c += hl[static_cast<size_t>(t) * g + k];
    counts[k] = c;
    kcount[k] = min(c, cap);
  }
  __syncthreads();
  for (int k = tid; k < g; k += bi) {
    int o = 0, f = 0;
    for (int h = 0; h < k; ++h) {
      o += counts[h] - kcount[h];
      f += cap - kcount[h];
    }
    ovf_before[k] = o;
    free_before[k] = f;
  }
  __syncthreads();

  const size_t idx = static_cast<size_t>(l) * mp + it * bi + tid;
  const int p = pref[idx];
  const int r = rank[idx];
  const bool in_range = p >= 0 && p < g;  // the one-hot gather is 0 otherwise
  int out;
  if (r < cap) {
    out = p * cap + min(r, cap - 1);
  } else {
    const int q = (in_range ? ovf_before[p] : 0) + r - cap;
    int gsel = 0, kc = 0, lo = 0;
    for (int k = 0; k < g; ++k) {
      const int lo_k = free_before[k];
      if (q >= lo_k && q < lo_k + (cap - kcount[k])) {
        gsel += k;
        kc += kcount[k];
        lo += lo_k;
      }
    }
    out = gsel * cap + kc + (q - lo);
  }
  slot[idx] = out;
}

}  // namespace

extern "C" {

// pref, strength: (L, Mp); rank: (L, Mp); hist: (L, Mp/bi, G). int32/f32.
int plan_rank(const void* pref, const void* strength, void* rank, void* hist,
              int l, int mp, int g, int bi, void* stream) {
  const dim3 grid(mp / bi, l);
  rank_kernel<<<grid, bi, g * sizeof(int),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pref), static_cast<const float*>(strength),
      static_cast<int*>(rank), static_cast<int*>(hist), mp, g);
  return static_cast<int>(cudaGetLastError());
}

// pref, rank: (L, Mp); hist: (L, Mp/bi, G); slot: (L, Mp). int32.
int plan_place(const void* pref, const void* rank, const void* hist,
               void* slot, int l, int mp, int g, int cap, int bi,
               void* stream) {
  const dim3 grid(mp / bi, l);
  place_kernel<<<grid, bi, 4 * g * sizeof(int),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pref), static_cast<const int*>(rank),
      static_cast<const int*>(hist), static_cast<int*>(slot), mp, g, cap);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
