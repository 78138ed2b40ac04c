// Plan encode (capacity-balanced group assignment) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/plan_encode/plan_encode.py:
//   plan_rank  <- _rank_kernel  (comparator-rank pass)
//   plan_place <- _place_kernel (cross-tile placement pass)
// by two routes, chosen in the wrapper by an explicit shape test
// (repro_torch.kernels.plan_encode.ops.assign_route):
//
//   * plan_assign (the sort route, every side of the IC3Net and gemma2-2b
//     paths): one launch a grouping side, one CTA a stacked layer, from
//     the f32 scores straight to the (G, cap) item lists and each item's
//     group;
//   * plan_rank + plan_place (the tiled route, sides past the sort route's
//     limits): the TPU's two passes over pref/strength padded to tiles.
//
// Both return slot ids bitwise equal to the TPU kernels'.
//
// plan_assign. What bounds it on this card: by bytes its work is a few
// microseconds even at gemma2-2b's widths (13 x 9216 items: 1.9 MB of
// scores in, 1.2 MB of ids and groups out); what it has to compute is a
// stable sort of L*M short keys. The TPU computed each item's rank by
// comparing it with every item (M^2 pair tests, 1.1e9 a launch at 13 x
// 9216) because a VMEM tile is a (bi, bj) block; a CTA instead holds a
// whole layer's items (up to kAssignMaxItems) in registers and shared
// memory and sorts them:
//   1. every thread reads its items' G scores in place through the given
//      strides (striped over the threads, so a warp's loads are
//      neighbours whether the items or the groups are contiguous; og is
//      read transposed, with no copy) and forms argmax group p (first
//      index on ties, as torch/jnp.argmax) and strength s; the group
//      histogram is built with shared-memory atomics (order-free, so
//      deterministic); a block exchange then gives each thread kItems
//      consecutive items (a blocked arrangement: an item's place in it is
//      its index);
//   2. two stable radix sorts (cub::BlockRadixSort, block scope, 4-bit
//      digits): the strength key ~orderable(s) with the packed
//      (p << 16 | index) as value, then the packed word on its group bits
//      alone. Stability keeps index order among equal keys, so the result
//      is the order (p asc, s desc, index asc) of the comparator; -0.0 is
//      folded into +0.0 first, as the comparator treats them as equal;
//   3. one warp scans the histogram: each group's start, kept count, and
//      the exclusive overflow and free-slot prefixes of _place_kernel;
//   4. the item at sorted position pos has rank pos - start[p] and takes
//      _place_kernel's closed-form slot (the overflow's free-slot range by
//      binary search); the CTA writes ids[slot] = item, group[item] =
//      slot / cap, and M into every slot no item takes.
// The sort's passes (8 for the strength, 1 for G <= 16) bound it: in a
// small CTA their barriers and shared-memory round trips (~0.5 us a pass),
// in a large one the SM's shared-memory traffic (~6 us a pass at 10,240
// items); one CTA a layer leaves most SMs idle at L = 13.
// No padding to a tile and no cross-CTA carry are left.
//
// plan_rank / plan_place inputs per layer l: pref[l, i] (argmax group,
// int32; padding items carry pref == G) and strength[l, i] (float32;
// padding carries -inf), both (L, Mp) with Mp a multiple of the tile
// side bi. At the FLGW layer shapes of the MARL path (Mp <= 512, L = 1)
// the whole pass is a few KB and ~0.3 M comparisons, so the launch itself
// is the bound. The TPU's sequential j grid axis and its VMEM
// accumulator become a loop inside the block over j-tiles staged in
// shared memory (blocks carry no state from one to the next on a GPU),
// every thread counts for one item in a register, and the per-tile group
// histogram is built with integer shared-memory atomics (order-free, so
// deterministic). Shared-memory reads in the inner loop are broadcasts
// (all threads read the same j), so they are conflict-free.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_exchange.cuh>
#include <cub/block/block_radix_sort.cuh>

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


// ---------------------------------------------------------------------------
// plan_assign: the sort route
// ---------------------------------------------------------------------------

// The route's limits, the same numbers as ops.SORT_MAX_ITEMS and
// ops.SORT_MAX_GROUPS. Items: the largest tier is 1024 threads (the most a
// CTA takes) x 16 items; its keys and values take 32 of the 64 registers
// a thread has at 1024 threads (the sort's ranks push it to spill ~0.5 KB
// a thread, which is why 512 x 20 takes the sides up to 10,240), and its
// exchange buffer 66 KB of shared memory. An item's index rides in 16
// bits of the packed value. Groups: the histogram and its four prefixes
// take 5 ints a group in shared memory (20 KB at 1024), and the group key
// needs at most 10 bits (three 4-bit radix passes).
constexpr int kAssignMaxItems = 16384;
constexpr int kAssignMaxGroups = 1024;

template <int kThreads_, int kItems_>
struct AssignTier {
  static constexpr int kThreads = kThreads_;
  static constexpr int kItems = kItems_;
  using SortKV = cub::BlockRadixSort<unsigned, kThreads, kItems, unsigned>;
  using SortK = cub::BlockRadixSort<unsigned, kThreads, kItems>;
  using Exchange = cub::BlockExchange<unsigned, kThreads, kItems>;
  union Temp {
    typename SortKV::TempStorage kv;
    typename SortK::TempStorage k;
    typename Exchange::TempStorage ex;
  };
  static constexpr size_t kTempBytes = (sizeof(Temp) + 15) / 16 * 16;
  // dynamic shared memory of a launch: the sorts' storage, then the
  // histogram, its four prefixes and the overflow total
  static size_t smem(int g) {
    return kTempBytes + (5 * static_cast<size_t>(g) + 1) * sizeof(int);
  }
};

// Calls f with the tier of m items: the fastest measured for each range
// (few items a thread while the passes' latency bounds a small CTA; 512
// x 20 up to 10,240, faster than 1024 x 10 or x 16, whose 64 registers
// spill).
template <typename F>
int by_tier(int m, F&& f) {
  if (m <= 128) return f(AssignTier<128, 1>{});
  if (m <= 512) return f(AssignTier<128, 4>{});
  if (m <= 2048) return f(AssignTier<256, 8>{});
  if (m <= 4096) return f(AssignTier<512, 8>{});
  if (m <= 10240) return f(AssignTier<512, 20>{});
  return f(AssignTier<1024, 16>{});
}

// grid (L,), block kThreads. Thread t reads items t, t + kThreads, ...
// (striped: a warp's loads are neighbours along whichever axis is
// contiguous), then holds items t*kItems .. +kItems-1 (blocked, so an
// item's place is its index) for the sorts.
// scores(l, i, h) = scores[l*s_layer + i*s_item + h*s_group].
// ids: (L, G*cap) int64; group: (L, M) int64.
template <int kThreads, int kItems>
__global__ void __launch_bounds__(kThreads)
plan_assign_kernel(const float* __restrict__ scores, long long s_layer,
                   long long s_item, long long s_group,
                   long long* __restrict__ ids, long long* __restrict__ group,
                   int m, int g, int cap) {
  using Tier = AssignTier<kThreads, kItems>;
  extern __shared__ __align__(16) unsigned char assign_smem[];
  auto& temp = *reinterpret_cast<typename Tier::Temp*>(assign_smem);
  int* counts = reinterpret_cast<int*>(assign_smem + Tier::kTempBytes);
  int* start = counts + g;        // first sorted position of each group
  int* kcount = start + g;        // kept count: min(count, cap)
  int* ovf_before = kcount + g;   // exclusive prefix of the overflow counts
  int* free_before = ovf_before + g;  // exclusive prefix of the free slots
  int* total_ovf = free_before + g;

  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sl = scores + static_cast<long long>(l) * s_layer;
  for (int h = tid; h < g; h += kThreads) counts[h] = 0;
  __syncthreads();

  // 1. argmax group and strength key of every item; padding sorts last.
  // The loads of kBatch groups of all the thread's items are issued
  // together (16 in flight a thread).
  constexpr int kBatch = kItems >= 16 ? 1 : 16 / kItems;
  unsigned key[kItems], val[kItems];
  float best[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    best[k] = -INFINITY;  // with a strict > below: the first index wins
    val[k] = 0;           // a tie, and an all -inf item takes group 0
  }
  for (int h0 = 0; h0 < g; h0 += kBatch) {
    float v[kBatch][kItems];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int i = k * kThreads + tid;
        v[b][k] = h0 + b < g && i < m
            ? sl[i * s_item + static_cast<long long>(h0 + b) * s_group]
            : -INFINITY;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (v[b][k] > best[k]) {
          best[k] = v[b][k];
          val[k] = h0 + b;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (i < m) {
      const float s = best[k] == 0.0f ? 0.0f : best[k];  // -0.0 -> +0.0
      unsigned u = __float_as_uint(s);
      u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in s
      key[k] = ~u;                                     // descending in s
      atomicAdd(&counts[val[k]], 1);
      val[k] = (val[k] << 16) | static_cast<unsigned>(i);
    } else {
      key[k] = 0xFFFFFFFFu;
      val[k] = 0xFFFFFFFFu;
    }
  }
  using Exchange = typename Tier::Exchange;
  Exchange(temp.ex).StripedToBlocked(key);
  __syncthreads();
  Exchange(temp.ex).StripedToBlocked(val);
  __syncthreads();

  // 3. (before the sorts, which do not touch these arrays) one warp scans
  // the histogram, 32 groups at a time, carrying the running sums.
  if (tid < 32) {
    const unsigned full = 0xFFFFFFFFu;
    int run_c = 0, run_o = 0, run_f = 0;
    for (int base = 0; base < g; base += 32) {
      const int h = base + tid;
      const int c = h < g ? counts[h] : 0;
      const int kc = min(c, cap);
      const int o = c - kc;
      const int f = h < g ? cap - kc : 0;
      int ic = c, io = o, jf = f;  // inclusive scans across the warp
      for (int off = 1; off < 32; off <<= 1) {
        const int a = __shfl_up_sync(full, ic, off);
        const int b = __shfl_up_sync(full, io, off);
        const int d = __shfl_up_sync(full, jf, off);
        if (tid >= off) {
          ic += a;
          io += b;
          jf += d;
        }
      }
      if (h < g) {
        start[h] = run_c + ic - c;
        kcount[h] = kc;
        ovf_before[h] = run_o + io - o;
        free_before[h] = run_f + jf - f;
      }
      run_c += __shfl_sync(full, ic, 31);
      run_o += __shfl_sync(full, io, 31);
      run_f += __shfl_sync(full, jf, 31);
    }
    if (tid == 0) *total_ovf = run_o;
  }

  // 2. strength (desc) then group (asc), both stable.
  using SortKV = typename Tier::SortKV;
  using SortK = typename Tier::SortK;
  SortKV(temp.kv).Sort(key, val);
  if (g > 1) {
    __syncthreads();  // the two sorts share their storage
    const int gbits = 32 - __clz(g - 1);
    SortK(temp.k).Sort(val, 16, 16 + gbits);
  }
  __syncthreads();  // the scan's arrays are visible to every thread

  // 4. rank from the sorted position, then _place_kernel's slot.
  const int slots = g * cap;
  long long* il = ids + static_cast<long long>(l) * slots;
  long long* gl = group + static_cast<long long>(l) * m;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int pos = tid * kItems + k;
    if (pos < m) {
      const int item = static_cast<int>(val[k] & 0xFFFFu);
      const int p = static_cast<int>(val[k] >> 16);
      const int r = pos - start[p];
      int slot;
      if (r < cap) {
        slot = p * cap + r;
      } else {
        // the overflow rank q falls in the free-slot range of the last
        // group whose range starts at or before it
        const int q = ovf_before[p] + r - cap;
        int lo = 0, hi = g - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (free_before[mid] <= q) lo = mid; else hi = mid - 1;
        }
        slot = lo * cap + kcount[lo] + (q - free_before[lo]);
      }
      il[slot] = item;
      gl[item] = slot / cap;
    }
  }
  // Slot (h, j) is taken by a kept item (j < kcount) or by the overflow
  // item of rank free_before[h] + j - kcount, if there is one.
  const int n_ovf = *total_ovf;
  for (int s = tid; s < slots; s += kThreads) {
    const int h = s / cap;
    const int j = s - h * cap;
    if (j >= kcount[h] && free_before[h] + (j - kcount[h]) >= n_ovf)
      il[s] = m;
  }
}

template <int kThreads, int kItems>
int launch_assign(const float* scores, long long s_layer, long long s_item,
                  long long s_group, long long* ids, long long* group, int l,
                  int m, int g, int cap, cudaStream_t stream) {
  const size_t smem = AssignTier<kThreads, kItems>::smem(g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        plan_assign_kernel<kThreads, kItems>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  plan_assign_kernel<kThreads, kItems><<<l, kThreads, smem, stream>>>(
      scores, s_layer, s_item, s_group, ids, group, m, g, cap);
  return static_cast<int>(cudaGetLastError());
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

// scores: f32, (L, M, G) read through the element strides given (s_item
// along the items, s_group along the groups); ids: (L, G*cap) int64;
// group: (L, M) int64. Refuses (cudaErrorInvalidValue) the shapes past
// the sort route's limits: those take plan_rank + plan_place.
int plan_assign(const void* scores, void* ids, void* group, int l, int m,
                int g, int cap, long long s_layer, long long s_item,
                long long s_group, void* stream) {
  if (l < 1 || m < 1 || m > kAssignMaxItems || g < 1
      || g > kAssignMaxGroups || cap < 1
      || static_cast<long long>(g) * cap < m)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_tier(m, [&](auto tier) {
    using Tier = decltype(tier);
    return launch_assign<Tier::kThreads, Tier::kItems>(
        static_cast<const float*>(scores), s_layer, s_item, s_group,
        static_cast<long long*>(ids), static_cast<long long*>(group), l, m,
        g, cap, static_cast<cudaStream_t>(stream));
  });
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
