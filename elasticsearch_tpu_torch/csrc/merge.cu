// Merge of docid-sorted per-term runs, written for Hopper (sm_90a).
//
// Replaces elasticsearch_tpu/ops/merge.py `_chunk_kernel` (the Pallas TPU
// kernel, launched by `_chunk_call`) together with its XLA compare-exchange
// stages `_xla_stage`, as driven by `merge_sorted_slots`. The TPU merged
// with a bitonic network because Mosaic has no data-dependent addressing;
// Hopper has, so this is a merge-path merge instead.
//
// Contract (ops/merge.py:184-196): keys [Q, n_slots, L] with every slot
// ascending, n_slots and L powers of two; out: [Q, P] ascending, P = n_slots*L.
// The payload rides along. Elements compare on (key, payload)
// lexicographically, and on a full tie the element of the left run goes
// first, so the merge is stable. The serving path's payload is the lane
// index, unique and ascending inside each slot, so the result is exactly the
// stable sort by key (torch.sort(..., stable=True)), bit for bit.
//
// Bound: device-memory bytes. The function must read and write each
// (key, payload) pair once, 16 B per pair; it does a few integer operations
// per pair.
//
// Design: merge path (Green, McColl and Bader, "GPU Merge Path", ICS 2012;
// Odeh et al., "Merge Path", 2012). log2(n_slots) rounds; each merges the
// runs two by two in ONE pass over device memory, so the design's floor is
// log2(n_slots) times the bound. A block owns a tile of 4096 consecutive
// outputs. When a merged pair is longer than the tile, two warps find where
// the tile's first and last diagonals cross the pair's two runs, each by a
// 32-way search in device memory (3 rounds of loads for a 2^15 run, against
// 16 for a binary search); the block then loads the two sub-ranges into
// shared memory with coalesced loads; each thread finds its own split of 16
// outputs there, merges them in registers, and stages them back through
// shared memory so that the block stores its tile coalesced. A block holds
// 33 KB of shared memory and 256 threads, so four share an SM and hide one
// another's load latency. (Side by side on the card, this shape ran faster
// than 2048-output tiles, and the in-block search faster than a separate
// partition launch per round.) Every length is a power of two and arrives
// as its log2: index arithmetic is shifts and masks. Sentinel keys need no
// special case.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // outputs per thread
constexpr int kLogTile = 12;
constexpr int kTile = 1 << kLogTile;  // outputs per block
static_assert(kThreads * kItems == kTile, "a tile is threads x items");
// Element i of a tile sits at i + i / 32 in shared memory (pad below): the
// threads of a warp read and write 16 apart when they merge and stage, and
// the padding puts those 32 addresses in 32 different banks. A thread may
// read one element past the tile.
constexpr int kSmem = kTile + kTile / 32 + 1;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ bool greater(int32_t ka, int32_t va, int32_t kb,
                                        int32_t vb) {
  return ka > kb || (ka == kb && va > vb);
}

// How many of the first d outputs of the stable merge of run A (na items)
// and run B (nb) come from A: the least a in [max(0, d - nb), min(d, na)]
// with A[a] > B[d - 1 - a]. The 32 lanes of the calling warp search
// together: each round probes 32 evenly spaced candidates and keeps the gap
// between the last probe with A <= B and the first with A > B. Every lane
// returns the same value.
__device__ int warp_merge_path(const int32_t* __restrict__ ka,
                               const int32_t* __restrict__ va,
                               const int32_t* __restrict__ kb,
                               const int32_t* __restrict__ vb, int na,
                               int nb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    bool le = false;
    if (p < hi) le = !greater(ka[p], va[p], kb[d - 1 - p], vb[d - 1 - p]);
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    const int nlo = c == 0 ? lo : lo + (c - 1) * step + 1;
    hi = min(lo + c * step, hi);
    lo = nlo;
  }
  return lo;
}

// The same split by one thread, binary search, for runs in shared memory:
// A at tile elements a0 .. a0 + na - 1, B at b0 .. b0 + nb - 1.
__device__ __forceinline__ int merge_path(const int32_t* sk,
                                          const int32_t* sv, int a0, int na,
                                          int b0, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int i = pad(a0 + mid), j = pad(b0 + d - 1 - mid);
    if (greater(sk[i], sv[i], sk[j], sv[j]))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// One round: src holds runs of 2^lrun pairs; dst gets them merged two by
// two into runs of 2^(lrun + 1). Both are flat [total]: the runs tile each
// query's row, so no pair of runs straddles two queries.
__global__ void __launch_bounds__(kThreads)
    merge_path_round(const int32_t* __restrict__ ksrc,
                     const int32_t* __restrict__ vsrc,
                     int32_t* __restrict__ kdst, int32_t* __restrict__ vdst,
                     int64_t total, int lrun) {
  __shared__ int32_t sk[kSmem];
  __shared__ int32_t sv[kSmem];
  __shared__ int split[2];
  const int tid = threadIdx.x;
  const int64_t tile0 = (int64_t)blockIdx.x << kLogTile;
  // outputs of this tile: a whole tile, except the last one when total is
  // not a multiple of the tile (then every pair is shorter than a tile)
  const int n = (int)min((int64_t)kTile, total - tile0);
  const int run = 1 << lrun;
  // a merged pair (2^(lrun+1)) longer than the tile holds the whole tile;
  // otherwise the tile holds whole pairs and its inputs are the same range
  const bool in_one_pair = lrun >= kLogTile;
  int na = 0;  // with in_one_pair, the tile's outputs taken from run A
  if (in_one_pair) {
    const int64_t pair0 = tile0 & ~((int64_t(2) << lrun) - 1);
    const int d0 = (int)(tile0 - pair0);
    const int32_t* ka = ksrc + pair0;
    const int32_t* va = vsrc + pair0;
    const int32_t* kb = ka + run;
    const int32_t* vb = va + run;
    const int warp = tid >> 5;
    if (warp < 2) {  // warp 0: the tile's first diagonal; warp 1: its end
      const int a = warp_merge_path(ka, va, kb, vb, run, run,
                                    d0 + warp * kTile);
      if ((tid & 31) == 0) split[warp] = a;
    }
    __syncthreads();
    const int a0 = split[0];
    const int b0 = d0 - a0;
    na = split[1] - a0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      if (i < na) {
        sk[pad(i)] = ka[a0 + i];
        sv[pad(i)] = va[a0 + i];
      } else {
        sk[pad(i)] = kb[b0 + i - na];
        sv[pad(i)] = vb[b0 + i - na];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = tid + j * kThreads;
      if (i < n) {
        sk[pad(i)] = ksrc[tile0 + i];
        sv[pad(i)] = vsrc[tile0 + i];
      }
    }
  }
  __syncthreads();

  // this thread's outputs o .. o + kItems - 1 of the tile: find where they
  // start in runs A and B (shared memory), then merge them in registers
  const int o = tid * kItems;
  int a, a_end, b, b_end;
  if (in_one_pair) {
    const int s = merge_path(sk, sv, 0, na, na, kTile - na, o);
    a = s;
    a_end = na;
    b = na + o - s;
    b_end = kTile;
  } else {
    const int seg = o & ~((2 << lrun) - 1);  // start of o's pair of runs
    const int d = o - seg;
    const int s = merge_path(sk, sv, seg, run, seg + run, run, d);
    a = seg + s;
    a_end = seg + run;
    b = a_end + d - s;
    b_end = a_end + run;
  }
  int32_t rk[kItems], rv[kItems];
  int32_t ak = sk[pad(a)], av = sv[pad(a)];
  int32_t bk = sk[pad(b)], bv = sv[pad(b)];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_a = b >= b_end || (a < a_end && !greater(ak, av, bk, bv));
    rk[j] = take_a ? ak : bk;
    rv[j] = take_a ? av : bv;
    if (take_a) {
      ++a;
      ak = sk[pad(a)];
      av = sv[pad(a)];
    } else {
      ++b;
      bk = sk[pad(b)];
      bv = sv[pad(b)];
    }
    // runs shorter than 8: the next output starts the next pair of runs
    if (!in_one_pair && j + 1 < kItems &&
        ((o + j + 1) & ((2 << lrun) - 1)) == 0) {
      a = o + j + 1;
      a_end = a + run;
      b = a_end;
      b_end = b + run;
      ak = sk[pad(a)];
      av = sv[pad(a)];
      bk = sk[pad(b)];
      bv = sv[pad(b)];
    }
  }
  __syncthreads();  // every thread has read its inputs
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (o + j < n) {
      sk[pad(o + j)] = rk[j];
      sv[pad(o + j)] = rv[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kThreads;
    if (i < n) {
      kdst[tile0 + i] = sk[pad(i)];
      vdst[tile0 + i] = sv[pad(i)];
    }
  }
}

inline int log2_of(int64_t n) {  // n is a power of two
  int l = 0;
  while ((int64_t(1) << l) < n) ++l;
  return l;
}

}  // namespace

// keys_in/vals_in [Q, n_slots, L] int32 -> keys_out/vals_out [Q, P] int32.
// The inputs are only read. keys_tmp/vals_tmp are [Q, P] scratch, needed
// when n_slots >= 4: the rounds alternate between scratch and output,
// ordered so that the last one lands in the output. Returns the first CUDA
// error of any launch or copy (0 when every one was accepted).
extern "C" int merge_sorted_slots_i32(const void* keys_in,
                                      const void* vals_in, void* keys_out,
                                      void* vals_out, void* keys_tmp,
                                      void* vals_tmp, int64_t q,
                                      int64_t n_slots, int64_t slot_len,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t total = q * n_slots * slot_len;
  if (total == 0) return 0;
  const int rounds = log2_of(n_slots);
  if (rounds == 0) {  // one run per query: the merge is a copy
    const size_t bytes = (size_t)total * sizeof(int32_t);
    cudaError_t err = cudaMemcpyAsync(keys_out, keys_in, bytes,
                                      cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(vals_out, vals_in, bytes,
                            cudaMemcpyDeviceToDevice, st);
    return (int)err;
  }
  if (rounds >= 2 && (keys_tmp == nullptr || vals_tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  const int32_t* ks = (const int32_t*)keys_in;
  const int32_t* vs = (const int32_t*)vals_in;
  const unsigned blocks = (unsigned)((total + kTile - 1) >> kLogTile);
  const int lrun0 = log2_of(slot_len);
  for (int r = 0; r < rounds; ++r) {
    const bool to_out = ((rounds - 1 - r) & 1) == 0;
    int32_t* kd = (int32_t*)(to_out ? keys_out : keys_tmp);
    int32_t* vd = (int32_t*)(to_out ? vals_out : vals_tmp);
    merge_path_round<<<blocks, kThreads, 0, st>>>(ks, vs, kd, vd, total,
                                                   lrun0 + r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ks = kd;
    vs = vd;
  }
  return 0;
}
