// Bitonic merge of docid-sorted per-term runs, written for Hopper (sm_90a).
//
// Replaces elasticsearch_tpu/ops/merge.py `_chunk_kernel` (the Pallas TPU
// chunk kernel, launched by `_chunk_call`) together with its XLA
// compare-exchange stages `_xla_stage`, as driven by `merge_sorted_slots`.
//
// Contract (ops/merge.py:184-196): keys [Q, n_slots, L] with every slot
// ascending, n_slots and L powers of two; out: [Q, P] ascending, P = n_slots*L.
// The payload rides along. Elements compare on (key, payload)
// lexicographically; the serving path's payload is the lane index, which is
// unique and ascending inside each slot, so the network yields exactly the
// stable sort by key (torch.sort(..., stable=True)) and kernel and twin agree
// bit for bit.
//
// Design. The alternating-direction invariant of the TPU kernel stays: odd
// slots are reversed once (flip_odd_slots), and every round merges pairs of
// runs with direction = (position // n) % 2, n being the merged run length.
// A stage whose stride s is at least the shared-memory chunk runs as one
// global compare-exchange launch (one thread per pair); the stages below it
// run inside one block per chunk with the chunk held in shared memory.
// Bitonic stages only exchange inside 2s-aligned groups, so chunks never
// interact once s < chunk. A chunk holds 2^14 (key, payload) pairs (128 KB of
// the 227 KB a block may use), against 2^17 in a TPU core's VMEM.
//
// Bound: device-memory bytes. The function must read and write each
// (key, payload) pair once (16 B); this simple version passes over device
// memory once per global stage and once per chunk launch instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogChunk = 14;  // 2^14 (key, payload) pairs per chunk
constexpr int kChunkThreads = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ bool greater(int32_t ka, int32_t va, int32_t kb,
                                        int32_t vb) {
  return ka > kb || (ka == kb && va > vb);
}

// out = in with every odd slot of every query reversed (the caller's pre-flip
// of ops/merge.py:204-205); with one slot per query it is a plain copy.
__global__ void flip_odd_slots(const int32_t* __restrict__ kin,
                               const int32_t* __restrict__ vin,
                               int32_t* __restrict__ kout,
                               int32_t* __restrict__ vout, int64_t total,
                               int64_t slot_len, int64_t n_slots) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t slot = i / slot_len;  // q * n_slots + s
  const int64_t pos = i % slot_len;
  const bool odd = (slot % n_slots) & 1;
  const int64_t src = odd ? slot * slot_len + (slot_len - 1 - pos) : i;
  kout[i] = kin[src];
  vout[i] = vin[src];
}

// Every length below is a power of two and arrives as its log2, so the
// index arithmetic is shifts and masks (a 64-bit division by a runtime value
// costs dozens of instructions).

// One compare-exchange stage at stride 2^ls (>= the chunk) of the round that
// merges runs into runs of length 2^ln; each query holds 2^lp elements.
__global__ void global_stage(int32_t* __restrict__ k, int32_t* __restrict__ v,
                             int64_t n_pairs, int lp, int ln, int ls) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const int64_t q = t >> (lp - 1);
  const int64_t r = t & ((int64_t(1) << (lp - 1)) - 1);
  // position inside the query: r with a 0 inserted at bit ls
  const int64_t i = ((r >> ls) << (ls + 1)) | (r & ((int64_t(1) << ls) - 1));
  const int64_t a = (q << lp) + i;
  const int64_t c = a + (int64_t(1) << ls);
  const bool desc = (i >> ln) & 1;
  const int32_t ka = k[a], kc = k[c], va = v[a], vc = v[c];
  if (greater(ka, va, kc, vc) != desc) {
    k[a] = kc;
    k[c] = ka;
    v[a] = vc;
    v[c] = va;
  }
}

// Stages 2^ls0, ..., 2, 1 of one round on one chunk of 2^lch pairs in shared
// memory. Chunks never straddle two queries (the chunk divides 2^lp).
__global__ void chunk_stages(int32_t* __restrict__ k, int32_t* __restrict__ v,
                             int lp, int lch, int ln, int ls0) {
  extern __shared__ int32_t smem[];
  const int ch = 1 << lch;
  int32_t* sk = smem;
  int32_t* sv = smem + ch;
  const int64_t base = (int64_t)blockIdx.x << lch;
  // chunk start inside its query
  const int64_t pbase = base & ((int64_t(1) << lp) - 1);
  for (int i = threadIdx.x; i < ch; i += blockDim.x) {
    sk[i] = k[base + i];
    sv[i] = v[base + i];
  }
  __syncthreads();
  for (int ls = ls0; ls >= 0; --ls) {
    const int s = 1 << ls;
    for (int t = threadIdx.x; t < ch / 2; t += blockDim.x) {
      const int i = ((t >> ls) << (ls + 1)) | (t & (s - 1));
      const int c = i + s;
      const bool desc = ((pbase + i) >> ln) & 1;
      const int32_t ka = sk[i], kc = sk[c], va = sv[i], vc = sv[c];
      if (greater(ka, va, kc, vc) != desc) {
        sk[i] = kc;
        sk[c] = ka;
        sv[i] = vc;
        sv[c] = va;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ch; i += blockDim.x) {
    k[base + i] = sk[i];
    v[base + i] = sv[i];
  }
}

inline int log2_of(int64_t n) {  // n is a power of two
  int l = 0;
  while ((int64_t(1) << l) < n) ++l;
  return l;
}

inline unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// keys_in/vals_in [Q, n_slots, L] int32 -> keys_out/vals_out [Q, P] int32.
// Inputs are only read; all stages run in place on the outputs. Returns the
// first CUDA error of any launch (0 when every launch was accepted).
extern "C" int merge_sorted_slots_i32(const void* keys_in,
                                      const void* vals_in, void* keys_out,
                                      void* vals_out, int64_t q,
                                      int64_t n_slots, int64_t slot_len,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t p = n_slots * slot_len;
  const int64_t total = q * p;
  if (total == 0) return 0;
  int32_t* k = (int32_t*)keys_out;
  int32_t* v = (int32_t*)vals_out;
  flip_odd_slots<<<blocks_for(total, kThreads), kThreads, 0, st>>>(
      (const int32_t*)keys_in, (const int32_t*)vals_in, k, v, total,
      slot_len, n_slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_slots == 1) return 0;

  const int lp = log2_of(p);
  const int lch = lp < kLogChunk ? lp : kLogChunk;
  const size_t smem = 2 * ((size_t)1 << lch) * sizeof(int32_t);
  err = cudaFuncSetAttribute(chunk_stages,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * (1 << kLogChunk) * sizeof(int32_t)));
  if (err != cudaSuccess) return (int)err;
  for (int lrun = log2_of(slot_len); lrun < lp; ++lrun) {
    const int ln = lrun + 1;  // merged run length 2^ln
    int ls = lrun;            // first stride: half the merged run
    for (; ls >= lch; --ls) {
      global_stage<<<blocks_for(total / 2, kThreads), kThreads, 0, st>>>(
          k, v, total / 2, lp, ln, ls);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    chunk_stages<<<(unsigned)(total >> lch), kChunkThreads, smem, st>>>(
        k, v, lp, lch, ln, ls);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
