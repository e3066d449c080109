// Gather + BM25 contribution for one v2m cohort, written for Hopper (sm_90a).
//
// Replaces elasticsearch_tpu/ops/pallas_bm25.py `_contrib_kernel` (the Pallas
// TPU contribution kernel) and fuses in the XLA gather of
// elasticsearch_tpu/ops/fastpath.py `gather_one`: every lane of every
// selected postings block becomes one (key, contribution) pair.
//
//   key     = docid            where tf > 0, else 0x7FFFFFFF (sorts last)
//   contrib = w * (tf / (tf + k1 * ((1 - b) + b * dl / avg)))
//             where tf > 0 and the doc is live in the query's mask row, else 0
//
// The arithmetic follows ops/bm25.py `bm25_contrib` operation by operation in
// the rail type T (float or double); the build passes --fmad=false so no
// multiply-add is contracted and the result matches the plain PyTorch twin
// bit for bit. (1 - b) arrives precomputed in double, as the reference
// computes it on the host.
//
// Bound: device-memory bytes. Per lane the kernel reads the docid and tf (8 B,
// coalesced along the 128-wide block), gathers the doc length (4 B) and the
// mask byte, and writes the key (4 B) and the contribution (sizeof(T)): about
// 25 B at double. One thread per lane keeps neighbouring threads on
// neighbouring addresses for every access except the two per-doc gathers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockLanes = 128;          // index/segment.py BLOCK_SIZE
constexpr int32_t kSentinel = 0x7FFFFFFF;  // ops/bm25.py _SENTINEL
constexpr int kThreads = 256;

template <typename T>
__global__ void gather_contrib_kernel(
    const int32_t* __restrict__ block_docids,  // [TB, 128]
    const float* __restrict__ block_tfs,       // [TB, 128]
    const int32_t* __restrict__ sel_blocks,    // [Q, NB]
    const T* __restrict__ sel_weights,         // [Q, NB]
    const float* __restrict__ doc_lens,        // [ND]
    const uint8_t* __restrict__ masks,         // [F, ND] bool
    const int32_t* __restrict__ mask_ids,      // [Q]
    int64_t n_lanes, int64_t nb, int64_t nd,
    T avg, T k1, T b, T one_minus_b,
    int32_t* __restrict__ keys,                // [Q, NB * 128]
    T* __restrict__ contrib) {                 // [Q, NB * 128]
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const int64_t row = i / kBlockLanes;         // q * NB + selected block
  const int64_t q = row / nb;
  const int64_t src = (int64_t)sel_blocks[row] * kBlockLanes + (i % kBlockLanes);
  const int32_t d = block_docids[src];
  const float tf = block_tfs[src];
  int32_t key = kSentinel;
  T c = T(0);
  if (tf > 0.0f) {
    key = d;
    if (masks[(int64_t)mask_ids[q] * nd + d]) {
      const T tft = T(tf);
      const T dl = T(doc_lens[d]);
      const T norm = k1 * (one_minus_b + b * dl / avg);
      c = sel_weights[row] * (tft / (tft + norm));
    }
  }
  keys[i] = key;
  contrib[i] = c;
}

template <typename T>
int launch(const void* block_docids, const void* block_tfs,
           const void* sel_blocks, const void* sel_weights,
           const void* doc_lens, const void* masks, const void* mask_ids,
           int64_t q, int64_t nb, int64_t nd, double avg, double k1,
           double b, double one_minus_b, void* keys, void* contrib,
           void* stream) {
  const int64_t n_lanes = q * nb * kBlockLanes;
  if (n_lanes == 0) return 0;
  const int64_t grid = (n_lanes + kThreads - 1) / kThreads;
  gather_contrib_kernel<T><<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)block_docids, (const float*)block_tfs,
      (const int32_t*)sel_blocks, (const T*)sel_weights,
      (const float*)doc_lens, (const uint8_t*)masks,
      (const int32_t*)mask_ids, n_lanes, nb, nd, T(avg), T(k1), T(b),
      T(one_minus_b), (int32_t*)keys, (T*)contrib);
  return (int)cudaGetLastError();
}

}  // namespace

// Scalars arrive as double and are rounded once to the rail type here, the
// same rounding the PyTorch twin applies to its Python-float operands.
extern "C" int gather_bm25_contrib_f32(
    const void* block_docids, const void* block_tfs, const void* sel_blocks,
    const void* sel_weights, const void* doc_lens, const void* masks,
    const void* mask_ids, int64_t q, int64_t nb, int64_t nd, double avg,
    double k1, double b, double one_minus_b, void* keys, void* contrib,
    void* stream) {
  return launch<float>(block_docids, block_tfs, sel_blocks, sel_weights,
                       doc_lens, masks, mask_ids, q, nb, nd, avg, k1, b,
                       one_minus_b, keys, contrib, stream);
}

extern "C" int gather_bm25_contrib_f64(
    const void* block_docids, const void* block_tfs, const void* sel_blocks,
    const void* sel_weights, const void* doc_lens, const void* masks,
    const void* mask_ids, int64_t q, int64_t nb, int64_t nd, double avg,
    double k1, double b, double one_minus_b, void* keys, void* contrib,
    void* stream) {
  return launch<double>(block_docids, block_tfs, sel_blocks, sel_weights,
                        doc_lens, masks, mask_ids, q, nb, nd, avg, k1, b,
                        one_minus_b, keys, contrib, stream);
}
