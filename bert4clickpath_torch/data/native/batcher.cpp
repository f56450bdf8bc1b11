// Native Cloze batch builder.
//
// The hot host-side loop of the input pipeline: given ragged label-id
// sequences (values + offsets), build fixed-shape training/eval batches —
// token layout [CLS][SEP] items [PAD]... [SEP], random Cloze masking
// (floor(pct*n) clipped to max_masked unique sorted positions; reference
// semantics from examples/BERT4Rec/source/input_pipeline.py:59-120) — in
// parallel with OpenMP. Replaces the per-row Python/numpy loop
// (bert4clickpath_tpu/data/cloze.py) at large batch sizes; the numpy path
// stays as the reference implementation.
//
// Determinism: a counter-based splitmix64 stream seeded by (seed, global
// row index) — bitwise reproducible for a given backend regardless of
// thread count.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC batcher.cpp -o libbatcher.so
// (the port's loader, data/native/__init__.py, builds into build/native/).

#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int32_t PAD_ID = 0;
constexpr int32_t MASK_ID = 1;
constexpr int32_t CLS_ID = 3;
constexpr int32_t SEP_ID = 4;
constexpr int32_t LABEL_PAD = -1;
constexpr int32_t NUM_RESERVED = 10;

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint32_t bounded(uint32_t n) {
    uint64_t m = (uint64_t)(uint32_t)next() * n;
    uint32_t l = (uint32_t)m;
    if (l < n) {
      uint32_t t = (uint32_t)(-(int32_t)n) % n;
      while (l < t) {
        m = (uint64_t)(uint32_t)next() * n;
        l = (uint32_t)m;
      }
    }
    return (uint32_t)(m >> 32);
  }
};

inline void init_row(int32_t* tokens, int token_len) {
  tokens[0] = CLS_ID;
  tokens[1] = SEP_ID;
  for (int t = 2; t < token_len - 1; ++t) tokens[t] = PAD_ID;
  tokens[token_len - 1] = SEP_ID;
}

}  // namespace

extern "C" {

// Outputs (preallocated by caller):
//   tokens:    (batch, max_items + 3) int32
//   positions: (batch, max_masked) int32
//   labels:    (batch, max_masked) int32
void build_train_batch(const int32_t* values, const int64_t* offsets,
                       const int64_t* row_indices, int64_t batch,
                       int32_t max_items, int32_t max_masked,
                       float masked_percentage, uint64_t seed,
                       uint64_t batch_counter, int32_t* tokens,
                       int32_t* positions, int32_t* labels) {
  const int token_len = max_items + 3;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < batch; ++i) {
    int32_t* tok = tokens + i * token_len;
    int32_t* pos = positions + i * max_masked;
    int32_t* lab = labels + i * max_masked;
    init_row(tok, token_len);
    for (int m = 0; m < max_masked; ++m) {
      pos[m] = 0;
      lab[m] = LABEL_PAD;
    }
    const int64_t row = row_indices[i];
    const int64_t start = offsets[row];
    int64_t full = offsets[row + 1] - start - 1;  // drop-last holdout
    if (full < 0) full = 0;
    int64_t n = full > max_items ? max_items : full;
    // most-recent window (matches cloze.py / serving.py conventions)
    const int32_t* seq = values + start + (full - n);
    for (int64_t t = 0; t < n; ++t) tok[2 + t] = seq[t] + NUM_RESERVED;

    int n_masked = (int)((float)n * masked_percentage);
    if (n_masked > max_masked) n_masked = max_masked;
    if (n_masked <= 0) continue;

    // partial Fisher-Yates over [0, n) for unique positions
    SplitMix64 rng(seed * 0x9e3779b97f4a7c15ULL + batch_counter * 0x85ebca77ULL +
                   (uint64_t)row + 1);
    int32_t idx[1024];  // max_items <= 1024, enforced by the caller (MAX_ITEMS_NATIVE)
    for (int64_t t = 0; t < n; ++t) idx[t] = (int32_t)t;
    for (int m = 0; m < n_masked; ++m) {
      int j = m + (int)rng.bounded((uint32_t)(n - m));
      std::swap(idx[m], idx[j]);
    }
    std::sort(idx, idx + n_masked);
    for (int m = 0; m < n_masked; ++m) {
      int32_t p = idx[m];
      lab[m] = seq[p];
      pos[m] = p + 2;
      tok[2 + p] = MASK_ID;
    }
  }
}

void build_eval_batch(const int32_t* values, const int64_t* offsets,
                      const int64_t* row_indices, int64_t batch,
                      int32_t max_items, int32_t max_masked, int32_t* tokens,
                      int32_t* positions, int32_t* labels) {
  const int token_len = max_items + 3;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < batch; ++i) {
    int32_t* tok = tokens + i * token_len;
    int32_t* pos = positions + i * max_masked;
    int32_t* lab = labels + i * max_masked;
    init_row(tok, token_len);
    for (int m = 0; m < max_masked; ++m) {
      pos[m] = 0;
      lab[m] = LABEL_PAD;
    }
    const int64_t row = row_indices[i];
    const int64_t start = offsets[row];
    int64_t full = offsets[row + 1] - start;
    int64_t n = full > max_items ? max_items : full;
    if (n <= 0) continue;
    // most-recent window so the masked position is the true last item
    const int32_t* seq = values + start + (full - n);
    for (int64_t t = 0; t < n; ++t) tok[2 + t] = seq[t] + NUM_RESERVED;
    tok[2 + n - 1] = MASK_ID;
    lab[0] = seq[n - 1];
    pos[0] = (int32_t)(n - 1) + 2;
  }
}

int batcher_version() { return 1; }

}  // extern "C"
