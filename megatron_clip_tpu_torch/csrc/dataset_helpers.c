/* Index helpers of the GPT dataset, in C for the host.
 *
 * The port's copy of the two functions of
 * megatron_clip_tpu/data/native/helpers.cpp that the GPT dataset calls
 * (megatron/data/helpers.cpp's build_sample_idx and
 * build_blending_indices), with the same arithmetic, so the indices are
 * equal bit for bit. A plain C interface over NumPy buffers, loaded with
 * ctypes by data/helpers.py and built on first use by
 * ops/kernels/_build.py (HOST_SOURCES) with the host's C compiler.
 *
 *  - build_sample_idx: walk the shuffled documents in epoch order, packing
 *    their tokens into samples of seq_length + 1 (the targets are the
 *    inputs shifted by one, so consecutive samples share a token), and
 *    record each sample's start as (position in doc_idx, token offset).
 *  - build_blending_indices: for each sample of a blend, the dataset whose
 *    emitted share lags its weight the most, and that dataset's next
 *    sample.
 */
#include <stdint.h>
#include <stdlib.h>

/* Writes (num_samples + 1) rows of 2 int32 into sample_idx and returns
 * num_samples = (num_epochs * tokens_per_epoch - 1) / seq_length, or -1
 * when max_samples rows do not hold them. */
long long build_sample_idx(const int32_t *sizes, const int32_t *doc_idx,
                           long long doc_idx_len, int32_t seq_length,
                           int32_t num_epochs, long long tokens_per_epoch,
                           int32_t *sample_idx, long long max_samples) {
  long long num_samples = (num_epochs * tokens_per_epoch - 1) / seq_length;
  if (num_samples + 1 > max_samples) return -1;

  long long sample = 0;
  long long doc_pos = 0;   /* index into doc_idx */
  int32_t doc_offset = 0;  /* token offset within the current document */
  sample_idx[0] = (int32_t)doc_pos;
  sample_idx[1] = doc_offset;
  sample += 1;
  while (sample <= num_samples) {
    long long remaining = seq_length + 1;
    while (remaining > 0) {
      int32_t doc_len = sizes[doc_idx[doc_pos]] - doc_offset;
      remaining -= doc_len;
      if (remaining <= 0) {
        /* the sample ends inside this document */
        doc_offset += (int32_t)(doc_len + remaining - 1);
        remaining = 0;
      } else {
        ++doc_pos;
        doc_offset = 0;
        if (doc_pos >= doc_idx_len) { /* out of shuffled documents */
          doc_pos = doc_idx_len - 1;
          remaining = 0;
        }
      }
    }
    sample_idx[sample * 2] = (int32_t)doc_pos;
    sample_idx[sample * 2 + 1] = doc_offset;
    ++sample;
  }
  return num_samples;
}

/* Weighted blend of num_datasets datasets over size samples (weights
 * summing to 1): dataset_index[s] is the dataset whose deficit
 * weights[i] * (s + 1) - counts[i] is the largest (the first on a tie),
 * dataset_sample_index[s] its count so far. Returns 0, or -1 when out of
 * memory. */
int build_blending_indices(int16_t *dataset_index,
                           int64_t *dataset_sample_index,
                           const double *weights, int32_t num_datasets,
                           int64_t size) {
  int64_t *counts = calloc((size_t)num_datasets, sizeof(int64_t));
  if (counts == NULL) return -1;
  for (int64_t s = 0; s < size; ++s) {
    int32_t best = 0;
    double best_deficit = -1e300;
    for (int32_t i = 0; i < num_datasets; ++i) {
      double deficit = weights[i] * (double)(s + 1) - (double)counts[i];
      if (deficit > best_deficit) {
        best_deficit = deficit;
        best = i;
      }
    }
    dataset_index[s] = (int16_t)best;
    dataset_sample_index[s] = counts[best];
    ++counts[best];
  }
  free(counts);
  return 0;
}
