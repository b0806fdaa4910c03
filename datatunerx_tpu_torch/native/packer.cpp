// Native data-path hot loops: batch buffer filling + first-fit packing.
//
// The trainer's loader assembles static-shape batches host-side every step,
// which in Python costs a per-example interpreter loop. These loops are the
// port's native (C++) component: built once with g++ into build/torch_native/
// and bound through ctypes (datatunerx_tpu_torch/native/__init__.py), with the
// Python loops of data/preprocess.py as the fallback.
//
// Exposed (extern "C"):
//   dtx_fill_batch:  scatter variable-length token/label rows into fixed
//                    [B, block] int32 buffers (pad_id / ignore_index padding)
//   dtx_first_fit:   greedy first-fit-decreasing bin packing of row lengths
//   dtx_fill_packed: scatter rows into packed buffers with segment ids,
//                    per-segment positions, and boundary label masking

#include <cstdint>
#include <cstring>

extern "C" {

// tokens/labels: concatenated example arrays; offsets[i]..offsets[i+1] is
// example i. Rows are right-padded to block; labels padded with ignore_index.
void dtx_fill_batch(
    const int32_t* tokens, const int32_t* labels, const int64_t* offsets,
    int64_t n_examples, int64_t block, int32_t pad_id, int32_t ignore_index,
    int32_t* out_tokens, int32_t* out_labels, int32_t* out_attn) {
  for (int64_t i = 0; i < n_examples; ++i) {
    int64_t start = offsets[i];
    int64_t len = offsets[i + 1] - start;
    if (len > block) len = block;
    int32_t* trow = out_tokens + i * block;
    int32_t* lrow = out_labels + i * block;
    int32_t* arow = out_attn + i * block;
    std::memcpy(trow, tokens + start, len * sizeof(int32_t));
    std::memcpy(lrow, labels + start, len * sizeof(int32_t));
    for (int64_t t = 0; t < len; ++t) arow[t] = 1;
    for (int64_t t = len; t < block; ++t) {
      trow[t] = pad_id;
      lrow[t] = ignore_index;
      arow[t] = 0;
    }
  }
}

// lengths: per-example lengths SORTED DESCENDING by the caller (with
// `order` carrying original indices). Assigns each example a row id via
// greedy first-fit; returns the number of rows used.
int64_t dtx_first_fit(
    const int64_t* lengths, int64_t n, int64_t block,
    int64_t* row_of,  // out: row id per (sorted) example
    int64_t* row_used  // scratch+out: capacity n, bytes used per row
) {
  int64_t n_rows = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = lengths[i] < block ? lengths[i] : block;
    int64_t placed = -1;
    for (int64_t r = 0; r < n_rows; ++r) {
      if (row_used[r] + len <= block) {
        placed = r;
        break;
      }
    }
    if (placed < 0) {
      placed = n_rows++;
      row_used[placed] = 0;
    }
    row_of[i] = placed;
    row_used[placed] += len;
  }
  return n_rows;
}

// Scatter examples into packed rows. row_of/row_offset are per-example
// (row id, starting column) computed by the caller from dtx_first_fit.
// seg_of[i] is the 1-based segment index within its row.
void dtx_fill_packed(
    const int32_t* tokens, const int32_t* labels, const int64_t* offsets,
    const int64_t* row_of, const int64_t* row_offset, const int64_t* seg_of,
    int64_t n_examples, int64_t block, int32_t ignore_index,
    int32_t* out_tokens, int32_t* out_labels, int32_t* out_attn,
    int32_t* out_segs, int32_t* out_pos) {
  for (int64_t i = 0; i < n_examples; ++i) {
    int64_t start = offsets[i];
    int64_t len = offsets[i + 1] - start;
    int64_t off = row_offset[i];
    if (len > block - off) len = block - off;
    if (len <= 0) continue;
    int64_t row = row_of[i];
    int32_t* trow = out_tokens + row * block + off;
    int32_t* lrow = out_labels + row * block + off;
    int32_t* arow = out_attn + row * block + off;
    int32_t* srow = out_segs + row * block + off;
    int32_t* prow = out_pos + row * block + off;
    std::memcpy(trow, tokens + start, len * sizeof(int32_t));
    std::memcpy(lrow, labels + start, len * sizeof(int32_t));
    // shifted-CE boundary: never train a segment's first token from the
    // previous segment's last (mirrors preprocess.pack_to_block)
    lrow[0] = ignore_index;
    for (int64_t t = 0; t < len; ++t) {
      arow[t] = 1;
      srow[t] = (int32_t)seg_of[i];
      prow[t] = (int32_t)t;
    }
  }
}

}  // extern "C"
