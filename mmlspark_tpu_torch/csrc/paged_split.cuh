// The split-lane merge that K1 (paged_decode_attention.cu) and K3
// (paged_prefix_prefill_attention.cu) share.
//
// A kernel that splits a lane's keys across blocks writes, for every
// (item, split, head), the split's softmax partial: its running max m
// (in the log2 domain: scores times scale * log2 e), its normalizer l and
// its unnormalized accumulator acc (head_dim floats). An item is a slot
// (K1) or a suffix row (K3); split j holds keys [j * keys_per_split,
// (j + 1) * keys_per_split). Layout, all f32:
//   acc at ws[((item * n_splits + j) * n_heads + h) * head_dim + d],
//   m, l at ws[acc_floats + ((item * n_splits + j) * n_heads + h) * 2 + {0, 1}]
// with acc_floats = n_items * n_splits * n_heads * head_dim.
//
// The merge reads only the splits that hold a key the item sees: its
// last key is pos[item] (K1; pos null for K3: offset + item), capped at
// max_key, and splits 0 .. last / keys_per_split are live. They merge in
// split order by their maxima with the JAX numerics: M = max m_j,
// L = sum l_j 2^(m_j - M), out = (sum acc_j 2^(m_j - M)) / max(L, 1e-30),
// every sum taken in split order, so two launches give the same bits. No
// float atomics.
#pragma once

#include <cuda_runtime.h>

// Launch the merge on `stream` right behind the split kernel, as a
// programmatic dependent launch (the split kernel runs
// hopper::launch_dependents; the merge waits for its partials): one warp
// per (item, head). Returns the launch's error.
int mmt_launch_paged_merge(const float* ws, float* out, const int* pos,
                           int offset, int max_key, int n_items,
                           int n_splits, int keys_per_split, int n_heads,
                           int head_dim, cudaStream_t stream);
