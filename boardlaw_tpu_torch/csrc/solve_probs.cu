// The all-node regularized-policy solve alone, one lane group per (env,
// node) row: the solved probs (B,R,A) f32, or with out_alpha only the roots
// alpha (B,R).
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:solve_probs
// (_solve_probs_kernel). Plain twin: boardlaw_tpu_torch/mcts/kernels.py
// solve_probs_ref (search.node_probs).
//
// The solve is row_solve.cuh's `solve_row`, the one node_actions_multi.cu
// runs before its draws, with the same n_iters Newton or (accel) safeguarded
// Halley steps and the same lane layout (kernels.row_layout). So alpha here
// is the same float as node_actions_multi's, and sample_children_multi.cu,
// drawing from these probs with the shared prefix sum, draws what
// node_actions_multi draws.
//
// The logits are read in their storage type, f32 or bf16 (the tree_dtype
// of MCTSConfig), as the Pallas kernel streams them; a bf16 logit is
// widened at its load, so the bf16 instantiation solves what the f32 one
// solves on the logits' f32 copy, bit for bit. The edge counts are bf16 up
// to 128 node slots and f32 above (search.tree_dtypes), each instantiated.
//
// What bounds it on the H100: device-memory bytes in principle. Each (row,
// lane) reads 10 bytes (logits f32, n_edge bf16, w_edge f32; 8 with bf16
// logits) and, in probs mode, writes 4: at 32,768 envs x 65 nodes x 81
// actions (the 9x9 scan pass) about 2.4 GB, 0.72 ms at 3.35 TB/s (1.7 GB,
// 0.52 ms in alpha mode). In practice the solve's divisions and group sums.
//
// What the design does about it: each row is read once, straight in its
// storage types, the whole iteration stays in registers and leaves once
// every row of the warp has converged; the probs are written once with
// consecutive lanes on consecutive addresses, and in alpha mode not at all
// (the caller re-derives them where it samples). q_bounds is read from
// device memory, so the host never syncs.

#include "row_solve.cuh"

namespace {

template <int G, bool kAccel, typename TL, typename TN>
__global__ void __launch_bounds__(row_solve::kThreads, row_solve::kMinBlocks)
solve_probs_kernel(
    const TL* __restrict__ logits, const TN* __restrict__ n_edge,
    const float* __restrict__ w_edge, int B, int R, int A, int64_t env_stride,
    const float* __restrict__ c_puct, const float* __restrict__ q_bounds, int n_iters,
    int out_alpha, float* __restrict__ out) {
  const row_solve::Lane<G> L;
  const int64_t rows = (int64_t)B * R;
  const int64_t row_id = L.row();
  if (row_id - L.group >= rows) return;  // the warp's first row: uniform across the warp
  const bool valid = row_id < rows;
  const int b = valid ? (int)(row_id / R) : 0;
  const int t = valid ? (int)(row_id % R) : 0;
  const int64_t base = (int64_t)b * env_stride + (int64_t)t * A;

  row_solve::Row<G> row;
  row_solve::solve_row<G, kAccel, TL, TN>(logits + base, n_edge + base, w_edge + base, A,
                                          __ldg(c_puct + b), __ldg(q_bounds),
                                          __ldg(q_bounds + 1), n_iters, valid, L, row);
  if (!valid) return;
  if (out_alpha) {
    if (L.gl == 0) out[row_id] = row.alpha;
    return;
  }
  float* dst = out + row_id * A;
#pragma unroll
  for (int j = 0; j < row_solve::kMaxJ; ++j) {
    const int a = j * G + L.gl;
    if (a < A) dst[a] = row.probs[j];
  }
}

}  // namespace

extern "C" int solve_probs_launch(
    const void* logits, int logits_bf16, const void* n_edge, int counts_f32, const void* w_edge,
    int B, int R, int A, int env_stride, const void* c_puct, const void* q_bounds, int n_iters,
    int accel, int out_alpha, void* out, int group, int blocks, void* stream) {
  return row_solve::with_counts(counts_f32, [&](auto tn) {
    using TN = typename decltype(tn)::type;
    return row_solve::with_logits(logits_bf16, [&](auto tl) {
      using TL = typename decltype(tl)::type;
      return row_solve::with_group(group, A, (int64_t)B * R, blocks, [&](auto g) {
        constexpr int kG = decltype(g)::value;
        auto kernel = accel ? solve_probs_kernel<kG, true, TL, TN>
                            : solve_probs_kernel<kG, false, TL, TN>;
        kernel<<<(unsigned)blocks, row_solve::kThreads, 0, (cudaStream_t)stream>>>(
            (const TL*)logits, (const TN*)n_edge, (const float*)w_edge, B, R, A,
            (int64_t)env_stride, (const float*)c_puct, (const float*)q_bounds, n_iters,
            out_alpha, (float*)out);
      });
    });
  });
}
