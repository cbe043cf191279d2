// The K=1 all-node pass: every (env, node) row's regularized-policy solve and
// one inverse-CDF draw with its child lookup, one lane group per row.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:node_actions
// (_node_actions_kernel). Plain twin: boardlaw_tpu_torch/mcts/search.py
// node_actions (search.node_probs + search._sample_children, log-shift order).
//
// The row solve and the draw are row_solve.cuh's, shared with
// node_actions_multi.cu and descend.cu, with the rules of
// _node_actions_kernel (pallas_kernels.py:237-251): up to 16 Newton steps,
// the one-sided err < 1e-3 test, no acceleration. The K=1 search always runs
// them, whatever MCTSConfig.solve_iters/solve_accel say.
//
// The logits are read in their storage type, f32 or bf16 (the tree_dtype
// of MCTSConfig); a bf16 logit is widened at its load, so the bf16
// instantiation draws what the f32 one draws on the logits' f32 copy. The
// children and counts too (search.tree_dtypes): int8/bf16, int32/bf16 at
// T = 128, int32/f32 above; an int32 child is loaded after its draw.
//
// What bounds it on the H100: device-memory bytes in principle. Each (row,
// lane) reads 11 bytes (logits f32, n_edge bf16, w_edge f32, children int8; 9
// with bf16 logits), each row a rand and writes two int32s: at 32,768 envs x
// 64 nodes x 36 actions (6x6) about 0.85 GB, 0.25 ms at 3.35 TB/s. In
// practice the warp instructions a row executes bound it: two divisions a
// lane a step and the group sums.
//
// What the design does about it: the solve loop leaves once every row of
// the warp has converged (about 3-4 of the 16 steps on live rows); at A <=
// 64 a warp holds four rows of 8 lanes (3 shuffle levels a sum, 90% of the
// lanes busy at A = 36); the prefix sum stays in registers and the draw is
// one ballot per lane slot, with the child shuffled from the packed children
// row. The search hands it only the live rows (a leading slice of the node
// axis, env stride T*A), so early sims read a fraction of the tree.

#include "row_solve.cuh"

namespace {

template <int G, typename TL, typename TC, typename TN>
__global__ void __launch_bounds__(row_solve::kThreads, row_solve::kMinBlocks)
node_actions_kernel(
    const TL* __restrict__ logits, const TN* __restrict__ n_edge,
    const float* __restrict__ w_edge, const TC* __restrict__ children,
    int B, int T, int A, int64_t env_stride,
    const float* __restrict__ rands, const float* __restrict__ c_puct,
    const float* __restrict__ q_bounds,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ child_out,
    float* __restrict__ alpha_out) {
  const row_solve::Lane<G> L;
  const int64_t rows = (int64_t)B * T;
  const int64_t row_id = L.row();
  if (row_id - L.group >= rows) return;  // the warp's first row: uniform across the warp
  const bool valid = row_id < rows;
  const int b = valid ? (int)(row_id / T) : 0;
  const int t = valid ? (int)(row_id % T) : 0;
  const int64_t base = (int64_t)b * env_stride + (int64_t)t * A;

  row_solve::Row<G> row;
  row_solve::Kids<G, TC> kids;
  kids.load(children + base, A, valid, L);
  row_solve::solve_row<G, false, TL, TN>(logits + base, n_edge + base, w_edge + base, A,
                                         __ldg(c_puct + b), __ldg(q_bounds),
                                         __ldg(q_bounds + 1), 16, valid, L, row);
  row_solve::prefix<G>(A, L, row);
  row_solve::draw_k<G>(row, kids, rands + row_id, 1, 1, A, valid, L, actions_out + row_id,
                       child_out + row_id);
  if (alpha_out != nullptr && valid && L.gl == 0) alpha_out[row_id] = row.alpha;
}

}  // namespace

extern "C" int node_actions_launch(
    const void* logits, int logits_bf16, const void* n_edge, int counts_f32, const void* w_edge,
    const void* children, int children_i32, int B, int T, int A, int env_stride,
    const void* rands, const void* c_puct, const void* q_bounds, void* actions_out,
    void* child_out, void* alpha_out, int group, int blocks, void* stream) {
  return row_solve::with_tree(children_i32, counts_f32, [&](auto tc, auto tn) {
    using TC = typename decltype(tc)::type;
    using TN = typename decltype(tn)::type;
    return row_solve::with_logits(logits_bf16, [&](auto tl) {
      using TL = typename decltype(tl)::type;
      return row_solve::with_group(group, A, (int64_t)B * T, blocks, [&](auto g) {
        node_actions_kernel<decltype(g)::value, TL, TC, TN>
            <<<(unsigned)blocks, row_solve::kThreads, 0, (cudaStream_t)stream>>>(
                (const TL*)logits, (const TN*)n_edge, (const float*)w_edge,
                (const TC*)children, B, T, A, (int64_t)env_stride, (const float*)rands,
                (const float*)c_puct, (const float*)q_bounds, (int32_t*)actions_out,
                (int32_t*)child_out, (float*)alpha_out);
      });
    });
  });
}
