// All-node regularized-policy solve plus K inverse-CDF draws, one lane group
// per (env, node) row.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:node_actions_multi
// (_node_actions_multi_kernel). Plain twin:
// boardlaw_tpu_torch/mcts/kernels.py node_actions_multi_ref
// (search.node_probs + search._sample_children_multi, log-shift order).
//
// The row solve and the draw are row_solve.cuh's, shared with node_actions.cu
// and descend.cu. Here: up to n_iters Newton or (accel) safeguarded-Halley
// steps, then for each of the K rands the draw and that lane's child pointer.
//
// The logits are read in their storage type, f32 or bf16 (the tree_dtype
// of MCTSConfig); a bf16 logit is widened at its load, so the bf16
// instantiation draws what the f32 one draws on the logits' f32 copy. The
// children and counts too (search.tree_dtypes): int8 children with bf16
// counts up to 127 node slots, int32 with bf16 at 128, int32 with f32 above.
//
// What bounds it on the H100: device-memory bytes in principle. The tree rows
// are read once each in their storage types (logits f32, n_edge bf16, w_edge
// f32, children int8: 11 bytes per (row, lane); 9 with bf16 logits), plus the
// (B,K,T) rands and two (B,K,T) int32 outputs: at 32,768 envs x 65 nodes x 81
// actions about 2.1 GB, 0.63 ms at 3.35 TB/s. In practice the warp
// instructions a row executes bound it: the solve's divisions and sums, then
// K draws.
//
// What the design does about it: the solve loop leaves once every row of
// the warp has converged; the prefix sum stays in registers; each draw is a
// ballot per lane slot with no dependent load (the children row is loaded
// once with the other row loads, and each draw's child is shuffled from the
// lane that holds it); lane k loads rand k and stores draw k, so each output
// is one store instruction. At A = 81 two rows share a warp (G = 16, J = 6:
// 4 shuffle levels a sum), smaller boards four (kernels.row_layout).
// q_bounds is read from device memory, so the host never syncs.

#include "row_solve.cuh"

namespace {

template <int G, bool kAccel, typename TL, typename TC, typename TN>
__global__ void __launch_bounds__(row_solve::kThreads, row_solve::kMinBlocks)
node_actions_multi_kernel(
    const TL* __restrict__ logits, const TN* __restrict__ n_edge,
    const float* __restrict__ w_edge, const TC* __restrict__ children,
    int B, int T, int A, int K, int64_t env_stride,
    const float* __restrict__ rands, const float* __restrict__ c_puct,
    const float* __restrict__ q_bounds, int n_iters,
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
  row_solve::solve_row<G, kAccel, TL, TN>(logits + base, n_edge + base, w_edge + base, A,
                                          __ldg(c_puct + b), __ldg(q_bounds),
                                          __ldg(q_bounds + 1), n_iters, valid, L, row);
  row_solve::prefix<G>(A, L, row);
  const int64_t o = (int64_t)b * K * T + t;
  row_solve::draw_k<G>(row, kids, rands + o, T, K, A, valid, L, actions_out + o,
                       child_out + o);
  if (alpha_out != nullptr && valid && L.gl == 0) alpha_out[row_id] = row.alpha;
}

}  // namespace

extern "C" int node_actions_multi_launch(
    const void* logits, int logits_bf16, const void* n_edge, int counts_f32, const void* w_edge,
    const void* children, int children_i32, int B, int T, int A, int K, int env_stride,
    const void* rands, const void* c_puct, const void* q_bounds, int n_iters, int accel,
    void* actions_out, void* child_out, void* alpha_out, int group, int blocks, void* stream) {
  return row_solve::with_tree(children_i32, counts_f32, [&](auto tc, auto tn) {
    using TC = typename decltype(tc)::type;
    using TN = typename decltype(tn)::type;
    return row_solve::with_logits(logits_bf16, [&](auto tl) {
      using TL = typename decltype(tl)::type;
      return row_solve::with_group(group, A, (int64_t)B * T, blocks, [&](auto g) {
        constexpr int kG = decltype(g)::value;
        auto kernel = accel ? node_actions_multi_kernel<kG, true, TL, TC, TN>
                            : node_actions_multi_kernel<kG, false, TL, TC, TN>;
        kernel<<<(unsigned)blocks, row_solve::kThreads, 0, (cudaStream_t)stream>>>(
            (const TL*)logits, (const TN*)n_edge, (const float*)w_edge, (const TC*)children, B,
            T, A, K, (int64_t)env_stride, (const float*)rands, (const float*)c_puct,
            (const float*)q_bounds, n_iters, (int32_t*)actions_out, (int32_t*)child_out,
            (float*)alpha_out);
      });
    });
  });
}
