// The K=1 descend: each env walks its tree from the root, solving and
// sampling only the rows it visits, one lane group per env.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:descend (_descend_kernel,
// with _solve_policy_rows). Plain twin: boardlaw_tpu_torch/mcts/search.py
// descend_reference.
//
// At each level the group runs row_solve.cuh's solve on row t (up to 16
// Newton steps, the one-sided test: the same device code, rules and lane
// layout as node_actions.cu), draws with rands[b, t], looks up the child and
// steps; it stops when the child is unexpanded (-1) or terminal
// (pallas_kernels.py:674-723). Sharing the row code and kernels.row_layout
// makes this bit-equal to node_actions + walk on the same tree and rands.
//
// The logits are read in their storage type, f32 or bf16 (the tree_dtype
// of MCTSConfig); a bf16 logit is widened at its load, so the bf16
// instantiation walks what the f32 one walks on the logits' f32 copy. The
// children and counts too (search.tree_dtypes): int8/bf16, int32/bf16 at
// T = 128, int32/f32 above; an int32 child is loaded after its draw.
//
// What bounds it on the H100: the dependent chain, then bytes. A walk of
// depth d is d row solves in sequence, each needing its row (11 bytes per
// lane, 9 with bf16 logits) before it can start and the child pointer before
// the next one. The useful bytes are the visited rows plus one rand and a
// terminal flag per level: at 32,768 envs and 6x6 rows of 36 lanes, some tens
// of MB, a bound of some microseconds at 3.35 TB/s. One lane group per env
// keeps 32,768 chains in flight to hide the latency of each; a warp's groups
// walk to different depths, and the warp runs until its deepest walk ends.

#include "row_solve.cuh"

namespace {

template <int G, typename TL, typename TC, typename TN>
__global__ void __launch_bounds__(row_solve::kThreads, row_solve::kMinBlocks)
descend_kernel(
    const TL* __restrict__ logits, const TN* __restrict__ n_edge,
    const float* __restrict__ w_edge, const TC* __restrict__ children,
    const uint8_t* __restrict__ terminal, int B, int T, int A,
    const float* __restrict__ rands, const float* __restrict__ c_puct,
    const float* __restrict__ q_bounds,
    int32_t* __restrict__ parents_out, int32_t* __restrict__ actions_out) {
  const row_solve::Lane<G> L;
  const int64_t env_id = L.row();
  if (env_id - L.group >= B) return;  // the warp's first env: uniform across the warp
  const bool valid = env_id < B;
  const int b = valid ? (int)env_id : 0;
  const int64_t env = (int64_t)b * T * A;
  const uint8_t* term = terminal + (int64_t)b * T;
  const float* rand = rands + (int64_t)b * T;
  const float cp = __ldg(c_puct + b);
  const float qlo = __ldg(q_bounds);
  const float qhi = __ldg(q_bounds + 1);

  int t = 0, parent = 0, action = -1;
  bool active = valid && __ldg(term) == 0;
  // node ids strictly increase along a path, so T levels bound every walk;
  // `active` is group-uniform, the loop's exit warp-uniform
  for (int level = 0; level < T && __any_sync(row_solve::kFull, active); ++level) {
    const int64_t base = env + (int64_t)t * A;
    row_solve::Row<G> row;
    row_solve::Kids<G, TC> kids;
    kids.load(children + base, A, active, L);
    row_solve::solve_row<G, false, TL, TN>(logits + base, n_edge + base, w_edge + base, A, cp,
                                           qlo, qhi, 16, active, L, row);
    row_solve::prefix<G>(A, L, row);
    const int a = row_solve::draw<G>(row, active ? __ldg(rand + t) : 0.f, A, L);
    const int child = kids.of(a, L);
    if (active) {
      parent = t;
      action = a;
      if (child < 0 || __ldg(term + child) != 0) {
        active = false;
      } else {
        t = child;
      }
    }
  }
  if (valid && L.gl == 0) {
    parents_out[b] = parent;
    actions_out[b] = action;
  }
}

}  // namespace

extern "C" int descend_launch(const void* logits, int logits_bf16, const void* n_edge,
                              int counts_f32, const void* w_edge, const void* children,
                              int children_i32, const void* terminal, int B, int T, int A,
                              const void* rands, const void* c_puct, const void* q_bounds,
                              void* parents_out, void* actions_out, int group, int blocks,
                              void* stream) {
  return row_solve::with_tree(children_i32, counts_f32, [&](auto tc, auto tn) {
    using TC = typename decltype(tc)::type;
    using TN = typename decltype(tn)::type;
    return row_solve::with_logits(logits_bf16, [&](auto tl) {
      using TL = typename decltype(tl)::type;
      return row_solve::with_group(group, A, B, blocks, [&](auto g) {
        descend_kernel<decltype(g)::value, TL, TC, TN>
            <<<(unsigned)blocks, row_solve::kThreads, 0, (cudaStream_t)stream>>>(
                (const TL*)logits, (const TN*)n_edge, (const float*)w_edge,
                (const TC*)children, (const uint8_t*)terminal, B, T, A,
                (const float*)rands, (const float*)c_puct, (const float*)q_bounds,
                (int32_t*)parents_out, (int32_t*)actions_out);
      });
    });
  });
}
