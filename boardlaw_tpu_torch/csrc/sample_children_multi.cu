// K inverse-CDF draws per (env, node) row from precomputed probs, with their
// child lookups, one lane group per row.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:sample_children_multi
// (_sample_children_kernel). Plain twin: boardlaw_tpu_torch/mcts/kernels.py
// sample_children_multi_ref (search._sample_children_multi, cum_mode
// 'shift').
//
// The prefix sum and the draws are row_solve.cuh's `prefix` and `draw_k`,
// the ones node_actions_multi.cu runs after its solve, in the same lane
// layout (kernels.row_layout): the log-shift (Hillis-Steele) inclusive sum
// in the order of search._shift_cumsum, then for each rand the first lane
// with prob > 0 and cum >= r, else the last positive lane (-1, child 0,
// where a row has none). Both sides add the same floats in the same order,
// so the draws are bit-equal to the twin's, and from solve_probs.cu's probs
// to node_actions_multi's.
//
// What bounds it on the H100: device-memory bytes in principle. Each (row,
// lane) reads 5 bytes (probs f32, children int8), each row K rands and
// writes 2K int32s: at 32,768 envs x 65 nodes x 81 actions, K=8, about
// 1.07 GB, 0.32 ms at 3.35 TB/s.
//
// What the design does about it: the probs and children rows are read once,
// with consecutive lanes on consecutive addresses; the prefix sum stays in
// registers; each draw is a ballot per lane slot and its child a shuffle,
// with no dependent load; lane k loads rand k and stores draw k.
//
// Children are int8 up to 127 node slots and int32 above
// (search.tree_dtypes), each instantiated; an int32 child is one load of
// the drawn slot after the draw, exact at every node id (the Pallas kernel
// streams children as bf16, exact up to 256 only).

#include "row_solve.cuh"

namespace {

template <int G, typename TC>
__global__ void __launch_bounds__(row_solve::kThreads, row_solve::kMinBlocks)
sample_children_multi_kernel(
    const float* __restrict__ probs, int64_t probs_stride, const TC* __restrict__ children,
    int64_t children_stride, int B, int R, int A, int K, const float* __restrict__ rands,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ child_out) {
  const row_solve::Lane<G> L;
  const int64_t rows = (int64_t)B * R;
  const int64_t row_id = L.row();
  if (row_id - L.group >= rows) return;  // the warp's first row: uniform across the warp
  const bool valid = row_id < rows;
  const int b = valid ? (int)(row_id / R) : 0;
  const int t = valid ? (int)(row_id % R) : 0;
  const float* p = probs + (int64_t)b * probs_stride + (int64_t)t * A;

  row_solve::Row<G> row;
  row_solve::Kids<G, TC> kids;
  kids.load(children + (int64_t)b * children_stride + (int64_t)t * A, A, valid, L);
  const int J = (A + G - 1) / G;
#pragma unroll
  for (int j = 0; j < row_solve::kMaxJ; ++j) {
    const int a = j * G + L.gl;
    row.probs[j] = (j < J && valid && a < A) ? __ldg(p + a) : 0.f;
  }
  row_solve::prefix<G>(A, L, row);
  const int64_t o = (int64_t)b * K * R + t;
  row_solve::draw_k<G>(row, kids, rands + o, R, K, A, valid, L, actions_out + o,
                       child_out + o);
}

}  // namespace

extern "C" int sample_children_multi_launch(
    const void* probs, int probs_stride, const void* children, int children_i32,
    int children_stride, int B, int R, int A, int K, const void* rands, void* actions_out,
    void* child_out, int group, int blocks, void* stream) {
  return row_solve::with_children(children_i32, [&](auto tc) {
    using TC = typename decltype(tc)::type;
    return row_solve::with_group(group, A, (int64_t)B * R, blocks, [&](auto g) {
      sample_children_multi_kernel<decltype(g)::value, TC>
          <<<(unsigned)blocks, row_solve::kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)probs, (int64_t)probs_stride, (const TC*)children,
              (int64_t)children_stride, B, R, A, K, (const float*)rands,
              (int32_t*)actions_out, (int32_t*)child_out);
    });
  });
}
