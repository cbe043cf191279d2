// The K=1 backup ('delta'): each env's leaf->root chase, updating n, w,
// n_edge and w_edge in place in one launch; one lane group per env.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:backup (_backup_kernel),
// which emits dense node deltas that its wrapper routes onto the parent edges
// in XLA (pallas_kernels.py:887-906). The port owes the same tree, not that
// dataflow: the routing happens inside the kernel, with the edge value
// val[clamp(seats[p], 0, S-1)] as search._apply_deltas takes it, for up to 4
// seats. Plain twin: boardlaw_tpu_torch/mcts/search.py backup.
//
// What bounds it on the H100: the latency of a few dependent round trips to
// device memory per env, not bytes. The useful bytes are 57 per visited level
// (the parent, relation, terminal flag, rewards and the parent's seat read,
// n, w, n_edge and w_edge read and written): some 10 MB at 32,768 envs, a
// bound of about 3 microseconds at 3.35 TB/s.
//
// What the design does about it (backup_walk.cuh): a lane group per env puts
// 8 to 32 times as many warps in flight as a thread per env; the parents row
// is loaded once, coalesced, and the chase runs in shared memory; the path's
// gathers go out at once; the values take one shuffle a level in the twin's
// order. An env costs the row load, one round of gathers and one edge read
// before its writes, whatever its depth up to G levels. Nothing dense is
// allocated, zeroed or scattered.

#include "backup_walk.cuh"

namespace {

template <typename TN>
__global__ void __launch_bounds__(backup_walk::kThreads)
backup_kernel(const backup_walk::Args<TN> a) {
  backup_walk::backup_env<false>(a);
}

template <typename TN>
int launch_as(const void* v, const void* leaves, const void* parents, const void* relation,
              const void* seats, const void* terminal, const void* rewards, int B, int T, int A,
              int S, int npv, void* n, void* w, void* n_edge, void* w_edge, void* stream) {
  const backup_walk::Args<TN> a{
      (const float*)v, (const int32_t*)leaves, (const int32_t*)parents,
      (const int32_t*)relation, (const int32_t*)seats, (const uint8_t*)terminal,
      (const float*)rewards, B, T, A, S, npv, (int32_t*)n, (float*)w, (TN*)n_edge,
      (float*)w_edge};
  return backup_walk::launch(backup_kernel<TN>, a, (cudaStream_t)stream);
}

}  // namespace

// counts_f32: n_edge is f32 (trees of more than 128 node slots), else bf16.
extern "C" int backup_launch(const void* v, const void* leaves, const void* parents,
                             const void* relation, const void* seats, const void* terminal,
                             const void* rewards, int B, int T, int A, int S, int npv, void* n,
                             void* w, void* n_edge, int counts_f32, void* w_edge, void* stream) {
  auto go = counts_f32 ? launch_as<float> : launch_as<__nv_bfloat16>;
  return go(v, leaves, parents, relation, seats, terminal, rewards, B, T, A, S, npv, n, w,
            n_edge, w_edge, stream);
}
