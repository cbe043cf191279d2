// The K=1 backup ('dense'): each env's leaf->root chase, updating n, w,
// n_edge and w_edge in place; one lane group per env.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:backup_dense
// (_backup_dense_kernel, whose outputs alias its inputs). Plain twin:
// boardlaw_tpu_torch/mcts/search.py backup.
//
// The chase of backup.cu (backup_walk.cuh), with the Pallas kernel's edge
// value: seats[p] == 0 ? val[0] : val[S-1] (pallas_kernels.py:957; the same as
// val[seats[p]] for two seats, which the wrapper requires).
//
// What bounds it on the H100: the latency of the dependent round trips to
// device memory, not bytes. Per visited level it needs 57 bytes (see
// backup.cu): some 10 MB at 32,768 envs, a bound of about 3 microseconds at
// 3.35 TB/s. A thread per env chained three dependent round trips a level
// (parents[c], then seats[p], then the edge's read-modify-write) and kept
// 8 of an SM's 64 warp slots busy.
//
// What the design does about it (backup_walk.cuh): a lane group per env,
// the parents row loaded once and chased in shared memory, the path's
// gathers at once, one round trip for the edges, the values in the twin's
// order by shuffles. n_edge is bf16 and holds the integer counts exactly up
// to 256 (at most 2*63 = 126 at the root here).

#include "backup_walk.cuh"

namespace {

template <typename TN>
__global__ void __launch_bounds__(backup_walk::kThreads)
backup_dense_kernel(const backup_walk::Args<TN> a) {
  backup_walk::backup_env<true>(a);
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
  return backup_walk::launch(backup_dense_kernel<TN>, a, (cudaStream_t)stream);
}

}  // namespace

// counts_f32: n_edge is f32 (trees of more than 128 node slots), else bf16.
extern "C" int backup_dense_launch(const void* v, const void* leaves, const void* parents,
                                   const void* relation, const void* seats,
                                   const void* terminal, const void* rewards, int B, int T,
                                   int A, int S, int npv, void* n, void* w, void* n_edge,
                                   int counts_f32, void* w_edge, void* stream) {
  auto go = counts_f32 ? launch_as<float> : launch_as<__nv_bfloat16>;
  return go(v, leaves, parents, relation, seats, terminal, rewards, B, T, A, S, npv, n, w,
            n_edge, w_edge, stream);
}
