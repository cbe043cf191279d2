// The K=1 backup with every statistic updated in place along the path; one
// thread per env.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:backup_dense
// (_backup_dense_kernel, whose outputs alias its inputs). Plain twin:
// boardlaw_tpu_torch/mcts/search.py backup.
//
// The chase of backup.cu, but at each node c it adds npv to n[c] and v to
// w[c, :] and, when c has a parent p, npv to n_edge[p, relation[c]] and
// v[seat[p] == 0 ? 0 : S-1] to w_edge[p, relation[c]] (pallas_kernels.py:957;
// the same as v[seat[p]] for two seats, which the wrapper requires). It
// touches nothing off the path.
//
// What bounds it on the H100: the dependent chain. Per visited level it
// reads parent, relation, terminal and rewards, the parent's seat, and reads
// and writes n, w, one n_edge (bf16) and one w_edge entry: about 40 bytes, a
// few MB per call at 32,768 envs, a bound of about a microsecond at
// 3.35 TB/s; the chain's latency is what it costs.
//
// What the simple design does about it: one thread per env, 32,768 chains in
// flight. Each env's path is its own part of memory, so the in-place updates
// have no write conflicts and need no atomics. n_edge is bf16 and holds the
// integer counts exactly up to 256 (at most 2*63 = 126 at the root here).
// Each statistic gets one add per visit, the twin's add, so the results are
// bit-equal to it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeats = 4;
constexpr int kThreads = 256;

__global__ void backup_dense_kernel(
    const float* __restrict__ v, const int32_t* __restrict__ leaves,
    const int32_t* __restrict__ parents, const int32_t* __restrict__ relation,
    const int32_t* __restrict__ seats, const uint8_t* __restrict__ terminal,
    const float* __restrict__ rewards, int B, int T, int A, int S, int npv,
    int32_t* __restrict__ n, float* __restrict__ w, __nv_bfloat16* __restrict__ n_edge,
    float* __restrict__ w_edge) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int cur = __ldg(leaves + b);
  float val[kMaxSeats];
  for (int s = 0; s < S; ++s) val[s] = __ldg(v + (b * T + cur) * S + s);
  for (int level = 0; level < T && cur >= 0; ++level) {
    const int64_t node = b * T + cur;
    const bool term = __ldg(terminal + node) != 0;
    for (int s = 0; s < S; ++s) {
      val[s] = (term ? 0.f : val[s]) + __ldg(rewards + node * S + s);
      w[node * S + s] += val[s];
    }
    n[node] += npv;
    const int p = __ldg(parents + node);
    if (p >= 0) {
      const int64_t edge = (b * T + p) * A + __ldg(relation + node);
      const float vp = __ldg(seats + b * T + p) == 0 ? val[0] : val[S - 1];
      n_edge[edge] = __float2bfloat16(__bfloat162float(n_edge[edge]) + (float)npv);
      w_edge[edge] += vp;
    }
    cur = p;
  }
}

}  // namespace

extern "C" int backup_dense_launch(const void* v, const void* leaves, const void* parents,
                                   const void* relation, const void* seats,
                                   const void* terminal, const void* rewards, int B, int T,
                                   int A, int S, int npv, void* n, void* w, void* n_edge,
                                   void* w_edge, void* stream) {
  if (S > kMaxSeats) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    backup_dense_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)v, (const int32_t*)leaves, (const int32_t*)parents,
        (const int32_t*)relation, (const int32_t*)seats, (const uint8_t*)terminal,
        (const float*)rewards, B, T, A, S, npv, (int32_t*)n, (float*)w,
        (__nv_bfloat16*)n_edge, (float*)w_edge);
  }
  return (int)cudaGetLastError();
}
