// The K=1 backup's leaf->root chase, emitting dense node deltas; one thread
// per env.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:backup (_backup_kernel). Its
// wrapper, boardlaw_tpu_torch/mcts/kernels.py backup, then routes the deltas
// onto the parent edges with search._apply_deltas, as the Pallas wrapper
// does (pallas_kernels.py:887-906). Plain twin: search.backup.
//
// From each env's leaf: v = v[leaf]; at each node of the chase, v is zeroed
// if the node is terminal, the node's rewards are added, then dn[t] += npv
// and dw[t, :] += v; then step to parents[t] until it is -1.
//
// What bounds it on the H100: the dependent chain, not bytes. Each level
// needs parents[t] before the next can start. The useful bytes are, per
// visited level, 4 (parent) + 1 (terminal) + 4*S (rewards) read, plus the
// dense (B,T) and (B,T,S) f32 outputs written once: at 32,768 envs x 64
// nodes x 2 seats that is about 25 MB of output, a bound of some
// microseconds at 3.35 TB/s.
//
// What the simple design does about it: one thread per env gives 32,768
// independent chains in flight. Each block first zeroes its envs' rows of
// dn and dw with coalesced stores, then chases; a path visits each node
// once, so a thread's adds never collide and need no atomics. Every add is
// the twin's, in the twin's order, so dn and dw are bit-equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeats = 4;
constexpr int kThreads = 256;

__global__ void backup_kernel(const float* __restrict__ v, const int32_t* __restrict__ leaves,
                              const int32_t* __restrict__ parents,
                              const uint8_t* __restrict__ terminal,
                              const float* __restrict__ rewards, int B, int T, int S, float npv,
                              float* __restrict__ dn, float* __restrict__ dw) {
  const int64_t b0 = (int64_t)blockIdx.x * kThreads;
  const int64_t nb = min((int64_t)kThreads, (int64_t)B - b0);
  for (int64_t i = threadIdx.x; i < nb * T; i += kThreads) dn[b0 * T + i] = 0.f;
  for (int64_t i = threadIdx.x; i < nb * T * S; i += kThreads) dw[b0 * T * S + i] = 0.f;
  __syncthreads();
  if (threadIdx.x >= nb) return;
  const int64_t b = b0 + threadIdx.x;

  int cur = __ldg(leaves + b);
  float val[kMaxSeats];
  for (int s = 0; s < S; ++s) val[s] = __ldg(v + (b * T + cur) * S + s);
  // node ids strictly decrease towards the root: at most T levels
  for (int level = 0; level < T && cur >= 0; ++level) {
    const int64_t node = b * T + cur;
    const bool term = __ldg(terminal + node) != 0;
    for (int s = 0; s < S; ++s) {
      val[s] = (term ? 0.f : val[s]) + __ldg(rewards + node * S + s);
      dw[node * S + s] += val[s];
    }
    dn[node] += npv;
    cur = __ldg(parents + node);
  }
}

}  // namespace

extern "C" int backup_launch(const void* v, const void* leaves, const void* parents,
                             const void* terminal, const void* rewards, int B, int T, int S,
                             float npv, void* dn, void* dw, void* stream) {
  if (S > kMaxSeats) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    backup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)v, (const int32_t*)leaves, (const int32_t*)parents,
        (const uint8_t*)terminal, (const float*)rewards, B, T, S, npv, (float*)dn, (float*)dw);
  }
  return (int)cudaGetLastError();
}
