// All-node regularized-policy solve plus K inverse-CDF draws, one warp per
// (env, node) row.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:node_actions_multi
// (_node_actions_multi_kernel). Plain twin:
// boardlaw_tpu_torch/mcts/kernels.py node_actions_multi_ref
// (search.node_probs + search._sample_children_multi, log-shift order).
//
// The row solve and the draw are row_solve.cuh's, shared with node_actions.cu
// and descend.cu. Here: n_iters Newton or (accel) safeguarded-Halley steps,
// then for each of the K rands the draw and that lane's child pointer.
//
// What bounds it on the H100: device-memory bytes. The tree rows are read
// once each in their storage types (logits f32, n_edge bf16, w_edge f32,
// children int8: 11 bytes per (row, lane)), plus the (B,K,T) rands and two
// (B,K,T) int32 outputs. At 32,768 envs x 65 nodes x 81 actions that is
// about 2.1 GB, 0.63 ms at 3.35 TB/s; the solve's ~100 float operations per
// (row, lane) stay below the 67 TFLOP/s float32 rate.
//
// What the simple design does about it: each row is read once, straight in
// its storage types (the JAX wrapper up-casts copies to f32 first; this does
// not), and every intermediate stays in registers or the warp's shared-memory
// strip. q_bounds is read from device memory, so the host never syncs. Wider
// loads, several rows per warp and fusing the walk are later work.

#include "row_solve.cuh"

namespace {

using row_solve::kMaxJ;
using row_solve::kWarp;
constexpr int kWarpsPerBlock = 8;

__global__ void node_actions_multi_kernel(
    const float* __restrict__ logits, const __nv_bfloat16* __restrict__ n_edge,
    const float* __restrict__ w_edge, const int8_t* __restrict__ children,
    int B, int T, int A, int K, int64_t env_stride,
    const float* __restrict__ rands, const float* __restrict__ c_puct,
    const float* __restrict__ q_bounds, int n_iters, int accel,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ child_out,
    float* __restrict__ alpha_out) {
  __shared__ float strip[kWarpsPerBlock][kMaxJ * kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t row_id = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row_id >= (int64_t)B * T) return;  // uniform across the warp
  const int b = (int)(row_id / T);
  const int t = (int)(row_id % T);
  const int64_t base = (int64_t)b * env_stride + (int64_t)t * A;

  row_solve::Row row;
  row_solve::solve(logits + base, n_edge + base, w_edge + base, A, __ldg(c_puct + b),
                   __ldg(q_bounds), __ldg(q_bounds + 1), n_iters, accel, strip[warp], lane, row);
  for (int k = 0; k < K; ++k) {
    const int64_t o = ((int64_t)b * K + k) * T + t;
    const int act = row_solve::draw(row, __ldg(rands + o), A, lane);
    if (lane == 0) {
      actions_out[o] = act;
      child_out[o] = act >= 0 ? (int32_t)children[base + act] : 0;
    }
  }
  if (alpha_out != nullptr && lane == 0) alpha_out[(int64_t)b * T + t] = row.alpha;
}

}  // namespace

extern "C" int node_actions_multi_launch(
    const void* logits, const void* n_edge, const void* w_edge, const void* children,
    int B, int T, int A, int K, int env_stride,
    const void* rands, const void* c_puct, const void* q_bounds, int n_iters, int accel,
    void* actions_out, void* child_out, void* alpha_out, void* stream) {
  if (A > kMaxJ * kWarp) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * T;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    node_actions_multi_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0,
                                (cudaStream_t)stream>>>(
        (const float*)logits, (const __nv_bfloat16*)n_edge, (const float*)w_edge,
        (const int8_t*)children, B, T, A, K, (int64_t)env_stride,
        (const float*)rands, (const float*)c_puct, (const float*)q_bounds,
        n_iters, accel, (int32_t*)actions_out, (int32_t*)child_out,
        (float*)alpha_out);
  }
  return (int)cudaGetLastError();
}
