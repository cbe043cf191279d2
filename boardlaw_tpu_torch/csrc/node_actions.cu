// The K=1 all-node pass: every (env, node) row's regularized-policy solve and
// one inverse-CDF draw with its child lookup, one warp per row.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:node_actions
// (_node_actions_kernel). Plain twin: boardlaw_tpu_torch/mcts/search.py
// node_actions (search.node_probs + search._sample_children, log-shift order).
//
// The row solve and the draw are row_solve.cuh's, shared with
// node_actions_multi.cu and descend.cu, with the rules of
// _node_actions_kernel (pallas_kernels.py:237-251): 16 Newton steps, the
// one-sided err < 1e-3 test, no acceleration. The K=1 search always runs
// them, whatever MCTSConfig.solve_iters/solve_accel say.
//
// What bounds it on the H100: device-memory bytes. Each (row, lane) reads
// 11 bytes (logits f32, n_edge bf16, w_edge f32, children int8), each row a
// rand and writes two int32s. At 32,768 envs x 64 nodes x 36 actions (6x6)
// that is about 0.85 GB, 0.25 ms at 3.35 TB/s; the 16-step solve's ~150 float
// operations per (row, lane) need about 0.17 ms at the 67 TFLOP/s float32
// rate, so the two bounds are close.
//
// What the simple design does about it: each row is read once, straight in
// its storage types, every intermediate stays in registers or the warp's
// shared-memory strip, and q_bounds is read from device memory (no host
// sync). The search hands it only the live rows (a leading slice of the node
// axis, env stride T*A), so early sims read a fraction of the tree. At A=36
// a warp's second lane group holds only 4 actions, so most lanes idle there;
// several rows per warp are later work.

#include "row_solve.cuh"

namespace {

using row_solve::kMaxJ;
using row_solve::kWarp;
constexpr int kWarpsPerBlock = 8;

__global__ void node_actions_kernel(
    const float* __restrict__ logits, const __nv_bfloat16* __restrict__ n_edge,
    const float* __restrict__ w_edge, const int8_t* __restrict__ children,
    int B, int T, int A, int64_t env_stride,
    const float* __restrict__ rands, const float* __restrict__ c_puct,
    const float* __restrict__ q_bounds,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ child_out) {
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
                   __ldg(q_bounds), __ldg(q_bounds + 1), 16, 0, strip[warp], lane, row);
  const int act = row_solve::draw(row, __ldg(rands + row_id), A, lane);
  if (lane == 0) {
    actions_out[row_id] = act;
    child_out[row_id] = act >= 0 ? (int32_t)children[base + act] : 0;
  }
}

}  // namespace

extern "C" int node_actions_launch(
    const void* logits, const void* n_edge, const void* w_edge, const void* children,
    int B, int T, int A, int env_stride, const void* rands, const void* c_puct,
    const void* q_bounds, void* actions_out, void* child_out, void* stream) {
  if (A > kMaxJ * kWarp) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * T;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    node_actions_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
        (const float*)logits, (const __nv_bfloat16*)n_edge, (const float*)w_edge,
        (const int8_t*)children, B, T, A, (int64_t)env_stride, (const float*)rands,
        (const float*)c_puct, (const float*)q_bounds, (int32_t*)actions_out,
        (int32_t*)child_out);
  }
  return (int)cudaGetLastError();
}
