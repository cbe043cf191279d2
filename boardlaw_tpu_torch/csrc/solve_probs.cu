// The all-node regularized-policy solve alone, one warp per (env, node) row:
// the solved probs (B,R,A) f32, or with out_alpha only the roots alpha (B,R).
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:solve_probs
// (_solve_probs_kernel). Plain twin: boardlaw_tpu_torch/mcts/kernels.py
// solve_probs_ref (search.node_probs).
//
// The solve is row_solve.cuh's `solve_row`, the one node_actions_multi.cu
// runs before its draws, with the same n_iters Newton or (accel) safeguarded
// Halley steps. So alpha here is the same float as node_actions_multi's, and
// sample_children_multi.cu, drawing from these probs with the shared prefix
// sum, draws what node_actions_multi draws.
//
// What bounds it on the H100: device-memory bytes. Each (row, lane) reads 10
// bytes (logits f32, n_edge bf16, w_edge f32) and, in probs mode, writes 4.
// At 32,768 envs x 65 nodes x 81 actions (the 9x9 scan pass) that is about
// 2.4 GB, 0.72 ms at 3.35 TB/s (1.7 GB, 0.52 ms in alpha mode); the solve's
// ~60 float operations per (row, lane) at 6 steps stay below the 67 TFLOP/s
// float32 rate.
//
// What the simple design does about it: each row is read once, straight in
// its storage types, and the whole iteration stays in registers; the probs
// are written once with consecutive lanes on consecutive addresses, and in
// alpha mode not at all (the caller re-derives them where it samples).
// q_bounds is read from device memory, so the host never syncs. Like the
// other row kernels it is latency-bound by the solve's divisions at these
// widths; several rows per warp are later work.

#include "row_solve.cuh"

namespace {

using row_solve::kMaxJ;
using row_solve::kWarp;
constexpr int kWarpsPerBlock = 8;

__global__ void solve_probs_kernel(
    const float* __restrict__ logits, const __nv_bfloat16* __restrict__ n_edge,
    const float* __restrict__ w_edge, int B, int R, int A, int64_t env_stride,
    const float* __restrict__ c_puct, const float* __restrict__ q_bounds, int n_iters,
    int accel, int out_alpha, float* __restrict__ out) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t row_id = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row_id >= (int64_t)B * R) return;  // uniform across the warp
  const int b = (int)(row_id / R);
  const int t = (int)(row_id % R);
  const int64_t base = (int64_t)b * env_stride + (int64_t)t * A;

  row_solve::Row row;
  row_solve::solve_row(logits + base, n_edge + base, w_edge + base, A, __ldg(c_puct + b),
                       __ldg(q_bounds), __ldg(q_bounds + 1), n_iters, accel, lane, row);
  if (out_alpha) {
    if (lane == 0) out[row_id] = row.alpha;
    return;
  }
  float* dst = out + row_id * A;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    if (a < A) dst[a] = row.probs[j];
  }
}

}  // namespace

extern "C" int solve_probs_launch(
    const void* logits, const void* n_edge, const void* w_edge, int B, int R, int A,
    int env_stride, const void* c_puct, const void* q_bounds, int n_iters, int accel,
    int out_alpha, void* out, void* stream) {
  if (A > kMaxJ * kWarp) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * R;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    solve_probs_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
        (const float*)logits, (const __nv_bfloat16*)n_edge, (const float*)w_edge, B, R, A,
        (int64_t)env_stride, (const float*)c_puct, (const float*)q_bounds, n_iters, accel,
        out_alpha, (float*)out);
  }
  return (int)cudaGetLastError();
}
