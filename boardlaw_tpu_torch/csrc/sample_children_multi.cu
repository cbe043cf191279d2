// K inverse-CDF draws per (env, node) row from precomputed probs, with their
// child lookups, one warp per row.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:sample_children_multi
// (_sample_children_kernel). Plain twin: boardlaw_tpu_torch/mcts/kernels.py
// sample_children_multi_ref (search._sample_children_multi, cum_mode
// 'shift').
//
// The prefix sum and the draw are row_solve.cuh's `prefix` and `draw`, the
// ones node_actions_multi.cu runs after its solve: the log-shift
// (Hillis-Steele) inclusive sum in the order of search._shift_cumsum, then
// for each rand the first lane with prob > 0 and cum >= r, else the last
// positive lane (-1, child 0, where a row has none). Both sides add the same
// floats in the same order, so the draws are bit-equal to the twin's, and
// from solve_probs.cu's probs to node_actions_multi's.
//
// What bounds it on the H100: device-memory bytes. Each (row, lane) reads 5
// bytes (probs f32, children int8), each row K rands and writes 2K int32s.
// At 32,768 envs x 65 nodes x 81 actions, K=8, that is about 1.07 GB,
// 0.32 ms at 3.35 TB/s; the 7 prefix adds and 2K compares per lane stay
// below the float32 rate.
//
// What the simple design does about it: the probs row is read once, with
// consecutive lanes on consecutive addresses, the children byte only at the
// drawn lanes, and the sum stays in the warp's shared-memory strip and
// registers for all K draws.

#include "row_solve.cuh"

namespace {

using row_solve::kMaxJ;
using row_solve::kWarp;
constexpr int kWarpsPerBlock = 8;

__global__ void sample_children_multi_kernel(
    const float* __restrict__ probs, int64_t probs_stride, const int8_t* __restrict__ children,
    int64_t children_stride, int B, int R, int A, int K, const float* __restrict__ rands,
    int32_t* __restrict__ actions_out, int32_t* __restrict__ child_out) {
  __shared__ float strip[kWarpsPerBlock][kMaxJ * kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t row_id = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row_id >= (int64_t)B * R) return;  // uniform across the warp
  const int b = (int)(row_id / R);
  const int t = (int)(row_id % R);
  const float* p = probs + (int64_t)b * probs_stride + (int64_t)t * A;
  const int8_t* ch = children + (int64_t)b * children_stride + (int64_t)t * A;

  row_solve::Row row;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    row.probs[j] = a < A ? __ldg(p + a) : 0.f;
  }
  row_solve::prefix(A, strip[warp], lane, row);
  for (int k = 0; k < K; ++k) {
    const int64_t o = ((int64_t)b * K + k) * R + t;
    const int act = row_solve::draw(row, __ldg(rands + o), A, lane);
    if (lane == 0) {
      actions_out[o] = act;
      child_out[o] = act >= 0 ? (int32_t)ch[act] : 0;
    }
  }
}

}  // namespace

extern "C" int sample_children_multi_launch(
    const void* probs, int probs_stride, const void* children, int children_stride, int B,
    int R, int A, int K, const void* rands, void* actions_out, void* child_out, void* stream) {
  if (A > kMaxJ * kWarp) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * R;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    sample_children_multi_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)probs, (int64_t)probs_stride, (const int8_t*)children,
        (int64_t)children_stride, B, R, A, K, (const float*)rands, (int32_t*)actions_out,
        (int32_t*)child_out);
  }
  return (int)cudaGetLastError();
}
