// All-node regularized-policy solve plus K inverse-CDF draws, one warp per
// (env, node) row.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:node_actions_multi
// (_node_actions_multi_kernel). Plain twin:
// boardlaw_tpu_torch/mcts/kernels.py node_actions_multi_ref
// (search.node_probs + search._sample_children_multi(cum_mode='shift')).
//
// Per row: pi = exp(logits); q = (w_e/(n_e+1e-4) - qlo)/(qhi - qlo + 1e-4)
// on expanded edges, else 0; N = sum(expanded ? n_e : 1);
// lambda = c_puct*N/(N+A); alpha solves sum lambda*pi/(alpha-q) = 1 with
// n_iters Newton steps (one-sided err<tol test) or, with accel, safeguarded
// Halley steps (two-sided |err|<tol test), exactly as search.solve_policy;
// probs = lambda*pi/(alpha-q); a log-shift (Hillis-Steele) inclusive prefix
// sum in the order of _sample_children_multi(cum_mode='shift'); then for each
// of the K rands the first lane with prob>0 and cum>=r, else the last
// positive lane, and that lane's child pointer.
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
// not), and every intermediate stays in registers or a 512-byte
// shared-memory strip per warp. Lanes hold actions lane, lane+32, lane+64,
// ... so a warp's loads of a row are contiguous. Sums use warp shuffles; the
// prefix sum runs in shared memory in the log-shift order. q_bounds is read
// from device memory, so the host never syncs. Wider loads, several rows
// per warp and fusing the walk are later work.
//
// Numbers: built with -fmad=false so each element's arithmetic rounds like
// the twin's separate PyTorch ops; the lane sums are taken in another order
// than the twin's, so alpha agrees to float32 roundoff and a draw can differ
// only where its rand lies within roundoff of a CDF boundary.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxJ = 4;  // lanes hold up to 4 actions: A <= 128
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_min_int(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ int warp_max_int(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

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
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= (int64_t)B * T) return;  // uniform across the warp
  const int b = (int)(row / T);
  const int t = (int)(row % T);
  const int64_t base = (int64_t)b * env_stride + (int64_t)t * A;
  float* sh = strip[warp];

  const float qlo = __ldg(q_bounds);
  const float qhi = __ldg(q_bounds + 1);
  const float cp = __ldg(c_puct + b);

  float pi[kMaxJ], q[kMaxJ], lampi[kMaxJ];
  float n_local = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    pi[j] = 0.f;
    q[j] = 0.f;
    if (a < A) {
      const float lg = __ldg(logits + base + a);
      const float ne = __bfloat162float(n_edge[base + a]);
      const float we = __ldg(w_edge + base + a);
      const bool expanded = ne > 0.f;
      q[j] = expanded ? (we / (ne + 1e-4f) - qlo) / (qhi - qlo + 1e-4f) : 0.f;
      n_local += expanded ? ne : 1.f;
      pi[j] = expf(lg);
    }
  }
  // counts are integers, so this sum is exact in any order
  const float N = warp_sum(n_local);
  const float lam = cp * N / (N + (float)A);

  float alpha = -INFINITY, qmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    lampi[j] = lam * pi[j];
    if (a < A) {
      alpha = fmaxf(alpha, q[j] + fmaxf(lampi[j], 1e-4f));
      qmax = fmaxf(qmax, q[j]);
    }
  }
  alpha = warp_max(alpha);
  const float floor_ = warp_max(qmax) + 1e-6f;

  bool done = false;
  for (int it = 0; it < n_iters; ++it) {
    float s = 0.f, g = 0.f, h = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      if (j * kWarp + lane < A) {
        const float r = 1.f / (alpha - q[j]);
        const float term = lampi[j] * r;
        const float tr = term * r;
        s += term;
        g += tr;
        h += tr * r;
      }
    }
    s = warp_sum(s);
    g = -warp_sum(g);
    const float err = s - 1.f;
    float step = err / g;
    if (accel) {
      h = 2.f * warp_sum(h);
      done = done || (fabsf(err) < 1e-3f);
      const float tt = err * h / (2.f * g * g);
      if (err > 0.f && tt < 0.75f) step = step / fmaxf(1.f - tt, 0.25f);
    } else {
      done = done || (err < 1e-3f);
    }
    alpha = fmaxf(alpha - (done ? 0.f : step), floor_);
  }

  // probs and the log-shift inclusive prefix sum: cum[a] += cum[a - shift]
  // for shift = 1, 2, 4, ... (lanes below shift keep their value)
  float cum[kMaxJ];
  int last_pos = -1;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    cum[j] = 0.f;
    if (a < A) {
      const float p = lampi[j] / (alpha - q[j]);
      cum[j] = p;
      pi[j] = p;  // keep probs for the positivity test
      sh[a] = p;
      if (p > 0.f) last_pos = a;
    }
  }
  last_pos = warp_max_int(last_pos);
  __syncwarp();
  for (int shift = 1; shift < A; shift <<= 1) {
    float add[kMaxJ];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int a = j * kWarp + lane;
      add[j] = (a < A && a >= shift) ? sh[a - shift] : 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int a = j * kWarp + lane;
      if (a < A && a >= shift) {
        cum[j] = cum[j] + add[j];
        sh[a] = cum[j];
      }
    }
    __syncwarp();
  }

  const int big = A + 1;
  for (int k = 0; k < K; ++k) {
    const int64_t o = ((int64_t)b * K + k) * T + t;
    const float r = __ldg(rands + o);
    int first = big;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int a = j * kWarp + lane;
      if (a < A && pi[j] > 0.f && cum[j] >= r) first = min(first, a);
    }
    first = warp_min_int(first);
    if (lane == 0) {
      const int act = first < big ? first : last_pos;
      actions_out[o] = act;
      child_out[o] = act >= 0 ? (int32_t)children[base + act] : 0;
    }
  }
  if (alpha_out != nullptr && lane == 0) alpha_out[(int64_t)b * T + t] = alpha;
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
