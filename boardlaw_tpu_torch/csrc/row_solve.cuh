// The per-row regularized-policy solve and inverse-CDF draw, one warp per
// node row. Shared by node_actions_multi.cu (K draws per row), node_actions.cu
// (one draw per row), descend.cu (one row per level of a walk), and by the
// split pair solve_probs.cu (the solve alone: `solve_row`) and
// sample_children_multi.cu (the prefix sum and draws alone: `prefix`,
// `draw`), so all five compute bit-identical alphas and draws from one tree.
//
// Per row: pi = exp(logits); q = (w_e/(n_e+1e-4) - qlo)/(qhi - qlo + 1e-4)
// on expanded edges, else 0; N = sum(expanded ? n_e : 1);
// lambda = c_puct*N/(N+A); alpha solves sum lambda*pi/(alpha-q) = 1 with
// n_iters Newton steps (one-sided err<tol test) or, with accel, safeguarded
// Halley steps (two-sided |err|<tol test), exactly as search.solve_policy;
// probs = lambda*pi/(alpha-q); a log-shift (Hillis-Steele) inclusive prefix
// sum in the order of search._shift_cumsum; then a draw is the first lane
// with prob>0 and cum>=r, else the last positive lane (-1 if none).
//
// Lanes hold actions lane, lane+32, lane+64, lane+96 (A <= 128), so a warp's
// loads of a row are contiguous. The row is read once, in its storage types
// (f32 logits and w_edge, bf16 n_edge); sums use warp shuffles; the prefix
// sum runs in a per-warp shared-memory strip of kMaxJ*32 floats. Built with
// -fmad=false so each element's arithmetic rounds like the plain twin's
// separate PyTorch ops; only the lane sums run in another order than the
// twin's, so alpha agrees to float32 roundoff and a draw can differ only
// where its uniform lies within roundoff of a CDF boundary.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace row_solve {

constexpr int kWarp = 32;
constexpr int kMaxJ = 4;  // lanes hold up to 4 actions: A <= 128
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

// One solved row, held across the warp's lanes.
struct Row {
  float probs[kMaxJ];
  float cum[kMaxJ];
  int last_pos;  // warp-uniform
  float alpha;   // warp-uniform
};

// Solve the row whose lane 0 is at logits/n_edge/w_edge (all lanes of the
// warp call this together): row.alpha and row.probs (0 on lanes >= A).
__device__ __forceinline__ void solve_row(const float* __restrict__ logits,
                                          const __nv_bfloat16* __restrict__ n_edge,
                                          const float* __restrict__ w_edge, int A, float cp,
                                          float qlo, float qhi, int n_iters, int accel,
                                          int lane, Row& row) {
  float pi[kMaxJ], q[kMaxJ], lampi[kMaxJ];
  float n_local = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    pi[j] = 0.f;
    q[j] = 0.f;
    if (a < A) {
      const float lg = __ldg(logits + a);
      const float ne = __bfloat162float(n_edge[a]);
      const float we = __ldg(w_edge + a);
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
  row.alpha = alpha;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    row.probs[j] = j * kWarp + lane < A ? lampi[j] / (alpha - q[j]) : 0.f;
  }
}

// The log-shift inclusive prefix sum of row.probs into row.cum, cum[a] +=
// cum[a - shift] for shift = 1, 2, 4, ... (lanes below shift keep their
// value), and the last positive lane. sh: this warp's kMaxJ*kWarp-float strip.
__device__ __forceinline__ void prefix(int A, float* sh, int lane, Row& row) {
  int last_pos = -1;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    const float p = row.probs[j];
    row.cum[j] = p;
    if (a < A) {
      sh[a] = p;
      if (p > 0.f) last_pos = a;
    }
  }
  row.last_pos = warp_max_int(last_pos);
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
        row.cum[j] = row.cum[j] + add[j];
        sh[a] = row.cum[j];
      }
    }
    __syncwarp();
  }
}

// The solve and the prefix sum of one row.
__device__ __forceinline__ void solve(const float* __restrict__ logits,
                                      const __nv_bfloat16* __restrict__ n_edge,
                                      const float* __restrict__ w_edge, int A, float cp,
                                      float qlo, float qhi, int n_iters, int accel,
                                      float* sh, int lane, Row& row) {
  solve_row(logits, n_edge, w_edge, A, cp, qlo, qhi, n_iters, accel, lane, row);
  prefix(A, sh, lane, row);
}

// The draw of uniform r from a solved row; the result is warp-uniform.
__device__ __forceinline__ int draw(const Row& row, float r, int A, int lane) {
  const int big = A + 1;
  int first = big;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * kWarp + lane;
    if (a < A && row.probs[j] > 0.f && row.cum[j] >= r) first = min(first, a);
  }
  first = warp_min_int(first);
  return first < big ? first : row.last_pos;
}

}  // namespace row_solve
