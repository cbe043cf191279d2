// The per-row regularized-policy solve and inverse-CDF draw, one lane group
// per node row. Shared by node_actions_multi.cu (K draws per row),
// node_actions.cu (one draw per row), descend.cu (one row per level of a
// walk), and by the split pair solve_probs.cu (the solve alone: `solve_row`)
// and sample_children_multi.cu (the prefix sum and draws alone: `prefix`,
// `draw_k`), so all five compute bit-identical alphas and draws from one tree.
//
// Per row: pi = exp(logits); q = (w_e/(n_e+1e-4) - qlo)/(qhi - qlo + 1e-4)
// on expanded edges, else 0; N = sum(expanded ? n_e : 1);
// lambda = c_puct*N/(N+A); alpha solves sum lambda*pi/(alpha-q) = 1 with up
// to n_iters Newton steps (one-sided err<tol test) or, with accel,
// safeguarded Halley steps (two-sided |err|<tol test), exactly as
// search.solve_policy; probs = lambda*pi/(alpha-q); a log-shift
// (Hillis-Steele) inclusive prefix sum in the order of search._shift_cumsum;
// then a draw is the first lane with prob>0 and cum>=r, else the last
// positive lane (-1 if none).
//
// Layout (kernels.row_layout picks G from A; the launchers take it and
// check that the row fits): a warp is 32/G lane groups of G lanes (G = 8 or
// 16), each group holds one row, and lane gl of a group holds actions gl,
// gl+G, gl+2G, ... (J = ceil(A/G) of them, at most kMaxJ). Small rows so
// fill the warp's lanes, and a group's sums take log2(G) shuffle levels.
//
// The rows are bound by the warp instructions they execute, so the design
// cuts warp instructions per row:
// - the solve loop leaves as soon as every row of the warp has converged.
//   This is bit-exact against the twin's fixed step count: once a row is
//   done its alpha is at least the floor and is never changed again;
// - the prefix sum runs in registers (shuffles for shifts below G, the
//   lane's own slots above), every element adding what it adds in
//   _shift_cumsum, in the same order;
// - a draw is one ballot per lane slot, the int8 children row is loaded
//   once (packed four bytes a word) and each draw's child is shuffled from
//   the lane that holds it; lane k of a group loads rand k and stores draw k.
//
// The row is read once, in its storage types (f32 or bf16 logits, f32
// w_edge, bf16 or f32 n_edge, int8 or int32 children: search.tree_dtypes'
// rule, `Kids` and `with_tree` below): a bf16 logit or count is widened to
// f32 at its load, which is exact, so a kernel on bf16 logits computes what
// it computes on their f32 copy, bit for bit, without the copy. Int32
// children (trees of more than 127 nodes) are not held in registers: a
// draw's child is one load of the group-uniform address after the draw, so
// the register budget of the int8 layout is kept. Built with -fmad=false
// so each element's arithmetic rounds like the plain twin's separate
// PyTorch ops; only the
// lane sums run in another order than the twin's (and than another G's), so
// alpha agrees to float32 roundoff and a draw can differ only where its
// uniform lies within roundoff of a CDF boundary.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace row_solve {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// The most actions a lane holds: rows of up to 8G actions.
constexpr int kMaxJ = 8;

template <int G>
__host__ __device__ constexpr int rows_per_block() {
  return kWarpsPerBlock * (kWarp / G);
}

// Where a thread sits: its warp's lane group `group` holds one row, and its
// lane `gl` in that group the actions gl + j*G.
template <int G>
struct Lane {
  int group, gl;
  __device__ Lane() : group((threadIdx.x % kWarp) / G), gl(threadIdx.x % G) {}
  // The index of this group's row (or env) over the grid.
  __device__ int64_t row() const {
    return ((int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) * (kWarp / G) + group;
  }
  // This group's bits of a warp ballot, lane gl at bit gl.
  __device__ unsigned bits(unsigned ballot) const {
    return (ballot >> (group * G)) & ((1u << G) - 1u);
  }
};

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// One row, held across its group's lanes.
template <int G>
struct Row {
  float probs[kMaxJ];
  float cum[kMaxJ];
  float alpha;                   // group-uniform
  int last_pos;                  // group-uniform
};

// The child pointers of one row, in their storage type TC: `load` (all lanes
// of the warp together, zeros where the row is invalid), then `of(act)` for
// a group-uniform action (0 where act < 0).
template <int G, typename TC>
struct Kids;

// int8 ids, loaded with the row and packed in registers, slot j in byte j%4
// of word j/4; a draw's child is shuffled from the lane that holds it.
template <int G>
struct Kids<G, int8_t> {
  uint32_t word[kMaxJ / 4];
  __device__ __forceinline__ void load(const int8_t* __restrict__ children, int A, bool valid,
                                       const Lane<G>& L) {
    const int J = (A + G - 1) / G;
#pragma unroll
    for (int w = 0; w < kMaxJ / 4; ++w) word[w] = 0u;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int a = j * G + L.gl;
      if (j < J && valid && a < A) {
        word[j / 4] |= (uint32_t)(uint8_t)children[a] << (8 * (j % 4));
      }
    }
  }
  __device__ __forceinline__ int of(int act, const Lane<G>& L) const {
    const int src = act & (G - 1);
    const int j = act >= 0 ? act / G : 0;
    const uint32_t lo = __shfl_sync(kFull, word[0], src, G);
    const uint32_t hi = __shfl_sync(kFull, word[1], src, G);
    const uint32_t w = j >= 4 ? hi : lo;
    return act >= 0 ? (int)(int8_t)(uint8_t)(w >> (8 * (j % 4))) : 0;
  }
};

// int32 ids (trees of more than 127 nodes): nothing is held; a draw's child
// is one load of the row's slot `act`, the same address in every lane of
// the group.
template <int G>
struct Kids<G, int32_t> {
  const int32_t* row;
  bool valid;
  __device__ __forceinline__ void load(const int32_t* __restrict__ children, int, bool valid_,
                                       const Lane<G>&) {
    row = children;
    valid = valid_;
  }
  __device__ __forceinline__ int of(int act, const Lane<G>&) const {
    return act >= 0 && valid ? __ldg(row + act) : 0;
  }
};

// A logit or an edge count as f32, from its storage type.
__device__ __forceinline__ float load_logit(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_logit(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float load_count(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_count(const float* p) { return *p; }

// Solve the row whose action 0 is at logits/n_edge/w_edge (all lanes of the
// warp call this together; an invalid row reads nothing and is done from the
// start): row.alpha and row.probs (0 on slots >= A). TL is the logits'
// storage type, float or __nv_bfloat16; TN the counts', the same two.
template <int G, bool kAccel, typename TL, typename TN>
__device__ __forceinline__ void solve_row(const TL* __restrict__ logits,
                                          const TN* __restrict__ n_edge,
                                          const float* __restrict__ w_edge, int A, float cp,
                                          float qlo, float qhi, int n_iters, bool valid,
                                          const Lane<G>& L, Row<G>& row) {
  const int J = (A + G - 1) / G;
  float pi[kMaxJ], q[kMaxJ], lampi[kMaxJ];
  float n_local = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * G + L.gl;
    pi[j] = 0.f;
    q[j] = 0.f;
    if (j < J && valid && a < A) {
      const float lg = load_logit(logits + a);
      const float ne = load_count(n_edge + a);
      const float we = __ldg(w_edge + a);
      const bool expanded = ne > 0.f;
      q[j] = expanded ? (we / (ne + 1e-4f) - qlo) / (qhi - qlo + 1e-4f) : 0.f;
      n_local += expanded ? ne : 1.f;
      pi[j] = expf(lg);
    }
  }
  // counts are integers, so this sum is exact in any order
  const float N = group_sum<G>(n_local);
  const float lam = cp * N / (N + (float)A);

  float alpha = -INFINITY, qmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * G + L.gl;
    lampi[j] = lam * pi[j];
    if (j < J && a < A) {
      alpha = fmaxf(alpha, q[j] + fmaxf(lampi[j], 1e-4f));
      qmax = fmaxf(qmax, q[j]);
    }
  }
  alpha = group_max<G>(alpha);
  const float floor_ = group_max<G>(qmax) + 1e-6f;

  // Once done, alpha >= floor_ stays fixed (fmaxf(alpha - 0, floor_) is
  // alpha), so leaving when every row of the warp is done changes no bit.
  bool done = !valid;
  for (int it = 0; it < n_iters; ++it) {
    float s = 0.f, g = 0.f, h = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      if (j < J && j * G + L.gl < A) {
        const float r = 1.f / (alpha - q[j]);
        const float term = lampi[j] * r;
        const float tr = term * r;
        s += term;
        g += tr;
        if (kAccel) h += tr * r;
      }
    }
    s = group_sum<G>(s);
    g = -group_sum<G>(g);
    const float err = s - 1.f;
    float step = err / g;
    if (kAccel) {
      h = 2.f * group_sum<G>(h);
      done = done || (fabsf(err) < 1e-3f);
      const float tt = err * h / (2.f * g * g);
      if (err > 0.f && tt < 0.75f) step = step / fmaxf(1.f - tt, 0.25f);
    } else {
      done = done || (err < 1e-3f);
    }
    alpha = fmaxf(alpha - (done ? 0.f : step), floor_);
    if (__all_sync(kFull, done)) break;
  }
  row.alpha = alpha;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    row.probs[j] = (j < J && j * G + L.gl < A) ? lampi[j] / (alpha - q[j]) : 0.f;
  }
}

// One level of the log-shift sum: cum[a] += cum[a - S] for S <= a < A, from
// the values before the level.
template <int G, int S>
__device__ __forceinline__ void shift_level(int A, const Lane<G>& L, Row<G>& row) {
  const int J = (A + G - 1) / G;
  float add[kMaxJ];
  if constexpr (S < G) {
    // cum[a - S] is in lane gl - S of slot j, or lane gl + G - S of slot j-1
    float rot[kMaxJ];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      rot[j] = j < J ? __shfl_sync(kFull, row.cum[j], L.gl + G - S, G) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      add[j] = L.gl >= S ? rot[j] : (j > 0 ? rot[j > 0 ? j - 1 : 0] : 0.f);
    }
  } else {
    // cum[a - S] is in this lane's own slot j - S/G
    constexpr int D = S / G;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) add[j] = j >= D ? row.cum[j >= D ? j - D : 0] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int a = j * G + L.gl;
    if (j < J && a < A && a >= S) row.cum[j] = row.cum[j] + add[j];
  }
}

// The log-shift inclusive prefix sum of row.probs into row.cum (shift = 1,
// 2, 4, ... while shift < A) and the row's last positive lane.
template <int G>
__device__ __forceinline__ void prefix(int A, const Lane<G>& L, Row<G>& row) {
  const int J = (A + G - 1) / G;
  int last_pos = -1;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    row.cum[j] = row.probs[j];
    if (j < J) {
      const unsigned pos =
          L.bits(__ballot_sync(kFull, j * G + L.gl < A && row.probs[j] > 0.f));
      if (pos) last_pos = j * G + 31 - __clz(pos);
    }
  }
  row.last_pos = last_pos;
  if (A > 1) shift_level<G, 1>(A, L, row);
  if (A > 2) shift_level<G, 2>(A, L, row);
  if (A > 4) shift_level<G, 4>(A, L, row);
  if (A > 8) shift_level<G, 8>(A, L, row);
  if (A > 16) shift_level<G, 16>(A, L, row);
  if (A > 32) shift_level<G, 32>(A, L, row);
  if (A > 64) shift_level<G, 64>(A, L, row);
}

// The draw of uniform r (group-uniform) from a prefixed row.
template <int G>
__device__ __forceinline__ int draw(const Row<G>& row, float r, int A, const Lane<G>& L) {
  const int J = (A + G - 1) / G;
  int first = -1;
  // from the last slot down, so the lowest slot with a hit decides
#pragma unroll
  for (int j = kMaxJ - 1; j >= 0; --j) {
    if (j < J) {
      const bool ok = j * G + L.gl < A && row.probs[j] > 0.f && row.cum[j] >= r;
      const unsigned hit = L.bits(__ballot_sync(kFull, ok));
      if (hit) first = j * G + __ffs(hit) - 1;
    }
  }
  return first >= 0 ? first : row.last_pos;
}

// K draws from a prefixed row with rands[k * stride]; draw k's action and
// child (from `kids`) go to actions[k * stride] and childs[k * stride]. In
// rounds of G draws, lane k of the group loads rand k, every lane takes it
// by shuffle, and lane k stores draw k.
template <int G, class Kids>
__device__ __forceinline__ void draw_k(const Row<G>& row, const Kids& kids,
                                       const float* __restrict__ rands,
                                       int64_t stride, int K, int A, bool valid,
                                       const Lane<G>& L, int32_t* __restrict__ actions,
                                       int32_t* __restrict__ childs) {
  for (int k0 = 0; k0 < K; k0 += G) {
    const int n = min(G, K - k0);
    const bool mine = valid && L.gl < n;
    const int64_t o = (int64_t)(k0 + L.gl) * stride;
    const float my_rand = mine ? __ldg(rands + o) : 0.f;
    int my_act = 0, my_child = 0;
    for (int i = 0; i < n; ++i) {
      const int act = draw<G>(row, __shfl_sync(kFull, my_rand, i, G), A, L);
      const int child = kids.of(act, L);
      if (L.gl == i) {
        my_act = act;
        my_child = child;
      }
    }
    if (mine) {
      actions[o] = my_act;
      childs[o] = my_child;
    }
  }
}

// Launch `launch(std::integral_constant<int, G>{})` for G = 8 or 16, and
// return the launch's CUDA error; cudaErrorInvalidValue for another G, a row
// wider than the layout holds, or a grid of too few blocks for `rows`.
template <class F>
inline int with_group(int G, int A, int64_t rows, int blocks, F&& launch) {
  auto go = [&](auto g) -> int {
    constexpr int kG = decltype(g)::value;
    if (A < 1 || A > kG * kMaxJ || (int64_t)blocks * rows_per_block<kG>() < rows) {
      return (int)cudaErrorInvalidValue;
    }
    if (blocks > 0) launch(g);
    return (int)cudaGetLastError();
  };
  switch (G) {
    case 8: return go(std::integral_constant<int, 8>{});
    case 16: return go(std::integral_constant<int, 16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// A type as a value, for the launchers' generic lambdas.
template <class T>
struct TypeTag {
  using type = T;
};

// Launch `launch(TypeTag<TL>{})` for TL the logits' storage type: float, or
// __nv_bfloat16 when `logits_bf16`. Returns the launch's result.
template <class F>
inline int with_logits(int logits_bf16, F&& launch) {
  return logits_bf16 ? launch(TypeTag<__nv_bfloat16>{}) : launch(TypeTag<float>{});
}

// Launch `launch(TypeTag<TC>{})` for the children's type: int8, or int32
// with `children_i32`. Returns the launch's result.
template <class F>
inline int with_children(int children_i32, F&& launch) {
  return children_i32 ? launch(TypeTag<int32_t>{}) : launch(TypeTag<int8_t>{});
}

// Launch `launch(TypeTag<TN>{})` for the edge counts' type: bf16, or float
// with `counts_f32`. Returns the launch's result.
template <class F>
inline int with_counts(int counts_f32, F&& launch) {
  return counts_f32 ? launch(TypeTag<float>{}) : launch(TypeTag<__nv_bfloat16>{});
}

// Launch `launch(TypeTag<TC>{}, TypeTag<TN>{})` for the tree's bookkeeping
// types, the pairs of search.tree_dtypes' rule: (int8, bf16) when neither
// flag is set, (int32, bf16) with `children_i32` (T = 128), (int32, float)
// with both. Returns the launch's result; cudaErrorInvalidValue for int8
// children with float counts, which the rule never gives (and which is not
// instantiated).
template <class F>
inline int with_tree(int children_i32, int counts_f32, F&& launch) {
  return with_children(children_i32, [&](auto tc) {
    return with_counts(counts_f32, [&](auto tn) {
      using TC = typename decltype(tc)::type;
      using TN = typename decltype(tn)::type;
      if constexpr (std::is_same_v<TC, int8_t> && std::is_same_v<TN, float>) {
        return (int)cudaErrorInvalidValue;
      } else {
        return launch(tc, tn);
      }
    });
  });
}

constexpr int kThreads = kWarpsPerBlock * kWarp;
// Blocks an SM keeps resident: __launch_bounds__(kThreads, kMinBlocks) caps
// a thread at 40 registers, so 48 warps an SM hide the solve's latency (the
// uncapped 8- and 16-lane layouts took 58-64 registers and ran slower).
constexpr int kMinBlocks = 6;

}  // namespace row_solve
