// The K=1 backup's leaf->root chase, one lane group per env, updating n, w,
// n_edge and w_edge in place. Shared by backup.cu and backup_dense.cu, which
// differ only in the value an edge takes (`kDense`).
//
// Per env, from its leaf: val = v[leaf]; at each path node c (leaf first),
// val = (terminal[c] ? 0 : val) + rewards[c]; n[c] += npv, w[c, :] += val,
// and where c has a parent p, n_edge[p, relation[c]] += npv and
// w_edge[p, relation[c]] += the edge value: val[clamp(seats[p], 0, S-1)]
// (backup.cu, as search._apply_deltas routes it), or
// seats[p] == 0 ? val[0] : val[S-1] (backup_dense.cu, the Pallas kernel's
// rule). Exactly search.backup's result, bit for bit. n_edge is bf16 up to
// 128 node slots and f32 above (search.tree_dtypes): Args<TN> and the
// kernels are instantiated for both.
//
// Layout (kGroup below is G): G lanes of a warp hold one env, 32/G envs a
// warp, up to 8 warps a block. Per env:
// 1. the group loads the env's parents row (T int32) with coalesced loads
//    into shared memory, while the leaf and its value are on their way;
// 2. every lane of the group follows the chain in shared memory, G levels a
//    round, and lane j keeps the round's j-th path node (leaf first), so a
//    level costs a shared-memory load, not a round trip to device memory.
//    Shared memory rather than registers: a chase step reads a slot that
//    depends on the node, which a register file cannot index without a
//    select over every slot, and it holds rows of any T;
// 3. lane j gathers its node's terminal flag, rewards, statistics and
//    relation and its parent's seat, all loads independent of each other,
//    then its parent edge's n_edge and w_edge, which arrive while step 4 runs;
// 4. the values run in the twin's order: one shuffle per seat and level
//    from the lane that holds the level to its group, each value the twin's
//    single add, so w and w_edge equal the twin's bit for bit (no parallel
//    scan, which would round otherwise);
// 5. lane j writes its node's and its edge's statistics. A path visits each
//    node and each edge once, so no two lanes write one address: no atomics,
//    nothing off the path.
// Every warp-wide vote, shuffle and loop bound is warp-uniform; an env whose
// chain has ended stays in the warp as a done group.
//
// Measured on the H100 (chip_smoke.py phase 4): at 32,768 envs the 6x6
// search tree's 175,375 levels take about 0.04 ms on the card, near what
// their scattered 32-byte sectors cost (each level's node and edge
// statistics lie in sectors of their own); the all-chains tree's 2,097,152
// levels about 0.3 ms, bound the same way.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace backup_walk {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSeats = 4;
// The lane group's width, the one place it is chosen. On the H100 at 32,768
// envs, 16 lanes were fastest on the 6x6 search tree (paths of 5.35 levels on
// average), ahead of 8 and 32; 32 were fastest only on the all-chains tree
// (64 levels a path), which no search makes.
constexpr int kGroup = 16;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kThreads = kMaxWarpsPerBlock * kWarp;
// shared memory a block uses without opting in, and the most it may opt in to
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename TN>
struct Args {
  const float* v;           // (B,T,S)
  const int32_t* leaves;    // (B,)
  const int32_t* parents;   // (B,T)
  const int32_t* relation;  // (B,T)
  const int32_t* seats;     // (B,T)
  const uint8_t* terminal;  // (B,T) bool
  const float* rewards;     // (B,T,S)
  int B, T, A, S, npv;
  int32_t* n;               // (B,T)
  float* w;                 // (B,T,S)
  TN* n_edge;               // (B,T,A) bf16 or f32
  float* w_edge;            // (B,T,A)
};

// x[k] for a k that is the same in every lane: a select, not a local-memory
// index.
// An edge count as f32, and its store, in its storage type.
__device__ __forceinline__ float count_of(const __nv_bfloat16& x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float count_of(const float& x) { return x; }
__device__ __forceinline__ void set_count(__nv_bfloat16& x, float v) {
  x = __float2bfloat16(v);
}
__device__ __forceinline__ void set_count(float& x, float v) { x = v; }

__device__ __forceinline__ float seat_of(const float (&x)[kMaxSeats], int k) {
  float out = x[0];
#pragma unroll
  for (int s = 1; s < kMaxSeats; ++s) out = k == s ? x[s] : out;
  return out;
}

template <bool kDense, typename TN>
__device__ __forceinline__ void backup_env(const Args<TN>& a) {
  constexpr int G = kGroup;
  extern __shared__ int32_t par_rows[];
  const float* __restrict__ v = a.v;
  const uint8_t* __restrict__ terminal = a.terminal;
  const float* __restrict__ rewards = a.rewards;
  const int T = a.T, S = a.S;
  const int gl = threadIdx.x % G;    // lane in the group
  const int slot = threadIdx.x / G;  // the group's env in the block
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x / G) + slot;
  if (b - (int64_t)((threadIdx.x % kWarp) / G) >= a.B) return;  // the warp's first env
  const bool valid = b < a.B;
  const int64_t env = (valid ? b : 0) * T;
  int32_t* par = par_rows + (int64_t)slot * T;

  // 1. the leaf, its value and the parents row, all in flight together
  int cur = valid ? __ldg(a.leaves + b) : -1;
  if ((unsigned)cur >= (unsigned)T) cur = -1;
  float val[kMaxSeats];
#pragma unroll
  for (int s = 0; s < kMaxSeats; ++s) {
    val[s] = cur >= 0 && s < S ? __ldg(v + (env + cur) * S + s) : 0.f;
  }
  for (int t = gl; t < T; t += G) par[t] = valid ? __ldg(a.parents + env + t) : -1;
  __syncwarp();

  for (int level = 0; __any_sync(kFull, cur >= 0); level += G) {
    // 2. the next G levels of the chain; lane gl keeps level + gl's node
    int node = -1;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (gl == i) node = cur;
      if (cur >= 0) {
        const int p = par[cur];
        // node ids strictly decrease towards the root: at most T levels
        cur = (unsigned)p < (unsigned)T && level + i + 1 < T ? p : -1;
      }
    }

    // 3. one round of independent gathers for this lane's node
    const bool on = node >= 0;
    const int64_t c = env + (on ? node : 0);
    const bool term = on && __ldg(terminal + c) != 0;
    float rew[kMaxSeats], w_old[kMaxSeats];
#pragma unroll
    for (int s = 0; s < kMaxSeats; ++s) {
      rew[s] = on && s < S ? __ldg(rewards + c * S + s) : 0.f;
      w_old[s] = on && s < S ? a.w[c * S + s] : 0.f;
    }
    const int n_old = on ? a.n[c] : 0;
    const int p = on ? par[node] : -1;
    const int rel = (unsigned)p < (unsigned)T ? max(__ldg(a.relation + c), 0) : a.A;
    const bool edge_on = rel < a.A;
    const int seat = edge_on ? __ldg(a.seats + env + p) : 0;
    // the parent edge's statistics, read while step 4 runs
    const int64_t e = (env + (edge_on ? p : 0)) * a.A + (edge_on ? rel : 0);
    const float ne_old = edge_on ? count_of(a.n_edge[e]) : 0.f;
    const float we_old = edge_on ? a.w_edge[e] : 0.f;

    // 4. the values, level by level in the twin's order, from the lane that
    //    holds each level to its group; `count` bounds the levels any group
    //    of the warp has in this round
    const int count = __reduce_max_sync(kFull, on ? gl + 1 : 0);
    float mine[kMaxSeats];
#pragma unroll
    for (int s = 0; s < kMaxSeats; ++s) mine[s] = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i < count) {
#pragma unroll
        for (int s = 0; s < kMaxSeats; ++s) {
          if (s < S) val[s] = __shfl_sync(kFull, (term ? 0.f : val[s]) + rew[s], i, G);
        }
        if (gl == i) {
#pragma unroll
          for (int s = 0; s < kMaxSeats; ++s) mine[s] = val[s];
        }
      }
    }

    // 5. every write of this lane's level
    if (on) {
      a.n[c] = n_old + a.npv;
#pragma unroll
      for (int s = 0; s < kMaxSeats; ++s) {
        if (s < S) a.w[c * S + s] = w_old[s] + mine[s];
      }
    }
    if (edge_on) {
      const float edge_val = kDense ? (seat == 0 ? mine[0] : seat_of(mine, S - 1))
                                    : seat_of(mine, min(max(seat, 0), S - 1));
      set_count(a.n_edge[e], ne_old + (float)a.npv);
      a.w_edge[e] = we_old + edge_val;
    }
  }
}

// The launch of kGroup-lane groups: as many warps a block (up to 8) as fit
// the parents rows in the default 48 KB of shared memory, at least one;
// above that the block opts in to more, up to the card's 227 KB.
template <class Kernel, typename TN>
inline int launch(Kernel kernel, const Args<TN>& a, cudaStream_t stream) {
  constexpr int G = kGroup;
  if (a.S < 1 || a.S > kMaxSeats || a.T < 1 || a.A < 1 || a.B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t per_warp = (size_t)(kWarp / G) * a.T * sizeof(int32_t);
  if (per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int warps = (int)std::min<size_t>(kMaxWarpsPerBlock,
                                          std::max<size_t>(1, kDefaultSmem / per_warp));
  const size_t smem = warps * per_warp;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int envs_per_block = warps * (kWarp / G);
  const int blocks = (int)((a.B + (int64_t)envs_per_block - 1) / envs_per_block);
  if (blocks > 0) {
    void* params[] = {(void*)&a};
    const cudaError_t err = cudaLaunchKernel((const void*)kernel, dim3(blocks),
                                             dim3(warps * kWarp), params, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace backup_walk
