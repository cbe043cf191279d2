// Root->leaf pointer chase of the search, K walks per env.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:walk (_walk_kernel), the
// Pallas kernel that chases every (k, b) row over the per-node sampled
// actions `acts` and child pointers `nxt` until the sampled child is
// unexpanded (-1) or terminal. Plain twin: boardlaw_tpu_torch/mcts/kernels.py
// walk_ref (search._walk).
//
// Inputs: acts, nxt as (K, B, R) int32 with a contiguous last axis and any K
// and B strides (the sampler's (B,K,R) buffer seen as (K,B,R), or N = K*B
// contiguous rows), terminal (B, R) bool rows at any env stride. Output: one
// packed int32 buffer, four k-major planes: parents, actions, halt_child
// (K*B each) and path (K*B, L).
//
// What bounds it on the H100: memory latency and sectors, not arithmetic. A
// level of a walk reads acts[t], nxt[t] and terminal[nxt[t]] at
// data-dependent addresses, and the next level cannot start before nxt[t]
// arrives: chased in device memory, a walk of depth d is d dependent round
// trips (2d with the terminal flag), each useful 4-byte read costs a 32-byte
// sector, and a row's path lies L*4 bytes from its neighbour's, so each
// level's store is a sector of its own.
//
// Three designs, one launcher; kernels.walk_design picks one per shape:
// * 'block' (walk_env_kernel<true>): a block holds E envs and copies each
//   env's K acts and nxt rows and its terminal row into shared memory with
//   coalesced asynchronous copies, then a thread per (k, env) row chases
//   there: a level costs a shared-memory load, not a round trip. It reads
//   every byte of the rows, visited or not, so it fits the K = 1 search
//   (rows of up to 64 nodes, walks up to 63 deep).
// * 'gather' (walk_env_kernel<false>): the same, with only the terminal rows
//   in shared memory (read once for all K walks of an env); the chase reads
//   acts[t] and nxt[t] in device memory, one round trip a level, and tests
//   the child against shared memory. It fits K = 8, whose walks are at most
//   a few levels deep over rows of up to 65 nodes.
// * 'chase' (walk_chase_kernel): a thread per row, all in device memory, the
//   first design; fastest only where every walk stops at the root.
// The env designs stage the visited nodes in shared memory and write each
// k's rows of the block's envs as one contiguous span of E*L int32 (the
// output is k-major), the -1 tail with them; parents, actions and halt_child
// as spans of E. Shared rows are padded to an odd stride, so that the rows a
// warp chases hit distinct banks at equal depth.
//
// Semantics are pure integer logic and bit-exact with walk_ref: the halting
// leaf is not recorded in `path`; `parents` starts at 0 and `actions` at -1;
// a terminal root leaves the row inactive. A child pointer at or beyond R
// (not a tree of R rows) halts the walk, so no read leaves a row.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The lanes an env gets for its copy, G, are set from its bytes: about
// kIntsPerLane of its 2*K*R acts and nxt ints a lane, a power of two from
// kMinGroup to kMaxGroup. E = kThreads / G envs a block (fewer where the
// rows do not fit in shared memory).
constexpr int kIntsPerLane = 16;
constexpr int kMinGroup = 4;
constexpr int kMaxGroup = 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Args {
  const int32_t* acts;
  const int32_t* nxt;
  const uint8_t* terminal;
  int K, B, R, L;
  int64_t sK, sB, term_stride;
  int32_t* out;  // parents, actions, halt_child (K*B each), path (K*B, L)
};

__host__ __device__ __forceinline__ int odd(int x) { return x | 1; }

// One row's walk over rows `ra`, `rn` and terminal row `term` (any memory).
// Records the visited nodes through `visit(level, node)`; returns the depth.
template <class Visit>
__device__ __forceinline__ int chase(const int32_t* ra, const int32_t* rn, const uint8_t* term,
                                     int R, int L, int& parent, int& action, int& halt,
                                     Visit visit) {
  bool active = term[0] == 0;
  int t = 0, level = 0;
  parent = 0;
  action = -1;
  halt = -1;
  for (; level < L && active; ++level) {
    const int a_t = ra[t];
    const int c_t = rn[t];
    parent = t;
    action = a_t;
    visit(level, t);
    if (c_t < 0 || c_t >= R || term[c_t] != 0) {
      halt = c_t;
      active = false;
    } else {
      t = c_t;
    }
  }
  return level;
}

// The env-block designs: E envs a block, their terminal rows read once into
// shared memory, a thread per (k, env) row chasing, the visited nodes staged
// in shared memory and written as k-major spans. kCopyRows: the rows too are
// copied to shared memory first ('block'); else the chase reads them in
// device memory, one round trip a level for acts[t] and nxt[t] together
// ('gather').
template <bool kCopyRows>
__global__ void __launch_bounds__(kThreads) walk_env_kernel(Args a, int E) {
  extern __shared__ int32_t smem[];
  const int K = a.K, R = a.R, L = a.L;
  const int64_t B = a.B;
  const int Rp = odd(R), Lp = odd(L), Rt = (R + 3) & ~3;
  const int rows = E * K;
  int32_t* s_path = smem;
  int32_t* s_depth = s_path + rows * Lp;
  int32_t* s_acts = s_depth + rows;
  int32_t* s_nxt = s_acts + rows * Rp;
  uint8_t* s_term = reinterpret_cast<uint8_t*>(kCopyRows ? s_nxt + rows * Rp : s_acts);
  const int64_t b0 = (int64_t)blockIdx.x * E;
  const int64_t left = B - b0;
  const int nE = left < E ? (int)left : E;
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. the block's rows ('block'), k by k, env by env, into shared memory:
  //    coalesced asynchronous 4-byte copies, all in flight before the wait;
  //    and the envs' terminal rows
  const int span = nE * R;
  if (kCopyRows) {
    for (int k = 0; k < K; ++k) {
      const int64_t base = k * a.sK + b0 * a.sB;
      for (int i = tid; i < span; i += nt) {
        const int e = i / R, t = i - e * R;
        const int64_t src = base + e * a.sB + t;
        const int dst = (k * E + e) * Rp + t;
        __pipeline_memcpy_async(s_acts + dst, a.acts + src, sizeof(int32_t));
        __pipeline_memcpy_async(s_nxt + dst, a.nxt + src, sizeof(int32_t));
      }
    }
    __pipeline_commit();
  }
  for (int i = tid; i < span; i += nt) {
    const int e = i / R, t = i - e * R;
    s_term[e * Rt + t] = __ldg(a.terminal + (b0 + e) * a.term_stride + t);
  }
  if (kCopyRows) __pipeline_wait_prior(0);
  __syncthreads();

  // 2. a thread per (k, env) row chases; parents, actions and halt_child go
  //    out as k-major spans (consecutive threads, consecutive rows)
  int32_t* parents = a.out;
  int32_t* actions = parents + K * B;
  int32_t* halts = actions + K * B;
  for (int j = tid; j < rows; j += nt) {
    const int k = j / E, e = j - k * E;
    if (e >= nE) continue;
    const int64_t row = k * a.sK + (b0 + e) * a.sB;
    const int32_t* ra = kCopyRows ? s_acts + j * Rp : a.acts + row;
    const int32_t* rn = kCopyRows ? s_nxt + j * Rp : a.nxt + row;
    int32_t* p_row = s_path + j * Lp;
    int parent, action, halt;
    s_depth[j] = chase(ra, rn, s_term + e * Rt, R, L, parent, action, halt,
                       [&](int level, int t) { p_row[level] = t; });
    const int64_t r = k * B + b0 + e;
    parents[r] = parent;
    actions[r] = action;
    halts[r] = halt;
  }
  if (L == 0) return;
  __syncthreads();

  // 3. the paths: k's rows of the block's envs are one span of nE*L int32
  int32_t* path = halts + K * B;
  const int plen = nE * L;
  for (int k = 0; k < K; ++k) {
    int32_t* dst = path + (k * B + b0) * L;
    for (int i = tid; i < plen; i += nt) {
      const int e = i / L, l = i - e * L;
      const int j = k * E + e;
      dst[i] = l < s_depth[j] ? s_path[j * Lp + l] : -1;
    }
  }
}

// The first design, a thread per row chasing in device memory.
__global__ void __launch_bounds__(kThreads) walk_chase_kernel(Args a) {
  const int64_t B = a.B, N = (int64_t)a.K * B;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const int64_t k = r / B, b = r - k * B;
  const int64_t off = k * a.sK + b * a.sB;
  int32_t* p_row = a.out + 3 * N + r * a.L;
  int parent, action, halt;
  int level = chase(a.acts + off, a.nxt + off, a.terminal + b * a.term_stride, a.R, a.L, parent,
                    action, halt, [&](int lv, int t) { p_row[lv] = t; });
  for (; level < a.L; ++level) p_row[level] = -1;
  a.out[r] = parent;
  a.out[N + r] = action;
  a.out[2 * N + r] = halt;
}

size_t env_smem(bool copy_rows, int E, int K, int R, int L) {
  const size_t rows = (size_t)E * K;
  return rows * ((copy_rows ? 2 * (size_t)odd(R) : 0) + odd(L) + 1) * sizeof(int32_t) +
         (size_t)E * ((R + 3) & ~3);
}

}  // namespace

// design 0: 'block', 1: 'chase', 2: 'gather' (kernels.WALK_DESIGNS).
extern "C" int walk_launch(const void* acts, const void* nxt, const void* terminal, int K, int B,
                           int R, long long sK, long long sB, long long term_stride, int L,
                           int design, void* out, void* stream) {
  if (K < 0 || B < 0 || R < 1 || L < 0 || L > R || design < 0 || design > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int32_t*)acts, (const int32_t*)nxt, (const uint8_t*)terminal, K, B, R, L,
               (int64_t)sK, (int64_t)sB, (int64_t)term_stride, (int32_t*)out};
  if ((int64_t)K * B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (design == 1) {
    const int64_t blocks = ((int64_t)K * B + kThreads - 1) / kThreads;
    walk_chase_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const bool copy_rows = design == 0;
  int E = 1;
  if (copy_rows) {  // G lanes an env for its copy
    int G = kMinGroup;
    while (G < kMaxGroup && G * kIntsPerLane < 2 * K * R) G *= 2;
    E = kThreads / G;
  } else {  // a thread a row
    while (2 * E * K <= kThreads) E *= 2;
  }
  while (E > 1 && env_smem(copy_rows, E, K, R, L) > kMaxSmem) E /= 2;
  const size_t smem = env_smem(copy_rows, E, K, R, L);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* kernel = copy_rows ? (const void*)walk_env_kernel<true>
                                 : (const void*)walk_env_kernel<false>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = ((int64_t)B + E - 1) / E;
  if (copy_rows) {
    walk_env_kernel<true><<<(unsigned)blocks, kThreads, smem, st>>>(a, E);
  } else {
    walk_env_kernel<false><<<(unsigned)blocks, kThreads, smem, st>>>(a, E);
  }
  return (int)cudaGetLastError();
}
