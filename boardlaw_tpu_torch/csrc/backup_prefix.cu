// The K>1 prefix backup: one pass's K recorded walks per env, added to n, w,
// n_edge and w_edge in place in one launch; one lane group per env.
//
// Replaces: no Pallas kernel. The JAX package backs up a K>1 pass in plain
// XLA (boardlaw_tpu/mcts/search.py backup_paths_prefix, one-hot
// contractions). The plain twin, boardlaw_tpu_torch/mcts/search.py
// backup_paths_prefix, scatters the K*B*L path entries with six accumulating
// index_put_ calls; on the card each sorts its indices (cub's radix sort),
// and the call launches some 220 kernels a pass.
//
// What it computes, the twin's prefix identity: with P = prew and
// C_k = (terminal[leaf_k] ? 0 : v[leaf_k]) + P[leaf_k] (S seats), for every
// node t that walk k passes (its path entries) or ends at (leaf_k),
//   n[t] += npv * cnt(t),  w[t] += sumC(t) - cnt(t) * (P[t] - rewards[t]),
// cnt and sumC the count and the sum of C_k over those walks; and for every
// edge (t, a = acts[k, t]) that walk k takes from a path node t,
//   n_edge[t, a] += npv,   w_edge[t, a] += C_k[seat(t)] - P[t, seat(t)].
//
// Order: the twin's scatters add an address's entries in walk order,
// k = 0..K-1 (on the card index_put_ sorts them stably; on the CPU it runs
// them one after another): cnt and sumC start at 0 and w takes their result
// in one add. For w_edge the two differ: the CPU adds each walk's term to
// w_edge in turn, the card sums an edge's entries in one warp (`edge_sum`)
// and adds the sum once. The kernel makes the card's adds: each node and
// each edge has one owner lane, which adds in that order with
// __fadd_rn/__fsub_rn/__fmul_rn, so nothing is contracted. n, w, n_edge and
// w_edge equal the twin's on the card bit for bit (the benchmark's plain
// reference runs those torch ops there), n, w and n_edge the CPU's, and
// two launches on one input are bit-equal (no atomics).
//
// What it takes of its input, as `walk` and the expansion make it: a node of
// an env lies at one level of every path that holds it (its depth: the
// tree's child pointers form a tree), and no leaf is a path node (a leaf is a
// new slot or a terminal child; a walk steps only into expanded non-terminal
// nodes). Node ids, leaves and actions outside the tree are skipped, never
// read or written.
//
// What bounds it on the H100: the latency of scattered sectors, not bytes.
// Per node a pass reaches it needs 12 + 16S bytes (n and w read and
// written, prew, rewards, the seat), per edge 8 plus twice n_edge's size
// (n_edge and w_edge read and written), 4 per path slot and 4 per path
// entry's action, and per walk 5 + 8S (its leaf, terminal flag, v and
// prew): 45 MB at 32,768 envs on the 64-node search's last pass, 0.0135 ms
// at 3.35 TB/s, where the kernel takes about 0.20 ms (chip_smoke.py phase 3
// counts and times it).
//
// What the design does about it: G lanes hold an env, 32/G envs a warp, up
// to 8 warps a block. The env's paths (level-major), their actions, the
// leaves and C_k sit in shared memory, so the owner tests and the sums read
// no device memory. Lane i takes the env's path entries i, i + G, ...: the
// first entry of its level that holds node t owns the node, the first that
// holds (t, a) owns the edge; each owner gathers its rows at once and sums
// the level's later entries in walk order (an edge's as `edge_sum` says:
// in order, or at 32 entries and more in the card scatter's warp tree,
// which only the root's edges reach at K = 8). The leaves are owned the same
// way, the first walk that ends at a leaf owning it. Nothing dense is
// allocated, zeroed or scattered.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSeats = 4;
// The lane group's width: 16 lanes take two levels of K = 8 walks a round.
constexpr int kGroup = 16;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kThreads = kMaxWarpsPerBlock * kWarp;
// shared memory a block uses without opting in, and the most it may opt in to
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename TN>
struct Args {
  const int32_t* paths;     // (K,B,L) the walks' interior nodes, -1 padded
  const int32_t* acts;      // (K,B,R) a view: strides sK, sB, 1
  const int32_t* leaves;    // (K,B)
  const float* v;           // (B,T,S)
  const float* prew;        // (B,T,S)
  const uint8_t* terminal;  // (B,T) bool
  const float* rewards;     // (B,T,S)
  const int32_t* seats;     // (B,T)
  int64_t sK, sB;
  int B, T, A, S, K, L, R, npv;
  int32_t* n;               // (B,T)
  float* w;                 // (B,T,S)
  TN* n_edge;               // (B,T,A) bf16 or f32
  float* w_edge;            // (B,T,A)
};

// 32-bit words of shared memory an env takes: its paths and their actions
// (level-major), its leaves and their C_k
__host__ __device__ inline int env_words(int K, int L, int S) { return 2 * K * L + K + K * S; }

__device__ __forceinline__ float count_of(const __nv_bfloat16& x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float count_of(const float& x) { return x; }
__device__ __forceinline__ void set_count(__nv_bfloat16& x, float v) {
  x = __float2bfloat16(v);
}
__device__ __forceinline__ void set_count(float& x, float v) { x = v; }

// n[c] += npv * cnt, w[c] += sum - cnt * (prew[c] - rewards[c]): the twin's
// node update, in its association
template <typename TN>
__device__ __forceinline__ void add_node(const Args<TN>& a, int64_t c, float cnt,
                                         const float (&sum)[kMaxSeats]) {
  a.n[c] += (int)cnt * a.npv;
#pragma unroll
  for (int s = 0; s < kMaxSeats; ++s) {
    if (s < a.S) {
      const int64_t i = c * a.S + s;
      const float pex = __fsub_rn(__ldg(a.prew + i), __ldg(a.rewards + i));
      a.w[i] = __fadd_rn(a.w[i], __fsub_rn(sum[s], __fmul_rn(cnt, pex)));
    }
  }
}

// The padded slots of walk k's path (-1 past its halting depth), which the
// twin's scatter sends, as zeros, to the edge of the walk's root action.
__device__ __forceinline__ int padded(const int32_t* path, int K, int L, int k) {
  int n = 0;
  for (int l = 0; l < L; ++l) n += path[l * K + k] < 0;
  return n;
}

// The pass's sum for the edge (t, a) that the walks from entry k0 of its
// level take, in the association of the twin's scatter on the card. There
// index_put_ sorts the entries stably by address, so an edge's entries keep
// walk order (at a root edge each walk's entry is followed by its padded
// slots' zeros), and one warp sums an edge's n entries from 0: lane j the
// positions j, j + 32, ... below 32 * (n / 32), in order, then a shuffle
// tree over the lanes, then the positions past them in order; under 32
// entries, all in order. It adds the sum to w_edge in one add.
__device__ float edge_sum(const int32_t* path, const int32_t* act, const float* C, int K, int L,
                          int S, int row, int k0, int t, int ai, int seat, float p) {
  int n = 0;
  for (int j = k0; j < K; ++j) {
    if (path[row + j] == t && act[row + j] == ai) n += 1 + (t == 0 ? padded(path, K, L, j) : 0);
  }
  const int whole = n - n % kWarp;
  float sum = 0.f;
  int pos = 0;
  if (whole > 0) {
    float lane[kWarp];
    for (int i = 0; i < kWarp; ++i) lane[i] = 0.f;
    for (int j = k0; j < K && pos < whole; ++j) {
      if (path[row + j] != t || act[row + j] != ai) continue;
      lane[pos % kWarp] = __fadd_rn(lane[pos % kWarp], __fsub_rn(C[j * S + seat], p));
      pos += 1 + (t == 0 ? padded(path, K, L, j) : 0);
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      for (int i = 0; i < off; ++i) lane[i] = __fadd_rn(lane[i], lane[i + off]);
    }
    sum = lane[0];
  }
  pos = 0;
  for (int j = k0; j < K; ++j) {
    if (path[row + j] != t || act[row + j] != ai) continue;
    if (pos >= whole) sum = __fadd_rn(sum, __fsub_rn(C[j * S + seat], p));
    pos += 1 + (t == 0 ? padded(path, K, L, j) : 0);
  }
  return sum;
}

template <typename TN>
__global__ void __launch_bounds__(kThreads) backup_prefix_kernel(const Args<TN> a) {
  constexpr int G = kGroup;
  extern __shared__ int32_t smem[];
  const int K = a.K, L = a.L, S = a.S, T = a.T, KL = a.K * a.L;
  const int gl = threadIdx.x % G;    // lane in the group
  const int slot = threadIdx.x / G;  // the group's env in the block
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x / G) + slot;
  if (b - (int64_t)((threadIdx.x % kWarp) / G) >= a.B) return;  // the warp's first env
  const bool valid = b < a.B;
  const int64_t env = (valid ? b : 0) * T;
  int32_t* path = smem + (int64_t)slot * env_words(K, L, S);  // [level][k]
  int32_t* act = path + KL;                                    // [level][k]
  int32_t* leaf = act + KL;                                    // [k]
  float* C = reinterpret_cast<float*>(leaf + K);               // [k][seat]

  // 1. the paths, level-major, and the leaves with their C_k
  for (int i = gl; i < KL; i += G) {
    const int k = i / L, l = i - k * L;
    int t = valid ? __ldg(a.paths + ((int64_t)k * a.B + b) * L + l) : -1;
    path[l * K + k] = (unsigned)t < (unsigned)T ? t : -1;
  }
  for (int k = gl; k < K; k += G) {
    int t = valid ? __ldg(a.leaves + (int64_t)k * a.B + b) : -1;
    t = (unsigned)t < (unsigned)T ? t : -1;
    leaf[k] = t;
    const int64_t c = env + (t >= 0 ? t : 0);
    const bool term = t >= 0 && __ldg(a.terminal + c) != 0;
    for (int s = 0; s < S; ++s) {
      C[k * S + s] = t >= 0 ? __fadd_rn(term ? 0.f : __ldg(a.v + c * S + s),
                                        __ldg(a.prew + c * S + s))
                            : 0.f;
    }
  }
  __syncwarp();

  // 2. the action each walk takes at each of its path nodes
  for (int i = gl; i < KL; i += G) {
    const int t = path[i];
    act[i] = t >= 0 && t < a.R ? __ldg(a.acts + (i % K) * a.sK + b * a.sB + t) : -1;
  }
  __syncwarp();

  // 3. the path entries' owners: node t's is the first entry of its level
  //    that holds t, edge (t, a)'s the first that holds both; each sums the
  //    level's later entries in walk order
  for (int i = gl; i < KL; i += G) {
    const int t = path[i];
    if (t < 0) continue;
    const int k = i % K, row = i - k;
    const int ai = act[i];
    bool node_owner = true;
    bool edge_owner = (unsigned)ai < (unsigned)a.A;
    for (int j = 0; j < k; ++j) {
      if (path[row + j] == t) {
        node_owner = false;
        edge_owner = edge_owner && act[row + j] != ai;
      }
    }
    const int64_t c = env + t;
    if (node_owner) {
      float cnt = 0.f;
      float sum[kMaxSeats] = {0.f, 0.f, 0.f, 0.f};
      for (int j = k; j < K; ++j) {
        if (path[row + j] != t) continue;
        cnt = __fadd_rn(cnt, 1.f);
#pragma unroll
        for (int s = 0; s < kMaxSeats; ++s) {
          if (s < S) sum[s] = __fadd_rn(sum[s], C[j * S + s]);
        }
      }
      add_node(a, c, cnt, sum);
    }
    if (edge_owner) {
      const int seat = min(max(__ldg(a.seats + c), 0), S - 1);
      const float p = __ldg(a.prew + c * S + seat);
      const int64_t e = c * a.A + ai;
      int visits = 0;
      for (int j = k; j < K; ++j) visits += path[row + j] == t && act[row + j] == ai;
      set_count(a.n_edge[e], __fadd_rn(count_of(a.n_edge[e]), (float)(visits * a.npv)));
      a.w_edge[e] = __fadd_rn(a.w_edge[e], edge_sum(path, act, C, K, L, S, row, k, t, ai, seat, p));
    }
  }

  // 4. the leaves' owners: leaf t's is the first walk that ends at t
  for (int k = gl; k < K; k += G) {
    const int t = leaf[k];
    if (t < 0) continue;
    bool owner = true;
    for (int j = 0; j < k; ++j) owner = owner && leaf[j] != t;
    if (!owner) continue;
    float cnt = 0.f;
    float sum[kMaxSeats] = {0.f, 0.f, 0.f, 0.f};
    for (int j = k; j < K; ++j) {
      if (leaf[j] != t) continue;
      cnt = __fadd_rn(cnt, 1.f);
#pragma unroll
      for (int s = 0; s < kMaxSeats; ++s) {
        if (s < S) sum[s] = __fadd_rn(sum[s], C[j * S + s]);
      }
    }
    add_node(a, env + t, cnt, sum);
  }
}

// As many warps a block (up to 8) as fit the envs' shared rows in the
// default 48 KB, at least one; above that the block opts in to more.
template <typename TN>
int launch_as(const Args<TN>& a, cudaStream_t stream) {
  constexpr int G = kGroup;
  if (a.S < 1 || a.S > kMaxSeats || a.T < 1 || a.A < 1 || a.B < 0 || a.K < 1 || a.L < 1 ||
      a.R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t per_warp = (size_t)(kWarp / G) * env_words(a.K, a.L, a.S) * sizeof(int32_t);
  if (per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int warps = (int)std::min<size_t>(kMaxWarpsPerBlock,
                                          std::max<size_t>(1, kDefaultSmem / per_warp));
  const size_t smem = warps * per_warp;
  const void* kernel = (const void*)backup_prefix_kernel<TN>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int envs_per_block = warps * (kWarp / G);
  const int blocks = (int)((a.B + (int64_t)envs_per_block - 1) / envs_per_block);
  if (blocks > 0) {
    void* params[] = {(void*)&a};
    const cudaError_t err =
        cudaLaunchKernel(kernel, dim3(blocks), dim3(warps * kWarp), params, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// counts_f32: n_edge is f32 (trees of more than 128 node slots), else bf16.
extern "C" int backup_prefix_launch(const void* paths, const void* acts, long long sK,
                                    long long sB, const void* leaves, const void* v,
                                    const void* prew, const void* terminal, const void* rewards,
                                    const void* seats, int B, int T, int A, int S, int K, int L,
                                    int R, int npv, void* n, void* w, void* n_edge,
                                    int counts_f32, void* w_edge, void* stream) {
  if (counts_f32) {
    const Args<float> a{(const int32_t*)paths, (const int32_t*)acts, (const int32_t*)leaves,
                        (const float*)v, (const float*)prew, (const uint8_t*)terminal,
                        (const float*)rewards, (const int32_t*)seats, sK, sB, B, T, A, S, K,
                        L, R, npv, (int32_t*)n, (float*)w, (float*)n_edge, (float*)w_edge};
    return launch_as(a, (cudaStream_t)stream);
  }
  const Args<__nv_bfloat16> a{(const int32_t*)paths, (const int32_t*)acts,
                              (const int32_t*)leaves, (const float*)v, (const float*)prew,
                              (const uint8_t*)terminal, (const float*)rewards,
                              (const int32_t*)seats, sK, sB, B, T, A, S, K, L, R, npv,
                              (int32_t*)n, (float*)w, (__nv_bfloat16*)n_edge, (float*)w_edge};
  return launch_as(a, (cudaStream_t)stream);
}
