// Root->leaf pointer chase of the K-leaf search, one thread per walk.
//
// Replaces: boardlaw_tpu/mcts/pallas_kernels.py:walk (_walk_kernel), the
// Pallas kernel that chases every (k, b) row over the per-node sampled
// actions `acts` and child pointers `nxt` until the sampled child is
// unexpanded (-1) or terminal. Plain twin: boardlaw_tpu_torch/mcts/kernels.py
// walk_ref (search._walk).
//
// What bounds it on the H100: memory latency and sectors, not arithmetic.
// Each level of a walk reads acts[t], nxt[t] (4 bytes each) and
// terminal[nxt[t]] (1 byte) at data-dependent addresses, and the next level
// cannot start before nxt[t] arrives: a walk of depth d is d dependent
// round trips to memory, and every useful 4-byte read costs a whole 32-byte
// sector. The useful bytes are about 9 per visited level plus (L+3)*4 bytes
// of output per row; at 262,144 rows and a handful of levels that is a few
// tens of MB, a bound of some microseconds at 3.35 TB/s.
//
// What the simple design does about it: one thread per row gives 262,144
// independent chains in flight, so the card hides the latency of one chain
// behind the others; a row's path is written once per level and its tail
// filled with -1. Loads go through the read-only path (__ldg). Coalescing
// the path writes and fusing the walk into the sampler is later work.
//
// Semantics are pure integer logic and bit-exact with walk_ref: the halting
// leaf is not recorded in `path`; `parents` starts at 0 and `actions` at -1;
// a terminal root leaves the row inactive.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void walk_kernel(const int32_t* __restrict__ acts,
                            const int32_t* __restrict__ nxt,
                            const uint8_t* __restrict__ terminal,
                            int N, int B, int T, int term_stride, int L,
                            int32_t* __restrict__ parents,
                            int32_t* __restrict__ actions,
                            int32_t* __restrict__ halt_child,
                            int32_t* __restrict__ path) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const int b = r % B;
  const int32_t* a_row = acts + (int64_t)r * T;
  const int32_t* n_row = nxt + (int64_t)r * T;
  const uint8_t* term = terminal + (int64_t)b * term_stride;
  int32_t* p_row = path + (int64_t)r * L;

  bool active = __ldg(term) == 0;
  int t = 0, parent = 0, action = -1, halt = -1;
  int level = 0;
  for (; level < L && active; ++level) {
    const int a_t = __ldg(a_row + t);
    const int c_t = __ldg(n_row + t);
    const bool h = (c_t < 0) || (c_t < T && __ldg(term + c_t) != 0);
    parent = t;
    action = a_t;
    p_row[level] = t;
    if (h) {
      halt = c_t;
      active = false;
    } else {
      t = c_t;
    }
  }
  for (; level < L; ++level) p_row[level] = -1;
  parents[r] = parent;
  actions[r] = action;
  halt_child[r] = halt;
}

extern "C" int walk_launch(const void* acts, const void* nxt, const void* terminal,
                           int N, int B, int T, int term_stride, int L,
                           void* parents, void* actions, void* halt_child, void* path,
                           void* stream) {
  const int threads = 256;
  const int blocks = (N + threads - 1) / threads;
  if (blocks > 0) {
    walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)acts, (const int32_t*)nxt, (const uint8_t*)terminal,
        N, B, T, term_stride, L, (int32_t*)parents, (int32_t*)actions,
        (int32_t*)halt_child, (int32_t*)path);
  }
  return (int)cudaGetLastError();
}
