// One Hex step per board: the stone, the win test, the edge flood and the
// auto-reset, for every board of a batch in one launch.
//
// Replaces no Pallas kernel. The JAX package steps Hex in plain XLA
// (boardlaw_tpu/envs/hex.py, the flood a `lax.while_loop`), and so does the
// port's plain twin, boardlaw_tpu_torch/envs/hex.py `step_reference`
// (`_step_boards`, `_flood`): some sixty elementwise launches a step, and a
// flood of dilations whose fixpoint test waits for the host once every four.
// Here each board is stepped by one thread, the flood run to its fixpoint on
// the device; the host waits for nothing.
//
// What bounds it on the H100: bytes. A board is S*S bytes read and written,
// with its seat, its action, two f32 rewards and a terminal flag: 187 bytes
// at 9x9 with int64 actions, against a few hundred integer operations. The
// design moves each byte once, coalesced:
// * a block of kThreads threads steps a contiguous tile of kThreads boards.
//   A board of 81 bytes read a thread a board would scatter a warp's loads
//   over 81-byte strides, so the tile (kThreads*S*S bytes, a multiple of 16)
//   is staged into shared memory with 16-byte loads, neighbouring threads on
//   neighbouring words, and written back from there the same way;
// * each thread steps its board in shared memory. Its flood holds the
//   mover's plain stones and the frontier as S row bitmasks in registers
//   (bit c of row r is cell (r, c)): a hex dilation of row r is
//   f[r] | f[r]<<1 | f[r]>>1 | f[r-1] | f[r-1]>>1 | f[r+1] | f[r+1]<<1,
//   masked by the row's stones, swept down and up the rows in place until a
//   sweep changes nothing. S is a template parameter (1 to kMaxSize), so the
//   rows stay in registers;
// * seats, actions, rewards and terminal flags are read and written a thread
//   a board, which is coalesced as it is.
//
// Semantics are integer logic, bit-exact with the twin:
// * a flat action is in the mover's frame: black (seat 0) plays cell
//   (a / S, a % S), any other seat (a % S, a / S), with floor division and
//   the divisor's sign of remainder (int64 actions are cut to int32 first).
//   An action outside [0, S*S) places nothing and reads no neighbour;
// * the six neighbour labels are read before the stone is placed; off the
//   board they are the virtual edge ring: TOP above and BOT below over the
//   full width (the corners included), LEFT and RIGHT at the sides;
// * black wins when a neighbour is TOP and one is BOT, white when one is LEFT
//   and one is RIGHT; black's reward is (black ? 1 : -1) * win in f32, signed
//   zeros as that product gives them, white's its negation;
// * the new label is the first edge label found (TOP before BOT, LEFT before
//   RIGHT), else the plain stone. Where it is an edge label, the placed
//   stone's 6-connected group of cells holding exactly the plain stone is
//   relabelled: cells already labelled block the flood. The fixpoint is that
//   group whatever the order of the sweeps, since dilation masked by the
//   stones is monotone;
// * with `reset`, a win clears the board and gives black (seat 0) the move
//   and is flagged terminal; otherwise the seat becomes 1 - seat and no board
//   is terminal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // boards a block, a thread each
constexpr int kMaxSize = 11;   // the largest board; kernels.HEX_MAX_SIZE

enum : uint8_t { kEmpty = 0, kBlack = 1, kWhite = 2, kTop = 3, kBot = 4, kLeft = 5, kRight = 6 };

struct Args {
  const uint8_t* board;  // (B, S, S)
  const int32_t* seats;  // (B,)
  const void* actions;   // (B,) int32 or int64
  int64_t B;
  int reset;
  uint8_t* out_board;    // (B, S, S)
  int32_t* out_seats;    // (B,)
  float2* rewards;       // (B,) pairs: black's, white's
  bool* terminal;        // (B,)
};

// n bytes from src to dst by the whole block: 16-byte words where both
// addresses allow it (a tile always starts on a multiple of 16 bytes from
// the tensor's start), bytes for the rest.
__device__ __forceinline__ void copy_tile(uint8_t* dst, const uint8_t* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int words = n / 16;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      reinterpret_cast<uint4*>(dst)[w] = reinterpret_cast<const uint4*>(src)[w];
    }
    done = words * 16;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// The label at (r, c), with the virtual edge ring off the board.
template <int S>
__device__ __forceinline__ int label_at(const uint8_t* cells, int r, int c) {
  if (r < 0) return kTop;
  if (r >= S) return kBot;
  if (c < 0) return kLeft;
  if (c >= S) return kRight;
  return cells[r * S + c];
}

// Relabel with `label` the 6-connected group of `stone` cells that holds
// (row, col).
template <int S>
__device__ __forceinline__ void flood(uint8_t* cells, int row, int col, uint8_t stone,
                                      uint8_t label) {
  uint32_t own[S], f[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    uint32_t m = 0;
#pragma unroll
    for (int c = 0; c < S; ++c) m |= (uint32_t)(cells[r * S + c] == stone) << c;
    own[r] = m;
    f[r] = r == row ? 1u << col : 0u;  // no dynamic index: the rows stay in registers
  }
  bool grew = true;
  while (grew) {
    grew = false;
#pragma unroll
    for (int i = 0; i < 2 * S; ++i) {  // down the rows, then up
      const int r = i < S ? i : 2 * S - 1 - i;
      uint32_t x = f[r] | f[r] << 1 | f[r] >> 1;
      if (r > 0) x |= f[r - 1] | f[r - 1] >> 1;
      if (r + 1 < S) x |= f[r + 1] | f[r + 1] << 1;
      x &= own[r];
      grew |= x != f[r];
      f[r] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < S; ++r) {
#pragma unroll
    for (int c = 0; c < S; ++c) {
      if (f[r] >> c & 1u) cells[r * S + c] = label;
    }
  }
}

template <int S, typename TA>
__global__ void __launch_bounds__(kThreads) hex_step_kernel(Args a) {
  constexpr int N = S * S;
  __shared__ uint4 tile_words[(kThreads * N + 15) / 16];
  uint8_t* tile = reinterpret_cast<uint8_t*>(tile_words);

  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int n_boards = (int)min((int64_t)kThreads, a.B - first);
  copy_tile(tile, a.board + first * N, n_boards * N);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < n_boards) {
    const int64_t b = first + t;
    uint8_t* cells = tile + t * N;
    const int32_t seat = a.seats[b];
    const int32_t action = (int32_t)static_cast<const TA*>(a.actions)[b];
    const bool black = seat == 0;
    int32_t q = action / S, m = action % S;
    if (m < 0) {  // floor division, a remainder of the divisor's sign
      m += S;
      q -= 1;
    }
    const int row = black ? q : m;
    const int col = black ? m : q;
    const bool placed = 0 <= row && row < S && 0 <= col && col < S;

    bool top = false, bot = false, left = false, right = false;
    if (placed) {  // the six neighbours: envs/hex.py NEIGHBOURS
      const int v[6] = {label_at<S>(cells, row - 1, col), label_at<S>(cells, row - 1, col + 1),
                        label_at<S>(cells, row, col - 1), label_at<S>(cells, row, col + 1),
                        label_at<S>(cells, row + 1, col - 1), label_at<S>(cells, row + 1, col)};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        top |= v[k] == kTop;
        bot |= v[k] == kBot;
        left |= v[k] == kLeft;
        right |= v[k] == kRight;
      }
    }
    const bool win = black ? top && bot : left && right;
    const float black_reward = (black ? 1.0f : -1.0f) * (win ? 1.0f : 0.0f);
    const uint8_t stone = black ? kBlack : kWhite;
    const uint8_t label = black ? (top ? kTop : bot ? kBot : kBlack)
                                : (left ? kLeft : right ? kRight : kWhite);
    if (placed) {
      cells[row * S + col] = stone;
      if (label != stone) flood<S>(cells, row, col, stone, label);
    }
    const bool done = a.reset && win;
    if (done) {
      for (int i = 0; i < N; ++i) cells[i] = kEmpty;
    }
    a.out_seats[b] = done ? 0 : (int32_t)(1u - (uint32_t)seat);
    a.rewards[b] = make_float2(black_reward, -black_reward);
    a.terminal[b] = done;
  }
  __syncthreads();
  copy_tile(a.out_board + first * N, tile, n_boards * N);
}

template <int S>
cudaError_t launch(const Args& a, int actions_i64, cudaStream_t st) {
  const unsigned blocks = (unsigned)((a.B + kThreads - 1) / kThreads);
  if (actions_i64) {
    hex_step_kernel<S, int64_t><<<blocks, kThreads, 0, st>>>(a);
  } else {
    hex_step_kernel<S, int32_t><<<blocks, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// board (B,S,S) uint8, seats (B,) int32, actions (B,) int32 (actions_i64 0)
// or int64 (1), all contiguous; writes out_board (B,S,S) uint8, out_seats
// (B,) int32, rewards (B,2) f32 and terminal (B,) bool. Returns a CUDA error
// code, cudaErrorInvalidValue for a size outside 1 to kMaxSize.
extern "C" int hex_step_launch(const void* board, const void* seats, const void* actions,
                               int actions_i64, long long B, int S, int reset, void* out_board,
                               void* out_seats, void* rewards, void* terminal, void* stream) {
  if (B < 0 || S < 1 || S > kMaxSize) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{(const uint8_t*)board, (const int32_t*)seats, actions, (int64_t)B, reset,
               (uint8_t*)out_board, (int32_t*)out_seats, (float2*)rewards, (bool*)terminal};
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return (int)launch<1>(a, actions_i64, st);
    case 2: return (int)launch<2>(a, actions_i64, st);
    case 3: return (int)launch<3>(a, actions_i64, st);
    case 4: return (int)launch<4>(a, actions_i64, st);
    case 5: return (int)launch<5>(a, actions_i64, st);
    case 6: return (int)launch<6>(a, actions_i64, st);
    case 7: return (int)launch<7>(a, actions_i64, st);
    case 8: return (int)launch<8>(a, actions_i64, st);
    case 9: return (int)launch<9>(a, actions_i64, st);
    case 10: return (int)launch<10>(a, actions_i64, st);
    default: return (int)launch<11>(a, actions_i64, st);
  }
}
