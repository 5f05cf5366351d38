// K1: fused agent actions + one cellular-automaton step + readback of each
// agent's post-advance cell.
//
// Replaces the Pallas kernel `fused_actions_advance` / `_physics_kernel`
// (`_actions_block`, `_advance_block`) in safelife_tpu/ops/physics.py:
// 178-350. Bound on the H100 by int32 operations (55 a cell for the CA step
// plus about 60 an agent, at 16.7 T a second) ahead of bytes (8 a cell:
// the board read once and written once, plus a few words an agent).
//
// A block takes `boards_per_block` consecutive boards, as K2 does
// (advance.cu): asynchronous 16-byte staging copies, then the actions, then
// the shared separable CA step of ca.cuh, then the readback and 16-byte
// stores.
//
// Actions: agents act strictly in index order (agent k sees agent k-1's
// writes), so one thread per board applies them one after another, and
// the boards of a block act in parallel. Each action reads and writes its
// four cells (agent, ahead, two ahead, behind) one at a time in the order
// of the reference's `agent_body` (safelife_tpu/core/actions.py:163-242),
// so on boards with min(H, W) < 4, where those cells can coincide, a write
// is seen by the later reads exactly as there; on larger boards the cells
// are distinct and the result equals the four-cell form. Coordinates are
// reduced to the board once an agent; its neighbours wrap by compare and
// add. After the CA step the same thread reads its agents' new cells.
#include <cuda_runtime.h>

#include "ca.cuh"

namespace {

using namespace sl;

// One agent's action on the board `s` (shared memory). (ly, lx) is its
// recorded location; writes its new location to (new_y, new_x).
__device__ void apply_action(int* s, int h, int w, int act, int ly, int lx,
                             int* new_y, int* new_x) {
  *new_y = ly;
  *new_x = lx;
  const int y0 = floor_mod(ly, h), x0 = floor_mod(lx, w);
  const int p0 = y0 * w + x0;
  int v0 = s[p0];
  if (act == 0 || !(v0 & AGENT)) return;

  // Two's complement: act 0 would give direction 3, as in the JAX code.
  const int dirn = (act - 1) & 3;
  const bool odd = (dirn & 1) == 1;
  const int dx = odd ? 2 - dirn : 0;
  const int dy = odd ? 0 : dirn - 1;
  const int y1 = wrap1(y0 + dy, h), x1 = wrap1(x0 + dx, w);
  const int p1 = y1 * w + x1;
  const int p2 = wrap1(y1 + dy, h) * w + wrap1(x1 + dx, w);
  const int p3 = wrap1(y0 - dy, h) * w + wrap1(x0 - dx, w);

  v0 = (v0 & ~ORIENTATION_MASK) | (dirn << ORIENTATION_BIT);
  s[p0] = v0;
  if (act >= 5) {  // toggle: create, destroy or shove
    const int v1 = s[p1];
    if (v1 == 0) {
      s[p1] = ALIVE | DESTRUCTIBLE | (v0 & COLORS);
    } else if (v1 & DESTRUCTIBLE) {
      s[p1] = (v1 & AGENT) ? ((v1 ^ (AGENT | DESTRUCTIBLE)) | FROZEN) : 0;
    } else if (~v0 & v1 & PUSHABLE) {
      const int v2 = s[p2];
      if (v2 == 0) {
        s[p2] = v1;
        s[p1] = 0;
      } else if (v2 & EXIT) {
        s[p1] = 0;
      }
    }
    return;
  }
  // move: push, walk, exit, then pull
  const int v1 = s[p1], v2 = s[p2];
  const bool push = (~v0 & v1 & PUSHABLE) != 0;
  const bool push_empty = push && v2 == 0;
  const bool push_exit = push && v2 != 0 && (v2 & EXIT);
  const bool empty = !push && v1 == 0;
  const bool exit_move = !push && !empty && (v0 & v1 & EXIT) && !(v1 & AGENT);
  const bool do_move = push_empty || push_exit || empty;
  if (!do_move && !exit_move) return;
  if (push_empty) s[p2] = v1;
  const int v0f = s[p0];  // the writes above may alias p0 on tiny boards
  if (do_move) s[p1] = v0f;
  const int v3 = s[p3];
  const bool pull = (~v0f & v3 & PULLABLE) != 0;
  s[p0] = pull ? v3 : 0;
  if (pull) s[p3] = 0;
  *new_y = y1;
  *new_x = x1;
}

__global__ void __launch_bounds__(1024)
    physics_kernel(const int* __restrict__ board,
                   const int* __restrict__ locs,
                   const int* __restrict__ actions,
                   const float* __restrict__ spawn_prob,
                   const int* __restrict__ seed, int* __restrict__ out_board,
                   int* __restrict__ out_locs, int* __restrict__ out_cells,
                   int batch, int h, int w, int n_agents,
                   int boards_per_block, int rows_per_thread,
                   int stochastic) {
  extern __shared__ __align__(16) int smem[];
  const int hw = h * w;
  const int lane0 = blockIdx.x * boards_per_block;
  const int nb = min(boards_per_block, batch - lane0);
  int* s = smem;
  uint32_t* q = reinterpret_cast<uint32_t*>(smem + boards_per_block * hw);

  stage_in(s, board + (size_t)lane0 * hw, nb * hw);
  __syncthreads();

  // One thread a board: its agents in order, then (below) their cells.
  const int b = threadIdx.x;
  const size_t first = (size_t)(lane0 + b) * n_agents;
  if (b < nb) {
    int* sb = s + b * hw;
    for (int k = 0; k < n_agents; ++k) {
      apply_action(sb, h, w, actions[first + k], locs[2 * (first + k)],
                   locs[2 * (first + k) + 1], &out_locs[2 * (first + k)],
                   &out_locs[2 * (first + k) + 1]);
    }
  }
  __syncthreads();

  ca_step_block(s, q, nb, h, w, rows_per_thread, lane0, stochastic != 0,
                (uint32_t)seed[0], (uint32_t)seed[1], spawn_prob);

  if (b < nb) {
    const int* sb = s + b * hw;
    for (int k = 0; k < n_agents; ++k) {
      // This thread wrote out_locs above; its own writes are visible.
      const int idx = out_locs[2 * (first + k)] * w +
                      out_locs[2 * (first + k) + 1];
      out_cells[first + k] = (idx >= 0 && idx < hw) ? sb[idx] : 0;
    }
  }
  store_out(out_board + (size_t)lane0 * hw, s, nb * hw);
}

}  // namespace

extern "C" int sl_fused_actions_advance(
    const void* board, const void* locs, const void* actions,
    const void* spawn_prob, const void* seed, void* out_board,
    void* out_locs, void* out_cells, int batch, int h, int w, int n_agents,
    int boards_per_block, int rows_per_thread, int threads, int stochastic,
    void* stream) {
  if (batch == 0) return 0;
  const int blocks = (batch + boards_per_block - 1) / boards_per_block;
  const size_t smem = (size_t)boards_per_block * h * w * SMEM_BYTES_PER_CELL;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        physics_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  physics_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)locs, (const int*)actions,
      (const float*)spawn_prob, (const int*)seed, (int*)out_board,
      (int*)out_locs, (int*)out_cells, batch, h, w, n_agents,
      boards_per_block, rows_per_thread, stochastic);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_fused_actions_advance_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
