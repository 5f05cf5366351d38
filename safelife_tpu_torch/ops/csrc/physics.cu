// K1: fused agent actions + one cellular-automaton step + readback of each
// agent's post-advance cell.
//
// Replaces the Pallas kernel `fused_actions_advance` / `_physics_kernel`
// (`_actions_block`, `_advance_block`) in safelife_tpu/ops/physics.py:
// 178-350. Bound on the H100 by int32 operations (55 a cell for the CA step
// plus about 60 an agent, at 16.7 T a second) ahead of bytes (8 a cell:
// the board read once and written once, plus a few words an agent).
//
// Boards of up to MAX_CELLS (ops/physics.py), `physics_kernel`: a block
// takes `boards_per_block` consecutive boards, as K2 does (advance.cu):
// asynchronous 16-byte staging copies, then the actions, then the shared
// separable CA step of ca.cuh, then the readback and 16-byte stores.
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
//
// Larger boards, `physics_tiled_kernel`: a block takes one tile of R x C
// cells of one board, as K2's tiled form does (grid: tiles x lanes;
// bound as above plus the halo's packs). One thread of every block of
// the board fetches the agents' actions and locations while the tile's
// staging copies fly; once the tile is staged, it fetches each agent's
// four cells of the input board and replays the agents in order through
// an overlay in shared memory (the writes so far, newest first, over the
// fetched cells), so every block derives the same writes, and reads see
// earlier writes on any board shape as the shared board above does. The
// replay runs while the block's other warps pack the tile, so its latency
// hides under the pack; the same thread then writes the agents' writes
// that fall in the staged tile, halo included, and packs those words
// again. After the CA step the block whose tile holds an agent's new
// location reads its cell, and tile 0 writes the new locations. No copy
// of the board goes through device memory, and every board is cut into
// enough tiles to fill the card.
#include <cuda_runtime.h>

#include "ca.cuh"

namespace {

using namespace sl;

// The board an action works on: `get` reads a cell (flat index), `set`
// writes one.
struct SharedBoard {  // a whole board staged in shared memory
  int* s;
  __device__ int get(int p) const { return s[p]; }
  __device__ void set(int p, int v) { s[p] = v; }
};

// At most this many writes an action: its orientation, then a move's
// push, step, vacated cell and pull.
constexpr int WRITES_PER_ACTION = 5;

// An action's four cells (flat indices): the agent's at its recorded
// location (ly, lx), the one ahead, two ahead and behind it in the
// direction of `act`, and the cell ahead as (y1, x1).
struct ActionCells {
  int p[4];
  int y1, x1;
};

__device__ __forceinline__ ActionCells action_cells(int h, int w, int act,
                                                    int ly, int lx) {
  const int y0 = floor_mod(ly, h), x0 = floor_mod(lx, w);
  // Two's complement: act 0 would give direction 3, as in the JAX code.
  const int dirn = (act - 1) & 3;
  const bool odd = (dirn & 1) == 1;
  const int dx = odd ? 2 - dirn : 0;
  const int dy = odd ? 0 : dirn - 1;
  ActionCells c;
  c.y1 = wrap1(y0 + dy, h);
  c.x1 = wrap1(x0 + dx, w);
  c.p[0] = y0 * w + x0;
  c.p[1] = c.y1 * w + c.x1;
  c.p[2] = wrap1(c.y1 + dy, h) * w + wrap1(c.x1 + dx, w);
  c.p[3] = wrap1(y0 - dy, h) * w + wrap1(x0 - dx, w);
  return c;
}

// A board's cells under the writes of its actions so far, kept in shared
// memory newest last: a cell no write has touched reads as the current
// agent's fetched copy (`cell`, its four cells of the input board).
struct OverlayBoard {
  int* pos;
  int* val;
  int n;
  const int* cell;
  ActionCells at;
  __device__ int get(int p) const {
    for (int i = n - 1; i >= 0; --i)
      if (pos[i] == p) return val[i];
    return p == at.p[0] ? cell[0]
           : p == at.p[1] ? cell[1]
           : p == at.p[2] ? cell[2]
                          : cell[3];
  }
  __device__ void set(int p, int v) {
    pos[n] = p;
    val[n] = v;
    ++n;
  }
};

// One agent's action on the board `s`: `act` at its cells `c`, from its
// recorded location (ly, lx); writes its new location to (new_y, new_x).
// Reads and writes only the cells `c.p`.
template <class Board>
__device__ void apply_action(Board& s, const ActionCells& c, int act,
                             int ly, int lx, int* new_y, int* new_x) {
  *new_y = ly;
  *new_x = lx;
  const int p0 = c.p[0], p1 = c.p[1], p2 = c.p[2], p3 = c.p[3];
  int v0 = s.get(p0);
  if (act == 0 || !(v0 & AGENT)) return;

  const int dirn = (act - 1) & 3;
  v0 = (v0 & ~ORIENTATION_MASK) | (dirn << ORIENTATION_BIT);
  s.set(p0, v0);
  if (act >= 5) {  // toggle: create, destroy or shove
    const int v1 = s.get(p1);
    if (v1 == 0) {
      s.set(p1, ALIVE | DESTRUCTIBLE | (v0 & COLORS));
    } else if (v1 & DESTRUCTIBLE) {
      s.set(p1, (v1 & AGENT) ? ((v1 ^ (AGENT | DESTRUCTIBLE)) | FROZEN) : 0);
    } else if (~v0 & v1 & PUSHABLE) {
      const int v2 = s.get(p2);
      if (v2 == 0) {
        s.set(p2, v1);
        s.set(p1, 0);
      } else if (v2 & EXIT) {
        s.set(p1, 0);
      }
    }
    return;
  }
  // move: push, walk, exit, then pull
  const int v1 = s.get(p1), v2 = s.get(p2);
  const bool push = (~v0 & v1 & PUSHABLE) != 0;
  const bool push_empty = push && v2 == 0;
  const bool push_exit = push && v2 != 0 && (v2 & EXIT);
  const bool empty = !push && v1 == 0;
  const bool exit_move = !push && !empty && (v0 & v1 & EXIT) && !(v1 & AGENT);
  const bool do_move = push_empty || push_exit || empty;
  if (!do_move && !exit_move) return;
  if (push_empty) s.set(p2, v1);
  const int v0f = s.get(p0);  // the writes above may alias p0 on tiny boards
  if (do_move) s.set(p1, v0f);
  const int v3 = s.get(p3);
  const bool pull = (~v0f & v3 & PULLABLE) != 0;
  s.set(p0, pull ? v3 : 0);
  if (pull) s.set(p3, 0);
  *new_y = c.y1;
  *new_x = c.x1;
}

// The agents of one board in order: agent k of the board whose first agent
// is `first` in the batch acts on the board `s` (shared memory).
__device__ void apply_actions(int* s, int h, int w, size_t first,
                              int n_agents, const int* __restrict__ actions,
                              const int* __restrict__ locs,
                              int* __restrict__ out_locs) {
  SharedBoard board{s};
  for (int k = 0; k < n_agents; ++k) {
    const size_t j = first + k;
    const int act = actions[j], ly = locs[2 * j], lx = locs[2 * j + 1];
    apply_action(board, action_cells(h, w, act, ly, lx), act, ly, lx,
                 &out_locs[2 * j], &out_locs[2 * j + 1]);
  }
}

// Each agent's cell of the advanced board `s`, at the location the same
// thread wrote in `apply_actions` (its own writes are visible to it).
__device__ void read_cells(const int* s, int hw, int w, size_t first,
                           int n_agents, const int* out_locs,
                           int* __restrict__ out_cells) {
  for (int k = 0; k < n_agents; ++k) {
    const size_t j = first + k;
    const int idx = out_locs[2 * j] * w + out_locs[2 * j + 1];
    out_cells[j] = (idx >= 0 && idx < hw) ? s[idx] : 0;
  }
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
                   int stochastic, int lane_offset) {
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
  if (b < nb)
    apply_actions(s + b * hw, h, w, first, n_agents, actions, locs, out_locs);
  __syncthreads();

  ca_step_block(s, q, nb, h, w, rows_per_thread, lane0, stochastic != 0,
                (uint32_t)seed[0], (uint32_t)seed[1], spawn_prob, lane_offset,
                0);

  if (b < nb) read_cells(s + b * hw, hw, w, first, n_agents, out_locs,
                         out_cells);
  store_out(out_board + (size_t)lane0 * hw, s, nb * hw);
}

// Shared words a tiled block keeps an agent: its action, recorded location
// and four fetched cells; for each of its writes (WRITES_PER_ACTION) the
// cell, the value and the staged row and column of the cell's first copy
// in the tile; its new location.
constexpr int TILE_WORDS_PER_AGENT = 7 + 4 * WRITES_PER_ACTION + 2;

// Thread 0 of a tiled block: the actions and recorded locations of the
// board's agents (first agent `first` in the batch) into `agent_in`.
__device__ void fetch_agents(size_t first, int n_agents,
                             const int* __restrict__ actions,
                             const int* __restrict__ locs, int* agent_in) {
  for (int k = 0; k < n_agents; ++k) {
    const size_t j = first + k;
    agent_in[7 * k] = actions[j];
    agent_in[7 * k + 1] = locs[2 * j];
    agent_in[7 * k + 2] = locs[2 * j + 1];
  }
}

// Thread 0 of a tiled block, after `fetch_agents`: each agent's four cells
// of the input board `g` (one round of reads for all agents), then the
// agents in order. Returns the number of writes, and leaves in shared
// memory each write's cell and value (`ov_pos`, `ov_val`), the staged row
// and column of its cell's first copy in tile `t` (`ov_k`, `ov_j`; a cell
// can be staged twice, or thrice when H or W is 1, where the halo wraps
// onto the tile: the others lie H rows or W columns further on) and the
// agents' new locations (`new_locs`).
__device__ int replay_agents(const int* g, const Tile& t, int h, int w,
                             int n_agents, int* agent_in, int* ov_pos,
                             int* ov_val, int* ov_k, int* ov_j,
                             int* new_locs) {
  for (int k = 0; k < n_agents; ++k) {
    int* in = agent_in + 7 * k;
    const ActionCells c = action_cells(h, w, in[0], in[1], in[2]);
    for (int i = 0; i < 4; ++i) in[3 + i] = g[c.p[i]];
  }
  OverlayBoard ob{ov_pos, ov_val, 0};
  for (int k = 0; k < n_agents; ++k) {
    const int* in = agent_in + 7 * k;
    ob.cell = in + 3;
    ob.at = action_cells(h, w, in[0], in[1], in[2]);
    apply_action(ob, ob.at, in[0], in[1], in[2], &new_locs[2 * k],
                 &new_locs[2 * k + 1]);
  }
  for (int i = 0; i < ob.n; ++i) {
    const int gy = ov_pos[i] / w, gx = ov_pos[i] - gy * w;
    ov_k[i] = floor_mod(gy - t.y0 + 1, h);
    ov_j[i] = floor_mod(gx - t.x0 + 1, w);
  }
  return ob.n;
}

// Grid: x over the tiles of a board, y over the lanes (looping when the
// batch exceeds the grid's 65,535 rows). Shared memory: the staged tile
// and its packed words, then TILE_WORDS_PER_AGENT words an agent.
// Registers are capped at K2's tiled form's count: left alone, the
// replay (one thread's cold code) raised the whole kernel's, and with it
// cut the blocks an SM holds.
__global__ void __maxnreg__(48)
    physics_tiled_kernel(const int* __restrict__ board,
                         const int* __restrict__ locs,
                         const int* __restrict__ actions,
                         const float* __restrict__ spawn_prob,
                         const int* __restrict__ seed,
                         int* __restrict__ out_board,
                         int* __restrict__ out_locs,
                         int* __restrict__ out_cells, int batch, int h,
                         int w, int n_agents, int tile_rows, int tile_cols,
                         int rows_per_thread, int stochastic,
                         int lane_offset) {
  extern __shared__ __align__(16) int smem[];
  const Tile t = tile_at(blockIdx.x, h, w, tile_rows, tile_cols);
  const int staged = (tile_rows + 2) * t.stride;
  const int writes = WRITES_PER_ACTION * n_agents;
  int* s = smem;
  uint32_t* q = reinterpret_cast<uint32_t*>(smem + staged);
  int* agent_in = smem + 2 * staged;
  int* ov_pos = agent_in + 7 * n_agents;
  int* ov_val = ov_pos + writes;
  int* ov_k = ov_val + writes;
  int* ov_j = ov_k + writes;
  int* new_locs = ov_j + writes;
  const int hw = h * w;
  const bool st = stochastic != 0;
  const int pad_cols = (tile_cols + 31) & ~31;
  for (int lane = blockIdx.y; lane < batch; lane += gridDim.y) {
    const int* g = board + (size_t)lane * hw;
    int* o = out_board + (size_t)lane * hw;
    const size_t first = (size_t)lane * n_agents;
    const bool vec = tile_vec(g, o, w, tile_cols);
    stage_tile_async(s, g, t, h, w, vec);
    if (threadIdx.x == 0)
      fetch_agents(first, n_agents, actions, locs, agent_in);
    stage_wait();
    __syncthreads();
    // Thread 0 replays the board's agents while warps 1.. pack the tile
    // as staged.
    int n_writes = 0;
    if (threadIdx.x == 0)
      n_writes = replay_agents(g, t, h, w, n_agents, agent_in, ov_pos,
                               ov_val, ov_k, ov_j, new_locs);
    else if (threadIdx.x >= 32)
      pack_tile(s, q, t, threadIdx.x - 32, blockDim.x - 32);
    __syncthreads();
    // Then it writes what the agents wrote, in order, into every staged
    // copy of its cell, and packs those words again.
    for (int i = 0; i < n_writes; ++i)
      for (int k = ov_k[i]; k < t.r + 2; k += h)
        for (int j = ov_j[i]; j < t.c + 2; j += w) {
          s[k * t.stride + 3 + j] = ov_val[i];
          q[k * t.stride + 3 + j] = pack_cell(ov_val[i]);
        }
    __syncthreads();
    walk_tile(s, q, t, w, pad_cols, rows_per_thread, lane, st,
              (uint32_t)seed[0], (uint32_t)seed[1],
              st ? spawn_prob[lane] : 0.0f, lane_offset, 0);
    __syncthreads();
    // Each agent's cell at its new location (0 off the board), as
    // `read_cells` reads it.
    for (int k = threadIdx.x; k < n_agents; k += blockDim.x) {
      const size_t j = first + k;
      const int ny = new_locs[2 * k], nx = new_locs[2 * k + 1];
      const int idx = ny * w + nx;
      if (idx >= 0 && idx < hw) {
        const int gy = idx / w, gx = idx - gy * w;
        if (gy >= t.y0 && gy < t.y0 + t.r && gx >= t.x0 && gx < t.x0 + t.c)
          out_cells[j] = s[(gy - t.y0 + 1) * t.stride + 4 + gx - t.x0];
      } else if (blockIdx.x == 0) {
        out_cells[j] = 0;
      }
      if (blockIdx.x == 0) {
        out_locs[2 * j] = ny;
        out_locs[2 * j + 1] = nx;
      }
    }
    store_tile(o, s, t, w, vec);
    __syncthreads();  // before the next lane's staging and replay
  }
}

}  // namespace

extern "C" int sl_fused_actions_advance(
    const void* board, const void* locs, const void* actions,
    const void* spawn_prob, const void* seed, void* out_board,
    void* out_locs, void* out_cells, int batch, int h, int w, int n_agents,
    int boards_per_block, int rows_per_thread, int threads, int stochastic,
    int lane_offset, void* stream) {
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
      boards_per_block, rows_per_thread, stochastic, lane_offset);
  return (int)cudaGetLastError();
}

extern "C" int sl_fused_actions_advance_global(
    const void* board, const void* locs, const void* actions,
    const void* spawn_prob, const void* seed, void* out_board,
    void* out_locs, void* out_cells, int batch, int h, int w, int n_agents,
    int tile_rows, int tile_cols, int rows_per_thread, int threads,
    int stochastic, int lane_offset, void* stream) {
  if (batch == 0) return 0;
  // Warp 0 replays while the others pack: at least one more warp.
  if (threads < 64) threads = 64;
  const int tiles =
      ((h + tile_rows - 1) / tile_rows) * ((w + tile_cols - 1) / tile_cols);
  const int smem = tile_smem_bytes(tile_rows, tile_cols) +
                   TILE_WORDS_PER_AGENT * n_agents * (int)sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        physics_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(tiles, batch < 65535 ? batch : 65535);
  physics_tiled_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)locs, (const int*)actions,
      (const float*)spawn_prob, (const int*)seed, (int*)out_board,
      (int*)out_locs, (int*)out_cells, batch, h, w, n_agents, tile_rows,
      tile_cols, rows_per_thread, stochastic, lane_offset);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_fused_actions_advance_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
