// K1: fused agent actions + one cellular-automaton step + readback of each
// agent's post-advance cell.
//
// Replaces the Pallas kernel `fused_actions_advance` / `_physics_kernel`
// (`_actions_block`, `_advance_block`) in
// safelife_tpu/ops/physics.py:178-350. Bound by memory like K2: the board is
// read once and written once, plus a few words per agent.
//
// One thread block takes one board, staged in shared memory. Agents act
// strictly in index order (agent k sees agent k-1's writes), so thread 0
// applies them one after another: each action reads its four cells (agent,
// ahead, two ahead, behind; distinct because min(h, w) >= 4), computes the
// four new values and writes them back. That serial part touches 4 cells per
// agent and costs little beside the CA step, which all threads then run.
// After a barrier, thread k reads agent k's cell at its new location.
#include <cuda_runtime.h>

#include "ca.cuh"

namespace {

using namespace sl;

__device__ void apply_action(int* s, int h, int w, int act, int ly, int lx,
                             int* new_y, int* new_x) {
  *new_y = ly;
  *new_x = lx;
  // Two's complement: act 0 gives direction 3, as in the JAX kernel.
  const int dirn = (act - 1) & 3;
  const bool odd = (dirn & 1) == 1;
  const int dx = odd ? 2 - dirn : 0;
  const int dy = odd ? 0 : dirn - 1;
  const int y0 = floor_mod(ly, h), x0 = floor_mod(lx, w);
  const int y1 = floor_mod(y0 + dy, h), x1 = floor_mod(x0 + dx, w);
  const int i0 = y0 * w + x0;
  const int i1 = y1 * w + x1;
  const int i2 = floor_mod(y0 + 2 * dy, h) * w + floor_mod(x0 + 2 * dx, w);
  const int i3 = floor_mod(y0 - dy, h) * w + floor_mod(x0 - dx, w);
  const int v0 = s[i0], v1 = s[i1], v2 = s[i2], v3 = s[i3];
  if (act == 0 || !(v0 & AGENT)) return;

  const int v0o = (v0 & ~ORIENTATION_MASK) | (dirn << ORIENTATION_BIT);
  int n0, n1, n2 = v2, n3 = v3;
  if (act >= 5) {  // toggle: create, destroy or shove
    n0 = v0o;
    n1 = v1;
    if (v1 == 0) {
      n1 = ALIVE | DESTRUCTIBLE | (v0o & COLORS);
    } else if (v1 & DESTRUCTIBLE) {
      n1 = (v1 & AGENT) ? ((v1 ^ (AGENT | DESTRUCTIBLE)) | FROZEN) : 0;
    } else if (~v0o & v1 & PUSHABLE) {
      if (v2 == 0) {
        n1 = 0;
        n2 = v1;
      } else if (v2 & EXIT) {
        n1 = 0;
      }
    }
  } else {  // move: push, walk, exit, then pull
    const bool push = (~v0o & v1 & PUSHABLE) != 0;
    const bool push_empty = push && v2 == 0;
    const bool push_exit = push && v2 != 0 && (v2 & EXIT);
    const bool empty = !push && v1 == 0;
    const bool exit_move =
        !push && !empty && (v0o & v1 & EXIT) && !(v1 & AGENT);
    const bool do_move = push_empty || push_exit || empty;
    const bool do_reloc = do_move || exit_move;
    const bool pull = do_reloc && (~v0o & v3 & PULLABLE);
    n0 = do_reloc ? (pull ? v3 : 0) : v0o;
    n1 = do_move ? v0o : v1;
    if (push_empty) n2 = v1;
    if (pull) n3 = 0;
    if (do_reloc) {
      *new_y = y1;
      *new_x = x1;
    }
  }
  s[i0] = n0;
  s[i1] = n1;
  s[i2] = n2;
  s[i3] = n3;
}

__global__ void physics_kernel(const int* __restrict__ board,
                               const int* __restrict__ locs,
                               const int* __restrict__ actions,
                               const float* __restrict__ spawn_prob,
                               const int* __restrict__ seed,
                               int* __restrict__ out_board,
                               int* __restrict__ out_locs,
                               int* __restrict__ out_cells, int h, int w,
                               int n_agents, int stochastic) {
  extern __shared__ int s[];
  const int hw = h * w;
  const int lane = blockIdx.x;
  const int* src = board + (size_t)lane * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) s[i] = src[i];
  __syncthreads();

  const int* lane_locs = locs + (size_t)lane * n_agents * 2;
  int* lane_out_locs = out_locs + (size_t)lane * n_agents * 2;
  if (threadIdx.x == 0) {
    for (int k = 0; k < n_agents; ++k) {
      apply_action(s, h, w, actions[(size_t)lane * n_agents + k],
                   lane_locs[2 * k], lane_locs[2 * k + 1],
                   &lane_out_locs[2 * k], &lane_out_locs[2 * k + 1]);
    }
  }
  __syncthreads();

  const float prob = spawn_prob[lane];
  const uint32_t k0 = (uint32_t)seed[0], k1 = (uint32_t)seed[1];
  int* dst = out_board + (size_t)lane * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x)
    dst[i] = ca_cell(s, i, h, w, lane, stochastic != 0, k0, k1, prob);
  // Makes this block's writes to out_board and out_locs visible to all
  // of its threads.
  __syncthreads();

  for (int k = threadIdx.x; k < n_agents; k += blockDim.x) {
    const int idx = lane_out_locs[2 * k] * w + lane_out_locs[2 * k + 1];
    out_cells[(size_t)lane * n_agents + k] =
        (idx >= 0 && idx < hw) ? dst[idx] : 0;
  }
}

}  // namespace

extern "C" int sl_fused_actions_advance(
    const void* board, const void* locs, const void* actions,
    const void* spawn_prob, const void* seed, void* out_board,
    void* out_locs, void* out_cells, int batch, int h, int w, int n_agents,
    int stochastic, void* stream) {
  if (batch == 0) return 0;
  size_t smem = (size_t)h * w * sizeof(int);
  physics_kernel<<<batch, 256, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)locs, (const int*)actions,
      (const float*)spawn_prob, (const int*)seed, (int*)out_board,
      (int*)out_locs, (int*)out_cells, h, w, n_agents, stochastic);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_fused_actions_advance_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
