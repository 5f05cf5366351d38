// K3: packed observation views, recentred per agent, with exits projected
// onto the view's perimeter.
//
// Replaces the Pallas kernel `recenter_views_pallas` / `_obs_kernel`
// (`_rotate2d`) in safelife_tpu/ops/obs.py:78-218. There the per-lane
// wrapped window was built from binary-decomposed cyclic lane rolls, a TPU
// workaround for gathers; here a block gathers its views out of shared
// memory. Each view element is the packed word board | (goal colour << 16),
// white goals removed, at ((cy - vh/2 + row) mod h, (cx - vw/2 + col) mod
// w); views larger than the board tile it. Then each valid exit, in order,
// overwrites the element it projects to on the view's perimeter, so later
// exits win.
//
// Bound on the H100 by bytes: the board and goal words the views cover
// read once and each view word written once, against about ten integer
// operations an element. The design keeps the operations an element few
// and each word's trips to device memory to one:
//
// * A block takes `lanes_per_block` consecutive lanes, all their agents'
//   views (the wrapper picks the count, `ops/obs.py::view_launch_shape`).
//   It stages the lanes' boards and goals with asynchronous 16-byte copies
//   (`stage_async` of ca.cuh).
// * While the copies fly, it builds per view the row offsets
//   ((y1 + r) mod h) * w and the columns (x1 + c) mod w, once a row and
//   once a column. An element is then four shared-memory reads (row, column,
//   board, goal) and the pack: its row and column come from loop counters,
//   with no division and no modulo. All index arithmetic is 32-bit (the
//   wrapper checks the sizes).
// * The block's views are one contiguous range of the output: consecutive
//   threads store consecutive elements straight to device memory. (Packing
//   each cell once into shared memory and storing a view tile with 16-byte
//   stores measured 14-16% slower: one more pass, one more barrier and more
//   shared-memory traffic; PERF.md, PR 3.)
// * Exits once a view, not once an element: after a barrier, one thread a
//   view overwrites its exits' elements in order.
//
// Boards above MAX_CELLS (12,288 cells) and lanes too large to stage (one
// lane's boards and tables above the 227 KB a block may have;
// ops/obs.py::view_launch_shape decides) take the windowed form,
// `recenter_window_kernel`, which reads from device memory
// only the cells that the views and the exits cover, so the board's size
// does not matter. At 4096 lanes of 192x192 boards it is bound by bytes:
// 10.2 MB of views written and twice that of covered board and goal words
// read, about 9.2 us at 3.35 TB/s, against 1.5 us of integer operations.
// What it does about the latency of dependent loads and about divisions:
//
// * A block takes `views_per_block` consecutive views ((lane, agent)
//   pairs; ops/obs.py::window_launch_shape picks the count and threads).
// * Prologue, one round trip: the views' centres and their exits are
//   loaded at once; the row-offset and column tables and each exit's slot
//   in its view and cell are built from them in shared memory.
// * Body, one round trip, no division: the element's (view, row, column)
//   is carried by compare and subtract; WINDOW_UNROLL elements a thread
//   have their board and goal loads in flight together (with the words of
//   the thread's first exit), then are stored to consecutive addresses by
//   consecutive threads.
// * Exits once a view, not once an element: after a barrier, each valid
//   exit of each view writes its word to its slot unless a later exit of
//   the view has the same slot, so later exits win.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ca.cuh"

namespace {

using namespace sl;

__device__ __forceinline__ int packed_word(int b, int g, bool remove_white) {
  int gcol = g & COLORS;
  if (remove_white && gcol == COLORS) gcol = 0;
  return b | (gcol << 16);
}

// x mod n (a floor modulo), by a compare and an add or subtract where x
// lies in [-n, 2n), as a view's first row and column and its rows and
// columns on a board at least as large as the view do, and by a division
// only otherwise (one by a runtime divisor takes about 95 cycles).
__device__ __forceinline__ int wrap_mod(int x, int n) {
  const int y = wrap1(x, n);
  return (unsigned)y < (unsigned)n ? y : floor_mod(x, n);
}

// Element (row * vw + col) of a view centred at (ccy, ccx) that the exit at
// (ey, ex) projects to: its wrapped offset from the centre, clipped to the
// view's perimeter (safelife_tpu/env/env.py:192-206). The windowed form
// wraps by wrap_mod, which takes its exits' chain 0.15-0.2 us shorter at
// small batches; the staged form keeps floor_mod, with which it compiles
// to 32 registers, two blocks of 1024 threads an SM (38 and one block with
// wrap_mod: 20% slower at 4096 lanes). Both give the same slot.
template <bool kWrap>
__device__ __forceinline__ int exit_slot(int ey, int ex, int ccy, int ccx,
                                         int h, int w, int vh, int vw) {
  const int oy = ey - ccy + h / 2, ox = ex - ccx + w / 2;
  const int jy = (kWrap ? wrap_mod(oy, h) : floor_mod(oy, h)) - h / 2 + vh / 2;
  const int jx = (kWrap ? wrap_mod(ox, w) : floor_mod(ox, w)) - w / 2 + vw / 2;
  return min(max(jy, 0), vh - 1) * vw + min(max(jx, 0), vw - 1);
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) & ~3;
}

// Shared-memory words of a block of `lanes` lanes: the boards (padded to
// 16 bytes), the goals, and the row and column tables.
// ops/obs.py::view_smem_bytes is the same.
__host__ __device__ __forceinline__ int view_smem_words(int lanes,
                                                        int n_agents, int hw,
                                                        int vh, int vw) {
  return round4(lanes * hw) + lanes * hw + lanes * n_agents * (vh + vw);
}

__global__ void __launch_bounds__(1024)
    recenter_kernel(const int* __restrict__ board,
                    const int* __restrict__ goals,
                    const int* __restrict__ cy, const int* __restrict__ cx,
                    const int* __restrict__ exit_locs,
                    const uint8_t* __restrict__ exit_valid,
                    int* __restrict__ out, int batch, int n_agents, int h,
                    int w, int vh, int vw, int n_exits, int lanes_per_block,
                    int remove_white) {
  extern __shared__ __align__(16) int smem[];
  const int hw = h * w;
  const int vhw = vh * vw;
  const int lane0 = blockIdx.x * lanes_per_block;
  const int nl = min(lanes_per_block, batch - lane0);
  const int nv = nl * n_agents;
  const int v0 = lane0 * n_agents;  // first view of the block
  // The layout that view_smem_words counts.
  int* sb = smem;
  int* sg = sb + round4(lanes_per_block * hw);
  int* rowoff = sg + lanes_per_block * hw;
  int* colx = rowoff + lanes_per_block * n_agents * vh;
  int* dst = out + (size_t)v0 * vhw;

  stage_async(sb, board + (size_t)lane0 * hw, nl * hw);
  stage_async(sg, goals + (size_t)lane0 * hw, nl * hw);

  // Row offsets (into the staged boards, the lane's included) and columns
  // of each view, once a row and once a column.
  for (int i = threadIdx.x; i < nv * vh; i += blockDim.x) {
    const int v = i / vh;
    const int y1 = floor_mod(cy[v0 + v] - vh / 2, h);
    rowoff[i] = (v / n_agents) * hw + (y1 + i - v * vh) % h * w;
  }
  for (int i = threadIdx.x; i < nv * vw; i += blockDim.x) {
    const int v = i / vw;
    const int x1 = floor_mod(cx[v0 + v] - vw / 2, w);
    colx[i] = (x1 + i - v * vw) % w;
  }
  stage_wait();
  __syncthreads();

  // Element e = (v * vh + r) * vw + c of the block's views. Each thread
  // steps by blockDim.x elements, carried into (v, r, c) by compare and
  // subtract.
  const bool rw = remove_white != 0;
  {
    const int dc = blockDim.x % vw;
    const int drows = blockDim.x / vw;
    const int dv = drows / vh;
    const int dr = drows - dv * vh;
    int c = threadIdx.x % vw;
    int v = threadIdx.x / vw;
    int r = v % vh;
    v /= vh;
    const int total = nv * vhw;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int i = rowoff[v * vh + r] + colx[v * vw + c];
      dst[e] = packed_word(sb[i], sg[i], rw);
      c += dc;
      r += dr;
      v += dv;
      if (c >= vw) {
        c -= vw;
        ++r;
      }
      if (r >= vh) {
        r -= vh;
        ++v;
      }
    }
  }
  if (n_exits == 0) return;

  // Exits once a view, in order. The barrier orders each exit's store after
  // the gather's store to the same element.
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int lane = v / n_agents;
    const int ccy = cy[v0 + v], ccx = cx[v0 + v];
    const int* el = exit_locs + (size_t)(lane0 + lane) * n_exits * 2;
    const uint8_t* ev = exit_valid + (size_t)(lane0 + lane) * n_exits;
    for (int e = 0; e < n_exits; ++e) {
      if (!ev[e]) continue;
      const int ey = el[2 * e], ex = el[2 * e + 1];
      const int i = lane * hw + ey * w + ex;
      dst[v * vhw + exit_slot<false>(ey, ex, ccy, ccx, h, w, vh, vw)] =
          packed_word(sb[i], sg[i], rw);
    }
  }
}

// Elements a thread of the windowed body takes at a time, their board and
// goal loads in flight together.
constexpr int WINDOW_UNROLL = 4;

// Exit k = v * n_exits + e of a windowed block whose first view is v0:
// exit e of view v's lane (a0 + v agents after the block's first lane,
// a0 = v0 mod n_agents), its slot in view v (-1 if the exit is not valid)
// and the index of its cell from the block's first lane's board. Every
// load goes out at once.
struct ExitHit {
  int slot, cell;
};

__device__ __forceinline__ ExitHit exit_hit(
    int k, const int* __restrict__ cy, const int* __restrict__ cx,
    const int* __restrict__ exit_locs, const uint8_t* __restrict__ exit_valid,
    int v0, int lane0, int a0, FastDiv per_lane, FastDiv per_view, int h,
    int w, int vh, int vw, int n_exits) {
  const int v = per_view(k);
  const int lane = per_lane(a0 + v);
  const size_t p = (size_t)(lane0 + lane) * n_exits + (k - v * n_exits);
  const int ey = exit_locs[2 * p], ex = exit_locs[2 * p + 1];
  const bool valid = exit_valid[p];
  const int slot =
      exit_slot<true>(ey, ex, cy[v0 + v], cx[v0 + v], h, w, vh, vw);
  return {valid ? slot : -1, lane * h * w + ey * w + ex};
}

// The windowed form: a block's views gathered from device memory through
// per-view row and column tables. Shared memory (ops/obs.py::
// window_smem_bytes): the row offsets and the columns of each view, and
// the slot and cell of each of its exits. At small batches its time is
// its chain of latencies (chip_sweep.py views, PERF.md), so the
// prologue's loads go out in one round trip (the rows, the columns and the
// exits each start on a warp of their own: a warp runs the sides of a
// branch one after the other), and divisions go through FastDiv.
__global__ void __launch_bounds__(1024)
    recenter_window_kernel(const int* __restrict__ board,
                           const int* __restrict__ goals,
                           const int* __restrict__ cy,
                           const int* __restrict__ cx,
                           const int* __restrict__ exit_locs,
                           const uint8_t* __restrict__ exit_valid,
                           int* __restrict__ out, int n_views, int n_agents,
                           int h, int w, int vh, int vw, int n_exits,
                           int views_per_block, int remove_white,
                           FastDiv per_lane, FastDiv per_row,
                           FastDiv per_col, FastDiv per_view) {
  extern __shared__ __align__(16) int smem[];
  const int hw = h * w;
  const int vhw = vh * vw;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int v0 = blockIdx.x * views_per_block;  // first view of the block
  const int nv = min(views_per_block, n_views - v0);
  const int lane0 = per_lane(v0);
  const int a0 = v0 - lane0 * n_agents;
  int* rowoff = smem;
  int* colx = rowoff + views_per_block * vh;
  int* slots = colx + views_per_block * vw;
  int* cells = slots + views_per_block * n_exits;
  // The block's lanes' boards; offsets below are 32-bit from here (the
  // wrapper checks views_per_block * h * w).
  const int* b = board + (size_t)lane0 * hw;
  const int* g = goals + (size_t)lane0 * hw;
  int* dst = out + (size_t)v0 * vhw;
  const bool rw = remove_white != 0;

  // Prologue: the row offsets (from the block's first lane's board) and
  // the columns of each view, once a row and once a column, and the slots
  // and cells of the block's exits.
  const int n_rows = nv * vh, n_cols = nv * vw, n_hits = nv * n_exits;
  const int col0 = (n_rows + 31) & ~31;
  const int hit0 = col0 + ((n_cols + 31) & ~31);
#pragma unroll 1
  for (int i = tid; i < hit0 + n_hits; i += nt) {
    if (i < n_rows) {
      const int vi = per_row(i);
      const int y1 = wrap_mod(cy[v0 + vi] - vh / 2, h);
      rowoff[i] = per_lane(a0 + vi) * hw + wrap_mod(y1 + i - vi * vh, h) * w;
    } else if (i >= col0 && i < col0 + n_cols) {
      const int j = i - col0;
      const int vi = per_col(j);
      colx[j] = wrap_mod(wrap_mod(cx[v0 + vi] - vw / 2, w) + j - vi * vw, w);
    } else if (i >= hit0) {
      const int k = i - hit0;
      const ExitHit x = exit_hit(k, cy, cx, exit_locs, exit_valid, v0, lane0,
                                 a0, per_lane, per_view, h, w, vh, vw,
                                 n_exits);
      slots[k] = x.slot;
      cells[k] = x.cell;
    }
  }
  // The body's first element (v, r, c) = tid and its step nt.
  const int drows = per_col(nt);
  const int dc = nt - drows * vw;
  const int dv = per_row(drows);
  const int dr = drows - dv * vh;
  int r = per_col(tid);
  int c = tid - r * vw;
  int v = per_row(r);
  r -= v * vh;
  __syncthreads();

  // The thread's first exit's words join the body's loads (a barrier
  // would wait for loads made before it).
  const bool first_hit = tid < n_hits && slots[tid] >= 0;
  int bw0 = 0, gw0 = 0;
  if (first_hit) {
    bw0 = b[cells[tid]];
    gw0 = g[cells[tid]];
  }

  // Element e = (v * vh + r) * vw + c of the block's views. A thread takes
  // WINDOW_UNROLL elements nt apart at a time; (v, r, c) steps by nt
  // elements by compare and subtract, and past the last view reads the
  // last view's tables, so that no branch stands before the loads.
  const int total = nv * vhw;
#pragma unroll 1
  for (int e0 = tid; e0 < total; e0 += WINDOW_UNROLL * nt) {
    int idx[WINDOW_UNROLL];
#pragma unroll
    for (int u = 0; u < WINDOW_UNROLL; ++u) {
      const int vu = min(v, nv - 1);
      idx[u] = rowoff[vu * vh + r] + colx[vu * vw + c];
      c += dc;
      r += dr;
      v += dv;
      if (c >= vw) {
        c -= vw;
        ++r;
      }
      if (r >= vh) {
        r -= vh;
        ++v;
      }
    }
    int bw[WINDOW_UNROLL], gw[WINDOW_UNROLL];
#pragma unroll
    for (int u = 0; u < WINDOW_UNROLL; ++u) {
      if (e0 + u * nt < total) {
        bw[u] = b[idx[u]];
        gw[u] = g[idx[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < WINDOW_UNROLL; ++u) {
      if (e0 + u * nt < total)
        dst[e0 + u * nt] = packed_word(bw[u], gw[u], rw);
    }
  }
  if (n_exits == 0) return;

  // Exits once a view, after a barrier that orders their stores after the
  // body's: a valid exit writes its word to its slot unless a later exit
  // of the same view has the same slot (later exits win).
  __syncthreads();
#pragma unroll 1
  for (int k = tid; k < n_hits; k += nt) {
    const int slot = slots[k];
    if (slot < 0) continue;
    const int vk = per_view(k);
    bool later = false;
#pragma unroll 1
    for (int k2 = k + 1; k2 < (vk + 1) * n_exits; ++k2)
      later |= slots[k2] == slot;
    if (later) continue;
    int bw = bw0, gw = gw0;
    if (k != tid) {
      bw = b[cells[k]];
      gw = g[cells[k]];
    }
    dst[vk * vhw + slot] = packed_word(bw, gw, rw);
  }
}

}  // namespace

extern "C" int sl_recenter_views(const void* board, const void* goals,
                                 const void* cy, const void* cx,
                                 const void* exit_locs,
                                 const void* exit_valid, void* out,
                                 int batch, int n_agents, int h, int w,
                                 int vh, int vw, int n_exits,
                                 int lanes_per_block, int threads,
                                 int remove_white, void* stream) {
  if (batch == 0 || n_agents == 0 || vh == 0 || vw == 0) return 0;
  const int blocks = (batch + lanes_per_block - 1) / lanes_per_block;
  const size_t smem =
      sizeof(int) *
      (size_t)view_smem_words(lanes_per_block, n_agents, h * w, vh, vw);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        recenter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  recenter_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)goals, (const int*)cy, (const int*)cx,
      (const int*)exit_locs, (const uint8_t*)exit_valid, (int*)out, batch,
      n_agents, h, w, vh, vw, n_exits, lanes_per_block, remove_white);
  return (int)cudaGetLastError();
}

extern "C" int sl_recenter_views_global(const void* board, const void* goals,
                                        const void* cy, const void* cx,
                                        const void* exit_locs,
                                        const void* exit_valid, void* out,
                                        int batch, int n_agents, int h,
                                        int w, int vh, int vw, int n_exits,
                                        int views_per_block, int threads,
                                        int remove_white, void* stream) {
  const int n_views = batch * n_agents;
  if (n_views == 0 || vh == 0 || vw == 0) return 0;
  const int blocks = (n_views + views_per_block - 1) / views_per_block;
  const size_t smem =
      sizeof(int) * (size_t)views_per_block * (vh + vw + 2 * n_exits);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        recenter_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  recenter_window_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)goals, (const int*)cy, (const int*)cx,
      (const int*)exit_locs, (const uint8_t*)exit_valid, (int*)out, n_views,
      n_agents, h, w, vh, vw, n_exits, views_per_block, remove_white,
      FastDiv(n_agents), FastDiv(vh), FastDiv(vw),
      FastDiv(n_exits > 0 ? n_exits : 1));
  return (int)cudaGetLastError();
}

extern "C" const char* sl_recenter_views_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
