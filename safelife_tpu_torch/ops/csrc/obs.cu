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
// Lanes too large to stage (ops/obs.py decides) take
// `recenter_global_kernel`: one thread an element, a wrapped gather from
// device memory, exits tested at each element.
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

// Element (row * vw + col) of a view centred at (ccy, ccx) that the exit at
// (ey, ex) projects to: its wrapped offset from the centre, clipped to the
// view's perimeter (safelife_tpu/env/env.py:192-206).
__device__ __forceinline__ int exit_slot(int ey, int ex, int ccy, int ccx,
                                         int h, int w, int vh, int vw) {
  const int jy = floor_mod(ey - ccy + h / 2, h) - h / 2 + vh / 2;
  const int jx = floor_mod(ex - ccx + w / 2, w) - w / 2 + vw / 2;
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
      dst[v * vhw + exit_slot(ey, ex, ccy, ccx, h, w, vh, vw)] =
          packed_word(sb[i], sg[i], rw);
    }
  }
}

// The global-memory form: one thread an output element (the wrapper checks
// that their count fits 32 bits), a wrapped gather from device memory, then
// each valid exit in order tested against the element.
__global__ void __launch_bounds__(256)
    recenter_global_kernel(const int* __restrict__ board,
                           const int* __restrict__ goals,
                           const int* __restrict__ cy,
                           const int* __restrict__ cx,
                           const int* __restrict__ exit_locs,
                           const uint8_t* __restrict__ exit_valid,
                           int* __restrict__ out, int total, int n_agents,
                           int h, int w, int vh, int vw, int n_exits,
                           int remove_white) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = t % vw;
  const int rest = t / vw;
  const int r = rest % vh;
  const int view = rest / vh;
  const int lane = view / n_agents;
  const int ccy = cy[view], ccx = cx[view];
  const int* b = board + (size_t)lane * h * w;
  const int* g = goals + (size_t)lane * h * w;
  const bool rw = remove_white != 0;

  const int y = floor_mod(ccy - vh / 2 + r, h);
  const int x = floor_mod(ccx - vw / 2 + c, w);
  int v = packed_word(b[y * w + x], g[y * w + x], rw);

  const int* el = exit_locs + (size_t)lane * n_exits * 2;
  const uint8_t* ev = exit_valid + (size_t)lane * n_exits;
  for (int e = 0; e < n_exits; ++e) {
    if (!ev[e]) continue;
    const int ey = el[2 * e], ex = el[2 * e + 1];
    if (exit_slot(ey, ex, ccy, ccx, h, w, vh, vw) == r * vw + c)
      v = packed_word(b[ey * w + ex], g[ey * w + ex], rw);
  }
  out[t] = v;
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
                                        int threads, int remove_white,
                                        void* stream) {
  const int total = batch * n_agents * vh * vw;
  if (total == 0) return 0;
  recenter_global_kernel<<<(total + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)board, (const int*)goals, (const int*)cy, (const int*)cx,
      (const int*)exit_locs, (const uint8_t*)exit_valid, (int*)out, total,
      n_agents, h, w, vh, vw, n_exits, remove_white);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_recenter_views_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
