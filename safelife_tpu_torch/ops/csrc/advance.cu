// K2: one batched cellular-automaton step on flat boards.
//
// Replaces the Pallas kernel `advance_pallas` / `_advance_kernel` in
// safelife_tpu/ops/physics.py:353-395. Bound on the H100 by int32
// operations (55 a cell in the separable form, 16.7 T a second) ahead of
// bytes (8 a cell: each board read once and written once).
//
// Boards of up to MAX_CELLS (ops/physics.py), `advance_kernel`: a block
// takes `boards_per_block` consecutive boards (the wrapper picks the count
// from H and W so that one thread a column fills whole warps), stages them
// in shared memory with asynchronous 16-byte copies, runs the shared
// separable step of ca.cuh (each cell packed once, horizontal taps once a
// row, one thread walking each column or `rows_per_thread` rows of it),
// and stores the result with 16-byte stores. The last block may hold fewer
// boards.
//
// Larger boards, `advance_tiled_kernel`: a block takes one tile of R x C
// cells of one board (grid: tiles x lanes), stages it with its one-cell
// halo ring by `cp.async`, packs every staged cell once, walks the tile's
// columns in segments reading the halo instead of wrapping, and stores
// with 16-byte stores. Bound as above plus the halo's packs, (2R + 2C + 4)
// / (R C) of a pack a cell; the tiles are many enough to fill the card
// (ops/physics.py::tile_shape), and a tile's coins are drawn at its cells'
// indices in the whole board.
#include <cuda_runtime.h>

#include "ca.cuh"

namespace {

using namespace sl;

__global__ void __launch_bounds__(1024)
    advance_kernel(const int* __restrict__ board,
                   const float* __restrict__ spawn_prob,
                   const int* __restrict__ seed, int* __restrict__ out,
                   int batch, int h, int w, int boards_per_block,
                   int rows_per_thread, int stochastic, int lane_offset,
                   int cell_offset) {
  extern __shared__ __align__(16) int smem[];
  const int hw = h * w;
  const int lane0 = blockIdx.x * boards_per_block;
  const int nb = min(boards_per_block, batch - lane0);
  int* s = smem;
  uint32_t* q = reinterpret_cast<uint32_t*>(smem + boards_per_block * hw);

  stage_in(s, board + (size_t)lane0 * hw, nb * hw);
  __syncthreads();
  ca_step_block(s, q, nb, h, w, rows_per_thread, lane0, stochastic != 0,
                (uint32_t)seed[0], (uint32_t)seed[1], spawn_prob, lane_offset,
                cell_offset);
  store_out(out + (size_t)lane0 * hw, s, nb * hw);
}

// Grid: x over the tiles of a board, y over the lanes (looping when the
// batch exceeds the grid's 65,535 rows).
__global__ void __launch_bounds__(1024)
    advance_tiled_kernel(const int* __restrict__ board,
                         const float* __restrict__ spawn_prob,
                         const int* __restrict__ seed, int* __restrict__ out,
                         int batch, int h, int w, int tile_rows,
                         int tile_cols, int rows_per_thread, int stochastic,
                         int lane_offset, int cell_offset) {
  extern __shared__ __align__(16) int smem[];
  const Tile t = tile_at(blockIdx.x, h, w, tile_rows, tile_cols);
  int* s = smem;
  uint32_t* q =
      reinterpret_cast<uint32_t*>(smem + (tile_rows + 2) * t.stride);
  const size_t hw = (size_t)h * w;
  const bool st = stochastic != 0;
  const int pad_cols = (tile_cols + 31) & ~31;
  for (int lane = blockIdx.y; lane < batch; lane += gridDim.y) {
    const int* g = board + lane * hw;
    int* o = out + lane * hw;
    const bool vec = tile_vec(g, o, w, tile_cols);
    stage_tile_async(s, g, t, h, w, vec);
    stage_wait();
    __syncthreads();
    pack_tile(s, q, t, threadIdx.x, blockDim.x);
    __syncthreads();
    walk_tile(s, q, t, w, pad_cols, rows_per_thread, lane, st,
              (uint32_t)seed[0], (uint32_t)seed[1],
              st ? spawn_prob[lane] : 0.0f, lane_offset, cell_offset);
    __syncthreads();
    store_tile(o, s, t, w, vec);
    __syncthreads();  // before the next lane's staging
  }
}

}  // namespace

extern "C" int sl_advance(const void* board, const void* spawn_prob,
                          const void* seed, void* out, int batch, int h,
                          int w, int boards_per_block, int rows_per_thread,
                          int threads, int stochastic, int lane_offset,
                          int cell_offset, void* stream) {
  if (batch == 0) return 0;
  const int blocks = (batch + boards_per_block - 1) / boards_per_block;
  const size_t smem = (size_t)boards_per_block * h * w * SMEM_BYTES_PER_CELL;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        advance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  advance_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const float*)spawn_prob, (const int*)seed,
      (int*)out, batch, h, w, boards_per_block, rows_per_thread, stochastic,
      lane_offset, cell_offset);
  return (int)cudaGetLastError();
}

extern "C" int sl_advance_global(const void* board, const void* spawn_prob,
                                 const void* seed, void* out, int batch,
                                 int h, int w, int tile_rows, int tile_cols,
                                 int rows_per_thread, int threads,
                                 int stochastic, int lane_offset,
                                 int cell_offset, void* stream) {
  if (batch == 0) return 0;
  const int tiles =
      ((h + tile_rows - 1) / tile_rows) * ((w + tile_cols - 1) / tile_cols);
  const int smem = tile_smem_bytes(tile_rows, tile_cols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        advance_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(tiles, batch < 65535 ? batch : 65535);
  advance_tiled_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const float*)spawn_prob, (const int*)seed,
      (int*)out, batch, h, w, tile_rows, tile_cols, rows_per_thread,
      stochastic, lane_offset, cell_offset);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_advance_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
