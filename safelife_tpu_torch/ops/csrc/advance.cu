// K2: one batched cellular-automaton step on flat boards.
//
// Replaces the Pallas kernel `advance_pallas` / `_advance_kernel` in
// safelife_tpu/ops/physics.py:353-395. Bound on the H100 by int32
// operations (55 a cell in the separable form, 16.7 T a second) ahead of
// bytes (8 a cell: each board read once and written once). A block takes
// `boards_per_block` consecutive boards (the wrapper picks the count from
// H and W so that one thread a column fills whole warps), stages them in
// shared memory with asynchronous 16-byte copies, runs the shared
// separable step of ca.cuh (each cell packed once, horizontal taps once a
// row, one thread walking each column or `rows_per_thread` rows of it),
// and stores the result with 16-byte stores. The last block may hold fewer
// boards.
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

// Grid: x over the cells of a board, y over the lanes (looping when the
// batch exceeds the grid's 65,535 rows).
__global__ void __launch_bounds__(256)
    advance_global_kernel(const int* __restrict__ board,
                          const float* __restrict__ spawn_prob,
                          const int* __restrict__ seed,
                          int* __restrict__ out, int batch, int h, int w,
                          int stochastic, int lane_offset, int cell_offset) {
  const size_t hw = (size_t)h * w;
  const bool st = stochastic != 0;
  for (int lane = blockIdx.y; lane < batch; lane += gridDim.y) {
    ca_cells_global(board + lane * hw, out + lane * hw, h, w,
                    blockIdx.x * blockDim.x + threadIdx.x,
                    gridDim.x * blockDim.x, lane, st, (uint32_t)seed[0],
                    (uint32_t)seed[1], st ? spawn_prob[lane] : 0.0f,
                    lane_offset, cell_offset);
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
                                 int h, int w, int threads, int stochastic,
                                 int lane_offset, int cell_offset,
                                 void* stream) {
  if (batch == 0) return 0;
  const dim3 grid((h * w + threads - 1) / threads,
                  batch < 65535 ? batch : 65535);
  advance_global_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)board, (const float*)spawn_prob, (const int*)seed,
      (int*)out, batch, h, w, stochastic, lane_offset, cell_offset);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_advance_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
