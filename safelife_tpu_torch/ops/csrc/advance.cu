// K2: one batched cellular-automaton step on flat boards.
//
// Replaces the Pallas kernel `advance_pallas` / `_advance_kernel` in
// safelife_tpu/ops/physics.py:353-395. The work is bound by memory: each
// board is read once and written once (8 bytes a cell), against some 150
// integer operations a cell. One thread block takes one board and stages it
// in shared memory (26x26 cells = 2.7 KB), so each of the nine neighbour
// reads of a cell hits shared memory and device memory is touched once per
// cell each way. Each thread computes cells i, i + blockDim, ... through the
// shared `ca_cell` rule.
#include <cuda_runtime.h>

#include "ca.cuh"

namespace {

__global__ void advance_kernel(const int* __restrict__ board,
                               const float* __restrict__ spawn_prob,
                               const int* __restrict__ seed,
                               int* __restrict__ out, int h, int w,
                               int stochastic) {
  extern __shared__ int s[];
  const int hw = h * w;
  const int lane = blockIdx.x;
  const int* src = board + (size_t)lane * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  const float prob = spawn_prob[lane];
  const uint32_t k0 = (uint32_t)seed[0], k1 = (uint32_t)seed[1];
  int* dst = out + (size_t)lane * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x)
    dst[i] = sl::ca_cell(s, i, h, w, lane, stochastic != 0, k0, k1, prob);
}

}  // namespace

extern "C" int sl_advance(const void* board, const void* spawn_prob,
                          const void* seed, void* out, int batch, int h,
                          int w, int stochastic, void* stream) {
  if (batch == 0) return 0;
  size_t smem = (size_t)h * w * sizeof(int);
  advance_kernel<<<batch, 256, smem, (cudaStream_t)stream>>>(
      (const int*)board, (const float*)spawn_prob, (const int*)seed,
      (int*)out, h, w, stochastic);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_advance_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
