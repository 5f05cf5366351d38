// K4: packed observation views -> the policy trunk's input planes.
//
// Replaces no Pallas kernel. The JAX package leaves this unpack to XLA:
// `unpack_obs` (safelife_tpu/models/nets.py:74-81) and the transpose before
// the trunk's first convolution (:94). The port ran them as four PyTorch
// passes (shift, mask, cast, then cuDNN's copy of the transposed tensor)
// after a host-to-card copy of the channel shifts, which waited for the
// device, on every forward. This kernel is one pass:
//
//   out[n, c, j, i] = float((views[n, i, j] >> shifts[c]) & 1)
//
// views int32 [N, vh, vw] -> out float32 [N, C, vw, vh], contiguous NCHW,
// each value exactly 0 or 1 (bits 24-31 and negative words included: the
// shift and the mask run on the int32 word).
//
// Bound on the H100 by bytes: 4 bytes read a view word and 4 C written
// (C = 15 at 25x25: 2.5 KB read and 37.5 KB written a sample; 655 MB, 196
// us at 3.35 TB/s for 16,384 samples), against a few integer operations an
// output. The design moves each byte through device memory once and keeps
// the operations an output few:
//
// * A block takes one sample (ops/unpack.py::THREADS threads). It reads
//   its words once, coalesced, and writes them transposed into shared
//   memory, words[j][i]: the transpose is a shared-memory address, never a
//   strided read of device memory. Neighbouring threads write vh words
//   apart, an odd stride at 25x25 views, so without bank conflicts. (At
//   512 threads, blocks of 2 to 16 samples ran 2-5% slower at 16,384
//   samples, 1-5% at 4,096 and 1.4-6.8x at 25: chip_sweep.py unpack,
//   PERF.md section 6.)
// * The block's output is one contiguous run of C x vw x vh floats. Its
//   threads walk the run as 16-byte groups, neighbouring threads on
//   neighbouring groups, so the stores coalesce. A run starts on a 16-byte
//   boundary only where its first float's offset is a multiple of 4 (9,375
//   floats a sample at 25x25 and 15 channels is not), so the floats before
//   the run's first boundary and after its last go one at a time.
// * A group's four floats are four consecutive positions of one plane (one
//   channel), so four consecutive words under one shift: a division by the
//   plane size a group (`FastDiv`), then a shift and a select an output. A
//   group that straddles two planes (one in about 156 at 25x25) takes each
//   float on its own.
// * The shifts are kernel arguments, up to 32, copied to shared memory: a
//   call copies nothing from the host and waits for nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ca.cuh"

namespace {

using namespace sl;

constexpr int MAX_CHANNELS = 32;

struct Shifts {
  int v[MAX_CHANNELS];
};

__device__ __forceinline__ float bit_of(int word, int shift) {
  return ((word >> shift) & 1) ? 1.0f : 0.0f;
}

// Shared memory: the shifts, then the block's sample transposed,
// words[j * vh + i] = views[blockIdx.x][i][j].
__global__ void __launch_bounds__(1024) unpack_kernel(
    const int* __restrict__ views, float* __restrict__ out, int vh, int vw,
    int n_channels, const __grid_constant__ Shifts shifts, FastDiv by_plane,
    FastDiv by_row) {
  extern __shared__ int smem[];
  int* shift = smem;
  int* words = smem + MAX_CHANNELS;
  const int plane = vh * vw;
  const int t = threadIdx.x;
  const int* src = views + (size_t)blockIdx.x * plane;
  if (t < n_channels) shift[t] = shifts.v[t];
  for (int f = t; f < plane; f += blockDim.x) {
    const int i = by_row(f), j = f - i * vw;
    words[j * vh + i] = src[f];
  }
  __syncthreads();

  // The float at offset e of the block's run.
  auto one = [&](int e) {
    const int c = by_plane(e);
    return bit_of(words[e - c * plane], shift[c]);
  };
  const size_t first = (size_t)blockIdx.x * n_channels * plane;
  float* dst = out + first;
  const int run = n_channels * plane;
  const int lead = min((int)((4 - (first & 3)) & 3), run);
  const int groups = (run - lead) >> 2;
  const int tail = lead + 4 * groups;
  if (t < lead) dst[t] = one(t);
  if (t < run - tail) dst[tail + t] = one(tail + t);
  float4* dst4 = reinterpret_cast<float4*>(dst + lead);
  for (int g = t; g < groups; g += blockDim.x) {
    const int e = lead + 4 * g;
    const int c = by_plane(e), x = e - c * plane;
    float4 v;
    if (x + 3 < plane) {
      const int* w = words + x;
      const int sh = shift[c];
      v = make_float4(bit_of(w[0], sh), bit_of(w[1], sh), bit_of(w[2], sh),
                      bit_of(w[3], sh));
    } else {
      v = make_float4(one(e), one(e + 1), one(e + 2), one(e + 3));
    }
    dst4[g] = v;
  }
}

}  // namespace

// `channels` is a host array of `n_channels` shifts, each in [0, 31]; `out`
// is 16-byte aligned; a block of `threads` threads a sample.
extern "C" int sl_unpack_planes(const void* views, void* out, int n, int vh,
                                int vw, const void* channels, int n_channels,
                                int threads, void* stream) {
  if (n == 0) return 0;
  if (n_channels < 1 || n_channels > MAX_CHANNELS || vh < 1 || vw < 1 ||
      threads < MAX_CHANNELS || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Shifts shifts = {};
  for (int c = 0; c < n_channels; ++c)
    shifts.v[c] = static_cast<const int*>(channels)[c];
  const size_t smem = sizeof(int) * (MAX_CHANNELS + (size_t)vh * vw);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  unpack_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      (const int*)views, (float*)out, vh, vw, n_channels, shifts,
      FastDiv(vh * vw), FastDiv(vw));
  return (int)cudaGetLastError();
}

extern "C" const char* sl_unpack_planes_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
