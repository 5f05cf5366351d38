// K3: packed observation views, recentred per agent, with exits projected
// onto the view's perimeter.
//
// Replaces the Pallas kernel `recenter_views_pallas` / `_obs_kernel`
// (`_rotate2d`) in safelife_tpu/ops/obs.py:78-218. There the per-lane
// wrapped window was built from binary-decomposed cyclic lane rolls, a TPU
// workaround for gathers; here it is a direct wrapped gather. Bound by
// memory: the output (B*A*vh*vw words) dominates what must move, and each
// board and goal word is read by up to vh*vw/(h*w) threads, mostly from L1
// and L2.
//
// One thread per output element (lane, agent, row, col): it builds the
// packed word board | (goal colour << 16), white goals removed, at
// ((cy - vh/2 + row) mod h, (cx - vw/2 + col) mod w), then walks the exits
// in order and takes the packed word of each valid exit whose projection
// lands on its element, so later exits win.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ca.cuh"

namespace {

__device__ __forceinline__ int packed_word(int b, int g, bool remove_white) {
  int gcol = g & sl::COLORS;
  if (remove_white && gcol == sl::COLORS) gcol = 0;
  return b | (gcol << 16);
}

__global__ void recenter_kernel(const int* __restrict__ board,
                                const int* __restrict__ goals,
                                const int* __restrict__ cy,
                                const int* __restrict__ cx,
                                const int* __restrict__ exit_locs,
                                const uint8_t* __restrict__ exit_valid,
                                int* __restrict__ out, long long total,
                                int n_agents, int h, int w, int vh, int vw,
                                int n_exits, int remove_white) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % vw);
  const long long rest = t / vw;
  const int r = (int)(rest % vh);
  const long long lane_agent = rest / vh;
  const int lane = (int)(lane_agent / n_agents);
  const int ccy = cy[lane_agent], ccx = cx[lane_agent];
  const int* b = board + (size_t)lane * h * w;
  const int* g = goals + (size_t)lane * h * w;
  const bool rw = remove_white != 0;

  const int y = sl::floor_mod(ccy - vh / 2 + r, h);
  const int x = sl::floor_mod(ccx - vw / 2 + c, w);
  int v = packed_word(b[y * w + x], g[y * w + x], rw);

  const int* el = exit_locs + (size_t)lane * n_exits * 2;
  const uint8_t* ev = exit_valid + (size_t)lane * n_exits;
  for (int e = 0; e < n_exits; ++e) {
    if (!ev[e]) continue;
    const int ey = el[2 * e], ex = el[2 * e + 1];
    int jy = sl::floor_mod(ey - ccy + h / 2, h) - h / 2 + vh / 2;
    int jx = sl::floor_mod(ex - ccx + w / 2, w) - w / 2 + vw / 2;
    jy = min(max(jy, 0), vh - 1);
    jx = min(max(jx, 0), vw - 1);
    if (jy == r && jx == c) v = packed_word(b[ey * w + ex], g[ey * w + ex], rw);
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
                                 int remove_white, void* stream) {
  const long long total = (long long)batch * n_agents * vh * vw;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  recenter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)board, (const int*)goals, (const int*)cy, (const int*)cx,
      (const int*)exit_locs, (const uint8_t*)exit_valid, (int*)out, total,
      n_agents, h, w, vh, vw, n_exits, remove_white);
  return (int)cudaGetLastError();
}

extern "C" const char* sl_recenter_views_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
