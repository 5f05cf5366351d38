// Shared device code of the SafeLife kernels: cell constants, floor modulo,
// the Philox4x32-10 spawn draw and the one-cell cellular-automaton rule.
//
// The CA rule is what `_advance_block` computes in
// safelife_tpu/ops/physics.py:128-175 (and safelife_tpu/core/advance.py),
// written for one cell that reads its toroidal 3x3 neighbourhood from a
// board staged in shared memory. K1 (physics.cu) and K2 (advance.cu) both
// call `ca_cell`.
#pragma once

#include <stdint.h>

namespace sl {

constexpr int ALIVE = 1 << 0;
constexpr int AGENT = 1 << 1;
constexpr int PUSHABLE = 1 << 2;
constexpr int DESTRUCTIBLE = 1 << 3;
constexpr int FROZEN = 1 << 4;
constexpr int PRESERVING = 1 << 5;
constexpr int INHIBITING = 1 << 6;
constexpr int SPAWNING = 1 << 7;
constexpr int EXIT = 1 << 8;
constexpr int COLOR_BIT = 9;
constexpr int COLOR_R = 1 << 9;
constexpr int COLOR_G = 1 << 10;
constexpr int COLOR_B = 1 << 11;
constexpr int COLORS = 7 << COLOR_BIT;
constexpr int ORIENTATION_BIT = 12;
constexpr int ORIENTATION_MASK = 3 << ORIENTATION_BIT;
constexpr int PULLABLE = 1 << 15;

// JAX's `%` is a floor modulo; C's truncates toward zero.
__device__ __forceinline__ int floor_mod(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
}

// First output word of Philox4x32-10 for counter (c0, c1, 0, 0) and key
// (k0, k1). The plain version is `ops.physics.philox_bits`.
__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1,
                                                uint32_t k0, uint32_t k1) {
  uint32_t x0 = c0, x1 = c1, x2 = 0u, x3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t lo0 = 0xD2511F53u * x0, hi0 = __umulhi(0xD2511F53u, x0);
    uint32_t lo1 = 0xCD9E8D57u * x2, hi1 = __umulhi(0xCD9E8D57u, x2);
    uint32_t n0 = hi1 ^ x1 ^ k0;
    uint32_t n2 = hi0 ^ x3 ^ k1;
    x0 = n0;
    x1 = lo1;
    x2 = n2;
    x3 = lo0;
  }
  return x0;
}

// Spawn coin flip of cell `cell` on board `lane`: the top 24 bits as a
// float32 uniform in [0, 1), compared with the float32 spawn probability.
__device__ __forceinline__ bool spawn_draw(int cell, int lane, uint32_t k0,
                                           uint32_t k1, float prob) {
  uint32_t bits = philox_word((uint32_t)cell, (uint32_t)lane, k0, k1);
  float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return u < prob;
}

// New value of cell i of the h x w board `s` (shared memory). When
// `stochastic` is set, a spawn-eligible cell draws its coin from Philox
// keyed by (k0, k1) at counter (i, lane); otherwise spawners never fire.
__device__ __forceinline__ int ca_cell(const int* s, int i, int h, int w,
                                       int lane, bool stochastic,
                                       uint32_t k0, uint32_t k1, float prob) {
  int y = i / w;
  int x = i - y * w;
  int ym = y == 0 ? h - 1 : y - 1, yp = y == h - 1 ? 0 : y + 1;
  int xm = x == 0 ? w - 1 : x - 1, xp = x == w - 1 ? 0 : x + 1;
  int rows[3] = {ym * w, y * w, yp * w};
  int cols[3] = {xm, x, xp};
  int sum = 0, orred = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      int v = s[rows[a] + cols[b]];
      // The destructible bit copied onto bit 8: alive EXIT cells count
      // toward destructibility consensus, as in the C kernel.
      int m = v | ((v & DESTRUCTIBLE) << 5);
      int al = m & 1;
      sum += al | (((m >> 8) & al) << 5) | (((m >> 9) & al) << 10) |
             (((m >> 10) & al) << 15) | (((m >> 11) & al) << 20);
      int spawner = (m >> 7) & 1;
      orred |= (m & (PRESERVING | INHIBITING | SPAWNING)) |
               ((m & COLORS) * spawner);
    }
  }
  int count = sum & 31;
  int v = s[i];
  if (v & ALIVE) {
    bool survives = (v & FROZEN) || (orred & PRESERVING) || count == 3 ||
                    count == 4;
    return survives ? v : 0;
  }
  if ((v & FROZEN) || (orred & INHIBITING)) return v;
  int cons_colors = ((((sum >> 10) & 31) >= 2) ? COLOR_R : 0) |
                    ((((sum >> 15) & 31) >= 2) ? COLOR_G : 0) |
                    ((((sum >> 20) & 31) >= 2) ? COLOR_B : 0) |
                    (orred & COLORS);
  if (count == 3) {
    int cons_destr = (((sum >> 5) & 31) >= 2) ? DESTRUCTIBLE : 0;
    return ALIVE | cons_colors | cons_destr;
  }
  if ((orred & SPAWNING) && stochastic && spawn_draw(i, lane, k0, k1, prob))
    return ALIVE | DESTRUCTIBLE | cons_colors;
  return v;
}

}  // namespace sl
