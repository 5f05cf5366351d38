// Shared device code of the SafeLife kernels K1 (physics.cu) and K2
// (advance.cu): cell constants, the Philox4x32-10 spawn draw, the packed
// cell word, the one-cell CA rule, and the block-level passes both kernels
// are built from (staging copies and the separable CA step).
//
// The CA step computes what `_advance_block` computes in
// safelife_tpu/ops/physics.py:128-175 (and safelife_tpu/core/advance.py):
// a 3x3 toroidal neighbourhood sum of five 5-bit counters and an OR of
// flags, then the rule. What bounds it on the H100 is int32 issue
// (55 operations a cell at 16.7 T int32 operations/s, against 8 bytes a
// cell of device memory at 3.35 TB/s), so the design spends as few
// operations a cell as it can:
//
// * Pack once (`pack_cell`). Each cell's count word and or-word are
//   computed once a step into one 32-bit word kept in shared memory beside
//   the raw board: counters in bits 0-24, flags in bits 25-31. A counter
//   never exceeds 9 over a neighbourhood, so sums of such words are exact
//   in bits 0-24 and ORs are exact in bits 25-31.
// * Separable neighbourhood (`ca_step_block`). One thread owns a column
//   (or a segment of one) and walks down its rows, keeping the horizontal
//   3-tap sum and OR of three rows in registers; each row's horizontal
//   taps are computed once, and the vertical step is one 3-input add and
//   one 3-input OR. Row and column come from the loop, so no cell needs a
//   division, and only the row counter wraps.
// * Several boards per block: the wrapper picks the count from (H, W) so
//   that columns fill warps; the boards of one block are contiguous in
//   device memory and are staged with asynchronous 16-byte copies
//   (`stage_in`) and stored with 16-byte stores (`store_out`).
//
// Boards too large for a block's shared memory take `ca_cells_global`
// instead: one thread a cell, its neighbourhood read from device memory.
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

// Shared memory a block needs per cell: the raw board and the packed word.
constexpr int SMEM_BYTES_PER_CELL = 8;

// JAX's `%` is a floor modulo; C's truncates toward zero.
__device__ __forceinline__ int floor_mod(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
}

// x mod n for x in [-n, 2n): one compare and add.
__device__ __forceinline__ int wrap1(int x, int n) {
  return x < 0 ? x + n : (x >= n ? x - n : x);
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

// Spawn coin flip of cell `cell` on board `lane` (both counter words, the
// caller's offsets already added; they wrap mod 2^32): the top 24 bits as
// a float32 uniform in [0, 1), compared with the float32 spawn probability.
__device__ __forceinline__ bool spawn_draw(int cell, int lane, uint32_t k0,
                                           uint32_t k1, float prob) {
  uint32_t bits = philox_word((uint32_t)cell, (uint32_t)lane, k0, k1);
  float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return u < prob;
}

// The packed word of one cell (`packed | orv << 20` of
// safelife_tpu/ops/physics.py:130-148):
//   bits 0-24: 5-bit counters of alive, destructible-or-exit, R, G and B,
//              the last four only for alive cells (the destructible bit is
//              copied onto bit 8, so alive EXIT cells count toward
//              destructibility, as in the C kernel);
//   bits 25-31: PRESERVING, INHIBITING, SPAWNING and, for a spawner, its
//              colours (bits 5-11 of the cell moved up by 20).
__device__ __forceinline__ uint32_t pack_cell(int v) {
  const uint32_t u = (uint32_t)v;
  const uint32_t m = u | ((u & DESTRUCTIBLE) << 5);
  const uint32_t alive = m & 1u;
  // Bits 8-11 of an alive cell; the multiply spreads bit j to bit 5j
  // (its 16 partial products land on distinct bits, so nothing carries).
  const uint32_t t = (m >> 8) & (0u - alive) & 15u;
  const uint32_t counts = alive | (((t * 0x1111u) & 0x8421u) << 5);
  const uint32_t spawner = (uint32_t)((int)(u << 24) >> 31);  // ~0 iff SPAWNING
  const uint32_t orv =
      u & (PRESERVING | INHIBITING | SPAWNING | (spawner & COLORS));
  return counts | (orv << 20);
}

// The SafeLife rule for one cell of raw value v, given the neighbourhood
// sum and OR of packed words. When `stochastic` is set, a spawn-eligible
// cell draws its coin from Philox keyed by (k0, k1) at counter
// (cell, lane) (the global cell and lane: the caller adds its offsets);
// otherwise spawners never fire.
__device__ __forceinline__ int ca_rule(int v, uint32_t sum, uint32_t orw,
                                       int cell, int lane, bool stochastic,
                                       uint32_t k0, uint32_t k1, float prob) {
  // Flags in bits 5-11; bits 0-4 of orred hold counter bits, never read.
  const int orred = (int)(orw >> 20);
  const int count = sum & 31;
  if (v & ALIVE) {
    const bool survives = (v & FROZEN) || (orred & PRESERVING) ||
                          count == 3 || count == 4;
    return survives ? v : 0;
  }
  if ((v & FROZEN) || (orred & INHIBITING)) return v;
  // A counter >= 2 iff any of its bits 1-4 is set.
  const int cons_colors = ((sum & (30u << 10)) ? COLOR_R : 0) |
                          ((sum & (30u << 15)) ? COLOR_G : 0) |
                          ((sum & (30u << 20)) ? COLOR_B : 0) |
                          (orred & COLORS);
  if (count == 3)
    return ALIVE | cons_colors | ((sum & (30u << 5)) ? DESTRUCTIBLE : 0);
  if (stochastic && (orred & SPAWNING) && spawn_draw(cell, lane, k0, k1, prob))
    return ALIVE | DESTRUCTIBLE | cons_colors;
  return v;
}

// Starts copying n ints from device to shared memory with all of the
// block's threads: asynchronous 16-byte copies (`cp.async`, no register
// staging, all in flight at once) where both addresses are 16-byte aligned
// (the wrapper's block sizes make them so for the usual boards), one int at
// a time for the tail or otherwise. The copies are complete after
// `stage_wait` and a barrier.
__device__ __forceinline__ void stage_async(int* __restrict__ dst,
                                            const int* __restrict__ src,
                                            int n) {
  int done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + 4 * i));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// `stage_async` then `stage_wait`. The caller synchronises the block after.
__device__ __forceinline__ void stage_in(int* __restrict__ dst,
                                         const int* __restrict__ src, int n) {
  stage_async(dst, src, n);
  stage_wait();
}

// Copies n ints from shared to device memory with all of the block's
// threads, 16 bytes a thread where both addresses allow it.
__device__ __forceinline__ void store_out(int* __restrict__ dst,
                                          const int* __restrict__ src,
                                          int n) {
  int done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int n4 = n >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Horizontal 3-tap of a row: the sum and the OR of the packed words at
// columns xm, x, xp.
__device__ __forceinline__ void row_taps(const uint32_t* row, int xm, int x,
                                         int xp, uint32_t* sum,
                                         uint32_t* orw) {
  const uint32_t a = row[xm], c = row[x], d = row[xp];
  *sum = a + c + d;
  *orw = a | c | d;
}

// One CA step, in place, of the nb boards of h x w cells staged one after
// another at `s` in shared memory; `q` is shared scratch of as many words.
// Board b is board lane0 + b of the batch; its coins are drawn at counter
// (cell + cell_offset, lane0 + b + lane_offset), the offsets placing a
// slice of a larger batch (or of a larger board) at its global counters.
// Each thread walks `rows` rows
// of one column (a segment; the wrapper cuts columns into segments when
// the batch is too small to keep the card busy with whole columns).
// Starts and ends with the block in step (the caller must have
// synchronised after writing `s`).
__device__ __forceinline__ void ca_step_block(
    int* __restrict__ s, uint32_t* __restrict__ q, int nb, int h, int w,
    int rows, int lane0, bool stochastic, uint32_t k0, uint32_t k1,
    const float* __restrict__ spawn_prob, int lane_offset, int cell_offset) {
  const int hw = h * w;
  const int n = nb * hw;
  for (int i = threadIdx.x; i < n; i += blockDim.x) q[i] = pack_cell(s[i]);
  __syncthreads();

  const int segments = (h + rows - 1) / rows;
  const int items = nb * w * segments;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    // Once a segment, not once a cell: neighbouring threads take
    // neighbouring columns of one board and segment.
    const int r = item / w;
    const int x = item - r * w;
    const int seg = r / nb;
    const int b = r - seg * nb;
    const int xm = x == 0 ? w - 1 : x - 1;
    const int xp = x == w - 1 ? 0 : x + 1;
    const uint32_t* qb = q + b * hw;
    int* sb = s + b * hw;
    const int lane = lane0 + b;
    const float prob = stochastic ? spawn_prob[lane] : 0.0f;
    const int y0 = seg * rows;
    const int y1 = min(h, y0 + rows);

    uint32_t s_up, o_up, s_mid, o_mid;
    row_taps(qb + (y0 == 0 ? h - 1 : y0 - 1) * w, xm, x, xp, &s_up, &o_up);
    row_taps(qb + y0 * w, xm, x, xp, &s_mid, &o_mid);
    int i = y0 * w + x;
    for (int y = y0; y < y1; ++y, i += w) {
      uint32_t s_dn, o_dn;
      row_taps(qb + (y + 1 == h ? 0 : i + w - x), xm, x, xp, &s_dn, &o_dn);
      sb[i] = ca_rule(sb[i], s_up + s_mid + s_dn, o_up | o_mid | o_dn,
                      i + cell_offset, lane + lane_offset, stochastic, k0, k1,
                      prob);
      s_up = s_mid;
      o_up = o_mid;
      s_mid = s_dn;
      o_mid = o_dn;
    }
  }
  __syncthreads();
}

// The global-memory form of the CA step, for boards too large to stage
// (above MAX_CELLS of ops/physics.py): cells first, first + stride, ... of
// the h x w board `src` of batch lane `lane`, each read with its 3x3
// neighbourhood straight from device memory, every neighbour packed as it
// is read, into `dst`. Coins are drawn at counter (cell + cell_offset,
// lane + lane_offset). `src` is not __restrict__: K1 writes it earlier in
// the same kernel.
__device__ __forceinline__ void ca_cells_global(
    const int* src, int* __restrict__ dst, int h, int w, int first,
    int stride, int lane, bool stochastic, uint32_t k0, uint32_t k1,
    float prob, int lane_offset, int cell_offset) {
  const int hw = h * w;
  for (int i = first; i < hw; i += stride) {
    const int y = i / w;
    const int x = i - y * w;
    const int xm = x == 0 ? w - 1 : x - 1;
    const int xp = x == w - 1 ? 0 : x + 1;
    const int rows[3] = {(y == 0 ? h - 1 : y - 1) * w, y * w,
                         (y + 1 == h ? 0 : y + 1) * w};
    uint32_t sum = 0, orw = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t a = pack_cell(src[rows[k] + xm]);
      const uint32_t c = pack_cell(src[rows[k] + x]);
      const uint32_t d = pack_cell(src[rows[k] + xp]);
      sum += a + c + d;
      orw |= a | c | d;
    }
    dst[i] = ca_rule(src[i], sum, orw, i + cell_offset, lane + lane_offset,
                     stochastic, k0, k1, prob);
  }
}

}  // namespace sl
