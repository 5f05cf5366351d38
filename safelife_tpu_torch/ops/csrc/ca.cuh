// Shared device code of the SafeLife kernels K1 (physics.cu) and K2
// (advance.cu): cell constants, the Philox4x32-10 spawn draw, the packed
// cell word, the one-cell CA rule, and the block-level passes both kernels
// are built from (staging copies and the separable CA step, for whole
// boards and for tiles of larger ones).
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
// * Separable neighbourhood (`ca_step_block`, `walk_tile`). One thread
//   owns a column (or a segment of one) and walks down its rows, keeping
//   the horizontal 3-tap sum and OR of three rows in registers; each row's
//   horizontal taps are computed once (`row_taps`), and the vertical step
//   is one 3-input add and one 3-input OR. Row and column come from the
//   loop, so no cell needs a division.
// * Boards of up to MAX_CELLS (ops/physics.py): several boards per block;
//   the wrapper picks the count from (H, W) so that columns fill warps;
//   the boards of one block are contiguous in device memory and are staged
//   with asynchronous 16-byte copies (`stage_in`) and stored with 16-byte
//   stores (`store_out`). Only the row counter wraps.
// * Larger boards: a block takes one tile of one board, R rows x C
//   columns staged with a one-cell halo ring (`Tile`, `stage_tile_async`),
//   so the walk reads the halo instead of wrapping; the halo's packs are
//   the tiling's only extra operations, about (2R + 2C + 4) / (R C) a
//   cell (ops/physics.py::tile_shape picks R, C and the threads).
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

// One asynchronous copy (`cp.async`) of 16 bytes (both addresses 16-byte
// aligned) or of 4 bytes from device to shared memory: no register
// staging, all of a thread's copies in flight at once.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// Starts copying n ints from device to shared memory with all of the
// block's threads: asynchronous 16-byte copies where both addresses are
// 16-byte aligned (the wrapper's block sizes make them so for the usual
// boards), one int at a time for the tail or otherwise. The copies are
// complete after `stage_wait` and a barrier.
__device__ __forceinline__ void stage_async(int* __restrict__ dst,
                                            const int* __restrict__ src,
                                            int n) {
  int done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
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

// ---------------------------------------------------------------------------
// Tiles of boards above MAX_CELLS.
//
// Tile t of an h x w board cut into tiles of R x C cells (row-major over
// the tiles, the last row and column of tiles possibly smaller) holds
// board rows [y0, y0 + r) and columns [x0, x0 + c). It is staged as r + 2
// rows of `tile_stride(C)` words: staged row k is board row y0 - 1 + k and
// its word 3 + j board column x0 - 1 + j, both wrapped round the torus, so
// the tile's own cells start at word 4 of rows 1 .. r, 16-byte aligned,
// and the halo ring lies around them. Words 0-2 and those past c + 4 are
// never written.

struct Tile {
  int y0, x0, r, c;
  int stride;
};

__host__ __device__ inline int tile_stride(int cols) {
  return (cols + 8) & ~3;  // cols + 5 words, rounded up to 16 bytes
}

// Shared bytes of one staged tile and its packed words.
__host__ __device__ inline int tile_smem_bytes(int rows, int cols) {
  return 2 * (rows + 2) * tile_stride(cols) * (int)sizeof(int);
}

__device__ __forceinline__ Tile tile_at(int t, int h, int w, int rows,
                                        int cols) {
  const int nx = (w + cols - 1) / cols;
  const int ty = t / nx;
  Tile tl;
  tl.y0 = ty * rows;
  tl.x0 = (t - ty * nx) * cols;
  tl.r = min(rows, h - tl.y0);
  tl.c = min(cols, w - tl.x0);
  tl.stride = tile_stride(cols);
  return tl;
}

// Calls f(i, j) for every (i, j) of an n x m grid, the block's threads
// taking them in row-major order, with no division past the first.
template <class F>
__device__ __forceinline__ void block_grid(int n, int m, F f) {
  if (m <= 0) return;
  const int di = blockDim.x / m, dj = blockDim.x - di * m;
  int i = threadIdx.x / m, j = threadIdx.x - i * m;
  while (i < n) {
    f(i, j);
    i += di;
    j += dj;
    if (j >= m) {
      j -= m;
      ++i;
    }
  }
}

// Starts staging tile `t` of board `g` into `s` with all of the block's
// threads: the tile's columns of its rows and of the halo rows above and
// below by asynchronous 16-byte copies where `vec` (the caller's check
// that the board, W and C are 16-byte aligned), else 4-byte ones; the two
// halo columns 4 bytes a copy. Complete after `stage_wait` and a barrier.
__device__ __forceinline__ void stage_tile_async(int* __restrict__ s,
                                                 const int* g, const Tile& t,
                                                 int h, int w, bool vec) {
  const int rows = t.r + 2;
  if (vec) {
    block_grid(rows, t.c >> 2, [&](int k, int j) {
      const int gy = wrap1(t.y0 - 1 + k, h);
      cp_async16(s + k * t.stride + 4 + 4 * j, g + gy * w + t.x0 + 4 * j);
    });
  } else {
    block_grid(rows, t.c, [&](int k, int j) {
      const int gy = wrap1(t.y0 - 1 + k, h);
      cp_async4(s + k * t.stride + 4 + j, g + gy * w + t.x0 + j);
    });
  }
  const int xl = wrap1(t.x0 - 1, w), xr = wrap1(t.x0 + t.c, w);
  block_grid(rows, 2, [&](int k, int right) {
    const int gy = wrap1(t.y0 - 1 + k, h);
    cp_async4(s + k * t.stride + (right ? 4 + t.c : 3),
              g + gy * w + (right ? xr : xl));
  });
  asm volatile("cp.async.commit_group;\n" ::);
}

// Packs the staged words of `t` once each, q = pack_cell(s), 16 bytes at
// a time over whole staged rows (the words around the staged ones are
// packed too and never read), with `n_threads` threads, this one `tid`.
__device__ __forceinline__ void pack_tile(const int* __restrict__ s,
                                          uint32_t* __restrict__ q,
                                          const Tile& t, int tid,
                                          int n_threads) {
  const int n4 = ((t.r + 2) * t.stride) >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(s);
  uint4* q4 = reinterpret_cast<uint4*>(q);
  for (int i = tid; i < n4; i += n_threads) {
    const int4 v = s4[i];
    q4[i] = make_uint4(pack_cell(v.x), pack_cell(v.y), pack_cell(v.z),
                       pack_cell(v.w));
  }
}

// One CA step of tile `t`'s own cells, in place in `s`, from the packed
// words `q` (halo included). Threads are (segment, column) items of
// `pad_cols` columns (C rounded up to whole warps) by segments of `rows`
// rows; an item walks its column down its segment. Cell (y, x) of the
// tile draws its coin at counter (its index in the whole board +
// cell_offset, lane + lane_offset), mod 2^32.
__device__ __forceinline__ void walk_tile(
    int* __restrict__ s, const uint32_t* __restrict__ q, const Tile& t,
    int w, int pad_cols, int rows, int lane, bool stochastic, uint32_t k0,
    uint32_t k1, float prob, int lane_offset, int cell_offset) {
  const int items = pad_cols * ((t.r + rows - 1) / rows);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int seg = item / pad_cols;
    const int x = item - seg * pad_cols;
    if (x >= t.c) continue;
    const int ya = seg * rows, yb = min(t.r, ya + rows);
    // Staged row ya is the row above the segment's first; word 3 + x the
    // column left of x.
    const uint32_t* qc = q + ya * t.stride + 3 + x;
    uint32_t s_up, o_up, s_mid, o_mid;
    row_taps(qc, 0, 1, 2, &s_up, &o_up);
    qc += t.stride;
    row_taps(qc, 0, 1, 2, &s_mid, &o_mid);
    int* sc = s + (ya + 1) * t.stride + 4 + x;
    uint32_t cell = (uint32_t)((t.y0 + ya) * w + t.x0 + x) +
                    (uint32_t)cell_offset;
    for (int y = ya; y < yb; ++y) {
      qc += t.stride;
      uint32_t s_dn, o_dn;
      row_taps(qc, 0, 1, 2, &s_dn, &o_dn);
      *sc = ca_rule(*sc, s_up + s_mid + s_dn, o_up | o_mid | o_dn, (int)cell,
                    lane + lane_offset, stochastic, k0, k1, prob);
      s_up = s_mid;
      o_up = o_mid;
      s_mid = s_dn;
      o_mid = o_dn;
      sc += t.stride;
      cell += (uint32_t)w;
    }
  }
}

// Stores tile `t`'s own cells from `s` to board `g`, 16 bytes a store
// where `vec` (as for `stage_tile_async`).
__device__ __forceinline__ void store_tile(int* g, const int* __restrict__ s,
                                           const Tile& t, int w, bool vec) {
  if (vec) {
    block_grid(t.r, t.c >> 2, [&](int y, int j) {
      *reinterpret_cast<int4*>(g + (t.y0 + y) * w + t.x0 + 4 * j) =
          *reinterpret_cast<const int4*>(s + (y + 1) * t.stride + 4 + 4 * j);
    });
  } else {
    block_grid(t.r, t.c, [&](int y, int x) {
      g[(t.y0 + y) * w + t.x0 + x] = s[(y + 1) * t.stride + 4 + x];
    });
  }
}

// Whether tile staging and stores of boards `a` and `b` can move 16
// bytes at a time: both 16-byte aligned, and W and C multiples of 4.
__device__ __forceinline__ bool tile_vec(const void* a, const void* b, int w,
                                         int cols) {
  return ((((uintptr_t)a | (uintptr_t)b) & 15) | (w & 3) | (cols & 3)) == 0;
}

}  // namespace sl
