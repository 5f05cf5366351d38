// Simulated-annealing pattern generator for SafeLife procedural levels.
//
// Behavioral parity target: the reference C annealer
// (safelife/speedups_src/gen_board.c) — a Metropolis sampler over a stack of
// `period` board layers representing one full oscillation cycle, where layer
// k+1 must equal advance(layer k) and the cycle must close. Candidate moves
// mutate one cell among {empty, wall, life, tree}; the move's cost is the
// change in rule violations, minus an oscillation bonus, plus density
// penalties per cell type. Sampling favors currently-violating cells, then
// seed cells, then any unmasked cell.
//
// This implementation is written fresh in C++17 (distributional fidelity,
// not draw-stream compatibility): its own indexed-set structure, its own
// splitmix/xoshiro RNG seeded from the caller, and a light-cone update that
// re-evolves only the affected region through the layer stack.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr uint16_t kAlive = 1 << 0;
constexpr uint16_t kDestructible = 1 << 3;
constexpr uint16_t kFrozen = 1 << 4;

// Cell palette the annealer may write.
constexpr uint16_t kCellTypes[4] = {
    0,                      // empty
    kFrozen,                // wall
    kAlive | kDestructible, // life
    kFrozen | kAlive,       // tree
};

enum MaskBits : int32_t {
  kNewCell = 1,
  kCanOscillate = 2,
  kIncludeViolations = 4,
};

enum ErrorCodes : int {
  kOk = 0,
  kMaxIterError = -1,
  kAreaTooSmallError = -3,
};

inline int paletteIndex(uint16_t cell) {
  // empty=0, wall=1, life=2, tree=3 (alive bit high, frozen bit low).
  return (((cell & kAlive) != 0) << 1) | ((cell & kFrozen) != 0);
}

// Dense integer set with O(1) add/remove/uniform-sample.
class IndexedSet {
 public:
  explicit IndexedSet(int capacity) : pos_(capacity, -1) {}

  bool contains(int v) const { return pos_[v] >= 0; }
  int size() const { return static_cast<int>(items_.size()); }

  void add(int v) {
    if (pos_[v] >= 0) return;
    pos_[v] = static_cast<int>(items_.size());
    items_.push_back(v);
  }

  void remove(int v) {
    int p = pos_[v];
    if (p < 0) return;
    int last = items_.back();
    items_[p] = last;
    pos_[last] = p;
    items_.pop_back();
    pos_[v] = -1;
  }

  template <typename Rng>
  int sample(Rng& rng) const {
    return items_[rng.below(static_cast<uint32_t>(items_.size()))];
  }

 private:
  std::vector<int> pos_;
  std::vector<int> items_;
};

// xoshiro256** seeded via splitmix64 — fast, solid host RNG.
class Rng {
 public:
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (auto& s : s_) {
      x += 0x9E3779B97F4A7C15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s = z ^ (z >> 31);
    }
  }

  uint64_t next() {
    auto rotl = [](uint64_t v, int k) {
      return (v << k) | (v >> (64 - k));
    };
    uint64_t result = rotl(s_[1] * 5, 7) * 9;
    uint64_t t = s_[1] << 17;
    s_[2] ^= s_[0];
    s_[3] ^= s_[1];
    s_[1] ^= s_[2];
    s_[0] ^= s_[3];
    s_[2] ^= t;
    s_[3] = rotl(s_[3], 45);
    return result;
  }

  double uniform() { return (next() >> 11) * 0x1.0p-53; }

  uint32_t below(uint32_t n) {
    return static_cast<uint32_t>((next() >> 32) * uint64_t(n) >> 32);
  }

 private:
  uint64_t s_[4];
};

// The evolving state: a period-deep stack of boards plus per-layer neighbor
// counts and per-cell violation/oscillation summaries.
class PatternState {
 public:
  PatternState(uint16_t* layers, const int32_t* mask, int period, int rows,
               int cols)
      : board_(layers), mask_(mask), period_(period), rows_(rows),
        cols_(cols), layerSize_(rows * cols),
        neighbors_(period * rows * cols, 0),
        violations_(rows * cols, 0), oscillations_(rows * cols, 0) {
    // Neighbor counts: 3x3 alive sums per layer (self included).
    for (int p = 0; p < period_; ++p) {
      for (int r = 0; r < rows_; ++r) {
        for (int c = 0; c < cols_; ++c) {
          int n = 0;
          for (int dr = -1; dr <= 1; ++dr)
            for (int dc = -1; dc <= 1; ++dc)
              n += board_[at(p, r + dr, c + dc)] & kAlive;
          neighbors_[at(p, r, c)] = n;
        }
      }
    }
    for (int i = 0; i < layerSize_; ++i) {
      oscillations_[i] = oscSummary(i);
      violations_[i] = cellViolations(i);
    }
  }

  int at(int layer, int r, int c) const {
    r %= rows_; if (r < 0) r += rows_;
    c %= cols_; if (c < 0) c += cols_;
    return layer * layerSize_ + r * cols_ + c;
  }

  // Dead/alive presence across layers: bit0 = some layer dead,
  // bit1 = some layer alive. 3 -> oscillating cell.
  int oscSummary(int i) const {
    int bits = 0;
    for (int p = 0; p < period_; ++p) {
      bits |= (board_[i + p * layerSize_] & kAlive) ? 2 : 1;
    }
    return bits;
  }

  // Rule violations for the cycle closure at cell i: advance of the last
  // layer must reproduce the first. Frozen cells must be layer-invariant.
  // Non-oscillatable oscillation adds one violation.
  int cellViolations(int i) const {
    uint16_t first = board_[i];
    if (first & kFrozen) return 0;
    int last = i + (period_ - 1) * layerSize_;
    uint16_t lastCell = board_[last];
    int n = neighbors_[last];
    int v;
    if (lastCell & kFrozen) {
      v = lastCell != first;
    } else if (lastCell & kAlive) {
      v = ((n == 3 || n == 4) != ((first & kAlive) != 0));
    } else {
      v = ((n == 3) != ((first & kAlive) != 0));
    }
    if (oscillations_[i] == 3 && !(mask_[i] & kCanOscillate)) v += 1;
    return v;
  }

  // Write a new cell value at (layer, r, c), maintaining neighbor counts.
  // Returns 0 if unchanged, 1 if frozen-only change, 2 if aliveness changed.
  int writeCell(int layer, int r, int c, uint16_t value) {
    int i = at(layer, r, c);
    uint16_t old = board_[i];
    if (old == value) return 0;
    board_[i] = value;
    int delta = (value & kAlive) - (old & kAlive);
    if (!delta) return 1;
    for (int dr = -1; dr <= 1; ++dr)
      for (int dc = -1; dc <= 1; ++dc)
        neighbors_[at(layer, r + dr, c + dc)] += delta;
    return 2;
  }

  struct Delta {
    int violations = 0;
    int oscillations = 0;
  };

  // Mutate cell (r, c) of layer 0 to `value` and re-evolve the light cone
  // through the stack; update violation/oscillation summaries in the
  // affected area. If `tracked` is non-null, maintain the violating-cell set.
  Delta mutate(int r, int c, uint16_t value, IndexedSet* tracked) {
    Delta out;
    int x1 = c, x2 = c, y1 = r, y2 = r;
    int kind = writeCell(0, r, c, value);
    if (kind == 0) return out;
    if (kind == 2) { --x1; --y1; ++x2; ++y2; }

    for (int layer = 1; layer < period_; ++layer) {
      int changed = 0;
      for (int rr = y1; rr <= y2; ++rr) {
        for (int cc = x1; cc <= x2; ++cc) {
          int src = at(layer - 1, rr, cc);
          uint16_t b1 = board_[src];
          int n = neighbors_[src];
          uint16_t b2;
          if (b1 & kFrozen) b2 = b1;
          else if (b1 & kAlive) b2 = (n == 3 || n == 4) ? b1 : 0;
          else b2 = (n == 3) ? kAlive : b1;
          int wrote = writeCell(layer, rr, cc, b2);
          changed |= wrote;
          if (wrote) {
            if (cc == x1) --x1;
            if (cc == x2) ++x2;
            if (rr == y1) --y1;
            if (rr == y2) ++y2;
          }
        }
      }
      if (!changed) break;
    }

    for (int rr = y1; rr <= y2; ++rr) {
      for (int cc = x1; cc <= x2; ++cc) {
        int i = at(0, rr, cc);
        int osc = oscSummary(i);
        int oldOsc = oscillations_[i];
        oscillations_[i] = osc;
        int v = cellViolations(i);
        out.violations += v - violations_[i];
        out.oscillations += (osc == 3) - (oldOsc == 3);
        violations_[i] = v;
        if (tracked) {
          if (v && (mask_[i] & kIncludeViolations)) tracked->add(i);
          else tracked->remove(i);
        }
      }
    }
    return out;
  }

  uint16_t cell(int i) const { return board_[i]; }
  int rows() const { return rows_; }
  int cols() const { return cols_; }
  int layerSize() const { return layerSize_; }
  int period() const { return period_; }
  const int32_t* mask() const { return mask_; }
  int violationsAt(int i) const { return violations_[i]; }

 private:
  uint16_t* board_;
  const int32_t* mask_;
  int period_, rows_, cols_, layerSize_;
  std::vector<int> neighbors_;
  std::vector<int> violations_;
  std::vector<int> oscillations_;
};

}  // namespace

extern "C" {

// layers: (period, rows, cols) uint16 — layer 0 is the pattern, layers 1..p-1
//   its pre-evolved successors (caller prepares them). Mutated in place;
//   layer 0 is the result.
// mask, seeds: (rows, cols) int32.
// penalties: 8 doubles — (base, at-t-1) pairs for empty/wall/life/tree; the
//   empty entry is ignored (fill-progress penalty is built in).
int sl_gen_pattern(uint16_t* layers, const int32_t* mask,
                   const int32_t* seeds, int period, int rows, int cols,
                   double rel_max_iter, double rel_min_fill,
                   double temperature, double osc_bonus,
                   const double* penalties, uint64_t seed) {
  PatternState state(layers, mask, period, rows, cols);
  Rng rng(seed);
  const int layerSize = rows * cols;

  IndexedSet bad(layerSize), seedSet(layerSize), unmasked(layerSize);
  int totals[4] = {0, 0, 0, 0};
  int totalArea = 0;
  for (int i = 0; i < layerSize; ++i) {
    if (seeds[i]) seedSet.add(i);
    if (state.violationsAt(i) && (mask[i] & kIncludeViolations)) bad.add(i);
    if (mask[i] & kNewCell) {
      unmasked.add(i);
      ++totalArea;
      ++totals[paletteIndex(state.cell(i))];
    }
  }
  if (totalArea == 0) return kAreaTooSmallError;

  const long maxIter = static_cast<long>(rel_max_iter * totalArea * period);
  const double minFill = rel_min_fill * totalArea;
  const double beta = 1.0 / temperature;
  const int radius = period;

  std::vector<double> cumProb;
  std::vector<int> candCell;
  std::vector<uint16_t> candType;

  long iter = 0;
  for (; iter < maxIter; ++iter) {
    int notEmpty = totalArea - totals[0];
    if (bad.size() == 0 && notEmpty >= minFill) return kOk;

    int k0 = bad.size() > 0 ? bad.sample(rng)
             : seedSet.size() > 0 ? seedSet.sample(rng)
                                  : unmasked.sample(rng);
    seedSet.remove(k0);  // each seed is sampled at most once
    int r0 = k0 / cols, c0 = k0 % cols;

    // Density penalties for this iteration.
    double pen[4];
    {
      double t = notEmpty / minFill;
      pen[0] = t < 0.9 ? 2.0 : t < 1.0 ? 20.0 * (1.0 - t) : 0.0;
    }
    for (int j = 1; j < 4; ++j) {
      double t = totals[j] / (notEmpty + 1.0);
      pen[j] = penalties[2 * j] + t * (penalties[2 * j + 1] - penalties[2 * j]);
    }

    // Evaluate switching every unmasked cell in the extended neighborhood
    // through the three alternative palette entries.
    cumProb.clear();
    candCell.clear();
    candType.clear();
    double maxLogProb = -1e100;
    for (int r = r0 - radius; r <= r0 + radius; ++r) {
      for (int c = c0 - radius; c <= c0 + radius; ++c) {
        int i1 = state.at(0, r, c);
        if (!(state.mask()[i1] & kNewCell)) continue;
        uint16_t current = state.cell(i1);
        int base = paletteIndex(current);
        int dViol = 0, dOsc = 0;
        for (int j = base + 1; j < base + 4; ++j) {
          uint16_t target = kCellTypes[j & 3];
          auto d = state.mutate(r, c, target, nullptr);
          dViol += d.violations;
          dOsc += d.oscillations;
          double lp = -beta * (dViol - osc_bonus * dOsc + pen[j & 3]);
          if (lp > maxLogProb) maxLogProb = lp;
          cumProb.push_back(lp);  // log-prob for now; normalized below
          candCell.push_back(i1);
          candType.push_back(target);
        }
        state.mutate(r, c, current, nullptr);  // restore
      }
    }
    if (cumProb.empty()) continue;

    double total = 0.0;
    for (auto& lp : cumProb) {
      total += std::exp(lp - maxLogProb);
      lp = total;
    }
    double pick = rng.uniform() * total;
    for (size_t k = 0; k < cumProb.size(); ++k) {
      if (cumProb[k] > pick) {
        int i = candCell[k];
        uint16_t oldCell = state.cell(i);
        state.mutate(i / cols, i % cols, candType[k], &bad);
        --totals[paletteIndex(oldCell)];
        ++totals[paletteIndex(candType[k])];
        break;
      }
    }
  }
  return kMaxIterError;
}

// Connected-component labeling with toroidal wrap and 8-connectivity.
// data: (rows, cols) int32 (nonzero = foreground); labels out: int32.
// Returns the number of labels.
int sl_wrapped_label(const int32_t* data, int32_t* labels, int rows,
                     int cols) {
  const int n = rows * cols;
  std::vector<int32_t> parent(n);
  for (int i = 0; i < n; ++i) parent[i] = i;

  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  auto unite = [&](int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b] = a;
  };

  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < cols; ++c) {
      int i = r * cols + c;
      if (!data[i]) continue;
      // Union with the 4 already-visited neighbors (NW, N, NE, W), wrapped.
      int rm = (r - 1 + rows) % rows;
      int cm = (c - 1 + cols) % cols;
      int cp = (c + 1) % cols;
      const int nbrs[4] = {rm * cols + cm, rm * cols + c, rm * cols + cp,
                           r * cols + cm};
      for (int nb : nbrs)
        if (data[nb]) unite(i, nb);
    }
  }

  std::vector<int32_t> names(n, 0);
  int next = 0;
  for (int i = 0; i < n; ++i) {
    if (!data[i]) {
      labels[i] = 0;
      continue;
    }
    int root = find(i);
    if (!names[root]) names[root] = ++next;
    labels[i] = names[root];
  }
  return next;
}

}  // extern "C"
