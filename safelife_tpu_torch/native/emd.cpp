// Exact earth mover's distance with unequal masses (Pele and Werman's
// EMD-hat, its partial-transport part) by the primal network simplex.
//
// The problem: sources i with masses a_i, sinks j with masses b_j, an arc
// i -> j of cost dist[i][j] >= 0 for every pair. One dummy node on the
// lighter side takes the surplus |sum a - sum b| at zero cost, so the
// problem is a balanced transportation problem whose optimum is the least
// cost of moving min(sum a, sum b).
//
// The method is the network simplex of LEMON (Kovacs 2015) with the block
// search pivot rule of Bonneel et al. 2011:
//
// * An artificial root is joined to every node. The first tree holds those
//   arcs, each carrying its node's mass: node -> root for a source, root ->
//   node for a sink. Every arc of zero flow points to the root, so the tree
//   is strongly feasible.
// * An artificial arc root -> node costs M (big-M), one node -> root costs 0.
//   Every potential is s * M + r with s in {0, 1} kept apart from r, the sum
//   of real costs along the tree path, so reduced costs between nodes of one
//   s are computed from real costs alone: adding M would round them.
// * The entering arc has the most negative reduced cost in the first block
//   of sqrt(arcs) arcs, from where the last search stopped, that has one.
// * The leaving arc is the last blocking arc of the cycle walked in the
//   direction of its flow from the apex (Cunningham's rule), so the tree
//   stays strongly feasible and degenerate pivots cannot cycle.
// * A pivot re-hangs the subtree that the leaving arc cuts off under the
//   entering arc, and recomputes its depths and potentials from its new
//   parent: a potential is always the sum of costs along its tree path,
//   never a sum of updates.
//
// It stops only when no arc prices below -eps, eps = 1e-12 * max dist: an
// optimal basis up to rounding. It returns a status, never a value, when
// the input is not a transportation problem, when the pivots pass
// kMaxPivotsPerArc times the arcs (the sign of cycling), or when mass is
// left on an artificial arc.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <new>
#include <vector>

namespace {

enum Status : int {
  kOk = 0,
  kBadInput = 1,       // a size below 1, a mass or a cost negative or NaN
  kUnbounded = 2,      // a cycle without a blocking arc
  kNoConvergence = 3,  // more than kMaxPivotsPerArc pivots an arc
  kInfeasible = 4,     // mass left on an artificial arc
  kNoMemory = 5,
};

constexpr int kUp = 1;     // the tree arc runs from the node to its parent
constexpr int kDown = -1;  // the tree arc runs from the parent to the node
constexpr int kNone = -1;
constexpr int64_t kArtificial = -1;
constexpr int64_t kMaxPivotsPerArc = 64;
constexpr double kEpsilon = 1e-12;  // of the largest cost: optimality
constexpr double kResidual = 1e-12;  // of the mass: artificial flow left

class Simplex {
 public:
  // cost: [ns * nt] row-major, the dummy's row or column included.
  Simplex(int ns, int nt, std::vector<double> cost,
          const std::vector<double>& supply, double max_cost)
      : ns_(ns), nt_(nt), nodes_(ns + nt), root_(ns + nt),
        arcs_(int64_t(ns) * nt), cost_(std::move(cost)),
        lower_(arcs_, 1.0), parent_(nodes_ + 1, kNone),
        depth_(nodes_ + 1, 0), first_child_(nodes_ + 1, kNone),
        next_sib_(nodes_ + 1, kNone), prev_sib_(nodes_ + 1, kNone),
        pred_(nodes_ + 1, kArtificial), dir_(nodes_ + 1, kUp),
        flow_(nodes_ + 1, 0.0), pot_s_(nodes_ + 1, 0.0),
        pot_r_(nodes_ + 1, 0.0) {
    eps_ = kEpsilon * max_cost;
    // Above any |cost + r_i - r_j|: r is a sum of at most nodes_ costs.
    big_ = 4.0 * (max_cost + 1.0) * (nodes_ + 1.0);
    block_ = std::max<int64_t>(
        10, int64_t(std::ceil(std::sqrt(double(arcs_)))));
    for (int u = 0; u < nodes_; ++u) {
      link(u, root_);
      parent_[u] = root_;
      depth_[u] = 1;
      if (supply[u] >= 0) {
        dir_[u] = kUp;
        flow_[u] = supply[u];
      } else {
        dir_[u] = kDown;
        flow_[u] = -supply[u];
        pot_s_[u] = 1.0;
      }
    }
  }

  int solve(double mass, double* cost_out) {
    int64_t pivots = 0;
    const int64_t max_pivots = kMaxPivotsPerArc * (arcs_ + nodes_);
    int64_t in;
    while ((in = entering()) >= 0) {
      if (++pivots > max_pivots) return kNoConvergence;
      int st = pivot(in);
      if (st != kOk) return st;
    }
    double total = 0.0;
    for (int u = 0; u < nodes_; ++u) {
      if (pred_[u] == kArtificial) {
        if (flow_[u] > kResidual * mass) return kInfeasible;
      } else {
        total += flow_[u] * cost_[pred_[u]];
      }
    }
    *cost_out = total;
    return kOk;
  }

 private:
  void link(int u, int p) {
    next_sib_[u] = first_child_[p];
    prev_sib_[u] = kNone;
    if (first_child_[p] != kNone) prev_sib_[first_child_[p]] = u;
    first_child_[p] = u;
  }

  void unlink(int u) {
    if (prev_sib_[u] != kNone) {
      next_sib_[prev_sib_[u]] = next_sib_[u];
    } else {
      first_child_[parent_[u]] = next_sib_[u];
    }
    if (next_sib_[u] != kNone) prev_sib_[next_sib_[u]] = prev_sib_[u];
  }

  // Block search: the arc of the most negative reduced cost below -eps in
  // the first block, from next_, that has one; -1 when no arc has one.
  int64_t entering() {
    const double* rs = pot_r_.data() + ns_;
    const double* ss = pot_s_.data() + ns_;
    double best = -eps_;
    int64_t best_e = -1;
    int64_t e = next_, scanned = 0, left = block_;
    while (scanned < arcs_) {
      const int i = int(e / nt_);
      const int j0 = int(e - int64_t(i) * nt_);
      int64_t len = std::min<int64_t>(nt_ - j0, left);
      len = std::min<int64_t>(len, arcs_ - scanned);
      const double ri = pot_r_[i], si = pot_s_[i];
      const double* c = cost_.data() + e;
      const double* lo = lower_.data() + e;
      for (int k = 0; k < int(len); ++k) {
        const int j = j0 + k;
        const double v =
            lo[k] * (c[k] + ri - rs[j] + big_ * (si - ss[j]));
        if (v < best) {
          best = v;
          best_e = e + k;
        }
      }
      e += len;
      if (e == arcs_) e = 0;
      scanned += len;
      left -= len;
      if (left == 0) {
        if (best_e >= 0) break;
        left = block_;
      }
    }
    next_ = e;
    return best_e;
  }

  int pivot(int64_t in) {
    const int first = int(in / nt_);            // the source: flow leaves it
    const int second = ns_ + int(in % nt_);     // the sink: flow enters it
    int u = first, v = second;
    while (depth_[u] > depth_[v]) u = parent_[u];
    while (depth_[v] > depth_[u]) v = parent_[v];
    while (u != v) {
      u = parent_[u];
      v = parent_[v];
    }
    const int join = u;

    // Flow runs down from the apex to `first`, over the entering arc, and
    // up from `second` to the apex; the arcs it runs against block.
    double delta = std::numeric_limits<double>::infinity();
    int out = kNone;
    bool out_first = false;
    for (u = first; u != join; u = parent_[u]) {
      if (dir_[u] == kUp && flow_[u] < delta) {
        delta = flow_[u];
        out = u;
        out_first = true;
      }
    }
    for (u = second; u != join; u = parent_[u]) {
      if (dir_[u] == kDown && flow_[u] <= delta) {
        delta = flow_[u];
        out = u;
        out_first = false;
      }
    }
    if (out == kNone) return kUnbounded;
    if (delta > 0) {
      for (u = first; u != join; u = parent_[u])
        flow_[u] += dir_[u] == kUp ? -delta : delta;
      for (u = second; u != join; u = parent_[u])
        flow_[u] += dir_[u] == kDown ? -delta : delta;
    }
    if (pred_[out] != kArtificial) lower_[pred_[out]] = 1.0;
    lower_[in] = 0.0;

    // Re-hang the cut-off subtree from its end of the entering arc: the
    // path from there up to `out` turns over.
    const int top = out_first ? first : second;
    int p = out_first ? second : first;
    int64_t arc = in;
    int d = out_first ? kUp : kDown;
    double f = delta;
    for (v = top;;) {
      const int op = parent_[v];
      const int64_t oarc = pred_[v];
      const int od = dir_[v];
      const double of = flow_[v];
      unlink(v);
      parent_[v] = p;
      pred_[v] = arc;
      dir_[v] = d;
      flow_[v] = f;
      link(v, p);
      if (v == out) break;
      p = v;
      arc = oarc;
      d = -od;
      f = of;
      v = op;
    }
    refresh(top);
    return kOk;
  }

  // Depths and potentials of the subtree under `top` from its parent.
  void refresh(int top) {
    stack_.clear();
    stack_.push_back(top);
    while (!stack_.empty()) {
      const int u = stack_.back();
      stack_.pop_back();
      const int p = parent_[u];
      const double c = cost_[pred_[u]];
      depth_[u] = depth_[p] + 1;
      pot_s_[u] = pot_s_[p];
      pot_r_[u] = dir_[u] == kDown ? pot_r_[p] + c : pot_r_[p] - c;
      for (int w = first_child_[u]; w != kNone; w = next_sib_[w])
        stack_.push_back(w);
    }
  }

  const int ns_, nt_, nodes_, root_;
  const int64_t arcs_;
  std::vector<double> cost_;
  std::vector<double> lower_;  // 1 for an arc at flow 0, 0 for a tree arc
  // Per node, the root included: the tree and the arc to the parent.
  std::vector<int> parent_, depth_, first_child_, next_sib_, prev_sib_;
  std::vector<int64_t> pred_;
  std::vector<int> dir_;
  std::vector<double> flow_;
  std::vector<double> pot_s_, pot_r_;  // potential = pot_s * big + pot_r
  std::vector<int> stack_;
  double eps_ = 0.0, big_ = 0.0;
  int64_t block_ = 0, next_ = 0;
};

bool valid(double x) { return std::isfinite(x) && x >= 0.0; }

}  // namespace

extern "C" {

// The least cost of moving min(sum a, sum b) from the n masses `a` to the
// m masses `b` under the costs `dist` ([n * m], row-major). Writes the cost
// to *cost_out and returns 0; any other value is a Status and writes
// nothing.
int sl_emd_hat(int n, int m, const double* a, const double* b,
               const double* dist, double* cost_out) {
  if (n < 1 || m < 1) return kBadInput;
  try {
    double sa = 0.0, sb = 0.0, max_cost = 0.0;
    for (int i = 0; i < n; ++i) {
      if (!valid(a[i])) return kBadInput;
      sa += a[i];
    }
    for (int j = 0; j < m; ++j) {
      if (!valid(b[j])) return kBadInput;
      sb += b[j];
    }
    const int64_t nm = int64_t(n) * m;
    for (int64_t e = 0; e < nm; ++e) {
      if (!valid(dist[e])) return kBadInput;
      max_cost = std::max(max_cost, dist[e]);
    }
    // The dummy: a source for b's surplus, a sink for a's.
    const int ns = n + (sb > sa), nt = m + (sa > sb);
    std::vector<double> cost(int64_t(ns) * nt, 0.0);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < m; ++j)
        cost[int64_t(i) * nt + j] = dist[int64_t(i) * m + j];
    std::vector<double> supply(ns + nt, 0.0);
    for (int i = 0; i < n; ++i) supply[i] = a[i];
    if (sb > sa) supply[n] = sb - sa;
    for (int j = 0; j < m; ++j) supply[ns + j] = -b[j];
    if (sa > sb) supply[ns + m] = sb - sa;
    Simplex s(ns, nt, std::move(cost), supply, max_cost);
    return s.solve(std::max(sa, sb), cost_out);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
