// Native (C++) kernels and engine for waffle_con_tpu.
//
// Provides the serial-CPU implementation of the framework's two layers:
//   1. the incremental dynamic-WFA kernel + a WavefrontScorer-compatible
//      branch store (exact behavioral parity with ops/dwfa.py — the
//      executable spec — and transitively with the reference
//      /root/reference/src/dynamic_wfa.rs);
//   2. a complete single-consensus search engine (parity with
//      models/consensus.py, i.e. /root/reference/src/consensus.rs) used
//      as the CPU baseline in bench.py.
//
// Wavefronts use centered diagonal coordinates: diagonal k = (other
// consumed) - (baseline consumed) ranges over [-e, +e]; the stored value
// is bases consumed in `other` beyond `offset`; the baseline position of
// a lane is d - k.
//
// Exposed as a C ABI for ctypes (see ../__init__.py).

#include <algorithm>
#include <array>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <optional>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using std::size_t;
using i64 = long long;
using Bytes = std::vector<uint8_t>;

// ---------------------------------------------------------------------
// L0: incremental dynamic WFA (parity: ops/dwfa.py::DWFALite)

struct DWFA {
  i64 e = 0;
  std::vector<i64> wf{0};  // index i <-> diagonal k = i - e
  i64 offset = 0;

  void extend(const Bytes& baseline, const Bytes& other, int wildcard) {
    const i64 blen = (i64)baseline.size();
    const i64 olen = (i64)other.size();
    for (size_t i = 0; i < wf.size(); ++i) {
      i64 d = wf[i];
      const i64 k = (i64)i - e;
      i64 bo = d - k;
      i64 oo = d + offset;
      while (bo < blen && oo < olen) {
        const int b = baseline[(size_t)bo];
        if (b != other[(size_t)oo] && b != wildcard) break;
        ++d; ++bo; ++oo;
      }
      wf[i] = d;
    }
  }

  void escalate(const Bytes& baseline, const Bytes& other, int wildcard) {
    const size_t n = wf.size();
    ++e;
    std::vector<i64> nw(n + 2, 0);
    for (size_t i = 0; i < n; ++i) {
      const i64 d = wf[i];
      nw[i] = std::max(nw[i], d);          // baseline deletion
      nw[i + 1] = std::max(nw[i + 1], d + 1);  // mismatch
      nw[i + 2] = std::max(nw[i + 2], d + 1);  // insertion into baseline
    }
    wf.swap(nw);
    extend(baseline, other, wildcard);
  }

  i64 max_other() const {
    i64 m = std::numeric_limits<i64>::min();
    for (i64 d : wf) m = std::max(m, d);
    return offset + m;
  }

  i64 max_baseline() const {
    i64 m = std::numeric_limits<i64>::min();
    for (size_t i = 0; i < wf.size(); ++i) m = std::max(m, wf[i] - ((i64)i - e));
    return m;
  }

  bool reached_end(const Bytes& baseline) const {
    return max_baseline() == (i64)baseline.size();
  }

  void update(const Bytes& baseline, const Bytes& other, int wildcard,
              bool early_term) {
    extend(baseline, other, wildcard);
    const i64 target = (i64)other.size();
    while (max_other() < target && !(early_term && reached_end(baseline))) {
      escalate(baseline, other, wildcard);
    }
  }

  void finalize(const Bytes& baseline, const Bytes& other, int wildcard) {
    const i64 blen = (i64)baseline.size();
    while (max_baseline() < blen) escalate(baseline, other, wildcard);
  }

  // tip votes for the next consensus symbol: lanes that consumed all of
  // `other`, voting the baseline char they face
  void tips(const Bytes& baseline, const Bytes& other,
            std::map<int, i64>& votes) const {
    const i64 olen = (i64)other.size();
    const i64 blen = (i64)baseline.size();
    for (size_t i = 0; i < wf.size(); ++i) {
      const i64 d = wf[i];
      if (d + offset == olen) {
        const i64 bo = d - ((i64)i - e);
        if (bo < blen) votes[baseline[(size_t)bo]] += 1;
      }
    }
  }
};

// one-shot WFA edit distance (parity: ops/alignment.py::wfa_ed_config)
i64 wfa_ed_config(const uint8_t* v1, i64 l1, const uint8_t* v2, i64 l2,
                  bool require_both_end, int wildcard) {
  std::vector<std::pair<i64, i64>> curr{{0, 0}};
  i64 edits = 0;
  for (;;) {
    std::vector<std::pair<i64, i64>> next(2 * edits + 3, {0, 0});
    for (size_t w = 0; w < curr.size(); ++w) {
      i64 i = curr[w].first, j = curr[w].second;
      while (i < l1 && j < l2 &&
             (v1[i] == v2[j] || v1[i] == wildcard || v2[j] == wildcard)) {
        ++i; ++j;
      }
      if (j == l2 && (i == l1 || !require_both_end)) return edits;
      std::pair<i64, i64> a, b, c;
      if (i == l1) {
        a = {i, j}; b = {i, j + 1}; c = {i, j + 1};
      } else if (j == l2) {
        a = {i + 1, j}; b = {i + 1, j}; c = {i, j};
      } else {
        a = {i + 1, j}; b = {i + 1, j + 1}; c = {i, j + 1};
      }
      next[w] = std::max(next[w], a);
      next[w + 1] = std::max(next[w + 1], b);
      next[w + 2] = std::max(next[w + 2], c);
    }
    ++edits;
    curr.swap(next);
  }
}

// ---------------------------------------------------------------------
// scorer branch store (parity: ops/scorer.py::PythonScorer)

struct Scorer {
  std::vector<Bytes> reads;
  std::vector<int> symtab;              // dense id -> byte
  std::array<int, 256> sym_id;          // byte -> dense id (or -1)
  int wildcard = -1;                    // byte value or -1
  bool early_term = false;
  std::unordered_map<i64, std::vector<std::optional<DWFA>>> branches;
  i64 next_handle = 0;

  size_t R() const { return reads.size(); }
  size_t A() const { return symtab.size(); }
};

void scorer_snapshot(Scorer& s, const std::vector<std::optional<DWFA>>& dwfas,
                     const Bytes& cons, i64* eds, i64* occ, i64* split,
                     uint8_t* reached) {
  const size_t R = s.R(), A = s.A();
  std::fill(eds, eds + R, 0);
  std::fill(occ, occ + R * A, 0);
  std::fill(split, split + R, 0);
  std::fill(reached, reached + R, 0);
  std::map<int, i64> votes;
  for (size_t r = 0; r < R; ++r) {
    if (!dwfas[r]) continue;
    const DWFA& dw = *dwfas[r];
    eds[r] = dw.e;
    reached[r] = dw.reached_end(s.reads[r]) ? 1 : 0;
    votes.clear();
    dw.tips(s.reads[r], cons, votes);
    i64 total = 0;
    for (auto& [sym, count] : votes) {
      occ[r * A + s.sym_id[sym]] = count;
      total += count;
    }
    split[r] = total;
  }
}

// ---------------------------------------------------------------------
// single-consensus engine (parity: models/consensus.py::ConsensusDWFA)

struct EngineConfig {
  int cost_l2 = 0;                 // 0 = L1, 1 = L2
  i64 max_queue_size = 20;
  i64 max_capacity_per_size = 20;
  i64 max_return_size = 10;
  i64 max_nodes_wo_constraint = 1000;
  i64 min_count = 3;
  double min_af = 0.0;
  int wildcard = -1;
  int allow_early_termination = 0;
  int auto_shift_offsets = 1;
  i64 offset_window = 50;
  i64 offset_compare_length = 50;
};

struct Tracker {
  std::vector<i64> length_counts, processed_counts;
  i64 total = 0, thr = 0, cap = 0;
  explicit Tracker(size_t n, i64 capacity) : length_counts(n, 0), processed_counts(n, 0), cap(capacity) {}
  void ensure(std::vector<i64>& v, size_t n) { if (v.size() <= n) v.resize(n + 1, 0); }
  void insert(i64 v) { ensure(length_counts, v); length_counts[v]++; if (v >= thr) total++; }
  void remove(i64 v) { length_counts[v]--; if (v >= thr) total--; }
  void inc_threshold() { if ((size_t)thr < length_counts.size()) total -= length_counts[thr]; thr++; }
  bool process(i64 v) { ensure(processed_counts, v); if (processed_counts[v] >= cap) return false; processed_counts[v]++; return true; }
  bool at_capacity(i64 v) const {
    return (size_t)v < processed_counts.size() && processed_counts[v] >= cap;
  }
};

struct Node {
  Bytes consensus;
  std::vector<std::optional<DWFA>> dwfas;
  i64 cost = 0;

  i64 total_cost(bool l2) const {
    i64 t = 0;
    for (auto& d : dwfas)
      if (d) t += l2 ? d->e * d->e : d->e;
    return t;
  }
};

struct Result {
  Bytes sequence;
  std::vector<i64> scores;
};

i64 activation_offset(const Bytes& cons, const Bytes& seq, const EngineConfig& cfg) {
  const i64 cmp = std::min<i64>(cfg.offset_compare_length, (i64)seq.size());
  const i64 clen = (i64)cons.size();
  const i64 start = std::max<i64>(0, clen - (cfg.offset_window + cmp));
  const i64 end = std::max<i64>(0, clen - cmp);
  i64 best = std::max<i64>(0, clen - (cmp + cfg.offset_window / 2));
  i64 best_ed = wfa_ed_config(cons.data() + best, clen - best, seq.data(), cmp,
                              false, cfg.wildcard);
  for (i64 p = start; p < end; ++p) {
    i64 ed = wfa_ed_config(cons.data() + p, clen - p, seq.data(), cmp, false,
                           cfg.wildcard);
    if (ed < best_ed) { best_ed = ed; best = p; }
  }
  return best;
}

// error codes
constexpr int ERR_OK = 0;
constexpr int ERR_NO_INITIAL = 1;       // no initially active sequence
constexpr int ERR_COVERAGE_GAP = 2;     // coverage gap before activation
constexpr int ERR_UNINITIALIZED = 3;    // finalize on inactive DWFA
constexpr int ERR_REACTIVATION = 4;     // activating an already-active read

// queue priority shared by all engines: lowest cost, then longest
// consensus, then FIFO (matches SetPriorityQueue's (-cost, len) + seq)
struct QKey {
  i64 cost; i64 len; i64 seq;
  bool operator<(const QKey& o) const {
    if (cost != o.cost) return cost < o.cost;
    if (len != o.len) return len > o.len;
    return seq < o.seq;
  }
};

// offset auto-shift (parity: models/consensus.py::shift_offsets)
void shift_offsets_native(std::vector<i64>& offsets, bool auto_shift) {
  if (!auto_shift) return;
  i64 mn = std::numeric_limits<i64>::max();
  bool have_start = false;
  for (i64 o : offsets) {
    if (o < 0) have_start = true; else mn = std::min(mn, o);
  }
  if (!have_start)
    for (i64& o : offsets) o = (o == mn) ? -1 : o - mn;
}

// late-read activation points keyed by consensus length; returns the
// number of initially active reads
size_t build_activate_points(const std::vector<i64>& offsets,
                             i64 offset_compare_length,
                             std::map<i64, std::vector<size_t>>& points,
                             i64* max_activate = nullptr) {
  size_t initially_active = 0;
  for (size_t i = 0; i < offsets.size(); ++i) {
    if (offsets[i] >= 0) {
      const i64 al = offsets[i] + offset_compare_length;
      points[al].push_back(i);
      if (max_activate) *max_activate = std::max(*max_activate, al);
    } else {
      ++initially_active;
    }
  }
  return initially_active;
}

int run_consensus(const std::vector<Bytes>& reads,
                  const std::vector<i64>& in_offsets,  // -1 = none
                  const EngineConfig& cfg, std::vector<Result>& out,
                  i64* gap_info = nullptr) {  // [top_len, max_activate] on
                                              // ERR_COVERAGE_GAP (the
                                              // reference message carries
                                              // both, consensus.rs:305)
  const size_t R = reads.size();
  const bool l2 = cfg.cost_l2 != 0;
  const bool et = cfg.allow_early_termination != 0;

  std::vector<i64> offsets(in_offsets);
  shift_offsets_native(offsets, cfg.auto_shift_offsets != 0);

  std::map<i64, std::vector<size_t>> activate_points;
  i64 max_activate = 0;
  const size_t initially_active = build_activate_points(
      offsets, cfg.offset_compare_length, activate_points, &max_activate);
  if (initially_active == 0) return ERR_NO_INITIAL;

  size_t max_len = 0;
  for (auto& r : reads) max_len = std::max(max_len, r.size());
  Tracker tracker(max_len, cfg.max_capacity_per_size);

  std::map<QKey, std::unique_ptr<Node>> queue;
  i64 seq_counter = 0;

  auto root = std::make_unique<Node>();
  root->dwfas.resize(R);
  for (size_t i = 0; i < R; ++i)
    if (offsets[i] < 0) root->dwfas[i].emplace();
  root->cost = 0;
  tracker.insert(0);
  queue.emplace(QKey{0, 0, seq_counter++}, std::move(root));

  i64 maximum_error = std::numeric_limits<i64>::max();
  i64 farthest = 0, last_constraint = 0;
  out.clear();

  while (!queue.empty()) {
    while ((tracker.total > cfg.max_queue_size ||
            last_constraint >= cfg.max_nodes_wo_constraint) &&
           tracker.thr < farthest) {
      tracker.inc_threshold();
      last_constraint = 0;
    }

    auto it = queue.begin();
    std::unique_ptr<Node> node = std::move(it->second);
    const i64 top_cost = it->first.cost;
    queue.erase(it);
    const i64 top_len = (i64)node->consensus.size();
    tracker.remove(top_len);

    if (top_cost > maximum_error || top_len < tracker.thr ||
        tracker.at_capacity(top_len))
      continue;

    farthest = std::max(farthest, top_len);
    ++last_constraint;
    tracker.process(top_len);

    // completion check
    bool any_end = false, all_end = true;
    for (size_t r = 0; r < R; ++r) {
      const bool reached = node->dwfas[r] && node->dwfas[r]->reached_end(reads[r]);
      any_end |= reached;
      all_end &= reached;
    }
    if (et ? all_end : any_end) {
      for (size_t r = 0; r < R; ++r)
        if (!node->dwfas[r]) return ERR_UNINITIALIZED;
      // finalize a scratch copy
      std::vector<i64> fin(R);
      i64 fin_total = 0;
      for (size_t r = 0; r < R; ++r) {
        DWFA scratch = *node->dwfas[r];
        scratch.finalize(reads[r], node->consensus, cfg.wildcard);
        fin[r] = l2 ? scratch.e * scratch.e : scratch.e;
        fin_total += fin[r];
      }
      if (fin_total < maximum_error) {
        maximum_error = fin_total;
        out.clear();
      }
      if (fin_total <= maximum_error && (i64)out.size() < cfg.max_return_size) {
        out.push_back(Result{node->consensus, fin});
      }
    }

    // candidate nomination: fractional votes accumulated in read order
    std::map<int, double> candidates;
    std::map<int, i64> votes;
    for (size_t r = 0; r < R; ++r) {
      if (!node->dwfas[r]) continue;
      votes.clear();
      node->dwfas[r]->tips(reads[r], node->consensus, votes);
      i64 total = 0;
      for (auto& [sym, c] : votes) total += c;
      if (total == 0) continue;
      for (auto& [sym, c] : votes)
        candidates[sym] += (double)c / (double)total;
    }
    if (cfg.wildcard >= 0 && candidates.size() > 1)
      candidates.erase(cfg.wildcard);

    double max_observed = (double)cfg.min_count;
    if (!candidates.empty()) {
      max_observed = -1.0;
      for (auto& [sym, c] : candidates) max_observed = std::max(max_observed, c);
    }
    const double threshold = std::min((double)cfg.min_count, max_observed);

    std::vector<int> passing;
    for (auto& [sym, c] : candidates)
      if (c >= threshold) passing.push_back(sym);

    if (passing.empty()) {
      if (top_len < max_activate) {
        if (gap_info) {
          gap_info[0] = top_len;
          gap_info[1] = max_activate;
        }
        return ERR_COVERAGE_GAP;
      }
      continue;
    }

    for (size_t pi = 0; pi < passing.size(); ++pi) {
      std::unique_ptr<Node> child;
      if (pi + 1 == passing.size()) {
        child = std::move(node);  // move-in-place for the last child
      } else {
        child = std::make_unique<Node>(*node);
      }
      child->consensus.push_back((uint8_t)passing[pi]);
      for (size_t r = 0; r < R; ++r)
        if (child->dwfas[r])
          child->dwfas[r]->update(reads[r], child->consensus, cfg.wildcard, et);

      auto ap = activate_points.find((i64)child->consensus.size());
      if (ap != activate_points.end()) {
        for (size_t r : ap->second) {
          i64 off = activation_offset(child->consensus, reads[r], cfg);
          DWFA dw;
          dw.offset = off;
          dw.update(reads[r], child->consensus, cfg.wildcard, et);
          child->dwfas[r] = std::move(dw);
        }
      }
      const i64 c_cost = child->total_cost(l2);
      const i64 c_len = (i64)child->consensus.size();
      tracker.insert(c_len);
      queue.emplace(QKey{c_cost, c_len, seq_counter++}, std::move(child));
    }
  }

  std::sort(out.begin(), out.end(),
            [](const Result& a, const Result& b) { return a.sequence < b.sequence; });
  return ERR_OK;
}

// ---------------------------------------------------------------------
// dual-consensus engine (parity: models/dual_consensus.py, i.e.
// /root/reference/src/dual_consensus.rs:240-787)

struct DualEngineConfig : EngineConfig {
  int weighted_by_ed = 0;
  i64 dual_max_ed_delta = 20;
};

struct DualNode {
  bool is_dual = false, lock1 = false, lock2 = false;
  Bytes cons1, cons2;
  std::vector<std::optional<DWFA>> dw1, dw2;

  i64 max_len() const {
    return (i64)std::max(cons1.size(), cons2.size());
  }

  // full-identity key for set-semantics queue dedup (python _DualNode.key):
  // flags, both consensuses, and per-read (active, offset) on both sides
  std::string key() const {
    std::string k;
    k.reserve(cons1.size() + cons2.size() + dw1.size() * 10 + 8);
    k.push_back(is_dual ? '1' : '0');
    k.push_back(lock1 ? '1' : '0');
    k.push_back(lock2 ? '1' : '0');
    auto put = [&k](const Bytes& b) {
      i64 n = (i64)b.size();
      k.append(reinterpret_cast<const char*>(&n), sizeof(n));
      k.append(reinterpret_cast<const char*>(b.data()), b.size());
    };
    put(cons1);
    put(cons2);
    auto put_side = [&k](const std::vector<std::optional<DWFA>>& dws) {
      for (const auto& d : dws) {
        i64 o = d ? d->offset : -1;
        k.append(reinterpret_cast<const char*>(&o), sizeof(o));
        k.push_back(d ? '1' : '0');
      }
    };
    put_side(dw1);
    put_side(dw2);
    return k;
  }

  i64 total_cost(bool l2) const {
    i64 t = 0;
    for (size_t r = 0; r < dw1.size(); ++r) {
      i64 best = -1;
      if (dw1[r]) best = l2 ? dw1[r]->e * dw1[r]->e : dw1[r]->e;
      if (is_dual && dw2[r]) {
        const i64 s2 = l2 ? dw2[r]->e * dw2[r]->e : dw2[r]->e;
        if (best < 0 || s2 < best) best = s2;
      }
      if (best > 0) t += best;
    }
    return t;
  }

  bool is_dual_imbalanced(i64 min_count) const {
    if (!is_dual) return false;
    i64 a1 = 0, a2 = 0;
    for (const auto& d : dw1) a1 += d ? 1 : 0;
    for (const auto& d : dw2) a2 += d ? 1 : 0;
    return a1 < min_count || a2 < min_count;
  }

  bool reached_all_end(const std::vector<Bytes>& reads, bool require_all) const {
    bool any = false, all = true;
    for (size_t r = 0; r < dw1.size(); ++r) {
      const bool p1 = dw1[r] && dw1[r]->reached_end(reads[r]);
      const bool p2 = is_dual && dw2[r] && dw2[r]->reached_end(reads[r]);
      any |= p1 || p2;
      all &= p1 || p2;
    }
    return require_all ? all : any;
  }

  bool reached_consensus_end(const std::vector<Bytes>& reads, bool side1,
                             bool require_all) const {
    if (!side1 && !is_dual) return false;
    const auto& dws = side1 ? dw1 : dw2;
    bool any = false, all = true;
    for (size_t r = 0; r < dws.size(); ++r) {
      const bool f = dws[r] ? dws[r]->reached_end(reads[r]) : require_all;
      any |= f;
      all &= f;
    }
    return require_all ? all : any;
  }

  // fractional candidate votes for one side, reads accumulated in index
  // order (float summation order matches the python engine exactly)
  std::map<int, double> candidates(const std::vector<Bytes>& reads,
                                   int wildcard, bool side1,
                                   bool weighted) const {
    const auto& dws = side1 ? dw1 : dw2;
    const Bytes& cons = side1 ? cons1 : cons2;
    std::map<int, double> cand;
    std::map<int, i64> votes;
    for (size_t r = 0; r < dws.size(); ++r) {
      if (!dws[r]) continue;
      double w = 1.0;
      if (weighted && is_dual) {
        const double min_ed = 0.5;
        const bool h1 = (bool)dw1[r], h2 = (bool)dw2[r];
        if (h1 && h2) {
          const double c1 = std::max((double)dw1[r]->e, min_ed);
          const double c2 = std::max((double)dw2[r]->e, min_ed);
          const double numer = side1 ? c2 : c1;
          w = numer / (c1 + c2);
        } else if ((h1 && side1) || (h2 && !side1)) {
          w = 1.0;
        } else {
          w = 0.0;
        }
      }
      if (w <= 0.0) continue;
      votes.clear();
      dws[r]->tips(reads[r], cons, votes);
      i64 total = 0;
      for (auto& [sym, c] : votes) total += c;
      if (total == 0) continue;
      for (auto& [sym, c] : votes)
        cand[sym] += w * (double)c / (double)total;
    }
    if (wildcard >= 0 && cand.size() > 1) cand.erase(wildcard);
    return cand;
  }
};

struct DualResultC {
  Bytes cons1, cons2;
  bool has2 = false;
  std::vector<uint8_t> is_cons1;
  std::vector<i64> scores1, scores2;      // -1 = untracked (None)
  std::vector<i64> c1_scores, c2_scores;  // grouped per-assigned-read scores
};

// returns false on an attempt to activate an already-active read (the
// reference asserts/panics there: /root/reference/src/dual_consensus.rs:882)
bool dual_activate_sequence(DualNode& node, size_t seq_index,
                            const std::vector<Bytes>& reads,
                            const DualEngineConfig& cfg, bool et) {
  for (int side = 0; side < (node.is_dual ? 2 : 1); ++side) {
    const bool side1 = side == 0;
    const Bytes& cons = side1 ? node.cons1 : node.cons2;
    auto& dws = side1 ? node.dw1 : node.dw2;
    if (dws[seq_index]) return false;
    const i64 off = activation_offset(cons, reads[seq_index], cfg);
    DWFA dw;
    dw.offset = off;
    dw.update(reads[seq_index], cons, cfg.wildcard, et);
    dws[seq_index] = std::move(dw);
  }
  return true;
}

void dual_prune(DualNode& node, i64 ed_delta) {
  if (!node.is_dual) return;
  for (size_t r = 0; r < node.dw1.size(); ++r) {
    if (node.dw1[r] && node.dw2[r]) {
      const i64 e1 = node.dw1[r]->e, e2 = node.dw2[r]->e;
      if (e1 + ed_delta < e2) node.dw2[r].reset();
      else if (e2 + ed_delta < e1) node.dw1[r].reset();
    }
  }
}

// finalize a node into a result; returns false when some read was never
// tracked on either side (ERR_UNINITIALIZED)
bool dual_finalize(const DualNode& node, const std::vector<Bytes>& reads,
                   const DualEngineConfig& cfg, DualResultC& out,
                   i64& total) {
  const size_t R = reads.size();
  const bool l2 = cfg.cost_l2 != 0;
  for (size_t r = 0; r < R; ++r)
    if (!node.dw1[r] && !(node.is_dual && node.dw2[r])) return false;

  std::vector<i64> fin1(R, -1), fin2(R, -1);
  for (size_t r = 0; r < R; ++r) {
    if (node.dw1[r]) {
      DWFA scratch = *node.dw1[r];
      scratch.finalize(reads[r], node.cons1, cfg.wildcard);
      fin1[r] = l2 ? scratch.e * scratch.e : scratch.e;
    }
    if (node.is_dual && node.dw2[r]) {
      DWFA scratch = *node.dw2[r];
      scratch.finalize(reads[r], node.cons2, cfg.wildcard);
      fin2[r] = l2 ? scratch.e * scratch.e : scratch.e;
    }
  }

  std::vector<int> indices(R);
  std::vector<i64> best(R);
  total = 0;
  for (size_t r = 0; r < R; ++r) {
    const bool have1 = fin1[r] >= 0, have2 = fin2[r] >= 0;
    if (have1 && (!have2 || fin1[r] <= fin2[r])) {
      indices[r] = 0;
      best[r] = fin1[r];
    } else {
      indices[r] = 1;
      best[r] = fin2[r];
    }
    total += best[r];
  }

  const bool swap = node.is_dual && node.cons2 < node.cons1;
  out.is_cons1.resize(R);
  for (size_t r = 0; r < R; ++r)
    out.is_cons1[r] = ((indices[r] == 0) != swap) ? 1 : 0;
  out.c1_scores.clear();
  out.c2_scores.clear();
  for (size_t r = 0; r < R; ++r)
    (indices[r] == 0 ? out.c1_scores : out.c2_scores).push_back(best[r]);
  out.has2 = node.is_dual;
  if (swap) {
    out.cons1 = node.cons2;
    out.cons2 = node.cons1;
    out.scores1 = fin2;
    out.scores2 = fin1;
    out.c1_scores.swap(out.c2_scores);
  } else {
    out.cons1 = node.cons1;
    out.cons2 = node.cons2;
    out.scores1 = fin1;
    out.scores2 = fin2;
  }
  if (!node.is_dual) {
    out.cons2.clear();
    out.scores2.assign(R, -1);
  }
  return true;
}

int run_dual_consensus(const std::vector<Bytes>& reads,
                       const std::vector<i64>& in_offsets,  // -1 = none
                       const DualEngineConfig& cfg,
                       std::vector<DualResultC>& out) {
  const size_t R = reads.size();
  const bool l2 = cfg.cost_l2 != 0;
  const bool et = cfg.allow_early_termination != 0;

  std::vector<i64> offsets(in_offsets);
  shift_offsets_native(offsets, cfg.auto_shift_offsets != 0);

  std::map<i64, std::vector<size_t>> activate_points;
  const size_t initially_active = build_activate_points(
      offsets, cfg.offset_compare_length, activate_points);
  if (initially_active == 0) return ERR_NO_INITIAL;

  size_t max_len = 0;
  for (auto& r : reads) max_len = std::max(max_len, r.size());
  Tracker single_tracker(max_len, cfg.max_capacity_per_size);
  Tracker dual_tracker(max_len, cfg.max_capacity_per_size);

  std::map<QKey, std::unique_ptr<DualNode>> queue;
  std::set<std::string> live_keys;
  i64 seq_counter = 0;

  auto queue_child = [&](std::unique_ptr<DualNode> child, Tracker& tracker) {
    const i64 len = child->max_len();
    tracker.insert(len);
    std::string k = child->key();
    if (!live_keys.insert(std::move(k)).second) {
      tracker.remove(len);  // duplicate node: drop it
      return;
    }
    const i64 c = child->total_cost(l2);
    queue.emplace(QKey{c, len, seq_counter++}, std::move(child));
  };

  auto root = std::make_unique<DualNode>();
  root->dw1.resize(R);
  root->dw2.resize(R);
  for (size_t i = 0; i < R; ++i)
    if (offsets[i] < 0) root->dw1[i].emplace();
  queue_child(std::move(root), single_tracker);

  i64 maximum_error = std::numeric_limits<i64>::max();
  i64 farthest_single = 0, farthest_dual = 0;
  i64 single_last_constraint = 0, dual_last_constraint = 0;

  const i64 full_min_count = std::max<i64>(
      cfg.min_count, (i64)std::ceil(cfg.min_af * (double)R));
  std::vector<i64> total_active_count{(i64)initially_active};
  std::vector<i64> active_min_count{std::max<i64>(
      cfg.min_count,
      (i64)std::ceil(cfg.min_af * (double)initially_active))};

  std::vector<std::pair<DualResultC, i64>> results;  // result, total

  while (!queue.empty()) {
    while ((single_tracker.total > cfg.max_queue_size ||
            single_last_constraint >= cfg.max_nodes_wo_constraint) &&
           single_tracker.thr < farthest_single) {
      single_tracker.inc_threshold();
      single_last_constraint = 0;
    }
    while ((dual_tracker.total > cfg.max_queue_size ||
            dual_last_constraint >= cfg.max_nodes_wo_constraint) &&
           dual_tracker.thr < farthest_dual) {
      dual_tracker.inc_threshold();
      dual_last_constraint = 0;
    }

    auto it = queue.begin();
    std::unique_ptr<DualNode> node = std::move(it->second);
    const i64 top_cost = it->first.cost;
    queue.erase(it);
    live_keys.erase(node->key());
    const i64 top_len = node->max_len();

    Tracker& tracker = node->is_dual ? dual_tracker : single_tracker;
    tracker.remove(top_len);
    const i64 threshold_cutoff = tracker.thr;
    const bool at_capacity = tracker.at_capacity(top_len);

    if (top_cost > maximum_error || top_len < threshold_cutoff ||
        at_capacity ||
        node->is_dual_imbalanced(active_min_count[(size_t)top_len]))
      continue;

    if (node->is_dual) {
      farthest_dual = std::max(farthest_dual, top_len);
      ++dual_last_constraint;
      dual_tracker.process(top_len);
    } else {
      farthest_single = std::max(farthest_single, top_len);
      ++single_last_constraint;
      single_tracker.process(top_len);
    }

    // completion check
    if (node->reached_all_end(reads, et)) {
      DualResultC fin;
      i64 fin_total = 0;
      if (!dual_finalize(*node, reads, cfg, fin, fin_total))
        return ERR_UNINITIALIZED;
      bool imbalanced = false;
      if (node->is_dual) {
        i64 c1 = 0;
        for (uint8_t b : fin.is_cons1) c1 += b;
        const i64 c2 = (i64)fin.is_cons1.size() - c1;
        imbalanced = c1 < full_min_count || c2 < full_min_count;
      }
      if (!imbalanced) {
        if (fin_total < maximum_error) {
          maximum_error = fin_total;
          results.clear();
        }
        if (fin_total <= maximum_error &&
            (i64)results.size() < cfg.max_return_size)
          results.emplace_back(std::move(fin), fin_total);
      }
    }

    // dynamic active-count tables
    if ((i64)active_min_count.size() == top_len + 1) {
      i64 new_total = total_active_count[(size_t)top_len];
      auto ap = activate_points.find(top_len);
      if (ap != activate_points.end()) new_total += (i64)ap->second.size();
      total_active_count.push_back(new_total);
      active_min_count.push_back(std::max<i64>(
          cfg.min_count, (i64)std::ceil(cfg.min_af * (double)new_total)));
    }

    // -- expansion ---------------------------------------------------
    const bool weighted = cfg.weighted_by_ed != 0;
    auto ec1 = node->candidates(reads, cfg.wildcard, true, weighted);
    double sum1 = 0.0;
    for (auto& [s, c] : ec1) sum1 += c;
    const i64 min_count1 =
        std::max<i64>(cfg.min_count, (i64)std::ceil(cfg.min_af * sum1));
    double max_observed1 = (double)min_count1;
    if (!ec1.empty()) {
      max_observed1 = -1.0;
      for (auto& [s, c] : ec1) max_observed1 = std::max(max_observed1, c);
    }
    const double active_threshold1 =
        std::min((double)min_count1, max_observed1);

    auto maybe_activate = [&](DualNode& child) -> bool {
      auto ap = activate_points.find(child.max_len());
      if (ap != activate_points.end())
        for (size_t r : ap->second)
          if (!dual_activate_sequence(child, r, reads, cfg, et))
            return false;
      return true;
    };
    auto push_side = [&](DualNode& child, int sym, bool side1) {
      Bytes& cons = side1 ? child.cons1 : child.cons2;
      auto& dws = side1 ? child.dw1 : child.dw2;
      cons.push_back((uint8_t)sym);
      for (size_t r = 0; r < R; ++r)
        if (dws[r]) dws[r]->update(reads[r], cons, cfg.wildcard, et);
    };

    if (node->is_dual) {
      auto ec2 = node->candidates(reads, cfg.wildcard, false, weighted);
      double sum2 = 0.0;
      for (auto& [s, c] : ec2) sum2 += c;
      const i64 min_count2 =
          std::max<i64>(cfg.min_count, (i64)std::ceil(cfg.min_af * sum2));
      double max_observed2 = (double)min_count2;
      if (!ec2.empty()) {
        max_observed2 = -1.0;
        for (auto& [s, c] : ec2) max_observed2 = std::max(max_observed2, c);
      }
      const double active_threshold2 =
          std::min((double)min_count2, max_observed2);

      const bool fin1 = node->reached_consensus_end(reads, true, et);
      const bool fin2 = node->reached_consensus_end(reads, false, et);

      std::vector<int> opt1, opt2;  // -1 encodes None
      if (fin1 || ec1.empty() || node->lock1) opt1.push_back(-1);
      if (!node->lock1)
        for (auto& [sym, c] : ec1)
          if (c >= active_threshold1) opt1.push_back(sym);
      if (fin2 || ec2.empty() || node->lock2) opt2.push_back(-1);
      if (!node->lock2)
        for (auto& [sym, c] : ec2)
          if (c >= active_threshold2) opt2.push_back(sym);

      for (int can1 : opt1) {
        for (int can2 : opt2) {
          if (can1 < 0 && can2 < 0) continue;
          auto child = std::make_unique<DualNode>(*node);
          if (can1 >= 0) push_side(*child, can1, true);
          else child->lock1 = true;
          if (can2 >= 0) push_side(*child, can2, false);
          else child->lock2 = true;
          if (!maybe_activate(*child)) return ERR_REACTIVATION;
          dual_prune(*child, cfg.dual_max_ed_delta);
          queue_child(std::move(child), dual_tracker);
        }
      }
    } else {
      for (auto& [sym, c] : ec1) {
        if (c < active_threshold1) continue;
        auto child = std::make_unique<DualNode>(*node);
        push_side(*child, sym, true);
        if (!maybe_activate(*child)) return ERR_REACTIVATION;
        queue_child(std::move(child), single_tracker);
      }

      // dual splits: unordered pairs of distinct non-wildcard candidates
      // ordered by (-count, sym), gated on two passing min_count1
      std::vector<std::pair<double, int>> sorted_candidates;
      for (auto& [sym, c] : ec1)
        if (sym != cfg.wildcard) sorted_candidates.emplace_back(-c, sym);
      std::sort(sorted_candidates.begin(), sorted_candidates.end());
      i64 num_passing = 0;
      for (auto& [negc, sym] : sorted_candidates)
        if (-negc >= (double)min_count1) ++num_passing;
      if (num_passing > 1) {
        for (size_t i = 0; i < sorted_candidates.size(); ++i) {
          for (size_t j = i + 1; j < sorted_candidates.size(); ++j) {
            auto child = std::make_unique<DualNode>(*node);
            child->is_dual = true;
            child->cons2 = child->cons1;
            child->dw2 = child->dw1;
            push_side(*child, sorted_candidates[i].second, true);
            push_side(*child, sorted_candidates[j].second, false);
            if (!maybe_activate(*child)) return ERR_REACTIVATION;
            dual_prune(*child, cfg.dual_max_ed_delta);
            queue_child(std::move(child), dual_tracker);
          }
        }
      }
    }
  }

  std::stable_sort(
      results.begin(), results.end(), [](const auto& a, const auto& b) {
        if (a.first.cons1 != b.first.cons1)
          return a.first.cons1 < b.first.cons1;
        return a.first.cons2 < b.first.cons2;
      });

  out.clear();
  for (auto& [res, _t] : results) out.push_back(std::move(res));
  if (out.empty()) {
    // empty-consensus fallback (reference warn! path)
    DualResultC fb;
    fb.has2 = false;
    fb.is_cons1.assign(R, 1);
    fb.scores1.assign(R, 0);
    fb.scores2.assign(R, -1);
    fb.c1_scores.assign(R, 0);
    out.push_back(std::move(fb));
  }
  return ERR_OK;
}

// ---------------------------------------------------------------------
// priority consensus: worklist of dual splits over sequence chains
// (parity: models/priority_consensus.py, i.e.
// /root/reference/src/priority_consensus.rs:172-341)

struct PriorityResultC {
  // per group: a chain of (sequence, grouped scores)
  std::vector<std::vector<std::pair<Bytes, std::vector<i64>>>> chains;
  std::vector<i64> indices;
};

int run_priority_consensus(
    const std::vector<std::vector<Bytes>>& chains,       // [read][level]
    const std::vector<std::vector<i64>>& chain_offsets,  // -1 = none
    const std::vector<i64>& seed_groups,                 // -1 = none
    const DualEngineConfig& cfg, PriorityResultC& out) {
  const size_t n_reads = chains.size();
  const size_t max_split_level = chains[0].size();

  std::vector<std::vector<uint8_t>> to_split;
  std::vector<size_t> split_levels;
  std::vector<std::vector<std::pair<Bytes, std::vector<i64>>>> chain_stack;

  std::set<i64> seeds(seed_groups.begin(), seed_groups.end());
  for (i64 seed : seeds) {  // -1 (unseeded) sorts first
    std::vector<uint8_t> inc(n_reads);
    for (size_t i = 0; i < n_reads; ++i) inc[i] = seed_groups[i] == seed;
    to_split.push_back(std::move(inc));
    split_levels.push_back(0);
    chain_stack.emplace_back();
  }

  std::vector<std::vector<std::pair<Bytes, std::vector<i64>>>> consensuses;
  std::vector<std::vector<uint8_t>> assignments;

  while (!to_split.empty()) {
    std::vector<uint8_t> include_set = std::move(to_split.back());
    to_split.pop_back();
    const size_t level = split_levels.back();
    split_levels.pop_back();
    auto chain = std::move(chain_stack.back());
    chain_stack.pop_back();

    std::vector<Bytes> sub_reads;
    std::vector<i64> sub_offsets;
    for (size_t i = 0; i < n_reads; ++i) {
      if (include_set[i]) {
        sub_reads.push_back(chains[i][level]);
        sub_offsets.push_back(chain_offsets[i][level]);
      }
    }
    std::vector<DualResultC> dc;
    const int rc = run_dual_consensus(sub_reads, sub_offsets, cfg, dc);
    if (rc != ERR_OK) return rc;
    DualResultC& chosen = dc[0];

    if (chosen.has2) {
      std::vector<uint8_t> assign1(n_reads, 0), assign2(n_reads, 0);
      size_t ic = 0;
      for (size_t i = 0; i < n_reads; ++i) {
        if (include_set[i]) {
          (chosen.is_cons1[ic] ? assign1 : assign2)[i] = 1;
          ++ic;
        }
      }
      to_split.push_back(std::move(assign1));
      split_levels.push_back(level);
      chain_stack.push_back(chain);  // copy for the first half
      to_split.push_back(std::move(assign2));
      split_levels.push_back(level);
      chain_stack.push_back(std::move(chain));
    } else {
      chain.emplace_back(chosen.cons1, chosen.c1_scores);
      if (level + 1 == max_split_level) {
        consensuses.push_back(std::move(chain));
        assignments.push_back(std::move(include_set));
      } else {
        to_split.push_back(std::move(include_set));
        split_levels.push_back(level + 1);
        chain_stack.push_back(std::move(chain));
      }
    }
  }

  out.chains.clear();
  out.indices.assign(n_reads, 0);
  if (consensuses.size() > 1) {
    std::vector<size_t> order(consensuses.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      const auto& ca = consensuses[a];
      const auto& cb = consensuses[b];
      for (size_t l = 0; l < ca.size() && l < cb.size(); ++l) {
        if (ca[l].first != cb[l].first) return ca[l].first < cb[l].first;
      }
      return ca.size() < cb.size();
    });
    out.indices.assign(n_reads, -1);
    for (size_t new_index = 0; new_index < order.size(); ++new_index) {
      const size_t old_index = order[new_index];
      for (size_t i = 0; i < n_reads; ++i)
        if (assignments[old_index][i]) out.indices[i] = (i64)new_index;
      out.chains.push_back(std::move(consensuses[old_index]));
    }
  } else {
    out.chains = std::move(consensuses);
  }
  return ERR_OK;
}

Scorer* as_scorer(void* p) { return reinterpret_cast<Scorer*>(p); }

void parse_dual_config(const i64* int_cfg, double min_af,
                       DualEngineConfig& cfg) {
  cfg.cost_l2 = (int)int_cfg[0];
  cfg.max_queue_size = int_cfg[1];
  cfg.max_capacity_per_size = int_cfg[2];
  cfg.max_return_size = int_cfg[3];
  cfg.max_nodes_wo_constraint = int_cfg[4];
  cfg.min_count = int_cfg[5];
  cfg.wildcard = (int)int_cfg[6];
  cfg.allow_early_termination = (int)int_cfg[7];
  cfg.auto_shift_offsets = (int)int_cfg[8];
  cfg.offset_window = int_cfg[9];
  cfg.offset_compare_length = int_cfg[10];
  cfg.weighted_by_ed = (int)int_cfg[11];
  cfg.dual_max_ed_delta = int_cfg[12];
  cfg.min_af = min_af;
}

struct BlobWriter {
  std::vector<uint8_t> buf;
  void put_i64(i64 v) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
    buf.insert(buf.end(), p, p + sizeof(i64));
  }
  void put_bytes(const Bytes& b) {
    put_i64((i64)b.size());
    buf.insert(buf.end(), b.begin(), b.end());
  }
  void put_vec(const std::vector<i64>& v) {
    put_i64((i64)v.size());
    for (i64 x : v) put_i64(x);
  }
  uint8_t* release(i64* out_size) {
    uint8_t* blob = (uint8_t*)malloc(buf.size());
    std::memcpy(blob, buf.data(), buf.size());
    *out_size = (i64)buf.size();
    return blob;
  }
};

void write_dual_results(const std::vector<DualResultC>& results,
                        BlobWriter& w) {
  w.put_i64((i64)results.size());
  for (const auto& res : results) {
    w.put_bytes(res.cons1);
    w.put_i64(res.has2 ? 1 : 0);
    if (res.has2) w.put_bytes(res.cons2);
    w.put_i64((i64)res.is_cons1.size());
    for (uint8_t b : res.is_cons1) w.put_i64(b);
    w.put_vec(res.scores1);
    w.put_vec(res.scores2);
    w.put_vec(res.c1_scores);
    w.put_vec(res.c2_scores);
  }
}

}  // namespace

// ---------------------------------------------------------------------
// C ABI

extern "C" {

void* wn_scorer_new(const uint8_t* read_data, const i64* read_lens, i64 n_reads,
                    const uint8_t* symtab, i64 n_symbols, int wildcard,
                    int early_term) {
  auto* s = new Scorer();
  i64 pos = 0;
  for (i64 i = 0; i < n_reads; ++i) {
    s->reads.emplace_back(read_data + pos, read_data + pos + read_lens[i]);
    pos += read_lens[i];
  }
  s->sym_id.fill(-1);
  for (i64 i = 0; i < n_symbols; ++i) {
    s->symtab.push_back(symtab[i]);
    s->sym_id[symtab[i]] = (int)i;
  }
  s->wildcard = wildcard;
  s->early_term = early_term != 0;
  return s;
}

void wn_scorer_free(void* p) { delete as_scorer(p); }

i64 wn_root(void* p, const uint8_t* active) {
  auto* s = as_scorer(p);
  std::vector<std::optional<DWFA>> dwfas(s->R());
  for (size_t r = 0; r < s->R(); ++r)
    if (active[r]) dwfas[r].emplace();
  const i64 h = s->next_handle++;
  s->branches.emplace(h, std::move(dwfas));
  return h;
}

i64 wn_clone(void* p, i64 h) {
  auto* s = as_scorer(p);
  const i64 nh = s->next_handle++;
  s->branches.emplace(nh, s->branches.at(h));
  return nh;
}

void wn_free_branch(void* p, i64 h) { as_scorer(p)->branches.erase(h); }

void wn_push(void* p, i64 h, const uint8_t* cons, i64 clen, i64* eds, i64* occ,
             i64* split, uint8_t* reached) {
  auto* s = as_scorer(p);
  auto& dwfas = s->branches.at(h);
  Bytes consensus(cons, cons + clen);
  for (size_t r = 0; r < s->R(); ++r)
    if (dwfas[r])
      dwfas[r]->update(s->reads[r], consensus, s->wildcard, s->early_term);
  scorer_snapshot(*s, dwfas, consensus, eds, occ, split, reached);
}

void wn_stats(void* p, i64 h, const uint8_t* cons, i64 clen, i64* eds, i64* occ,
              i64* split, uint8_t* reached) {
  auto* s = as_scorer(p);
  Bytes consensus(cons, cons + clen);
  scorer_snapshot(*s, s->branches.at(h), consensus, eds, occ, split, reached);
}

void wn_activate(void* p, i64 h, i64 read_index, i64 offset, const uint8_t* cons,
                 i64 clen) {
  auto* s = as_scorer(p);
  Bytes consensus(cons, cons + clen);
  DWFA dw;
  dw.offset = offset;
  dw.update(s->reads[(size_t)read_index], consensus, s->wildcard, s->early_term);
  s->branches.at(h)[(size_t)read_index] = std::move(dw);
}

void wn_deactivate(void* p, i64 h, i64 read_index) {
  as_scorer(p)->branches.at(h)[(size_t)read_index].reset();
}

void wn_finalized_eds(void* p, i64 h, const uint8_t* cons, i64 clen, i64* eds) {
  auto* s = as_scorer(p);
  Bytes consensus(cons, cons + clen);
  auto& dwfas = s->branches.at(h);
  for (size_t r = 0; r < s->R(); ++r) {
    if (dwfas[r]) {
      DWFA scratch = *dwfas[r];
      scratch.finalize(s->reads[r], consensus, s->wildcard);
      eds[r] = scratch.e;
    } else {
      eds[r] = 0;
    }
  }
}

i64 wn_wfa_ed(const uint8_t* v1, i64 l1, const uint8_t* v2, i64 l2,
              int require_both_end, int wildcard) {
  return wfa_ed_config(v1, l1, v2, l2, require_both_end != 0, wildcard);
}

// Full single-consensus engine.  Returns an error code; on success the
// result blob layout is:
//   i64 n_results; then per result: i64 seq_len, bytes, i64 n_scores,
//   i64 scores[]  (blob malloc'd; free with wn_blob_free)
int wn_consensus(const uint8_t* read_data, const i64* read_lens, i64 n_reads,
                 const i64* offsets,  // -1 = none
                 const i64* int_cfg,  // [cost_l2, max_queue, max_cap, max_ret,
                                      //  max_nodes, min_count, wildcard(-1),
                                      //  early_term, auto_shift, off_window,
                                      //  off_cmp_len]
                 double min_af, uint8_t** out_blob, i64* out_size) {
  std::vector<Bytes> reads;
  i64 pos = 0;
  for (i64 i = 0; i < n_reads; ++i) {
    reads.emplace_back(read_data + pos, read_data + pos + read_lens[i]);
    pos += read_lens[i];
  }
  EngineConfig cfg;
  cfg.cost_l2 = (int)int_cfg[0];
  cfg.max_queue_size = int_cfg[1];
  cfg.max_capacity_per_size = int_cfg[2];
  cfg.max_return_size = int_cfg[3];
  cfg.max_nodes_wo_constraint = int_cfg[4];
  cfg.min_count = int_cfg[5];
  cfg.wildcard = (int)int_cfg[6];
  cfg.allow_early_termination = (int)int_cfg[7];
  cfg.auto_shift_offsets = (int)int_cfg[8];
  cfg.offset_window = int_cfg[9];
  cfg.offset_compare_length = int_cfg[10];
  cfg.min_af = min_af;

  std::vector<i64> offs(offsets, offsets + n_reads);
  std::vector<Result> results;
  i64 gap[2] = {0, 0};
  int rc = run_consensus(reads, offs, cfg, results, gap);
  if (rc != ERR_OK) {
    if (rc == ERR_COVERAGE_GAP && out_blob != nullptr) {
      // error-detail blob: the two i64s the reference interpolates into
      // its coverage-gap message (consensus.rs:305)
      uint8_t* detail = (uint8_t*)malloc(2 * sizeof(i64));
      std::memcpy(detail, gap, 2 * sizeof(i64));
      *out_blob = detail;
      *out_size = 2 * sizeof(i64);
    }
    return rc;
  }

  i64 size = sizeof(i64);
  for (auto& r : results)
    size += sizeof(i64) * 2 + (i64)r.sequence.size() + sizeof(i64) * (i64)r.scores.size();
  uint8_t* blob = (uint8_t*)malloc((size_t)size);
  uint8_t* w = blob;
  auto put_i64 = [&w](i64 v) { std::memcpy(w, &v, sizeof(i64)); w += sizeof(i64); };
  put_i64((i64)results.size());
  for (auto& r : results) {
    put_i64((i64)r.sequence.size());
    std::memcpy(w, r.sequence.data(), r.sequence.size());
    w += r.sequence.size();
    put_i64((i64)r.scores.size());
    for (i64 v : r.scores) put_i64(v);
  }
  *out_blob = blob;
  *out_size = size;
  return ERR_OK;
}

// Full dual-consensus engine.  int_cfg layout: [cost_l2, max_queue,
// max_cap, max_ret, max_nodes, min_count, wildcard(-1), early_term,
// auto_shift, off_window, off_cmp_len, weighted_by_ed, dual_max_ed_delta].
// Result blob: i64 n_results; per result: bytes cons1, i64 has2,
// [bytes cons2], i64 n, i64 is_cons1[n], vec scores1, vec scores2,
// vec c1_scores, vec c2_scores (vec = i64 len + payload; bytes = i64 len
// + raw).  Scores use -1 for "untracked".
int wn_dual_consensus(const uint8_t* read_data, const i64* read_lens,
                      i64 n_reads, const i64* offsets, const i64* int_cfg,
                      double min_af, uint8_t** out_blob, i64* out_size) {
  std::vector<Bytes> reads;
  i64 pos = 0;
  for (i64 i = 0; i < n_reads; ++i) {
    reads.emplace_back(read_data + pos, read_data + pos + read_lens[i]);
    pos += read_lens[i];
  }
  DualEngineConfig cfg;
  parse_dual_config(int_cfg, min_af, cfg);
  std::vector<i64> offs(offsets, offsets + n_reads);
  std::vector<DualResultC> results;
  const int rc = run_dual_consensus(reads, offs, cfg, results);
  if (rc != ERR_OK) return rc;
  BlobWriter w;
  write_dual_results(results, w);
  *out_blob = w.release(out_size);
  return ERR_OK;
}

// Full priority (chained multi) consensus engine over the dual engine.
// Chains arrive flattened read-major: chain_lens has n_reads * n_levels
// entries.  Result blob: i64 n_groups; per group: i64 n_levels, per
// level: bytes sequence + vec scores; then vec sequence_indices.
int wn_priority_consensus(const uint8_t* chain_data, const i64* chain_lens,
                          i64 n_reads, i64 n_levels, const i64* offsets,
                          const i64* seed_groups, const i64* int_cfg,
                          double min_af, uint8_t** out_blob, i64* out_size) {
  std::vector<std::vector<Bytes>> chains((size_t)n_reads);
  std::vector<std::vector<i64>> chain_offsets((size_t)n_reads);
  i64 pos = 0;
  for (i64 i = 0; i < n_reads; ++i) {
    for (i64 l = 0; l < n_levels; ++l) {
      const i64 len = chain_lens[i * n_levels + l];
      chains[(size_t)i].emplace_back(chain_data + pos, chain_data + pos + len);
      chain_offsets[(size_t)i].push_back(offsets[i * n_levels + l]);
      pos += len;
    }
  }
  std::vector<i64> seeds(seed_groups, seed_groups + n_reads);
  DualEngineConfig cfg;
  parse_dual_config(int_cfg, min_af, cfg);
  PriorityResultC res;
  const int rc = run_priority_consensus(chains, chain_offsets, seeds, cfg, res);
  if (rc != ERR_OK) return rc;
  BlobWriter w;
  w.put_i64((i64)res.chains.size());
  for (const auto& chain : res.chains) {
    w.put_i64((i64)chain.size());
    for (const auto& [seq, scores] : chain) {
      w.put_bytes(seq);
      w.put_vec(scores);
    }
  }
  w.put_vec(res.indices);
  *out_blob = w.release(out_size);
  return ERR_OK;
}

void wn_blob_free(uint8_t* blob) { free(blob); }

}  // extern "C"
