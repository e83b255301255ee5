// Native bulk query sampler for graphqembed_tpu.
//
// The reference's offline sampling is pure-python dict/set traversal driven
// by multiprocessing [R: netquery/data_utils.py::parallel_sample (conf=M)];
// at bio scale (~1e5 nodes, ~8M edges, millions of queries) that is the
// preprocessing bottleneck. This is the same exact semantics as
// data/sampling.py (reverse walks from a target, exact answer sets by CSR
// set algebra, negatives = non-answers of the target mode, hard negatives =
// partial-branch matches) over flat CSR arrays, compiled with g++ and bound
// via ctypes (python fallback remains; invariants cross-checked in tests).
//
// Graph encoding (all int32, passed from python):
//   modes:      mode_lo[m], mode_hi[m]                   (global id ranges)
//   relations:  rel_from_mode[r], rel_to_mode[r], rel_rev[r]
//               indptr_off[r]  -> offset into indptr_cat (len n_from+1 each)
//               indices_off[r] -> offset into indices_cat
// Structures: 0=1p 1=2p 2=3p 3=2i 4=3i 5=ip 6=pi  (config.STRUCTURES order).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

struct Graph {
  int n_modes = 0, n_rels = 0;
  const int32_t *mode_lo = nullptr, *mode_hi = nullptr;
  const int32_t *rel_from_mode = nullptr, *rel_to_mode = nullptr,
                *rel_rev = nullptr;
  const int64_t *indptr_off = nullptr, *indices_off = nullptr;
  const int32_t *indptr_cat = nullptr, *indices_cat = nullptr;

  int mode_of(int32_t gid) const {
    for (int m = 0; m < n_modes; ++m)
      if (gid >= mode_lo[m] && gid < mode_hi[m]) return m;
    return -1;
  }
  // neighbors of global node `gid` under relation r (empty if out of range)
  std::pair<const int32_t*, int> neighbors(int r, int32_t gid) const {
    const int from_m = rel_from_mode[r];
    const int32_t lo = mode_lo[from_m];
    if (gid < lo || gid >= mode_hi[from_m]) return {nullptr, 0};
    const int32_t* ip = indptr_cat + indptr_off[r];
    const int32_t a = ip[gid - lo], b = ip[gid - lo + 1];
    return {indices_cat + indices_off[r] + a, b - a};
  }
  int64_t rel_nnz(int r) const {
    const int from_m = rel_from_mode[r];
    const int n_from = mode_hi[from_m] - mode_lo[from_m];
    return (indptr_cat + indptr_off[r])[n_from];
  }
};

using Set = std::unordered_set<int32_t>;

// Epoch-stamped node set over global ids: O(1) insert/count with no hashing,
// no allocation, no clearing (reset bumps the epoch) — answer sets at paper
// scale reach degree^hops ≈ 64k nodes PER QUERY, and unordered_set's hashed
// inserts were the dominant preprocessing cost (73% of paper-scale wall).
struct NodeSet {
  std::vector<uint32_t> stamp;
  std::vector<int32_t> members;
  uint32_t epoch = 0;

  void init(size_t n) { stamp.assign(n, 0); epoch = 0; }
  void reset() { ++epoch; members.clear(); }
  bool insert(int32_t v) {
    if (stamp[v] == epoch) return false;
    stamp[v] = epoch;
    members.push_back(v);
    return true;
  }
  bool count(int32_t v) const { return stamp[v] == epoch; }
  size_t size() const { return members.size(); }
};

void project_into(const Graph& g, const std::vector<int32_t>& src, int rel,
                  NodeSet* out) {
  for (int32_t v : src) {
    auto [p, n] = g.neighbors(rel, v);
    for (int i = 0; i < n; ++i) out->insert(p[i]);
  }
}

struct Walk {
  int rels[3];
  int32_t anchors[3];
  int32_t target;
  int n_rels, n_anchors;
};

struct Sampler {
  const Graph& g;
  std::mt19937_64 rng;
  std::vector<int> live;                       // relations with edges
  std::vector<std::vector<int>> in_rels;       // per mode: rels with to_mode=m
  // preallocated epoch-stamped sets (answers/branches/hard-neg scratch)
  NodeSet ns_branch[3], ns_ans, ns_tmp, ns_seen, ns_hard;

  Sampler(const Graph& g_, uint64_t seed) : g(g_), rng(seed) {
    for (int r = 0; r < g.n_rels; ++r)
      if (g.rel_nnz(r) > 0) live.push_back(r);
    in_rels.resize(g.n_modes);
    for (int r : live) in_rels[g.rel_to_mode[r]].push_back(r);
    int32_t n_nodes = 0;
    for (int m = 0; m < g.n_modes; ++m)
      n_nodes = std::max(n_nodes, g.mode_hi[m]);
    for (auto* s : {&ns_branch[0], &ns_branch[1], &ns_branch[2], &ns_ans,
                    &ns_tmp, &ns_seen, &ns_hard})
      s->init((size_t)n_nodes);
  }

  int32_t pick(const int32_t* p, int n) { return p[rng() % n]; }

  // random (rel, src) with src having out-edges under rel
  bool pick_edge(int rel, int32_t* src, int32_t* dst) {
    const int from_m = g.rel_from_mode[rel];
    const int32_t lo = g.mode_lo[from_m], hi = g.mode_hi[from_m];
    for (int t = 0; t < 64; ++t) {
      int32_t s = lo + (int32_t)(rng() % (hi - lo));
      auto [p, n] = g.neighbors(rel, s);
      if (n > 0) { *src = s; *dst = pick(p, n); return true; }
    }
    // dense fallback: scan from a random start
    int32_t start = lo + (int32_t)(rng() % (hi - lo));
    for (int32_t s = start; s < hi; ++s) {
      auto [p, n] = g.neighbors(rel, s);
      if (n > 0) { *src = s; *dst = pick(p, n); return true; }
    }
    for (int32_t s = lo; s < start; ++s) {
      auto [p, n] = g.neighbors(rel, s);
      if (n > 0) { *src = s; *dst = pick(p, n); return true; }
    }
    return false;
  }

  // random in-edge of `node`: (rel, src) with src -rel-> node
  bool pick_in_edge(int32_t node, int* rel, int32_t* src) {
    const auto& cands = in_rels[g.mode_of(node)];
    if (cands.empty()) return false;
    int start = (int)(rng() % cands.size());
    for (size_t k = 0; k < cands.size(); ++k) {
      int r = cands[(start + k) % cands.size()];
      auto [p, n] = g.neighbors(g.rel_rev[r], node);
      if (n > 0) { *rel = r; *src = pick(p, n); return true; }
    }
    return false;
  }

  bool walk(int structure, Walk* w) {
    if (live.empty()) return false;
    switch (structure) {
      case 0: case 1: case 2: {                       // 1p/2p/3p
        const int hops = structure + 1;
        int rel = live[rng() % live.size()];
        int32_t src, dst;
        if (!pick_edge(rel, &src, &dst)) return false;
        int chain[3] = {rel, 0, 0};
        int32_t cur = src;
        for (int h = 1; h < hops; ++h) {
          int r_in; int32_t prev;
          if (!pick_in_edge(cur, &r_in, &prev)) return false;
          for (int i = h; i > 0; --i) chain[i] = chain[i - 1];
          chain[0] = r_in;
          cur = prev;
        }
        w->n_rels = hops; w->n_anchors = 1;
        for (int i = 0; i < hops; ++i) w->rels[i] = chain[i];
        w->anchors[0] = cur; w->target = dst;
        return true;
      }
      case 3: case 4: {                               // 2i/3i
        const int k = structure - 1;                  // 2 or 3 branches
        int rel0 = live[rng() % live.size()];
        int32_t a0, tgt;
        if (!pick_edge(rel0, &a0, &tgt)) return false;
        int rels[3] = {rel0, 0, 0};
        int32_t anchors[3] = {a0, 0, 0};
        for (int b = 1; b < k; ++b) {
          int r; int32_t a;
          if (!pick_in_edge(tgt, &r, &a)) return false;
          for (int j = 0; j < b; ++j)
            if (rels[j] == r && anchors[j] == a) return false;
          rels[b] = r; anchors[b] = a;
        }
        // shuffle branch order
        for (int i = k - 1; i > 0; --i) {
          int j = (int)(rng() % (i + 1));
          std::swap(rels[i], rels[j]);
          std::swap(anchors[i], anchors[j]);
        }
        w->n_rels = k; w->n_anchors = k;
        for (int i = 0; i < k; ++i) { w->rels[i] = rels[i]; w->anchors[i] = anchors[i]; }
        w->target = tgt;
        return true;
      }
      case 6: {                                       // pi
        int rel2 = live[rng() % live.size()];
        int32_t v, tgt;
        if (!pick_edge(rel2, &v, &tgt)) return false;
        int rel1; int32_t a1;
        if (!pick_in_edge(v, &rel1, &a1)) return false;
        int rel3; int32_t a2;
        if (!pick_in_edge(tgt, &rel3, &a2)) return false;
        if (rel3 == rel2 && a2 == v) return false;    // degenerate
        w->n_rels = 3; w->n_anchors = 2;
        w->rels[0] = rel1; w->rels[1] = rel2; w->rels[2] = rel3;
        w->anchors[0] = a1; w->anchors[1] = a2; w->target = tgt;
        return true;
      }
      case 5: {                                       // ip
        int rel3 = live[rng() % live.size()];
        int32_t v, tgt;
        if (!pick_edge(rel3, &v, &tgt)) return false;
        int rel1, rel2; int32_t a1, a2;
        if (!pick_in_edge(v, &rel1, &a1)) return false;
        if (!pick_in_edge(v, &rel2, &a2)) return false;
        if (rel1 == rel2 && a1 == a2) return false;
        w->n_rels = 3; w->n_anchors = 2;
        w->rels[0] = rel1; w->rels[1] = rel2; w->rels[2] = rel3;
        w->anchors[0] = a1; w->anchors[1] = a2; w->target = tgt;
        return true;
      }
    }
    return false;
  }

  // one-anchor projection into a NodeSet
  void project1(int32_t anchor, int rel, NodeSet* out) {
    out->reset();
    auto [p, n] = g.neighbors(rel, anchor);
    for (int i = 0; i < n; ++i) out->insert(p[i]);
  }

  // exact answer set + per-branch sets (at the join node for ip), all in
  // preallocated stamped sets. Returns: *ans_out points at the answer set;
  // ns_branch[0..n_branches) hold the branch sets.
  void answers(int structure, const Walk& w, NodeSet** ans_out,
               int* n_branches) {
    switch (structure) {
      case 0: case 1: case 2: {
        // chain: ping-pong between ns_branch[0] and ns_tmp per hop
        project1(w.anchors[0], w.rels[0], &ns_branch[0]);
        NodeSet* cur = &ns_branch[0];
        NodeSet* nxt = &ns_tmp;
        for (int i = 1; i < w.n_rels; ++i) {
          nxt->reset();
          project_into(g, cur->members, w.rels[i], nxt);
          std::swap(cur, nxt);
        }
        if (cur != &ns_branch[0]) {         // make branch[0] the final set
          ns_branch[0].reset();
          for (int32_t x : cur->members) ns_branch[0].insert(x);
        }
        *ans_out = &ns_branch[0];
        *n_branches = 1;
        return;
      }
      case 3: case 4: {
        for (int b = 0; b < w.n_anchors; ++b)
          project1(w.anchors[b], w.rels[b], &ns_branch[b]);
        *n_branches = w.n_anchors;
        break;
      }
      case 6: {                                        // pi
        project1(w.anchors[0], w.rels[0], &ns_tmp);
        ns_branch[0].reset();
        project_into(g, ns_tmp.members, w.rels[1], &ns_branch[0]);
        project1(w.anchors[1], w.rels[2], &ns_branch[1]);
        *n_branches = 2;
        break;
      }
      case 5: {                                        // ip: join at v
        project1(w.anchors[0], w.rels[0], &ns_branch[0]);
        project1(w.anchors[1], w.rels[1], &ns_branch[1]);
        ns_tmp.reset();
        for (int32_t x : ns_branch[0].members)
          if (ns_branch[1].count(x)) ns_tmp.insert(x);
        ns_ans.reset();
        project_into(g, ns_tmp.members, w.rels[2], &ns_ans);
        *ans_out = &ns_ans;
        *n_branches = 2;
        return;
      }
    }
    // generic intersection at target (2i/3i/pi)
    ns_ans.reset();
    for (int32_t x : ns_branch[0].members) {
      bool all = true;
      for (int b = 1; b < *n_branches; ++b)
        if (!ns_branch[b].count(x)) { all = false; break; }
      if (all) ns_ans.insert(x);
    }
    *ans_out = &ns_ans;
  }

  int sample_negs(int target_mode, const NodeSet& ans, int32_t* out,
                  int max_negs, bool exhaustive) {
    const int32_t lo = g.mode_lo[target_mode], hi = g.mode_hi[target_mode];
    const int64_t n_mode = hi - lo;
    int count = 0;
    if (exhaustive || n_mode <= 4 * max_negs) {
      for (int32_t c = lo; c < hi && count < max_negs; ++c)
        if (!ans.count(c)) out[count++] = c;
      // exhaustive caller passes max_negs = n_mode
      return count;
    }
    ns_seen.reset();
    for (int64_t draws = 0; count < max_negs && draws < 50LL * max_negs;
         ++draws) {
      int32_t c = lo + (int32_t)(rng() % n_mode);
      if (ans.count(c) || !ns_seen.insert(c)) continue;
      out[count++] = c;
    }
    return count;
  }
};

struct Key {
  int64_t h;
  bool operator==(const Key& o) const { return h == o.h; }
};
struct KeyHash {
  size_t operator()(const Key& k) const { return (size_t)k.h; }
};

}  // namespace

extern "C" {

// Returns number of queries written (<= n_queries).
int gqe_sample_queries(
    // graph
    int n_modes, const int32_t* mode_lo, const int32_t* mode_hi,
    int n_rels, const int32_t* rel_from_mode, const int32_t* rel_to_mode,
    const int32_t* rel_rev, const int64_t* indptr_off,
    const int64_t* indices_off, const int32_t* indptr_cat,
    const int32_t* indices_cat,
    // request
    int structure, int n_queries, uint64_t seed, int max_negs, int max_tries,
    int exhaustive_negs,
    // outputs (caller-allocated)
    int32_t* out_rels,        // [n, 3]
    int32_t* out_anchors,     // [n, 3]
    int32_t* out_targets,     // [n]
    int32_t* out_negs,        // [n, max_negs]
    int32_t* out_neg_counts,  // [n]
    int32_t* out_hard,        // [n, max_negs]
    int32_t* out_hard_counts  // [n]
) {
  Graph g;
  g.n_modes = n_modes; g.mode_lo = mode_lo; g.mode_hi = mode_hi;
  g.n_rels = n_rels; g.rel_from_mode = rel_from_mode;
  g.rel_to_mode = rel_to_mode; g.rel_rev = rel_rev;
  g.indptr_off = indptr_off; g.indices_off = indices_off;
  g.indptr_cat = indptr_cat; g.indices_cat = indices_cat;

  Sampler s(g, seed);
  std::unordered_set<Key, KeyHash> dedup;
  const bool has_hard = structure >= 3;
  int written = 0;
  int64_t budget = 20LL * n_queries + 100;

  Walk w;
  std::vector<int32_t> scratch;
  while (written < n_queries && budget-- > 0) {
    for (int t = 0; t < max_tries; ++t)
      if (s.walk(structure, &w)) break; else w.n_rels = 0;
    if (w.n_rels == 0) continue;

    // dedup key: fnv over (rels, anchors, target)
    uint64_t h = 1469598103934665603ULL;
    auto mix = [&h](int64_t x) {
      h ^= (uint64_t)x; h *= 1099511628211ULL;
    };
    for (int i = 0; i < w.n_rels; ++i) mix(w.rels[i]);
    for (int i = 0; i < w.n_anchors; ++i) mix(w.anchors[i]);
    mix(w.target);
    if (!dedup.insert(Key{(int64_t)h}).second) continue;

    NodeSet* ans = nullptr;
    int n_branches = 0;
    s.answers(structure, w, &ans, &n_branches);
    const int tmode = g.mode_of(w.target);
    int n_negs = s.sample_negs(tmode, *ans,
                               out_negs + (int64_t)written * max_negs,
                               max_negs, exhaustive_negs != 0);
    if (n_negs == 0) continue;

    int n_hard = 0;
    if (has_hard) {
      // partial-branch matches (union of branches), minus full answers;
      // for ip the partial set lives at the join node v and must be
      // projected through r3 first. ns_hard stamps deduplicate; scratch
      // collects the survivors.
      scratch.clear();
      s.ns_hard.reset();
      if (structure == 5) {
        s.ns_tmp.reset();
        for (int b = 0; b < n_branches; ++b)
          for (int32_t x : s.ns_branch[b].members) s.ns_tmp.insert(x);
        s.ns_seen.reset();   // reuse as the projected set
        project_into(g, s.ns_tmp.members, w.rels[2], &s.ns_seen);
        for (int32_t x : s.ns_seen.members)
          if (!ans->count(x) && s.ns_hard.insert(x)) scratch.push_back(x);
      } else {
        for (int b = 0; b < n_branches; ++b)
          for (int32_t x : s.ns_branch[b].members)
            if (!ans->count(x) && s.ns_hard.insert(x)) scratch.push_back(x);
      }
      if ((int)scratch.size() > max_negs) {
        // uniform subsample without replacement (partial Fisher-Yates)
        for (int i = 0; i < max_negs; ++i) {
          int j = i + (int)(s.rng() % (scratch.size() - i));
          std::swap(scratch[i], scratch[j]);
        }
        scratch.resize(max_negs);
      }
      n_hard = (int)scratch.size();
      if (n_hard)
        std::memcpy(out_hard + (int64_t)written * max_negs, scratch.data(),
                    sizeof(int32_t) * n_hard);
    }

    for (int i = 0; i < 3; ++i) {
      out_rels[written * 3 + i] = i < w.n_rels ? w.rels[i] : -1;
      out_anchors[written * 3 + i] = i < w.n_anchors ? w.anchors[i] : -1;
    }
    out_targets[written] = w.target;
    out_neg_counts[written] = n_negs;
    out_hard_counts[written] = n_hard;
    ++written;
  }
  return written;
}

// Clean-test sampling (SURVEY §2.1 edge holdout): walk on the FULL graph,
// accept only queries whose target is NOT answerable on the TRAIN graph
// (>=1 held-out edge is required to answer them) — the generalization
// protocol. Negatives/hard negatives are computed on the FULL graph,
// matching data/sampling.py::QuerySampler.sample(train_graph=...). The
// train-side answer check reuses the same answer-set machinery on a second
// Sampler bound to the train adjacency (a walk's relations may have no
// train edges; the projections are then simply empty). Rejection is high by
// construction (~holdout_frac of walks are clean), so the budget scales
// accordingly.
int gqe_sample_clean_queries(
    // FULL graph
    int n_modes, const int32_t* mode_lo, const int32_t* mode_hi,
    int n_rels, const int32_t* rel_from_mode, const int32_t* rel_to_mode,
    const int32_t* rel_rev, const int64_t* indptr_off,
    const int64_t* indices_off, const int32_t* indptr_cat,
    const int32_t* indices_cat,
    // TRAIN graph (same schema arrays; its own CSR)
    const int64_t* t_indptr_off, const int64_t* t_indices_off,
    const int32_t* t_indptr_cat, const int32_t* t_indices_cat,
    // request
    int structure, int n_queries, uint64_t seed, int max_negs, int max_tries,
    int exhaustive_negs,
    // outputs (caller-allocated)
    int32_t* out_rels, int32_t* out_anchors, int32_t* out_targets,
    int32_t* out_negs, int32_t* out_neg_counts, int32_t* out_hard,
    int32_t* out_hard_counts) {
  Graph g;
  g.n_modes = n_modes; g.mode_lo = mode_lo; g.mode_hi = mode_hi;
  g.n_rels = n_rels; g.rel_from_mode = rel_from_mode;
  g.rel_to_mode = rel_to_mode; g.rel_rev = rel_rev;
  g.indptr_off = indptr_off; g.indices_off = indices_off;
  g.indptr_cat = indptr_cat; g.indices_cat = indices_cat;
  Graph tg = g;
  tg.indptr_off = t_indptr_off; tg.indices_off = t_indices_off;
  tg.indptr_cat = t_indptr_cat; tg.indices_cat = t_indices_cat;

  Sampler s(g, seed);
  Sampler st(tg, seed + 1);      // rng unused; carries the scratch sets
  std::unordered_set<Key, KeyHash> dedup;
  const bool has_hard = structure >= 3;
  int written = 0;
  int64_t budget = 400LL * n_queries + 1000;

  Walk w;
  std::vector<int32_t> scratch;
  while (written < n_queries && budget-- > 0) {
    for (int t = 0; t < max_tries; ++t)
      if (s.walk(structure, &w)) break; else w.n_rels = 0;
    if (w.n_rels == 0) continue;

    // clean filter: answerable on TRAIN -> reject
    NodeSet* tans = nullptr;
    int tb = 0;
    st.answers(structure, w, &tans, &tb);
    if (tans->count(w.target)) continue;

    uint64_t h = 1469598103934665603ULL;
    auto mix = [&h](int64_t x) {
      h ^= (uint64_t)x; h *= 1099511628211ULL;
    };
    for (int i = 0; i < w.n_rels; ++i) mix(w.rels[i]);
    for (int i = 0; i < w.n_anchors; ++i) mix(w.anchors[i]);
    mix(w.target);
    if (!dedup.insert(Key{(int64_t)h}).second) continue;

    NodeSet* ans = nullptr;
    int n_branches = 0;
    s.answers(structure, w, &ans, &n_branches);
    const int tmode = g.mode_of(w.target);
    int n_negs = s.sample_negs(tmode, *ans,
                               out_negs + (int64_t)written * max_negs,
                               max_negs, exhaustive_negs != 0);
    if (n_negs == 0) continue;

    int n_hard = 0;
    if (has_hard) {
      scratch.clear();
      s.ns_hard.reset();
      if (structure == 5) {
        s.ns_tmp.reset();
        for (int b = 0; b < n_branches; ++b)
          for (int32_t x : s.ns_branch[b].members) s.ns_tmp.insert(x);
        s.ns_seen.reset();
        project_into(g, s.ns_tmp.members, w.rels[2], &s.ns_seen);
        for (int32_t x : s.ns_seen.members)
          if (!ans->count(x) && s.ns_hard.insert(x)) scratch.push_back(x);
      } else {
        for (int b = 0; b < n_branches; ++b)
          for (int32_t x : s.ns_branch[b].members)
            if (!ans->count(x) && s.ns_hard.insert(x)) scratch.push_back(x);
      }
      if ((int)scratch.size() > max_negs) {
        for (int i = 0; i < max_negs; ++i) {
          int j = i + (int)(s.rng() % (scratch.size() - i));
          std::swap(scratch[i], scratch[j]);
        }
        scratch.resize(max_negs);
      }
      n_hard = (int)scratch.size();
      if (n_hard)
        std::memcpy(out_hard + (int64_t)written * max_negs, scratch.data(),
                    sizeof(int32_t) * n_hard);
    }

    for (int i = 0; i < 3; ++i) {
      out_rels[written * 3 + i] = i < w.n_rels ? w.rels[i] : -1;
      out_anchors[written * 3 + i] = i < w.n_anchors ? w.anchors[i] : -1;
    }
    out_targets[written] = w.target;
    out_neg_counts[written] = n_negs;
    out_hard_counts[written] = n_hard;
    ++written;
  }
  return written;
}

// Bulk 1p pool: EVERY edge of every relation as a 1p query with `max_negs`
// exact negatives (rejection-sampled against the anchor's answer set, which
// for 1p is just its neighbor row — built once per source and reused for all
// of that source's out-edges). This is how the reference gets 1p coverage:
// its train_edges set IS the full edge set, not a subsample — a 20k-query 1p
// pool leaves most embeddings without a single positive gradient at
// 100k-node scale (round-1 paper-scale failure mode).
//
// THREADED (n_threads workers): the (relation, source) space is partitioned
// into contiguous chunks of ~equal edge count; each worker writes compactly
// into the output slice starting at its chunk's edge-count prefix (disjoint
// slices, no locks — each edge yields at most one query), then slices are
// compacted left and truncated to `cap`. Per-worker RNG streams are seeded
// from (seed, worker), so results are deterministic for a fixed n_threads
// (different n_threads → different, equally valid, negative draws).
//
// If n_edges_total > cap, a uniform per-edge Bernoulli subsample of ~cap
// edges is taken. Returns the number of queries written.

namespace {

struct EdgeChunk {                // [r, s_begin..s_end) plus output offset
  int r;
  int32_t s_begin, s_end;
  int64_t out_off;                // edge-count prefix at chunk start
};

void all_edges_worker(const Graph& g, const std::vector<EdgeChunk>& chunks,
                      size_t c_begin, size_t c_end, uint64_t seed,
                      uint64_t keep_thresh, bool subsample, int max_negs,
                      int32_t* out_rels, int32_t* out_anchors,
                      int32_t* out_targets, int32_t* out_negs,
                      int32_t* out_neg_counts, int64_t* n_written) {
  std::mt19937_64 rng(seed);
  int64_t written = c_begin < c_end ? chunks[c_begin].out_off : 0;
  Set ans;
  for (size_t ci = c_begin; ci < c_end; ++ci) {
    const EdgeChunk& c = chunks[ci];
    const int to_m = g.rel_to_mode[c.r];
    const int32_t tlo = g.mode_lo[to_m], thi = g.mode_hi[to_m];
    const int64_t n_tmode = thi - tlo;
    for (int32_t s = c.s_begin; s < c.s_end; ++s) {
      auto [p, n] = g.neighbors(c.r, s);
      if (n == 0) continue;
      ans.clear();
      ans.insert(p, p + n);
      for (int e = 0; e < n; ++e) {
        if (subsample && rng() > keep_thresh) continue;
        int count = 0;
        int32_t* negp = out_negs + written * max_negs;
        if (n_tmode <= (int64_t)n + max_negs) {
          for (int32_t c2 = tlo; c2 < thi && count < max_negs; ++c2)
            if (!ans.count(c2)) negp[count++] = c2;
        } else {
          for (int64_t draws = 0; count < max_negs &&
               draws < 50LL * max_negs; ++draws) {
            int32_t c2 = tlo + (int32_t)(rng() % n_tmode);
            if (!ans.count(c2)) negp[count++] = c2;
          }
        }
        if (count == 0) continue;
        out_rels[written * 3] = c.r;
        out_rels[written * 3 + 1] = -1;
        out_rels[written * 3 + 2] = -1;
        out_anchors[written * 3] = s;
        out_anchors[written * 3 + 1] = -1;
        out_anchors[written * 3 + 2] = -1;
        out_targets[written] = p[e];
        out_neg_counts[written] = count;
        ++written;
      }
    }
  }
  *n_written = written - (c_begin < c_end ? chunks[c_begin].out_off : 0);
}

}  // namespace

int gqe_all_edges_1p(
    int n_modes, const int32_t* mode_lo, const int32_t* mode_hi,
    int n_rels, const int32_t* rel_from_mode, const int32_t* rel_to_mode,
    const int32_t* rel_rev, const int64_t* indptr_off,
    const int64_t* indices_off, const int32_t* indptr_cat,
    const int32_t* indices_cat,
    int64_t cap, uint64_t seed, int max_negs, int n_threads,
    int32_t* out_rels,        // [n_out_rows, 3]   (n_out_rows: see binding)
    int32_t* out_anchors,     // [n_out_rows, 3]
    int32_t* out_targets,     // [n_out_rows]
    int32_t* out_negs,        // [n_out_rows, max_negs]
    int32_t* out_neg_counts   // [n_out_rows]
) {
  Graph g;
  g.n_modes = n_modes; g.mode_lo = mode_lo; g.mode_hi = mode_hi;
  g.n_rels = n_rels; g.rel_from_mode = rel_from_mode;
  g.rel_to_mode = rel_to_mode; g.rel_rev = rel_rev;
  g.indptr_off = indptr_off; g.indices_off = indices_off;
  g.indices_cat = indices_cat; g.indptr_cat = indptr_cat;

  int64_t total = 0;
  for (int r = 0; r < n_rels; ++r) total += g.rel_nnz(r);
  const bool subsample = total > cap;
  const double p_keep = subsample ? (double)cap / (double)total : 1.0;
  const uint64_t keep_thresh =
      (uint64_t)(p_keep * 18446744073709551615.0);

  if (subsample) {
    // Bernoulli-subsample path stays SEQUENTIAL: the caller's buffer holds
    // only `cap` rows, but the threaded path's disjoint output slices are
    // offset by FULL edge-count prefixes (up to `total` rows) — writing
    // there would overrun the buffer, and proportional per-worker caps
    // would bias which edges survive. Full-coverage builds (cap >= total,
    // the paper-scale configuration) take the threaded path below.
    std::mt19937_64 rng(seed);
    int64_t written = 0;
    Set ans;
    for (int r = 0; r < n_rels && written < cap; ++r) {
      const int from_m = rel_from_mode[r];
      const int to_m = rel_to_mode[r];
      const int32_t lo = mode_lo[from_m], hi = mode_hi[from_m];
      const int32_t tlo = mode_lo[to_m], thi = mode_hi[to_m];
      const int64_t n_tmode = thi - tlo;
      for (int32_t s = lo; s < hi && written < cap; ++s) {
        auto [p, n] = g.neighbors(r, s);
        if (n == 0) continue;
        ans.clear();
        ans.insert(p, p + n);
        for (int e = 0; e < n && written < cap; ++e) {
          if (rng() > keep_thresh) continue;
          int count = 0;
          int32_t* negp = out_negs + written * max_negs;
          if (n_tmode <= (int64_t)n + max_negs) {
            for (int32_t c = tlo; c < thi && count < max_negs; ++c)
              if (!ans.count(c)) negp[count++] = c;
          } else {
            for (int64_t draws = 0; count < max_negs &&
                 draws < 50LL * max_negs; ++draws) {
              int32_t c = tlo + (int32_t)(rng() % n_tmode);
              if (!ans.count(c)) negp[count++] = c;
            }
          }
          if (count == 0) continue;
          out_rels[written * 3] = r;
          out_rels[written * 3 + 1] = -1;
          out_rels[written * 3 + 2] = -1;
          out_anchors[written * 3] = s;
          out_anchors[written * 3 + 1] = -1;
          out_anchors[written * 3 + 2] = -1;
          out_targets[written] = p[e];
          out_neg_counts[written] = count;
          ++written;
        }
      }
    }
    return (int)written;
  }

  if (n_threads < 1) n_threads = 1;
  // Partition (r, source-range) into chunks of ~total/(8*n_threads) edges
  // (over-decomposed so uneven negative-sampling cost balances out), each
  // carrying its exact edge-count prefix as the output offset.
  const int64_t target = std::max<int64_t>(1, total / (8 * n_threads));
  std::vector<EdgeChunk> chunks;
  int64_t prefix = 0;
  for (int r = 0; r < n_rels; ++r) {
    const int from_m = rel_from_mode[r];
    const int32_t lo = mode_lo[from_m], hi = mode_hi[from_m];
    const int32_t* ip = indptr_cat + indptr_off[r];
    int32_t s = lo;
    while (s < hi) {
      EdgeChunk c{r, s, s, prefix};
      int64_t cnt = 0;
      while (c.s_end < hi && cnt < target) {
        cnt += ip[c.s_end - lo + 1] - ip[c.s_end - lo];
        ++c.s_end;
      }
      s = c.s_end;
      prefix += cnt;
      if (cnt > 0) chunks.push_back(c);
    }
  }

  // assign contiguous chunk ranges to workers by edge count
  std::vector<size_t> cuts{0};
  {
    int64_t per = (total + n_threads - 1) / n_threads, acc = 0;
    for (size_t i = 0; i < chunks.size(); ++i) {
      int64_t next = (i + 1 < chunks.size()) ? chunks[i + 1].out_off : total;
      acc = next;
      if (acc >= (int64_t)cuts.size() * per && cuts.size() < (size_t)n_threads)
        cuts.push_back(i + 1);
    }
    while (cuts.size() < (size_t)n_threads + 1) cuts.push_back(chunks.size());
  }

  std::vector<int64_t> counts(n_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t)
    threads.emplace_back(
        all_edges_worker, std::cref(g), std::cref(chunks), cuts[t],
        cuts[t + 1], seed + 0x9E3779B97F4A7C15ULL * (uint64_t)(t + 1),
        keep_thresh, subsample, max_negs, out_rels, out_anchors, out_targets,
        out_negs, out_neg_counts, &counts[t]);
  for (auto& th : threads) th.join();

  // compact worker slices left; truncate to cap
  int64_t written = counts[0];
  for (int t = 1; t < n_threads; ++t) {
    const int64_t src = chunks[cuts[t]].out_off;  // cuts[t] < size if counts>0
    const int64_t cnt = counts[t];
    if (cnt == 0) continue;
    if (src != written) {
      std::memmove(out_rels + written * 3, out_rels + src * 3,
                   sizeof(int32_t) * 3 * cnt);
      std::memmove(out_anchors + written * 3, out_anchors + src * 3,
                   sizeof(int32_t) * 3 * cnt);
      std::memmove(out_targets + written, out_targets + src,
                   sizeof(int32_t) * cnt);
      std::memmove(out_negs + written * max_negs, out_negs + src * max_negs,
                   sizeof(int32_t) * (int64_t)max_negs * cnt);
      std::memmove(out_neg_counts + written, out_neg_counts + src,
                   sizeof(int32_t) * cnt);
    }
    written += cnt;
  }
  if (written > cap) written = cap;
  return (int)written;
}

}  // extern "C"
