// Serial gang scorer and exact repair, host C++ (not a kernel).
//
// grove_tpu_torch's own copy of grove_tpu/native/serial_scorer.cpp, kept
// identical in algorithm so the two packages place bit for bit. Its ABI
// differs: the commit into free and the placement scores run here, the
// repair reads its candidates' nodes from a domain->node index, and its
// exactness net skips the level scan for a gang the free aggregate
// cannot hold (aggregate_short), which places nothing differently.
// `solve_serial` is the native serial baseline; `repair_gangs` is the
// engine's default exact repair (PlacementEngine native_repair=True).
// The algorithm mirrors grove_tpu_torch/solver/serial.py and fit.py
// exactly: gangs in priority order; candidate levels narrowest ->
// broadest down to the gang's required level (level -1 = cluster root);
// domains within a level filtered by aggregate feasibility and ordered
// tightest-first; exact placement by best-fit-decreasing with one level
// of group nesting (each pod group may require packing into a single
// domain at its own level).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (driven by
// grove_tpu_torch/native/build.py), called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Ctx {
  int32_t num_nodes;
  int32_t num_res;
  int32_t num_levels;
  const float* capacity;      // [N*R]
  const int32_t* domain_ids;  // [L*N]
  const uint8_t* schedulable; // [N]
  // Node-eligibility (node_selector/tolerations): unique mask rows [M*N]
  // + per-pod row index (-1 = unconstrained). Both null when the backlog
  // carries no masks. Hard filter, enforced in bfd exactly like the
  // Python fit primitives.
  const uint8_t* elig_masks;     // [M*N] or null
  const int32_t* pod_mask_idx;   // [P_total] or null
  std::vector<float> cap_scale;
};

inline bool eligible(const Ctx& ctx, int32_t pod, int32_t node) {
  if (!ctx.pod_mask_idx) return true;
  int32_t mi = ctx.pod_mask_idx[pod];
  if (mi < 0) return true;
  return ctx.elig_masks[(size_t)mi * ctx.num_nodes + node] != 0;
}

inline float dominant_share(const Ctx& ctx, const float* vec) {
  float best = -1e30f;
  for (int r = 0; r < ctx.num_res; ++r) {
    float v = vec[r] / ctx.cap_scale[r];
    if (v > best) best = v;
  }
  return best;
}

inline bool fits(const Ctx& ctx, const float* free_row, const float* demand) {
  for (int r = 0; r < ctx.num_res; ++r) {
    if (free_row[r] + 1e-6f < demand[r]) return false;
  }
  return true;
}

// Best-fit-decreasing of `pods` (indices into demand matrix) onto nodes in
// `dom`. Mutates free/assign; returns false on failure (caller restores).
bool bfd(const Ctx& ctx, const std::vector<int32_t>& pods, const float* demand,
         const std::vector<int32_t>& dom, std::vector<float>& free,
         int32_t* assign) {
  std::vector<int32_t> order(pods);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return dominant_share(ctx, demand + a * ctx.num_res) >
           dominant_share(ctx, demand + b * ctx.num_res);
  });
  for (int32_t p : order) {
    const float* d = demand + p * ctx.num_res;
    int32_t best_node = -1;
    float best_left = 1e30f;
    for (int32_t n : dom) {
      if (!eligible(ctx, p, n)) continue;
      float* row = free.data() + n * ctx.num_res;
      if (!fits(ctx, row, d)) continue;
      float left = -1e30f;
      for (int r = 0; r < ctx.num_res; ++r) {
        float v = (row[r] - d[r]) / ctx.cap_scale[r];
        if (v > left) left = v;
      }
      if (left < best_left) {
        best_left = left;
        best_node = n;
      }
    }
    if (best_node < 0) return false;
    for (int r = 0; r < ctx.num_res; ++r)
      free[best_node * ctx.num_res + r] -= d[r];
    assign[p] = best_node;
  }
  return true;
}

// Split `dom` into subdomains at `level`, aggregate-feasible for `total`,
// ordered tightest first.
std::vector<std::vector<int32_t>> subdomains_tightest(
    const Ctx& ctx, const std::vector<int32_t>& dom, int level,
    const float* total, const std::vector<float>& free) {
  std::vector<std::pair<int32_t, std::vector<int32_t>>> by_id;
  for (int32_t n : dom) {
    int32_t id = ctx.domain_ids[level * ctx.num_nodes + n];
    auto it = std::find_if(by_id.begin(), by_id.end(),
                           [id](const auto& kv) { return kv.first == id; });
    if (it == by_id.end())
      by_id.push_back({id, {n}});
    else
      it->second.push_back(n);
  }
  struct Keyed {
    float slack;
    int idx;
    std::vector<int32_t> nodes;
  };
  std::vector<Keyed> keyed;
  int idx = 0;
  for (auto& kv : by_id) {
    std::vector<float> agg(ctx.num_res, 0.0f);
    for (int32_t n : kv.second)
      for (int r = 0; r < ctx.num_res; ++r) agg[r] += free[n * ctx.num_res + r];
    bool ok = true;
    for (int r = 0; r < ctx.num_res; ++r)
      if (agg[r] + 1e-6f < total[r]) ok = false;
    if (!ok) {
      ++idx;
      continue;
    }
    for (int r = 0; r < ctx.num_res; ++r) agg[r] -= total[r];
    keyed.push_back({dominant_share(ctx, agg.data()), idx++, std::move(kv.second)});
  }
  std::stable_sort(keyed.begin(), keyed.end(), [](const Keyed& a, const Keyed& b) {
    return a.slack < b.slack || (a.slack == b.slack && a.idx < b.idx);
  });
  std::vector<std::vector<int32_t>> out;
  out.reserve(keyed.size());
  for (auto& k : keyed) out.push_back(std::move(k.nodes));
  return out;
}

struct Gang {
  int32_t pod_begin, pod_end;  // into demand matrix
  int32_t required_level;
  int32_t preferred_level;
  const int32_t* group_ids;       // per pod (relative)
  const int32_t* group_levels;    // per group: required level or -1
  const int32_t* group_prefs;     // per group: preferred level or -1
  int32_t num_groups;
  // constraint groups (PCSG co-location inside a base gang,
  // podgang.go:121-132): each spans a subset of pod groups
  int32_t num_cgroups;
  const int32_t* cg_req;           // [num_cgroups]
  const int32_t* cg_pref;          // [num_cgroups]
  const int32_t* cg_member_begin;  // [num_cgroups+1] into cg_members
  const int32_t* cg_members;       // group indices
};

// Co-location unit — the C++ mirror of fit.py's _Unit tree: gang root ->
// constraint groups -> pod groups, each placed inside ONE domain at its
// required level, with soft preferred levels tried first. Semantics and
// ordering (tightest-first candidates, stable largest-first children,
// BFD) match fit.py line for line so native and Python repair produce
// identical placements.
struct Unit {
  int32_t req = -1, pref = -1;
  std::vector<int32_t> pods;   // direct pods (absolute demand rows)
  std::vector<int32_t> children;  // indices into the arena
};

void collect_pods(const std::vector<Unit>& arena, const Unit& u,
                  std::vector<int32_t>* out) {
  out->insert(out->end(), u.pods.begin(), u.pods.end());
  for (int32_t c : u.children) collect_pods(arena, arena[c], out);
}

// Build the unit arena for one gang; returns the root's index.
int32_t build_unit_tree(const Gang& g, std::vector<Unit>* arena) {
  arena->clear();
  arena->push_back(Unit{});  // root
  // per-group pod lists (ascending pod index, matching np.flatnonzero)
  std::vector<std::vector<int32_t>> group_pods(g.num_groups);
  for (int32_t p = g.pod_begin; p < g.pod_end; ++p) {
    int32_t gi = g.group_ids[p - g.pod_begin];
    if (gi >= 0 && gi < g.num_groups) group_pods[gi].push_back(p);
  }
  std::vector<char> in_cg(g.num_groups, 0);
  for (int32_t c = 0; c < g.num_cgroups; ++c) {
    Unit cg;
    cg.req = g.cg_req[c];
    cg.pref = g.cg_pref[c];
    for (int32_t m = g.cg_member_begin[c]; m < g.cg_member_begin[c + 1]; ++m) {
      int32_t gi = g.cg_members[m];
      in_cg[gi] = 1;
      Unit gu;
      gu.req = g.group_levels[gi];
      gu.pref = g.group_prefs[gi];
      gu.pods = group_pods[gi];
      arena->push_back(std::move(gu));
      cg.children.push_back((int32_t)arena->size() - 1);
    }
    arena->push_back(std::move(cg));
    (*arena)[0].children.push_back((int32_t)arena->size() - 1);
  }
  for (int32_t gi = 0; gi < g.num_groups; ++gi) {
    if (in_cg[gi]) continue;
    if (g.group_levels[gi] >= 0 || g.group_prefs[gi] >= 0) {
      Unit gu;
      gu.req = g.group_levels[gi];
      gu.pref = g.group_prefs[gi];
      gu.pods = group_pods[gi];
      arena->push_back(std::move(gu));
      (*arena)[0].children.push_back((int32_t)arena->size() - 1);
    } else {
      // level-free groups' pods are loose on the root, in group order
      (*arena)[0].pods.insert((*arena)[0].pods.end(),
                              group_pods[gi].begin(), group_pods[gi].end());
    }
  }
  (*arena)[0].req = -1;  // enclosing domain chosen by the caller
  (*arena)[0].pref = g.preferred_level;
  return 0;
}

bool place_unit(const Ctx& ctx, const std::vector<Unit>& arena,
                const Unit& u, const float* demand,
                const std::vector<int32_t>& dom, int domain_level,
                std::vector<float>& free, int32_t* assign);

// fit.py _place_child: a constrained child goes inside exactly ONE
// subdomain at its required level (tightest-first, backtracking).
bool place_child(const Ctx& ctx, const std::vector<Unit>& arena,
                 const Unit& c, const float* demand,
                 const std::vector<int32_t>& dom, int domain_level,
                 std::vector<float>& free, int32_t* assign) {
  if (c.req <= domain_level) {
    return place_unit(ctx, arena, c, demand, dom, domain_level, free, assign);
  }
  std::vector<int32_t> pods_all;
  collect_pods(arena, c, &pods_all);
  std::vector<float> total(ctx.num_res, 0.0f);
  for (int32_t p : pods_all)
    for (int r = 0; r < ctx.num_res; ++r) total[r] += demand[p * ctx.num_res + r];
  auto subs = subdomains_tightest(ctx, dom, c.req, total.data(), free);
  for (auto& sub : subs) {
    std::vector<float> save_free;
    save_free.reserve(sub.size() * ctx.num_res);
    for (int32_t n : sub)
      for (int r = 0; r < ctx.num_res; ++r)
        save_free.push_back(free[n * ctx.num_res + r]);
    std::vector<int32_t> save_assign;
    save_assign.reserve(pods_all.size());
    for (int32_t p : pods_all) save_assign.push_back(assign[p]);
    if (place_unit(ctx, arena, c, demand, sub, c.req, free, assign))
      return true;
    size_t k = 0;
    for (int32_t n : sub)
      for (int r = 0; r < ctx.num_res; ++r)
        free[n * ctx.num_res + r] = save_free[k++];
    for (size_t i = 0; i < pods_all.size(); ++i)
      assign[pods_all[i]] = save_assign[i];
  }
  return false;
}

// fit.py _place_unit: soft preference first (whole unit inside one
// preferred-level subdomain, stripped recursion), then children largest
// demand first, then the unit's loose pods BFD.
bool place_unit(const Ctx& ctx, const std::vector<Unit>& arena,
                const Unit& u, const float* demand,
                const std::vector<int32_t>& dom, int domain_level,
                std::vector<float>& free, int32_t* assign) {
  if (u.pref > domain_level) {
    std::vector<int32_t> pods_all;
    collect_pods(arena, u, &pods_all);
    std::vector<float> total(ctx.num_res, 0.0f);
    for (int32_t p : pods_all)
      for (int r = 0; r < ctx.num_res; ++r)
        total[r] += demand[p * ctx.num_res + r];
    auto subs = subdomains_tightest(ctx, dom, u.pref, total.data(), free);
    Unit stripped = u;
    stripped.pref = -1;
    for (auto& sub : subs) {
      std::vector<float> save_free;
      save_free.reserve(sub.size() * ctx.num_res);
      for (int32_t n : sub)
        for (int r = 0; r < ctx.num_res; ++r)
          save_free.push_back(free[n * ctx.num_res + r]);
      std::vector<int32_t> save_assign;
      save_assign.reserve(pods_all.size());
      for (int32_t p : pods_all) save_assign.push_back(assign[p]);
      if (place_unit(ctx, arena, stripped, demand, sub, u.pref, free, assign))
        return true;
      size_t k = 0;
      for (int32_t n : sub)
        for (int r = 0; r < ctx.num_res; ++r)
          free[n * ctx.num_res + r] = save_free[k++];
      for (size_t i = 0; i < pods_all.size(); ++i)
        assign[pods_all[i]] = save_assign[i];
    }
    // fall through: preference unsatisfiable, place unrestricted
  }
  // children first, larger total demand first (stable, like sorted())
  std::vector<int32_t> corder(u.children);
  std::stable_sort(corder.begin(), corder.end(), [&](int32_t a, int32_t b) {
    float sa = 0, sb = 0;
    std::vector<int32_t> pa, pb;
    collect_pods(arena, arena[a], &pa);
    collect_pods(arena, arena[b], &pb);
    for (int32_t p : pa)
      for (int r = 0; r < ctx.num_res; ++r) sa += demand[p * ctx.num_res + r];
    for (int32_t p : pb)
      for (int r = 0; r < ctx.num_res; ++r) sb += demand[p * ctx.num_res + r];
    return sa > sb;
  });
  for (int32_t c : corder) {
    if (!place_child(ctx, arena, arena[c], demand, dom, domain_level, free,
                     assign))
      return false;
  }
  return bfd(ctx, u.pods, demand, dom, free, assign);
}

// Place one gang inside `dom` (already a single domain at `dom_level`).
bool place_in_domain(const Ctx& ctx, const Gang& g, const float* demand,
                     const std::vector<int32_t>& dom, int dom_level,
                     std::vector<float>& free, int32_t* assign) {
  std::vector<Unit> arena;
  build_unit_tree(g, &arena);
  return place_unit(ctx, arena, arena[0], demand, dom, dom_level, free,
                    assign);
}

// The exactness net's level scan: levels narrowest first down to the
// gang's required level (-1 = the cluster root), each level's
// aggregate-feasible domains tightest first, the first that holds the gang
// keeps it. Returns whether one did; a failed domain's free is restored.
bool place_by_scan(const Ctx& ctx, const Gang& g, const float* demand,
                   const float* total, const std::vector<int32_t>& sched,
                   std::vector<float>& free, int32_t* assign) {
  const int num_res = ctx.num_res;
  int stop = g.required_level >= 0 ? g.required_level : -1;
  for (int level = ctx.num_levels - 1; level >= stop; --level) {
    std::vector<std::vector<int32_t>> doms;
    if (level == -1) {
      // aggregate check for the root mirrors subdomains_tightest
      std::vector<float> agg(num_res, 0.0f);
      for (int32_t n : sched)
        for (int r = 0; r < num_res; ++r) agg[r] += free[n * num_res + r];
      bool ok = true;
      for (int r = 0; r < num_res; ++r)
        if (agg[r] + 1e-6f < total[r]) ok = false;
      if (ok) doms.push_back(sched);
    } else {
      doms = subdomains_tightest(ctx, sched, level, total, free);
    }
    for (auto& dom : doms) {
      std::vector<float> save;
      save.reserve(dom.size() * num_res);
      for (int32_t n : dom)
        for (int r = 0; r < num_res; ++r) save.push_back(free[n * num_res + r]);
      if (place_in_domain(ctx, g, demand, dom, level, free, assign))
        return true;
      size_t k = 0;
      for (int32_t n : dom)
        for (int r = 0; r < num_res; ++r) free[n * num_res + r] = save[k++];
    }
  }
  return false;
}

// Whether the level scan is sure to find no domain for `total`: some
// resource's free, summed over `sched` in node order with each entry
// clamped at 0, is short of it. Every aggregate the scan takes (each
// subdomain of subdomains_tightest, the root) sums some of these nodes in
// the same order, unclamped. A float32 sum rounded to nearest never
// decreases when an addend grows, and a node left out adds an exact 0, so
// each of those aggregates is at most this bound and fails the same
// `+ 1e-6f <` test. The clamp is what makes that hold: fits() admits
// free + 1e-6 >= demand, so a node may sit a hair below 0 after a commit.
bool aggregate_short(const Ctx& ctx, const std::vector<int32_t>& sched,
                     const float* total, const std::vector<float>& free) {
  const int num_res = ctx.num_res;
  std::vector<float> bound(num_res, 0.0f);
  for (int32_t n : sched)
    for (int r = 0; r < num_res; ++r)
      bound[r] += std::max(free[n * num_res + r], 0.0f);
  for (int r = 0; r < num_res; ++r)
    if (bound[r] + 1e-6f < total[r]) return true;
  return false;
}

// Commit every placed pod's demand into the caller's `free_io` and write
// each gang's narrowest shared level. The commit runs in pod-index order,
// one pod at a time (np.subtract.at's order), so `free_io` comes out
// bitwise what that would give, fractional demands included. A gang's
// narrowest shared level is the deepest level at which every pod's node
// has the same domain id (-1 = none); fit.placement_score_for_nodes
// turns it into the score. Unplaced gangs read -1.
void commit_and_score(int32_t num_nodes, int32_t num_res, int32_t num_levels,
                      const int32_t* domain_ids, int32_t num_gangs,
                      const int32_t* pod_offsets, const float* demand,
                      const int32_t* assign, float* free_io,
                      int32_t* narrowest) {
  int32_t total_pods = pod_offsets[num_gangs];
  for (int32_t p = 0; p < total_pods; ++p) {
    int32_t n = assign[p];
    if (n < 0) continue;
    for (int r = 0; r < num_res; ++r)
      free_io[(size_t)n * num_res + r] -= demand[(size_t)p * num_res + r];
  }
  for (int32_t g = 0; g < num_gangs; ++g) {
    int32_t begin = pod_offsets[g], end = pod_offsets[g + 1];
    int32_t best = -1;
    if (assign[begin] >= 0) {
      for (int level = 0; level < num_levels; ++level) {
        const int32_t* ids = domain_ids + (size_t)level * num_nodes;
        int32_t first = ids[assign[begin]];
        bool same = true;
        for (int32_t p = begin + 1; p < end && same; ++p)
          same = ids[assign[p]] == first;
        if (same) best = level;
      }
    }
    narrowest[g] = best;
  }
}

}  // namespace

extern "C" {

// ABI/capability handshake: the Python loader (native/build.py) refuses
// any library whose version differs from its expected constant, so a
// stale or foreign .so degrades to the Python reference implementation
// instead of marshalling arguments into undefined behavior. Bump on ANY
// signature or constraint-model change. v3 = full fit.py model:
// gang/group required+preferred levels, constraint groups, eligibility
// masks. v4 = both entry points commit into the caller's free matrix and
// return each gang's narrowest shared level; repair_gangs reads its
// candidates' nodes from a domain->node index and counts the candidates.
// v5 = repair_gangs' net skips a gang its free aggregate cannot hold and
// counts those gangs (net_short_out).
int32_t grove_native_abi(void) { return 5; }

// Returns number of gangs placed. assign[P_total] gets the node index per
// pod (-1 if the owning gang is unplaced). gang_order: priority order is
// the caller's array order (Python pre-sorts, same as serial.py).
int32_t solve_serial(
    int32_t num_nodes, int32_t num_res, int32_t num_levels,
    const float* capacity,        // [N*R] for cap_scale
    float* free_io,               // [N*R] in: free, out: less the placed pods
    const uint8_t* schedulable,   // [N]
    const int32_t* domain_ids,    // [L*N]
    int32_t num_gangs,
    const int32_t* pod_offsets,   // [G+1] into demand rows
    const float* demand,          // [P_total * R]
    const int32_t* required_level,  // [G]
    const int32_t* preferred_level, // [G] soft gang pack level or -1
    const int32_t* group_ids,       // [P_total] per-pod group (relative)
    const int32_t* group_offsets,   // [G+1] into group_levels/group_prefs
    const int32_t* group_levels,    // per gang's groups: level or -1
    const int32_t* group_prefs,     // per gang's groups: pref level or -1
    // constraint groups (flattened per gang; all null/empty when absent)
    const int32_t* cg_offsets,      // [G+1] into cg_req/cg_pref
    const int32_t* cg_req,          // [C_total]
    const int32_t* cg_pref,         // [C_total]
    const int32_t* cg_member_offsets,  // [C_total+1] into cg_members
    const int32_t* cg_members,      // member group indices (relative)
    const uint8_t* elig_masks,      // [M*N] or null
    const int32_t* pod_mask_idx,    // [P_total] or null
    int32_t* assign,                // out [P_total]
    int32_t* narrowest              // out [G] narrowest shared level or -1
) {
  Ctx ctx;
  ctx.num_nodes = num_nodes;
  ctx.num_res = num_res;
  ctx.num_levels = num_levels;
  ctx.capacity = capacity;
  ctx.domain_ids = domain_ids;
  ctx.schedulable = schedulable;
  ctx.elig_masks = elig_masks;
  ctx.pod_mask_idx = pod_mask_idx;
  ctx.cap_scale.assign(num_res, 1e-9f);
  for (int n = 0; n < num_nodes; ++n)
    for (int r = 0; r < num_res; ++r)
      ctx.cap_scale[r] = std::max(ctx.cap_scale[r], capacity[n * num_res + r]);

  std::vector<float> free(free_io, free_io + (size_t)num_nodes * num_res);
  std::vector<int32_t> sched;
  for (int n = 0; n < num_nodes; ++n)
    if (schedulable[n]) sched.push_back(n);

  int32_t total_pods = pod_offsets[num_gangs];
  for (int32_t i = 0; i < total_pods; ++i) assign[i] = -1;

  int32_t placed_count = 0;
  for (int32_t gidx = 0; gidx < num_gangs; ++gidx) {
    Gang g;
    g.pod_begin = pod_offsets[gidx];
    g.pod_end = pod_offsets[gidx + 1];
    g.required_level = required_level[gidx];
    g.preferred_level = preferred_level ? preferred_level[gidx] : -1;
    g.group_ids = group_ids + g.pod_begin;
    g.group_levels = group_levels + group_offsets[gidx];
    g.group_prefs = group_prefs + group_offsets[gidx];
    g.num_groups = group_offsets[gidx + 1] - group_offsets[gidx];
    int32_t cg0 = cg_offsets ? cg_offsets[gidx] : 0;
    g.num_cgroups = cg_offsets ? cg_offsets[gidx + 1] - cg0 : 0;
    g.cg_req = cg_req ? cg_req + cg0 : nullptr;
    g.cg_pref = cg_pref ? cg_pref + cg0 : nullptr;
    g.cg_member_begin = cg_member_offsets ? cg_member_offsets + cg0 : nullptr;
    g.cg_members = cg_members;
    std::vector<float> total(num_res, 0.0f);
    for (int32_t p = g.pod_begin; p < g.pod_end; ++p)
      for (int r = 0; r < num_res; ++r) total[r] += demand[p * num_res + r];

    bool placed = place_by_scan(ctx, g, demand, total.data(), sched, free,
                                assign);
    if (placed) {
      ++placed_count;
    } else {
      for (int32_t p = g.pod_begin; p < g.pod_end; ++p) assign[p] = -1;
    }
  }
  commit_and_score(num_nodes, num_res, num_levels, domain_ids, num_gangs,
                   pod_offsets, demand, assign, free_io, narrowest);
  return placed_count;
}

}  // extern "C"

extern "C" {

// Repair/commit phase for the accelerator path: gangs arrive with top-k
// candidate domains from the device scoring+contention pass; each gang is
// committed exactly (best-fit-decreasing, group constraints) into the
// first candidate that fits, with a full serial level-scan as the
// fallback net. Mirrors PlacementEngine's Python repair loop so both
// produce identical placements; this exists because at stress scale the
// Python loop dominated the solve wall-clock.
//
// dom_level[D]: level of each global domain id (-1 = cluster root).
// dom_node_offsets[D+1] / dom_nodes: every global domain's nodes, in
// ascending order (a CSR the engine builds once per snapshot); the walk
// keeps only the schedulable ones, so a node cordoned since the index
// was built is skipped. The root's entry is not read.
// top_dom/top_val: [G*K] candidates (row-major, best first); entries with
// top_val <= -5e8 are invalid.
// Returns number of gangs placed; fallbacks_out counts the gangs that
// reached the net, net_short_out those of them the net rejected by the
// free aggregate alone (aggregate_short) without a scan, candidates_out
// the candidate domains tried. free_io and narrowest as in solve_serial.
int32_t repair_gangs(
    int32_t num_nodes, int32_t num_res, int32_t num_levels,
    const float* capacity, float* free_io, const uint8_t* schedulable,
    const int32_t* domain_ids,
    int32_t num_gangs, const int32_t* pod_offsets, const float* demand,
    const int32_t* required_level, const int32_t* preferred_level,
    const int32_t* group_ids,
    const int32_t* group_offsets, const int32_t* group_levels,
    const int32_t* group_prefs,
    const int32_t* cg_offsets, const int32_t* cg_req, const int32_t* cg_pref,
    const int32_t* cg_member_offsets, const int32_t* cg_members,
    const int32_t* top_dom, const float* top_val, int32_t top_k,
    const int32_t* dom_level,
    const int32_t* dom_node_offsets, const int32_t* dom_nodes,
    const uint8_t* elig_masks, const int32_t* pod_mask_idx,
    int32_t* assign, int32_t* narrowest, int32_t* fallbacks_out,
    int32_t* candidates_out, int32_t* net_short_out) {
  Ctx ctx;
  ctx.num_nodes = num_nodes;
  ctx.num_res = num_res;
  ctx.num_levels = num_levels;
  ctx.capacity = capacity;
  ctx.domain_ids = domain_ids;
  ctx.schedulable = schedulable;
  ctx.elig_masks = elig_masks;
  ctx.pod_mask_idx = pod_mask_idx;
  ctx.cap_scale.assign(num_res, 1e-9f);
  for (int n = 0; n < num_nodes; ++n)
    for (int r = 0; r < num_res; ++r)
      ctx.cap_scale[r] = std::max(ctx.cap_scale[r], capacity[n * num_res + r]);

  std::vector<float> free(free_io, free_io + (size_t)num_nodes * num_res);
  std::vector<int32_t> sched;
  for (int n = 0; n < num_nodes; ++n)
    if (schedulable[n]) sched.push_back(n);

  int32_t total_pods = pod_offsets[num_gangs];
  for (int32_t i = 0; i < total_pods; ++i) assign[i] = -1;

  int32_t placed_count = 0;
  int32_t fallbacks = 0;
  int32_t candidates = 0;
  int32_t net_short = 0;
  std::vector<int32_t> dom;
  for (int32_t gidx = 0; gidx < num_gangs; ++gidx) {
    Gang g;
    g.pod_begin = pod_offsets[gidx];
    g.pod_end = pod_offsets[gidx + 1];
    g.required_level = required_level[gidx];
    g.preferred_level = preferred_level ? preferred_level[gidx] : -1;
    g.group_ids = group_ids + g.pod_begin;
    g.group_levels = group_levels + group_offsets[gidx];
    g.group_prefs = group_prefs + group_offsets[gidx];
    g.num_groups = group_offsets[gidx + 1] - group_offsets[gidx];
    int32_t cg0 = cg_offsets ? cg_offsets[gidx] : 0;
    g.num_cgroups = cg_offsets ? cg_offsets[gidx + 1] - cg0 : 0;
    g.cg_req = cg_req ? cg_req + cg0 : nullptr;
    g.cg_pref = cg_pref ? cg_pref + cg0 : nullptr;
    g.cg_member_begin = cg_member_offsets ? cg_member_offsets + cg0 : nullptr;
    g.cg_members = cg_members;

    bool placed = false;
    for (int32_t k = 0; k < top_k && !placed; ++k) {
      if (top_val[gidx * top_k + k] <= -5e8f) break;
      int32_t d = top_dom[gidx * top_k + k];
      int level = dom_level[d];
      ++candidates;
      if (level < 0) {
        dom = sched;
      } else {
        dom.clear();
        for (int32_t i = dom_node_offsets[d]; i < dom_node_offsets[d + 1]; ++i)
          if (schedulable[dom_nodes[i]]) dom.push_back(dom_nodes[i]);
      }
      if (dom.empty()) continue;
      std::vector<float> save;
      save.reserve(dom.size() * num_res);
      for (int32_t n : dom)
        for (int r = 0; r < num_res; ++r) save.push_back(free[n * num_res + r]);
      if (place_in_domain(ctx, g, demand, dom, level, free, assign)) {
        placed = true;
        break;
      }
      size_t ki = 0;
      for (int32_t n : dom)
        for (int r = 0; r < num_res; ++r) free[n * num_res + r] = save[ki++];
    }
    if (!placed) {
      // exactness net: solve_serial's level scan, skipped where the free
      // aggregate shows it cannot place the gang
      ++fallbacks;
      std::vector<float> total(num_res, 0.0f);
      for (int32_t p = g.pod_begin; p < g.pod_end; ++p)
        for (int r = 0; r < num_res; ++r) total[r] += demand[p * num_res + r];
      if (aggregate_short(ctx, sched, total.data(), free))
        ++net_short;
      else
        placed = place_by_scan(ctx, g, demand, total.data(), sched, free,
                               assign);
    }
    if (placed) {
      ++placed_count;
    } else {
      for (int32_t p = g.pod_begin; p < g.pod_end; ++p) assign[p] = -1;
    }
  }
  commit_and_score(num_nodes, num_res, num_levels, domain_ids, num_gangs,
                   pod_offsets, demand, assign, free_io, narrowest);
  if (fallbacks_out) *fallbacks_out = fallbacks;
  if (candidates_out) *candidates_out = candidates;
  if (net_short_out) *net_short_out = net_short;
  return placed_count;
}

}  // extern "C"
