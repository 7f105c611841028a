// Native MCMC strategy-search annealing loop.
//
// The analog of FFModel::optimize (reference src/runtime/model.cc:1905-1968):
// simulated annealing over per-op strategy candidates with `rewrite` and
// `propagate` moves, accepting uphill moves with prob exp(-delta/(alpha*cur)),
// resetting to the best strategy every budget/100 iterations.  Candidate
// costs are precomputed by the Python cost model (the stand-in for
// Op::measure_operator_cost); this file owns the hot loop: per-iteration
// task-graph construction + event simulation, matching
// flexflow_tpu_torch/search/simulator.py Simulator._simulate_raw exactly —
// including device-explicit placements (per-device resources so disjoint
// placements run concurrently) and pipeline candidates expanded into the
// real (microbatch, stage) GPipe schedule.  Fusion folding remains
// Python-only: fused searches route to the Python engine.

#include "sim_core.h"
#include "flexflow_torch_c.h"

#include <algorithm>
#include <cmath>
#include <random>
#include <vector>

namespace {

using fftpu::MTask;

// Fixed resource ids; device resources are 2..2+n_dev-1; per-op stage
// and join resources are allocated after them during construction.
constexpr int32_t kCompute = 0;
constexpr int32_t kComm = 1;

// Edge lists grouped per op, preserving the caller's edge order (which
// is the Python simulator's iteration order over op.inputs).
struct Graph {
  int32_t n_ops = 0;
  int32_t n_dev = 0;
  std::vector<int32_t> in_ptr, in_idx;    // producers of op (by dst)
  std::vector<int32_t> out_ptr, out_idx;  // consumers of op (by src)
};

Graph build_graph(int32_t n_ops, int32_t n_dev, int32_t n_edges,
                  const int32_t *edge_src, const int32_t *edge_dst) {
  Graph g;
  g.n_ops = n_ops;
  g.n_dev = n_dev;
  g.in_ptr.assign(n_ops + 1, 0);
  g.out_ptr.assign(n_ops + 1, 0);
  for (int32_t e = 0; e < n_edges; ++e) {
    ++g.in_ptr[edge_dst[e] + 1];
    ++g.out_ptr[edge_src[e] + 1];
  }
  for (int32_t i = 0; i < n_ops; ++i) {
    g.in_ptr[i + 1] += g.in_ptr[i];
    g.out_ptr[i + 1] += g.out_ptr[i];
  }
  g.in_idx.resize(n_edges);
  g.out_idx.resize(n_edges);
  std::vector<int32_t> ic(g.in_ptr.begin(), g.in_ptr.end() - 1);
  std::vector<int32_t> oc(g.out_ptr.begin(), g.out_ptr.end() - 1);
  for (int32_t e = 0; e < n_edges; ++e) {
    g.in_idx[ic[edge_dst[e]]++] = edge_src[e];
    g.out_idx[oc[edge_src[e]]++] = edge_dst[e];
  }
  return g;
}

// Per-(op, candidate) costs, flattened.  place_* carries the explicit
// device list of placed candidates (OpStrategy.device_ids); pipe_*
// carries the PipelineCost fields of layer->pipe candidates.
struct Costs {
  const int32_t *cand_offsets;
  const double *fwd, *bwd, *fwd_comm, *bwd_comm, *sync, *mem;
  const int32_t *place_off;   // into place_ids, len total_cands+1
  const int32_t *place_ids;
  const int32_t *pipe_stages; // 0 = not pipelined
  const int32_t *pipe_mb;
  const double *pipe_fwd_stage, *pipe_bwd_stage, *pipe_hop;
  int32_t at(int32_t op, int32_t cand) const { return cand_offsets[op] + cand; }
};

// Reusable scratch so the annealing loop does no allocation churn.
struct SimScratch {
  std::vector<MTask> tasks;
  std::vector<int32_t> deps;
  std::vector<int32_t> res;
  std::vector<int32_t> fwd_task, bwd_task;
  std::vector<int32_t> sync_tasks;
  std::vector<int32_t> tmp_deps;
  // per-(op) forward stage-task ids for expanded pipelines, row-major
  // (m * S + k); indexed via pipe_rows_off[op]
  std::vector<int32_t> pipe_rows;
  std::vector<int32_t> pipe_rows_off;
  int32_t next_res = 0;

  void reset(int32_t n_ops, int32_t n_dev) {
    tasks.clear();
    deps.clear();
    res.clear();
    sync_tasks.clear();
    pipe_rows.clear();
    pipe_rows_off.assign(n_ops, -1);
    fwd_task.assign(n_ops, -1);
    bwd_task.assign(n_ops, -1);
    next_res = 2 + n_dev;
  }

  int32_t add(double duration, int32_t resource,
              const std::vector<int32_t> &dep_list) {
    MTask t;
    t.duration = duration;
    t.first_res = static_cast<int32_t>(res.size());
    t.n_res = 1;
    res.push_back(resource);
    t.first_dep = static_cast<int32_t>(deps.size());
    t.n_deps = static_cast<int32_t>(dep_list.size());
    deps.insert(deps.end(), dep_list.begin(), dep_list.end());
    tasks.push_back(t);
    return static_cast<int32_t>(tasks.size()) - 1;
  }

  int32_t add_multi(double duration, const std::vector<int32_t> &resources,
                    const std::vector<int32_t> &dep_list) {
    MTask t;
    t.duration = duration;
    t.first_res = static_cast<int32_t>(res.size());
    t.n_res = static_cast<int32_t>(resources.size());
    res.insert(res.end(), resources.begin(), resources.end());
    t.first_dep = static_cast<int32_t>(deps.size());
    t.n_deps = static_cast<int32_t>(dep_list.size());
    deps.insert(deps.end(), dep_list.begin(), dep_list.end());
    tasks.push_back(t);
    return static_cast<int32_t>(tasks.size()) - 1;
  }
};

// Build the training-step task graph for one candidate assignment and
// event-simulate it.  Mirrors Simulator._simulate_raw task-for-task
// (construction order matters: FIFO tie-breaking keys on insertion).
double simulate_assignment(const Graph &g, const Costs &c,
                           const int32_t *assign, bool overlap,
                           double hbm_capacity, double time_scale,
                           double step_overhead, SimScratch &s) {
  if (g.n_ops == 0) return 0.0;
  s.reset(g.n_ops, g.n_dev);
  double total_mem = 0.0;

  // SPMD ops occupy compute + every device resource once any placed
  // candidate is active (Python res_for)
  bool any_placed = false;
  for (int32_t op = 0; op < g.n_ops; ++op) {
    int32_t k = c.at(op, assign[op]);
    if (c.place_off[k + 1] > c.place_off[k]) any_placed = true;
  }
  std::vector<int32_t> spmd_res{kCompute};
  if (any_placed)
    for (int32_t d = 0; d < g.n_dev; ++d) spmd_res.push_back(2 + d);
  std::vector<int32_t> placed_res;

  auto res_for = [&](int32_t k) -> const std::vector<int32_t> & {
    int32_t p0 = c.place_off[k], p1 = c.place_off[k + 1];
    if (p1 > p0) {
      placed_res.clear();
      for (int32_t p = p0; p < p1; ++p)
        placed_res.push_back(2 + c.place_ids[p]);
      return placed_res;
    }
    return spmd_res;
  };

  // ---- forward chain ----
  for (int32_t op = 0; op < g.n_ops; ++op) {
    int32_t k = c.at(op, assign[op]);
    s.tmp_deps.clear();
    for (int32_t e = g.in_ptr[op]; e < g.in_ptr[op + 1]; ++e)
      s.tmp_deps.push_back(s.fwd_task[g.in_idx[e]]);

    int32_t S = c.pipe_stages[k];
    if (S > 1) {
      // GPipe expansion (Python _expand_pipeline_fwd): stage k of op is
      // its own resource; one hop between stages; zero-duration join
      int32_t M = c.pipe_mb[k];
      double tf = c.pipe_fwd_stage[k], hop = c.pipe_hop[k];
      int32_t stage_base = s.next_res;
      s.next_res += S;
      int32_t join_f = s.next_res++;  // join resources (unique)
      s.pipe_rows_off[op] = static_cast<int32_t>(s.pipe_rows.size());
      std::vector<int32_t> ext = s.tmp_deps;
      std::vector<int32_t> dl;
      for (int32_t m = 0; m < M; ++m) {
        int32_t prev = -1;
        for (int32_t st = 0; st < S; ++st) {
          dl.clear();
          if (st == 0) dl = ext;
          if (prev >= 0) {
            if (hop > 0) {
              dl.push_back(s.add(hop, kComm, {prev}));
            } else {
              dl.push_back(prev);
            }
          }
          prev = s.add(tf, stage_base + st, dl);
          s.pipe_rows.push_back(prev);
        }
      }
      dl.clear();
      for (int32_t m = 0; m < M; ++m)
        dl.push_back(s.pipe_rows[s.pipe_rows_off[op] + m * S + S - 1]);
      s.fwd_task[op] = s.add(0.0, join_f, dl);
    } else {
      if (c.fwd_comm[k] > 0) {
        int32_t comm = s.add(c.fwd_comm[k], kComm, s.tmp_deps);
        s.tmp_deps.push_back(comm);
      }
      s.fwd_task[op] = s.add_multi(c.fwd[k], res_for(k), s.tmp_deps);
    }
    total_mem += c.mem[k];
  }

  // ---- backward chain (reverse graph) ----
  const int32_t last_fwd = s.fwd_task[g.n_ops - 1];
  for (int32_t op = g.n_ops - 1; op >= 0; --op) {
    int32_t k = c.at(op, assign[op]);
    s.tmp_deps.clear();
    for (int32_t e = g.out_ptr[op]; e < g.out_ptr[op + 1]; ++e) {
      int32_t cons = g.out_idx[e];
      if (s.bwd_task[cons] >= 0) s.tmp_deps.push_back(s.bwd_task[cons]);
    }
    if (s.tmp_deps.empty()) s.tmp_deps.push_back(last_fwd);

    int32_t S = c.pipe_stages[k];
    if (S > 1) {
      // Python _expand_pipeline_bwd: stage S-1..0 per microbatch, each
      // tick also depends on that microbatch's forward at the stage
      int32_t M = c.pipe_mb[k];
      double tb = c.pipe_bwd_stage[k], hop = c.pipe_hop[k];
      // stage resources were allocated in the forward pass in op order;
      // recover them from the first fwd stage task of this op
      int32_t row0 = s.pipe_rows_off[op];
      int32_t stage_base = s.res[s.tasks[s.pipe_rows[row0]].first_res];
      int32_t join_b = s.next_res++;
      std::vector<int32_t> ext = s.tmp_deps;
      std::vector<int32_t> dl, exits;
      for (int32_t m = 0; m < M; ++m) {
        int32_t prev = -1;
        for (int32_t st = S - 1; st >= 0; --st) {
          dl.clear();
          if (st == S - 1) dl = ext;
          dl.push_back(s.pipe_rows[row0 + m * S + st]);
          if (prev >= 0) {
            if (hop > 0) {
              dl.push_back(s.add(hop, kComm, {prev}));
            } else {
              dl.push_back(prev);
            }
          }
          prev = s.add(tb, stage_base + st, dl);
        }
        exits.push_back(prev);
      }
      s.bwd_task[op] = s.add(0.0, join_b, exits);
    } else {
      if (c.bwd_comm[k] > 0) {
        int32_t comm = s.add(c.bwd_comm[k], kComm, s.tmp_deps);
        s.tmp_deps.push_back(comm);
      }
      s.bwd_task[op] = s.add_multi(c.bwd[k], res_for(k), s.tmp_deps);
    }
    if (c.sync[k] > 0) {
      s.tmp_deps.clear();
      s.tmp_deps.push_back(s.bwd_task[op]);
      s.sync_tasks.push_back(s.add(c.sync[k], kComm, s.tmp_deps));
    }
  }

  if (!overlap && !s.sync_tasks.empty()) {
    // serialize syncs after all backward work: each sync additionally
    // depends on the first op's bwd, the last one computed (mirrors the
    // Python st.deps.append(last_bwd))
    for (int32_t st : s.sync_tasks) {
      int32_t own_bwd = s.deps[s.tasks[st].first_dep];
      s.tasks[st].first_dep = static_cast<int32_t>(s.deps.size());
      s.tasks[st].n_deps = 2;
      s.deps.push_back(own_bwd);
      s.deps.push_back(s.bwd_task[0]);
    }
  }

  double makespan = fftpu::simulate_multi(s.tasks, s.res, s.deps);
  double over = total_mem - hbm_capacity;
  double penalty = over > 0 ? over * 1e-9 : 0.0;
  return makespan * time_scale + penalty + step_overhead;
}

}  // namespace

extern "C" double ffsearch_simulate_assignment(
    int32_t n_ops, const int32_t *cand_offsets, const double *cost_fwd,
    const double *cost_bwd, const double *cost_fwd_comm,
    const double *cost_bwd_comm, const double *cost_sync,
    const double *cost_mem, const int32_t *place_off,
    const int32_t *place_ids, const int32_t *pipe_stages,
    const int32_t *pipe_mb, const double *pipe_fwd_stage,
    const double *pipe_bwd_stage, const double *pipe_hop, int32_t n_dev,
    int32_t n_edges, const int32_t *edge_src, const int32_t *edge_dst,
    int32_t overlap_backward_sync, double hbm_capacity, double time_scale,
    double step_overhead, const int32_t *assignment) {
  Graph g = build_graph(n_ops, n_dev, n_edges, edge_src, edge_dst);
  Costs c{cand_offsets, cost_fwd,   cost_bwd,      cost_fwd_comm,
          cost_bwd_comm, cost_sync, cost_mem,      place_off,
          place_ids,     pipe_stages, pipe_mb,     pipe_fwd_stage,
          pipe_bwd_stage, pipe_hop};
  SimScratch s;
  return simulate_assignment(g, c, assignment, overlap_backward_sync != 0,
                             hbm_capacity, time_scale, step_overhead, s);
}

extern "C" double ffsearch_mcmc(
    int32_t n_ops, const int32_t *n_cands, const int32_t *cand_offsets,
    const double *cost_fwd, const double *cost_bwd,
    const double *cost_fwd_comm, const double *cost_bwd_comm,
    const double *cost_sync, const double *cost_mem,
    const int32_t *place_off, const int32_t *place_ids,
    const int32_t *pipe_stages, const int32_t *pipe_mb,
    const double *pipe_fwd_stage, const double *pipe_bwd_stage,
    const double *pipe_hop, int32_t n_dev, int32_t n_edges,
    const int32_t *edge_src, const int32_t *edge_dst,
    const int32_t *prop_offsets, const int32_t *prop_match, int32_t budget,
    double alpha, uint64_t seed, int32_t enable_propagation,
    int32_t overlap_backward_sync, double hbm_capacity, double time_scale,
    double step_overhead, const int32_t *init_cand, int32_t *best_out) {
  Graph g = build_graph(n_ops, n_dev, n_edges, edge_src, edge_dst);
  Costs c{cand_offsets, cost_fwd,   cost_bwd,      cost_fwd_comm,
          cost_bwd_comm, cost_sync, cost_mem,      place_off,
          place_ids,     pipe_stages, pipe_mb,     pipe_fwd_stage,
          pipe_bwd_stage, pipe_hop};
  SimScratch s;
  const bool overlap = overlap_backward_sync != 0;

  std::vector<int32_t> current(init_cand, init_cand + n_ops);
  std::vector<int32_t> best = current;
  std::vector<int32_t> searchable;
  for (int32_t i = 0; i < n_ops; ++i)
    if (n_cands[i] > 1) searchable.push_back(i);

  double cur_cost = simulate_assignment(g, c, current.data(), overlap,
                                        hbm_capacity, time_scale,
                                        step_overhead, s);
  double best_cost = cur_cost;
  if (searchable.empty() || budget <= 0) {
    std::copy(best.begin(), best.end(), best_out);
    return best_cost;
  }

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  const int32_t reset_every = std::max(1, budget / 100);

  for (int32_t it = 0; it < budget; ++it) {
    if (it > 0 && it % reset_every == 0 && cur_cost > best_cost) {
      current = best;
      cur_cost = best_cost;
    }

    // one local move: remember (op, old candidate) so reject is O(1)
    int32_t moved_op, old_cand;
    if (enable_propagation && n_edges > 0 && uni(rng) < 0.25) {
      int32_t e = static_cast<int32_t>(rng() % static_cast<uint64_t>(n_edges));
      int32_t src = edge_src[e], dst = edge_dst[e];
      int32_t match = prop_match[prop_offsets[e] + current[src]];
      if (match >= 0) {
        moved_op = dst;
      } else {  // fall back to a random rewrite (reference does the same)
        moved_op = searchable[rng() % searchable.size()];
        match = static_cast<int32_t>(rng() % n_cands[moved_op]);
      }
      old_cand = current[moved_op];
      current[moved_op] = match;
    } else {
      moved_op = searchable[rng() % searchable.size()];
      old_cand = current[moved_op];
      current[moved_op] = static_cast<int32_t>(rng() % n_cands[moved_op]);
    }

    double nxt_cost = simulate_assignment(g, c, current.data(), overlap,
                                          hbm_capacity, time_scale,
                                          step_overhead, s);
    double delta = nxt_cost - cur_cost;
    double temp = std::max(1e-12, alpha * cur_cost);
    if (delta <= 0 || uni(rng) < std::exp(-delta / temp)) {
      cur_cost = nxt_cost;
      if (cur_cost < best_cost) {
        best_cost = cur_cost;
        best = current;
      }
    } else {
      current[moved_op] = old_cand;  // reject
    }
  }

  std::copy(best.begin(), best.end(), best_out);
  return best_cost;
}
