// Native event-driven task-graph simulator.
//
// The hot loop of strategy search: the MCMC walk calls simulate()
// thousands of times per search (reference: Simulator::simulate_runtime,
// src/runtime/simulator.cc:330-629, driven from FFModel::optimize).
// Semantics match flexflow_tpu_torch/search/simulator.py TaskGraph.simulate
// exactly: min-heap keyed on (ready_time, insertion counter), each task
// serializing on its resource's free time.

#include "sim_core.h"
#include "flexflow_torch_c.h"

#include <algorithm>
#include <queue>
#include <tuple>

namespace fftpu {

namespace {
struct HeapEntry {
  double ready;
  int64_t counter;
  int32_t task;
  bool operator>(const HeapEntry &o) const {
    if (ready != o.ready) return ready > o.ready;
    return counter > o.counter;
  }
};
}  // namespace

double simulate(const std::vector<Task> &tasks,
                const std::vector<int32_t> &dep_indices) {
  const int32_t n = static_cast<int32_t>(tasks.size());
  std::vector<int32_t> unresolved(n, 0);
  std::vector<double> ready_time(n, 0.0);

  // children CSR (built per call; graphs are small — O(5 * n_ops))
  std::vector<int32_t> child_count(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t d = 0; d < tasks[i].n_deps; ++d) {
      int32_t dep = dep_indices[tasks[i].first_dep + d];
      ++child_count[dep];
      ++unresolved[i];
    }
  }
  std::vector<int32_t> child_ptr(n + 1, 0);
  for (int32_t i = 0; i < n; ++i) child_ptr[i + 1] = child_ptr[i] + child_count[i];
  std::vector<int32_t> children(child_ptr[n]);
  {
    std::vector<int32_t> cur(child_ptr.begin(), child_ptr.end() - 1);
    for (int32_t i = 0; i < n; ++i)
      for (int32_t d = 0; d < tasks[i].n_deps; ++d) {
        int32_t dep = dep_indices[tasks[i].first_dep + d];
        children[cur[dep]++] = i;
      }
  }

  int32_t max_res = 0;
  for (const auto &t : tasks) max_res = std::max(max_res, t.resource);
  std::vector<double> free_at(max_res + 1, 0.0);

  std::priority_queue<HeapEntry, std::vector<HeapEntry>, std::greater<HeapEntry>> q;
  int64_t counter = 0;
  for (int32_t i = 0; i < n; ++i)
    if (unresolved[i] == 0) q.push({0.0, counter++, i});

  double makespan = 0.0;
  int32_t done = 0;
  while (!q.empty()) {
    HeapEntry e = q.top();
    q.pop();
    const Task &t = tasks[e.task];
    double start = std::max(e.ready, free_at[t.resource]);
    double finish = start + t.duration;
    free_at[t.resource] = finish;
    makespan = std::max(makespan, finish);
    ++done;
    for (int32_t c = child_ptr[e.task]; c < child_ptr[e.task + 1]; ++c) {
      int32_t ci = children[c];
      ready_time[ci] = std::max(ready_time[ci], finish);
      if (--unresolved[ci] == 0) q.push({ready_time[ci], counter++, ci});
    }
  }
  // done < n means a dependency cycle; report -1 so callers can assert.
  return done == n ? makespan : -1.0;
}

double simulate_multi(const std::vector<MTask> &tasks,
                      const std::vector<int32_t> &res_indices,
                      const std::vector<int32_t> &dep_indices) {
  const int32_t n = static_cast<int32_t>(tasks.size());
  std::vector<int32_t> unresolved(n, 0);
  std::vector<double> ready_time(n, 0.0);

  std::vector<int32_t> child_count(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t d = 0; d < tasks[i].n_deps; ++d) {
      int32_t dep = dep_indices[tasks[i].first_dep + d];
      ++child_count[dep];
      ++unresolved[i];
    }
  }
  std::vector<int32_t> child_ptr(n + 1, 0);
  for (int32_t i = 0; i < n; ++i)
    child_ptr[i + 1] = child_ptr[i] + child_count[i];
  std::vector<int32_t> children(child_ptr[n]);
  {
    std::vector<int32_t> cur(child_ptr.begin(), child_ptr.end() - 1);
    for (int32_t i = 0; i < n; ++i)
      for (int32_t d = 0; d < tasks[i].n_deps; ++d) {
        int32_t dep = dep_indices[tasks[i].first_dep + d];
        children[cur[dep]++] = i;
      }
  }

  int32_t max_res = 0;
  for (const auto &t : tasks)
    for (int32_t r = 0; r < t.n_res; ++r)
      max_res = std::max(max_res, res_indices[t.first_res + r]);
  std::vector<double> free_at(max_res + 1, 0.0);

  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>> q;
  int64_t counter = 0;
  for (int32_t i = 0; i < n; ++i)
    if (unresolved[i] == 0) q.push({0.0, counter++, i});

  double makespan = 0.0;
  int32_t done = 0;
  while (!q.empty()) {
    HeapEntry e = q.top();
    q.pop();
    const MTask &t = tasks[e.task];
    double start = e.ready;
    for (int32_t r = 0; r < t.n_res; ++r)
      start = std::max(start, free_at[res_indices[t.first_res + r]]);
    double finish = start + t.duration;
    for (int32_t r = 0; r < t.n_res; ++r)
      free_at[res_indices[t.first_res + r]] = finish;
    makespan = std::max(makespan, finish);
    ++done;
    for (int32_t c = child_ptr[e.task]; c < child_ptr[e.task + 1]; ++c) {
      int32_t ci = children[c];
      ready_time[ci] = std::max(ready_time[ci], finish);
      if (--unresolved[ci] == 0) q.push({ready_time[ci], counter++, ci});
    }
  }
  return done == n ? makespan : -1.0;
}

}  // namespace fftpu

extern "C" double ffsim_simulate(int32_t n_tasks, const double *durations,
                                 const int32_t *resources,
                                 const int32_t *dep_indptr,
                                 const int32_t *dep_indices) {
  std::vector<fftpu::Task> tasks(n_tasks);
  for (int32_t i = 0; i < n_tasks; ++i) {
    tasks[i].duration = durations[i];
    tasks[i].resource = resources[i];
    tasks[i].first_dep = dep_indptr[i];
    tasks[i].n_deps = dep_indptr[i + 1] - dep_indptr[i];
  }
  std::vector<int32_t> deps(dep_indices, dep_indices + dep_indptr[n_tasks]);
  return fftpu::simulate(tasks, deps);
}

extern "C" const char *flexflow_torch_native_version(void) {
  return "flexflow-torch-native 0.1";
}
