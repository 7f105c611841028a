// Internal shared declarations for the native simulator + search.
#ifndef FLEXFLOW_TPU_SIM_CORE_H
#define FLEXFLOW_TPU_SIM_CORE_H

#include <cstdint>
#include <vector>

namespace fftpu {

// One node of the event-simulated task graph.  Mirrors the Python
// SimTask (flexflow_tpu_torch/search/simulator.py) which itself mirrors the
// reference SimTask (include/simulator.h:238-390).
struct Task {
  double duration = 0.0;
  int32_t resource = 0;  // tasks sharing a resource id serialize
  int32_t first_dep = 0; // into TaskGraph::dep_indices
  int32_t n_deps = 0;
};

// Priority-queue event loop over contended resources — the native
// version of TaskGraph.simulate (reference simulator.cc:499-554).
// Ties on ready-time break by insertion order (FIFO), matching the
// Python heapq (ready_time, counter) key.
double simulate(const std::vector<Task> &tasks,
                const std::vector<int32_t> &dep_indices);

// Multi-resource variant: a task occupies EVERY resource in its slice
// of res_indices simultaneously (the Python TaskGraph list-resource
// convention — a placed op's device set, an SPMD op holding all
// devices, per-stage pipeline resources).
struct MTask {
  double duration = 0.0;
  int32_t first_res = 0;  // into res_indices
  int32_t n_res = 0;
  int32_t first_dep = 0;  // into dep_indices
  int32_t n_deps = 0;
};

double simulate_multi(const std::vector<MTask> &tasks,
                      const std::vector<int32_t> &res_indices,
                      const std::vector<int32_t> &dep_indices);

}  // namespace fftpu

#endif
