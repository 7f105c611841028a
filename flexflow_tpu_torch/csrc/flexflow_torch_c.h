/* flexflow_torch_c.h — flat C API over the port's native library, the
 * counterpart of flexflow_tpu/csrc/flexflow_tpu_c.h.
 *
 *   - ffsim_*    event-driven task-graph simulator
 *                (analog of src/runtime/simulator.cc:330-629)
 *   - ffsearch_* MCMC strategy-search annealing loop
 *                (analog of FFModel::optimize, src/runtime/model.cc:1905-1968)
 *   - ffdl_*     prefetching batch gatherer for the data pipeline, and
 *                the host embedding-bag
 *
 * Python binds this header with ctypes (flexflow_tpu_torch/native/
 * __init__.py); every entry point is usable from C as well.
 */
#ifndef FLEXFLOW_TORCH_C_H
#define FLEXFLOW_TORCH_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------------- simulator ----------------
 * Tasks are given in topological-friendly order (deps may point to any
 * earlier-added or later-added task; the event loop resolves order).
 * resources[i] is an arbitrary small integer id; tasks sharing a
 * resource serialize on it.  deps are CSR: task i depends on tasks
 * dep_indices[dep_indptr[i] .. dep_indptr[i+1]).
 * Returns the makespan (same units as durations). */
double ffsim_simulate(int32_t n_tasks,
                      const double *durations,
                      const int32_t *resources,
                      const int32_t *dep_indptr,
                      const int32_t *dep_indices);

/* ---------------- MCMC strategy search ----------------
 * Per-op candidate costs are precomputed by the caller (the Python cost
 * model, the analog of Op::measure_operator_cost feeding the search).
 *
 * Cost arrays are flattened per (op, candidate): entry
 * cand_offsets[op] + c, for c in [0, n_cands[op]).  Components follow
 * flexflow_tpu_torch.search.cost_model.OpCost: fwd/bwd compute seconds,
 * fwd/bwd collective seconds, gradient-sync seconds, bytes resident.
 *
 * Graph edges are producer->consumer op-index pairs, in the exact
 * iteration order the Python simulator uses (duplicates allowed).
 *
 * prop_match supports the propagation move (reference model.cc:1807-1903):
 * for edge e and source-candidate i, prop_match[prop_offsets[e] + i] is
 * the destination op's candidate with the same axis map, or -1.
 *
 * Device-explicit placements (OpStrategy.device_ids): place_off is a
 * CSR indptr (len total_cands+1) into place_ids; a candidate with a
 * non-empty slice runs only on those device resources, so disjoint
 * placements proceed concurrently while SPMD candidates hold every
 * device.  n_dev is the mesh device count.
 *
 * Pipeline candidates (layer->pipe): pipe_stages[cand] > 1 expands the
 * op into the (microbatch, stage) GPipe schedule over per-stage
 * resources using pipe_mb/pipe_fwd_stage/pipe_bwd_stage/pipe_hop
 * (PipelineCost fields) — the candidate's fwd/bwd/fwd_comm/bwd_comm are
 * ignored, exactly like the Python expansion.
 *
 * init_cand[op] seeds the walk (pure data parallelism by default);
 * best_out[op] receives the best candidate found.  Returns the best
 * simulated step time in seconds (including memory penalty and the
 * calibrated per-step dispatch overhead). */
double ffsearch_mcmc(int32_t n_ops,
                     const int32_t *n_cands,
                     const int32_t *cand_offsets,
                     const double *cost_fwd,
                     const double *cost_bwd,
                     const double *cost_fwd_comm,
                     const double *cost_bwd_comm,
                     const double *cost_sync,
                     const double *cost_mem,
                     const int32_t *place_off,
                     const int32_t *place_ids,
                     const int32_t *pipe_stages,
                     const int32_t *pipe_mb,
                     const double *pipe_fwd_stage,
                     const double *pipe_bwd_stage,
                     const double *pipe_hop,
                     int32_t n_dev,
                     int32_t n_edges,
                     const int32_t *edge_src,
                     const int32_t *edge_dst,
                     const int32_t *prop_offsets,
                     const int32_t *prop_match,
                     int32_t budget,
                     double alpha,
                     uint64_t seed,
                     int32_t enable_propagation,
                     int32_t overlap_backward_sync,
                     double hbm_capacity,
                     double time_scale,
                     double step_overhead,
                     const int32_t *init_cand,
                     int32_t *best_out);

/* Simulate one fixed candidate assignment with the same task-graph
 * construction the search uses (for parity tests / re-costing). */
double ffsearch_simulate_assignment(int32_t n_ops,
                                    const int32_t *cand_offsets,
                                    const double *cost_fwd,
                                    const double *cost_bwd,
                                    const double *cost_fwd_comm,
                                    const double *cost_bwd_comm,
                                    const double *cost_sync,
                                    const double *cost_mem,
                                    const int32_t *place_off,
                                    const int32_t *place_ids,
                                    const int32_t *pipe_stages,
                                    const int32_t *pipe_mb,
                                    const double *pipe_fwd_stage,
                                    const double *pipe_bwd_stage,
                                    const double *pipe_hop,
                                    int32_t n_dev,
                                    int32_t n_edges,
                                    const int32_t *edge_src,
                                    const int32_t *edge_dst,
                                    int32_t overlap_backward_sync,
                                    double hbm_capacity,
                                    double time_scale,
                                    double step_overhead,
                                    const int32_t *assignment);

/* ---------------- data loader ----------------
 * A loader gathers rows from n_arrays host arrays (equal sample counts)
 * into per-batch contiguous buffers on a background thread,
 * double-buffered — the prefetch analog of the reference's next_batch
 * index-launched copies (flexflow_dataloader.cc:649-740). */
typedef void *ffdl_handle_t;

/* row_bytes[k] = bytes per sample of array k (product of non-batch dims
 * times itemsize; arrays must be C-contiguous). */
ffdl_handle_t ffdl_create(int32_t n_arrays,
                          const void *const *data_ptrs,
                          const int64_t *row_bytes,
                          int64_t n_samples,
                          int32_t batch_size,
                          int32_t drop_last);

/* Begin an epoch over `order` (len n_samples, caller-owned permutation;
 * copied internally).  Restarts prefetching from batch 0. */
void ffdl_start_epoch(ffdl_handle_t h, const int64_t *order);

int32_t ffdl_num_batches(ffdl_handle_t h);

/* Blocks until the next batch is gathered; fills out_ptrs[k] with the
 * internal buffer for array k (valid until the following ffdl_next_batch
 * or ffdl_destroy).  out_rows receives the row count (last batch may be
 * short when drop_last=0).  Returns the batch index, or -1 at epoch end. */
int32_t ffdl_next_batch(ffdl_handle_t h, void **out_ptrs, int32_t *out_rows);

void ffdl_destroy(ffdl_handle_t h);

/* Host-side embedding-bag (reference src/ops/embedding_avx2.cc role in
 * the data pipeline): out[b] = reduce(table[indices[b, :]]) with
 * mode 0=sum, 1=mean; negative/out-of-range indices are padding and are
 * skipped.  indices is (batch, bag_size) row-major; out is (batch, dim). */
void ffdl_embedding_bag(const float *table, int64_t num_entries,
                        int32_t dim, const int64_t *indices, int64_t batch,
                        int32_t bag_size, int32_t mode, float *out);

/* ---------------- misc ---------------- */
const char *flexflow_torch_native_version(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* FLEXFLOW_TORCH_C_H */
