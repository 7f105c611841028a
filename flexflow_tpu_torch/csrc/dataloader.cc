// Native prefetching batch gatherer.
//
// The reference SingleDataLoader keeps the whole dataset in zero-copy
// host memory and copies per-batch slices to device regions on demand
// (python/flexflow_dataloader.cc:576-740).  Here the expensive host-side
// step is the gather of shuffled rows into a contiguous batch buffer;
// this runs on a background thread, double-buffered, so the gather for
// batch i+1 overlaps the caller's staging of batch i (the port's
// DataLoaderSet copies it into a pinned buffer and queues the
// host-to-device copy on a stream of its own).

#include "flexflow_torch_c.h"

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Loader {
  // dataset
  std::vector<const char *> data;
  std::vector<int64_t> row_bytes;
  int64_t n_samples = 0;
  int32_t batch_size = 0;
  bool drop_last = true;

  // epoch state
  std::vector<int64_t> order;
  int32_t num_batches = 0;

  // double buffers: buf[slot][array]
  std::vector<std::vector<char>> buf[2];
  int32_t buf_rows[2] = {0, 0};
  int32_t buf_batch[2] = {-1, -1};  // which batch index each slot holds
  bool buf_ready[2] = {false, false};

  // producer thread
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_produced, cv_consumed;
  int32_t produce_next = 0;  // next batch index the worker will gather
  int32_t consume_next = 0;  // next batch index the caller will take
  std::atomic<bool> stop{false};
  bool epoch_active = false;
  bool gathering = false;  // worker is copying outside the lock

  void gather(int32_t batch_idx, int32_t slot) {
    int64_t start = static_cast<int64_t>(batch_idx) * batch_size;
    int64_t end = std::min<int64_t>(start + batch_size, n_samples);
    int32_t rows = static_cast<int32_t>(end - start);
    for (size_t k = 0; k < data.size(); ++k) {
      char *dst = buf[slot][k].data();
      const char *src = data[k];
      int64_t rb = row_bytes[k];
      for (int64_t r = 0; r < rows; ++r)
        std::memcpy(dst + r * rb, src + order[start + r] * rb, rb);
    }
    buf_rows[slot] = rows;
    buf_batch[slot] = batch_idx;
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    while (!stop.load()) {
      if (!epoch_active || produce_next >= num_batches ||
          buf_ready[produce_next % 2]) {
        cv_consumed.wait(lk, [&] {
          return stop.load() ||
                 (epoch_active && produce_next < num_batches &&
                  !buf_ready[produce_next % 2]);
        });
        continue;
      }
      int32_t b = produce_next;
      int32_t slot = b % 2;
      gathering = true;
      lk.unlock();
      gather(b, slot);  // heavy work outside the lock
      lk.lock();
      gathering = false;
      if (!epoch_active || produce_next != b) {
        cv_produced.notify_all();  // epoch restarted mid-gather; discard
        continue;
      }
      buf_ready[slot] = true;
      ++produce_next;
      cv_produced.notify_all();
    }
  }
};

}  // namespace

extern "C" ffdl_handle_t ffdl_create(int32_t n_arrays,
                                     const void *const *data_ptrs,
                                     const int64_t *row_bytes,
                                     int64_t n_samples, int32_t batch_size,
                                     int32_t drop_last) {
  auto *l = new Loader();
  for (int32_t k = 0; k < n_arrays; ++k) {
    l->data.push_back(static_cast<const char *>(data_ptrs[k]));
    l->row_bytes.push_back(row_bytes[k]);
  }
  l->n_samples = n_samples;
  l->batch_size = batch_size;
  l->drop_last = drop_last != 0;
  for (int s = 0; s < 2; ++s) {
    l->buf[s].resize(n_arrays);
    for (int32_t k = 0; k < n_arrays; ++k)
      l->buf[s][k].resize(static_cast<size_t>(batch_size) * row_bytes[k]);
  }
  l->worker = std::thread([l] { l->run(); });
  return l;
}

extern "C" void ffdl_start_epoch(ffdl_handle_t h, const int64_t *order) {
  auto *l = static_cast<Loader *>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  // park the worker before touching `order` (it reads order outside the
  // lock while gathering)
  l->epoch_active = false;
  l->cv_produced.wait(lk, [&] { return !l->gathering; });
  l->order.assign(order, order + l->n_samples);
  int64_t nb = l->n_samples / l->batch_size;
  if (!l->drop_last && l->n_samples % l->batch_size) ++nb;
  l->num_batches = static_cast<int32_t>(nb);
  l->produce_next = 0;
  l->consume_next = 0;
  l->buf_ready[0] = l->buf_ready[1] = false;
  l->buf_batch[0] = l->buf_batch[1] = -1;
  l->epoch_active = true;
  l->cv_consumed.notify_all();
}

extern "C" int32_t ffdl_num_batches(ffdl_handle_t h) {
  auto *l = static_cast<Loader *>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  return l->num_batches;
}

extern "C" int32_t ffdl_next_batch(ffdl_handle_t h, void **out_ptrs,
                                   int32_t *out_rows) {
  auto *l = static_cast<Loader *>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  if (!l->epoch_active || l->consume_next >= l->num_batches) return -1;
  int32_t b = l->consume_next;
  int32_t slot = b % 2;
  // release the previous batch's slot so the worker can refill it
  int32_t prev_slot = 1 - slot;
  if (l->buf_batch[prev_slot] >= 0 && l->buf_batch[prev_slot] < b) {
    l->buf_ready[prev_slot] = false;
    l->cv_consumed.notify_all();
  }
  l->cv_produced.wait(lk, [&] { return l->buf_ready[slot] &&
                                       l->buf_batch[slot] == b; });
  for (size_t k = 0; k < l->data.size(); ++k)
    out_ptrs[k] = l->buf[slot][k].data();
  *out_rows = l->buf_rows[slot];
  ++l->consume_next;
  return b;
}

extern "C" void ffdl_destroy(ffdl_handle_t h) {
  auto *l = static_cast<Loader *>(h);
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->stop.store(true);
    l->cv_consumed.notify_all();
  }
  l->worker.join();
  delete l;
}
