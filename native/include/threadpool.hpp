// Fixed-size thread pool over the unbounded lock-free MPMC queue.
//
// Host runtime replacement for the capabilities of the reference's
// singleton pool (lib/concurrency/thread_pool/include/ThreadPool.hpp:25-43):
// same commit-a-callable / drain-on-stop semantics, but the mutex+cv queue
// becomes the hazard-pointer Michael-Scott queue (uqueue.hpp — unbounded,
// like the reference's refcounted ConcurrentQueue, so commit never blocks
// on queue depth) with a condvar only for
// sleep/wake. parallel_for replaces OpenMP '#pragma omp parallel for' as
// the host-side data-parallel primitive (used by the MatrixMarket parser).
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <future>
#include <mutex>
#include <thread>
#include <vector>

#include "uqueue.hpp"

namespace hpc_host {

class ThreadPool {
 public:
  explicit ThreadPool(int n_threads = 0) {
    if (n_threads <= 0)
      n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { worker_loop(); });
  }
  ~ThreadPool() { stop(); }

  int size() const { return (int)workers_.size(); }

  template <typename F>
  std::future<void> commit(F&& f) {
    auto task = std::make_shared<std::packaged_task<void()>>(
        std::forward<F>(f));
    auto fut = task->get_future();
    queue_.push([task] { (*task)(); });  // unbounded: never blocks
    wake_one();
    return fut;
  }

  // blocking parallel-for over [0, n) in chunks (OpenMP replacement)
  void parallel_for(std::int64_t n,
                    const std::function<void(std::int64_t, std::int64_t)>& fn,
                    std::int64_t min_chunk = 1024) {
    if (n <= 0) return;
    int nt = size();
    std::int64_t chunk = std::max(min_chunk, (n + nt - 1) / nt);
    std::vector<std::future<void>> futs;
    for (std::int64_t b = 0; b < n; b += chunk) {
      std::int64_t e = std::min(n, b + chunk);
      futs.push_back(commit([=] { fn(b, e); }));
    }
    for (auto& f : futs) f.get();
  }

  void stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) return;
    wake_all();
    for (auto& w : workers_)
      if (w.joinable()) w.join();
    // drain remaining tasks on the caller (the reference drains on stop,
    // ThreadPool.cpp:29-40)
    while (auto t = queue_.try_pop()) (*t)();
  }

 private:
  void worker_loop() {
    while (true) {
      if (auto t = queue_.try_pop()) {
        (*t)();
        continue;
      }
      if (stopping_.load(std::memory_order_acquire)) return;
      std::unique_lock<std::mutex> lk(sleep_mtx_);
      sleep_cv_.wait_for(lk, std::chrono::milliseconds(1), [this] {
        return stopping_.load(std::memory_order_acquire) || !queue_.empty();
      });
    }
  }
  void wake_one() { sleep_cv_.notify_one(); }
  void wake_all() { sleep_cv_.notify_all(); }

  UnboundedQueue<std::function<void()>> queue_;
  std::vector<std::thread> workers_;
  std::atomic<bool> stopping_{false};
  std::mutex sleep_mtx_;
  std::condition_variable sleep_cv_;
};

}  // namespace hpc_host
