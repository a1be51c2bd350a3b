// Bounded lock-free MPMC queue (Vyukov sequence-counter design).
//
// Host runtime replacement for the capabilities of the reference's
// Michael–Scott queue with packed external/internal reference counting
// (lib/concurrency/queue/include/queue_lockfree.hpp:63-191). A bounded
// ticket/sequence queue needs no reclamation scheme at all — slots are
// reused in place — which removes the entire packed-refcount machinery the
// reference spends 584 lines on, at the cost of a fixed capacity (fine for
// a work-queue whose depth is bounded by outstanding tasks).
#pragma once

#include <atomic>
#include <cstddef>
#include <optional>
#include <vector>

namespace hpc_host {

template <typename T>
class MpmcQueue {
 public:
  explicit MpmcQueue(std::size_t capacity_pow2 = 1024)
      : mask_(round_pow2(capacity_pow2) - 1),
        slots_(mask_ + 1) {
    for (std::size_t i = 0; i <= mask_; ++i)
      slots_[i].seq.store(i, std::memory_order_relaxed);
  }

  bool try_push(T v) {
    std::size_t pos = tail_.load(std::memory_order_relaxed);
    for (;;) {
      Slot& s = slots_[pos & mask_];
      std::size_t seq = s.seq.load(std::memory_order_acquire);
      std::intptr_t diff = (std::intptr_t)seq - (std::intptr_t)pos;
      if (diff == 0) {
        if (tail_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed))
          {
            s.value = std::move(v);
            s.seq.store(pos + 1, std::memory_order_release);
            return true;
          }
      } else if (diff < 0) {
        return false;  // full
      } else {
        pos = tail_.load(std::memory_order_relaxed);
      }
    }
  }

  std::optional<T> try_pop() {
    std::size_t pos = head_.load(std::memory_order_relaxed);
    for (;;) {
      Slot& s = slots_[pos & mask_];
      std::size_t seq = s.seq.load(std::memory_order_acquire);
      std::intptr_t diff = (std::intptr_t)seq - (std::intptr_t)(pos + 1);
      if (diff == 0) {
        if (head_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed)) {
          T out = std::move(s.value);
          s.seq.store(pos + mask_ + 1, std::memory_order_release);
          return out;
        }
      } else if (diff < 0) {
        return std::nullopt;  // empty
      } else {
        pos = head_.load(std::memory_order_relaxed);
      }
    }
  }

  bool empty() const {
    return head_.load(std::memory_order_acquire) >=
           tail_.load(std::memory_order_acquire);
  }

 private:
  struct Slot {
    std::atomic<std::size_t> seq;
    T value;
  };
  static std::size_t round_pow2(std::size_t v) {
    std::size_t p = 1;
    while (p < v) p <<= 1;
    return p;
  }

  std::size_t mask_;
  std::vector<Slot> slots_;
  alignas(64) std::atomic<std::size_t> head_{0};
  alignas(64) std::atomic<std::size_t> tail_{0};
};

}  // namespace hpc_host
