// Unbounded lock-free MPMC queue (Michael–Scott) with hazard-pointer
// reclamation.
//
// Capability parity with the reference's unbounded ConcurrentQueue
// (lib/concurrency/queue/include/queue_lockfree.hpp:63-191), which grows
// without bound via packed external/internal reference counts. This is a
// different reclamation design on the same algorithm skeleton: nodes are
// protected with hazard pointers from the shared HazardDomain and retired
// after the head swing — no per-node counter RMWs on the hot path. Fixes
// ThreadPool-style producers no longer spin on a
// full bounded ring (mpmc_queue.hpp stays as the bounded/slot-reusing
// fast path; this queue is the unbounded one).
//
// Invariants (dummy-head scheme):
//   * head_ always points at a dummy; the value of the logical front
//     element lives in head_->next.
//   * a node's payload pointer is consumed exactly once, by the popper
//     that swings head_ onto it.
//   * validation rule for touching node->next / node->data: the node is
//     published in a hazard slot AND head_ (or tail_) still equals the
//     value read before publishing — a retired node can never pass it.
#pragma once

#include <atomic>
#include <optional>
#include <utility>

#include "hazard.hpp"

namespace hpc_host {

template <typename T>
class UnboundedQueue {
  struct Node {
    std::atomic<T*> data{nullptr};
    std::atomic<Node*> next{nullptr};
  };
  static void deleter(void* p) { delete static_cast<Node*>(p); }

 public:
  UnboundedQueue() {
    Node* dummy = new Node;
    head_.store(dummy, std::memory_order_relaxed);
    tail_.store(dummy, std::memory_order_relaxed);
  }
  ~UnboundedQueue() {
    Node* n = head_.load(std::memory_order_relaxed);
    while (n) {
      Node* nx = n->next.load(std::memory_order_relaxed);
      delete n->data.load(std::memory_order_relaxed);
      delete n;
      n = nx;
    }
  }
  UnboundedQueue(const UnboundedQueue&) = delete;
  UnboundedQueue& operator=(const UnboundedQueue&) = delete;

  void push(T v) {
    T* val = new T(std::move(v));
    Node* node = new Node;
    node->data.store(val, std::memory_order_relaxed);
    HazardGuard hp;
    for (;;) {
      Node* t = hp.protect(tail_);
      Node* next = t->next.load(std::memory_order_acquire);
      if (t != tail_.load(std::memory_order_acquire)) continue;
      if (next != nullptr) {  // tail lagging: help swing it
        tail_.compare_exchange_strong(t, next, std::memory_order_release,
                                      std::memory_order_relaxed);
        continue;
      }
      Node* expected = nullptr;
      if (t->next.compare_exchange_strong(expected, node,
                                          std::memory_order_release,
                                          std::memory_order_relaxed)) {
        tail_.compare_exchange_strong(t, node, std::memory_order_release,
                                      std::memory_order_relaxed);
        return;
      }
    }
  }

  std::optional<T> try_pop() {
    HazardGuard hp_h, hp_n;
    for (;;) {
      Node* h = hp_h.protect(head_);
      Node* next = h->next.load(std::memory_order_acquire);
      if (h != head_.load(std::memory_order_acquire)) continue;
      if (next == nullptr) return std::nullopt;  // empty
      hp_n.set(next);
      // revalidate: while head_ == h, h is not retired and next (ahead of
      // the head) cannot have been retired either — both now safe
      if (h != head_.load(std::memory_order_seq_cst)) continue;
      Node* t = tail_.load(std::memory_order_acquire);
      if (h == t) {  // tail lagging behind a completed push: help
        tail_.compare_exchange_strong(t, next, std::memory_order_release,
                                      std::memory_order_relaxed);
        continue;
      }
      T* val = next->data.load(std::memory_order_acquire);
      if (head_.compare_exchange_strong(h, next, std::memory_order_acq_rel,
                                        std::memory_order_relaxed)) {
        // we own the payload; next is the new dummy
        next->data.store(nullptr, std::memory_order_relaxed);
        T out = std::move(*val);
        delete val;
        hp_h.clear();
        hp_n.clear();
        HazardDomain::instance().retire(h, &deleter);
        return out;
      }
    }
  }

  bool empty() const {
    HazardGuard hp;
    Node* h = hp.protect(head_);
    return h->next.load(std::memory_order_acquire) == nullptr;
  }

 private:
  alignas(64) std::atomic<Node*> head_;
  alignas(64) std::atomic<Node*> tail_;
};

}  // namespace hpc_host
