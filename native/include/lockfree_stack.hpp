// Lock-free stack with packed split reference counting.
//
// Host runtime parity for the reference's reclamation-safe stacks
// (lib/concurrency/stack: hazard-pointer and split-ref-count variants,
// SURVEY.md §2.15). This is the split-reference-count design with the
// reference's packing trick (atomic_reference_node.hpp:55-155): a 48-bit
// pointer and a 16-bit external visit count share one 64-bit atomic, so a
// single CAS updates both — no double-width CAS needed on x86-64/arm64.
//
// Reclamation invariant: a popped node is deleted when the threads that
// saw it (external count) have all released it (internal count cancels).
#pragma once

#include <atomic>
#include <cstdint>
#include <optional>
#include <utility>

namespace hpc_host {

template <typename T>
class LockFreeStack {
  struct Node {
    T value;
    std::uint64_t next;               // packed (ptr, count) of next node
    std::atomic<int> internal{0};     // released-visitor count (negative)
    explicit Node(T v) : value(std::move(v)), next(0) {}
  };

  static constexpr int kCountBits = 16;
  static constexpr std::uint64_t kPtrMask =
      (~std::uint64_t{0}) >> kCountBits;

  static Node* ptr_of(std::uint64_t packed) {
    // sign-extend bit 47 (canonical-form user pointers on x86-64/arm64)
    std::int64_t p = (std::int64_t)(packed << kCountBits) >> kCountBits;
    return reinterpret_cast<Node*>(p);
  }
  static int count_of(std::uint64_t packed) {
    return (int)(packed >> (64 - kCountBits));
  }
  static std::uint64_t pack(Node* p, int count) {
    return (reinterpret_cast<std::uint64_t>(p) & kPtrMask) |
           ((std::uint64_t)(std::uint16_t)count << (64 - kCountBits));
  }

 public:
  LockFreeStack() : head_(0) {}
  ~LockFreeStack() {
    std::uint64_t h = head_.load(std::memory_order_relaxed);
    Node* n = ptr_of(h);
    while (n) {
      Node* nx = ptr_of(n->next);
      delete n;
      n = nx;
    }
  }
  LockFreeStack(const LockFreeStack&) = delete;
  LockFreeStack& operator=(const LockFreeStack&) = delete;

  void push(T v) {
    Node* node = new Node(std::move(v));
    std::uint64_t h = head_.load(std::memory_order_relaxed);
    do {
      // store the FULL counted pointer: the old head's accumulated visit
      // count must survive in the link, or its visitors' internal
      // decrements can never cancel and the node leaks (LSan-verified)
      node->next = h;
    } while (!head_.compare_exchange_weak(h, pack(node, 1),
                                          std::memory_order_release,
                                          std::memory_order_relaxed));
  }

  std::optional<T> pop() {
    std::uint64_t h = increase_head_count();
    for (;;) {
      Node* node = ptr_of(h);
      if (!node) return std::nullopt;
      std::uint64_t next = node->next;
      // try to unlink `node`: install next AS STORED (counted pointer),
      // preserving the successor's accumulated external count
      if (head_.compare_exchange_strong(h, next,
                                        std::memory_order_acquire,
                                        std::memory_order_relaxed)) {
        T out = std::move(node->value);
        // we removed it: reconcile counts. external visitors besides us:
        int external = count_of(h) - 2;  // minus our visit and the link ref
        if (node->internal.fetch_add(external,
                                     std::memory_order_acq_rel) ==
            -external) {
          delete node;
        }
        return out;
      }
      // lost the race: release our visit on the node we saw
      if (node->internal.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        delete node;
      }
      h = increase_head_count();
    }
  }

  bool empty() const {
    return ptr_of(head_.load(std::memory_order_acquire)) == nullptr;
  }

 private:
  std::uint64_t increase_head_count() {
    std::uint64_t h = head_.load(std::memory_order_relaxed);
    std::uint64_t nh;
    do {
      if (!ptr_of(h)) return h;
      nh = pack(ptr_of(h), count_of(h) + 1);
    } while (!head_.compare_exchange_weak(h, nh, std::memory_order_acquire,
                                          std::memory_order_relaxed));
    return nh;
  }

  alignas(64) std::atomic<std::uint64_t> head_;
};

}  // namespace hpc_host
