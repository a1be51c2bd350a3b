// Hand-over-hand (lock-coupling) concurrent linked list.
//
// Host runtime parity for the reference's LinkListLK
// (lib/concurrency/linklist/include/linklist_lk.hpp:14-135, SURVEY.md
// §2.17): per-node mutex, traversal locks at most two nodes at a time.
#pragma once

#include <functional>
#include <memory>
#include <mutex>
#include <optional>
#include <utility>

namespace hpc_host {

template <typename T>
class LinkedList {
  struct Node {
    std::mutex m;
    std::optional<T> value;          // empty for the head sentinel
    std::unique_ptr<Node> next;
  };

 public:
  LinkedList() = default;
  LinkedList(const LinkedList&) = delete;
  LinkedList& operator=(const LinkedList&) = delete;

  void push_front(T v) {
    auto node = std::make_unique<Node>();
    node->value = std::move(v);
    std::lock_guard<std::mutex> lk(head_.m);
    node->next = std::move(head_.next);
    head_.next = std::move(node);
  }

  template <typename Pred>
  std::size_t remove_if(Pred pred) {
    std::size_t removed = 0;
    Node* cur = &head_;
    std::unique_lock<std::mutex> lk(head_.m);
    while (Node* next = cur->next.get()) {
      std::unique_lock<std::mutex> next_lk(next->m);
      if (pred(*next->value)) {
        auto owned = std::move(cur->next);
        cur->next = std::move(next->next);
        next_lk.unlock();   // node now unreachable; safe to drop
        ++removed;
      } else {
        lk.unlock();
        cur = next;
        lk = std::move(next_lk);
      }
    }
    return removed;
  }

  template <typename Fn>
  void for_each(Fn fn) {
    Node* cur = &head_;
    std::unique_lock<std::mutex> lk(head_.m);
    while (Node* next = cur->next.get()) {
      std::unique_lock<std::mutex> next_lk(next->m);
      lk.unlock();
      fn(*next->value);
      cur = next;
      lk = std::move(next_lk);
    }
  }

  template <typename Pred>
  std::optional<T> find_first_if(Pred pred) {
    Node* cur = &head_;
    std::unique_lock<std::mutex> lk(head_.m);
    while (Node* next = cur->next.get()) {
      std::unique_lock<std::mutex> next_lk(next->m);
      lk.unlock();
      if (pred(*next->value)) return *next->value;
      cur = next;
      lk = std::move(next_lk);
    }
    return std::nullopt;
  }

  std::size_t size() {
    std::size_t n = 0;
    for_each([&](const T&) { ++n; });
    return n;
  }

 private:
  Node head_;  // sentinel
};

}  // namespace hpc_host
