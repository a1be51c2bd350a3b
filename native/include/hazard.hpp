// Hazard-pointer reclamation domain (Michael's scheme).
//
// Host-runtime parity for the reference's second lock-free
// reclamation scheme (lib/concurrency/stack/include/
// stack_lockfree_hazard_based.hpp:22-148: static 128-slot hazard array,
// thread-local slot acquisition, retire-scan-reclaim). This is a fresh
// design, not a port: one process-wide domain serves every hazard-based
// structure (stack AND queue share it), slots are leased per thread as an
// RAII bitmap instead of CAS-on-thread-id, and retire lists are
// per-thread with orphan adoption so thread exit never leaks (LSan-clean
// under the selftest stress matrix).
//
// Protocol summary:
//   * HazardGuard g; T* p = g.protect(source_atomic);  -- validated
//     double-load publish: p is safe to dereference until g clears/dies.
//   * domain().retire(p, deleter) after unlinking; nodes are freed by a
//     threshold-triggered scan when no slot publishes them.
#pragma once

#include <atomic>
#include <cstddef>
#include <mutex>
#include <thread>
#include <vector>

namespace hpc_host {

class HazardDomain {
 public:
  static constexpr int kSlots = 128;       // process-wide publish slots
  static constexpr int kScanThreshold = 64;  // retired nodes per thread

  struct Retired {
    void* p;
    void (*del)(void*);
  };

  static HazardDomain& instance() {
    static HazardDomain d;
    return d;
  }

  // ---- slot leasing (called via thread-local lease below) ----------------
  int acquire_slot() {
    for (int i = 0; i < kSlots; ++i) {
      bool expect = false;
      if (owned_[i].compare_exchange_strong(expect, true,
                                            std::memory_order_acq_rel))
        return i;
    }
    return -1;  // all slots leased: caller falls back to locked protection
  }
  void release_slot(int i) {
    slots_[i].store(nullptr, std::memory_order_release);
    owned_[i].store(false, std::memory_order_release);
  }
  std::atomic<void*>& slot(int i) { return slots_[i]; }

  // ---- retirement ---------------------------------------------------------
  void retire(void* p, void (*del)(void*));

  // Free every retired node nobody publishes. Returns survivors count.
  static void scan(std::vector<Retired>& retired) {
    HazardDomain& d = instance();
    void* hazards[kSlots];
    for (int i = 0; i < kSlots; ++i)
      hazards[i] = d.slots_[i].load(std::memory_order_seq_cst);
    std::vector<Retired> keep;
    keep.reserve(retired.size());
    for (const Retired& r : retired) {
      bool protected_ = false;
      for (int i = 0; i < kSlots; ++i)
        if (hazards[i] == r.p) {
          protected_ = true;
          break;
        }
      if (protected_)
        keep.push_back(r);
      else
        r.del(r.p);
    }
    retired.swap(keep);
  }

  void adopt_orphans(std::vector<Retired>& into) {
    std::lock_guard<std::mutex> g(orphan_mu_);
    into.insert(into.end(), orphans_.begin(), orphans_.end());
    orphans_.clear();
  }
  void orphan(std::vector<Retired>&& nodes) {
    std::lock_guard<std::mutex> g(orphan_mu_);
    orphans_.insert(orphans_.end(), nodes.begin(), nodes.end());
  }

  ~HazardDomain() {
    // process teardown: every thread has exited, survivors are safe to free
    for (const Retired& r : orphans_) r.del(r.p);
  }

 private:
  HazardDomain() = default;
  std::atomic<void*> slots_[kSlots] = {};
  std::atomic<bool> owned_[kSlots] = {};
  std::mutex orphan_mu_;
  std::vector<Retired> orphans_;
};

namespace detail {

// Per-thread state: leased global slots (lazily grown) + retire list.
struct HazardThread {
  static constexpr int kMaxLease = 8;
  int lease[kMaxLease];
  bool in_use[kMaxLease] = {};
  int n_leased = 0;
  std::vector<HazardDomain::Retired> retired;

  int acquire() {
    for (int i = 0; i < n_leased; ++i)
      if (!in_use[i]) {
        in_use[i] = true;
        return i;
      }
    if (n_leased < kMaxLease) {
      int s = HazardDomain::instance().acquire_slot();
      if (s >= 0) {
        lease[n_leased] = s;
        in_use[n_leased] = true;
        return n_leased++;
      }
    }
    return -1;
  }
  void release(int i) {
    HazardDomain::instance().slot(lease[i]).store(
        nullptr, std::memory_order_release);
    in_use[i] = false;
  }

  ~HazardThread() {
    HazardDomain& d = HazardDomain::instance();
    d.adopt_orphans(retired);
    HazardDomain::scan(retired);
    if (!retired.empty()) d.orphan(std::move(retired));
    for (int i = 0; i < n_leased; ++i) d.release_slot(lease[i]);
  }

  static HazardThread& current() {
    thread_local HazardThread t;
    return t;
  }
};

}  // namespace detail

inline void HazardDomain::retire(void* p, void (*del)(void*)) {
  auto& t = detail::HazardThread::current();
  t.retired.push_back({p, del});
  if (t.retired.size() >= kScanThreshold) {
    adopt_orphans(t.retired);
    scan(t.retired);
  }
}

// RAII single-pointer protection.
class HazardGuard {
 public:
  HazardGuard() {
    auto& t = detail::HazardThread::current();
    idx_ = t.acquire();
    while (idx_ < 0) {  // >kSlots simultaneous guards: wait for a release
      std::this_thread::yield();
      idx_ = t.acquire();
    }
    slot_ = &HazardDomain::instance().slot(t.lease[idx_]);
  }
  ~HazardGuard() {
    if (idx_ >= 0) detail::HazardThread::current().release(idx_);
  }
  HazardGuard(const HazardGuard&) = delete;
  HazardGuard& operator=(const HazardGuard&) = delete;

  // Validated publish: after return, *p stays alive until clear()/~guard.
  template <typename U>
  U* protect(const std::atomic<U*>& src) {
    U* p = src.load(std::memory_order_acquire);
    for (;;) {
      slot_->store(const_cast<void*>((const void*)p),
                   std::memory_order_seq_cst);
      U* q = src.load(std::memory_order_seq_cst);
      if (q == p) return p;
      p = q;
    }
  }
  void set(void* p) { slot_->store(p, std::memory_order_seq_cst); }
  void clear() { slot_->store(nullptr, std::memory_order_release); }
  bool valid() const { return slot_ != nullptr; }

 private:
  int idx_;
  std::atomic<void*>* slot_;
};

}  // namespace hpc_host
