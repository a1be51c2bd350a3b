// Arena memory pool — host runtime.
//
// C++17 re-design of the capabilities of the reference's nginx-style C pool
// (lib/mempool/single/src/single_mempool_impl.c:31-254): bump-pointer pages
// for small allocations with fail-count page rotation, malloc-backed large
// allocations tracked for early free, cleanup-handler chain, reset/destroy.
// Used by the host staging path (MatrixMarket parsing) to avoid per-token
// malloc traffic.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <new>
#include <vector>

namespace hpc_host {

class ArenaPool {
 public:
  static constexpr std::size_t kAlign = 16;
  static constexpr int kMaxFail = 4;  // page rotation threshold (ref :163-167)

  explicit ArenaPool(std::size_t page_size = 4096)
      : page_size_(page_size < 256 ? 256 : page_size) {
    pages_.push_back(Page(page_size_));
    current_ = 0;
  }
  ArenaPool(const ArenaPool&) = delete;
  ArenaPool& operator=(const ArenaPool&) = delete;
  ~ArenaPool() { destroy(); }

  void* alloc(std::size_t size) {
    if (size == 0) size = 1;
    if (size > page_size_) return alloc_large(size);
    // try pages starting from current_; rotate current_ past pages that
    // keep failing (the reference's fail-count rotation)
    for (std::size_t i = current_; i < pages_.size(); ++i) {
      void* p = pages_[i].bump(size);
      if (p) return p;
      if (++pages_[i].fails > kMaxFail && i == current_) ++current_;
    }
    pages_.push_back(Page(page_size_));
    if (current_ >= pages_.size()) current_ = pages_.size() - 1;
    return pages_.back().bump(size);
  }

  void* alloc_large(std::size_t size) {
    void* p = std::malloc(size);
    if (!p) throw std::bad_alloc();
    large_.push_back(p);
    large_bytes_ += size;
    return p;
  }

  // early free of a large allocation (ref ngx_pfree :206); returns true if found
  bool free_large(void* p) {
    for (auto& slot : large_) {
      if (slot == p) {
        std::free(p);
        slot = nullptr;
        return true;
      }
    }
    return false;
  }

  // cleanup handlers run (LIFO) at reset/destroy (ref :232-254)
  void add_cleanup(std::function<void()> fn) {
    cleanups_.push_back(std::move(fn));
  }

  void reset() {
    run_cleanups();
    for (void* p : large_)
      if (p) std::free(p);
    large_.clear();
    large_bytes_ = 0;
    for (auto& pg : pages_) pg.reset();
    current_ = 0;
  }

  std::size_t bytes_reserved() const {
    return pages_.size() * page_size_ + large_bytes_;
  }
  std::size_t n_pages() const { return pages_.size(); }

 private:
  struct Page {
    explicit Page(std::size_t sz) : buf(new unsigned char[sz]), cap(sz) {}
    Page(Page&& o) noexcept : buf(o.buf), cap(o.cap), used(o.used),
                              fails(o.fails) {
      o.buf = nullptr;
    }
    Page(const Page&) = delete;
    ~Page() { delete[] buf; }

    void* bump(std::size_t size) {
      std::size_t aligned = (used + kAlign - 1) & ~(kAlign - 1);
      if (aligned + size > cap) return nullptr;
      used = aligned + size;
      return buf + aligned;
    }
    void reset() { used = 0; fails = 0; }

    unsigned char* buf;
    std::size_t cap;
    std::size_t used = 0;
    int fails = 0;
  };

  void run_cleanups() {
    for (auto it = cleanups_.rbegin(); it != cleanups_.rend(); ++it) (*it)();
    cleanups_.clear();
  }

  void destroy() {
    run_cleanups();
    for (void* p : large_)
      if (p) std::free(p);
    large_.clear();
  }

  std::size_t page_size_;
  std::vector<Page> pages_;
  std::size_t current_ = 0;
  std::vector<void*> large_;
  std::size_t large_bytes_ = 0;
  std::vector<std::function<void()>> cleanups_;
};

}  // namespace hpc_host
