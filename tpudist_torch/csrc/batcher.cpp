// Host batch assembly for the port's DataLoader (tpudist_torch/data/native.py):
// the C++ core of tpudist's batcher (tpudist/csrc/batcher.cpp), the gather
// kernels only.
//
// The hot operation is gathering the sampler's index shard into one
// contiguous batch buffer (on a machine with a card, a pinned buffer that
// the host-to-device copy reads), optionally fused with the ToTensor
// uint8 -> float32 conversion and a per-channel normalization, in one pass
// over a persistent thread pool. numpy does the same work in two passes
// (fancy-index gather, then astype and the affine) with an intermediate.
//
// A plain C ABI, loaded with ctypes; built with g++ at first use into
// tpudist_torch/_build/ (tpudist_torch/csrc/build.py, build_host).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    n = std::max(n, 1);
    workers_.reserve(n);
    for (int i = 0; i < n; ++i) workers_.emplace_back([this] { Loop(); });
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> l(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  int size() const { return static_cast<int>(workers_.size()); }

  // Run all tasks on the pool and block until every one has finished.
  void Run(std::vector<std::function<void()>> tasks) {
    if (tasks.empty()) return;
    std::mutex done_m;
    std::condition_variable done_cv;
    size_t remaining = tasks.size();  // guarded by done_m
    {
      std::lock_guard<std::mutex> l(m_);
      for (auto& t : tasks) {
        q_.push([&done_m, &done_cv, &remaining, t = std::move(t)] {
          t();
          // final decrement must happen under done_m so the waiter cannot
          // observe 0 and destroy done_m while we still hold it
          std::lock_guard<std::mutex> dl(done_m);
          if (--remaining == 0) done_cv.notify_all();
        });
      }
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> dl(done_m);
    done_cv.wait(dl, [&] { return remaining == 0; });
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> l(m_);
        cv_.wait(l, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        task = std::move(q_.front());
        q_.pop();
      }
      task();
    }
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex m_;
  std::condition_variable cv_;
  bool stop_ = false;
};

// Split [0, n) into at most pool->size() contiguous chunks of at least
// min_chunk rows each and run fn(start, end) on the pool; small inputs run
// inline on the caller to skip scheduling overhead.
void ParallelChunks(ThreadPool* pool, int64_t n, int64_t min_chunk,
                    const std::function<void(int64_t, int64_t)>& fn) {
  int64_t max_tasks = pool ? pool->size() : 1;
  int64_t n_tasks = std::min(max_tasks, (n + min_chunk - 1) / min_chunk);
  if (n_tasks <= 1 || pool == nullptr) {
    fn(0, n);
    return;
  }
  std::vector<std::function<void()>> tasks;
  tasks.reserve(n_tasks);
  int64_t per = (n + n_tasks - 1) / n_tasks;
  for (int64_t s = 0; s < n; s += per) {
    int64_t e = std::min(n, s + per);
    tasks.push_back([s, e, &fn] { fn(s, e); });
  }
  pool->Run(std::move(tasks));
}

}  // namespace

extern "C" {

void* tpd_pool_create(int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  }
  return new ThreadPool(n_threads);
}

void tpd_pool_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }

// out[i] = src[idx[i]] for rows of item_bytes bytes (dtype-agnostic gather).
void tpd_gather_rows(void* pool, const uint8_t* src, int64_t item_bytes,
                     const int64_t* idx, int64_t n, uint8_t* out) {
  // ~1 MiB of copying per task amortizes scheduling
  int64_t min_chunk = std::max<int64_t>(1, (1 << 20) / std::max<int64_t>(item_bytes, 1));
  ParallelChunks(static_cast<ThreadPool*>(pool), n, min_chunk,
                 [=](int64_t s, int64_t e) {
                   for (int64_t i = s; i < e; ++i) {
                     std::memcpy(out + i * item_bytes,
                                 src + idx[i] * item_bytes, item_bytes);
                   }
                 });
}

// out[i] = float(src[idx[i]]) * scale + shift — the sampler gather fused
// with ToTensor's /255 (one pass, no uint8 intermediate batch).
void tpd_gather_u8_to_f32(void* pool, const uint8_t* src, int64_t item_elems,
                          const int64_t* idx, int64_t n, float* out,
                          float scale, float shift) {
  int64_t min_chunk = std::max<int64_t>(1, (1 << 19) / std::max<int64_t>(item_elems, 1));
  ParallelChunks(static_cast<ThreadPool*>(pool), n, min_chunk,
                 [=](int64_t s, int64_t e) {
                   for (int64_t i = s; i < e; ++i) {
                     const uint8_t* row = src + idx[i] * item_elems;
                     float* dst = out + i * item_elems;
                     for (int64_t j = 0; j < item_elems; ++j) {
                       dst[j] = static_cast<float>(row[j]) * scale + shift;
                     }
                   }
                 });
}

// out[i][..., c] = float(src[idx[i]][..., c]) * scale[c] + shift[c] — the
// gather fused with ToTensor + per-channel normalization ((x/255 - mean)/std
// folds into one affine per channel). `channels` is the innermost dim of an
// item; item_elems must be a multiple of it.
void tpd_gather_u8_to_f32_ch(void* pool, const uint8_t* src,
                             int64_t item_elems, int64_t channels,
                             const int64_t* idx, int64_t n, float* out,
                             const float* scale, const float* shift) {
  int64_t min_chunk = std::max<int64_t>(1, (1 << 19) / std::max<int64_t>(item_elems, 1));
  ParallelChunks(static_cast<ThreadPool*>(pool), n, min_chunk,
                 [=](int64_t s, int64_t e) {
                   for (int64_t i = s; i < e; ++i) {
                     const uint8_t* row = src + idx[i] * item_elems;
                     float* dst = out + i * item_elems;
                     for (int64_t j = 0; j < item_elems; j += channels) {
                       for (int64_t c = 0; c < channels; ++c) {
                         dst[j + c] =
                             static_cast<float>(row[j + c]) * scale[c] + shift[c];
                       }
                     }
                   }
                 });
}

}  // extern "C"
