// Multithreaded frame decode + prefetch for the PyTorch port's frame
// reader (data/sequence.iter_frames): the port's own copy of
// yolov7_tracker_tpu/native/frameloader.cpp, the same code.
//
// The reference hides JPEG decode latency behind torch DataLoader worker
// processes (utils/datasets.py:106-137 InfiniteDataLoader,
// tracker/track.py:130 DataLoader(batch_size=1)). A pool of std::thread
// workers decodes frames ahead of the consumer into a bounded in-order
// ring, so host decode overlaps device compute without Python in the
// decode path (OpenCV's imread releases no GIL it never held). Decoding
// uses the system OpenCV imgcodecs -- the same BGR HWC uint8 contract as
// cv2.imread.
//
// C API (loaded via ctypes from native/__init__.py):
//   void* fl_open(const char** paths, int n, int n_threads, int cap)
//   int   fl_next(void* h, unsigned char* out, long out_bytes, int* hw)
//         -> frame index (0-based), or -1 end-of-stream,
//            -2 caller buffer too small (frame NOT consumed: hw reports
//               the frame's height/width so the caller can grow the
//               buffer and call again), -3 decode failure
//   void  fl_close(void* h)
//
// fl_next delivers frames strictly in path order regardless of which
// worker decoded them; hw[0]/hw[1] receive the frame's height/width.

#include <opencv2/imgcodecs.hpp>

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  cv::Mat mat;
  bool ready = false;
  bool failed = false;
};

struct Loader {
  std::vector<std::string> paths;
  int cap = 0;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready;  // consumer waits for slot ready
  std::condition_variable cv_free;   // workers wait for ring space
  std::atomic<int> next_claim{0};
  int next_consume = 0;  // guarded by mu
  bool stop = false;     // guarded by mu
  std::vector<std::thread> threads;
};

void worker(Loader* L) {
  const int n = static_cast<int>(L->paths.size());
  for (;;) {
    const int idx = L->next_claim.fetch_add(1);
    if (idx >= n) return;
    cv::Mat m = cv::imread(L->paths[idx], cv::IMREAD_COLOR);
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_free.wait(lk, [&] {
      return L->stop || idx - L->next_consume < L->cap;
    });
    if (L->stop) return;
    Slot& s = L->slots[idx % L->cap];
    s.mat = std::move(m);
    s.failed = s.mat.empty();
    s.ready = true;
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* fl_open(const char** paths, int n, int n_threads, int cap) {
  if (n <= 0 || cap <= 0) return nullptr;
  Loader* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->cap = cap;
  L->slots.resize(cap);
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads; ++t)
    L->threads.emplace_back(worker, L);
  return L;
}

int fl_next(void* h, unsigned char* out, long out_bytes, int* hw) {
  Loader* L = static_cast<Loader*>(h);
  const int n = static_cast<int>(L->paths.size());
  cv::Mat m;
  int idx;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    idx = L->next_consume;
    if (idx >= n) return -1;
    Slot& s = L->slots[idx % L->cap];
    L->cv_ready.wait(lk, [&] { return s.ready; });
    if (!s.failed) {
      // size check BEFORE consuming: on a too-small buffer the frame
      // stays in the ring so the caller can grow and retry
      hw[0] = s.mat.rows;
      hw[1] = s.mat.cols;
      const long need = static_cast<long>(s.mat.rows) * s.mat.cols *
                        s.mat.channels();
      if (need > out_bytes) return -2;
    }
    const bool failed = s.failed;
    m = std::move(s.mat);
    s.ready = false;
    s.failed = false;
    ++L->next_consume;
    L->cv_free.notify_all();
    if (failed) return -3;
  }
  const long bytes = static_cast<long>(m.rows) * m.cols * m.channels();
  if (m.isContinuous()) {
    std::memcpy(out, m.data, bytes);
  } else {
    const long row = static_cast<long>(m.cols) * m.channels();
    for (int r = 0; r < m.rows; ++r)
      std::memcpy(out + r * row, m.ptr(r), row);
  }
  return idx;
}

void fl_close(void* h) {
  Loader* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  // unblock any worker still claiming indices
  L->next_claim.store(static_cast<int>(L->paths.size()));
  for (auto& t : L->threads) t.join();
  delete L;
}

}  // extern "C"
