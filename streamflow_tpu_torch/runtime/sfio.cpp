// sfio — native IO runtime of the port's data pipeline (its own copy of
// streamflow_tpu/runtime/sfio.cpp).
//
// The host pipeline is thread-based (data/loader.py); this library supplies
// GIL-free leaf operations: Middlebury .flo and binary PPM (P6, maxval 255)
// decoding, and a batched .flo read on a C++ thread pool, through a plain C
// ABI loaded with ctypes (streamflow_tpu_torch/runtime/__init__.py, which
// builds it with g++ at first use).
//
// Every function returns 0 on success and a code naming the failure
// otherwise (SFIO_* below); the Python side raises on any non-zero code.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

enum {
  SFIO_OK = 0,
  SFIO_OPEN = 1,       // the file cannot be opened or read
  SFIO_SHORT = 2,      // fewer bytes than the header or its payload needs
  SFIO_MAGIC = 3,      // not a .flo (magic) or not a binary P6 PPM
  SFIO_DIMS = 4,       // non-positive size, or a PPM maxval other than 255
  SFIO_MISMATCH = 5,   // the size differs from the one asked for
};

struct ThreadPool {
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Loop(); });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      done_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return done_ || !q_.empty(); });
        if (done_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  bool done_ = false;
};

ThreadPool* Pool() {
  static ThreadPool pool(
      static_cast<int>(std::max(2u, std::thread::hardware_concurrency())));
  return &pool;
}

bool ReadFile(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(size));
  size_t got = std::fread(out->data(), 1, out->size(), f);
  std::fclose(f);
  return got == out->size();
}

// A .flo header: magic 202021.25, int32 w, int32 h, then w*h*2 float32.
int FloHeader(const uint8_t* buf, size_t len, int32_t* w, int32_t* h) {
  if (len < 12) return SFIO_SHORT;
  float magic;
  std::memcpy(&magic, buf, 4);
  if (magic != 202021.25f) return SFIO_MAGIC;
  std::memcpy(w, buf + 4, 4);
  std::memcpy(h, buf + 8, 4);
  if (*w <= 0 || *h <= 0 || *w >= (1 << 30) || *h >= (1 << 30))
    return SFIO_DIMS;
  size_t want = 12 + static_cast<size_t>(*w) * static_cast<size_t>(*h) * 8;
  return len < want ? SFIO_SHORT : SFIO_OK;
}

// A binary PPM header: "P6", width, height, maxval (255) separated by
// whitespace or comments, then one whitespace byte; *pos ends at the
// first payload byte.
int PpmHeader(const uint8_t* buf, size_t len, int32_t* w, int32_t* h,
              size_t* pos_out) {
  if (len < 2 || buf[0] != 'P' || buf[1] != '6') return SFIO_MAGIC;
  size_t pos = 2;
  auto skip_ws = [&] {
    while (pos < len) {
      if (buf[pos] == '#') {
        while (pos < len && buf[pos] != '\n') ++pos;
      } else if (std::isspace(buf[pos])) {
        ++pos;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    bool any = false;
    while (pos < len && std::isdigit(buf[pos]) && v < (1L << 30)) {
      v = v * 10 + (buf[pos] - '0');
      ++pos;
      any = true;
    }
    return any ? v : -1;
  };
  long wv = read_int(), hv = read_int(), maxv = read_int();
  if (wv <= 0 || hv <= 0 || maxv != 255 || wv >= (1L << 30) ||
      hv >= (1L << 30))
    return SFIO_DIMS;
  ++pos;  // the single whitespace byte after maxval
  size_t want = static_cast<size_t>(wv) * static_cast<size_t>(hv) * 3;
  if (pos > len || len - pos < want) return SFIO_SHORT;
  *w = static_cast<int32_t>(wv);
  *h = static_cast<int32_t>(hv);
  *pos_out = pos;
  return SFIO_OK;
}

}  // namespace

extern "C" {

// Probe a .flo header: fills w/h; checks that the file holds the payload.
int sfio_flo_header(const char* path, int32_t* w, int32_t* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return SFIO_OPEN;
  uint8_t hdr[12];
  size_t got = std::fread(hdr, 1, 12, f);
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fclose(f);
  if (got != 12 || size < 0) return SFIO_SHORT;
  int rc = FloHeader(hdr, 12, w, h);
  if (rc != SFIO_OK && rc != SFIO_SHORT) return rc;
  size_t want = 12 + static_cast<size_t>(*w) * static_cast<size_t>(*h) * 8;
  return static_cast<size_t>(size) < want ? SFIO_SHORT : SFIO_OK;
}

// Decode one .flo of size w x h into dst (h*w*2 floats).
int sfio_read_flo(const char* path, float* dst, int32_t w, int32_t h) {
  std::vector<uint8_t> buf;
  if (!ReadFile(path, &buf)) return SFIO_OPEN;
  int32_t rw, rh;
  int rc = FloHeader(buf.data(), buf.size(), &rw, &rh);
  if (rc) return rc;
  if (rw != w || rh != h) return SFIO_MISMATCH;
  std::memcpy(dst, buf.data() + 12, static_cast<size_t>(w) * h * 8);
  return SFIO_OK;
}

// Batched .flo decode on the thread pool. paths: n C strings; dst: n
// contiguous (h*w*2) float blocks; codes: n return codes, one a file.
// Returns the number of files that failed.
int sfio_read_flo_batch(const char** paths, int n, float* dst, int32_t w,
                        int32_t h, int* codes) {
  // remaining is counted down under mu, so this frame (mu, cv) outlives
  // every worker's last touch of it
  std::atomic<int> failures{0};
  int remaining = n;
  std::mutex mu;
  std::condition_variable cv;
  size_t stride = static_cast<size_t>(w) * h * 2;
  for (int i = 0; i < n; ++i) {
    Pool()->Submit([&, i] {
      codes[i] = sfio_read_flo(paths[i], dst + stride * i, w, h);
      if (codes[i] != SFIO_OK) failures.fetch_add(1);
      std::lock_guard<std::mutex> lk(mu);
      if (--remaining == 0) cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return remaining == 0; });
  return failures.load();
}

// Probe a PPM header: fills w/h; checks that the file holds the payload.
int sfio_ppm_header(const char* path, int32_t* w, int32_t* h) {
  std::vector<uint8_t> buf;
  if (!ReadFile(path, &buf)) return SFIO_OPEN;
  size_t pos;
  return PpmHeader(buf.data(), buf.size(), w, h, &pos);
}

// Decode one binary PPM of size w x h into dst (h*w*3 uint8).
int sfio_read_ppm(const char* path, uint8_t* dst, int32_t w, int32_t h) {
  std::vector<uint8_t> buf;
  if (!ReadFile(path, &buf)) return SFIO_OPEN;
  int32_t rw, rh;
  size_t pos;
  int rc = PpmHeader(buf.data(), buf.size(), &rw, &rh, &pos);
  if (rc) return rc;
  if (rw != w || rh != h) return SFIO_MISMATCH;
  std::memcpy(dst, buf.data() + pos, static_cast<size_t>(w) * h * 3);
  return SFIO_OK;
}

}  // extern "C"
