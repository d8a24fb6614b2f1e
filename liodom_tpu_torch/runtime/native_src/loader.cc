// Native data loader for liodom_tpu.
//
// The reference's runtime is C++ end to end; its ingest path is a ROS
// subscriber thread deserialising PointCloud2 into PCL buffers feeding a
// mutex FIFO (liodom_node.cc:40-55 -> shared_data.cc:37-62).  The TPU engine
// consumes fixed-shape host arrays instead, and this library is the native
// equivalent of that ingest stage: multithreaded file readers that parse
// KITTI velodyne .bin records (float32 x,y,z,intensity) straight into
// preallocated xyz buffers, decoupled from the Python interpreter by a
// bounded ring (backpressure included -- unlike the reference's unbounded
// queue).
//
// Exposed as a plain C ABI for ctypes.  Build: g++ -O3 -shared -fPIC.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Velodyne ring routing (the reference's splitPointCloud,
// feature_extractor.cc:104-179) as a loader stage: validity gate + the
// hard-coded 64/32/16-line elevation formulas, appending each point to its
// ring row of a dense (rings, width, 3) image.  All math in float to match
// the on-device f32 path (liodom_tpu/ops/features.py ring_id_velodyne).
// Returns the number of routed points.
long split_velodyne(const float* pts, long n, int stride, int scan_lines,
                    float min_range, float max_range, int ring_width,
                    float* out_img, int* out_counts) {
  const float rad2deg = 180.0f / 3.14159265358979323846f;
  std::memset(out_img, 0,
              static_cast<size_t>(scan_lines) * ring_width * 3 *
                  sizeof(float));
  std::memset(out_counts, 0, static_cast<size_t>(scan_lines) * sizeof(int));
  long routed = 0;
  for (long i = 0; i < n; ++i) {
    const float x = pts[i * stride + 0];
    const float y = pts[i * stride + 1];
    const float z = pts[i * stride + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    const float d = std::sqrt(x * x + y * y);
    if (d < min_range || d > max_range) continue;
    const float dd = d > 1e-9f ? d : 1e-9f;
    const float angle = std::atan(z / dd) * rad2deg;
    int rid;
    bool ok;
    if (scan_lines == 64) {
      if (angle >= -8.83f) {
        rid = static_cast<int>((2.0f - angle) * 3.0f + 0.5f);
      } else {
        rid = 32 + static_cast<int>((-8.83f - angle) * 2.0f + 0.5f);
      }
      ok = angle <= 2.0f && angle >= -24.33f && rid >= 0 && rid <= 63;
    } else if (scan_lines == 32) {
      rid = static_cast<int>((angle + 92.0f / 3.0f) * 3.0f / 4.0f);
      ok = rid >= 0 && rid <= 31;
    } else if (scan_lines == 16) {
      rid = static_cast<int>((angle + 15.0f) / 2.0f + 0.5f);
      ok = rid >= 0 && rid <= 15;
    } else {
      return -1;
    }
    if (!ok) continue;
    int& c = out_counts[rid];
    if (c < ring_width) {
      float* row = out_img + (static_cast<size_t>(rid) * ring_width + c) * 3;
      row[0] = x;
      row[1] = y;
      row[2] = z;
      ++c;
    }
    ++routed;
  }
  for (int r = 0; r < scan_lines; ++r)
    if (out_counts[r] > ring_width) out_counts[r] = ring_width;
  return routed;
}

// Read a whole file of float32 records; returns bytes read or -1.
long read_file(const char* path, void* out, long cap_bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  long n = static_cast<long>(std::fread(out, 1, cap_bytes, f));
  std::fclose(f);
  return n;
}

struct Slot {
  std::vector<float> xyz;   // cap_points * 3  (or rings*width*3 in split mode)
  std::vector<int> counts;  // split mode: per-ring point counts
  long n_points = 0;
  long index = -1;          // sequence index held by this slot
  bool ready = false;
};

// Split-mode parameters (scan_lines == 0 -> raw xyz mode).
struct SplitParams {
  int scan_lines = 0;
  int ring_width = 0;
  float min_range = 0.f;
  float max_range = 0.f;
};

struct Prefetcher {
  std::vector<std::string> paths;
  long cap_points;
  int depth;
  SplitParams split;
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  long next_to_read = 0;     // next file index a worker may claim
  long next_to_emit = 0;     // next index the consumer wants
  std::atomic<bool> stop{false};

  Prefetcher(std::vector<std::string> p, long cap, int d, int n_threads,
             SplitParams sp = {})
      : paths(std::move(p)), cap_points(cap), depth(d), split(sp), slots(d) {
    const size_t buf = split.scan_lines
        ? static_cast<size_t>(split.scan_lines) * split.ring_width * 3
        : static_cast<size_t>(cap) * 3;
    for (auto& s : slots) {
      s.xyz.resize(buf);
      if (split.scan_lines) s.counts.resize(split.scan_lines);
    }
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { this->work(); });
  }

  ~Prefetcher() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& w : workers) w.join();
  }

  void work() {
    std::vector<float> raw(static_cast<size_t>(cap_points) * 4);
    for (;;) {
      long idx;
      Slot* slot = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          if (stop.load()) return true;
          if (next_to_read >= static_cast<long>(paths.size())) return true;
          // claimable: a free slot exists and the next file is within
          // `depth` of the consumer cursor (bounded look-ahead).
          if (next_to_read >= next_to_emit + depth) return false;
          for (auto& s : slots) if (s.index == -1) return true;
          return false;
        });
        if (stop.load() ||
            next_to_read >= static_cast<long>(paths.size()))
          return;
        for (auto& s : slots) {
          if (s.index == -1) { slot = &s; break; }
        }
        if (!slot) continue;
        idx = next_to_read++;
        slot->index = idx;
        slot->ready = false;
      }
      long bytes = read_file(paths[idx].c_str(), raw.data(),
                             static_cast<long>(raw.size()) * 4);
      long n = bytes < 0 ? 0 : bytes / 16;  // 4 floats per record
      if (split.scan_lines) {
        n = split_velodyne(raw.data(), n, 4, split.scan_lines,
                           split.min_range, split.max_range,
                           split.ring_width, slot->xyz.data(),
                           slot->counts.data());
      } else {
        for (long i = 0; i < n; ++i)
          std::memcpy(&slot->xyz[i * 3], &raw[i * 4], 3 * sizeof(float));
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->n_points = n;
        slot->ready = true;
      }
      cv_ready.notify_all();
    }
  }

  // Copies scan `next_to_emit` into out (cap_points*3 floats; in split mode
  // the full rings*width*3 image plus per-ring counts).
  // Returns n_points (routed points in split mode), or -1 at end.
  long next(float* out, int* out_counts = nullptr) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_emit >= static_cast<long>(paths.size())) return -1;
    long want = next_to_emit;
    Slot* slot = nullptr;
    cv_ready.wait(lk, [&] {
      if (stop.load()) return true;
      for (auto& s : slots)
        if (s.index == want && s.ready) { slot = &s; return true; }
      return false;
    });
    if (!slot) return -1;
    long n = slot->n_points;
    if (split.scan_lines) {
      std::memcpy(out, slot->xyz.data(),
                  slot->xyz.size() * sizeof(float));
      if (out_counts)
        std::memcpy(out_counts, slot->counts.data(),
                    slot->counts.size() * sizeof(int));
    } else {
      std::memcpy(out, slot->xyz.data(),
                  static_cast<size_t>(n) * 3 * sizeof(float));
    }
    slot->index = -1;   // release the slot back to the workers
    slot->ready = false;
    next_to_emit++;
    lk.unlock();
    cv_free.notify_all();
    return n;
  }
};

}  // namespace

extern "C" {

// Read one .bin of float32 records into out; returns floats read or -1.
long liodom_read_bin(const char* path, float* out, long cap_floats) {
  long bytes = read_file(path, out, cap_floats * 4);
  return bytes < 0 ? -1 : bytes / 4;
}

void* liodom_prefetch_create(const char** paths, long n_paths,
                             long cap_points, int depth, int n_threads) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new Prefetcher(std::move(p), cap_points, depth, n_threads);
}

long liodom_prefetch_next(void* h, float* out_xyz) {
  return static_cast<Prefetcher*>(h)->next(out_xyz);
}

void liodom_prefetch_destroy(void* h) {
  delete static_cast<Prefetcher*>(h);
}

// Ring-split one scan already in memory (pts = n x stride floats).
long liodom_split_velodyne(const float* pts, long n, int stride,
                           int scan_lines, float min_range, float max_range,
                           int ring_width, float* out_img, int* out_counts) {
  return split_velodyne(pts, n, stride, scan_lines, min_range, max_range,
                        ring_width, out_img, out_counts);
}

// Prefetcher that reads .bin files AND ring-splits them in worker threads,
// emitting dense (scan_lines, ring_width, 3) images + per-ring counts.
void* liodom_prefetch_create_split(const char** paths, long n_paths,
                                   long cap_points, int depth, int n_threads,
                                   int scan_lines, int ring_width,
                                   float min_range, float max_range) {
  std::vector<std::string> p(paths, paths + n_paths);
  SplitParams sp;
  sp.scan_lines = scan_lines;
  sp.ring_width = ring_width;
  sp.min_range = min_range;
  sp.max_range = max_range;
  return new Prefetcher(std::move(p), cap_points, depth, n_threads, sp);
}

long liodom_prefetch_next_split(void* h, float* out_img, int* out_counts) {
  return static_cast<Prefetcher*>(h)->next(out_img, out_counts);
}

}  // extern "C"
