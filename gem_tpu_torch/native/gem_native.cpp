// A copy of gem_tpu/native/gem_native.cpp (the port reads nothing under
// gem_tpu/).
// gem_native: C runtime components for gem_tpu.
//
// The reference's host runtime is C++: the VoxelGrid pre-filter chains
// (filter.launch / filter_kitti.launch), PCL point-cloud struct-of-array
// conversion loops (SensorProcessorBase.cpp:160-169), the spatial hash used
// for submap dedup (GridUtilHash.hpp), PCD file IO, and a threaded frame
// pipeline (elevation_mapping_node.cpp:48-55).  This library provides the
// TPU-framework equivalents behind a plain C ABI consumed via ctypes
// (gem_tpu_torch/native/__init__.py):
//
//   gem_voxel_filter      leaf-size voxel downsample + crop box (centroid)
//   gem_dedup_cells       quantized-cell dedup keeping the min-variance hit
//   gem_write_pcd / gem_read_pcd_info / gem_read_pcd_data
//   gem_prefetcher_*      background-thread file loader with a ring buffer
//
// Built at first use by gem_tpu_torch/native/__init__.py into
// build/gem_tpu_torch/ (g++ -O3 -shared; no external deps).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Voxel-grid downsample with crop box.
//
// Equivalent of the reference's pcl_ros VoxelGrid nodelets
// (filter_kitti.launch: leaf 0.2 m, crop x/y +-40 m, z +-25 m): points are
// binned by leaf cell and replaced by the per-cell centroid; intensity
// averages.  Returns the number of output points (<= capacity).
int gem_voxel_filter(const float* xyz, const float* intensity, int n,
                     float leaf, float min_x, float max_x, float min_y,
                     float max_y, float min_z, float max_z, float* out_xyz,
                     float* out_intensity, int capacity) {
  if (leaf <= 0.f || n <= 0) return 0;
  struct Acc {
    double x = 0, y = 0, z = 0, i = 0;
    int count = 0;
  };
  std::unordered_map<uint64_t, Acc> cells;
  cells.reserve(static_cast<size_t>(n));
  const double inv = 1.0 / leaf;
  for (int k = 0; k < n; ++k) {
    const float x = xyz[3 * k], y = xyz[3 * k + 1], z = xyz[3 * k + 2];
    if (!(x >= min_x && x <= max_x && y >= min_y && y <= max_y && z >= min_z &&
          z <= max_z))
      continue;
    if (std::isnan(x) || std::isnan(y) || std::isnan(z)) continue;
    const int64_t ix = static_cast<int64_t>(std::floor(x * inv));
    const int64_t iy = static_cast<int64_t>(std::floor(y * inv));
    const int64_t iz = static_cast<int64_t>(std::floor(z * inv));
    const uint64_t key = (static_cast<uint64_t>(ix & 0x1FFFFF) << 42) |
                         (static_cast<uint64_t>(iy & 0x1FFFFF) << 21) |
                         static_cast<uint64_t>(iz & 0x1FFFFF);
    Acc& a = cells[key];
    a.x += x;
    a.y += y;
    a.z += z;
    if (intensity) a.i += intensity[k];
    a.count++;
  }
  int m = 0;
  for (const auto& kv : cells) {
    if (m >= capacity) break;
    const Acc& a = kv.second;
    out_xyz[3 * m] = static_cast<float>(a.x / a.count);
    out_xyz[3 * m + 1] = static_cast<float>(a.y / a.count);
    out_xyz[3 * m + 2] = static_cast<float>(a.z / a.count);
    if (out_intensity)
      out_intensity[m] = static_cast<float>(a.i / a.count);
    ++m;
  }
  return m;
}

// ---------------------------------------------------------------------------
// Quantized-cell dedup: keep the minimum-variance record per cell.
//
// Replaces the reference's GridPoint unordered_map insert/replace loops
// (updateLocalMap src/ElevationMapping.cpp:740-747, pointCloudtoHash
// :1180-1192) for submap export.  Keys use the reference's
// ceil(x/res) quantization.  Writes the kept indices; returns their count.
int gem_dedup_cells(const float* x, const float* y, const float* variance,
                    const uint8_t* valid, int n, float resolution,
                    int32_t* kept_indices, int capacity) {
  if (n <= 0 || resolution <= 0.f) return 0;
  std::unordered_map<uint64_t, int> best;
  best.reserve(static_cast<size_t>(n));
  const double inv = 1.0 / resolution;
  for (int k = 0; k < n; ++k) {
    if (valid && !valid[k]) continue;
    const int64_t qx = static_cast<int64_t>(std::ceil(x[k] * inv));
    const int64_t qy = static_cast<int64_t>(std::ceil(y[k] * inv));
    const uint64_t key = (static_cast<uint64_t>(qx & 0xFFFFFFFF) << 32) |
                         static_cast<uint64_t>(qy & 0xFFFFFFFF);
    auto it = best.find(key);
    if (it == best.end() || variance[k] < variance[it->second] ||
        (variance[k] == variance[it->second] && k > it->second)) {
      best[key] = k;  // min variance wins; later frame breaks ties (the
                      // reference hash keeps the most recent insert)
    }
  }
  int m = 0;
  for (const auto& kv : best) {
    if (m >= capacity) break;
    kept_indices[m++] = kv.second;
  }
  return m;
}

// ---------------------------------------------------------------------------
// PCD binary IO fast path (layout matches io/pcd.py).

int gem_write_pcd(const char* path, const float* data, int n, int fields) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f,
               "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
               "FIELDS x y z rgb intensity covariance travers\n"
               "SIZE 4 4 4 4 4 4 4\nTYPE F F F F F F F\n"
               "COUNT 1 1 1 1 1 1 1\nWIDTH %d\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS %d\nDATA binary\n",
               n, n);
  const size_t want = static_cast<size_t>(n) * fields;
  const size_t wrote = std::fwrite(data, sizeof(float), want, f);
  std::fclose(f);
  return wrote == want ? n : -2;
}

// Returns point count and field count via out params; -1 on error.
int gem_read_pcd_info(const char* path, int* n_points, int* n_fields) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  int n = -1, fields = 0;
  bool binary = false;
  while (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "FIELDS", 6) == 0) {
      for (char* p = line + 6; *p; ++p)
        if (*p == ' ' && *(p + 1) && *(p + 1) != '\n') ++fields;
    } else if (std::sscanf(line, "POINTS %d", &n) == 1) {
    } else if (std::strncmp(line, "DATA", 4) == 0) {
      binary = std::strstr(line, "binary") != nullptr;
      break;
    }
  }
  std::fclose(f);
  if (n < 0 || !binary) return -1;
  *n_points = n;
  *n_fields = fields;
  return 0;
}

int gem_read_pcd_data(const char* path, float* out, int n, int fields) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  while (std::fgets(line, sizeof line, f))
    if (std::strncmp(line, "DATA", 4) == 0) break;
  const size_t want = static_cast<size_t>(n) * fields;
  const size_t got = std::fread(out, sizeof(float), want, f);
  std::fclose(f);
  return got == want ? n : -2;
}

// ---------------------------------------------------------------------------
// Background frame prefetcher.
//
// The reference overlaps sensor IO with mapping via its ROS spinner threads;
// here a worker thread reads raw frame files (any format — the Python side
// parses) into a bounded ring buffer so host file IO overlaps device
// compute.  Handles are opaque ints.

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<std::vector<uint8_t>> slots;
  std::vector<int> slot_frame;       // which frame index occupies the slot
  size_t next_read = 0;              // next frame the worker will load
  size_t next_consume = 0;           // next frame the consumer wants
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::thread worker;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_full.wait(lk, [&] {
          // signed: the consumer may skip AHEAD of next_read, and the
          // unsigned difference would underflow and stall the worker
          const long ahead = static_cast<long>(next_read) -
                             static_cast<long>(next_consume);
          return stop.load() || (next_read < paths.size() &&
                                 ahead < static_cast<long>(slots.size()));
        });
        if (stop.load() || next_read >= paths.size()) {
          if (next_read >= paths.size()) return;
          continue;
        }
        idx = next_read;
      }
      std::vector<uint8_t> buf;
      FILE* f = std::fopen(paths[idx].c_str(), "rb");
      if (f) {
        std::fseek(f, 0, SEEK_END);
        const long sz = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        buf.resize(static_cast<size_t>(sz));
        if (std::fread(buf.data(), 1, buf.size(), f) != buf.size())
          buf.clear();
        std::fclose(f);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        const size_t slot = idx % slots.size();
        slots[slot] = std::move(buf);
        slot_frame[slot] = static_cast<int>(idx);
        next_read = idx + 1;
      }
      cv_empty.notify_all();
    }
  }
};

static std::mutex g_pf_mu;
static std::unordered_map<int, Prefetcher*> g_prefetchers;
static int g_next_handle = 1;

int gem_prefetcher_create(const char** paths, int n_paths, int ring) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n_paths);
  p->slots.resize(ring > 0 ? ring : 4);
  p->slot_frame.assign(p->slots.size(), -1);
  p->worker = std::thread(&Prefetcher::run, p);
  std::lock_guard<std::mutex> lk(g_pf_mu);
  const int h = g_next_handle++;
  g_prefetchers[h] = p;
  return h;
}

// Blocks until frame `idx` is loaded; returns its byte size (0 = read error,
// -1 = bad handle/index, -2 = frame no longer reachable — the ring is
// forward-only and the slot was already overwritten by a newer frame; the
// caller must fall back to a direct read).  Data: gem_prefetcher_copy.
long gem_prefetcher_size(int handle, int idx) {
  Prefetcher* p;
  {
    std::lock_guard<std::mutex> lk(g_pf_mu);
    auto it = g_prefetchers.find(handle);
    if (it == g_prefetchers.end()) return -1;
    p = it->second;
  }
  if (idx < 0 || static_cast<size_t>(idx) >= p->paths.size()) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  const size_t slot = static_cast<size_t>(idx) % p->slots.size();
  if (p->slot_frame[slot] > idx) return -2;  // overwritten: backward access
  p->next_consume = static_cast<size_t>(idx);
  p->cv_full.notify_all();
  p->cv_empty.wait(lk, [&] {
    return p->stop.load() || p->slot_frame[slot] >= idx;
  });
  if (p->slot_frame[slot] != idx) return -2;
  return static_cast<long>(p->slots[slot].size());
}

int gem_prefetcher_copy(int handle, int idx, uint8_t* out, long capacity) {
  Prefetcher* p;
  {
    std::lock_guard<std::mutex> lk(g_pf_mu);
    auto it = g_prefetchers.find(handle);
    if (it == g_prefetchers.end()) return -1;
    p = it->second;
  }
  std::lock_guard<std::mutex> lk(p->mu);
  const size_t slot = static_cast<size_t>(idx) % p->slots.size();
  if (p->slot_frame[slot] != idx) return -2;
  const auto& buf = p->slots[slot];
  if (static_cast<long>(buf.size()) > capacity) return -3;
  std::memcpy(out, buf.data(), buf.size());
  // release the slot so the worker can advance
  p->next_consume = static_cast<size_t>(idx) + 1;
  p->cv_full.notify_all();
  return static_cast<int>(buf.size());
}

void gem_prefetcher_destroy(int handle) {
  Prefetcher* p = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_pf_mu);
    auto it = g_prefetchers.find(handle);
    if (it == g_prefetchers.end()) return;
    p = it->second;
    g_prefetchers.erase(it);
  }
  p->stop.store(true);
  p->cv_full.notify_all();
  p->worker.join();
  delete p;
}

}  // extern "C"
