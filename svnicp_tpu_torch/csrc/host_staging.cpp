// Host-side frame staging for the PyTorch port: range crop + pad, and one
// stage of the uniform downsample (and both stages back to back), each
// also in a form that carries the per-point sweep times of the rows it
// keeps; the two loaders of the log and dataset readers, KITTI's velodyne
// .bin files and the per-point time field of interleaved point records;
// and the lock-free single-producer single-consumer ring of scans that the
// threaded ingest feeds. The port's own copy of svn_stage_scan,
// svn_stage_scan_ts, svn_downsample_one_stage, svn_downsample_one_stage_ts,
// svn_downsample_two_stage, svn_read_kitti_bin, svn_extract_timestamps and
// svn_ring_* from native/svnicp_native.cpp, with the same arithmetic, so
// the staged clouds and the times are byte-equal to the JAX package's.
// Plain C ABI, bound with ctypes (svnicp_tpu_torch/io/native.py); built
// with g++ at first use.
//
// Downsample semantics (bit-compatible with core/pointcloud.downsample_uniform):
//  - voxel id: floor(p / v) per axis in f32 (divide, never multiply by a
//    reciprocal), packed 10 bits/axis;
//  - keep the point nearest the voxel CENTER (strict <, first wins);
//  - compact voxels in ascending (hash32(key) & -2) order, ties by key.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

inline uint32_t svn_hash32(uint32_t x) {
  x ^= x >> 16; x *= 0x7FEB352Du; x ^= x >> 15; x *= 0x846CA68Bu; x ^= x >> 16;
  return x;
}

// NOTE (key packing below): must DIVIDE like the device path
// (floor(p / v)); multiplying by a precomputed reciprocal differs for some
// float32 inputs at non-power-of-two voxel sizes (e.g.
// floor(7.4999995f * (1/1.5f)) = 5 vs floor(/1.5) = 4) and would break the
// bit-compatibility contract.

// One uniform-downsample stage; returns count written to out (<= capacity).
// Open-addressing flat table of packed entries, two passes with software
// prefetch (the probe is a random access into a table of 256+ KB per point),
// and nth_element + partial sort for the capacity truncation.
// With `ts`, out_ts gets the kept rows' times in the same order.
int svn_downsample_stage(const float* xyz, int n, float voxel, float* out,
                         int capacity, const float* ts = nullptr,
                         float* out_ts = nullptr) {
  struct Entry { int32_t key; float d; int32_t idx; };   // one cache line
  size_t tsize = 64;
  while (tsize < (size_t)n * 2) tsize <<= 1;
  static thread_local std::vector<Entry> table;
  static thread_local std::vector<int32_t> keybuf;
  static thread_local std::vector<float> dbuf;
  table.assign(tsize, Entry{-1, 0.0f, 0});               // 30-bit keys: -1 = empty
  if (keybuf.size() < (size_t)n) { keybuf.resize(n); dbuf.resize(n); }
  const size_t mask = tsize - 1;

  // pass 1 (sequential, vectorizable): voxel key + distance-to-center
  for (int i = 0; i < n; ++i) {
    const float* p = xyz + 3 * i;
    float d = 0.0f;
    uint32_t packed = 0;
    const int bits = 10, kmask = (1 << bits) - 1, half = 1 << (bits - 1);
    for (int a = 0; a < 3; ++a) {
      // divide (not reciprocal-multiply) and (f+0.5)*v (not f*v+0.5*v) for
      // bit-compatibility with the device/numpy paths — both expressions
      // differ by ulps on some inputs, which flips near-tie selections
      const float f = std::floor(p[a] / voxel);
      const float e = p[a] - (f + 0.5f) * voxel;
      d += e * e;
      packed = (packed << bits) | (uint32_t)(((int)f + half) & kmask);
    }
    keybuf[i] = (int32_t)packed;
    dbuf[i] = d;
  }

  // pass 2: probe with a prefetch window hiding the random-access latency
  constexpr int PF = 12;
  for (int i = 0; i < n; ++i) {
    if (i + PF < n)
      __builtin_prefetch(&table[svn_hash32((uint32_t)keybuf[i + PF]) & mask]);
    const int32_t key = keybuf[i];
    const float d = dbuf[i];
    size_t slot = svn_hash32((uint32_t)key) & mask;
    for (;;) {
      Entry& e = table[slot];
      if (e.key == key) {
        if (d < e.d) { e.d = d; e.idx = i; }
        break;
      }
      if (e.key == -1) {
        e = Entry{key, d, i};
        break;
      }
      slot = (slot + 1) & mask;
    }
  }

  struct Row { int32_t rank; int32_t key; int idx; };
  static thread_local std::vector<Row> rows;
  rows.clear();
  rows.reserve(tsize / 2);
  for (size_t s = 0; s < tsize; ++s) {
    if (table[s].key == -1) continue;
    const int32_t rank = (int32_t)(svn_hash32((uint32_t)table[s].key) & ~1u);
    rows.push_back(Row{rank, table[s].key, table[s].idx});
  }
  const auto lt = [](const Row& a, const Row& b) {
    if (a.rank != b.rank) return a.rank < b.rank;
    return a.key < b.key;
  };
  const int m = (int)rows.size() < capacity ? (int)rows.size() : capacity;
  if ((int)rows.size() > capacity) {
    std::nth_element(rows.begin(), rows.begin() + capacity, rows.end(), lt);
    rows.resize(capacity);
  }
  std::sort(rows.begin(), rows.end(), lt);
  for (int j = 0; j < m; ++j) {
    std::memcpy(out + 3 * j, xyz + 3 * rows[j].idx, sizeof(float) * 3);
    if (out_ts) out_ts[j] = ts[rows[j].idx];
  }
  return m;
}

// Crop by range (min < |p| < max, finite) and pad into [capacity,3]. Each
// of out_valid (0/1 bytes) and, with ts, out_ts (the kept rows' times) may
// be null. Returns the number of points staged.
int svn_crop_stage(const float* xyz, const float* ts, int n, float min_range,
                   float max_range, float* out_xyz, uint8_t* out_valid,
                   float* out_ts, int capacity) {
  const float min2 = min_range * min_range;
  const float max2 = max_range * max_range;
  int m = 0;
  for (int i = 0; i < n && m < capacity; ++i) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    const float d2 = x * x + y * y + z * z;
    if (d2 > min2 && d2 < max2 && std::isfinite(d2)) {
      out_xyz[3 * m + 0] = x;
      out_xyz[3 * m + 1] = y;
      out_xyz[3 * m + 2] = z;
      if (out_valid) out_valid[m] = 1;
      if (out_ts) out_ts[m] = ts[i];
      ++m;
    }
  }
  std::memset(out_xyz + 3 * m, 0, sizeof(float) * 3 * (capacity - m));
  if (out_valid) std::memset(out_valid + m, 0, capacity - m);
  if (out_ts) std::memset(out_ts + m, 0, sizeof(float) * (capacity - m));
  return m;
}

double svn_ts_read(const uint8_t* p, int dtype_code) {
  switch (dtype_code) {
    case 0: { float f; std::memcpy(&f, p, 4); return f; }
    case 1: { double d; std::memcpy(&d, p, 8); return d; }
    default: { uint32_t u; std::memcpy(&u, p, 4); return u; }
  }
}

}  // namespace

extern "C" {

// Crop by range and pad into [capacity,3]; out_valid gets 0/1 bytes.
int svn_stage_scan(const float* xyz, int n, float min_range, float max_range,
                   float* out_xyz, uint8_t* out_valid, int capacity) {
  return svn_crop_stage(xyz, nullptr, n, min_range, max_range, out_xyz,
                        out_valid, nullptr, capacity);
}

// svn_stage_scan carrying per-point times (same selection and order); a
// null ts stages the points alone.
int svn_stage_scan_ts(const float* xyz, const float* ts, int n,
                      float min_range, float max_range, float* out_xyz,
                      float* out_ts, int capacity) {
  return svn_crop_stage(xyz, ts, n, min_range, max_range, out_xyz, nullptr,
                        ts ? out_ts : nullptr, capacity);
}

// One uniform-downsample stage of [n,3] at `voxel`, capped at `capacity`
// and zero-padded; returns the count written.
int svn_downsample_one_stage(const float* xyz, int n, float voxel,
                             float* out, int capacity) {
  const int m = svn_downsample_stage(xyz, n, voxel, out, capacity);
  std::memset(out + 3 * m, 0, sizeof(float) * 3 * (capacity - m));
  return m;
}

// svn_downsample_one_stage carrying the kept rows' times, zero-padded; a
// null ts downsamples the points alone.
int svn_downsample_one_stage_ts(const float* xyz, const float* ts, int n,
                                float voxel, float* out, float* out_ts,
                                int capacity) {
  if (!ts) out_ts = nullptr;
  const int m = svn_downsample_stage(xyz, n, voxel, out, capacity, ts, out_ts);
  std::memset(out + 3 * m, 0, sizeof(float) * 3 * (capacity - m));
  if (out_ts) std::memset(out_ts + m, 0, sizeof(float) * (capacity - m));
  return m;
}

// to_map = one stage of the input at 0.5 * voxel, capped at map_capacity;
// source = one stage of to_map at 1.5 * voxel, capped at src_capacity. Both
// zero-padded to their capacities; the counts go to n_map and n_src.
void svn_downsample_two_stage(const float* xyz, int n, float voxel,
                              float* out_map, int map_capacity, int* n_map,
                              float* out_src, int src_capacity, int* n_src) {
  const int m = svn_downsample_stage(xyz, n, 0.5f * voxel, out_map, map_capacity);
  const int s = svn_downsample_stage(out_map, m, 1.5f * voxel, out_src, src_capacity);
  std::memset(out_map + 3 * m, 0, sizeof(float) * 3 * (map_capacity - m));
  std::memset(out_src + 3 * s, 0, sizeof(float) * 3 * (src_capacity - s));
  *n_map = m;
  *n_src = s;
}

// KITTI velodyne .bin (float32 x, y, z, intensity records) -> [n,3] in
// out_xyz, at most `capacity` points. Returns n, or -1 when the file
// cannot be opened.
int svn_read_kitti_bin(const char* path, float* out_xyz, int capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<float> buf(4096 * 4);
  int n = 0;
  size_t got;
  while ((got = std::fread(buf.data(), sizeof(float), buf.size(), f)) > 0) {
    const size_t pts = got / 4;
    for (size_t i = 0; i < pts && n < capacity; ++i) {
      out_xyz[3 * n + 0] = buf[4 * i + 0];
      out_xyz[3 * n + 1] = buf[4 * i + 1];
      out_xyz[3 * n + 2] = buf[4 * i + 2];
      ++n;
    }
    if (n >= capacity) break;
  }
  std::fclose(f);
  return n;
}

// Per-point times of n interleaved records (`stride` bytes each, the field
// at `offset`; dtype_code 0 = float32, 1 = float64, 2 = uint32), min-max
// normalised to [0,1] in double before the float32 narrowing (epoch stamps
// keep their intra-sweep range). Returns 1, 0 when all times are equal
// (out untouched), -1 for an unknown dtype code.
int svn_extract_timestamps(const uint8_t* data, int n, int stride, int offset,
                           int dtype_code, float* out) {
  if (dtype_code < 0 || dtype_code > 2) return -1;
  double mn = 1e300, mx = -1e300;
  for (int i = 0; i < n; ++i) {
    const double v = svn_ts_read(data + (size_t)i * stride + offset, dtype_code);
    if (v < mn) mn = v;
    if (v > mx) mx = v;
  }
  if (!(mx > mn)) return 0;
  const double inv = 1.0 / (mx - mn);
  for (int i = 0; i < n; ++i) {
    const double v = svn_ts_read(data + (size_t)i * stride + offset, dtype_code);
    out[i] = (float)((v - mn) * inv);
  }
  return 1;
}

// Lock-free SPSC ring of fixed-size scan slots: one producer thread feeds
// scans, one consumer drains them. A full ring refuses the push (the
// producer retries); a scan longer than a slot keeps its first
// slot_floats / 3 points.
struct SvnRing {
  int slots;
  int slot_floats;
  std::vector<float> data;        // [slots * slot_floats]
  std::vector<double> stamps;     // [slots]
  std::vector<int> counts;        // [slots]
  std::atomic<uint64_t> head{0};  // next write
  std::atomic<uint64_t> tail{0};  // next read
};

void* svn_ring_create(int slots, int slot_floats) {
  auto* r = new SvnRing();
  r->slots = slots;
  r->slot_floats = slot_floats;
  r->data.resize((size_t)slots * slot_floats);
  r->stamps.resize(slots);
  r->counts.resize(slots);
  return r;
}

void svn_ring_destroy(void* h) { delete static_cast<SvnRing*>(h); }

int svn_ring_size(void* h) {
  auto* r = static_cast<SvnRing*>(h);
  return (int)(r->head.load(std::memory_order_acquire) -
               r->tail.load(std::memory_order_acquire));
}

// Push one scan of n points; returns 1, or 0 (nothing stored) when full.
int svn_ring_push(void* h, const float* xyz, int n, double stamp) {
  auto* r = static_cast<SvnRing*>(h);
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= (uint64_t)r->slots) return 0;
  const int slot = (int)(head % r->slots);
  const int m = n * 3 <= r->slot_floats ? n : r->slot_floats / 3;
  std::memcpy(&r->data[(size_t)slot * r->slot_floats], xyz, sizeof(float) * 3 * m);
  r->counts[slot] = m;
  r->stamps[slot] = stamp;
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Pop the oldest scan into out_xyz and out_stamp; returns its point count,
// or -1 when the ring is empty.
int svn_ring_pop(void* h, float* out_xyz, double* out_stamp) {
  auto* r = static_cast<SvnRing*>(h);
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return -1;
  const int slot = (int)(tail % r->slots);
  const int n = r->counts[slot];
  std::memcpy(out_xyz, &r->data[(size_t)slot * r->slot_floats], sizeof(float) * 3 * n);
  *out_stamp = r->stamps[slot];
  r->tail.store(tail + 1, std::memory_order_release);
  return n;
}

}  // extern "C"
