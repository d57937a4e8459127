// tpuslam native runtime: binary scan-log codec + playback cursor.
//
// The reference's "data plane" is ROS1: rosbag files played through TCPROS
// into subscriber callbacks (every lesson*/launch/*.launch ends with a
// `rosbag play` node).  tpuslam replaces that with a compact binary scan-log
// format decoded by this C library (loaded via ctypes) so host-side ingest
// never bottlenecks the device's step loop.  The port's copy of
// csrc/scanlog.cc: tpuslam_torch/io/_native.py builds it with the host C++
// compiler, and tpuslam_torch/io/bag.py's codec="python" is the plain
// version with the same bytes.
//
// Format (little-endian):
//   header:  magic "TSLG" | u32 version=1 | u32 num_beams | u32 num_records
//            f32 angle_min | f32 angle_increment | f32 range_min
//            f32 range_max | f32 time_increment
//   record:  f64 stamp | f32 odom[3] | f32 imu_wz | f32 ranges[num_beams]
//
// Exposed C ABI (all return 0 on success, negative on error):
//   tslg_write(path, header..., stamps, odom, imu_wz, ranges) -> int
//   tslg_open(path, out_header[8 floats as doubles], out_counts[2]) -> handle
//   tslg_read(handle, start, count, out_stamps, out_odom, out_wz, out_ranges)
//   tslg_close(handle)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr char kMagic[4] = {'T', 'S', 'L', 'G'};
constexpr uint32_t kVersion = 1;

struct Header {
  char magic[4];
  uint32_t version;
  uint32_t num_beams;
  uint32_t num_records;
  float angle_min;
  float angle_increment;
  float range_min;
  float range_max;
  float time_increment;
};

struct LogHandle {
  FILE* f = nullptr;
  Header h{};
  long data_start = 0;
  size_t record_bytes = 0;
};

}  // namespace

extern "C" {

int tslg_write(const char* path, uint32_t num_beams, uint32_t num_records,
               float angle_min, float angle_increment, float range_min,
               float range_max, float time_increment, const double* stamps,
               const float* odom /* [n,3] */, const float* imu_wz /* [n] */,
               const float* ranges /* [n, num_beams] */) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  Header h{};
  std::memcpy(h.magic, kMagic, 4);
  h.version = kVersion;
  h.num_beams = num_beams;
  h.num_records = num_records;
  h.angle_min = angle_min;
  h.angle_increment = angle_increment;
  h.range_min = range_min;
  h.range_max = range_max;
  h.time_increment = time_increment;
  if (std::fwrite(&h, sizeof(h), 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  for (uint32_t i = 0; i < num_records; ++i) {
    if (std::fwrite(&stamps[i], sizeof(double), 1, f) != 1 ||
        std::fwrite(&odom[3 * i], sizeof(float), 3, f) != 3 ||
        std::fwrite(&imu_wz[i], sizeof(float), 1, f) != 1 ||
        std::fwrite(&ranges[(size_t)i * num_beams], sizeof(float), num_beams,
                    f) != num_beams) {
      std::fclose(f);
      return -3;
    }
  }
  // fclose flushes the buffered tail: a full disk / failed write-back
  // surfaces HERE, and silently returning 0 would report a truncated
  // log as written
  if (std::fclose(f) != 0) return -3;
  return 0;
}

void* tslg_open(const char* path, double* out_meta /* [5] */,
                int64_t* out_counts /* [2]: num_beams, num_records */) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Header h{};
  if (std::fread(&h, sizeof(h), 1, f) != 1 ||
      std::memcmp(h.magic, kMagic, 4) != 0 || h.version != kVersion) {
    std::fclose(f);
    return nullptr;
  }
  auto* handle = new LogHandle();
  handle->f = f;
  handle->h = h;
  handle->data_start = static_cast<long>(sizeof(Header));
  handle->record_bytes =
      sizeof(double) + 4 * sizeof(float) + h.num_beams * sizeof(float);
  out_meta[0] = h.angle_min;
  out_meta[1] = h.angle_increment;
  out_meta[2] = h.range_min;
  out_meta[3] = h.range_max;
  out_meta[4] = h.time_increment;
  out_counts[0] = h.num_beams;
  out_counts[1] = h.num_records;
  return handle;
}

int tslg_read(void* vh, int64_t start, int64_t count, double* out_stamps,
              float* out_odom, float* out_wz, float* out_ranges) {
  auto* h = static_cast<LogHandle*>(vh);
  if (!h || !h->f) return -1;
  if (start < 0 || count < 0 ||
      static_cast<uint64_t>(start + count) > h->h.num_records)
    return -2;
  if (std::fseek(h->f, h->data_start + start * (long)h->record_bytes,
                 SEEK_SET) != 0)
    return -3;
  const uint32_t nb = h->h.num_beams;
  for (int64_t i = 0; i < count; ++i) {
    if (std::fread(&out_stamps[i], sizeof(double), 1, h->f) != 1 ||
        std::fread(&out_odom[3 * i], sizeof(float), 3, h->f) != 3 ||
        std::fread(&out_wz[i], sizeof(float), 1, h->f) != 1 ||
        std::fread(&out_ranges[(size_t)i * nb], sizeof(float), nb, h->f) != nb)
      return -4;
  }
  return 0;
}

int tslg_close(void* vh) {
  auto* h = static_cast<LogHandle*>(vh);
  if (!h) return -1;
  if (h->f) std::fclose(h->f);
  delete h;
  return 0;
}

}  // extern "C"
