// Memory-mapped record store: the training data layer's frame store.
//
// Counterpart of `vsc22_tpu/native/recordstore.cpp`, the same file format
// and entry points, so that a store written by either package reads in
// the other. Built by `kernels/build.host_library("recordstore")` with g++
// at first use and bound with ctypes by `data/store.py`.
//
// File format (little-endian):
//   [0:8)   magic "VSCREC01"
//   [8:16)  u64 record count N
//   [16:16+8*(N+1)) u64 offsets (relative to payload start), offsets[N] = payload size
//   [...]   payload blob
//
// The reader mmaps the whole file (shared, read-only) so the page cache is
// shared across dataloader workers and reads take no locks and no GIL
// (called via ctypes). Batch reads fan out with a small thread pool.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'V', 'S', 'C', 'R', 'E', 'C', '0', '1'};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;  // mmap base
  size_t file_size = 0;
  uint64_t count = 0;
  const uint64_t* offsets = nullptr;  // N+1 entries
  const uint8_t* payload = nullptr;
};

}  // namespace

extern "C" {

Store* rs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < 16) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* b = static_cast<const uint8_t*>(base);
  if (memcmp(b, kMagic, 8) != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  uint64_t count;
  memcpy(&count, b + 8, 8);
  // A truncated or foreign file must not send a read past the mapping.
  const size_t size = static_cast<size_t>(st.st_size);
  const uint64_t max_count = (size - 16) / 8;
  const uint64_t* offsets = reinterpret_cast<const uint64_t*>(b + 16);
  if (count >= max_count || offsets[count] > size - 16 - 8 * (count + 1)) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->fd = fd;
  s->base = b;
  s->file_size = size;
  s->count = count;
  s->offsets = offsets;
  s->payload = b + 16 + 8 * (count + 1);
  return s;
}

void rs_close(Store* s) {
  if (!s) return;
  if (s->base) munmap(const_cast<uint8_t*>(s->base), s->file_size);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

int64_t rs_num_records(Store* s) { return s ? static_cast<int64_t>(s->count) : -1; }

int64_t rs_record_size(Store* s, int64_t i) {
  if (!s || i < 0 || static_cast<uint64_t>(i) >= s->count) return -1;
  return static_cast<int64_t>(s->offsets[i + 1] - s->offsets[i]);
}

// Copy record i into buf; returns bytes copied or -1.
int64_t rs_read(Store* s, int64_t i, uint8_t* buf, int64_t buflen) {
  int64_t size = rs_record_size(s, i);
  if (size < 0 || size > buflen) return -1;
  memcpy(buf, s->payload + s->offsets[i], size);
  return size;
}

// Zero-copy pointer to record i (valid while the store is open).
const uint8_t* rs_data_ptr(Store* s, int64_t i, int64_t* size_out) {
  int64_t size = rs_record_size(s, i);
  if (size < 0) return nullptr;
  if (size_out) *size_out = size;
  return s->payload + s->offsets[i];
}

// Batch copy: record indices[j] lands at out + out_offsets[j]. The caller
// sizes out via rs_record_size. Parallel across a small thread pool.
int64_t rs_read_batch(Store* s, const int64_t* indices, int64_t n,
                      uint8_t* out, const int64_t* out_offsets, int num_threads) {
  if (!s || n < 0) return -1;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> bad(0);
  int workers = num_threads > 0 ? num_threads : 4;
  if (workers > n) workers = n > 0 ? static_cast<int>(n) : 1;
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (int64_t j = next.fetch_add(1); j < n; j = next.fetch_add(1)) {
        int64_t i = indices[j];
        int64_t size = rs_record_size(s, i);
        if (size < 0) {
          bad.fetch_add(1);
          continue;
        }
        memcpy(out + out_offsets[j], s->payload + s->offsets[i], size);
      }
    });
  }
  for (auto& th : pool) th.join();
  return bad.load() == 0 ? n : -1;
}

}  // extern "C"
