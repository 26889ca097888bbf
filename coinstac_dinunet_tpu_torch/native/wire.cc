// coinnwire — the port's native runtime for the tensor-wire transport.
//
// The port's own copy of the JAX package's native/wire.cc, byte-compatible
// with it: the same file bytes from the gather-write and the same 64-bit
// checksum.  It is host C++ (no device code), built with g++ at first use
// by native/__init__.py into coinstac_dinunet_tpu_torch/_build/ and loaded
// with ctypes.  The engine transport moves multi-hundred-MB gradient
// payloads per round through the filesystem, and the aggregator loads one
// payload per site every round:
//
//   - coinn_pack_file: a gather-write (writev) of
//     [magic | manifest-len | manifest | raw buffers] with no join-copy of
//     the payload;
//   - coinn_load_file / coinn_load_many: posix_fadvise(SEQUENTIAL) bulk
//     reads, fanned out on std::thread (at most the host's hardware threads
//     at a time) for the many-site case, with no GIL and no process pool;
//   - coinn_checksum: a 64-bit payload checksum, for transports that want
//     to verify payloads (the wire format embeds a CRC32 of its own).
//
// A plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- checksum
// 64-bit mix-based rolling checksum (wyhash-style multiply-fold; not crypto).
uint64_t coinn_checksum(const uint8_t* buf, uint64_t len) {
  const uint64_t k0 = 0x9e3779b97f4a7c15ull, k1 = 0xbf58476d1ce4e5b9ull;
  uint64_t h = len * k0;
  uint64_t i = 0;
  for (; i + 8 <= len; i += 8) {
    uint64_t w;
    std::memcpy(&w, buf + i, 8);
    h = (h ^ w) * k1;
    h ^= h >> 29;
  }
  uint64_t tail = 0;
  for (uint64_t j = 0; i + j < len; ++j) tail |= uint64_t(buf[i + j]) << (8 * j);
  h = (h ^ tail) * k0;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------------- write
// Gather-write n_bufs buffers after a header; returns 0 on success, -errno.
int coinn_pack_file(const char* path, const uint8_t* header, uint64_t header_len,
                    const uint8_t** bufs, const uint64_t* sizes, int32_t n_bufs) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  std::vector<iovec> iov;
  iov.reserve(size_t(n_bufs) + 1);
  iov.push_back({const_cast<uint8_t*>(header), size_t(header_len)});
  for (int32_t i = 0; i < n_bufs; ++i)
    iov.push_back({const_cast<uint8_t*>(bufs[i]), size_t(sizes[i])});
  // writev caps at IOV_MAX entries; loop over chunks, resuming partial writes
  size_t idx = 0;
  while (idx < iov.size()) {
    size_t n = std::min(iov.size() - idx, size_t(512));
    ssize_t wrote = ::writev(fd, iov.data() + idx, int(n));
    if (wrote < 0) {
      ::close(fd);
      return -2;
    }
    size_t w = size_t(wrote);
    while (idx < iov.size() && w >= iov[idx].iov_len) {
      w -= iov[idx].iov_len;
      ++idx;
    }
    if (idx < iov.size() && w > 0) {
      iov[idx].iov_base = static_cast<uint8_t*>(iov[idx].iov_base) + w;
      iov[idx].iov_len -= w;
    }
  }
  ::close(fd);
  return 0;
}

// -------------------------------------------------------------------- read
// Reads the whole file into a malloc'd buffer. Returns size, 0 on failure.
// Caller frees with coinn_free.
uint64_t coinn_load_file(const char* path, uint8_t** out) {
  *out = nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return 0;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < 0) {
    ::close(fd);
    return 0;
  }
#ifdef POSIX_FADV_SEQUENTIAL
  ::posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
  uint64_t size = uint64_t(st.st_size);
  if (size == 0) {  // empty file: success, no buffer
    ::close(fd);
    return 0;
  }
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(size));
  if (!buf) {
    ::close(fd);
    return 0;
  }
  uint64_t off = 0;
  while (off < size) {
    ssize_t got = ::read(fd, buf + off, size - off);
    if (got <= 0) {
      std::free(buf);
      ::close(fd);
      return 0;
    }
    off += uint64_t(got);
  }
  ::close(fd);
  *out = buf;
  return size;
}

// Load n files concurrently (one thread per file, capped at hw threads).
// outs[i]/sizes[i] receive each file's buffer; sizes[i]==0 marks failure.
void coinn_load_many(const char** paths, int32_t n, uint8_t** outs,
                     uint64_t* sizes) {
  int32_t cap = int32_t(std::thread::hardware_concurrency());
  if (cap < 1) cap = 1;
  std::vector<std::thread> pool;
  for (int32_t start = 0; start < n; start += cap) {
    int32_t end = std::min(n, start + cap);
    pool.clear();
    for (int32_t i = start; i < end; ++i)
      pool.emplace_back([&, i] { sizes[i] = coinn_load_file(paths[i], &outs[i]); });
    for (auto& t : pool) t.join();
  }
}

void coinn_free(uint8_t* buf) { std::free(buf); }

int32_t coinn_abi_version() { return 1; }

}  // extern "C"
