// The port's copy of the JAX package's native/clipcache.cpp, unchanged but for
// this note: built by data/clip_cache.py into build/native/ at first use.
// The shard format is the same, so either package reads the other's shards.
//
// Packed uint8 clip-cache: the native data-runtime component.
//
// The reference re-decoded every video fully on every epoch
// (reference train.py:160-172, 257-269 — the #1 hot loop, SURVEY.md §3.1).
// This library implements a decode-once store: staged uint8 clips are
// packed into one shard file; later epochs stream them back with
// multi-threaded pread entirely outside the Python GIL.
//
// File layout (little-endian):
//   [0..7]   magic  "CSECC01\0"
//   [8..15]  uint64 num_clips
//   [16..23] uint64 index_offset
//   [24..]   clip blobs (raw uint8, back to back)
//   [index_offset..] num_clips index entries:
//       uint64 offset, uint64 nbytes, uint32 t,h,w,c, int32 label, int32 pad
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'C', 'S', 'E', 'C', 'C', '0', '1', '\0'};

struct IndexEntry {
  uint64_t offset;
  uint64_t nbytes;
  uint32_t t, h, w, c;
  int32_t label;
  int32_t pad;
};
static_assert(sizeof(IndexEntry) == 40, "index entry must be 40 bytes");

struct Reader {
  int fd = -1;
  std::vector<IndexEntry> index;
};

struct Writer {
  FILE* f = nullptr;
  std::vector<IndexEntry> index;
  uint64_t cursor = 24;  // after header
};

bool pread_all(int fd, void* buf, size_t n, off_t off) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = pread(fd, p, n, off);
    if (r <= 0) return false;
    p += r;
    off += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- writer

void* cc_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  char header[24] = {0};
  memcpy(header, kMagic, 8);
  if (fwrite(header, 1, 24, f) != 24) {
    fclose(f);
    return nullptr;
  }
  Writer* w = new Writer();
  w->f = f;
  return w;
}

int cc_writer_add(void* handle, const unsigned char* data, uint32_t t,
                  uint32_t h, uint32_t wd, uint32_t c, int32_t label) {
  Writer* w = static_cast<Writer*>(handle);
  uint64_t nbytes = (uint64_t)t * h * wd * c;
  if (fwrite(data, 1, nbytes, w->f) != nbytes) return -1;
  IndexEntry e{w->cursor, nbytes, t, h, wd, c, label, 0};
  w->index.push_back(e);
  w->cursor += nbytes;
  return static_cast<int>(w->index.size() - 1);
}

int cc_writer_finish(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  uint64_t index_offset = w->cursor;
  uint64_t n = w->index.size();
  if (fwrite(w->index.data(), sizeof(IndexEntry), n, w->f) != n) return -1;
  // back-patch header
  if (fseek(w->f, 8, SEEK_SET) != 0) return -1;
  if (fwrite(&n, 8, 1, w->f) != 1) return -1;
  if (fwrite(&index_offset, 8, 1, w->f) != 1) return -1;
  fclose(w->f);
  delete w;
  return 0;
}

// ---------------------------------------------------------------- reader

void* cc_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  char header[24];
  if (!pread_all(fd, header, 24, 0) || memcmp(header, kMagic, 8) != 0) {
    close(fd);
    return nullptr;
  }
  uint64_t n, index_offset;
  memcpy(&n, header + 8, 8);
  memcpy(&index_offset, header + 16, 8);
  Reader* r = new Reader();
  r->fd = fd;
  r->index.resize(n);
  if (!pread_all(fd, r->index.data(), n * sizeof(IndexEntry),
                 static_cast<off_t>(index_offset))) {
    close(fd);
    delete r;
    return nullptr;
  }
  return r;
}

int64_t cc_num_clips(void* handle) {
  return static_cast<Reader*>(handle)->index.size();
}

// shape out: [t, h, w, c, label, nbytes_lo32] — label via shape[4]
int cc_clip_shape(void* handle, int64_t idx, uint32_t* out) {
  Reader* r = static_cast<Reader*>(handle);
  if (idx < 0 || idx >= (int64_t)r->index.size()) return -1;
  const IndexEntry& e = r->index[idx];
  out[0] = e.t;
  out[1] = e.h;
  out[2] = e.w;
  out[3] = e.c;
  out[4] = static_cast<uint32_t>(e.label);
  out[5] = static_cast<uint32_t>(e.nbytes & 0xffffffffu);
  return 0;
}

int cc_read_clip(void* handle, int64_t idx, unsigned char* out) {
  Reader* r = static_cast<Reader*>(handle);
  if (idx < 0 || idx >= (int64_t)r->index.size()) return -1;
  const IndexEntry& e = r->index[idx];
  return pread_all(r->fd, out, e.nbytes, static_cast<off_t>(e.offset)) ? 0 : -1;
}

// Batched multi-threaded read: each clip lands at out + i*clip_stride.
// Returns 0 on success, -1 if any read failed or a clip exceeds the stride.
int cc_read_batch(void* handle, const int64_t* indices, int64_t n,
                  unsigned char* out, uint64_t clip_stride, int num_threads) {
  Reader* r = static_cast<Reader*>(handle);
  if (num_threads < 1) num_threads = 1;
  std::vector<int> status(static_cast<size_t>(n), 0);

  auto worker = [&](int tid) {
    for (int64_t i = tid; i < n; i += num_threads) {
      int64_t idx = indices[i];
      if (idx < 0 || idx >= (int64_t)r->index.size()) {
        status[i] = -1;
        continue;
      }
      const IndexEntry& e = r->index[idx];
      if (e.nbytes > clip_stride) {
        status[i] = -1;
        continue;
      }
      if (!pread_all(r->fd, out + (uint64_t)i * clip_stride, e.nbytes,
                     static_cast<off_t>(e.offset))) {
        status[i] = -1;
      }
    }
  };

  std::vector<std::thread> threads;
  for (int tidx = 0; tidx < num_threads; ++tidx) threads.emplace_back(worker, tidx);
  for (auto& th : threads) th.join();
  for (int st : status)
    if (st != 0) return -1;
  return 0;
}

void cc_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  close(r->fd);
  delete r;
}

}  // extern "C"
