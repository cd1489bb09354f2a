// Shared-memory MPMC ring buffer for DataLoader batch transport — the
// JAX package's paddle_tpu/native/src/shm_ring.cc, built on its own here
// (g++, at first use) so the port needs nothing of that package.
//
// POSIX shm_open + mmap region holding a process-shared, robust
// mutex/condvar-guarded byte ring of length-prefixed records. Workers push
// a pickled header + raw numpy payload; the parent pops without a
// Python-level pickle of the bulk data.

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdio>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

namespace ptnative {
namespace {

constexpr uint64_t kMagic = 0x70745F72696E6701ULL;  // "pt_ring\1"

struct RingHdr {
  uint64_t magic;
  int64_t capacity;  // payload region bytes
  int64_t head;      // monotonically increasing write offset
  int64_t tail;      // monotonically increasing read offset
  int32_t closed;
  int32_t _pad;
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
};

struct Ring {
  RingHdr* hdr;
  uint8_t* data;
  size_t map_len;
  std::string name;
  bool owner;
};

int64_t used(const RingHdr* h) { return h->head - h->tail; }

void copy_in(Ring* r, int64_t offset, const uint8_t* src, int64_t len) {
  int64_t cap = r->hdr->capacity;
  int64_t pos = offset % cap;
  int64_t first = std::min(len, cap - pos);
  std::memcpy(r->data + pos, src, static_cast<size_t>(first));
  if (first < len) std::memcpy(r->data, src + first, static_cast<size_t>(len - first));
}

void copy_out(Ring* r, int64_t offset, uint8_t* dst, int64_t len) {
  int64_t cap = r->hdr->capacity;
  int64_t pos = offset % cap;
  int64_t first = std::min(len, cap - pos);
  std::memcpy(dst, r->data + pos, static_cast<size_t>(first));
  if (first < len) std::memcpy(dst + first, r->data, static_cast<size_t>(len - first));
}

bool timed_wait(pthread_cond_t* cv, pthread_mutex_t* mu, int timeout_ms) {
  if (timeout_ms < 0) {
    pthread_cond_wait(cv, mu);
    return true;
  }
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return pthread_cond_timedwait(cv, mu, &ts) == 0;
}

}  // namespace
}  // namespace ptnative

using ptnative::Ring;
using ptnative::RingHdr;

PT_EXPORT void* pt_shmring_create(const char* name, long long capacity) {
  ::shm_unlink(name);  // stale segment from a crashed run
  int fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t map_len = sizeof(RingHdr) + static_cast<size_t>(capacity);
  if (::ftruncate(fd, static_cast<off_t>(map_len)) != 0) {
    ::close(fd);
    ::shm_unlink(name);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) {
    ::shm_unlink(name);
    return nullptr;
  }
  auto* hdr = static_cast<RingHdr*>(mem);
  std::memset(hdr, 0, sizeof(RingHdr));
  hdr->capacity = capacity;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_empty, &ca);
  pthread_cond_init(&hdr->not_full, &ca);
  hdr->magic = ptnative::kMagic;

  auto* r = new Ring{hdr, static_cast<uint8_t*>(mem) + sizeof(RingHdr), map_len, name, true};
  return r;
}

PT_EXPORT void* pt_shmring_attach(const char* name) {
  int fd = ::shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<RingHdr*>(mem);
  if (hdr->magic != ptnative::kMagic) {
    ::munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* r = new Ring{hdr, static_cast<uint8_t*>(mem) + sizeof(RingHdr),
                     static_cast<size_t>(st.st_size), name, false};
  return r;
}

// 0 ok, -1 timeout/closed, -2 record larger than capacity.
PT_EXPORT int pt_shmring_push(void* rv, const uint8_t* payload, long long len,
                              int timeout_ms) {
  auto* r = static_cast<Ring*>(rv);
  RingHdr* h = r->hdr;
  int64_t need = 8 + len;
  if (need > h->capacity) return -2;
  if (pthread_mutex_lock(&h->mu) == EOWNERDEAD) pthread_mutex_consistent(&h->mu);
  while (!h->closed && h->capacity - ptnative::used(h) < need) {
    if (!ptnative::timed_wait(&h->not_full, &h->mu, timeout_ms)) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -1;
  }
  int64_t len64 = len;
  ptnative::copy_in(r, h->head, reinterpret_cast<uint8_t*>(&len64), 8);
  ptnative::copy_in(r, h->head + 8, payload, len);
  h->head += need;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Returns payload length (>=0, buffer malloc'd into *out — free with pt_free),
// -1 on timeout, -3 when closed and drained.
PT_EXPORT long long pt_shmring_pop(void* rv, uint8_t** out, int timeout_ms) {
  auto* r = static_cast<Ring*>(rv);
  RingHdr* h = r->hdr;
  if (pthread_mutex_lock(&h->mu) == EOWNERDEAD) pthread_mutex_consistent(&h->mu);
  while (ptnative::used(h) == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -3;
    }
    if (!ptnative::timed_wait(&h->not_empty, &h->mu, timeout_ms)) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  int64_t len;
  ptnative::copy_out(r, h->tail, reinterpret_cast<uint8_t*>(&len), 8);
  *out = static_cast<uint8_t*>(std::malloc(len > 0 ? static_cast<size_t>(len) : 1));
  ptnative::copy_out(r, h->tail + 8, *out, len);
  h->tail += 8 + len;
  pthread_cond_signal(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  return len;
}

PT_EXPORT long long pt_shmring_size(void* rv) {
  auto* r = static_cast<Ring*>(rv);
  return ptnative::used(r->hdr);
}

PT_EXPORT void pt_shmring_close(void* rv) {
  // Mark closed and wake waiters; detach mapping. Does not unlink the segment.
  auto* r = static_cast<Ring*>(rv);
  RingHdr* h = r->hdr;
  if (pthread_mutex_lock(&h->mu) == EOWNERDEAD) pthread_mutex_consistent(&h->mu);
  h->closed = 1;
  pthread_cond_broadcast(&h->not_empty);
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mu);
  ::munmap(h, r->map_len);
  delete r;
}

PT_EXPORT void pt_shmring_detach(void* rv) {
  auto* r = static_cast<Ring*>(rv);
  ::munmap(r->hdr, r->map_len);
  delete r;
}

PT_EXPORT void pt_shmring_unlink(const char* name) { ::shm_unlink(name); }

// Frees a record returned by pt_shmring_pop.
PT_EXPORT void pt_shmring_free(void* p) { std::free(p); }
