// Shared-memory SPSC ring buffer: the env farm's host transport.
//
// Each env worker process of native/shm_env.py owns two lock-free
// single-producer/single-consumer rings in POSIX shared memory (actions in,
// observations out).  The evaluator copies fixed-layout float32 payloads
// straight out of shared memory into its batch arrays: no pickling, no pipe
// syscalls on the hot path, one memcpy per message.
//
// Layout: [Header | slot 0 | slot 1 | ... ].  head/tail are C++11 atomics
// with acquire/release ordering; the producer waits when the ring is full,
// the consumer when it is empty (spin + usleep backoff: message rates here
// are kHz, not MHz).
//
// The segment is backed when it is created (posix_fallocate): a /dev/shm
// too small for the rings fails rb_create with ENOSPC in errno, instead of
// a SIGBUS in a worker at its first write past the backed pages.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libshm_ring.so shm_ring.cpp -lrt
// (done at first use by pointnav_vo_tpu_torch/native/__init__.py)

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <new>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

struct Header {
  std::atomic<uint64_t> head;  // next slot the producer writes
  std::atomic<uint64_t> tail;  // next slot the consumer reads
  uint64_t slots;
  uint64_t slot_bytes;
};

inline char* slot_ptr(void* rb, uint64_t idx) {
  Header* h = static_cast<Header*>(rb);
  return reinterpret_cast<char*>(rb) + sizeof(Header) +
         (idx % h->slots) * h->slot_bytes;
}

inline bool deadline_passed(const timespec& deadline) {
  timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  return now.tv_sec > deadline.tv_sec ||
         (now.tv_sec == deadline.tv_sec && now.tv_nsec >= deadline.tv_nsec);
}

inline timespec make_deadline(int timeout_ms) {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  t.tv_sec += timeout_ms / 1000;
  t.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (t.tv_nsec >= 1000000000L) {
    t.tv_sec += 1;
    t.tv_nsec -= 1000000000L;
  }
  return t;
}

// close and remove a half-made segment, keeping the error for the caller
void* fail_create(int fd, const char* name, int err) {
  close(fd);
  shm_unlink(name);
  errno = err;
  return nullptr;
}

}  // namespace

extern "C" {

// returns the mapped ring, or nullptr with errno set; a name that exists
// already fails with EEXIST (a live segment is never taken over)
void* rb_create(const char* name, uint64_t slots, uint64_t slot_bytes) {
  int fd = shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  size_t size = sizeof(Header) + slots * slot_bytes;
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    return fail_create(fd, name, errno);
  }
  // posix_fallocate returns its error instead of setting errno
  int rc = posix_fallocate(fd, 0, static_cast<off_t>(size));
  if (rc != 0) return fail_create(fd, name, rc);
  void* p = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) return fail_create(fd, name, errno);
  close(fd);
  Header* h = new (p) Header();
  h->head.store(0, std::memory_order_relaxed);
  h->tail.store(0, std::memory_order_relaxed);
  h->slots = slots;
  h->slot_bytes = slot_bytes;
  return p;
}

void* rb_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  void* hp = mmap(nullptr, sizeof(Header), PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (hp == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* h = static_cast<Header*>(hp);
  size_t size = sizeof(Header) + h->slots * h->slot_bytes;
  munmap(hp, sizeof(Header));
  void* p = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  return p == MAP_FAILED ? nullptr : p;
}

// returns 0 on success, -1 on timeout, -2 on size mismatch
int rb_push(void* rb, const void* data, uint64_t nbytes, int timeout_ms) {
  Header* h = static_cast<Header*>(rb);
  if (nbytes > h->slot_bytes) return -2;
  timespec deadline = make_deadline(timeout_ms);
  uint64_t head = h->head.load(std::memory_order_relaxed);
  while (head - h->tail.load(std::memory_order_acquire) >= h->slots) {
    if (deadline_passed(deadline)) return -1;
    usleep(50);
  }
  std::memcpy(slot_ptr(rb, head), data, nbytes);
  h->head.store(head + 1, std::memory_order_release);
  return 0;
}

int rb_pop(void* rb, void* out, uint64_t nbytes, int timeout_ms) {
  Header* h = static_cast<Header*>(rb);
  if (nbytes > h->slot_bytes) return -2;
  timespec deadline = make_deadline(timeout_ms);
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  while (h->head.load(std::memory_order_acquire) <= tail) {
    if (deadline_passed(deadline)) return -1;
    usleep(50);
  }
  std::memcpy(out, slot_ptr(rb, tail), nbytes);
  h->tail.store(tail + 1, std::memory_order_release);
  return 0;
}

uint64_t rb_size(void* rb) {
  Header* h = static_cast<Header*>(rb);
  return h->head.load(std::memory_order_acquire) -
         h->tail.load(std::memory_order_acquire);
}

void rb_detach(void* rb) {
  Header* h = static_cast<Header*>(rb);
  size_t size = sizeof(Header) + h->slots * h->slot_bytes;
  munmap(rb, size);
}

void rb_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
