// Shared-memory SPSC streaming channel — the native data plane for
// streaming edges between co-located operator instances.
//
// Reference counterpart: streaming/src/channel.h + data_writer.cc /
// data_reader.cc + ring_buffer.cc: a bounded queue on shared memory with
// flow control by capacity, seq-ordered messages, and EOF propagation.
// Re-designed for this runtime: one POSIX shm segment per edge, a
// single-producer/single-consumer byte ring with atomic head/tail (no
// locks on the data path), message framing [u32 len][bytes], and a wrap
// marker so messages stay contiguous for zero-copy reads on the consumer
// side. Backpressure IS the ring: a writer with no room spins with
// backoff until the reader drains (the reference's credit exhaustion).
//
// Single-writer/single-reader is a hard precondition (one channel per
// graph edge instance, like the reference's per-queue writer/reader).

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

constexpr uint64_t kChanMagic = 0x5450554348414e31ULL;  // "TPUCHAN1"
constexpr uint32_t kWrapMarker = 0xFFFFFFFFu;
constexpr uint32_t kFrame = sizeof(uint32_t);

struct ChanHeader {
  uint64_t magic;
  uint64_t capacity;                    // ring data bytes
  std::atomic<uint64_t> head;           // read offset  (consumer-owned)
  std::atomic<uint64_t> tail;           // write offset (producer-owned)
  std::atomic<uint32_t> closed;         // writer finished
  std::atomic<uint32_t> reader_dead;    // consumer gave up (error path)
  std::atomic<uint64_t> messages;       // total messages written (stats)
  uint8_t pad[16];
};

struct ChanHandle {
  uint8_t* base;
  uint64_t mapped;
  ChanHeader* hdr;
  uint8_t* data;
  bool owner;
  char name[256];
};

inline uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

inline void backoff(unsigned& spins) {
  if (spins < 64) {
    ++spins;
  } else {
    usleep(spins < 1024 ? 50 : 500);
    spins = spins < 1024 ? spins * 2 : spins;
  }
}

// Bytes available to read (contiguity handled by wrap markers).
inline uint64_t used(const ChanHeader* h) {
  return h->tail.load(std::memory_order_acquire) -
         h->head.load(std::memory_order_acquire);
}

}  // namespace

extern "C" {

void* tch_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  uint64_t total = sizeof(ChanHeader) + capacity;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = new (base) ChanHeader();
  hdr->capacity = capacity;
  hdr->head.store(0);
  hdr->tail.store(0);
  hdr->closed.store(0);
  hdr->reader_dead.store(0);
  hdr->messages.store(0);
  __sync_synchronize();
  hdr->magic = kChanMagic;

  auto* h = new ChanHandle();
  h->base = static_cast<uint8_t*>(base);
  h->mapped = total;
  h->hdr = hdr;
  h->data = h->base + sizeof(ChanHeader);
  h->owner = true;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

void* tch_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      st.st_size < static_cast<off_t>(sizeof(ChanHeader))) {
    close(fd);
    return nullptr;
  }
  uint64_t total = static_cast<uint64_t>(st.st_size);
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<ChanHeader*>(base);
  if (hdr->magic != kChanMagic) {
    munmap(base, total);
    return nullptr;
  }
  auto* h = new ChanHandle();
  h->base = static_cast<uint8_t*>(base);
  h->mapped = total;
  h->hdr = hdr;
  h->data = h->base + sizeof(ChanHeader);
  h->owner = false;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

// 0 = ok, -1 = timeout (ring full), -2 = closed, -3 = message too large.
int tch_write(void* handle, const uint8_t* payload, uint64_t len,
              uint64_t timeout_ms) {
  auto* h = static_cast<ChanHandle*>(handle);
  ChanHeader* hdr = h->hdr;
  uint64_t cap = hdr->capacity;
  uint64_t need = kFrame + len;
  if (need + kFrame > cap) return -3;  // must fit with room for a marker
  if (hdr->closed.load(std::memory_order_acquire)) return -2;

  uint64_t deadline = timeout_ms ? now_ms() + timeout_ms : 0;
  unsigned spins = 0;
  for (;;) {
    uint64_t tail = hdr->tail.load(std::memory_order_relaxed);
    uint64_t head = hdr->head.load(std::memory_order_acquire);
    uint64_t pos = tail % cap;
    uint64_t to_end = cap - pos;
    if (to_end < need) {
      // Frame would straddle the end: emit a wrap marker as its OWN step
      // once it fits, so the reader can consume it and free the burned
      // bytes before the message is attempted. (Checking marker+message
      // together can deadlock: burned-bytes + message may exceed the
      // capacity outright for messages > cap/2 at unlucky positions.)
      if (tail + to_end - head <= cap) {
        if (to_end >= kFrame) {
          uint32_t marker = kWrapMarker;
          std::memcpy(h->data + pos, &marker, kFrame);
        }
        hdr->tail.store(tail + to_end, std::memory_order_release);
        continue;  // progress made; retry from offset 0
      }
    } else if (tail + need - head <= cap) {
      std::memcpy(h->data + pos, &len, kFrame);
      std::memcpy(h->data + pos + kFrame, payload, len);
      hdr->tail.store(tail + need, std::memory_order_release);
      hdr->messages.fetch_add(1, std::memory_order_relaxed);
      return 0;
    }
    if (deadline && now_ms() > deadline) return -1;
    backoff(spins);
  }
}

// >= 0: message length copied into buf; -1 timeout; -2 closed + drained;
// -3 buf too small (message length returned via *needed).
int64_t tch_read(void* handle, uint8_t* buf, uint64_t buf_len,
                 uint64_t timeout_ms, uint64_t* needed) {
  auto* h = static_cast<ChanHandle*>(handle);
  ChanHeader* hdr = h->hdr;
  uint64_t cap = hdr->capacity;
  uint64_t deadline = timeout_ms ? now_ms() + timeout_ms : 0;
  unsigned spins = 0;
  for (;;) {
    uint64_t head = hdr->head.load(std::memory_order_relaxed);
    uint64_t tail = hdr->tail.load(std::memory_order_acquire);
    if (tail != head) {
      uint64_t pos = head % cap;
      uint64_t to_end = cap - pos;
      uint32_t len;
      if (to_end < kFrame) {
        // unreadable tail sliver: writer wrapped without a marker
        hdr->head.store(head + to_end, std::memory_order_release);
        continue;
      }
      std::memcpy(&len, h->data + pos, kFrame);
      if (len == kWrapMarker) {
        hdr->head.store(head + to_end, std::memory_order_release);
        continue;
      }
      if (len > buf_len) {
        if (needed) *needed = len;
        return -3;
      }
      std::memcpy(buf, h->data + pos + kFrame, len);
      hdr->head.store(head + kFrame + len, std::memory_order_release);
      return static_cast<int64_t>(len);
    }
    if (hdr->closed.load(std::memory_order_acquire)) return -2;
    if (deadline && now_ms() > deadline) return -1;
    backoff(spins);
  }
}

uint64_t tch_pending_bytes(void* handle) {
  return used(static_cast<ChanHandle*>(handle)->hdr);
}

uint64_t tch_total_messages(void* handle) {
  return static_cast<ChanHandle*>(handle)->hdr->messages.load();
}

void tch_close_write(void* handle) {
  static_cast<ChanHandle*>(handle)
      ->hdr->closed.store(1, std::memory_order_release);
}

// Consumer error path: tells the (possibly blocked) writer that no one
// will ever drain this ring again.
void tch_mark_reader_dead(void* handle) {
  static_cast<ChanHandle*>(handle)
      ->hdr->reader_dead.store(1, std::memory_order_release);
}

int tch_reader_dead(void* handle) {
  return static_cast<int>(
      static_cast<ChanHandle*>(handle)
          ->hdr->reader_dead.load(std::memory_order_acquire));
}

// Unmap; the reader side unlinks the segment (it outlives the writer).
void tch_close(void* handle, int unlink_segment) {
  auto* h = static_cast<ChanHandle*>(handle);
  munmap(h->base, h->mapped);
  if (unlink_segment) shm_unlink(h->name);
  delete h;
}

}  // extern "C"
