// Shared-memory immutable object store — the plasma equivalent.
//
// Reference counterpart: src/ray/object_manager/plasma/ (store.cc, client.h,
// dlmalloc arena, eviction_policy.cc). Re-designed for this runtime:
// one POSIX shm segment per node that the node controller creates and every
// worker process on the host maps. Objects are immutable byte blobs keyed by
// a 24-byte ObjectID. The create/seal protocol matches plasma's (create an
// unsealed buffer, write into it, seal; gets only see sealed objects), but
// there is no socket protocol at all: all operations are direct calls into
// this library under a process-shared robust mutex, and readers get offsets
// into their own mapping of the segment (zero-copy).
//
// Layout:  [StoreHeader][slot table][data arena]
// Allocator: sorted-by-offset free list with split on allocate and
// coalesce on free. Eviction: LRU over sealed, unreferenced objects.

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5450555354523143ULL;  // "TPUSTR1C"
constexpr uint64_t kAlign = 64;                     // cache-line data alignment
constexpr uint32_t kIdLen = 24;  // matches ray_tpu_torch ObjectID.SIZE

enum SlotState : uint8_t { kEmpty = 0, kUsed = 1, kTombstone = 2 };

enum ReturnCode : int {
  kOk = 0,
  kNotFound = -1,
  kOutOfMemory = -2,
  kNotSealed = -3,
  kAlreadyExists = -4,
  kInUse = -5,
  kBadHandle = -6,
};

struct StoreHeader {
  uint64_t magic;
  uint64_t capacity;     // whole-segment bytes
  uint64_t table_off;
  uint32_t table_cap;    // power of two
  uint32_t ready;        // set to 1 once fully initialized
  uint64_t arena_off;
  uint64_t arena_size;
  uint64_t used_bytes;   // payload bytes of live objects
  uint64_t num_objects;
  uint64_t num_evictions;
  uint64_t lru_clock;
  uint64_t free_head;    // offset of first free block, 0 = none
  pthread_mutex_t mutex;
};

struct Slot {
  uint8_t id[kIdLen];
  uint8_t state;
  uint8_t sealed;
  uint8_t pending_delete;
  uint8_t pad[5];
  uint32_t refcount;
  uint64_t block_off;    // BlockHeader offset in segment
  uint64_t size;         // payload bytes
  uint64_t lru;
};

// Every arena block (free or allocated) starts with this header.
struct BlockHeader {
  uint64_t size;       // payload capacity, excluding this header
  uint64_t next_free;  // next free block offset (valid when free), 0 = end
  uint32_t is_free;
  uint32_t pad;
};

struct Handle {
  uint8_t* base;
  uint64_t mapped_size;
  StoreHeader* hdr;
  bool owner;
  char name[256];
};

inline Slot* slot_table(Handle* h) {
  return reinterpret_cast<Slot*>(h->base + h->hdr->table_off);
}

inline BlockHeader* block_at(Handle* h, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(h->base + off);
}

uint64_t hash_id(const uint8_t* id) {
  uint64_t hash = 14695981039346656037ULL;  // FNV-1a
  for (uint32_t i = 0; i < kIdLen; ++i) {
    hash ^= id[i];
    hash *= 1099511628211ULL;
  }
  return hash;
}

// Locks the store mutex, recovering the lock state if a holder died.
void lock(Handle* h) {
  int rc = pthread_mutex_lock(&h->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // Previous owner died mid-operation. The index/free list are only
    // mutated under the lock in short critical sections; mark consistent
    // and continue — worst case a block leaks until eviction pressure.
    pthread_mutex_consistent(&h->hdr->mutex);
  }
}

void unlock(Handle* h) { pthread_mutex_unlock(&h->hdr->mutex); }

// Finds the slot for id, or an insertion slot if insert=true. Linear probing.
Slot* find_slot(Handle* h, const uint8_t* id, bool insert) {
  Slot* table = slot_table(h);
  uint32_t mask = h->hdr->table_cap - 1;
  uint32_t idx = static_cast<uint32_t>(hash_id(id)) & mask;
  Slot* first_tomb = nullptr;
  for (uint32_t probe = 0; probe <= mask; ++probe, idx = (idx + 1) & mask) {
    Slot* s = &table[idx];
    if (s->state == kEmpty) {
      if (!insert) return nullptr;
      return first_tomb ? first_tomb : s;
    }
    if (s->state == kTombstone) {
      if (insert && !first_tomb) first_tomb = s;
      continue;
    }
    if (std::memcmp(s->id, id, kIdLen) == 0) return s;
  }
  return insert ? first_tomb : nullptr;
}

uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

// Allocates a block with >= size payload bytes. First fit over the sorted
// free list; splits when the remainder can hold a minimal block.
uint64_t alloc_block(Handle* h, uint64_t size) {
  size = align_up(size, kAlign);
  uint64_t prev_off = 0;
  uint64_t off = h->hdr->free_head;
  while (off != 0) {
    BlockHeader* b = block_at(h, off);
    if (b->size >= size) {
      uint64_t remainder = b->size - size;
      if (remainder >= sizeof(BlockHeader) + kAlign) {
        // Split: tail becomes a new free block.
        uint64_t tail_off = off + sizeof(BlockHeader) + size;
        BlockHeader* tail = block_at(h, tail_off);
        tail->size = remainder - sizeof(BlockHeader);
        tail->next_free = b->next_free;
        tail->is_free = 1;
        b->size = size;
        if (prev_off == 0) {
          h->hdr->free_head = tail_off;
        } else {
          block_at(h, prev_off)->next_free = tail_off;
        }
      } else {
        if (prev_off == 0) {
          h->hdr->free_head = b->next_free;
        } else {
          block_at(h, prev_off)->next_free = b->next_free;
        }
      }
      b->is_free = 0;
      b->next_free = 0;
      return off;
    }
    prev_off = off;
    off = b->next_free;
  }
  return 0;
}

// Returns a block to the free list (kept sorted by offset) and coalesces
// with adjacent free blocks.
void free_block(Handle* h, uint64_t off) {
  BlockHeader* b = block_at(h, off);
  b->is_free = 1;
  uint64_t prev_off = 0;
  uint64_t cur = h->hdr->free_head;
  while (cur != 0 && cur < off) {
    prev_off = cur;
    cur = block_at(h, cur)->next_free;
  }
  b->next_free = cur;
  if (prev_off == 0) {
    h->hdr->free_head = off;
  } else {
    block_at(h, prev_off)->next_free = off;
  }
  // Coalesce with successor.
  if (cur != 0 && off + sizeof(BlockHeader) + b->size == cur) {
    BlockHeader* next = block_at(h, cur);
    b->size += sizeof(BlockHeader) + next->size;
    b->next_free = next->next_free;
  }
  // Coalesce with predecessor.
  if (prev_off != 0) {
    BlockHeader* prev = block_at(h, prev_off);
    if (prev_off + sizeof(BlockHeader) + prev->size == off) {
      prev->size += sizeof(BlockHeader) + b->size;
      prev->next_free = b->next_free;
    }
  }
}

void release_slot(Handle* h, Slot* s) {
  free_block(h, s->block_off);
  h->hdr->used_bytes -= s->size;
  h->hdr->num_objects -= 1;
  s->state = kTombstone;
  s->sealed = 0;
  s->pending_delete = 0;
}

// Evicts the least-recently-used sealed, unreferenced object.
// Returns true if something was evicted.
// O(table_cap) scan under the lock: fine at the common 1K-64K slot sizes;
// a sustained slot-full small-object workload would want a clock-hand
// cursor in the header to amortize this (plasma uses an LRU list).
bool evict_one(Handle* h) {
  Slot* table = slot_table(h);
  Slot* victim = nullptr;
  for (uint32_t i = 0; i < h->hdr->table_cap; ++i) {
    Slot* s = &table[i];
    if (s->state == kUsed && s->sealed && s->refcount == 0) {
      if (victim == nullptr || s->lru < victim->lru) victim = s;
    }
  }
  if (victim == nullptr) return false;
  release_slot(h, victim);
  h->hdr->num_evictions += 1;
  return true;
}

uint32_t table_capacity_for(uint64_t capacity) {
  // One slot per 16KB of arena, clamped to [1024, 1<<20], power of two.
  uint64_t want = capacity / 16384;
  uint32_t cap = 1024;
  while (cap < want && cap < (1u << 20)) cap <<= 1;
  return cap;
}

}  // namespace

extern "C" {

// Creates a fresh store segment. Fails if one with this name already exists.
void* tps_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base =
      mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = static_cast<StoreHeader*>(base);
  std::memset(hdr, 0, sizeof(StoreHeader));
  hdr->capacity = capacity;
  hdr->table_cap = table_capacity_for(capacity);
  hdr->table_off = align_up(sizeof(StoreHeader), kAlign);
  uint64_t table_bytes = static_cast<uint64_t>(hdr->table_cap) * sizeof(Slot);
  hdr->arena_off = align_up(hdr->table_off + table_bytes, kAlign);
  if (hdr->arena_off + sizeof(BlockHeader) + kAlign > capacity) {
    munmap(base, capacity);
    shm_unlink(name);
    return nullptr;  // capacity too small for metadata
  }
  hdr->arena_size = capacity - hdr->arena_off;
  std::memset(static_cast<uint8_t*>(base) + hdr->table_off, 0, table_bytes);
  // Whole arena = one free block.
  auto* first = reinterpret_cast<BlockHeader*>(
      static_cast<uint8_t*>(base) + hdr->arena_off);
  first->size = hdr->arena_size - sizeof(BlockHeader);
  first->next_free = 0;
  first->is_free = 1;
  hdr->free_head = hdr->arena_off;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  hdr->magic = kMagic;
  __sync_synchronize();
  hdr->ready = 1;

  auto* h = new Handle();
  h->base = static_cast<uint8_t*>(base);
  h->mapped_size = capacity;
  h->hdr = hdr;
  h->owner = true;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

// Attaches to an existing store segment.
void* tps_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(StoreHeader)) {
    close(fd);
    return nullptr;
  }
  uint64_t capacity = static_cast<uint64_t>(st.st_size);
  void* base =
      mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<StoreHeader*>(base);
  if (hdr->magic != kMagic || !hdr->ready || hdr->capacity != capacity) {
    munmap(base, capacity);
    return nullptr;
  }
  auto* h = new Handle();
  h->base = static_cast<uint8_t*>(base);
  h->mapped_size = capacity;
  h->hdr = hdr;
  h->owner = false;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

void tps_close(void* handle) {
  if (handle == nullptr) return;
  auto* h = static_cast<Handle*>(handle);
  munmap(h->base, h->mapped_size);
  delete h;
}

int tps_unlink(const char* name) { return shm_unlink(name); }

// Creates an unsealed object and returns the data offset for direct writes.
// The creator holds an implicit reference until seal/abort.
int tps_create_obj(void* handle, const uint8_t* id, uint64_t size,
                   uint64_t* data_off) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* existing = find_slot(h, id, false);
  if (existing != nullptr) {
    unlock(h);
    return kAlreadyExists;
  }
  // An object that can never fit must not trigger the eviction loop below —
  // it would destroy every idle object before failing anyway.
  if (align_up(size, kAlign) + sizeof(BlockHeader) > h->hdr->arena_size) {
    unlock(h);
    return kOutOfMemory;
  }
  uint64_t block = alloc_block(h, size);
  while (block == 0) {
    if (!evict_one(h)) {
      unlock(h);
      return kOutOfMemory;
    }
    block = alloc_block(h, size);
  }
  Slot* s = find_slot(h, id, true);
  while (s == nullptr) {
    // Slot table full (all kUsed, no tombstone): evict an idle object to
    // reclaim a slot, like plasma does for arena pressure. Dense
    // small-object workloads hit this before the arena fills.
    if (!evict_one(h)) {
      free_block(h, block);
      unlock(h);
      return kOutOfMemory;
    }
    s = find_slot(h, id, true);
  }
  std::memcpy(s->id, id, kIdLen);
  s->state = kUsed;
  s->sealed = 0;
  s->pending_delete = 0;
  s->refcount = 1;  // creator's reference
  s->block_off = block;
  s->size = size;
  s->lru = ++h->hdr->lru_clock;
  h->hdr->used_bytes += size;
  h->hdr->num_objects += 1;
  *data_off = block + sizeof(BlockHeader);
  unlock(h);
  return kOk;
}

// Seals an object (making it visible to gets) and drops the creator's ref.
int tps_seal(void* handle, const uint8_t* id) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* s = find_slot(h, id, false);
  if (s == nullptr) {
    unlock(h);
    return kNotFound;
  }
  if (s->sealed) {  // idempotent: never steal a reader's pin on re-seal
    unlock(h);
    return kAlreadyExists;
  }
  s->sealed = 1;
  if (s->refcount > 0) s->refcount -= 1;
  unlock(h);
  return kOk;
}

// Aborts an unsealed create, freeing its space.
int tps_abort(void* handle, const uint8_t* id) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* s = find_slot(h, id, false);
  if (s == nullptr) {
    unlock(h);
    return kNotFound;
  }
  if (s->sealed) {
    unlock(h);
    return kAlreadyExists;
  }
  release_slot(h, s);
  unlock(h);
  return kOk;
}

// One-shot put: create + copy + seal.
int tps_put(void* handle, const uint8_t* id, const uint8_t* data,
            uint64_t size) {
  uint64_t off = 0;
  int rc = tps_create_obj(handle, id, size, &off);
  if (rc != kOk) return rc;
  auto* h = static_cast<Handle*>(handle);
  std::memcpy(h->base + off, data, size);
  return tps_seal(handle, id);
}

// Gets a sealed object: returns its data offset + size and pins it
// (refcount++). Caller must tps_release when done with the buffer.
int tps_get(void* handle, const uint8_t* id, uint64_t* data_off,
            uint64_t* size) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* s = find_slot(h, id, false);
  if (s == nullptr) {
    unlock(h);
    return kNotFound;
  }
  if (!s->sealed) {
    unlock(h);
    return kNotSealed;
  }
  s->refcount += 1;
  s->lru = ++h->hdr->lru_clock;
  *data_off = s->block_off + sizeof(BlockHeader);
  *size = s->size;
  unlock(h);
  return kOk;
}

// Drops a pin taken by tps_get. Completes a deferred delete at zero refs.
int tps_release(void* handle, const uint8_t* id) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* s = find_slot(h, id, false);
  if (s == nullptr) {
    unlock(h);
    return kNotFound;
  }
  if (s->refcount > 0) s->refcount -= 1;
  if (s->refcount == 0 && s->pending_delete) release_slot(h, s);
  unlock(h);
  return kOk;
}

int tps_contains(void* handle, const uint8_t* id) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* s = find_slot(h, id, false);
  int present = (s != nullptr && s->sealed) ? 1 : 0;
  unlock(h);
  return present;
}

// Deletes an object. If pinned, deletion is deferred to the last release.
int tps_delete(void* handle, const uint8_t* id) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* s = find_slot(h, id, false);
  if (s == nullptr) {
    unlock(h);
    return kNotFound;
  }
  if (s->refcount > 0) {
    s->pending_delete = 1;
    unlock(h);
    return kInUse;
  }
  release_slot(h, s);
  unlock(h);
  return kOk;
}

// stats[0]=num_objects stats[1]=used_bytes stats[2]=arena_size
// stats[3]=num_evictions stats[4]=table_cap stats[5]=capacity
int tps_stats(void* handle, uint64_t* stats) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  stats[0] = h->hdr->num_objects;
  stats[1] = h->hdr->used_bytes;
  stats[2] = h->hdr->arena_size;
  stats[3] = h->hdr->num_evictions;
  stats[4] = h->hdr->table_cap;
  stats[5] = h->hdr->capacity;
  unlock(h);
  return kOk;
}

// Lists up to max_ids object ids (sealed only) into out (kIdLen bytes each).
// Returns the number written.
int tps_list(void* handle, uint8_t* out, int max_ids) {
  auto* h = static_cast<Handle*>(handle);
  if (h == nullptr) return kBadHandle;
  lock(h);
  Slot* table = slot_table(h);
  int n = 0;
  for (uint32_t i = 0; i < h->hdr->table_cap && n < max_ids; ++i) {
    Slot* s = &table[i];
    if (s->state == kUsed && s->sealed) {
      std::memcpy(out + static_cast<uint64_t>(n) * kIdLen, s->id, kIdLen);
      ++n;
    }
  }
  unlock(h);
  return n;
}

}  // extern "C"
