// rtpu native object store: one shared-memory arena per session.
//
// Role analog: the reference's plasma store (src/ray/object_manager/plasma/
// store.h + object_lifecycle_manager.h + dlmalloc arena) re-designed for the
// single-daemonless model this framework uses: instead of a store server
// process speaking a unix-socket protocol, the arena itself IS the shared
// state — a POSIX shm segment containing the allocator metadata, the object
// table, and the payload heap, guarded by a process-shared robust mutex.
// Writers allocate+seal; readers look up sealed entries and pin them with a
// refcount; eviction walks sealed refcount-0 objects in LRU order (the
// reference's EvictionPolicy).
//
// Exposed as a flat C API consumed from Python via ctypes (no pybind11 in
// the image). All offsets are relative to the arena base so every process
// can mmap at a different address.

#include <cstdint>
#include <cstring>
#include <cerrno>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055'53544f52ULL;  // "RTPUSTOR"
constexpr uint32_t kIdBytes = 20;                    // ObjectID binary size
constexpr uint32_t kMaxObjects = 65536;              // table capacity (pow2)
constexpr uint64_t kAlign = 64;                      // cacheline alignment

enum EntryState : uint32_t {
  kFree = 0,       // slot unused
  kCreated = 1,    // allocated, writer still filling
  kSealed = 2,     // immutable, readable
  kTombstone = 3,  // deleted; slot reusable but keeps probe chains alive
  kDeleting = 4,   // delete requested with live readers; freed on last release
};

struct Entry {
  uint8_t id[kIdBytes];
  uint32_t state;
  uint64_t offset;      // payload offset from arena base
  uint64_t size;        // payload size (what readers see)
  uint64_t alloc_size;  // bytes actually taken from the heap (>= size)
  int64_t refcount;
  uint64_t lru_tick;    // last pin/unpin tick for eviction ordering
};

// Free-list node stored inside the free block itself.
struct FreeBlock {
  uint64_t size;
  uint64_t next;       // offset of next free block, 0 == end
};

struct Header {
  uint64_t magic;
  uint64_t arena_size;     // total mapping size
  uint64_t heap_start;     // first payload byte
  uint64_t free_head;      // offset of first free block (0 == none)
  uint64_t used_bytes;     // payload bytes currently allocated
  uint64_t lru_clock;      // monotonic tick
  uint64_t num_objects;
  pthread_mutex_t lock;    // process-shared robust mutex
  Entry table[kMaxObjects];
};

struct Store {
  Header* hdr;
  uint8_t* base;
  uint64_t map_size;
  int fd;
};

uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

uint32_t id_hash(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdBytes; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return static_cast<uint32_t>(h & (kMaxObjects - 1));
}

class Locker {
 public:
  explicit Locker(Header* hdr) : hdr_(hdr) {
    int rc = pthread_mutex_lock(&hdr_->lock);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock; state is best-effort consistent
      // (allocator ops are short); mark recovered.
      pthread_mutex_consistent(&hdr_->lock);
    }
  }
  ~Locker() { pthread_mutex_unlock(&hdr_->lock); }

 private:
  Header* hdr_;
};

// Find the table slot for id (existing entry or insertion point).
Entry* find_slot(Header* hdr, const uint8_t* id, bool for_insert) {
  uint32_t idx = id_hash(id);
  Entry* first_tomb = nullptr;
  for (uint32_t probe = 0; probe < kMaxObjects; probe++) {
    Entry* e = &hdr->table[(idx + probe) & (kMaxObjects - 1)];
    if (e->state == kFree) {
      if (for_insert) return first_tomb ? first_tomb : e;
      return nullptr;
    }
    if (e->state == kTombstone) {
      if (for_insert && !first_tomb) first_tomb = e;
      continue;
    }
    if (memcmp(e->id, id, kIdBytes) == 0) return e;
  }
  return for_insert ? first_tomb : nullptr;
}

// First-fit allocation from the free list. Returns 0 on failure; on
// success *consumed is the exact byte count taken from the heap (the whole
// block when the remainder is too small to split — callers must free with
// this value or the remainder leaks).
uint64_t heap_alloc(Header* hdr, uint8_t* base, uint64_t size,
                    uint64_t* consumed) {
  size = align_up(size);
  uint64_t prev_off = 0;
  uint64_t cur = hdr->free_head;
  while (cur) {
    FreeBlock* blk = reinterpret_cast<FreeBlock*>(base + cur);
    if (blk->size >= size) {
      uint64_t remaining = blk->size - size;
      uint64_t next = blk->next;
      uint64_t taken = size;
      if (remaining >= sizeof(FreeBlock) + kAlign) {
        uint64_t tail_off = cur + size;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(base + tail_off);
        tail->size = remaining;
        tail->next = next;
        next = tail_off;
      } else {
        taken = blk->size;  // absorb the unsplittable remainder
      }
      if (prev_off) {
        reinterpret_cast<FreeBlock*>(base + prev_off)->next = next;
      } else {
        hdr->free_head = next;
      }
      hdr->used_bytes += taken;
      *consumed = taken;
      return cur;
    }
    prev_off = cur;
    cur = blk->next;
  }
  return 0;
}

// Return a block to the free list, coalescing with adjacent free blocks.
// `size` must be the alloc_size heap_alloc reported for this block.
void heap_free(Header* hdr, uint8_t* base, uint64_t off, uint64_t size) {
  hdr->used_bytes -= size;
  // insert sorted by offset, then coalesce neighbors
  uint64_t prev = 0;
  uint64_t cur = hdr->free_head;
  while (cur && cur < off) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(base + cur)->next;
  }
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(base + off);
  blk->size = size;
  blk->next = cur;
  if (prev) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(base + prev);
    pb->next = off;
    if (prev + pb->size == off) {  // coalesce prev+this
      pb->size += blk->size;
      pb->next = blk->next;
      off = prev;
      blk = pb;
    }
  } else {
    hdr->free_head = off;
  }
  if (blk->next && off + blk->size == blk->next) {  // coalesce this+next
    FreeBlock* nb = reinterpret_cast<FreeBlock*>(base + blk->next);
    blk->size += nb->size;
    blk->next = nb->next;
  }
}

// Evict sealed refcount-0 objects in LRU order until at least `needed`
// bytes are free-able. Returns freed bytes.
uint64_t evict_lru(Header* hdr, uint8_t* base, uint64_t needed) {
  uint64_t freed = 0;
  while (freed < needed) {
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < kMaxObjects; i++) {
      Entry* e = &hdr->table[i];
      if (e->state == kSealed && e->refcount == 0) {
        if (!victim || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (!victim) break;
    heap_free(hdr, base, victim->offset, victim->alloc_size);
    freed += victim->alloc_size;
    victim->state = kTombstone;
    hdr->num_objects--;
  }
  return freed;
}

}  // namespace

extern "C" {

// Create (or attach to) the arena for `name`. capacity used only on create.
Store* rtpu_store_open(const char* name, uint64_t capacity) {
  int fd = shm_open(name, O_RDWR, 0600);
  bool creator = false;
  if (fd < 0) {
    fd = shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600);
    if (fd < 0) {
      // lost a race: retry attach
      fd = shm_open(name, O_RDWR, 0600);
      if (fd < 0) return nullptr;
    } else {
      creator = true;
    }
  }
  uint64_t map_size;
  if (creator) {
    map_size = align_up(sizeof(Header)) + capacity;
    if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    struct stat st {};
    // creator may still be mid-ftruncate; spin briefly
    bool ok = false;
    for (int i = 0; i < 1000; i++) {
      if (fstat(fd, &st) == 0 && st.st_size > 0) {
        ok = true;
        break;
      }
      usleep(1000);
    }
    if (!ok) {
      close(fd);
      return nullptr;
    }
    map_size = static_cast<uint64_t>(st.st_size);
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* hdr = static_cast<Header*>(mem);
  uint8_t* base = static_cast<uint8_t*>(mem);
  if (creator) {
    memset(hdr, 0, sizeof(Header));
    hdr->arena_size = map_size;
    hdr->heap_start = align_up(sizeof(Header));
    FreeBlock* blk = reinterpret_cast<FreeBlock*>(base + hdr->heap_start);
    blk->size = map_size - hdr->heap_start;
    blk->next = 0;
    hdr->free_head = hdr->heap_start;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->lock, &attr);
    pthread_mutexattr_destroy(&attr);
    __sync_synchronize();
    hdr->magic = kMagic;
  } else {
    for (int i = 0; i < 1000 && hdr->magic != kMagic; i++) usleep(1000);
    if (hdr->magic != kMagic) {
      munmap(mem, map_size);
      close(fd);
      return nullptr;
    }
  }
  Store* s = new Store{hdr, base, map_size, fd};
  return s;
}

void rtpu_store_close(Store* s) {
  if (!s) return;
  munmap(s->base, s->map_size);
  close(s->fd);
  delete s;
}

void rtpu_store_destroy(const char* name) { shm_unlink(name); }

// Allocate an object; returns payload offset or 0 (full / exists).
uint64_t rtpu_create(Store* s, const uint8_t* id, uint64_t size) {
  Locker lk(s->hdr);
  Entry* existing = find_slot(s->hdr, id, false);
  if (existing) return 0;  // already present
  uint64_t consumed = 0;
  uint64_t off = heap_alloc(s->hdr, s->base, size, &consumed);
  if (!off) {
    evict_lru(s->hdr, s->base, align_up(size));
    off = heap_alloc(s->hdr, s->base, size, &consumed);
    if (!off) return 0;
  }
  Entry* e = find_slot(s->hdr, id, true);
  if (!e) {  // table full
    heap_free(s->hdr, s->base, off, consumed);
    return 0;
  }
  memcpy(e->id, id, kIdBytes);
  e->state = kCreated;
  e->offset = off;
  e->size = size;
  e->alloc_size = consumed;
  e->refcount = 1;  // writer holds a ref until seal+release
  e->lru_tick = ++s->hdr->lru_clock;
  s->hdr->num_objects++;
  return off;
}

int rtpu_seal(Store* s, const uint8_t* id) {
  Locker lk(s->hdr);
  Entry* e = find_slot(s->hdr, id, false);
  if (!e || e->state != kCreated) return -1;
  e->state = kSealed;
  return 0;
}

// Look up a sealed object; pins it (+1 ref). Returns offset or 0.
uint64_t rtpu_get(Store* s, const uint8_t* id, uint64_t* size_out) {
  Locker lk(s->hdr);
  Entry* e = find_slot(s->hdr, id, false);
  if (!e || e->state != kSealed) return 0;
  e->refcount++;
  e->lru_tick = ++s->hdr->lru_clock;
  if (size_out) *size_out = e->size;
  return e->offset;
}

int rtpu_contains(Store* s, const uint8_t* id) {
  Locker lk(s->hdr);
  Entry* e = find_slot(s->hdr, id, false);
  return (e && e->state == kSealed) ? 1 : 0;
}

int rtpu_release(Store* s, const uint8_t* id) {
  Locker lk(s->hdr);
  Entry* e = find_slot(s->hdr, id, false);
  if (!e || e->state == kTombstone || e->state == kFree) return -1;
  if (e->refcount > 0) e->refcount--;
  e->lru_tick = ++s->hdr->lru_clock;
  if (e->state == kDeleting && e->refcount == 0) {
    heap_free(s->hdr, s->base, e->offset, e->alloc_size);
    e->state = kTombstone;
    s->hdr->num_objects--;
  }
  return 0;
}

// Object lifetime contract (mirrors the driver's object directory): the
// writer ref from rtpu_create is the DIRECTORY's reference and is only
// dropped here, by the owner deciding the object is gone. With that ref
// held, sealed objects are never evictable, so live ObjectRefs can't lose
// data to allocation pressure (finding of the old auto-evict design).
int rtpu_delete(Store* s, const uint8_t* id) {
  Locker lk(s->hdr);
  Entry* e = find_slot(s->hdr, id, false);
  if (!e || e->state == kTombstone || e->state == kFree) return -1;
  if (e->state == kCreated) {
    // Unsealed: the writer is the only possible user; if the owner says
    // delete, the writer is gone (crash recovery path) — free now.
    heap_free(s->hdr, s->base, e->offset, e->alloc_size);
    e->state = kTombstone;
    s->hdr->num_objects--;
    return 0;
  }
  if (e->refcount > 0) e->refcount--;  // drop the writer/directory ref
  if (e->refcount > 0) {
    e->state = kDeleting;  // readers alive: free on their last release
    return 1;
  }
  heap_free(s->hdr, s->base, e->offset, e->alloc_size);
  e->state = kTombstone;
  s->hdr->num_objects--;
  return 0;
}

uint64_t rtpu_evict(Store* s, uint64_t nbytes) {
  Locker lk(s->hdr);
  return evict_lru(s->hdr, s->base, nbytes);
}

void rtpu_stats(Store* s, uint64_t* capacity, uint64_t* used,
                uint64_t* num_objects) {
  Locker lk(s->hdr);
  if (capacity) *capacity = s->hdr->arena_size - s->hdr->heap_start;
  if (used) *used = s->hdr->used_bytes;
  if (num_objects) *num_objects = s->hdr->num_objects;
}

// Fragmentation report for `ray_tpu memory`: walk the free list under the
// arena lock and report block count, total free bytes, and the largest
// contiguous free block (the biggest object the arena can still take
// without eviction).
void rtpu_frag_stats(Store* s, uint64_t* free_blocks, uint64_t* free_bytes,
                     uint64_t* largest_free) {
  Locker lk(s->hdr);
  uint64_t blocks = 0, total = 0, largest = 0;
  uint64_t cur = s->hdr->free_head;
  // the free list is bounded by arena_size/kAlign entries; the guard
  // caps pathological (corrupt-header) walks instead of spinning
  uint64_t guard = s->hdr->arena_size / kAlign + 2;
  while (cur != 0 && blocks < guard) {
    FreeBlock* blk = reinterpret_cast<FreeBlock*>(s->base + cur);
    blocks++;
    total += blk->size;
    if (blk->size > largest) largest = blk->size;
    cur = blk->next;
  }
  if (free_blocks) *free_blocks = blocks;
  if (free_bytes) *free_bytes = total;
  if (largest_free) *largest_free = largest;
}

uint8_t* rtpu_base(Store* s) { return s->base; }

}  // extern "C"
