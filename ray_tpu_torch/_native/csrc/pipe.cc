// rtpu native driver engine: GIL-free control-pipe transport + data-plane
// primitives.
//
// Role analog: the reference's C++ CoreWorker threads behind the Cython
// bridge (src/ray/core_worker/core_worker.h) — the entire reason
// _raylet.pyx exists is so the per-task control costs (framing, socket IO,
// refcount bookkeeping) are paid off the GIL. Here the driver attaches one
// engine per worker connection fd:
//
//   - sender thread: pops pre-pickled messages from a queue, coalesces
//     whatever accumulated while the previous write was in flight into ONE
//     multiprocessing-compatible frame (a batch frame when >1), and writes
//     it. Python's per-send cost drops to pickle + one ctypes enqueue.
//   - drain-side receiver: the Python reader thread's drain() call does
//     the length-prefix reads itself with the GIL released — one kernel
//     wake per burst, no intermediate thread hop — splitting batch
//     frames and applying refpin delta frames to a native per-connection
//     refcount table (only net 0<->1 transitions reach the interpreter).
//
// Wire formats (shared with the pure-Python fallback paths, which must
// keep understanding them when the .so is absent on one side):
//   frame     = mp framing: u32be len payload   (len==0xffffffff: u64be len)
//   payload   = pickle bytes
//             | "RTB1" u32be count ( u32be len pickle )*   [batch]
//             | "RTP1" ( id[16] i8 delta )*                [refpin deltas]
// Pickle payloads always start with 0x80 (protocol >= 2), so the ASCII
// magics cannot collide.
//
// Data plane: rtpu_copy_mt (persistent-pool multi-threaded memcpy for
// large put/get against the arena) and an LZ4-block-format codec for the
// spill/restore path (no lz4/zstd python modules in the image; the codec
// is self-contained and tested by roundtrip against random + structured
// data).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <errno.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

constexpr uint32_t kIdBytes16 = 16;  // control-plane ObjectID width (ids.py _ID_LEN)
const uint8_t kBatchMagic[4] = {'R', 'T', 'B', '1'};
const uint8_t kRefpinMagic[4] = {'R', 'T', 'P', '1'};

// -- low-level IO -----------------------------------------------------------

bool write_all(int fd, const uint8_t* buf, uint64_t n) {
  while (n > 0) {
    ssize_t w = ::write(fd, buf, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += w;
    n -= static_cast<uint64_t>(w);
  }
  return true;
}

void put_u32be(std::string& out, uint32_t v) {
  out.push_back(static_cast<char>((v >> 24) & 0xff));
  out.push_back(static_cast<char>((v >> 16) & 0xff));
  out.push_back(static_cast<char>((v >> 8) & 0xff));
  out.push_back(static_cast<char>(v & 0xff));
}

void put_u32le(std::string& out, uint32_t v) {
  out.push_back(static_cast<char>(v & 0xff));
  out.push_back(static_cast<char>((v >> 8) & 0xff));
  out.push_back(static_cast<char>((v >> 16) & 0xff));
  out.push_back(static_cast<char>((v >> 24) & 0xff));
}

uint32_t get_u32be(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

// -- pipe engine ------------------------------------------------------------

struct NativePipe {
  int fd = -1;
  uint64_t coalesce_us = 0;

  // send side
  std::mutex smu;
  std::condition_variable scv;
  std::deque<std::string> sendq;
  std::string partial;  // pre-framed bytes an inline write couldn't finish
  bool sender_busy = false;  // sender thread mid-write with smu RELEASED
  bool closing = false;
  std::thread sender;

  // recv side. Reads happen ON the drain call itself (GIL released via
  // ctypes): the kernel wakes the draining thread directly — one thread
  // hop, exactly like a plain Python reader — while framing, batch
  // splitting and refpin bookkeeping stay native. rq buffers records
  // that did not fit the caller's buffer; it is touched only by the
  // single drain thread, so it needs no lock.
  std::string rq;
  size_t rq_off = 0;  // consumed prefix (compacted when fully drained)
  std::string rbuf;   // raw socket bytes not yet parsed into frames
  size_t rbuf_off = 0;
  int rcvtimeo_ms = -1;  // last SO_RCVTIMEO applied (syscall cache)
  bool eof = false;

  // per-connection borrow refcounts (the worker's ws.pinned twin),
  // maintained natively so refpin batches never touch the interpreter.
  // rmu guards pins only (drain thread vs the death-path drain_pins).
  std::mutex rmu;
  std::map<std::string, int64_t> pins;

  // counters (read by rtpu_pipe_stats)
  std::atomic<uint64_t> c_sent_frames{0}, c_sent_msgs{0}, c_sent_bytes{0};
  std::atomic<uint64_t> c_recv_frames{0}, c_recv_msgs{0}, c_recv_bytes{0};
  std::atomic<uint64_t> c_refpin_deltas{0}, c_refpin_transitions{0};
};

void append_record(NativePipe* p, uint8_t type, const uint8_t* data,
                   uint64_t len) {
  // drain-thread only (rq is single-consumer overflow)
  p->rq.push_back(static_cast<char>(type));
  put_u32le(p->rq, static_cast<uint32_t>(len));
  p->rq.append(reinterpret_cast<const char*>(data), len);
}

// Frame header into hdr (mp wire format); returns header length.
int frame_header(uint64_t payload_len, uint8_t* hdr) {
  if (payload_len > 0x7fffffffull) {
    hdr[0] = hdr[1] = hdr[2] = hdr[3] = 0xff;  // struct.pack("!i", -1)
    for (int i = 0; i < 8; i++)
      hdr[4 + i] = static_cast<uint8_t>((payload_len >> (8 * (7 - i))) &
                                        0xff);
    return 12;
  }
  hdr[0] = static_cast<uint8_t>((payload_len >> 24) & 0xff);
  hdr[1] = static_cast<uint8_t>((payload_len >> 16) & 0xff);
  hdr[2] = static_cast<uint8_t>((payload_len >> 8) & 0xff);
  hdr[3] = static_cast<uint8_t>(payload_len & 0xff);
  return 4;
}

// One frame for a batch of messages (single = raw payload, >1 = RTB1).
std::string build_frame(const std::deque<std::string>& batch) {
  std::string frame;
  uint64_t payload_len;
  if (batch.size() == 1) {
    payload_len = batch[0].size();
  } else {
    payload_len = 8;  // magic + count
    for (const auto& m : batch) payload_len += 4 + m.size();
  }
  frame.reserve(payload_len + 12);
  uint8_t hdr[12];
  int hlen = frame_header(payload_len, hdr);
  frame.append(reinterpret_cast<const char*>(hdr), hlen);
  if (batch.size() == 1) {
    frame += batch[0];
  } else {
    frame.append(reinterpret_cast<const char*>(kBatchMagic), 4);
    put_u32be(frame, static_cast<uint32_t>(batch.size()));
    for (const auto& m : batch) {
      put_u32be(frame, static_cast<uint32_t>(m.size()));
      frame += m;
    }
  }
  return frame;
}

void sender_loop(NativePipe* p) {
  // The SLOW path: engaged only when an inline nonblocking send could not
  // finish (socket buffer full) or messages queued behind one. That is
  // exactly when coalescing pays — everything queued while this thread's
  // previous write was in flight ships as one batch frame.
  std::unique_lock<std::mutex> lk(p->smu);
  for (;;) {
    while (p->sendq.empty() && p->partial.empty() && !p->closing)
      p->scv.wait(lk);
    if (p->sendq.empty() && p->partial.empty()) return;  // closing, done
    if (p->coalesce_us > 0 && p->partial.empty() && p->sendq.size() == 1 &&
        !p->closing) {
      // optional Nagle window (default 0: natural coalescing only)
      p->scv.wait_for(lk, std::chrono::microseconds(p->coalesce_us));
    }
    std::string head;
    head.swap(p->partial);  // pre-framed remainder goes FIRST
    std::deque<std::string> batch;
    batch.swap(p->sendq);
    // the flag keeps the inline fast path OFF the socket while this
    // thread writes with the lock released — without it a send arriving
    // mid-write_all would interleave its frame into ours
    p->sender_busy = true;
    lk.unlock();

    bool ok = true;
    if (!head.empty())
      ok = write_all(p->fd, reinterpret_cast<const uint8_t*>(head.data()),
                     head.size());
    if (ok && !batch.empty()) {
      std::string frame = build_frame(batch);
      ok = write_all(p->fd,
                     reinterpret_cast<const uint8_t*>(frame.data()),
                     frame.size());
      p->c_sent_frames.fetch_add(1, std::memory_order_relaxed);
      p->c_sent_msgs.fetch_add(batch.size(), std::memory_order_relaxed);
      p->c_sent_bytes.fetch_add(frame.size(), std::memory_order_relaxed);
    }
    lk.lock();
    p->sender_busy = false;
    if (!ok) {  // peer gone; the receiver's EOF drives Python-side death
      p->closing = true;
      p->sendq.clear();
      p->partial.clear();
      return;
    }
  }
}

// Apply a packed refpin frame to the native borrow table; returns the
// packed NET transitions (id[16] + i8)* to surface to Python, usually
// empty or tiny.
std::string apply_refpins(NativePipe* p, const uint8_t* data,
                          uint64_t len) {
  std::string trans;
  std::lock_guard<std::mutex> lk(p->rmu);
  for (uint64_t off = 0; off + kIdBytes16 + 1 <= len;
       off += kIdBytes16 + 1) {
    std::string id(reinterpret_cast<const char*>(data + off), kIdBytes16);
    int8_t d = static_cast<int8_t>(data[off + kIdBytes16]);
    p->c_refpin_deltas.fetch_add(1, std::memory_order_relaxed);
    int64_t before = 0;
    auto it = p->pins.find(id);
    if (it != p->pins.end()) before = it->second;
    int64_t after = before + d;
    if (after > 0) {
      p->pins[id] = after;
    } else if (it != p->pins.end()) {
      p->pins.erase(it);
    }
    if (before == 0 && after > 0) {
      trans += id;
      trans.push_back(1);
    } else if (before > 0 && after <= 0) {
      trans += id;
      trans.push_back(static_cast<char>(-1));
    }
  }
  if (!trans.empty())
    p->c_refpin_transitions.fetch_add(trans.size() / (kIdBytes16 + 1),
                                      std::memory_order_relaxed);
  return trans;
}

// Record sink for the drain call: fills the caller buffer while records
// fit AND the overflow queue is empty (order preservation); everything
// else lands in the overflow queue for the next call.
struct DrainSink {
  NativePipe* p;
  uint8_t* out;
  uint64_t cap;
  uint64_t copied = 0;
};

void sink_record(DrainSink& s, uint8_t type, const uint8_t* data,
                 uint64_t len) {
  uint64_t rec = 5ull + len;
  if (s.p->rq.size() == s.p->rq_off && s.copied + rec <= s.cap) {
    s.out[s.copied] = static_cast<char>(type);
    uint32_t l32 = static_cast<uint32_t>(len);
    memcpy(s.out + s.copied + 1, &l32, 4);
    memcpy(s.out + s.copied + 5, data, len);
    s.copied += rec;
  } else {
    append_record(s.p, type, data, len);
  }
}

// Parse one complete frame payload into records.
void ingest_frame(DrainSink& s, const uint8_t* payload, uint64_t n) {
  NativePipe* p = s.p;
  p->c_recv_frames.fetch_add(1, std::memory_order_relaxed);
  p->c_recv_bytes.fetch_add(n + 4, std::memory_order_relaxed);
  if (n > 4 && memcmp(payload, kRefpinMagic, 4) == 0) {
    std::string trans = apply_refpins(p, payload + 4, n - 4);
    if (!trans.empty())
      sink_record(s, 1, reinterpret_cast<const uint8_t*>(trans.data()),
                  trans.size());
    return;
  }
  if (n >= 8 && memcmp(payload, kBatchMagic, 4) == 0) {
    uint32_t count = get_u32be(payload + 4);
    uint64_t off = 8;
    for (uint32_t i = 0; i < count && off + 4 <= n; i++) {
      uint32_t ln = get_u32be(payload + off);
      off += 4;
      if (off + ln > n) break;
      sink_record(s, 0, payload + off, ln);
      p->c_recv_msgs.fetch_add(1, std::memory_order_relaxed);
      off += ln;
    }
    return;
  }
  sink_record(s, 0, payload, n);
  p->c_recv_msgs.fetch_add(1, std::memory_order_relaxed);
}

// Parse every COMPLETE frame sitting in rbuf into the sink; partial
// frames stay buffered for the next recv.
void parse_rbuf(DrainSink& s) {
  NativePipe* p = s.p;
  for (;;) {
    const uint8_t* base =
        reinterpret_cast<const uint8_t*>(p->rbuf.data()) + p->rbuf_off;
    uint64_t avail = p->rbuf.size() - p->rbuf_off;
    if (avail < 4) break;
    uint64_t n = get_u32be(base);
    uint64_t hlen = 4;
    if (n == 0xffffffffu) {  // mp extended 64-bit length
      if (avail < 12) break;
      n = 0;
      for (int i = 0; i < 8; i++) n = (n << 8) | base[4 + i];
      hlen = 12;
    }
    if (avail < hlen + n) break;
    ingest_frame(s, base + hlen, n);
    p->rbuf_off += hlen + n;
  }
  if (p->rbuf_off == p->rbuf.size()) {
    p->rbuf.clear();
    p->rbuf_off = 0;
  } else if (p->rbuf_off > (1u << 20)) {
    p->rbuf.erase(0, p->rbuf_off);
    p->rbuf_off = 0;
  }
}

// -- multi-threaded memcpy pool ---------------------------------------------

struct CopyShard {
  uint8_t* dst;
  const uint8_t* src;
  uint64_t n;
  std::atomic<int>* done;
};

class CopyPool {
 public:
  static CopyPool& instance() {
    // intentionally leaked: a static-duration pool would run its
    // destructor at process exit while detached workers still wait on
    // the condition variable — glibc deadlocks in __run_exit_handlers
    static CopyPool* pool = new CopyPool();
    return *pool;
  }

  void submit(const CopyShard& s) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push_back(s);
    }
    cv_.notify_one();
  }

  int workers() const { return nworkers_; }

 private:
  CopyPool() {
    unsigned hc = std::thread::hardware_concurrency();
    nworkers_ = hc > 1 ? static_cast<int>(hc > 8 ? 8 : hc) - 1 : 1;
    for (int i = 0; i < nworkers_; i++)
      std::thread([this] { worker(); }).detach();
  }

  void worker() {
    for (;;) {
      CopyShard s;
      {
        std::unique_lock<std::mutex> lk(mu_);
        while (q_.empty()) cv_.wait(lk);
        s = q_.front();
        q_.pop_front();
      }
      memcpy(s.dst, s.src, s.n);
      s.done->fetch_add(1, std::memory_order_release);
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<CopyShard> q_;
  int nworkers_ = 1;
};

// -- LZ4 block codec --------------------------------------------------------
//
// Standard LZ4 block format (token / literals / le16 offset / matchlen),
// self-contained. Correctness contract: decompress(compress(x)) == x for
// every input; the compressor respects the end-of-block rules (last 5
// bytes literal, no match starting within the last 12 bytes).

constexpr int kHashLog = 13;
constexpr uint32_t kHashSize = 1u << kHashLog;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

inline uint32_t lz_hash(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// pipe engine C API
// ---------------------------------------------------------------------------

NativePipe* rtpu_pipe_new(int fd, uint64_t coalesce_us) {
  NativePipe* p = new NativePipe();
  p->fd = fd;
  p->coalesce_us = coalesce_us;
  p->sender = std::thread(sender_loop, p);
  return p;
}

// Send one pre-pickled message. 0 ok, -1 closed.
//
// Fast path (queues empty): frame and write INLINE with MSG_DONTWAIT — no
// thread handoff at all, same single syscall the Python sender paid. On a
// full socket buffer (or with messages already queued) the remainder goes
// to the sender thread, which batches everything that accumulates.
int rtpu_pipe_send(NativePipe* p, const uint8_t* buf, uint64_t len) {
  bool wake = false;
  {
    std::lock_guard<std::mutex> lk(p->smu);
    if (p->closing) return -1;
    if (p->sendq.empty() && p->partial.empty() && !p->sender_busy) {
      uint8_t hdr[12];
      int hlen = frame_header(len, hdr);
      struct iovec iov[2];
      iov[0].iov_base = hdr;
      iov[0].iov_len = static_cast<size_t>(hlen);
      iov[1].iov_base = const_cast<uint8_t*>(buf);
      iov[1].iov_len = len;
      struct msghdr mh;
      memset(&mh, 0, sizeof(mh));
      mh.msg_iov = iov;
      mh.msg_iovlen = 2;
      ssize_t w = ::sendmsg(p->fd, &mh, MSG_DONTWAIT | MSG_NOSIGNAL);
      uint64_t total = static_cast<uint64_t>(hlen) + len;
      if (w == static_cast<ssize_t>(total)) {
        p->c_sent_frames.fetch_add(1, std::memory_order_relaxed);
        p->c_sent_msgs.fetch_add(1, std::memory_order_relaxed);
        p->c_sent_bytes.fetch_add(total, std::memory_order_relaxed);
        return 0;
      }
      if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
          errno != EINTR) {
        p->closing = true;
        return -1;
      }
      // partial (or EAGAIN): stash the pre-framed remainder for the
      // sender thread; frame order is preserved (partial goes first)
      uint64_t done = w > 0 ? static_cast<uint64_t>(w) : 0;
      p->partial.reserve(total - done);
      if (done < static_cast<uint64_t>(hlen)) {
        p->partial.append(reinterpret_cast<const char*>(hdr) + done,
                          hlen - done);
        done = 0;
      } else {
        done -= hlen;
      }
      p->partial.append(reinterpret_cast<const char*>(buf) + done,
                        len - done);
      p->c_sent_frames.fetch_add(1, std::memory_order_relaxed);
      p->c_sent_msgs.fetch_add(1, std::memory_order_relaxed);
      p->c_sent_bytes.fetch_add(total, std::memory_order_relaxed);
      wake = true;
    } else {
      p->sendq.emplace_back(reinterpret_cast<const char*>(buf), len);
      wake = true;
    }
  }
  if (wake) p->scv.notify_one();
  return 0;
}

// Drain records into out (packed [u8 type][u32le len][payload]*).
//
// Called by ONE Python thread per connection (its reader thread), with
// the GIL released via ctypes. Syscall-frugal by design — syscalls on
// the sandboxed boxes this runs on cost tens of µs: steady state is ONE
// recv(2) per wake (SO_RCVTIMEO bounds the block; no poll), and a burst
// of frames arrives in one recv and parses out of the user-space buffer.
// Returns bytes written; 0 on timeout; -1 on EOF with nothing queued;
// -needed when the first record alone exceeds cap.
int64_t rtpu_pipe_drain(NativePipe* p, uint8_t* out, uint64_t cap,
                        uint64_t timeout_ms) {
  // 1. leftover records from a previous overflow
  if (p->rq.size() > p->rq_off) {
    const uint8_t* base = reinterpret_cast<const uint8_t*>(p->rq.data());
    uint64_t off = p->rq_off;
    uint64_t copied = 0;
    while (off < p->rq.size()) {
      uint32_t len;
      memcpy(&len, base + off + 1, 4);
      uint64_t rec = 5ull + len;
      if (copied + rec > cap) {
        if (copied == 0) return -static_cast<int64_t>(rec);
        break;
      }
      memcpy(out + copied, base + off, rec);
      copied += rec;
      off += rec;
    }
    p->rq_off = off;
    if (p->rq_off == p->rq.size()) {
      p->rq.clear();
      p->rq_off = 0;
    }
    return static_cast<int64_t>(copied);
  }

  DrainSink sink{p, out, cap};
  // 2. frames already buffered from a previous recv
  parse_rbuf(sink);
  for (;;) {
    if (sink.copied > 0) return static_cast<int64_t>(sink.copied);
    if (p->rq.size() > p->rq_off) {
      // a record bigger than cap went straight to overflow
      uint32_t len;
      memcpy(&len, p->rq.data() + p->rq_off + 1, 4);
      return -static_cast<int64_t>(5ull + len);
    }
    if (p->eof) return -1;

    // 3. one bounded blocking recv — THE syscall of the steady state
    if (p->rcvtimeo_ms != static_cast<int>(timeout_ms)) {
      struct timeval tv;
      tv.tv_sec = timeout_ms / 1000;
      tv.tv_usec = (timeout_ms % 1000) * 1000;
      setsockopt(p->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      p->rcvtimeo_ms = static_cast<int>(timeout_ms);
    }
    char tmp[256 << 10];
    ssize_t r = ::recv(p->fd, tmp, sizeof(tmp), 0);
    if (r == 0) {
      p->eof = true;
      return -1;
    }
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
        return 0;  // timeout tick: caller re-checks shutdown state
      p->eof = true;
      return -1;
    }
    p->rbuf.append(tmp, static_cast<size_t>(r));
    parse_rbuf(sink);
    // loop: a partial frame keeps reading; completed records return
  }
}

// Serialize-and-clear the connection's borrow table (worker-death drain):
// packed (id[16] + i64le count)*. Returns bytes or -needed.
int64_t rtpu_pipe_drain_pins(NativePipe* p, uint8_t* out, uint64_t cap) {
  std::lock_guard<std::mutex> lk(p->rmu);
  uint64_t need = p->pins.size() * (kIdBytes16 + 8ull);
  if (need > cap) return -static_cast<int64_t>(need);
  uint64_t off = 0;
  for (const auto& kv : p->pins) {
    memcpy(out + off, kv.first.data(), kIdBytes16);
    int64_t c = kv.second;
    memcpy(out + off + kIdBytes16, &c, 8);
    off += kIdBytes16 + 8;
  }
  p->pins.clear();
  return static_cast<int64_t>(off);
}

void rtpu_pipe_stats(NativePipe* p, uint64_t* out8) {
  out8[0] = p->c_sent_frames.load(std::memory_order_relaxed);
  out8[1] = p->c_sent_msgs.load(std::memory_order_relaxed);
  out8[2] = p->c_sent_bytes.load(std::memory_order_relaxed);
  out8[3] = p->c_recv_frames.load(std::memory_order_relaxed);
  out8[4] = p->c_recv_msgs.load(std::memory_order_relaxed);
  out8[5] = p->c_recv_bytes.load(std::memory_order_relaxed);
  out8[6] = p->c_refpin_deltas.load(std::memory_order_relaxed);
  out8[7] = p->c_refpin_transitions.load(std::memory_order_relaxed);
}

// Stop accepting sends and unblock the sender thread + any blocked
// drain (shutdown(2) makes poll/read return immediately). Does NOT close
// the fd (Python's Connection object owns it) and does not join — safe
// to call from the drain thread itself.
void rtpu_pipe_shutdown(NativePipe* p) {
  {
    std::lock_guard<std::mutex> lk(p->smu);
    p->closing = true;
  }
  p->scv.notify_all();
  ::shutdown(p->fd, SHUT_RDWR);
}

// Full teardown: shutdown + join + delete. Never call from the engine's
// own threads (the Python drain thread is fine — it is a Python thread;
// the wrapper's in-flight guard keeps it out of the struct first).
void rtpu_pipe_close(NativePipe* p) {
  rtpu_pipe_shutdown(p);
  if (p->sender.joinable()) p->sender.join();
  delete p;
}

// ---------------------------------------------------------------------------
// multi-threaded memcpy
// ---------------------------------------------------------------------------

// Copy n bytes dst<-src with up to `threads` workers (the calling thread
// copies its own shard; ctypes releases the GIL around the call, so pool
// workers run truly parallel to it). Small copies fall through to plain
// memcpy.
void rtpu_copy_mt(uint8_t* dst, const uint8_t* src, uint64_t n,
                  int threads) {
  CopyPool& pool = CopyPool::instance();
  int k = threads;
  int avail = pool.workers() + 1;
  if (k <= 0 || k > avail) k = avail;
  if (k <= 1 || n < (1u << 20)) {
    memcpy(dst, src, n);
    return;
  }
  std::atomic<int> done{0};
  uint64_t shard = (n / k + 63) & ~63ull;  // cacheline-aligned shards
  int submitted = 0;
  uint64_t off = shard;  // shard 0 is the caller's
  for (int i = 1; i < k && off < n; i++) {
    uint64_t len = (i == k - 1) ? n - off : (off + shard <= n ? shard
                                                              : n - off);
    pool.submit({dst + off, src + off, len, &done});
    submitted++;
    off += len;
  }
  memcpy(dst, src, shard < n ? shard : n);
  while (done.load(std::memory_order_acquire) < submitted)
    std::this_thread::yield();
}

// ---------------------------------------------------------------------------
// LZ4 block codec
// ---------------------------------------------------------------------------

uint64_t rtpu_lz4_bound(uint64_t n) { return n + n / 255 + 16; }

// Compress src[0..n) into dst (capacity cap). Returns compressed size, or
// -1 when dst is too small (callers then store the block raw).
int64_t rtpu_lz4_compress(const uint8_t* src, uint64_t n, uint8_t* dst,
                          uint64_t cap) {
  uint64_t op = 0;

  auto emit = [&](uint64_t lit_start, uint64_t lit_len, uint32_t offset,
                  uint64_t match_len) -> bool {
    // token
    uint64_t need = 1 + lit_len + lit_len / 255 + 1 + (offset ? 2 : 0) +
                    (match_len ? match_len / 255 + 1 : 0) + 8;
    if (op + need > cap) return false;
    uint8_t token = 0;
    uint64_t ml = match_len ? match_len - 4 : 0;
    token = static_cast<uint8_t>(
        ((lit_len >= 15 ? 15 : lit_len) << 4) |
        (offset ? (ml >= 15 ? 15 : ml) : 0));
    dst[op++] = token;
    if (lit_len >= 15) {
      uint64_t rest = lit_len - 15;
      while (rest >= 255) {
        dst[op++] = 255;
        rest -= 255;
      }
      dst[op++] = static_cast<uint8_t>(rest);
    }
    // guard: memcpy's args are declared nonnull, and a zero-byte input
    // arrives as src == nullptr (empty buffer) — UB even with len 0
    if (lit_len) memcpy(dst + op, src + lit_start, lit_len);
    op += lit_len;
    if (offset) {
      dst[op++] = static_cast<uint8_t>(offset & 0xff);
      dst[op++] = static_cast<uint8_t>((offset >> 8) & 0xff);
      if (ml >= 15) {
        uint64_t rest = ml - 15;
        while (rest >= 255) {
          dst[op++] = 255;
          rest -= 255;
        }
        dst[op++] = static_cast<uint8_t>(rest);
      }
    }
    return true;
  };

  if (n < 13) {  // too small for any match per the format's end rules
    if (!emit(0, n, 0, 0)) return -1;
    return static_cast<int64_t>(op);
  }

  std::vector<uint32_t> table(kHashSize, 0);  // pos+1; 0 = empty
  uint64_t mflimit = n - 12;  // no match may START past here
  uint64_t pos = 0, anchor = 0;
  while (pos <= mflimit) {
    uint32_t seq = read32(src + pos);
    uint32_t h = lz_hash(seq);
    uint64_t ref = table[h];
    table[h] = static_cast<uint32_t>(pos + 1);
    if (ref != 0) {
      uint64_t r = ref - 1;
      if (pos - r <= 65535 && read32(src + r) == seq) {
        // extend the match, but leave the last 5 bytes as literals
        uint64_t limit = n - 5;
        uint64_t mlen = 4;
        while (pos + mlen < limit && src[r + mlen] == src[pos + mlen])
          mlen++;
        if (!emit(anchor, pos - anchor,
                  static_cast<uint32_t>(pos - r), mlen))
          return -1;
        pos += mlen;
        anchor = pos;
        continue;
      }
    }
    pos++;
  }
  if (!emit(anchor, n - anchor, 0, 0)) return -1;
  return static_cast<int64_t>(op);
}

// Decompress src[0..n) into dst (exact capacity dcap). Returns bytes
// produced, or -1 on malformed input / overflow.
int64_t rtpu_lz4_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                            uint64_t dcap) {
  uint64_t ip = 0, op = 0;
  while (ip < n) {
    uint8_t token = src[ip++];
    uint64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || op + lit > dcap) return -1;
    memcpy(dst + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip >= n) break;  // final sequence: literals only
    if (ip + 2 > n) return -1;
    uint32_t offset = src[ip] | (static_cast<uint32_t>(src[ip + 1]) << 8);
    ip += 2;
    if (offset == 0 || offset > op) return -1;
    uint64_t mlen = (token & 15);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > dcap) return -1;
    // byte-wise copy: overlapping matches (offset < mlen) are the RLE case
    const uint8_t* m = dst + op - offset;
    for (uint64_t i = 0; i < mlen; i++) dst[op + i] = m[i];
    op += mlen;
  }
  return static_cast<int64_t>(op);
}

}  // extern "C"
