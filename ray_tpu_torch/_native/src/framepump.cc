// Native frame pump: socket recv + length-prefix framing + scatter-gather
// send, off the GIL (reference counterpart: the C++ core worker / raylet
// keep exactly these loops native — arXiv:1712.05889 §4.3; the Python
// byte-shuffling in protocol.py:_recv_exact was 14% of head and 60% of
// worker self-time in the reference's live profile).
//
// One pump per connection, used from ONE thread at a time (the client's
// reader thread or the server's event loop). Two modes share the
// ring/splitter:
//
//   * fd mode   (fd >= 0)  — the pump owns the read side of the socket:
//     fp_pump() blocks in recv(2) with the GIL released (ctypes releases
//     it around the foreign call), appends to a growable ring, splits
//     length-prefixed frames, and batches them for one fp_take() per
//     wakeup — N frames per Python call instead of 2+ recv syscalls and
//     a bytearray dance per frame.
//   * feed mode (fd < 0)   — the caller supplies bytes (the asyncio
//     server's bulk reader.read() chunks); fp_feed() splits the same way.
//
// Frame layout is protocol.py's: [8-byte LE length][body]. The pump
// enforces the same MAX_MESSAGE bound (oversize => hard error, the
// connection is dropped, matching the Python path's behavior). Bodies are
// delivered verbatim: magic-byte dispatch, pickle fallback, chaos hooks
// and every decode stay in Python.
//
// Thread-safety contract: fp_pump/fp_feed/fp_take on one handle are
// called from a single thread; fp_destroy only after the pumping thread
// has exited (the Python wrapper destroys from the reader loop's exit
// path). fp_sendv is stateless per call and safe from any thread.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

constexpr size_t kRecvChunk = 256 * 1024;
// Stay well under IOV_MAX per sendmsg (EMSGSIZE otherwise); same cap the
// Python _send_buffers used.
constexpr size_t kIovCap = 512;

struct Frame {
  size_t off;
  size_t len;
};

struct FramePump {
  int fd = -1;                    // -1: feed mode
  uint64_t max_message = 0;
  std::vector<uint8_t> buf;       // contiguous ring: [frames)[partial tail)
  size_t parse = 0;               // split cursor (start of the partial tail)
  std::deque<Frame> frames;       // complete, undelivered frame bodies
  uint64_t body_bytes = 0;        // sum of undelivered body lengths
  std::vector<uint8_t> rx;        // fd-mode recv staging chunk
  bool error = false;
};

uint64_t read_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // host is little-endian on every deploy target
  return v;
}

// Split complete frames out of [parse, buf.size()). Returns false on an
// oversize frame (protocol violation: latch the error, drop the conn).
bool split_frames(FramePump* p) {
  size_t end = p->buf.size();
  while (end - p->parse >= 8) {
    uint64_t length = read_le64(p->buf.data() + p->parse);
    if (length > p->max_message) {
      p->error = true;
      return false;
    }
    if (end - p->parse - 8 < length) break;  // partial body: wait for more
    p->frames.push_back({p->parse + 8, static_cast<size_t>(length)});
    p->body_bytes += length;
    p->parse += 8 + length;
  }
  return true;
}

// Reclaim delivered bytes once nothing references them: memmove the
// partial tail to the front so the buffer never grows past one frame +
// one recv chunk in steady state.
void compact(FramePump* p) {
  if (!p->frames.empty() || p->parse == 0) return;
  size_t tail = p->buf.size() - p->parse;
  if (tail > 0) std::memmove(p->buf.data(), p->buf.data() + p->parse, tail);
  p->buf.resize(tail);
  p->parse = 0;
}

// Copy out up to max_frames bodies into dst, then write the number of
// frames STILL buffered into sizes[taken] (the array must hold
// max_frames + 1 entries). Returns taken, or -3 when the first pending
// frame's body exceeds dst_cap (nothing consumed; the caller grows dst
// and drains with fp_take). The batched single-call path: Python pays
// ONE foreign call per wakeup instead of pending/bytes/take round-trips
// (each ctypes crossing costs ~1 µs — four per frame erased the win).
int64_t take_batch(FramePump* p, uint8_t* dst, uint64_t dst_cap,
                   uint64_t* sizes, uint64_t max_frames) {
  if (!p->frames.empty() && p->frames.front().len > dst_cap) return -3;
  uint64_t taken = 0;
  uint64_t written = 0;
  while (taken < max_frames && !p->frames.empty()) {
    const Frame& f = p->frames.front();
    if (written + f.len > dst_cap) break;
    if (f.len > 0) std::memcpy(dst + written, p->buf.data() + f.off, f.len);
    sizes[taken] = f.len;
    written += f.len;
    p->body_bytes -= f.len;
    p->frames.pop_front();
    ++taken;
  }
  sizes[taken] = p->frames.size();  // leftovers (cap overflow): rare drain
  compact(p);
  return static_cast<int64_t>(taken);
}

}  // namespace

extern "C" {

void* fp_create(int fd, uint64_t max_message) {
  FramePump* p = new (std::nothrow) FramePump();
  if (p == nullptr) return nullptr;
  p->fd = fd;
  p->max_message = max_message;
  return p;
}

void fp_destroy(void* h) { delete static_cast<FramePump*>(h); }

// fd mode: block in recv until at least one complete frame is buffered
// (or EOF/error). Returns the number of complete frames ready, -1 on
// EOF/socket error, -2 on an oversize frame.
int64_t fp_pump(void* h) {
  FramePump* p = static_cast<FramePump*>(h);
  if (p->error) return -2;
  if (p->fd < 0) return -1;
  if (p->rx.size() < kRecvChunk) p->rx.resize(kRecvChunk);
  uint8_t* chunk = p->rx.data();
  while (p->frames.empty()) {
    ssize_t n = recv(p->fd, chunk, kRecvChunk, 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (n == 0) return -1;  // orderly EOF
    p->buf.insert(p->buf.end(), chunk, chunk + n);
    if (!split_frames(p)) return -2;
  }
  return static_cast<int64_t>(p->frames.size());
}

// feed mode: append caller bytes + split. Returns frames ready, -2 on an
// oversize frame.
int64_t fp_feed(void* h, const uint8_t* data, uint64_t len) {
  FramePump* p = static_cast<FramePump*>(h);
  if (p->error) return -2;
  if (len > 0) p->buf.insert(p->buf.end(), data, data + len);
  if (!split_frames(p)) return -2;
  return static_cast<int64_t>(p->frames.size());
}

// fd mode, one foreign call per wakeup: block until >=1 frame, then copy
// a batch straight into the caller's reusable dst. Returns frames taken,
// -1 EOF/socket error, -2 oversize frame, -3 dst too small for the first
// frame (nothing consumed; grow + fp_take). sizes needs max_frames + 1
// entries — sizes[taken] reports frames still buffered.
int64_t fp_pump_take(void* h, uint8_t* dst, uint64_t dst_cap,
                     uint64_t* sizes, uint64_t max_frames) {
  FramePump* p = static_cast<FramePump*>(h);
  if (p->error) return -2;
  if (p->fd < 0) return -1;
  if (p->rx.size() < kRecvChunk) p->rx.resize(kRecvChunk);
  uint8_t* chunk = p->rx.data();
  while (p->frames.empty()) {
    ssize_t n = recv(p->fd, chunk, kRecvChunk, 0);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (n == 0) return -1;  // orderly EOF
    p->buf.insert(p->buf.end(), chunk, chunk + n);
    if (!split_frames(p)) return -2;
  }
  return take_batch(p, dst, dst_cap, sizes, max_frames);
}

// feed mode, one foreign call per chunk: append + split + copy out.
// Returns frames taken (0: no complete frame yet), -2 oversize, -3 dst
// too small for the first frame (bytes consumed into the ring; grow +
// fp_take, do NOT refeed). Same sizes contract as fp_pump_take.
int64_t fp_feed_take(void* h, const uint8_t* data, uint64_t len,
                     uint8_t* dst, uint64_t dst_cap,
                     uint64_t* sizes, uint64_t max_frames) {
  FramePump* p = static_cast<FramePump*>(h);
  if (p->error) return -2;
  if (len > 0) p->buf.insert(p->buf.end(), data, data + len);
  if (!split_frames(p)) return -2;
  if (p->frames.empty()) {
    sizes[0] = 0;
    return 0;
  }
  return take_batch(p, dst, dst_cap, sizes, max_frames);
}

uint64_t fp_pending_frames(void* h) {
  return static_cast<FramePump*>(h)->frames.size();
}

uint64_t fp_pending_bytes(void* h) {
  return static_cast<FramePump*>(h)->body_bytes;
}

// Copy out up to max_frames frame bodies, concatenated into dst; each
// body's length lands in sizes[]. Returns the number of frames taken
// (they are consumed), or -1 if dst_cap cannot hold them.
int64_t fp_take(void* h, uint8_t* dst, uint64_t dst_cap,
                uint64_t* sizes, uint64_t max_frames) {
  FramePump* p = static_cast<FramePump*>(h);
  uint64_t taken = 0;
  uint64_t written = 0;
  while (taken < max_frames && !p->frames.empty()) {
    const Frame& f = p->frames.front();
    if (written + f.len > dst_cap) {
      if (taken == 0) return -1;  // caller's buffer cannot hold even one
      break;
    }
    if (f.len > 0) std::memcpy(dst + written, p->buf.data() + f.off, f.len);
    sizes[taken] = f.len;
    written += f.len;
    p->body_bytes -= f.len;
    p->frames.pop_front();
    ++taken;
  }
  compact(p);
  return static_cast<int64_t>(taken);
}

// Scatter-gather send of n buffers over a BLOCKING fd: one sendmsg per
// <=kIovCap iovecs, partial-send continuation, EINTR retry. Returns 0 on
// success, -1 on error (errno left for the caller).
int fp_sendv(int fd, const uint8_t** bufs, const uint64_t* lens, uint64_t n) {
  std::vector<iovec> iov(n);
  for (uint64_t i = 0; i < n; ++i) {
    iov[i].iov_base = const_cast<uint8_t*>(bufs[i]);
    iov[i].iov_len = static_cast<size_t>(lens[i]);
  }
  size_t idx = 0;
  while (idx < n) {
    // Skip fully-sent / empty entries so msg_iovlen never counts them.
    if (iov[idx].iov_len == 0) {
      ++idx;
      continue;
    }
    msghdr mh;
    std::memset(&mh, 0, sizeof(mh));
    mh.msg_iov = &iov[idx];
    mh.msg_iovlen = std::min<size_t>(n - idx, kIovCap);
    ssize_t sent = sendmsg(fd, &mh, MSG_NOSIGNAL);
    if (sent < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    size_t s = static_cast<size_t>(sent);
    while (idx < n && s >= iov[idx].iov_len) {
      s -= iov[idx].iov_len;
      ++idx;
    }
    if (s > 0) {
      iov[idx].iov_base = static_cast<uint8_t*>(iov[idx].iov_base) + s;
      iov[idx].iov_len -= s;
    }
  }
  return 0;
}

}  // extern "C"
