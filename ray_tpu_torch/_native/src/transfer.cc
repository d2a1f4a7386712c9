// Object-transfer data plane — the ObjectManager equivalent.
//
// Reference counterpart: src/ray/object_manager/ (object_manager.cc chunked
// Push/Pull over a dedicated gRPC service, object_buffer_pool). Re-designed
// for this runtime: a per-node TCP server thread that streams object bytes
// STRAIGHT OUT OF the shared-memory arena (no copy into Python, no pickle
// framing), and a client that receives STRAIGHT INTO a newly created arena
// slot on the destination node. The Python control plane only exchanges
// object locations; bulk bytes never cross the GIL.
//
// Wire protocol (all little-endian):
//   GET : c->s [op=1:1][id:24]            s->c [status:1][size:8][payload]
//   PUT : c->s [op=2:1][id:24][size:8][payload]   s->c [status:1]
//   GETR: c->s [op=3:1][id:24][offset:8][length:8]
//         s->c [status:1][total:8][n:8][payload n bytes]
// A connection handles sequential requests until EOF.
//
// GETR is the chunked data plane (reference: object_buffer_pool chunked
// Push): n = min(length, total - offset), so a receiver pulls an object as
// a pipeline of fixed-size ranges, writing each into its (unsealed) arena
// slot as it lands. length=0 is a pure size probe. Because every response
// carries the authoritative total, a pull broken by sender death resumes
// at the next un-landed offset against ANY other holder — the per-chunk
// offset IS the resume cursor.

#include "shm_store.cc"  // same TU: Handle layout + tps_* internals

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>

namespace {

constexpr uint8_t kOpGet = 1;
constexpr uint8_t kOpPut = 2;
constexpr uint8_t kOpGetRange = 3;
constexpr int kChunk = 1 << 20;  // 1MB send granularity (ref ray_config_def.h:242)

bool send_all(int fd, const uint8_t* buf, uint64_t n) {
  while (n > 0) {
    ssize_t w = send(fd, buf, n > kChunk ? kChunk : n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && (errno == EINTR)) continue;
      return false;
    }
    buf += w;
    n -= static_cast<uint64_t>(w);
  }
  return true;
}

bool recv_all(int fd, uint8_t* buf, uint64_t n) {
  while (n > 0) {
    ssize_t r = recv(fd, buf, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    buf += r;
    n -= static_cast<uint64_t>(r);
  }
  return true;
}

struct ServerCtx {
  void* store;
  int listen_fd;
  int port;
  pthread_t thread;
  std::atomic<bool> stop{false};
  // Data-plane accounting: bytes served out of the arena and request
  // count, read by the Python side for transfer_bytes_out. Relaxed is
  // fine — these are monotonic gauges, not synchronization.
  std::atomic<uint64_t> bytes_out{0};
  std::atomic<uint64_t> requests{0};
  // Live-connection registry: conn threads are detached, so stop must
  // shut their sockets down and wait for the last one to leave before
  // the ctx can be freed (a detached thread touching a deleted ctx is a
  // use-after-free — caught by the TSAN stress harness).
  pthread_mutex_t conn_mu = PTHREAD_MUTEX_INITIALIZER;
  pthread_cond_t conn_cv = PTHREAD_COND_INITIALIZER;
  std::vector<int> conn_fds;
  int live_conns = 0;
};

struct ConnArgs {
  ServerCtx* ctx;
  int fd;
};

void handle_get(ServerCtx* ctx, int fd, const uint8_t* id) {
  uint64_t off = 0, size = 0;
  int rc = tps_get(ctx->store, id, &off, &size);
  uint8_t status = rc == kOk ? 0 : 1;
  uint8_t head[9];
  head[0] = status;
  uint64_t sz = rc == kOk ? size : 0;
  std::memcpy(head + 1, &sz, 8);
  if (!send_all(fd, head, 9)) {
    if (rc == kOk) tps_release(ctx->store, id);
    return;
  }
  if (rc == kOk) {
    auto* h = static_cast<Handle*>(ctx->store);
    if (send_all(fd, h->base + off, size)) {  // zero-copy out of the arena
      ctx->bytes_out.fetch_add(size, std::memory_order_relaxed);
    }
    tps_release(ctx->store, id);
  }
}

// One range of a sealed object: [status:1][total:8][n:8][payload].
// status 0 = ok, 1 = miss, 2 = offset past end. length 0 probes the size.
void handle_get_range(ServerCtx* ctx, int fd, const uint8_t* id) {
  uint8_t operands[16];
  if (!recv_all(fd, operands, sizeof(operands))) return;
  uint64_t offset, length;
  std::memcpy(&offset, operands, 8);
  std::memcpy(&length, operands + 8, 8);
  uint64_t off = 0, size = 0;
  int rc = tps_get(ctx->store, id, &off, &size);
  uint8_t status = rc == kOk ? 0 : 1;
  uint64_t total = rc == kOk ? size : 0;
  uint64_t n = 0;
  if (rc == kOk) {
    if (offset > total) {
      status = 2;
    } else {
      uint64_t avail = total - offset;
      n = length < avail ? length : avail;
    }
  }
  uint8_t head[17];
  head[0] = status;
  std::memcpy(head + 1, &total, 8);
  std::memcpy(head + 9, &n, 8);
  if (send_all(fd, head, sizeof(head)) && n > 0) {
    auto* h = static_cast<Handle*>(ctx->store);
    if (send_all(fd, h->base + off + offset, n)) {
      ctx->bytes_out.fetch_add(n, std::memory_order_relaxed);
    }
  }
  if (rc == kOk) tps_release(ctx->store, id);
}


// Drain `size` payload bytes so the connection stays request-aligned when a
// body cannot be stored (duplicate object, OOM, raced fetcher).
static bool drain_payload(int fd, uint64_t size) {
  uint8_t sink[65536];
  uint64_t left = size;
  while (left > 0) {
    uint64_t take = left > sizeof(sink) ? sizeof(sink) : left;
    if (!recv_all(fd, sink, take)) return false;
    left -= take;
  }
  return true;
}

void handle_put(ServerCtx* ctx, int fd, const uint8_t* id) {
  uint64_t size = 0;
  if (!recv_all(fd, reinterpret_cast<uint8_t*>(&size), 8)) return;
  uint64_t off = 0;
  int rc = tps_create_obj(ctx->store, id, size, &off);
  uint8_t status;
  if (rc == kOk) {
    auto* h = static_cast<Handle*>(ctx->store);
    if (recv_all(fd, h->base + off, size)) {  // straight into the arena
      tps_seal(ctx->store, id);
      status = 0;
    } else {
      tps_abort(ctx->store, id);
      return;  // connection broken anyway
    }
  } else if (rc == kAlreadyExists) {
    // Idempotent: drain payload, report success (objects are immutable).
    if (!drain_payload(fd, size)) return;
    status = 0;
  } else {
    // OOM etc: drain the payload so a persistent connection stays framed
    // (the next bytes must be a request header, not leftover payload).
    if (!drain_payload(fd, size)) return;
    status = 2;  // sender sees failure
  }
  send_all(fd, &status, 1);
}

void* conn_loop(void* arg) {
  auto* ca = static_cast<ConnArgs*>(arg);
  int one = 1;
  setsockopt(ca->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  uint8_t req[1 + kIdLen];
  while (!ca->ctx->stop.load(std::memory_order_relaxed)) {
    if (!recv_all(ca->fd, req, sizeof(req))) break;
    ca->ctx->requests.fetch_add(1, std::memory_order_relaxed);
    if (req[0] == kOpGet) {
      handle_get(ca->ctx, ca->fd, req + 1);
    } else if (req[0] == kOpPut) {
      handle_put(ca->ctx, ca->fd, req + 1);
    } else if (req[0] == kOpGetRange) {
      handle_get_range(ca->ctx, ca->fd, req + 1);
    } else {
      break;
    }
  }
  close(ca->fd);
  // deregister LAST: after the count drops, stop may free the ctx
  ServerCtx* ctx = ca->ctx;
  int fd = ca->fd;
  delete ca;
  pthread_mutex_lock(&ctx->conn_mu);
  for (size_t i = 0; i < ctx->conn_fds.size(); ++i) {
    if (ctx->conn_fds[i] == fd) {
      ctx->conn_fds[i] = ctx->conn_fds.back();
      ctx->conn_fds.pop_back();
      break;
    }
  }
  ctx->live_conns--;
  pthread_cond_broadcast(&ctx->conn_cv);
  pthread_mutex_unlock(&ctx->conn_mu);
  return nullptr;
}

void* accept_loop(void* arg) {
  auto* ctx = static_cast<ServerCtx*>(arg);
  while (!ctx->stop.load(std::memory_order_relaxed)) {
    int fd = accept(ctx->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      break;  // listen socket closed by tts_serve_stop
    }
    auto* ca = new ConnArgs{ctx, fd};
    pthread_mutex_lock(&ctx->conn_mu);
    ctx->conn_fds.push_back(fd);
    ctx->live_conns++;
    pthread_mutex_unlock(&ctx->conn_mu);
    pthread_t t;
    if (pthread_create(&t, nullptr, conn_loop, ca) == 0) {
      pthread_detach(t);
    } else {
      close(fd);
      delete ca;
      pthread_mutex_lock(&ctx->conn_mu);
      for (size_t i = 0; i < ctx->conn_fds.size(); ++i) {
        if (ctx->conn_fds[i] == fd) {
          ctx->conn_fds[i] = ctx->conn_fds.back();
          ctx->conn_fds.pop_back();
          break;
        }
      }
      ctx->live_conns--;
      pthread_cond_broadcast(&ctx->conn_cv);
      pthread_mutex_unlock(&ctx->conn_mu);
    }
  }
  return nullptr;
}

int connect_to(const char* host, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

}  // namespace

extern "C" {

// Starts the transfer server for an open store handle. port=0 picks a free
// port. Returns a ServerCtx* (opaque) or null.
void* tts_serve_start(void* store_handle, int port) {
  if (store_handle == nullptr) return nullptr;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 128) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);
  auto* ctx = new ServerCtx();
  ctx->store = store_handle;
  ctx->listen_fd = fd;
  ctx->port = ntohs(addr.sin_port);
  if (pthread_create(&ctx->thread, nullptr, accept_loop, ctx) != 0) {
    close(fd);
    delete ctx;
    return nullptr;
  }
  return ctx;
}

int tts_serve_port(void* sctx) {
  return sctx ? static_cast<ServerCtx*>(sctx)->port : -1;
}

// Cumulative bytes served / requests handled by this server (the
// transfer_bytes_out source of truth; payload bytes only, no headers).
void tts_serve_stats(void* sctx, uint64_t* bytes_out, uint64_t* requests) {
  auto* ctx = static_cast<ServerCtx*>(sctx);
  if (ctx == nullptr) {
    if (bytes_out) *bytes_out = 0;
    if (requests) *requests = 0;
    return;
  }
  if (bytes_out) *bytes_out = ctx->bytes_out.load(std::memory_order_relaxed);
  if (requests) *requests = ctx->requests.load(std::memory_order_relaxed);
}

void tts_serve_stop(void* sctx) {
  if (sctx == nullptr) return;
  auto* ctx = static_cast<ServerCtx*>(sctx);
  ctx->stop.store(true);
  shutdown(ctx->listen_fd, SHUT_RDWR);
  close(ctx->listen_fd);
  pthread_join(ctx->thread, nullptr);
  // Kick every live connection out of its blocking recv/send, then wait
  // for the detached handlers to deregister — only then is the ctx free
  // (use-after-free otherwise; see the ServerCtx registry comment).
  pthread_mutex_lock(&ctx->conn_mu);
  for (int fd : ctx->conn_fds) shutdown(fd, SHUT_RDWR);
  while (ctx->live_conns > 0) {
    pthread_cond_wait(&ctx->conn_cv, &ctx->conn_mu);
  }
  pthread_mutex_unlock(&ctx->conn_mu);
  delete ctx;
}

// Opens a persistent data-plane connection (the server handles sequential
// requests per connection). Returns fd >= 0 or -1.
int tts_connect(const char* host, int port) { return connect_to(host, port); }

void tts_disconnect(int fd) {
  if (fd >= 0) close(fd);
}

// Fetch over an existing connection. Same return codes as tts_fetch, plus
// -5 = connection broken (caller should reconnect).
int tts_fetch_fd(int fd, const uint8_t* id, void* store_handle) {
  if (tps_contains(store_handle, id) == 1) return 0;
  uint8_t req[1 + kIdLen];
  req[0] = kOpGet;
  std::memcpy(req + 1, id, kIdLen);
  uint8_t head[9];
  if (!send_all(fd, req, sizeof(req)) || !recv_all(fd, head, 9)) return -5;
  uint64_t size;
  std::memcpy(&size, head + 1, 8);
  if (head[0] != 0) return -1;
  uint64_t off = 0;
  int rc = tps_create_obj(store_handle, id, size, &off);
  if (rc == kAlreadyExists || rc != kOk) {
    // raced another fetcher / local store full: must still drain the stream
    // to keep the connection request-aligned.
    if (!drain_payload(fd, size)) return -5;
    return rc == kAlreadyExists ? 0 : -3;
  }
  auto* h = static_cast<Handle*>(store_handle);
  if (!recv_all(fd, h->base + off, size)) {
    tps_abort(store_handle, id);
    return -5;
  }
  tps_seal(store_handle, id);
  return 0;
}

// Fetches ONE range of object `id` over an existing connection, receiving
// straight into caller memory `dst` (an unsealed arena slot on the pull
// path). length=0 probes the size without moving payload. Returns the
// number of payload bytes landed (>= 0) with *total_out set to the
// object's full size, or negative: -1 remote miss, -4 protocol error
// (offset past end / malformed), -5 connection broken mid-stream — the
// caller's already-landed prefix stays valid, so a retry against another
// holder resumes at offset + <bytes landed so far>.
int64_t tts_fetch_range_fd(int fd, const uint8_t* id, uint64_t offset,
                           uint64_t length, uint8_t* dst,
                           uint64_t* total_out) {
  if (total_out) *total_out = 0;
  uint8_t req[1 + kIdLen + 16];
  req[0] = kOpGetRange;
  std::memcpy(req + 1, id, kIdLen);
  std::memcpy(req + 1 + kIdLen, &offset, 8);
  std::memcpy(req + 1 + kIdLen + 8, &length, 8);
  uint8_t head[17];
  if (!send_all(fd, req, sizeof(req)) || !recv_all(fd, head, sizeof(head)))
    return -5;
  uint64_t total, n;
  std::memcpy(&total, head + 1, 8);
  std::memcpy(&n, head + 9, 8);
  if (total_out) *total_out = total;
  if (head[0] == 1) return -1;
  if (head[0] != 0 || n > length) return -4;
  if (n > 0 && !recv_all(fd, dst, n)) return -5;
  return static_cast<int64_t>(n);
}

// Fetches object `id` from host:port directly into the local arena.
// Returns 0 on success, -1 remote miss, -2 connect failure, -3 local store
// full, -4 protocol error, -5 connection broken. Safe to call concurrently.
int tts_fetch(const char* host, int port, const uint8_t* id,
              void* store_handle) {
  if (tps_contains(store_handle, id) == 1) return 0;
  int fd = connect_to(host, port);
  if (fd < 0) return -2;
  int result = tts_fetch_fd(fd, id, store_handle);
  close(fd);
  return result;
}

// Fetches into a malloc'd buffer (for processes with no local arena).
// On success returns size (>=0) and sets *out (caller frees via
// tts_buf_free); negative = error codes as tts_fetch.
int64_t tts_fetch_buf(const char* host, int port, const uint8_t* id,
                      uint8_t** out) {
  *out = nullptr;
  int fd = connect_to(host, port);
  if (fd < 0) return -2;
  uint8_t req[1 + kIdLen];
  req[0] = kOpGet;
  std::memcpy(req + 1, id, kIdLen);
  uint8_t head[9];
  int64_t result = -4;
  if (send_all(fd, req, sizeof(req)) && recv_all(fd, head, 9)) {
    uint64_t size;
    std::memcpy(&size, head + 1, 8);
    if (head[0] != 0) {
      result = -1;
    } else {
      auto* buf = static_cast<uint8_t*>(malloc(size ? size : 1));
      if (buf == nullptr) {
        result = -3;
      } else if (recv_all(fd, buf, size)) {
        *out = buf;
        result = static_cast<int64_t>(size);
      } else {
        free(buf);
        result = -4;
      }
    }
  }
  close(fd);
  return result;
}

void tts_buf_free(uint8_t* p) { free(p); }

// Pushes a local arena object to a remote node (the reference's Push path).
// Returns 0 ok, -1 not local, -2 connect failure, -4 protocol/remote error.
int tts_push(const char* host, int port, const uint8_t* id,
             void* store_handle) {
  uint64_t off = 0, size = 0;
  if (tps_get(store_handle, id, &off, &size) != kOk) return -1;
  int result = -4;
  int fd = connect_to(host, port);
  if (fd >= 0) {
    uint8_t req[1 + kIdLen + 8];
    req[0] = kOpPut;
    std::memcpy(req + 1, id, kIdLen);
    std::memcpy(req + 1 + kIdLen, &size, 8);
    auto* h = static_cast<Handle*>(store_handle);
    uint8_t status = 1;
    if (send_all(fd, req, sizeof(req)) &&
        send_all(fd, h->base + off, size) && recv_all(fd, &status, 1) &&
        status == 0) {
      result = 0;
    }
    close(fd);
  } else {
    result = -2;
  }
  tps_release(store_handle, id);
  return result;
}

}  // extern "C"
