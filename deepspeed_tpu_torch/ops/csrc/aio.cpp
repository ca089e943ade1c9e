// Async file I/O for the NVMe offload tier (ZeRO-Infinity swap).
//
// The PyTorch/CUDA package's copy of the JAX package's host op (same C ABI),
// bound by ops/aio/__init__.py (AioHandle). Design:
//
// * every request is SPLIT into block_size chunks fanned across the worker
//   thread pool, so one large swap read or write keeps queue-depth chunk
//   I/Os in flight (the role libaio's iodepth plays upstream);
// * O_DIRECT (optional): chunks whose (offset, size, buffer address) are
//   all 4096-aligned go through an O_DIRECT fd, bypassing the page cache;
//   misaligned chunks (tails, odd buffers) use the buffered fd of the same
//   file;
// * queue_depth bounds the number of queued chunks: submit blocks when the
//   queue is full (backpressure instead of unbounded memory);
// * a request is a ticket: wait_ticket waits for one request, wait for all.
//
// C ABI, ctypes-bound.

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kAlign = 4096;

struct FileHandles {
  int fd_buffered = -1;
  int fd_direct = -1;
  ~FileHandles() {
    if (fd_buffered >= 0) ::close(fd_buffered);
    if (fd_direct >= 0) ::close(fd_direct);
  }
};

struct Request {
  bool write;
  std::shared_ptr<FileHandles> files;
  void* buf;
  int64_t nbytes;
  int64_t offset;
  int64_t ticket = 0;
};

struct Handle {
  std::vector<std::thread> workers;
  std::deque<Request> queue;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::condition_variable cv_space;
  int64_t inflight = 0;
  int64_t completed = 0;
  int64_t block_size = 1 << 20;
  int64_t queue_limit = 0;  // 0 = unbounded
  bool o_direct = false;
  std::atomic<int64_t> errors{0};
  bool shutdown = false;
  // per-request ("ticket") completion tracking: remaining chunk count +
  // failed chunk count, so callers can wait on ONE request (the
  // pipelined swap-in path) without draining the whole queue
  int64_t next_ticket = 1;
  std::unordered_map<int64_t, int64_t> ticket_remaining;
  std::unordered_map<int64_t, int64_t> ticket_errors;
  // DS_AIO_SIM_US_PER_MB: simulated device latency (test/bench-only) —
  // each chunk sleeps nbytes-proportionally while holding the "device"
  // mutex of its direction, so the simulated bandwidth is aggregate across
  // threads (a real device's queue), full-duplex (NVMe reads and writes
  // proceed concurrently), and the sleeping thread genuinely yields the CPU
  int64_t sim_us_per_mb = 0;
  std::mutex sim_mu_read, sim_mu_write;

  void worker_loop() {
    for (;;) {
      Request req;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [&] { return shutdown || !queue.empty(); });
        if (shutdown && queue.empty()) return;
        req = std::move(queue.front());
        queue.pop_front();
        cv_space.notify_all();
      }
      if (sim_us_per_mb > 0) {
        std::unique_lock<std::mutex> dev(req.write ? sim_mu_write
                                                   : sim_mu_read);
        int64_t us = req.nbytes * sim_us_per_mb / (1 << 20);
        if (us > 0) ::usleep(static_cast<useconds_t>(us));
      }
      bool ok = run_one(req);
      if (!ok) errors.fetch_add(1);
      {
        std::unique_lock<std::mutex> lock(mu);
        --inflight;
        ++completed;
        if (!ok) ++ticket_errors[req.ticket];
        auto it = ticket_remaining.find(req.ticket);
        if (it != ticket_remaining.end() && --it->second == 0)
          cv_done.notify_all();
        if (inflight == 0) cv_done.notify_all();
      }
    }
  }

  static bool aligned(const Request& req) {
    return req.offset % kAlign == 0 && req.nbytes % kAlign == 0 &&
           reinterpret_cast<uintptr_t>(req.buf) % kAlign == 0;
  }

  static bool run_one(const Request& req) {
    int fd = (req.files->fd_direct >= 0 && aligned(req))
                 ? req.files->fd_direct
                 : req.files->fd_buffered;
    if (fd < 0) return false;
    char* p = static_cast<char*>(req.buf);
    int64_t left = req.nbytes;
    int64_t off = req.offset;
    while (left > 0) {
      ssize_t r = req.write ? ::pwrite64(fd, p, left, off)
                            : ::pread64(fd, p, left, off);
      if (r <= 0) return false;
      p += r;
      off += r;
      left -= r;
    }
    return true;
  }
};

}  // namespace

extern "C" {

// block_size: chunking granularity (bytes, >= 4096); queue_depth: max
// queued chunks (0 = unbounded); o_direct: route aligned chunks through
// O_DIRECT.
void* ds_aio_create(int num_threads, int64_t block_size, int64_t queue_depth,
                    int o_direct) {
  auto* h = new Handle();
  if (num_threads < 1) num_threads = 1;
  if (block_size >= 4096) h->block_size = block_size;
  h->queue_limit = queue_depth > 0 ? queue_depth : 0;
  h->o_direct = o_direct != 0;
  if (const char* sim = ::getenv("DS_AIO_SIM_US_PER_MB"))
    h->sim_us_per_mb = ::strtoll(sim, nullptr, 10);
  for (int i = 0; i < num_threads; ++i)
    h->workers.emplace_back([h] { h->worker_loop(); });
  return h;
}

void ds_aio_destroy(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  {
    std::unique_lock<std::mutex> lock(h->mu);
    h->shutdown = true;
  }
  h->cv_work.notify_all();
  for (auto& t : h->workers) t.join();
  delete h;
}

static int64_t submit(Handle* h, bool write, const char* path, void* buf,
                      int64_t nbytes, int64_t offset) {
  auto files = std::make_shared<FileHandles>();
  int flags = write ? (O_WRONLY | O_CREAT) : O_RDONLY;
  files->fd_buffered = ::open(path, flags, 0644);
#ifdef O_DIRECT
  if (h->o_direct) files->fd_direct = ::open(path, flags | O_DIRECT, 0644);
#endif
  // register the ticket with its FULL chunk count before pushing any chunk
  // (a fast worker must not see remaining hit 0 mid-submission)
  int64_t n_chunks = nbytes == 0 ? 1 : (nbytes + h->block_size - 1) / h->block_size;
  int64_t ticket;
  {
    std::unique_lock<std::mutex> lock(h->mu);
    ticket = h->next_ticket++;
    h->ticket_remaining[ticket] = n_chunks;
  }
  if (nbytes == 0) {
    std::unique_lock<std::mutex> lock(h->mu);
    h->ticket_remaining[ticket] = 0;
    h->cv_done.notify_all();
    return ticket;
  }
  // split into block_size chunks; each chunk is an independent queue entry
  int64_t pos = 0;
  do {
    int64_t len = nbytes - pos < h->block_size ? nbytes - pos : h->block_size;
    Request req{write, files, static_cast<char*>(buf) + pos, len,
                offset + pos, ticket};
    {
      std::unique_lock<std::mutex> lock(h->mu);
      h->cv_space.wait(lock, [&] {
        return h->queue_limit == 0 ||
               static_cast<int64_t>(h->queue.size()) < h->queue_limit;
      });
      h->queue.push_back(std::move(req));
      ++h->inflight;
    }
    h->cv_work.notify_one();
    pos += len;
  } while (pos < nbytes);
  return ticket;
}

int64_t ds_aio_pread(void* handle, const char* path, void* buf, int64_t nbytes,
                     int64_t offset) {
  return submit(static_cast<Handle*>(handle), false, path, buf, nbytes,
                offset);
}

int64_t ds_aio_pwrite(void* handle, const char* path, const void* buf,
                      int64_t nbytes, int64_t offset) {
  return submit(static_cast<Handle*>(handle), true, path,
                const_cast<void*>(buf), nbytes, offset);
}

// Blocks until ONE request (ticket) completes; returns its failed-chunk
// count (0 = success). The ticket is forgotten afterwards.
int64_t ds_aio_wait_ticket(void* handle, int64_t ticket) {
  auto* h = static_cast<Handle*>(handle);
  std::unique_lock<std::mutex> lock(h->mu);
  auto done = [&] {
    auto it = h->ticket_remaining.find(ticket);
    return it == h->ticket_remaining.end() || it->second == 0;
  };
  h->cv_done.wait(lock, done);
  h->ticket_remaining.erase(ticket);
  auto it = h->ticket_errors.find(ticket);
  int64_t errs = it == h->ticket_errors.end() ? 0 : it->second;
  h->ticket_errors.erase(ticket);
  return errs;
}

// Blocks until all submitted requests complete. Returns the number of
// failed chunks since the last wait (0 = success).
int64_t ds_aio_wait(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  std::unique_lock<std::mutex> lock(h->mu);
  h->cv_done.wait(lock, [&] { return h->inflight == 0; });
  // everything is complete — drop per-ticket bookkeeping (callers mixing
  // wait()/wait_ticket() would otherwise leak map entries)
  h->ticket_remaining.clear();
  h->ticket_errors.clear();
  return h->errors.exchange(0);
}

int64_t ds_aio_pending(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  std::unique_lock<std::mutex> lock(h->mu);
  return h->inflight;
}

// 1 when the filesystem holding `path` accepts O_DIRECT opens (tmpfs and
// some network filesystems return EINVAL, in which case chunks silently
// use the buffered fd) — lets callers report o_direct_effective honestly.
int ds_aio_probe_o_direct(const char* path) {
#ifdef O_DIRECT
  // O_DIRECT opens are only valid on regular files (a directory open with
  // O_DIRECT fails with EINVAL even on filesystems that support it), so
  // probe with a scratch file when given a directory.
  struct stat st;
  if (::stat(path, &st) == 0 && S_ISDIR(st.st_mode)) {
    std::string probe = std::string(path) + "/.ds_odirect_probe";
    int fd = ::open(probe.c_str(), O_WRONLY | O_CREAT | O_DIRECT, 0644);
    if (fd >= 0) {
      ::close(fd);
      ::unlink(probe.c_str());
      return 1;
    }
    ::unlink(probe.c_str());
    return 0;
  }
  int fd = ::open(path, O_RDONLY | O_DIRECT);
  if (fd >= 0) {
    ::close(fd);
    return 1;
  }
#endif
  return 0;
}

}  // extern "C"
