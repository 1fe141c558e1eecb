// Native data loader: the port's copy of the C++ prefetching token loader
// (native/src/data_loader.cpp of the JAX package, the same code). A training
// step on the card must not wait on the host for its next batch.
//
// Design: a memory-mapped uint32 token corpus + a worker thread that fills
// a ring of batch buffers with random crops (xorshift64* PRNG, mirrored
// exactly by the Python twin in kubeflow_tpu_torch/training/loader.py for
// differential testing). The consumer overlaps device compute with the
// next batch's page faults + copies: classic double buffering.
//
// Flat C ABI, ctypes-bound. Single producer, single consumer, strict ring
// order -> deterministic batch sequence.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

inline uint64_t next_rng(uint64_t &s) {  // xorshift64*
  s ^= s >> 12;
  s ^= s << 25;
  s ^= s >> 27;
  return s * 2685821657736338717ULL;
}

struct Loader {
  int batch = 0, seq = 0, n_buffers = 0;
  uint64_t rng = 0;
  const uint32_t *corpus = nullptr;
  size_t n_tokens = 0;
  int fd = -1;
  size_t map_len = 0;

  std::vector<std::vector<int32_t>> bufs;
  // ring: worker fills produce_idx, consumer takes consume_idx; a buffer is
  // reusable once the consumer releases it
  std::vector<int> state;  // 0=free 1=full 2=held by consumer
  size_t produce_idx = 0, consume_idx = 0;
  std::mutex mu;
  std::condition_variable cv_free, cv_full;
  std::thread worker;
  std::atomic<bool> stopping{false};
  std::atomic<long> produced{0};

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_free.notify_all();
    cv_full.notify_all();
    if (worker.joinable()) worker.join();
    if (corpus) munmap(const_cast<uint32_t *>(corpus), map_len);
    if (fd >= 0) close(fd);
  }

  void fill(std::vector<int32_t> &buf) {
    const size_t span = n_tokens - static_cast<size_t>(seq);
    for (int b = 0; b < batch; ++b) {
      const size_t start = next_rng(rng) % span;
      const uint32_t *src = corpus + start;
      int32_t *dst = buf.data() + static_cast<size_t>(b) * seq;
      for (int t = 0; t < seq; ++t) dst[t] = static_cast<int32_t>(src[t]);
    }
  }

  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_free.wait(lk, [&] { return stopping || state[produce_idx] == 0; });
      if (stopping) return;
      const size_t idx = produce_idx;
      lk.unlock();
      fill(bufs[idx]);  // fill outside the lock: consumer keeps draining
      lk.lock();
      state[idx] = 1;
      produce_idx = (produce_idx + 1) % n_buffers;
      produced.fetch_add(1);
      cv_full.notify_one();
    }
  }
};

void set_err(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
  }
}

}  // namespace

extern "C" {

void *dl_open(const char *path, int batch, int seq, int n_buffers,
              uint64_t seed, char *err, int errlen) {
  if (batch < 1 || seq < 1 || n_buffers < 2) {
    set_err(err, errlen, "batch>=1, seq>=1, n_buffers>=2 required");
    return nullptr;
  }
  auto *l = new Loader();
  l->batch = batch;
  l->seq = seq;
  l->n_buffers = n_buffers;
  l->rng = seed ? seed : 0x9e3779b97f4a7c15ULL;  // xorshift state must be != 0

  l->fd = open(path, O_RDONLY);
  if (l->fd < 0) {
    set_err(err, errlen, "cannot open corpus file");
    delete l;
    return nullptr;
  }
  struct stat st;
  if (fstat(l->fd, &st) != 0 || st.st_size < (seq + 1) * 4) {
    set_err(err, errlen, "corpus smaller than one sequence");
    delete l;
    return nullptr;
  }
  l->map_len = static_cast<size_t>(st.st_size);
  void *m = mmap(nullptr, l->map_len, PROT_READ, MAP_PRIVATE, l->fd, 0);
  if (m == MAP_FAILED) {
    set_err(err, errlen, "mmap failed");
    delete l;
    return nullptr;
  }
  l->corpus = static_cast<const uint32_t *>(m);
  l->n_tokens = l->map_len / 4;

  l->bufs.assign(n_buffers, std::vector<int32_t>(
                                static_cast<size_t>(batch) * seq));
  l->state.assign(n_buffers, 0);
  l->worker = std::thread([l] { l->run(); });
  return l;
}

// Blocks until the next in-order batch is ready; returns the buffer index
// and writes its data pointer, or -1 if the loader is stopping.
int dl_next(void *p, int32_t **out) {
  auto *l = static_cast<Loader *>(p);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_full.wait(lk, [&] {
    return l->stopping.load() || l->state[l->consume_idx] == 1;
  });
  if (l->stopping) return -1;
  const size_t idx = l->consume_idx;
  l->state[idx] = 2;
  l->consume_idx = (l->consume_idx + 1) % l->n_buffers;
  *out = l->bufs[idx].data();
  return static_cast<int>(idx);
}

void dl_release(void *p, int idx) {
  auto *l = static_cast<Loader *>(p);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    if (idx >= 0 && idx < l->n_buffers && l->state[idx] == 2) {
      l->state[idx] = 0;
    }
  }
  l->cv_free.notify_one();
}

long dl_produced(void *p) {
  return static_cast<Loader *>(p)->produced.load();
}

long dl_corpus_tokens(void *p) {
  return static_cast<long>(static_cast<Loader *>(p)->n_tokens);
}

void dl_close(void *p) { delete static_cast<Loader *>(p); }

}  // extern "C"
