// Native host runtime for the TPU LDPC framework.
//
// Three independent subsystems behind a C ABI (ctypes-loaded from
// runtime/__init__.py):
//
//  1. Double-precision LDPC decoders — the framework's *oracle*: loop
//     ordering, accumulation order, tie handling, and early-exit placement
//     follow the behavioral spec in SURVEY.md §2 (#8-#12) of the reference's
//     decoders (the reference's lib/ldpc_decoder_cb_impl.cc:236-572), written
//     from that spec, not translated from the reference source. Used to
//     cross-validate the Python float64 oracle and the JAX/Pallas kernels
//     for bit-exact hard decisions, and as a fast golden-vector generator.
//
//  2. A lock-free single-producer/single-consumer byte ring buffer — the
//     native analog of the GNU Radio circular stream buffer (SURVEY.md L0)
//     for host-side inter-block streaming.
//
//  3. A streaming BMP reassembly scanner — the hot path of the image sink
//     (behavioral spec: lib/image_sink_impl.cc:46-84, with the improvement
//     that headers split across feed() chunks are still found).
//
//  4. A threaded stream-pipeline executor — the native analog of the GNU
//     Radio block scheduler (SURVEY.md L0: one thread per block, circular
//     buffers between): a file-source thread and a sink thread (BMP
//     reassembly + file write, or byte counting) run concurrently with the
//     host's device-dispatch stage, which pulls byte batches from the input
//     ring and pushes processed bytes to the output ring. This overlaps
//     host file IO and image scanning with accelerator compute.
//
// Codes are tiny (M,N <= 50,100), so decoders scan the dense H row/column
// and skip zeros — the identical arithmetic visit order to precomputed
// adjacency lists in ascending index order.

#include <atomic>
#include <cfloat>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. decoders (double precision, one frame per call; *_batch loops frames)
// ---------------------------------------------------------------------------

// Count nonzero syndrome entries of u under H, aborting once count > threshold.
int ldpc_check_frame(const int8_t* u, const int8_t* H, int M, int N,
                     int threshold) {
  int s_not_zero = 0;
  for (int i = 0; i < M; ++i) {
    long s = 0;
    for (int j = 0; j < N; ++j) {
      if (H[i * N + j]) s += u[j];
    }
    if (s % 2 != 0) ++s_not_zero;
    if (s_not_zero > threshold) break;
  }
  return s_not_zero;
}

static inline int sgn(double v) { return (v > 0) - (v < 0); }

// Slicer: rx < 0 -> 0 else 1.
void ldpc_decode_hard(const double* rx, int N, int8_t* vhat) {
  for (int j = 0; j < N; ++j) vhat[j] = rx[j] < 0 ? 0 : 1;
}

// Min-sum ("LogDomainSimple"): LLR init Lci = -rx; horizontal step
// Lr(i,j) = prod(alpha row) * alpha(i,j) * min_{k!=j} beta(i,k); vertical
// step Lq(i,j) = Lci(j) + sum Lr col - Lr(i,j); decision LQ < 0 -> 1;
// syndrome early-exit skipped on the final iteration.
void ldpc_decode_minsum(const double* rx, const int8_t* H, int M, int N,
                        int iterations, int8_t* vhat) {
  std::vector<double> Lci(N), Lq((size_t)M * N, 0.0), Lr((size_t)M * N, 0.0);
  for (int j = 0; j < N; ++j) Lci[j] = -rx[j];
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < N; ++j)
      if (H[i * N + j]) Lq[(size_t)i * N + j] = Lci[j];

  for (int n = 0; n < iterations; ++n) {
    for (int i = 0; i < M; ++i) {
      int prod_alpha = 1;
      for (int j = 0; j < N; ++j)
        if (H[i * N + j]) prod_alpha *= sgn(Lq[(size_t)i * N + j]);
      for (int j = 0; j < N; ++j) {
        if (!H[i * N + j]) continue;
        double min_beta = DBL_MAX;
        for (int k = 0; k < N; ++k) {
          if (!H[i * N + k] || k == j) continue;
          double b = std::fabs(Lq[(size_t)i * N + k]);
          if (b < min_beta) min_beta = b;
        }
        Lr[(size_t)i * N + j] =
            prod_alpha * sgn(Lq[(size_t)i * N + j]) * min_beta;
      }
    }
    for (int j = 0; j < N; ++j) {
      double sum_lr = 0.0;
      for (int i = 0; i < M; ++i)
        if (H[i * N + j]) sum_lr += Lr[(size_t)i * N + j];
      for (int i = 0; i < M; ++i)
        if (H[i * N + j])
          Lq[(size_t)i * N + j] = Lci[j] + sum_lr - Lr[(size_t)i * N + j];
      vhat[j] = (Lci[j] + sum_lr) < 0 ? 1 : 0;
    }
    if (n + 1 < iterations && ldpc_check_frame(vhat, H, M, N, 0) == 0) break;
  }
}

// Gallager-style majority bit-flip; flips assign NOT(y) (never reverting),
// flip when disagreements > M/2; early-exit skipped on the final iteration.
void ldpc_decode_bitflip(const double* rx, const int8_t* H, int M, int N,
                         int iterations, int8_t* vhat) {
  std::vector<int> y(N), ci(N);
  for (int j = 0; j < N; ++j) y[j] = ci[j] = rx[j] < 0.0 ? 0 : 1;
  std::vector<int> E((size_t)M * N, 0);
  for (int n = 0; n < iterations; ++n) {
    for (int i = 0; i < M; ++i) {
      int s_row = 0;
      for (int k = 0; k < N; ++k)
        if (H[i * N + k]) s_row += ci[k];
      for (int j = 0; j < N; ++j)
        if (H[i * N + j]) E[(size_t)i * N + j] = (s_row - ci[j]) % 2;
    }
    for (int j = 0; j < N; ++j) {
      int disagreements = 0;
      for (int i = 0; i < M; ++i)
        if (H[i * N + j] && E[(size_t)i * N + j] != y[j]) ++disagreements;
      if (disagreements > M / 2) ci[j] = (y[j] + 1) % 2;
    }
    for (int j = 0; j < N; ++j) vhat[j] = (int8_t)ci[j];
    if (n + 1 < iterations && ldpc_check_frame(vhat, H, M, N, 0) == 0) break;
  }
  for (int j = 0; j < N; ++j) vhat[j] = (int8_t)ci[j];
}

// Tanh-rule sum-product with the reference's nonstandard "+r(i) once per
// connected check" terms in both the tentative decision and the bit
// messages; syndrome checked EVERY iteration (before the bit-message step).
void ldpc_decode_sumproduct(const double* rx, const int8_t* H, int M, int N,
                            int iterations, int8_t* vhat) {
  std::vector<double> r(N), Msg((size_t)M * N, 0.0), E((size_t)M * N, 0.0),
      th(N);
  for (int i = 0; i < N; ++i) r[i] = -rx[i];
  for (int j = 0; j < M; ++j)
    for (int i = 0; i < N; ++i)
      if (H[j * N + i]) Msg[(size_t)j * N + i] = r[i];

  for (int n = 0; n < iterations; ++n) {
    for (int j = 0; j < M; ++j) {
      for (int k = 0; k < N; ++k)
        if (H[j * N + k]) th[k] = std::tanh(Msg[(size_t)j * N + k] / 2.0);
      for (int i = 0; i < N; ++i) {
        if (!H[j * N + i]) continue;
        double T = 1.0;
        for (int k = 0; k < N; ++k)
          if (H[j * N + k] && k != i) T *= th[k];
        E[(size_t)j * N + i] = std::log((1.0 + T) / (1.0 - T));
      }
    }
    for (int i = 0; i < N; ++i) {
      double L = 0.0;
      for (int j = 0; j < M; ++j)
        if (H[j * N + i]) L += E[(size_t)j * N + i] + r[i];
      vhat[i] = L <= 0 ? 1 : 0;
    }
    if (ldpc_check_frame(vhat, H, M, N, 0) == 0) break;
    for (int j = 0; j < M; ++j) {
      for (int i = 0; i < N; ++i) {
        if (!H[j * N + i]) continue;
        double T = 0.0;
        for (int k = 0; k < M; ++k)
          if (H[k * N + i] && k != j) T += E[(size_t)k * N + i] + r[i];
        Msg[(size_t)j * N + i] = T;
      }
    }
  }
}

// Batch drivers: rx (B, N) row-major -> vhat (B, N). method: 0=minsum,
// 1=sumproduct, 2=bitflip, 3=hard (the reference's method enum).
void ldpc_decode_batch(const double* rx, const int8_t* H, int M, int N, int B,
                       int iterations, int method, int8_t* vhat) {
  for (int b = 0; b < B; ++b) {
    const double* in = rx + (size_t)b * N;
    int8_t* out = vhat + (size_t)b * N;
    switch (method) {
      case 1: ldpc_decode_sumproduct(in, H, M, N, iterations, out); break;
      case 2: ldpc_decode_bitflip(in, H, M, N, iterations, out); break;
      case 3: ldpc_decode_hard(in, N, out); break;
      default: ldpc_decode_minsum(in, H, M, N, iterations, out); break;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. SPSC byte ring buffer
// ---------------------------------------------------------------------------

struct Ring {
  uint8_t* buf;
  size_t cap;  // power of two
  std::atomic<uint64_t> head{0};  // written by producer
  std::atomic<uint64_t> tail{0};  // written by consumer
};

void* ring_create(size_t capacity) {
  size_t cap = 1;
  while (cap < capacity) cap <<= 1;
  Ring* r = new Ring();
  r->buf = new uint8_t[cap];
  r->cap = cap;
  return r;
}

void ring_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  delete[] r->buf;
  delete r;
}

size_t ring_capacity(void* h) { return static_cast<Ring*>(h)->cap; }

size_t ring_size(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return (size_t)(r->head.load(std::memory_order_acquire) -
                  r->tail.load(std::memory_order_acquire));
}

// Push up to n bytes; returns bytes actually pushed (producer side).
size_t ring_push(void* h, const uint8_t* data, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_space = r->cap - (size_t)(head - tail);
  if (n > free_space) n = free_space;
  size_t pos = (size_t)(head & (r->cap - 1));
  size_t first = std::min(n, r->cap - pos);
  std::memcpy(r->buf + pos, data, first);
  std::memcpy(r->buf, data + first, n - first);
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Pop up to n bytes; returns bytes actually popped (consumer side).
size_t ring_pop(void* h, uint8_t* out, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = (size_t)(head - tail);
  if (n > avail) n = avail;
  size_t pos = (size_t)(tail & (r->cap - 1));
  size_t first = std::min(n, r->cap - pos);
  std::memcpy(out, r->buf + pos, first);
  std::memcpy(out + first, r->buf, n - first);
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// Peek without consuming (consumer side).
size_t ring_peek(void* h, uint8_t* out, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = (size_t)(head - tail);
  if (n > avail) n = avail;
  size_t pos = (size_t)(tail & (r->cap - 1));
  size_t first = std::min(n, r->cap - pos);
  std::memcpy(out, r->buf + pos, first);
  std::memcpy(out + first, r->buf, n - first);
  return n;
}

// ---------------------------------------------------------------------------
// 3. streaming BMP reassembly scanner
// ---------------------------------------------------------------------------

static const int kDibSizes[] = {12, 40, 52, 56, 64, 108, 124};

static bool is_bmp_header(const std::string& s, size_t i) {
  if (!((uint8_t)s[i] == 0x42 && (uint8_t)s[i + 1] == 0x4D)) return false;
  if (s[i + 6] || s[i + 7] || s[i + 8] || s[i + 9]) return false;
  uint8_t dib = (uint8_t)s[i + 14];
  for (int d : kDibSizes)
    if (dib == d) return true;
  return false;
}

struct BmpScanner {
  std::string stream;
  long img_start = -1;  // header offset within stream, -1 = none
  size_t file_size = 0;
  size_t scanned = 0;  // scan frontier
  std::deque<std::string> ready;
  uint64_t headers_found = 0;

  void flush_image() {
    if (img_start >= 0 && file_size > 0 &&
        stream.size() - (size_t)img_start >= file_size) {
      ready.emplace_back(stream.substr((size_t)img_start, file_size));
    }
  }

  void feed(const uint8_t* data, size_t n) {
    stream.append(reinterpret_cast<const char*>(data), n);
    // scan with the reference's 18-byte lookahead bound
    while (scanned + 19 <= stream.size()) {
      size_t i = scanned;
      if (is_bmp_header(stream, i)) {
        if (img_start >= 0) flush_image();  // previous image complete -> emit
        img_start = (long)i;
        file_size = (uint8_t)stream[i + 2] | ((uint8_t)stream[i + 3] << 8) |
                    ((uint8_t)stream[i + 4] << 16) |
                    ((uint32_t)(uint8_t)stream[i + 5] << 24);
        ++headers_found;
      }
      ++scanned;
    }
    size_t keep_from = img_start >= 0 ? (size_t)img_start : scanned;
    if (keep_from > 0) {
      stream.erase(0, keep_from);
      scanned -= keep_from;
      if (img_start >= 0) img_start = 0;
    }
  }
};

void* bmp_scanner_create() { return new BmpScanner(); }
void bmp_scanner_destroy(void* h) { delete static_cast<BmpScanner*>(h); }

void bmp_scanner_feed(void* h, const uint8_t* data, size_t n) {
  static_cast<BmpScanner*>(h)->feed(data, n);
}

// Flush at stream end (emits the final image if complete).
void bmp_scanner_finish(void* h) { static_cast<BmpScanner*>(h)->flush_image(); }

uint64_t bmp_scanner_headers_found(void* h) {
  return static_cast<BmpScanner*>(h)->headers_found;
}

// Size of the next completed image, or 0 if none pending.
size_t bmp_scanner_next_size(void* h) {
  BmpScanner* s = static_cast<BmpScanner*>(h);
  return s->ready.empty() ? 0 : s->ready.front().size();
}

// Copy the next completed image into out (cap bytes) and drop it from the
// queue; returns bytes written, 0 if none or cap too small.
size_t bmp_scanner_pop_image(void* h, uint8_t* out, size_t cap) {
  BmpScanner* s = static_cast<BmpScanner*>(h);
  if (s->ready.empty() || s->ready.front().size() > cap) return 0;
  const std::string& img = s->ready.front();
  std::memcpy(out, img.data(), img.size());
  size_t n = img.size();
  s->ready.pop_front();
  return n;
}

// ---------------------------------------------------------------------------
// 4. threaded stream-pipeline executor
// ---------------------------------------------------------------------------

static void spin_yield() {
  std::this_thread::sleep_for(std::chrono::microseconds(50));
}

struct Pipeline {
  Ring* in;          // source thread -> device stage
  Ring* out;         // device stage -> sink thread
  std::thread src_thread, sink_thread;
  std::atomic<bool> src_done{false};
  std::atomic<bool> out_done{false};
  std::atomic<bool> stop{false};
  std::atomic<bool> sink_finished{false};
  std::atomic<uint64_t> bytes_in{0}, bytes_out{0}, images_written{0};
  BmpScanner scanner;
  std::string sink_path;

  ~Pipeline() {
    stop.store(true);
    if (src_thread.joinable()) src_thread.join();
    if (sink_thread.joinable()) sink_thread.join();
    ring_destroy(in);
    ring_destroy(out);
  }
};

void* pipe_create(size_t ring_capacity) {
  Pipeline* p = new Pipeline();
  p->in = static_cast<Ring*>(ring_create(ring_capacity));
  p->out = static_cast<Ring*>(ring_create(ring_capacity));
  return p;
}

void pipe_destroy(void* h) { delete static_cast<Pipeline*>(h); }

// Source thread: stream a file into the input ring `repeats` times,
// zero-padding the tail to a multiple of `align` bytes (frame alignment).
int pipe_start_file_source(void* h, const char* path, int repeats,
                           size_t align) {
  Pipeline* p = static_cast<Pipeline*>(h);
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  std::string data((std::istreambuf_iterator<char>(f)),
                   std::istreambuf_iterator<char>());
  if (align > 1 && data.size() % align)
    data.append(align - data.size() % align, '\0');
  p->src_thread = std::thread([p, data, repeats]() {
    for (int rep = 0; rep < repeats && !p->stop.load(); ++rep) {
      size_t off = 0;
      while (off < data.size() && !p->stop.load()) {
        size_t n = ring_push(
            p->in, reinterpret_cast<const uint8_t*>(data.data()) + off,
            data.size() - off);
        off += n;
        p->bytes_in.fetch_add(n);
        if (n == 0) spin_yield();
      }
    }
    p->src_done.store(true, std::memory_order_release);
  });
  return 0;
}

// Sink thread: drain the output ring through the BMP scanner, writing each
// completed image to `path` (the reference's image_sink overwrites
// result.bmp per image, lib/image_sink_impl.cc:61-64).
int pipe_start_bmp_sink(void* h, const char* path) {
  Pipeline* p = static_cast<Pipeline*>(h);
  p->sink_path = path;
  p->sink_thread = std::thread([p]() {
    std::vector<uint8_t> buf(1 << 16);
    auto drain_images = [p]() {
      while (!p->scanner.ready.empty()) {
        const std::string& img = p->scanner.ready.front();
        std::ofstream o(p->sink_path, std::ios::binary | std::ios::trunc);
        o.write(img.data(), (std::streamsize)img.size());
        o.close();
        p->scanner.ready.pop_front();
        p->images_written.fetch_add(1);
      }
    };
    for (;;) {
      size_t n = ring_pop(p->out, buf.data(), buf.size());
      if (n) {
        p->scanner.feed(buf.data(), n);
        p->bytes_out.fetch_add(n);
        drain_images();
      } else if (p->stop.load() ||
                 (p->out_done.load(std::memory_order_acquire) &&
                  ring_size(p->out) == 0)) {
        p->scanner.flush_image();
        drain_images();
        break;
      } else {
        spin_yield();
      }
    }
    p->sink_finished.store(true, std::memory_order_release);
  });
  return 0;
}

// Device-stage pull: block until >= min_bytes are available (or the source
// finished), then pop up to n bytes. Returns 0 only at end of stream.
size_t pipe_pull(void* h, uint8_t* buf, size_t n, size_t min_bytes) {
  Pipeline* p = static_cast<Pipeline*>(h);
  for (;;) {
    size_t avail = ring_size(p->in);
    bool done = p->src_done.load(std::memory_order_acquire);
    if (avail >= min_bytes || (done && avail > 0))
      return ring_pop(p->in, buf, n);
    if (done || p->stop.load()) return 0;
    spin_yield();
  }
}

// Device-stage push: block until everything is written to the output ring.
void pipe_push(void* h, const uint8_t* buf, size_t n) {
  Pipeline* p = static_cast<Pipeline*>(h);
  size_t off = 0;
  while (off < n && !p->stop.load()) {
    size_t w = ring_push(p->out, buf + off, n - off);
    off += w;
    if (w == 0) spin_yield();
  }
}

// Signal that no more pushes are coming, and wait for the sink to drain.
void pipe_finish(void* h) {
  Pipeline* p = static_cast<Pipeline*>(h);
  p->out_done.store(true, std::memory_order_release);
  while (p->sink_thread.joinable() &&
         !p->sink_finished.load(std::memory_order_acquire))
    spin_yield();
}

uint64_t pipe_bytes_in(void* h) { return static_cast<Pipeline*>(h)->bytes_in.load(); }
uint64_t pipe_bytes_out(void* h) { return static_cast<Pipeline*>(h)->bytes_out.load(); }
uint64_t pipe_images_written(void* h) {
  return static_cast<Pipeline*>(h)->images_written.load();
}
uint64_t pipe_headers_found(void* h) {
  return static_cast<Pipeline*>(h)->scanner.headers_found;
}

}  // extern "C"
