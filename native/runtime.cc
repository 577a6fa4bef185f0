// Native host runtime for the LTE PHY framework.
//
// Counterparts of the reference's host-side C/C++ runtime
// (SURVEY.md §2.2/§2.3): while JAX/XLA owns the compute path, the
// real-time edges of the system — sample transport, buffering, packet
// capture — stay native so the Python orchestration never sits between
// the wire and the sample stream.
//
//  * spsc ring buffer for IQ samples  (reference: lib/src/phy/utils/ringbuffer.c)
//  * TCP IQ bridge: virtual-radio sample exchange with sample-count-as-
//    clock semantics                  (reference: lib/src/phy/rf/rf_zmq_imp*.c)
//  * background pcap writer w/ UDP framing
//                                     (reference: lib/src/common/mac_pcap_base.h)
//
// Exposed as a flat C API consumed via ctypes (srsran_4g_tpu/runtime/).

#include <arpa/inet.h>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <queue>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ring buffer

struct rt_ringbuffer {
  std::vector<float> data;  // interleaved I/Q
  size_t capacity;          // in complex samples
  std::atomic<size_t> head{0};
  std::atomic<size_t> tail{0};
};

rt_ringbuffer* rt_rb_create(size_t capacity_samples) {
  auto* rb = new rt_ringbuffer();
  rb->capacity = capacity_samples + 1;
  rb->data.resize(rb->capacity * 2);
  return rb;
}

void rt_rb_destroy(rt_ringbuffer* rb) { delete rb; }

size_t rt_rb_size(const rt_ringbuffer* rb) {
  size_t h = rb->head.load(std::memory_order_acquire);
  size_t t = rb->tail.load(std::memory_order_acquire);
  return (h + rb->capacity - t) % rb->capacity;
}

size_t rt_rb_space(const rt_ringbuffer* rb) {
  return rb->capacity - 1 - rt_rb_size(rb);
}

// returns samples written (may be < n if full)
size_t rt_rb_write(rt_ringbuffer* rb, const float* iq, size_t n) {
  n = std::min(n, rt_rb_space(rb));
  size_t h = rb->head.load(std::memory_order_relaxed);
  for (size_t i = 0; i < n; i++) {
    size_t idx = (h + i) % rb->capacity;
    rb->data[2 * idx] = iq[2 * i];
    rb->data[2 * idx + 1] = iq[2 * i + 1];
  }
  rb->head.store((h + n) % rb->capacity, std::memory_order_release);
  return n;
}

// returns samples read; zero-fills nothing (caller decides)
size_t rt_rb_read(rt_ringbuffer* rb, float* iq, size_t n) {
  n = std::min(n, rt_rb_size(rb));
  size_t t = rb->tail.load(std::memory_order_relaxed);
  for (size_t i = 0; i < n; i++) {
    size_t idx = (t + i) % rb->capacity;
    iq[2 * i] = rb->data[2 * idx];
    iq[2 * i + 1] = rb->data[2 * idx + 1];
  }
  rb->tail.store((t + n) % rb->capacity, std::memory_order_release);
  return n;
}

// ------------------------------------------------------------------ iq bridge
//
// One TX endpoint streams length-prefixed IQ buffers to one RX endpoint
// over TCP (loopback or LAN).  Like the reference's ZMQ radio, the
// receiver's clock advances with the samples it reads: rt_bridge_rx_read
// blocks until the requested sample count arrived, so two processes
// lock-step through virtual time with no hardware.

struct rt_bridge_tx {
  int listen_fd = -1;
  int fd = -1;
};

struct rt_bridge_rx {
  int fd = -1;
  std::vector<float> pending;
  size_t pending_pos = 0;  // in complex samples
  uint64_t rx_count = 0;
};

rt_bridge_tx* rt_bridge_tx_create(uint16_t port) {
  auto* b = new rt_bridge_tx();
  b->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(b->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (bind(b->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(b->listen_fd, 1) != 0) {
    close(b->listen_fd);
    delete b;
    return nullptr;
  }
  return b;
}

// blocks until a receiver connects; returns 0 on success
int rt_bridge_tx_accept(rt_bridge_tx* b) {
  b->fd = accept(b->listen_fd, nullptr, nullptr);
  if (b->fd < 0) return -1;
  int one = 1;
  setsockopt(b->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return 0;
}

static bool write_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n) {
    ssize_t w = ::write(fd, p, n);
    if (w <= 0) return false;
    p += w;
    n -= w;
  }
  return true;
}

static bool read_all(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= r;
  }
  return true;
}

int rt_bridge_tx_send(rt_bridge_tx* b, const float* iq, uint32_t n_samples) {
  if (b->fd < 0) return -1;
  uint32_t hdr = htonl(n_samples);
  if (!write_all(b->fd, &hdr, 4)) return -1;
  if (!write_all(b->fd, iq, (size_t)n_samples * 8)) return -1;
  return 0;
}

void rt_bridge_tx_destroy(rt_bridge_tx* b) {
  if (b->fd >= 0) close(b->fd);
  if (b->listen_fd >= 0) close(b->listen_fd);
  delete b;
}

rt_bridge_rx* rt_bridge_rx_connect(const char* host, uint16_t port,
                                   int timeout_ms) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  inet_pton(AF_INET, host, &addr.sin_addr);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    if (std::chrono::steady_clock::now() > deadline) {
      close(fd);
      return nullptr;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* b = new rt_bridge_rx();
  b->fd = fd;
  return b;
}

// blocking read of exactly n samples (virtual clock advance); returns 0 ok
int rt_bridge_rx_read(rt_bridge_rx* b, float* iq, uint32_t n_samples) {
  uint32_t got = 0;
  while (got < n_samples) {
    size_t avail = b->pending.size() / 2 - b->pending_pos;
    if (avail == 0) {
      uint32_t hdr;
      if (!read_all(b->fd, &hdr, 4)) return -1;
      uint32_t n = ntohl(hdr);
      b->pending.resize((size_t)n * 2);
      b->pending_pos = 0;
      if (!read_all(b->fd, b->pending.data(), (size_t)n * 8)) return -1;
      avail = n;
    }
    uint32_t take = std::min<uint32_t>(n_samples - got, (uint32_t)avail);
    memcpy(iq + (size_t)got * 2,
           b->pending.data() + b->pending_pos * 2, (size_t)take * 8);
    b->pending_pos += take;
    got += take;
  }
  b->rx_count += n_samples;
  return 0;
}

uint64_t rt_bridge_rx_count(const rt_bridge_rx* b) { return b->rx_count; }

void rt_bridge_rx_destroy(rt_bridge_rx* b) {
  if (b->fd >= 0) close(b->fd);
  delete b;
}

// ----------------------------------------------------------------- pcap writer

struct rt_pcap {
  FILE* f = nullptr;
  std::thread worker;
  std::mutex m;
  std::condition_variable cv;
  std::queue<std::vector<uint8_t>> q;
  std::atomic<bool> stop{false};
  size_t max_queue = 1024;  // reference's 1024-deep blocking queue
};

static void pcap_write_global_header(FILE* f) {
  struct {
    uint32_t magic = 0xa1b2c3d4;
    uint16_t vmaj = 2, vmin = 4;
    int32_t thiszone = 0;
    uint32_t sigfigs = 0, snaplen = 65535, network = 1;  // DLT_EN10MB
  } __attribute__((packed)) hdr;
  fwrite(&hdr, sizeof(hdr), 1, f);
}

rt_pcap* rt_pcap_open(const char* path) {
  auto* p = new rt_pcap();
  p->f = fopen(path, "wb");
  if (!p->f) {
    delete p;
    return nullptr;
  }
  pcap_write_global_header(p->f);
  p->worker = std::thread([p] {
    std::unique_lock<std::mutex> lk(p->m);
    while (!p->stop.load() || !p->q.empty()) {
      if (p->q.empty()) {
        p->cv.wait_for(lk, std::chrono::milliseconds(100));
        continue;
      }
      auto pkt = std::move(p->q.front());
      p->q.pop();
      lk.unlock();
      auto now = std::chrono::system_clock::now().time_since_epoch();
      uint32_t sec = (uint32_t)std::chrono::duration_cast<std::chrono::seconds>(now).count();
      uint32_t usec = (uint32_t)(std::chrono::duration_cast<std::chrono::microseconds>(now).count() % 1000000);
      uint32_t len = (uint32_t)pkt.size();
      uint32_t rec[4] = {sec, usec, len, len};
      fwrite(rec, sizeof(rec), 1, p->f);
      fwrite(pkt.data(), 1, pkt.size(), p->f);
      lk.lock();
    }
  });
  return p;
}

int rt_pcap_write(rt_pcap* p, const uint8_t* data, uint32_t len) {
  std::unique_lock<std::mutex> lk(p->m);
  if (p->q.size() >= p->max_queue) return -1;  // drop when saturated
  p->q.emplace(data, data + len);
  p->cv.notify_one();
  return 0;
}

void rt_pcap_close(rt_pcap* p) {
  p->stop.store(true);
  p->cv.notify_one();
  if (p->worker.joinable()) p->worker.join();
  fclose(p->f);
  delete p;
}

}  // extern "C"
