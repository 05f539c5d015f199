// Native threaded PNG loader/prefetcher of lldslam_tpu_torch.
//
// Counterpart of lldslam_tpu/native/loader.cpp: a pool of C++ worker
// threads decodes the PNG frames of a sequence ahead of the tracker, inside
// a window that follows the consumer, so Python never sits in the decode
// path. Exposed through a C ABI consumed with ctypes (native/__init__.py).
//
// The JAX package decodes with libpng's simplified API. The machine with
// the card has no libpng, so this file carries its own decoder: it parses
// the chunks (CRCs checked), inflates the IDAT stream with zlib and undoes
// the five scanline filters. It reads what KITTI (image_0/1) and EuRoC
// (cam0/1) store: 8-bit grayscale, not interlaced. Every other format is
// refused with its own status code, never converted.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread loader.cpp -lz

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Status codes (native/__init__.py names them).
constexpr int kOk = 1;
constexpr int kPending = 0;
constexpr int kCannotOpen = -1;
constexpr int kNotPng = -2;
constexpr int kUnsupported = -3;   // not 8-bit gray, or interlaced
constexpr int kCorrupt = -4;       // bad chunk, CRC, zlib stream or filter
constexpr int kTooSmall = -5;      // the caller's buffer is too small

struct Header {
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof buf, f)) > 0)
    out->insert(out->end(), buf, buf + n);
  bool ok = !std::ferror(f);
  std::fclose(f);
  return ok;
}

// Walks the chunks: fills the header and, where idat is given, the
// concatenated IDAT payload. Returns a status code.
int parse(const std::vector<uint8_t>& f, Header* hd,
          std::vector<uint8_t>* idat) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (f.size() < 8 || std::memcmp(f.data(), sig, 8) != 0) return kNotPng;
  size_t pos = 8;
  bool have_ihdr = false;
  while (true) {
    if (pos + 12 > f.size()) return kCorrupt;
    uint32_t len = be32(&f[pos]);
    if (len > f.size() - pos - 12) return kCorrupt;
    const uint8_t* type = &f[pos + 4];
    const uint8_t* data = &f[pos + 8];
    uint32_t crc = be32(data + len);
    if (crc32(crc32(0L, Z_NULL, 0), type, len + 4) != crc) return kCorrupt;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) return kCorrupt;
      hd->w = be32(data);
      hd->h = be32(data + 4);
      hd->bit_depth = data[8];
      hd->color_type = data[9];
      hd->interlace = data[12];
      if (data[10] != 0 || data[11] != 0 || hd->w == 0 || hd->h == 0)
        return kCorrupt;
      have_ihdr = true;
      if (!idat) return kOk;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (!have_ihdr) return kCorrupt;
      idat->insert(idat->end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if (!(type[0] & 0x20)) {
      return kUnsupported;   // a critical chunk this decoder does not know
    }
    pos += 12 + size_t(len);
  }
  return have_ihdr ? kOk : kCorrupt;
}

bool supported(const Header& hd) {
  return hd.bit_depth == 8 && hd.color_type == 0 && hd.interlace == 0;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Decodes one 8-bit grayscale PNG into out (h * w bytes, row-major).
int decode(const char* path, std::vector<uint8_t>* out, uint32_t* w,
           uint32_t* h) {
  std::vector<uint8_t> f, idat;
  if (!read_file(path, &f)) return kCannotOpen;
  Header hd;
  int st = parse(f, &hd, &idat);
  if (st != kOk) return st;
  if (!supported(hd)) return kUnsupported;
  size_t stride = size_t(hd.w) + 1;   // filter byte + one byte a pixel
  std::vector<uint8_t> raw(stride * hd.h);
  uLongf n = raw.size();
  if (uncompress(raw.data(), &n, idat.data(), idat.size()) != Z_OK ||
      n != raw.size())
    return kCorrupt;
  out->assign(size_t(hd.w) * hd.h, 0);
  for (uint32_t y = 0; y < hd.h; ++y) {
    const uint8_t* src = &raw[y * stride];
    uint8_t* row = &(*out)[size_t(y) * hd.w];
    const uint8_t* up = y ? row - hd.w : nullptr;
    int filter = src[0];
    ++src;
    for (uint32_t x = 0; x < hd.w; ++x) {
      int a = x ? row[x - 1] : 0;
      int b = up ? up[x] : 0;
      int c = (x && up) ? up[x - 1] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return kCorrupt;
      }
      row[x] = uint8_t(src[x] + pred);
    }
  }
  *w = hd.w;
  *h = hd.h;
  return kOk;
}

// Decodes one file into the caller's buffer of cap bytes.
int read_into(const char* path, uint8_t* out, uint32_t* w, uint32_t* h,
              size_t cap) {
  std::vector<uint8_t> data;
  int st = decode(path, &data, w, h);
  if (st != kOk) return st;
  if (data.size() > cap) return kTooSmall;
  std::memcpy(out, data.data(), data.size());
  return kOk;
}

struct Slot {
  std::vector<uint8_t> data;
  uint32_t w = 0, h = 0;
  int status = kPending;
  bool consumed = false;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_work;
  std::atomic<size_t> next_decode{0};
  std::atomic<size_t> consumer_pos{0};
  size_t window;
  std::atomic<bool> stop{false};

  Loader(const char** cpaths, size_t n, size_t window_, size_t n_threads)
      : paths(cpaths, cpaths + n), slots(n), window(window_) {
    for (size_t t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~Loader() {
    stop = true;
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  void run() {
    while (!stop) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] {
          return stop || (next_decode < paths.size() &&
                          next_decode < consumer_pos + window);
        });
        if (stop) return;
        idx = next_decode.fetch_add(1);
        if (idx >= paths.size()) return;
      }
      Slot tmp;
      tmp.status = decode(paths[idx].c_str(), &tmp.data, &tmp.w, &tmp.h);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[idx] = std::move(tmp);
      }
      cv_ready.notify_all();
    }
  }

  // Blocks until frame idx is decoded; returns a status code. A frame read
  // before (its pixels released) is decoded again on the calling thread.
  int get(size_t idx, uint8_t* out, uint32_t* w, uint32_t* h, size_t cap) {
    {
      std::lock_guard<std::mutex> lk(mu);
      consumer_pos = idx;  // advance the prefetch window
    }
    cv_work.notify_all();
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return slots[idx].status != kPending; });
    Slot& s = slots[idx];
    if (s.status != kOk) return s.status;
    if (s.consumed) {
      lk.unlock();
      return read_into(paths[idx].c_str(), out, w, h, cap);
    }
    *w = s.w;
    *h = s.h;
    size_t n = static_cast<size_t>(s.w) * s.h;
    if (n > cap) return kTooSmall;
    std::memcpy(out, s.data.data(), n);
    // release memory behind the consumer
    s.data.clear();
    s.data.shrink_to_fit();
    s.consumed = true;
    return kOk;
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, size_t n, size_t window,
                    size_t n_threads) {
  return new Loader(paths, n, window, n_threads);
}

int loader_get(void* handle, size_t idx, uint8_t* out, uint32_t* w,
               uint32_t* h, size_t cap) {
  return static_cast<Loader*>(handle)->get(idx, out, w, h, cap);
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// Reads the header of one file: size, bit depth, colour type, interlace.
int loader_probe(const char* path, uint32_t* w, uint32_t* h, int* bit_depth,
                 int* color_type, int* interlace) {
  std::vector<uint8_t> f;
  if (!read_file(path, &f)) return kCannotOpen;
  Header hd;
  int st = parse(f, &hd, nullptr);
  if (st != kOk) return st;
  *w = hd.w;
  *h = hd.h;
  *bit_depth = hd.bit_depth;
  *color_type = hd.color_type;
  *interlace = hd.interlace;
  return kOk;
}

// Decodes one file on the calling thread.
int loader_read(const char* path, uint8_t* out, uint32_t* w, uint32_t* h,
                size_t cap) {
  return read_into(path, out, w, h, cap);
}

}  // extern "C"
