// Native prefetching image loader for the training data path.
//
// The reference's host runtime is C++ end-to-end; its loader story is
// src/splat/file_io.cpp (+ happly). Our training extension streams posed
// PNG images (io/dataset.py), and decoding them one-by-one through PIL is
// the slowest part of dataset startup. This component is the host-side
// equivalent of a native data loader: a worker pool that reads + inflates
// (system zlib) + defilters + downscales PNGs concurrently, handing dense
// float32 HWC buffers to Python through a C ABI (ctypes, io/native.py).
//
// Supported PNGs: 8-bit depth, color types 0 (gray), 2 (RGB),
// 4 (gray+alpha), 6 (RGBA), non-interlaced — exactly what NeRF-synthetic /
// nerfstudio datasets contain. Anything else returns a nonzero status and
// the caller falls back to PIL.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Decoded {
  int64_t status = 1;  // 0 ok; 1 io/parse error; 2 unsupported format
  int64_t w = 0, h = 0, c = 0;   // post-downscale dims
  int64_t w0 = 0, h0 = 0;        // original dims (intrinsics scaling)
  float* data = nullptr;         // malloc'd (h, w, c) float32 in [0, 1]
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
      pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Decode one PNG file into `out`. No exceptions; status-coded.
void decode_png(const std::string& path, int64_t downscale, Decoded* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size > 0 ? size : 0);
  if (size <= 8 || std::fread(buf.data(), 1, size, f) != size_t(size)) {
    std::fclose(f);
    return;
  }
  std::fclose(f);

  static const uint8_t kMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                    0x1a, '\n'};
  if (std::memcmp(buf.data(), kMagic, 8) != 0) return;

  int64_t w = 0, h = 0, channels = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const uint8_t* tag = &buf[pos + 4];
    const uint8_t* payload = &buf[pos + 8];
    if (pos + 12 + len > buf.size()) return;
    if (!std::memcmp(tag, "IHDR", 4) && len >= 13) {
      w = be32(payload);
      h = be32(payload + 4);
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || idat.empty()) return;
  switch (color_type) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: out->status = 2; return;  // palette -> PIL fallback
  }
  if (bit_depth != 8 || interlace != 0) {
    out->status = 2;
    return;
  }

  const int64_t stride = w * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  {
    uLongf dest_len = raw.size();
    if (uncompress(raw.data(), &dest_len, idat.data(), idat.size()) != Z_OK
        || dest_len != raw.size())
      return;
  }

  // Defilter in place into `img` (sequential per row; Paeth dependencies).
  std::vector<uint8_t> img(stride * h);
  const int64_t bpp = channels;
  for (int64_t y = 0; y < h; ++y) {
    uint8_t ftype = raw[y * (stride + 1)];
    const uint8_t* line = &raw[y * (stride + 1) + 1];
    uint8_t* cur = &img[y * stride];
    const uint8_t* up = y ? &img[(y - 1) * stride] : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      int a = x >= bpp ? cur[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int v = line[x];
      switch (ftype) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: return;
      }
      cur[x] = uint8_t(v);
    }
  }

  out->w0 = w;
  out->h0 = h;
  int64_t ow = w, oh = h;
  if (downscale > 1) {
    ow = w / downscale;
    oh = h / downscale;
    if (ow < 1 || oh < 1) {
      out->status = 2;
      return;
    }
  }
  float* data = static_cast<float*>(std::malloc(ow * oh * channels *
                                                sizeof(float)));
  if (!data) return;
  const float inv255 = 1.0f / 255.0f;
  if (downscale <= 1) {
    for (int64_t i = 0; i < oh * ow * channels; ++i)
      data[i] = img[i] * inv255;
  } else {
    // Area average over downscale x downscale blocks (the antialiased
    // reduction PIL's BILINEAR approximates for integer factors).
    const float norm = inv255 / float(downscale * downscale);
    for (int64_t y = 0; y < oh; ++y) {
      for (int64_t x = 0; x < ow; ++x) {
        for (int64_t ch = 0; ch < channels; ++ch) {
          float acc = 0.0f;
          for (int64_t dy = 0; dy < downscale; ++dy) {
            const uint8_t* row = &img[(y * downscale + dy) * stride];
            for (int64_t dx = 0; dx < downscale; ++dx)
              acc += row[(x * downscale + dx) * channels + ch];
          }
          data[(y * ow + x) * channels + ch] = acc * norm;
        }
      }
    }
  }
  out->w = ow;
  out->h = oh;
  out->c = channels;
  out->data = data;
  out->status = 0;
}

struct Loader {
  struct Job {
    int64_t id;
    std::string path;
    int64_t downscale;
  };
  std::mutex mu;
  std::condition_variable job_cv, done_cv;
  std::deque<Job> jobs;
  std::unordered_map<int64_t, Decoded> done;
  std::vector<std::thread> workers;
  int64_t next_id = 0;
  bool stopping = false;

  explicit Loader(int64_t nthreads) {
    for (int64_t t = 0; t < nthreads; ++t)
      workers.emplace_back([this] { run(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    job_cv.notify_all();
    for (auto& th : workers) th.join();
    for (auto& kv : done) std::free(kv.second.data);
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        job_cv.wait(lk, [this] { return stopping || !jobs.empty(); });
        if (stopping && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      Decoded result;
      decode_png(job.path, job.downscale, &result);
      {
        std::lock_guard<std::mutex> lk(mu);
        done[job.id] = result;
      }
      done_cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(int64_t nthreads) {
  if (nthreads <= 0) {
    nthreads = std::max(1u, std::thread::hardware_concurrency() / 2);
  }
  return new Loader(nthreads);
}

void loader_destroy(void* l) { delete static_cast<Loader*>(l); }

int64_t loader_submit(void* l, const char* path, int64_t downscale) {
  auto* ld = static_cast<Loader*>(l);
  int64_t id;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    id = ld->next_id++;
    ld->jobs.push_back({id, path, downscale});
  }
  ld->job_cv.notify_one();
  return id;
}

// Blocks until job `id` completes. Returns the decode status (0 = ok); on
// success *data is a malloc'd float32 (h, w, c) buffer — free with
// loader_free after copying.
int64_t loader_fetch(void* l, int64_t id, float** data, int64_t* w,
                     int64_t* h, int64_t* c, int64_t* w0, int64_t* h0) {
  auto* ld = static_cast<Loader*>(l);
  std::unique_lock<std::mutex> lk(ld->mu);
  ld->done_cv.wait(lk, [&] { return ld->done.count(id) > 0; });
  Decoded result = ld->done[id];
  ld->done.erase(id);
  *data = result.data;
  *w = result.w;
  *h = result.h;
  *c = result.c;
  *w0 = result.w0;
  *h0 = result.h0;
  return result.status;
}

void loader_free(float* data) { std::free(data); }

}  // extern "C"
