// Native host-side image IO of the PyTorch port (the port's copy of
// native/mvo_io.cpp, same C ABI).
//
// Replaces the reference's cv2.imread(IMREAD_GRAYSCALE) per-frame disk reads
// (reference utils.py:55-65,:77-81): a minimal PNG decoder (zlib inflate +
// PNG reconstruction filters) plus a threaded prefetch pool that keeps
// decoded frames ahead of the device loop, so PNG decode never stalls the
// card.
//
// Exposed as a C ABI consumed from Python via ctypes (dataio/native_io.py),
// built with g++ at first use by _build.build_host.  Supported PNGs:
// 8/16-bit grayscale, 8-bit gray+alpha / RGB / RGBA (converted to gray),
// non-interlaced, which covers KITTI / Parking / Malaga rectified images.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> pixels;  // grayscale, [0, 255]
  bool ok = false;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image decode_png(const uint8_t* data, size_t size) {
  Image img;
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || std::memcmp(data, magic, 8) != 0) return img;

  size_t pos = 8;
  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;

  while (pos + 8 <= size) {
    uint32_t len = be32(data + pos);
    const char* type = reinterpret_cast<const char*>(data + pos + 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + len > size) return img;

    if (std::memcmp(type, "IHDR", 4) == 0) {
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }

  if (width <= 0 || height <= 0 || interlace != 0) return img;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return img;          // palette unsupported
  }
  if (bit_depth != 8 && !(bit_depth == 16 && color_type == 0)) return img;

  int bytes_per_px = channels * bit_depth / 8;
  size_t stride = size_t(width) * bytes_per_px;
  std::vector<uint8_t> raw((stride + 1) * height);

  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return img;
  }

  // Undo per-scanline filters in place.
  std::vector<uint8_t> out(stride * height);
  for (int y = 0; y < height; ++y) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = out.data() + stride * y;
    const uint8_t* up = y > 0 ? out.data() + stride * (y - 1) : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bytes_per_px) ? dst[x - bytes_per_px] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bytes_per_px)) ? up[x - bytes_per_px] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return img;
      }
      dst[x] = uint8_t(v);
    }
  }

  img.width = width;
  img.height = height;
  img.pixels.resize(size_t(width) * height);
  const uint8_t* p = out.data();
  for (size_t i = 0; i < img.pixels.size(); ++i) {
    float v;
    if (color_type == 0 && bit_depth == 16) {
      v = float((p[2 * i] << 8) | p[2 * i + 1]) * (255.0f / 65535.0f);
    } else if (channels == 1) {
      v = float(p[i]);
    } else if (channels == 2) {
      v = float(p[2 * i]);
    } else {
      const uint8_t* px = p + i * channels;
      // cv2 grayscale conversion weights (BT.601), PNG byte order is RGB.
      v = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
    }
    img.pixels[i] = v;
  }
  img.ok = true;
  return img;
}

Image load_png_file(const std::string& path) {
  Image img;
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return img;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  size_t rd = std::fread(buf.data(), 1, size, f);
  std::fclose(f);
  if (long(rd) != size) return img;
  return decode_png(buf.data(), buf.size());
}

// ---------------------------------------------------------------------------
// Prefetching sequence reader: worker threads decode ahead of the consumer;
// frames are handed out strictly in order.
// ---------------------------------------------------------------------------

struct Sequence {
  std::vector<std::string> paths;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produced;
  std::condition_variable cv_space;
  std::vector<Image> slots;       // ring buffer of decoded frames
  std::vector<std::atomic<int>> ready;  // 0 empty, 1 full
  std::atomic<size_t> next_to_decode{0};
  size_t next_to_consume = 0;
  size_t window = 0;
  std::atomic<bool> stop{false};

  explicit Sequence(std::vector<std::string> p, int num_threads, int prefetch)
      : paths(std::move(p)), slots(prefetch), ready(prefetch),
        window(prefetch) {
    for (auto& r : ready) r.store(0);
    for (int t = 0; t < num_threads; ++t) {
      workers.emplace_back([this] { worker_loop(); });
    }
  }

  ~Sequence() {
    // Set under the lock: a worker between its predicate check and its wait
    // would otherwise miss the notify and block the join forever.
    {
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_space.notify_all();
    cv_produced.notify_all();
    for (auto& w : workers) w.join();
  }

  void worker_loop() {
    while (!stop.load()) {
      size_t idx = next_to_decode.fetch_add(1);
      if (idx >= paths.size()) return;
      size_t slot = idx % window;
      // Wait until the slot is free AND idx is within the consume window.
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() ||
                 (ready[slot].load() == 0 && idx < next_to_consume + window);
        });
        if (stop.load()) return;
      }
      Image img = load_png_file(paths[idx]);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[slot] = std::move(img);
        ready[slot].store(1);
      }
      cv_produced.notify_all();
    }
  }

  bool next(float* out, int* w, int* h, int max_pixels) {
    size_t idx;
    {
      std::lock_guard<std::mutex> lk(mu);
      idx = next_to_consume;
    }
    if (idx >= paths.size()) return false;
    size_t slot = idx % window;
    std::unique_lock<std::mutex> lk(mu);
    cv_produced.wait(lk, [&] { return stop.load() || ready[slot].load() == 1; });
    if (stop.load()) return false;
    Image& img = slots[slot];
    if (!img.ok || int(img.pixels.size()) > max_pixels) return false;
    *w = img.width;
    *h = img.height;
    std::memcpy(out, img.pixels.data(), img.pixels.size() * sizeof(float));
    img = Image();
    ready[slot].store(0);
    next_to_consume = idx + 1;
    lk.unlock();
    cv_space.notify_all();
    return true;
  }
};

}  // namespace

extern "C" {

// One-shot decode. Returns 0 on success; fills out (row-major f32 gray).
int mvo_decode_png(const char* path, float* out, int max_pixels, int* width,
                   int* height) {
  Image img = load_png_file(path);
  if (!img.ok || int(img.pixels.size()) > max_pixels) return 1;
  *width = img.width;
  *height = img.height;
  std::memcpy(out, img.pixels.data(), img.pixels.size() * sizeof(float));
  return 0;
}

// Prefetching sequence API.
void* mvo_open_sequence(const char** paths, int num_paths, int num_threads,
                        int prefetch) {
  std::vector<std::string> p(paths, paths + num_paths);
  return new Sequence(std::move(p), num_threads, prefetch);
}

int mvo_next_frame(void* seq, float* out, int max_pixels, int* width,
                   int* height) {
  auto* s = static_cast<Sequence*>(seq);
  return s->next(out, width, height, max_pixels) ? 0 : 1;
}

void mvo_close_sequence(void* seq) { delete static_cast<Sequence*>(seq); }

}  // extern "C"
