// Prefetching stereo-image loader: libpng decode on worker threads feeding a
// bounded ring buffer.
//
// The TPU-native pipeline is host-latency sensitive: image decode must
// overlap device compute, which the reference gets implicitly from its
// OpenCV-reading main thread racing its worker threads (reference
// app/run_kitti_stereo.cpp:61-88 + backend/loopclosing threads).  Here the
// loader owns decode threads and the Python host thread only memcpy's ready
// frames.  Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<unsigned char> left;
  std::vector<unsigned char> right;
  int height = 0;
  int width = 0;
  int index = -1;
  bool ok = false;
};

bool decode_png_gray(const std::string& path, std::vector<unsigned char>& out,
                     int* h, int* w) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_COLOR) png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out.resize(static_cast<size_t>(width) * height);
  std::vector<png_bytep> rows(height);
  for (png_uint_32 y = 0; y < height; ++y) rows[y] = out.data() + y * width;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *h = static_cast<int>(height);
  *w = static_cast<int>(width);
  return true;
}

struct Loader {
  std::vector<std::string> left_paths;
  std::vector<std::string> right_paths;
  size_t capacity;
  std::vector<Frame> ring;
  size_t head = 0;  // next slot the consumer reads
  size_t tail = 0;  // next slot a producer fills
  std::atomic<int> next_index{0};
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<std::thread> workers;
  std::atomic<bool> stop_flag{false};

  Loader(std::vector<std::string> l, std::vector<std::string> r, int prefetch,
         int n_threads)
      : left_paths(std::move(l)),
        right_paths(std::move(r)),
        capacity(static_cast<size_t>(prefetch) + 1),
        ring(capacity) {
    for (int t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { this->work(); });
    }
  }

  void work() {
    while (!stop_flag.load()) {
      int idx = next_index.fetch_add(1);
      if (idx >= static_cast<int>(left_paths.size())) return;
      Frame f;
      f.index = idx;
      int hl = 0, wl = 0, hr = 0, wr = 0;
      f.ok = decode_png_gray(left_paths[idx], f.left, &hl, &wl) &&
             decode_png_gray(right_paths[idx], f.right, &hr, &wr) && hl == hr &&
             wl == wr;
      f.height = hl;
      f.width = wl;

      // Insert in order: wait until it's this frame's turn in the ring.
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] {
        return stop_flag.load() ||
               (static_cast<size_t>(idx) < head + capacity &&
                static_cast<size_t>(idx) == tail);
      });
      if (stop_flag.load()) return;
      ring[idx % capacity] = std::move(f);
      tail = idx + 1;
      cv_empty.notify_all();
      cv_full.notify_all();
    }
  }

  // Returns frame index, or -1 at end of sequence, or -2 on decode error.
  int next(unsigned char* left_out, unsigned char* right_out, int* h, int* w) {
    std::unique_lock<std::mutex> lk(mu);
    if (head >= left_paths.size()) return -1;
    cv_empty.wait(lk, [&] { return stop_flag.load() || tail > head; });
    if (stop_flag.load()) return -1;
    Frame& f = ring[head % capacity];
    if (!f.ok) {
      ++head;
      cv_full.notify_all();
      return -2;
    }
    *h = f.height;
    *w = f.width;
    const size_t n = static_cast<size_t>(f.height) * f.width;
    std::memcpy(left_out, f.left.data(), n);
    std::memcpy(right_out, f.right.data(), n);
    int idx = f.index;
    ++head;
    cv_full.notify_all();
    return idx;
  }

  ~Loader() {
    stop_flag.store(true);
    cv_full.notify_all();
    cv_empty.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** left, const char** right, int n, int prefetch,
                    int n_threads) {
  std::vector<std::string> l(left, left + n), r(right, right + n);
  return new Loader(std::move(l), std::move(r), prefetch, n_threads);
}

int loader_next(void* handle, unsigned char* left_out, unsigned char* right_out,
                int* h, int* w) {
  return static_cast<Loader*>(handle)->next(left_out, right_out, h, w);
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int loader_probe_dims(const char* path, int* h, int* w) {
  std::vector<unsigned char> buf;
  return decode_png_gray(path, buf, h, w) ? 0 : -1;
}

}  // extern "C"
