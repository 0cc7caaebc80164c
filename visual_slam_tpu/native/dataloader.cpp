// Async RGB-D PNG dataloader: libpng decode on a worker thread pool with a
// bounded prefetch window, exposed through a C ABI for ctypes.
//
// Replacement for the reference's synchronous per-frame cv2.imread calls
// (src/v2/frame.py:52-55): decoding a 640x480 RGB PNG takes milliseconds of
// host time, which at >100 frames/s of accelerator throughput would dominate
// the pipeline. Worker threads decode ahead of the consumer so image IO
// overlaps device compute.
//
// Build: see build.sh (g++ -O3 -shared -fPIC dataloader.cpp -lpng -lz).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> rgb;     // H*W*3
  std::vector<uint16_t> depth;  // H*W (raw 16-bit; consumer applies /5000)
  int width = 0, height = 0;
  bool ready = false;
  bool failed = false;
};

bool decode_png(const std::string& path, std::vector<uint8_t>* rgb8,
                std::vector<uint16_t>* gray16, int* w_out, int* h_out) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  int width = png_get_image_width(png, info);
  int height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  *w_out = width;
  *h_out = height;

  if (rgb8) {
    // Normalize anything to 8-bit RGB.
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);
    rgb8->resize(size_t(width) * height * 3);
    std::vector<png_bytep> rows(height);
    for (int y = 0; y < height; ++y)
      rows[y] = rgb8->data() + size_t(y) * width * 3;
    png_read_image(png, rows.data());
  } else {
    // 16-bit grayscale depth map, little-endian out.
    if (depth != 16 || color != PNG_COLOR_TYPE_GRAY) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(fp);
      return false;
    }
    png_set_swap(png);  // PNG is big-endian; we want host little-endian
    png_read_update_info(png, info);
    gray16->resize(size_t(width) * height);
    std::vector<png_bytep> rows(height);
    for (int y = 0; y < height; ++y)
      rows[y] = reinterpret_cast<png_bytep>(gray16->data() + size_t(y) * width);
    png_read_image(png, rows.data());
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

struct Loader {
  std::vector<std::string> rgb_paths;
  std::vector<std::string> depth_paths;  // may be empty strings (no depth)
  std::vector<Frame> frames;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_work;
  std::atomic<bool> stop{false};
  size_t next_to_schedule = 0;  // guarded by mu
  size_t consumer_pos = 0;      // guarded by mu
  size_t lookahead = 16;
  int expected_h = 0, expected_w = 0;  // 0 = accept any (caller's risk)

  void worker_loop() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return stop.load() ||
                 (next_to_schedule < frames.size() &&
                  next_to_schedule < consumer_pos + lookahead);
        });
        if (stop.load()) return;
        idx = next_to_schedule++;
      }
      Frame f;
      bool ok = decode_png(rgb_paths[idx], &f.rgb, nullptr, &f.width, &f.height);
      if (ok && expected_w > 0 &&
          (f.width != expected_w || f.height != expected_h))
        ok = false;  // dimension mismatch: would overflow caller buffers
      if (ok && !depth_paths[idx].empty()) {
        int dw = 0, dh = 0;
        ok = decode_png(depth_paths[idx], nullptr, &f.depth, &dw, &dh);
        if (ok && expected_w > 0 && (dw != expected_w || dh != expected_h))
          ok = false;
      }
      f.failed = !ok;
      f.ready = true;
      {
        std::lock_guard<std::mutex> lk(mu);
        frames[idx] = std::move(f);
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// expected_h/expected_w size the caller's buffers; frames decoded to any
// other dimensions are reported as failures instead of overflowing them.
void* dl_open(const char** rgb_paths, const char** depth_paths, int n_frames,
              int n_threads, int lookahead, int expected_h, int expected_w) {
  auto* L = new Loader();
  L->rgb_paths.reserve(n_frames);
  L->depth_paths.reserve(n_frames);
  for (int i = 0; i < n_frames; ++i) {
    L->rgb_paths.emplace_back(rgb_paths[i]);
    L->depth_paths.emplace_back(depth_paths ? depth_paths[i] : "");
  }
  L->frames.resize(n_frames);
  L->lookahead = lookahead > 0 ? lookahead : 16;
  L->expected_h = expected_h;
  L->expected_w = expected_w;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return L;
}

// Blocks until frame idx is decoded; copies into caller buffers.
// rgb_out: H*W*3 uint8; depth_out: H*W uint16 (may be null).
// Returns 0 on success, -1 on decode failure.
int dl_get(void* handle, int idx, uint8_t* rgb_out, uint16_t* depth_out) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (size_t(idx) >= L->consumer_pos) L->consumer_pos = idx;
  }
  L->cv_work.notify_all();
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return L->frames[idx].ready; });
  Frame& f = L->frames[idx];
  if (f.failed) return -1;
  std::memcpy(rgb_out, f.rgb.data(), f.rgb.size());
  if (depth_out && !f.depth.empty())
    std::memcpy(depth_out, f.depth.data(), f.depth.size() * 2);
  // Free decoded memory once consumed (window moves forward).
  f.rgb.clear();
  f.rgb.shrink_to_fit();
  f.depth.clear();
  f.depth.shrink_to_fit();
  return 0;
}

// As dl_get but converts RGB to 8-bit grayscale in native code: the
// device transfer then moves 1/3 of the bytes.
int dl_get_gray(void* handle, int idx, uint8_t* gray_out, uint16_t* depth_out) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (size_t(idx) >= L->consumer_pos) L->consumer_pos = idx;
  }
  L->cv_work.notify_all();
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return L->frames[idx].ready; });
  Frame& f = L->frames[idx];
  if (f.failed) return -1;
  const size_t n = f.rgb.size() / 3;
  const uint8_t* p = f.rgb.data();
  for (size_t i = 0; i < n; ++i) {
    gray_out[i] = uint8_t((299u * p[3 * i] + 587u * p[3 * i + 1] +
                           114u * p[3 * i + 2]) / 1000u);
  }
  if (depth_out && !f.depth.empty())
    std::memcpy(depth_out, f.depth.data(), f.depth.size() * 2);
  f.rgb.clear();
  f.rgb.shrink_to_fit();
  f.depth.clear();
  f.depth.shrink_to_fit();
  return 0;
}

void dl_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_work.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
