// Native frame loader: multi-threaded PNG decode into an in-order ring
// buffer (the port's copy of the repository's native/frame_loader.cc; the
// decode, the ring and the C interface are the same).
//
// The reference's drivers decode every frame synchronously on the tracking
// thread (reference: Examples/Monocular/mono_tum.cc:87-96 cv::imread in the
// main loop). Here decode runs on a background thread pool and the tracker
// pops ready frames in order, so dataset IO overlaps device compute, with a
// C ABI consumed via ctypes (dataio/native_loader.py).
//
// Build (dataio/native_loader.py does, on first use, into build/):
//   g++ -O3 -std=c++17 -shared -fPIC frame_loader.cc -o libframe_loader.so
//       -lpng -lpthread
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

// Decode one PNG into float32 gray [height*width]; 8-bit color collapses
// with ITU-R 601-2 luma (the reference's cvtColor weights); 16-bit gray
// (TUM depth maps) scales by 1/depth_factor. Returns 0 on success.
int decode_png(const char* path, float* out, int height, int width,
               int is_depth, float depth_factor) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if ((int)w != width || (int)h != height) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -4;
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  color = png_get_color_type(png, info);
  depth = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<uint8_t> row(rowbytes);
  const float kR = 0.299f, kG = 0.587f, kB = 0.114f;
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* o = out + (size_t)y * width;
    if (depth == 16) {
      // PNG 16-bit is big-endian
      for (int x = 0; x < width; ++x) {
        uint16_t v = (uint16_t)((row[2 * x] << 8) | row[2 * x + 1]);
        o[x] = is_depth ? (float)v / depth_factor : (float)v * (255.0f / 65535.0f);
      }
    } else if (color == PNG_COLOR_TYPE_GRAY) {
      for (int x = 0; x < width; ++x) o[x] = (float)row[x];
    } else {  // RGB
      for (int x = 0; x < width; ++x) {
        o[x] = kR * row[3 * x] + kG * row[3 * x + 1] + kB * row[3 * x + 2];
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

struct Loader {
  std::vector<std::string> paths;
  int height, width, is_depth;
  float depth_factor;
  int n_slots;
  std::vector<std::vector<float>> slots;   // n_slots frame buffers
  std::vector<int> slot_status;            // -1 free, >=0 frame idx ready
  std::atomic<int> next_claim{0};          // next frame index to decode
  int next_emit = 0;                       // next frame index to hand out
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  bool stop = false;

  void work() {
    for (;;) {
      int idx = next_claim.fetch_add(1);
      if (idx >= (int)paths.size()) return;
      // wait for a free slot whose ring position matches idx
      int slot = idx % n_slots;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || slot_status[slot] == -1; });
        if (stop) return;
        slot_status[slot] = -2;  // claimed
      }
      int rc = decode_png(paths[idx].c_str(), slots[slot].data(), height,
                          width, is_depth, depth_factor);
      if (rc != 0) std::memset(slots[slot].data(), 0, slots[slot].size() * 4);
      {
        std::lock_guard<std::mutex> lk(mu);
        slot_status[slot] = idx;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fl_create(const char** paths, int n, int height, int width,
                int n_threads, int is_depth, float depth_factor) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->height = height;
  L->width = width;
  L->is_depth = is_depth;
  L->depth_factor = depth_factor;
  L->n_slots = std::max(2 * n_threads, 4);
  L->slots.assign(L->n_slots, std::vector<float>((size_t)height * width));
  L->slot_status.assign(L->n_slots, -1);
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L] { L->work(); });
  return L;
}

// Blocking pop of the next frame in order; copies into out [height*width].
// Returns the frame index, or -1 when the sequence is exhausted.
int fl_next(void* handle, float* out) {
  auto* L = (Loader*)handle;
  if (L->next_emit >= (int)L->paths.size()) return -1;
  int idx = L->next_emit++;
  int slot = idx % L->n_slots;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return L->slot_status[slot] == idx; });
    std::memcpy(out, L->slots[slot].data(),
                (size_t)L->height * L->width * sizeof(float));
    L->slot_status[slot] = -1;
  }
  L->cv_free.notify_all();
  return idx;
}

void fl_destroy(void* handle) {
  auto* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->next_claim.store((int)L->paths.size());
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

int fl_decode_gray(const char* path, float* out, int height, int width,
                   int is_depth, float depth_factor) {
  return decode_png(path, out, height, width, is_depth, depth_factor);
}

}  // extern "C"
