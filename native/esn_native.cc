// esn_native — native data-loading runtime for the esn_tpu framework.
//
// Reference counterpart: the PyTorch zoo leans on torch DataLoader worker
// processes running cv2 decode per item [R: dataset/cityscapes.py,
// dataset/camvid.py — __getitem__ cv2.imread + resize]. That design pays
// process-fork, pickle and GIL costs per batch. Here the equivalent is a
// single C++ library the Python side drives through ctypes:
//
//   - PNG (libpng simplified API) and JPEG (libjpeg-turbo) decode straight
//     into caller-owned numpy buffers — BGR channel order to match the
//     reference's cv2 convention bit-for-bit.
//   - bilinear (image) / nearest (label) resize, matching cv2 semantics
//     (half-pixel centers for bilinear, floor mapping for nearest).
//   - a bounded-ring prefetch pipeline: N decode threads, in-order delivery,
//     epoch order injected from Python (so shuffling stays reproducible from
//     the JAX PRNG side).
//
// Built by native/Makefile into libesn_native.so; loaded by
// esn_tpu/data/native.py, which falls back to cv2/PIL when the toolchain is
// unavailable.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

bool sniff(const char* path, bool* is_png, bool* is_jpeg) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[4] = {0};
  size_t n = std::fread(magic, 1, 4, f);
  std::fclose(f);
  if (n < 4) return false;
  *is_png = magic[0] == 0x89 && magic[1] == 'P';
  *is_jpeg = magic[0] == 0xFF && magic[1] == 0xD8;
  return *is_png || *is_jpeg;
}

bool png_dims(const char* path, int* h, int* w) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path)) return false;
  *h = static_cast<int>(img.height);
  *w = static_cast<int>(img.width);
  png_image_free(&img);
  return true;
}

// decode whole PNG; channels==3 -> BGR, channels==1 -> grayscale
bool png_decode(const char* path, std::vector<uint8_t>& out, int* h, int* w,
                int channels) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&img, path)) return false;
  img.format = channels == 3 ? PNG_FORMAT_BGR : PNG_FORMAT_GRAY;
  *h = static_cast<int>(img.height);
  *w = static_cast<int>(img.width);
  out.resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, out.data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool jpeg_info(const char* path, int* h, int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

bool jpeg_decode(const char* path, std::vector<uint8_t>& out, int* h, int* w,
                 int channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = channels == 3 ? JCS_EXT_BGR : JCS_GRAYSCALE;
  const bool swap_rb = false;
#else
  cinfo.out_color_space = channels == 3 ? JCS_RGB : JCS_GRAYSCALE;
  const bool swap_rb = channels == 3;
#endif
  jpeg_start_decompress(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  const int stride = *w * channels;
  out.resize(static_cast<size_t>(*h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  if (swap_rb) {
    for (size_t i = 0; i + 2 < out.size(); i += 3) std::swap(out[i], out[i + 2]);
  }
  return true;
}

bool decode_any(const char* path, std::vector<uint8_t>& out, int* h, int* w,
                int channels) {
  bool is_png = false, is_jpeg = false;
  if (!sniff(path, &is_png, &is_jpeg)) return false;
  return is_png ? png_decode(path, out, h, w, channels)
                : jpeg_decode(path, out, h, w, channels);
}

// ---------------------------------------------------------------------------
// Resize (cv2-compatible)
// ---------------------------------------------------------------------------

// bilinear, half-pixel centers (cv2 INTER_LINEAR)
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw, int channels) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0.f; }
    if (y1 >= sh) { y1 = sh - 1; if (y0 >= sh) y0 = sh - 1; }
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0.f; }
      if (x1 >= sw) { x1 = sw - 1; if (x0 >= sw) x0 = sw - 1; }
      for (int c = 0; c < channels; ++c) {
        const float v00 = src[(static_cast<size_t>(y0) * sw + x0) * channels + c];
        const float v01 = src[(static_cast<size_t>(y0) * sw + x1) * channels + c];
        const float v10 = src[(static_cast<size_t>(y1) * sw + x0) * channels + c];
        const float v11 = src[(static_cast<size_t>(y1) * sw + x1) * channels + c];
        const float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                        v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(static_cast<size_t>(y) * dw + x) * channels + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// nearest neighbour (cv2 INTER_NEAREST: floor(dst*scale))
void resize_nearest(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    int ys = static_cast<int>(y * sy);
    if (ys >= sh) ys = sh - 1;
    for (int x = 0; x < dw; ++x) {
      int xs = static_cast<int>(x * sx);
      if (xs >= sw) xs = sw - 1;
      dst[static_cast<size_t>(y) * dw + x] =
          src[static_cast<size_t>(ys) * sw + xs];
    }
  }
}

// decode + optional resize into a caller buffer of (th, tw) or native size
int decode_into(const char* path, uint8_t* out, int channels, int th, int tw) {
  std::vector<uint8_t> buf;
  int h = 0, w = 0;
  if (!decode_any(path, buf, &h, &w, channels)) return -1;
  if (th <= 0 || (th == h && tw == w)) {
    std::memcpy(out, buf.data(), buf.size());
    return static_cast<int>(buf.size());
  }
  if (channels == 3) {
    resize_bilinear(buf.data(), h, w, out, th, tw, 3);
  } else {
    resize_nearest(buf.data(), h, w, out, th, tw);
  }
  return th * tw * channels;
}

// ---------------------------------------------------------------------------
// Prefetch pipeline: bounded ring, worker pool, in-order delivery
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<uint8_t> img;
  std::vector<uint8_t> lab;
  int ticket = -1;     // which position in the epoch order this slot holds
  int record = -1;     // dataset record index
  bool ok = false;
  bool ready = false;
};

struct Pipe {
  std::vector<std::string> imgs, labs;  // labs[i] empty => no label
  int th = 0, tw = 0;                   // target size (0 = native, must match)
  int capacity = 0;
  std::vector<Slot> slots;
  std::vector<int> order;
  std::atomic<int> next_ticket{0};      // producer-side cursor
  int consumed = 0;                     // consumer-side cursor
  int epoch_len = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      int ticket = next_ticket.fetch_add(1);
      if (ticket >= epoch_len) return;
      const int rec = order[ticket];
      Slot& s = slots[ticket % capacity];
      {
        std::unique_lock<std::mutex> lk(mu);
        // wait until the consumer has drained the slot's previous lap
        cv_free.wait(lk, [&] {
          return stop.load() || ticket - consumed < capacity;
        });
        if (stop.load()) return;
      }
      int hh = 0, ww = 0;
      std::vector<uint8_t> raw;
      bool ok = decode_any(imgs[rec].c_str(), raw, &hh, &ww, 3);
      if (ok) {
        if (th > 0 && (hh != th || ww != tw)) {
          s.img.resize(static_cast<size_t>(th) * tw * 3);
          resize_bilinear(raw.data(), hh, ww, s.img.data(), th, tw, 3);
        } else {
          s.img = std::move(raw);
        }
        if (!labs[rec].empty()) {
          std::vector<uint8_t> lraw;
          int lh = 0, lw = 0;
          ok = decode_any(labs[rec].c_str(), lraw, &lh, &lw, 1);
          if (ok) {
            if (th > 0 && (lh != th || lw != tw)) {
              s.lab.resize(static_cast<size_t>(th) * tw);
              resize_nearest(lraw.data(), lh, lw, s.lab.data(), th, tw);
            } else {
              s.lab = std::move(lraw);
            }
          }
        } else {
          s.lab.clear();
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        s.ticket = ticket;
        s.record = rec;
        s.ok = ok;
        s.ready = true;
      }
      cv_ready.notify_all();
    }
  }

  void start(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker(); });
  }

  void join() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    stop.store(false);
  }
};

}  // namespace

extern "C" {

int esn_image_info(const char* path, int* h, int* w) {
  bool is_png = false, is_jpeg = false;
  if (!sniff(path, &is_png, &is_jpeg)) return -1;
  return (is_png ? png_dims(path, h, w) : jpeg_info(path, h, w)) ? 0 : -1;
}

// decode into caller buffer; th/tw <= 0 means native size (buffer must be
// h*w*3 resp. h*w from esn_image_info). Returns bytes written or -1.
int esn_decode_bgr(const char* path, uint8_t* out, int th, int tw) {
  return decode_into(path, out, 3, th, tw);
}

int esn_decode_grey(const char* path, uint8_t* out, int th, int tw) {
  return decode_into(path, out, 1, th, tw);
}

void* esn_pipe_create(int n, const char** imgs, const char** labs, int th,
                      int tw, int n_threads, int capacity) {
  if (n <= 0 || th <= 0 || tw <= 0) return nullptr;
  Pipe* p = new Pipe();
  p->imgs.reserve(n);
  p->labs.reserve(n);
  for (int i = 0; i < n; ++i) {
    p->imgs.emplace_back(imgs[i]);
    p->labs.emplace_back(labs && labs[i] ? labs[i] : "");
  }
  p->th = th;
  p->tw = tw;
  p->capacity = capacity > 0 ? capacity : 8;
  p->slots.resize(p->capacity);
  return p;
}

// begin an epoch with the given visiting order (len entries into [0, n))
void esn_pipe_epoch(void* pipe, const int* order, int len, int n_threads) {
  Pipe* p = static_cast<Pipe*>(pipe);
  p->join();
  p->order.assign(order, order + len);
  p->epoch_len = len;
  p->next_ticket.store(0);
  p->consumed = 0;
  for (auto& s : p->slots) s = Slot{};
  p->start(n_threads > 0 ? n_threads : 4);
}

// blocking; fills img (th*tw*3) and lab (th*tw, only if the record has one).
// returns the record index, -2 for decode failure, or -1 at end of epoch.
int esn_pipe_next(void* pipe, uint8_t* img, uint8_t* lab, int* has_label) {
  Pipe* p = static_cast<Pipe*>(pipe);
  if (p->consumed >= p->epoch_len) return -1;
  const int ticket = p->consumed;
  Slot& s = p->slots[ticket % p->capacity];
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return s.ready && s.ticket == ticket; });
  int rec = s.record;
  bool ok = s.ok;
  if (ok) {
    std::memcpy(img, s.img.data(), s.img.size());
    if (has_label) *has_label = s.lab.empty() ? 0 : 1;
    if (!s.lab.empty() && lab) std::memcpy(lab, s.lab.data(), s.lab.size());
  }
  s.ready = false;
  p->consumed = ticket + 1;
  lk.unlock();
  p->cv_free.notify_all();
  return ok ? rec : -2;
}

void esn_pipe_destroy(void* pipe) {
  Pipe* p = static_cast<Pipe*>(pipe);
  p->join();
  delete p;
}

int esn_version() { return 1; }

}  // extern "C"
