// tileio: batch tile decoding for the host data path of the PyTorch port.
//
// A training step consumes a batch of fixed-size tiles (1024x1024 RGB PNGs,
// 1-channel PNG masks). This library decodes a whole batch straight into
// the caller's contiguous buffer (on the card, a pinned staging buffer)
// with a C++ thread pool; ctypes releases the interpreter lock for the
// call, so decoding overlaps the Python thread that drives the device.
//
// PNG is decoded here on top of zlib's inflate: chunk parsing with CRC
// checks, and the five row filters (none, sub, up, average, Paeth) undone
// in place. It takes non-interlaced images: 8-bit of colour type 0 (grey),
// 2 (RGB), 3 (palette: the indices are returned), 4 (grey + alpha) and 6
// (RGBA), and 16-bit grey, whose big-endian samples are returned as
// uint16 in host order. It returns the samples as stored, as PIL's
// np.asarray(Image) does. Anything else is an error, never a silent
// conversion. Two limits are errors of their own: a side above 2^20
// pixels (kTooWide), and more than 4 GiB of filtered image bytes, which
// zlib's 32-bit avail_out cannot take in one inflate (kTooManyBytes). It
// needs no libpng, which the machines with the card may lack.
//
// JPEG goes through libjpeg when the build found its header
// (TILEIO_JPEG); otherwise a JPEG file is an error (kNoJpeg).
//
// Plain C ABI for ctypes. Build: see __init__.py (g++ -O3 -shared -fPIC
// tileio.cpp -lz [-DTILEIO_JPEG -ljpeg] -lpthread).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#ifdef TILEIO_JPEG
#include <csetjmp>
extern "C" {
#include <jpeglib.h>
}
#endif

namespace {

// Error codes (negative), or 0 on success. Keep in step with __init__.py.
constexpr int kOk = 0;
constexpr int kOpenFailed = -1;
constexpr int kDecodeFailed = -2;
constexpr int kShapeMismatch = -3;
constexpr int kBadArgs = -4;
constexpr int kUnsupported = -5;
constexpr int kNoJpeg = -6;
constexpr int kTooWide = -7;
constexpr int kTooManyBytes = -8;

constexpr uint32_t kMaxSide = 1u << 20;

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

bool has_suffix(const char* path, const char* suffix) {
  size_t lp = std::strlen(path), ls = std::strlen(suffix);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; ++i) {
    char a = path[lp - ls + i], b = suffix[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

bool is_jpeg(const char* path) {
  return has_suffix(path, ".jpg") || has_suffix(path, ".jpeg");
}

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(f) : -1;
  ok = ok && size >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    data->resize(size_t(size));
    ok = std::fread(data->data(), 1, data->size(), f) == data->size();
  }
  std::fclose(f);
  return ok;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

struct PngHeader {
  int width, height, channels, sample_bytes;
};

// Channels of an 8-bit colour type, or 0 if the type is not one we take.
int png_channels(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// Parse the signature and IHDR of `data`; `*ihdr_end` is the offset of the
// first chunk after IHDR.
int png_header(const uint8_t* data, size_t size, PngHeader* h, size_t* ihdr_end) {
  if (size < 8 + 25 || std::memcmp(data, kPngSignature, 8) != 0) return kDecodeFailed;
  const uint8_t* c = data + 8;
  if (be32(c) != 13 || std::memcmp(c + 4, "IHDR", 4) != 0) return kDecodeFailed;
  if (uint32_t(crc32(crc32(0, nullptr, 0), c + 4, 17)) != be32(c + 21)) return kDecodeFailed;
  const uint8_t* d = c + 8;
  uint32_t w = be32(d), hh = be32(d + 4);
  int depth = d[8], color = d[9], compression = d[10], filter = d[11], interlace = d[12];
  if (w == 0 || hh == 0 || compression != 0 || filter != 0) return kDecodeFailed;
  int ch = png_channels(color);
  bool grey16 = depth == 16 && color == 0;
  if ((depth != 8 && !grey16) || ch == 0 || interlace != 0) return kUnsupported;
  if (w > kMaxSide || hh > kMaxSide) return kTooWide;
  int sample_bytes = depth / 8;
  // the filtered image (a filter byte a row) passes through zlib's 32-bit
  // avail_out in one piece
  if (uint64_t(hh) * (uint64_t(w) * ch * sample_bytes + 1) > 0xFFFFFFFFull) return kTooManyBytes;
  h->width = int(w);
  h->height = int(hh);
  h->channels = ch;
  h->sample_bytes = sample_bytes;
  *ihdr_end = 8 + 25;
  return kOk;
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

// Undo one row's filter: `cur` (filtered, `n` bytes) -> `out`, given the
// reconstructed previous row `prev` (nullptr for the first row).
bool unfilter_row(int type, const uint8_t* cur, const uint8_t* prev, uint8_t* out, size_t n,
                  int bpp) {
  switch (type) {
    case 0:
      std::memcpy(out, cur, n);
      return true;
    case 1:
      for (size_t i = 0; i < n; ++i)
        out[i] = uint8_t(cur[i] + (i >= size_t(bpp) ? out[i - bpp] : 0));
      return true;
    case 2:
      for (size_t i = 0; i < n; ++i) out[i] = uint8_t(cur[i] + (prev ? prev[i] : 0));
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        int left = i >= size_t(bpp) ? out[i - bpp] : 0;
        int up = prev ? prev[i] : 0;
        out[i] = uint8_t(cur[i] + ((left + up) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        int left = i >= size_t(bpp) ? out[i - bpp] : 0;
        int up = prev ? prev[i] : 0;
        int up_left = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
        out[i] = uint8_t(cur[i] + paeth(left, up, up_left));
      }
      return true;
    default:
      return false;
  }
}

// Decode one PNG file into `out` (height x width x channels samples of
// `sample_bytes` bytes, as stored; 16-bit samples in host order). `file`
// and `filtered` are the calling thread's scratch buffers.
int decode_png_one(const char* path, uint8_t* out, int height, int width, int channels,
                   int sample_bytes, std::vector<uint8_t>& file,
                   std::vector<uint8_t>& filtered) {
  if (!read_file(path, &file)) return kOpenFailed;
  PngHeader h;
  size_t pos;
  int rc = png_header(file.data(), file.size(), &h, &pos);
  if (rc != kOk) return rc;
  if (h.width != width || h.height != height || h.channels != channels ||
      h.sample_bytes != sample_bytes)
    return kShapeMismatch;

  const int bpp = channels * sample_bytes;
  const size_t row = size_t(width) * bpp;
  filtered.resize(size_t(height) * (row + 1));
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kDecodeFailed;
  zs.next_out = filtered.data();
  zs.avail_out = uInt(filtered.size());
  bool ended = false, seen_idat = false, seen_iend = false;
  rc = kOk;
  while (rc == kOk && !seen_iend) {
    if (pos + 12 > file.size()) {
      rc = kDecodeFailed;  // truncated: no IEND
      break;
    }
    const uint8_t* c = file.data() + pos;
    uint32_t len = be32(c);
    if (len > file.size() - pos - 12) {
      rc = kDecodeFailed;
      break;
    }
    if (uint32_t(crc32(crc32(0, nullptr, 0), c + 4, len + 4)) != be32(c + 8 + len)) {
      rc = kDecodeFailed;
      break;
    }
    if (std::memcmp(c + 4, "IDAT", 4) == 0) {
      seen_idat = true;
      if (!ended) {
        zs.next_in = const_cast<uint8_t*>(c + 8);
        zs.avail_in = len;
        // The stream's end (last block's end code, adler32) may lie in a
        // later IDAT than the last pixel byte: Z_OK with a full output is
        // progress. More data than the image holds gives Z_BUF_ERROR.
        while (zs.avail_in > 0 && !ended) {
          int z = inflate(&zs, Z_NO_FLUSH);
          if (z == Z_STREAM_END) {
            ended = true;
          } else if (z != Z_OK) {
            rc = kDecodeFailed;  // corrupt stream, or more data than the image holds
            break;
          }
        }
      }
    } else if (std::memcmp(c + 4, "IEND", 4) == 0) {
      seen_iend = true;
    } else if (!(c[4] & 0x20)) {
      // An unknown critical chunk (uppercase first letter); PLTE is the
      // only one we skip (palette images return their indices).
      if (std::memcmp(c + 4, "PLTE", 4) != 0) rc = kUnsupported;
    }
    pos += 12 + size_t(len);
  }
  inflateEnd(&zs);
  if (rc != kOk) return rc;
  if (!seen_idat || !ended || zs.avail_out != 0) return kDecodeFailed;

  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = filtered.data() + size_t(y) * (row + 1);
    uint8_t* dst = out + size_t(y) * row;
    if (!unfilter_row(src[0], src + 1, prev, dst, row, bpp)) return kDecodeFailed;
    prev = dst;
  }
  if (sample_bytes == 2) {
    // PNG stores 16-bit samples big-endian; the filters work on those
    // bytes, so swap only once every row is reconstructed.
    uint16_t* v = reinterpret_cast<uint16_t*>(out);
    const size_t n = size_t(height) * width * channels;
    for (size_t i = 0; i < n; ++i) {
      uint8_t* b = reinterpret_cast<uint8_t*>(v + i);
      v[i] = uint16_t((uint16_t(b[0]) << 8) | b[1]);
    }
  }
  return kOk;
}

int probe_png(const char* path, int* height, int* width, int* channels, int* sample_bytes) {
  uint8_t head[8 + 25];
  FILE* f = std::fopen(path, "rb");
  if (!f) return kOpenFailed;
  size_t got = std::fread(head, 1, sizeof(head), f);
  std::fclose(f);
  PngHeader h;
  size_t pos;
  int rc = png_header(head, got, &h, &pos);
  if (rc != kOk) return rc;
  *height = h.height;
  *width = h.width;
  *channels = h.channels;
  *sample_bytes = h.sample_bytes;
  return kOk;
}

#ifdef TILEIO_JPEG
// libjpeg's default fatal-error handler calls exit(): a corrupt JPEG would
// end the process from a decoder thread. Fatal errors longjmp back instead.
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf env;
};

void jpeg_error_longjmp(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErrorMgr*>(cinfo->err)->env, 1);
}

// Decode (out != nullptr) or probe one JPEG.
int jpeg_one(const char* path, uint8_t* out, int* height, int* width, int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kOpenFailed;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_longjmp;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kDecodeFailed;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  int rc = kOk;
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    rc = kDecodeFailed;
  } else if (out == nullptr) {
    *height = int(cinfo.image_height);
    *width = int(cinfo.image_width);
    *channels = int(cinfo.num_components);
  } else {
    cinfo.out_color_space = (*channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (int(cinfo.output_width) != *width || int(cinfo.output_height) != *height ||
        int(cinfo.output_components) != *channels) {
      jpeg_abort_decompress(&cinfo);
      rc = kShapeMismatch;
    } else {
      while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + size_t(cinfo.output_scanline) * (*width) * (*channels);
        jpeg_read_scanlines(&cinfo, &row, 1);
      }
      jpeg_finish_decompress(&cinfo);
    }
  }
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return rc;
}
#endif

int decode_one(const char* path, uint8_t* out, int height, int width, int channels,
               int sample_bytes, std::vector<uint8_t>& file, std::vector<uint8_t>& filtered) {
  if (is_jpeg(path)) {
#ifdef TILEIO_JPEG
    if (sample_bytes != 1) return kShapeMismatch;
    return jpeg_one(path, out, &height, &width, &channels);
#else
    return kNoJpeg;
#endif
  }
  return decode_png_one(path, out, height, width, channels, sample_bytes, file, filtered);
}

}  // namespace

extern "C" {

// Decode n images (all height x width x channels samples of sample_bytes
// bytes: 1, or 2 for 16-bit grey) into `out` (n * height * width *
// channels contiguous samples) with n_threads threads (0: one per core).
// Returns 0 on success or the first error code met; `status` (length n)
// receives each file's code.
int tileio_decode_batch(const char** paths, int n, uint8_t* out, int height, int width,
                        int channels, int sample_bytes, int n_threads, int* status) {
  if (n <= 0 || height <= 0 || width <= 0 || channels < 1 || channels > 4 ||
      (sample_bytes != 1 && sample_bytes != 2) || !paths || !out || !status)
    return kBadArgs;
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  const size_t stride = size_t(height) * width * channels * sample_bytes;
  std::atomic<int> next(0);
  std::atomic<int> first_error(kOk);

  auto worker = [&]() {
    std::vector<uint8_t> file, filtered;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = decode_one(paths[i], out + stride * i, height, width, channels, sample_bytes, file,
                          filtered);
      status[i] = rc;
      if (rc != kOk) {
        int expected = kOk;
        first_error.compare_exchange_strong(expected, rc);
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return first_error.load();
}

// An image's dimensions: 0, with height/width/channels (as stored) and the
// bytes of a sample (1, or 2 for 16-bit grey), or a negative error code.
int tileio_probe(const char* path, int* height, int* width, int* channels, int* sample_bytes) {
  if (is_jpeg(path)) {
#ifdef TILEIO_JPEG
    *sample_bytes = 1;
    return jpeg_one(path, nullptr, height, width, channels);
#else
    return kNoJpeg;
#endif
  }
  return probe_png(path, height, width, channels, sample_bytes);
}

// 1 if this build decodes JPEG (libjpeg was found), else 0.
int tileio_has_jpeg() {
#ifdef TILEIO_JPEG
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
