// Image preprocessing: PNG decode + bilinear resize + normalize.
//
// Native replacement for the reference's libvips dependency (reference
// utils/image_compressor.ex, boot check application.ex:89-116) on the
// path that matters for the TPU build: decoding and resizing vision
// inputs into the VLM tower's expected tensor layout. Scope: 8-bit
// RGB/RGBA/gray PNG, no interlace (the formats agents produce and the
// dashboard serves); JPEG arrives via the Python fallback if available.
//
// Build: g++ -O2 -shared -fPIC -o libqtimg.so image.cpp -lz

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

uint32_t ReadU32(const uint8_t *p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

int PaethPredictor(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode PNG into RGB8. Returns true on success.
bool DecodePng(const uint8_t *data, size_t len, std::vector<uint8_t> *rgb,
               uint32_t *out_w, uint32_t *out_h) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                  '\n'};
  if (len < 8 || memcmp(data, kSig, 8) != 0) return false;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= len) {
    uint32_t chunk_len = ReadU32(data + pos);
    const uint8_t *tag = data + pos + 4;
    const uint8_t *payload = data + pos + 8;
    if (pos + 12 + chunk_len > len) return false;
    if (memcmp(tag, "IHDR", 4) == 0 && chunk_len >= 13) {
      w = ReadU32(payload);
      h = ReadU32(payload + 4);
      bit_depth = payload[8];
      color_type = payload[9];
      if (payload[12] != 0) return false;  // interlaced unsupported
    } else if (memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + chunk_len);
    } else if (memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + chunk_len;
  }
  // Dimension sanity BEFORE any allocation: a crafted IHDR must fail with
  // rc=-1, not throw bad_alloc across the C boundary (which would abort
  // the interpreter).
  if (w == 0 || h == 0 || bit_depth != 8) return false;
  if (static_cast<uint64_t>(w) * h > 64ull * 1024 * 1024) return false;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return false;        // palette unsupported
  }
  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return false;
  // un-filter
  std::vector<uint8_t> img(stride * h);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t *src = raw.data() + y * (stride + 1) + 1;
    uint8_t *dst = img.data() + y * stride;
    const uint8_t *up = y ? img.data() + (y - 1) * stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= static_cast<size_t>(channels) ? dst[x - channels] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= static_cast<size_t>(channels))
                  ? up[x - channels] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += PaethPredictor(a, b, c); break;
        default: return false;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }
  // to RGB
  rgb->resize(static_cast<size_t>(w) * h * 3);
  for (size_t i = 0; i < static_cast<size_t>(w) * h; ++i) {
    const uint8_t *px = img.data() + i * channels;
    uint8_t r, g, b;
    if (channels <= 2) { r = g = b = px[0]; }
    else { r = px[0]; g = px[1]; b = px[2]; }
    (*rgb)[i * 3] = r;
    (*rgb)[i * 3 + 1] = g;
    (*rgb)[i * 3 + 2] = b;
  }
  *out_w = w;
  *out_h = h;
  return true;
}

void ResizeBilinear(const uint8_t *src, uint32_t sw, uint32_t sh,
                    uint8_t *dst, uint32_t dw, uint32_t dh) {
  for (uint32_t y = 0; y < dh; ++y) {
    float fy = dh > 1 ? static_cast<float>(y) * (sh - 1) / (dh - 1) : 0.0f;
    uint32_t y0 = static_cast<uint32_t>(fy);
    uint32_t y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (uint32_t x = 0; x < dw; ++x) {
      float fx = dw > 1 ? static_cast<float>(x) * (sw - 1) / (dw - 1) : 0.0f;
      uint32_t x0 = static_cast<uint32_t>(fx);
      uint32_t x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * sw + x0) * 3 + c];
        float v01 = src[(y0 * sw + x1) * 3 + c];
        float v10 = src[(y1 * sw + x0) * 3 + c];
        float v11 = src[(y1 * sw + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * dw + x) * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode PNG and resize to (out_w, out_h) RGB8 into out (size out_w*out_h*3).
// Also writes the source dims. Returns 0 ok, -1 decode error.
int32_t qt_img_decode_resize(const uint8_t *data, int64_t len,
                             int32_t out_w, int32_t out_h, uint8_t *out,
                             int32_t *src_w, int32_t *src_h) {
  try {
    std::vector<uint8_t> rgb;
    uint32_t w, h;
    if (!DecodePng(data, static_cast<size_t>(len), &rgb, &w, &h)) return -1;
    *src_w = static_cast<int32_t>(w);
    *src_h = static_cast<int32_t>(h);
    ResizeBilinear(rgb.data(), w, h, out, static_cast<uint32_t>(out_w),
                   static_cast<uint32_t>(out_h));
    return 0;
  } catch (...) {
    // No exception may cross into the ctypes frame.
    return -1;
  }
}

}  // extern "C"
