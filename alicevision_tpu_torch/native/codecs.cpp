// Byte-stream loops of the port's TIFF and PNG readers that numpy cannot
// vectorise: TIFF LZW (MSB-first codes of 9 to 12 bits, Clear and EOI,
// the early width change), PackBits, and PNG's five row filters. Every
// other step (IFDs, chunks, zlib, predictors, sample unpacking) lives in
// Python (image/tiff.py, image/png.py), which also holds the plain
// version of each routine here.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// TIFF LZW. Decodes `src` into `dst` until EOI, the end of `src`, or
// `cap` bytes written (as libtiff, which stops at the strip's size).
// Returns the bytes written, -1 for old-style (LSB-first) LZW, -2 for a
// code past the table.
int64_t tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -1;
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int width = 9, next = 258, prev = -1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t pos = 0, out = 0;
  while (out < cap) {
    while (bits < width && pos < n) {
      acc = (acc << 8) | src[pos++];
      bits += 8;
    }
    if (bits < width) break;  // no EOI: the data ends
    const int code = static_cast<int>((acc >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == 256) {  // Clear
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (code == 257) break;  // EOI
    int emit;
    if (prev < 0) {
      if (code > 255) return -2;
      emit = code;
    } else {
      if (code > next || (next > 4095 && code == next)) return -2;
      if (next < 4096) {  // the new entry: prev's string + the first byte of code's
        prefix[next] = static_cast<uint16_t>(prev);
        first[next] = first[prev];
        suffix[next] = code < next ? first[code] : first[prev];
        length[next] = static_cast<uint16_t>(length[prev] + 1);
        ++next;
      }
      emit = code;
    }
    // write the string of `emit` backwards from its last byte, clipped at cap
    const int len = length[emit];
    int64_t end = out + len;
    int c = emit;
    for (int64_t k = end - 1; k >= out; --k) {
      if (k < cap) dst[k] = suffix[c];
      c = prefix[c];
    }
    out = end < cap ? end : cap;
    prev = emit;
    if (next + 1 >= (1 << width) && width < 12) ++width;  // the early change: 511, 1023, 2047
  }
  return out;
}

// PackBits. Returns the bytes written (at most cap).
int64_t tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t pos = 0, out = 0;
  while (pos < n && out < cap) {
    const int h = static_cast<int8_t>(src[pos++]);
    if (h >= 0) {
      int64_t k = h + 1;
      if (k > n - pos) k = n - pos;
      if (k > cap - out) k = cap - out;
      std::memcpy(dst + out, src + pos, static_cast<size_t>(k));
      pos += h + 1;
      out += k;
    } else if (h != -128) {
      if (pos >= n) break;
      int64_t k = 1 - h;
      if (k > cap - out) k = cap - out;
      std::memset(dst + out, src[pos++], static_cast<size_t>(k));
      out += k;
    }
  }
  return out;
}

// PNG row filters. `src` holds h rows of (1 + stride) bytes, each a filter
// type and `stride` filtered bytes; `dst` gets h rows of stride bytes.
// bpp is the filter's pixel step in bytes (1 to 8). Returns 0, or -(y + 1)
// for a row y with an unknown filter type.
int png_unfilter(const uint8_t* src, int64_t h, int64_t stride, int bpp, uint8_t* dst) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = src + y * (stride + 1);
    const int kind = in[0];
    ++in;
    uint8_t* cur = dst + y * stride;
    const uint8_t* up = y > 0 ? dst + (y - 1) * stride : nullptr;
    switch (kind) {
      case 0:
        std::memcpy(cur, in, static_cast<size_t>(stride));
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x) cur[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) cur[x] = static_cast<uint8_t>(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          cur[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
          const int c = (x >= bpp && up) ? up[x - bpp] : 0;
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = static_cast<uint8_t>(in[x] + pred);
        }
        break;
      default:
        return static_cast<int>(-(y + 1));
    }
  }
  return 0;
}

}  // extern "C"
