// JPEG codec of the port: the entropy decoder for baseline, extended-
// sequential (8-bit) and progressive Huffman JPEGs, the pixel stage of
// libjpeg-turbo's defaults (islow integer IDCT, fancy upsampling, the
// fixed-point YCbCr -> RGB tables), and a baseline encoder (libjpeg's
// islow forward DCT, h2v2 downsampling, the standard Huffman tables).
//
// The marker parser lives in Python (image/jpeg.py): it hands this file
// the scans (components, tables, spectral band, successive approximation,
// restart interval and the byte range of the entropy-coded data) and the
// Huffman tables as (bits[16], vals[256]) rows. Coefficients are kept
// dequantization-free in natural order, one int16 block of 64 a block.
// image/jpeg.py holds the plain numpy version of every step.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum Err {
  kOk = 0,
  kTruncated = -1,   // a scan needs bits past its data
  kBadCode = -2,     // a Huffman code no table holds
  kBadRestart = -3,  // a missing or out-of-order RSTn marker
  kBadRun = -4,      // a run past coefficient 63
  kBadTable = -5,    // a table reference or a table that does not fit its code space
  kOverflow = -6,    // the encoder's output buffer is full
};

struct Huff {
  uint16_t fast[1 << 9];  // (length << 8) | symbol for codes of up to 9 bits, 0 otherwise
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

bool build_huff(const uint8_t* row, Huff* h) {
  const uint8_t* bits = row;
  const uint8_t* vals = row + 16;
  std::memcpy(h->vals, vals, 256);
  std::memset(h->fast, 0, sizeof(h->fast));
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    h->valoffset[l] = p - code;
    for (int i = 0; i < n; ++i, ++p, ++code) {
      if (code >= (1 << l) || p >= 256) return false;  // over-subscribed: no prefix code
      if (l <= 9) {
        int lo = code << (9 - l), hi = (code + 1) << (9 - l);
        for (int k = lo; k < hi; ++k) h->fast[k] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    h->maxcode[l] = n ? code - 1 : -1;
    code <<= 1;
  }
  h->maxcode[17] = INT_MAX;
  return true;
}

// MSB-first bit reader over one scan's entropy-coded bytes. Past a marker
// (or the end of the data) it feeds zero bits and counts them as fake; a
// decode that consumes a fake bit marks the scan truncated.
struct Bits {
  const uint8_t* d;
  int64_t pos, end;
  uint64_t buf = 0;
  int n = 0, fake = 0;
  bool marker = false, truncated = false;

  void fill() {
    while (n <= 56) {
      uint32_t c = 0;
      if (!marker && pos < end) {
        c = d[pos];
        if (c == 0xFF) {
          int64_t q = pos + 1;
          while (q < end && d[q] == 0xFF) ++q;  // fill bytes
          if (q < end && d[q] == 0) {
            pos = q + 1;  // a stuffed 0xFF data byte
          } else {
            marker = true;  // stay on the marker
            c = 0;
            fake += 8;
          }
        } else {
          ++pos;
        }
      } else {
        fake += 8;
      }
      buf |= static_cast<uint64_t>(c) << (56 - n);
      n += 8;
    }
  }
  inline void ensure() {
    if (n < 32) fill();
  }
  inline uint32_t peek(int k) const { return static_cast<uint32_t>(buf >> (64 - k)); }
  inline void skip(int k) {
    buf <<= k;
    n -= k;
    if (n < fake) truncated = true;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  inline int decode(const Huff& h, int* err) {
    uint32_t look = peek(9);
    uint16_t e = h.fast[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = static_cast<int32_t>(peek(l));
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) {
        *err = kBadCode;
        return 0;
      }
      code = static_cast<int32_t>(peek(l));
    }
    skip(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // restart: drop the buffered bits and step over the next RSTn marker
  bool restart(int expected) {
    buf = 0;
    n = fake = 0;
    marker = false;
    while (pos + 1 < end && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)) ++pos;
    if (pos + 1 >= end || d[pos + 1] != 0xD0 + (expected & 7)) return false;
    pos += 2;
    return true;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Comp {
  int64_t h, v, bw, bh, wib, hib, offset;  // offset: first block in the coefficient buffer
};

struct Scan {
  int ns, comp[4], td[4], ta[4], ss, se, ah, al, ri;
  int64_t off, len;
};

}  // namespace

extern "C" {

// Decode every scan's entropy-coded data into `coef` (int16, 64 a block,
// natural order). comps: ncomp rows of (h, v, bw, bh, wib, hib, offset),
// bw x bh the blocks held (the MCU grid), wib x hib the component's own.
// scans: nscans rows of 22 int64 (ns, comp[4], td[4], ta[4], ss, se, ah,
// al, ri, progressive, off, len, pad); td/ta index `tables` (rows of 272
// bytes: bits[16], vals[256]). Returns 0 or a negative Err.
int jpeg_decode_coefficients(const uint8_t* data, int64_t size, int ncomp, const int64_t* comps, int64_t mcux,
                             int64_t mcuy, int nscans, const int64_t* scans, int ntables, const uint8_t* tables,
                             int16_t* coef) {
  std::vector<Huff> huff(ntables);
  for (int t = 0; t < ntables; ++t)
    if (!build_huff(tables + 272 * t, &huff[t])) return kBadTable;
  std::vector<Comp> cs(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* r = comps + 7 * c;
    cs[c] = Comp{r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
  }
  for (int s = 0; s < nscans; ++s) {
    const int64_t* r = scans + 22 * s;
    Scan sc;
    sc.ns = static_cast<int>(r[0]);
    for (int i = 0; i < 4; ++i) {
      sc.comp[i] = static_cast<int>(r[1 + i]);
      sc.td[i] = static_cast<int>(r[5 + i]);
      sc.ta[i] = static_cast<int>(r[9 + i]);
    }
    sc.ss = static_cast<int>(r[13]);
    sc.se = static_cast<int>(r[14]);
    sc.ah = static_cast<int>(r[15]);
    sc.al = static_cast<int>(r[16]);
    sc.ri = static_cast<int>(r[17]);
    const bool progressive = r[18] != 0;
    sc.off = r[19];
    sc.len = r[20];
    if (sc.off < 0 || sc.off + sc.len > size) return kTruncated;
    const bool dc_scan = sc.ss == 0;
    for (int i = 0; i < sc.ns; ++i) {
      bool need_dc = !progressive || (dc_scan && sc.ah == 0);
      bool need_ac = !progressive || !dc_scan;
      if ((need_dc && (sc.td[i] < 0 || sc.td[i] >= ntables)) || (need_ac && (sc.ta[i] < 0 || sc.ta[i] >= ntables)))
        return kBadTable;
    }

    Bits b;
    b.d = data;
    b.pos = sc.off;
    b.end = sc.off + sc.len;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int err = kOk;
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);

    auto block_ptr = [&](int ci, int64_t by, int64_t bx) {
      const Comp& c = cs[sc.comp[ci]];
      return coef + 64 * (c.offset + by * c.bw + bx);
    };

    auto decode_block = [&](int ci, int16_t* blk) {
      b.ensure();
      if (!progressive) {  // sequential: DC and AC of the block
        int t = b.decode(huff[sc.td[ci]], &err);
        if (t > 15) {
          err = kBadCode;
          return;
        }
        int diff = t ? extend(b.get(t), t) : 0;
        pred[ci] += diff;
        blk[0] = static_cast<int16_t>(pred[ci]);
        const Huff& ac = huff[sc.ta[ci]];
        for (int k = 1; k < 64; ++k) {
          b.ensure();
          int rs = b.decode(ac, &err);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            if (k > 63) {
              err = kBadRun;
              return;
            }
            blk[kNatural[k]] = static_cast<int16_t>(extend(b.get(sz), sz));
          } else if (r == 15) {
            k += 15;
          } else {
            break;
          }
        }
        return;
      }
      if (dc_scan) {
        if (sc.ah == 0) {  // DC first
          int t = b.decode(huff[sc.td[ci]], &err);
          if (t > 15) {
            err = kBadCode;
            return;
          }
          int diff = t ? extend(b.get(t), t) : 0;
          pred[ci] += diff;
          blk[0] = static_cast<int16_t>(pred[ci] * (1 << sc.al));
        } else if (b.get(1)) {  // DC refinement
          blk[0] = static_cast<int16_t>(blk[0] | p1);
        }
        return;
      }
      const Huff& ac = huff[sc.ta[ci]];
      if (sc.ah == 0) {  // AC first
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        for (int k = sc.ss; k <= sc.se; ++k) {
          b.ensure();
          int rs = b.decode(ac, &err);
          int r = rs >> 4, sz = rs & 15;
          if (sz) {
            k += r;
            if (k > 63) {
              err = kBadRun;
              return;
            }
            blk[kNatural[k]] = static_cast<int16_t>(extend(b.get(sz), sz) * (1 << sc.al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += b.get(r);
            --eobrun;
            break;
          }
        }
        return;
      }
      // AC refinement (libjpeg's decode_mcu_AC_refine)
      int k = sc.ss;
      if (eobrun == 0) {
        for (; k <= sc.se; ++k) {
          b.ensure();
          int rs = b.decode(ac, &err);
          int r = rs >> 4, sz = rs & 15;
          int val = 0;
          if (sz) {
            val = b.get(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += b.get(r);
            break;
          }
          do {
            int16_t* c = blk + kNatural[k];
            if (*c != 0) {
              b.ensure();
              if (b.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
            } else {
              if (--r < 0) break;
            }
            ++k;
          } while (k <= sc.se);
          if (sz) {
            if (k > 63) {
              err = kBadRun;
              return;
            }
            blk[kNatural[k]] = static_cast<int16_t>(val);
          }
        }
      }
      if (eobrun > 0) {
        for (; k <= sc.se; ++k) {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            b.ensure();
            if (b.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          }
        }
        --eobrun;
      }
    };

    int64_t total, per_row;
    if (sc.ns == 1) {
      const Comp& c = cs[sc.comp[0]];
      per_row = c.wib;
      total = c.wib * c.hib;
    } else {
      per_row = mcux;
      total = mcux * mcuy;
    }
    int restarts = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (sc.ri > 0 && m > 0 && m % sc.ri == 0) {
        if (!b.restart(restarts++)) return kBadRestart;
        for (int i = 0; i < 4; ++i) pred[i] = 0;
        eobrun = 0;
      }
      int64_t my = m / per_row, mx = m % per_row;
      if (sc.ns == 1) {
        decode_block(0, block_ptr(0, my, mx));
      } else {
        for (int ci = 0; ci < sc.ns && err == kOk; ++ci) {
          const Comp& c = cs[sc.comp[ci]];
          for (int64_t yy = 0; yy < c.v; ++yy)
            for (int64_t xx = 0; xx < c.h; ++xx) decode_block(ci, block_ptr(ci, my * c.v + yy, mx * c.h + xx));
        }
      }
      if (err != kOk) return err;
      if (b.truncated) return kTruncated;
    }
  }
  return kOk;
}

// The pixel stage. comps as above; quant: ncomp rows of 64 (natural
// order) quantizers; color: 0 grey, 1 YCbCr, 2 RGB. out: H x W (grey) or
// H x W x 3 uint8. Returns 0, or kBadTable for a sampling ratio
// libjpeg does not upsample by an integer.
int jpeg_pixels(int ncomp, const int64_t* comps, const int16_t* coef, const uint16_t* quant, int64_t width,
                int64_t height, int64_t hmax, int64_t vmax, int color, uint8_t* out) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  std::vector<std::vector<uint8_t>> planes(ncomp);
  std::vector<Comp> cs(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* r = comps + 7 * c;
    cs[c] = Comp{r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
    const Comp& cp = cs[c];
    if (hmax % cp.h || vmax % cp.v) return kBadTable;
    const int64_t stride = cp.bw * 8;
    planes[c].assign(stride * cp.bh * 8, 0);
    int32_t q[64];
    for (int i = 0; i < 64; ++i) q[i] = static_cast<int16_t>(quant[64 * c + i]);  // ISLOW_MULT_TYPE is short
    for (int64_t by = 0; by < cp.bh; ++by) {
      for (int64_t bx = 0; bx < cp.bw; ++bx) {
        const int16_t* in = coef + 64 * (cp.offset + by * cp.bw + bx);
        int32_t ws[64];
        for (int col = 0; col < 8; ++col) {  // pass 1: columns
          int64_t z2 = in[16 + col] * q[16 + col], z3 = in[48 + col] * q[48 + col];
          int64_t z1 = (z2 + z3) * F0541;
          int64_t tmp2 = z1 - z3 * F1847, tmp3 = z1 + z2 * F0765;
          z2 = in[col] * q[col];
          z3 = in[32 + col] * q[32 + col];
          int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
          int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
          int64_t o0 = in[56 + col] * q[56 + col], o1 = in[40 + col] * q[40 + col];
          int64_t o2 = in[24 + col] * q[24 + col], o3 = in[8 + col] * q[8 + col];
          int64_t a1 = o0 + o3, a2 = o1 + o2, a3 = o0 + o2, a4 = o1 + o3;
          int64_t z5 = (a3 + a4) * F1175;
          o0 *= F0298;
          o1 *= F2053;
          o2 *= F3072;
          o3 *= F1501;
          a1 *= -F0899;
          a2 *= -F2562;
          a3 = a3 * -F1961 + z5;
          a4 = a4 * -F0390 + z5;
          o0 += a1 + a3;
          o1 += a2 + a4;
          o2 += a2 + a3;
          o3 += a1 + a4;
          const int sh = 11;  // CONST_BITS - PASS1_BITS
          const int64_t rnd = int64_t(1) << (sh - 1);
          ws[col] = static_cast<int32_t>((t10 + o3 + rnd) >> sh);
          ws[56 + col] = static_cast<int32_t>((t10 - o3 + rnd) >> sh);
          ws[8 + col] = static_cast<int32_t>((t11 + o2 + rnd) >> sh);
          ws[48 + col] = static_cast<int32_t>((t11 - o2 + rnd) >> sh);
          ws[16 + col] = static_cast<int32_t>((t12 + o1 + rnd) >> sh);
          ws[40 + col] = static_cast<int32_t>((t12 - o1 + rnd) >> sh);
          ws[24 + col] = static_cast<int32_t>((t13 + o0 + rnd) >> sh);
          ws[32 + col] = static_cast<int32_t>((t13 - o0 + rnd) >> sh);
        }
        uint8_t* dst = planes[c].data() + by * 8 * stride + bx * 8;
        for (int row = 0; row < 8; ++row) {  // pass 2: rows
          const int32_t* w = ws + 8 * row;
          int64_t z2 = w[2], z3 = w[6];
          int64_t z1 = (z2 + z3) * F0541;
          int64_t tmp2 = z1 - z3 * F1847, tmp3 = z1 + z2 * F0765;
          int64_t tmp0 = (int64_t(w[0]) + w[4]) * 8192, tmp1 = (int64_t(w[0]) - w[4]) * 8192;
          int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
          int64_t o0 = w[7], o1 = w[5], o2 = w[3], o3 = w[1];
          int64_t a1 = o0 + o3, a2 = o1 + o2, a3 = o0 + o2, a4 = o1 + o3;
          int64_t z5 = (a3 + a4) * F1175;
          o0 *= F0298;
          o1 *= F2053;
          o2 *= F3072;
          o3 *= F1501;
          a1 *= -F0899;
          a2 *= -F2562;
          a3 = a3 * -F1961 + z5;
          a4 = a4 * -F0390 + z5;
          o0 += a1 + a3;
          o1 += a2 + a4;
          o2 += a2 + a3;
          o3 += a1 + a4;
          const int sh = 18;  // CONST_BITS + PASS1_BITS + 3
          const int64_t rnd = int64_t(1) << (sh - 1);
          int64_t v[8] = {(t10 + o3 + rnd) >> sh, (t11 + o2 + rnd) >> sh, (t12 + o1 + rnd) >> sh,
                          (t13 + o0 + rnd) >> sh, (t13 - o0 + rnd) >> sh, (t12 - o1 + rnd) >> sh,
                          (t11 - o2 + rnd) >> sh, (t10 - o3 + rnd) >> sh};
          uint8_t* o = dst + row * stride;
          for (int i = 0; i < 8; ++i) o[i] = static_cast<uint8_t>(std::min<int64_t>(255, std::max<int64_t>(0, v[i] + 128)));
        }
      }
    }
  }

  if (ncomp == 1) {
    const int64_t stride = cs[0].bw * 8;
    for (int64_t y = 0; y < height; ++y) std::memcpy(out + y * width, planes[0].data() + y * stride, width);
    return kOk;
  }

  // upsample every component to W x H (libjpeg-turbo's jdsample.c methods)
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const Comp& cp = cs[c];
    const int64_t rh = hmax / cp.h, rv = vmax / cp.v, stride = cp.bw * 8;
    const int64_t dw = (width * cp.h + hmax - 1) / hmax, dh = (height * cp.v + vmax - 1) / vmax;
    const uint8_t* P = planes[c].data();
    std::vector<uint8_t>& F = full[c];
    F.assign(width * height, 0);
    auto row = [&](int64_t i) { return P + std::min(std::max<int64_t>(i, 0), dh - 1) * stride; };
    if (rh == 1 && rv == 1) {
      for (int64_t y = 0; y < height; ++y) std::memcpy(F.data() + y * width, P + y * stride, width);
    } else if (rh == 2 && rv == 1 && dw > 2) {  // h2v1 fancy
      for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = P + y * stride;
        uint8_t* o = F.data() + y * width;
        for (int64_t j = 0; j < dw; ++j) {
          int a = in[j] * 3, l = in[std::max<int64_t>(j - 1, 0)], r = in[std::min(j + 1, dw - 1)];
          if (2 * j < width) o[2 * j] = static_cast<uint8_t>((a + l + 1) >> 2);
          if (2 * j + 1 < width) o[2 * j + 1] = static_cast<uint8_t>((a + r + 2) >> 2);
        }
      }
    } else if (rh == 2 && rv == 2 && dw > 2) {  // h2v2 fancy
      std::vector<int> sum(dw);
      for (int64_t y = 0; y < height; ++y) {
        const int64_t i = y / 2;
        const uint8_t* near = row(i);
        const uint8_t* far = row(y % 2 ? i + 1 : i - 1);
        for (int64_t j = 0; j < dw; ++j) sum[j] = near[j] * 3 + far[j];
        uint8_t* o = F.data() + y * width;
        for (int64_t j = 0; j < dw; ++j) {
          int a = sum[j] * 3, l = sum[std::max<int64_t>(j - 1, 0)], r = sum[std::min(j + 1, dw - 1)];
          if (2 * j < width) o[2 * j] = static_cast<uint8_t>((a + l + 8) >> 4);
          if (2 * j + 1 < width) o[2 * j + 1] = static_cast<uint8_t>((a + r + 7) >> 4);
        }
      }
    } else if (rh == 1 && rv == 2) {  // h1v2 fancy
      for (int64_t y = 0; y < height; ++y) {
        const int64_t i = y / 2;
        const uint8_t* near = row(i);
        const uint8_t* far = row(y % 2 ? i + 1 : i - 1);
        const int bias = y % 2 ? 2 : 1;
        uint8_t* o = F.data() + y * width;
        for (int64_t x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      }
    } else {  // box replication (h2v1/h2v2 on narrow planes, integral factors)
      for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = P + (y / rv) * stride;
        uint8_t* o = F.data() + y * width;
        for (int64_t x = 0; x < width; ++x) o[x] = in[x / rh];
      }
    }
  }

  const int64_t n = width * height;
  if (color == 2) {
    for (int64_t p = 0; p < n; ++p)
      for (int c = 0; c < 3; ++c) out[3 * p + c] = full[c][p];
    return kOk;
  }
  // jdcolor.c's tables, SCALEBITS 16
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  const int64_t half = int64_t(1) << 15;
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = static_cast<int>((91881 * x + half) >> 16);   // FIX(1.40200)
    cb_b[i] = static_cast<int>((116130 * x + half) >> 16);  // FIX(1.77200)
    cr_g[i] = -46802 * x;                                   // FIX(0.71414)
    cb_g[i] = -22554 * x + half;                            // FIX(0.34414)
  }
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
  for (int64_t p = 0; p < n; ++p) {
    int y = Y[p], cb = Cb[p], cr = Cr[p];
    out[3 * p] = clamp(y + cr_r[cr]);
    out[3 * p + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * p + 2] = clamp(y + cb_b[cb]);
  }
  return kOk;
}

// ------------------------------------------------------------- encoder

// Baseline encode of a W x H grey (ncomp 1) or RGB (ncomp 3, written 4:2:0)
// uint8 image: the entropy-coded data of one scan,
// byte-stuffed and padded with 1-bits, written to `out`. quant: 2 rows of
// 64 natural-order quantizers (luma, chroma); tables: 4 rows of 272 bytes
// (DC luma, AC luma, DC chroma, AC chroma). Returns the byte count or a
// negative Err.
int64_t jpeg_encode_scan(const uint8_t* img, int64_t width, int64_t height, int ncomp, const uint16_t* quant, const uint8_t* tables, uint8_t* out, int64_t cap) {
  // Huffman code tables
  uint32_t code[4][256];
  uint8_t size[4][256];
  for (int t = 0; t < 4; ++t) {
    std::memset(size[t], 0, 256);
    const uint8_t* bits = tables + 272 * t;
    const uint8_t* vals = bits + 16;
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p, ++c) {
        code[t][vals[p]] = c;
        size[t][vals[p]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
  // colour conversion (jccolor.c, SCALEBITS 16)
  const int64_t n = width * height;
  std::vector<std::vector<uint8_t>> full(ncomp, std::vector<uint8_t>(n));
  if (ncomp == 1) {
    std::memcpy(full[0].data(), img, n);
  } else {
    const int64_t half = int64_t(1) << 15, cbcr = int64_t(128) << 16;
    for (int64_t p = 0; p < n; ++p) {
      int64_t r = img[3 * p], g = img[3 * p + 1], b = img[3 * p + 2];
      full[0][p] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + half) >> 16);
      full[1][p] = static_cast<uint8_t>((-11059 * r - 21709 * g + 32768 * b + cbcr + half - 1) >> 16);
      full[2][p] = static_cast<uint8_t>((32768 * r - 27439 * g - 5329 * b + cbcr + half - 1) >> 16);
    }
  }
  const int64_t hmax = ncomp == 3 ? 2 : 1, vmax = hmax;
  const int64_t mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  struct EComp {
    int64_t h, v, wib, hib, dh;
    std::vector<uint8_t> plane;  // wib*8 wide, hib*8 high
    std::vector<int16_t> coef;   // quantized, natural order
  };
  std::vector<EComp> cs(ncomp);
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  for (int c = 0; c < ncomp; ++c) {
    EComp& e = cs[c];
    e.h = c == 0 ? hmax : 1;
    e.v = c == 0 ? vmax : 1;
    const int64_t rh = hmax / e.h, rv = vmax / e.v;
    e.wib = (width * e.h + 8 * hmax - 1) / (8 * hmax);
    e.hib = (height * e.v + 8 * vmax - 1) / (8 * vmax);
    e.dh = (height + rv - 1) / rv;  // rows the downsampler makes; later rows repeat the last
    const int64_t pw = e.wib * 8, ph = e.hib * 8;
    e.plane.assign(pw * ph, 0);
    const uint8_t* src = full[c].data();
    for (int64_t y = 0; y < ph; ++y) {
      const int64_t yy = std::min(y, e.dh - 1);
      uint8_t* o = e.plane.data() + y * pw;
      if (rh == 1) {
        const uint8_t* in = src + std::min(yy, height - 1) * width;
        for (int64_t x = 0; x < pw; ++x) o[x] = in[std::min(x, width - 1)];
      } else {  // h2v2_downsample: bias 1, 2, 1, 2 along the row
        const uint8_t* r0 = src + std::min(2 * yy, height - 1) * width;
        const uint8_t* r1 = src + std::min(2 * yy + 1, height - 1) * width;
        for (int64_t x = 0; x < pw; ++x) {
          const int64_t x0 = std::min(2 * x, width - 1), x1 = std::min(2 * x + 1, width - 1);
          o[x] = static_cast<uint8_t>((r0[x0] + r0[x1] + r1[x0] + r1[x1] + 1 + (x & 1)) >> 2);
        }
      }
    }
    // islow forward DCT and quantization, block by block
    const uint16_t* q = quant + 64 * (c == 0 ? 0 : 1);
    e.coef.assign(e.wib * e.hib * 64, 0);
    for (int64_t by = 0; by < e.hib; ++by) {
      for (int64_t bx = 0; bx < e.wib; ++bx) {
        int64_t d[64];
        for (int r = 0; r < 8; ++r)
          for (int k = 0; k < 8; ++k) d[8 * r + k] = int64_t(e.plane[(by * 8 + r) * pw + bx * 8 + k]) - 128;
        for (int pass = 0; pass < 2; ++pass) {
          const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
          for (int i = 0; i < 8; ++i) {
            int64_t* p = d + i * stride;
            int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
            int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
            int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
            int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
            int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
            const int sh = pass == 0 ? 11 : 15;  // CONST_BITS -/+ PASS1_BITS
            const int64_t rnd = int64_t(1) << (sh - 1);
            if (pass == 0) {
              p[0] = (t10 + t11) * 4;
              p[4 * step] = (t10 - t11) * 4;
            } else {
              p[0] = (t10 + t11 + 2) >> 2;
              p[4 * step] = (t10 - t11 + 2) >> 2;
            }
            int64_t z1 = (t12 + t13) * F0541;
            p[2 * step] = (z1 + t13 * F0765 + rnd) >> sh;
            p[6 * step] = (z1 - t12 * F1847 + rnd) >> sh;
            int64_t a1 = t4 + t7, a2 = t5 + t6, a3 = t4 + t6, a4 = t5 + t7;
            int64_t z5 = (a3 + a4) * F1175;
            t4 *= F0298;
            t5 *= F2053;
            t6 *= F3072;
            t7 *= F1501;
            a1 *= -F0899;
            a2 *= -F2562;
            a3 = a3 * -F1961 + z5;
            a4 = a4 * -F0390 + z5;
            p[7 * step] = (t4 + a1 + a3 + rnd) >> sh;
            p[5 * step] = (t5 + a2 + a4 + rnd) >> sh;
            p[3 * step] = (t6 + a2 + a3 + rnd) >> sh;
            p[step] = (t7 + a1 + a4 + rnd) >> sh;
          }
        }
        int16_t* o = e.coef.data() + 64 * (by * e.wib + bx);
        for (int i = 0; i < 64; ++i) {
          const int64_t qv = int64_t(q[i]) * 8;
          int64_t t = d[i] < 0 ? -d[i] : d[i];
          t = (t + (qv >> 1)) / qv;
          o[i] = static_cast<int16_t>(d[i] < 0 ? -t : t);
        }
      }
    }
  }

  // Huffman coding in MCU order, with libjpeg's dummy blocks at the
  // right and bottom edges (zero AC, the DC of the block before them)
  int64_t pos = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool full_out = false;
  auto put = [&](uint32_t bits, int len) {
    acc = (acc << len) | (bits & ((1u << len) - 1));
    nacc += len;
    while (nacc >= 8) {
      uint8_t byte = static_cast<uint8_t>(acc >> (nacc - 8));
      nacc -= 8;
      if (pos + 2 > cap) {
        full_out = true;
        return;
      }
      out[pos++] = byte;
      if (byte == 0xFF) out[pos++] = 0;
    }
  };
  int pred[3] = {0, 0, 0};
  auto emit = [&](int c, const int16_t* blk) {
    const int tdc = c == 0 ? 0 : 2, tac = tdc + 1;
    int diff = blk[0] - pred[c];
    pred[c] = blk[0];
    int a = diff < 0 ? -diff : diff, s = 0;
    while (a) {
      ++s;
      a >>= 1;
    }
    put(code[tdc][s], size[tdc][s]);
    if (s) put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), s);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        put(code[tac][0xF0], size[tac][0xF0]);
        run -= 16;
      }
      int av = v < 0 ? -v : v, sz = 0;
      while (av) {
        ++sz;
        av >>= 1;
      }
      const int rs = (run << 4) | sz;
      put(code[tac][rs], size[tac][rs]);
      put(static_cast<uint32_t>(v < 0 ? v - 1 : v), sz);
      run = 0;
    }
    if (run > 0) put(code[tac][0], size[tac][0]);
  };
  if (ncomp == 1) {
    for (int64_t i = 0; i < cs[0].wib * cs[0].hib && !full_out; ++i) emit(0, cs[0].coef.data() + 64 * i);
  } else {
    int16_t dummy[64];
    for (int64_t my = 0; my < mcuy && !full_out; ++my) {
      for (int64_t mx = 0; mx < mcux; ++mx) {
        for (int c = 0; c < 3; ++c) {
          const EComp& e = cs[c];
          int16_t last_dc = 0;  // DC of the MCU's previous block of this component
          for (int64_t yy = 0; yy < e.v; ++yy) {
            const int64_t by = my * e.v + yy;
            const int16_t row_dc = last_dc;
            for (int64_t xx = 0; xx < e.h; ++xx) {
              const int64_t bx = mx * e.h + xx;
              const int16_t* blk;
              if (by < e.hib && bx < e.wib) {
                blk = e.coef.data() + 64 * (by * e.wib + bx);
              } else {
                std::memset(dummy, 0, sizeof(dummy));
                dummy[0] = by < e.hib ? last_dc : row_dc;
                blk = dummy;
              }
              last_dc = blk[0];
              emit(c, blk);
            }
          }
        }
      }
    }
  }
  if (nacc > 0) put(0x7F, 7);  // pad the last byte with 1-bits
  if (full_out) return kOverflow;
  return pos;
}

}  // extern "C"
