// Image codecs of the port's data layer, for the host: baseline JPEG
// decoding and encoding and PNG row unfiltering. The card's machine has
// no cv2 or PIL; these are the bit-level loops that Python cannot run at
// a usable speed. Built with g++ at first use by utils/imageio.py and
// bound with ctypes (a plain C interface; every entry returns 0 or a
// nonzero error code, the message in imageio_error()).
//
// JPEG decoding follows libjpeg-turbo's default path, which cv2.imread
// uses, step by step and in integer arithmetic throughout, so that the
// output is the same to the bit:
//   * baseline or extended sequential Huffman (SOF0/SOF1, 8-bit samples),
//     interleaved or not, with restart intervals; progressive (SOF2) and
//     arithmetic-coded (SOF9-SOF15) files raise;
//   * the accurate integer IDCT (JDCT_ISLOW, jidctint.c) and its
//     range-limit table;
//   * "fancy" upsampling (jdsample.c: h2v1 and h2v2, the triangle filter,
//     rows above the first and below the last replicated; plain
//     replication for a component at most 2 samples wide);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c.
// Sampling factors other than 4:4:4, 4:2:2 (h2v1) and 4:2:0 (h2v2), and
// files of 2 or 4 components, raise.
//
// JPEG encoding writes what cv2.imwrite writes by default: baseline,
// 4:2:0 (gray: one component), the Annex K tables scaled to the quality
// as libjpeg scales them, the standard Huffman tables, a JFIF header. The
// colour conversion and the 2x2 downsampling are libjpeg's; the forward
// DCT is computed in double precision (libjpeg's is an integer
// approximation), so the bytes differ from cv2's while the image agrees
// to within the quantization.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

thread_local char g_error[256] = "";
thread_local std::vector<uint8_t> g_encoded;

int fail(const char* msg) {
  std::snprintf(g_error, sizeof(g_error), "%s", msg);
  return 1;
}

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so that a corrupt run length stays inside the block
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- decoding

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint16_t fast[1 << 9];  // (length << 8) | value for codes of <= 9 bits

  bool build(const uint8_t* bits, const uint8_t* values, int nvals) {
    std::memset(fast, 0, sizeof(fast));
    std::memcpy(vals, values, nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = uint16_t((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      if (code > (1 << l)) return false;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
    return true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          uint32_t b2 = p + 1 < end ? p[1] : 0xD9;
          if (b2 == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // feed zeros past a marker, as libjpeg does
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int bits(int n) {
    if (n == 0) return 0;
    if (cnt < n) fill();
    int v = int(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    int e = h.fast[buf >> (64 - 9)];
    if (e) {
      int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int code = int(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    buf <<= 16;  // corrupt data: no code of any length
    cnt -= 16;
    return 0;
  }
  // after a restart interval: drop the partial byte, step over RSTn
  void restart() {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
      ++p;
    if (p + 1 < end) p += 2;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int width, height;          // downsampled size (ceil)
  int bw, bh;                 // blocks across and down, padded to MCUs
  std::vector<uint8_t> plane;  // bw * 8 x bh * 8 samples
  uint16_t quant[64];          // natural order, latched at the first scan
  bool latched = false;
  int dc_pred = 0;
};

// libjpeg's range-limit table behind the IDCT: x -> clamp(x + 128), with
// the RANGE_MASK wrap for values outside [-512, 511]
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = uint8_t(v);
    }
  }
};
const RangeLimit kRange;

// jidctint.c: jpeg_idct_islow
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  const int CB = 13, P1 = 2;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (in[0] * int(qq[0])) * (1 << P1);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * int64_t(qq[16]), z3 = in[48] * int64_t(qq[48]);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = in[0] * int64_t(qq[0]);
    z3 = in[32] * int64_t(qq[32]);
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * int64_t(qq[56]);
    tmp1 = in[40] * int64_t(qq[40]);
    tmp2 = in[24] * int64_t(qq[24]);
    tmp3 = in[8] * int64_t(qq[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CB - P1;
    const int64_t r = int64_t(1) << (s - 1);
    w[0] = int((tmp10 + tmp3 + r) >> s);
    w[56] = int((tmp10 - tmp3 + r) >> s);
    w[8] = int((tmp11 + tmp2 + r) >> s);
    w[48] = int((tmp11 - tmp2 + r) >> s);
    w[16] = int((tmp12 + tmp1 + r) >> s);
    w[40] = int((tmp12 - tmp1 + r) >> s);
    w[24] = int((tmp13 + tmp0 + r) >> s);
    w[32] = int((tmp13 - tmp0 + r) >> s);
  }
  for (int rr = 0; rr < 8; ++rr) {
    const int* w = ws + 8 * rr;
    uint8_t* o = out + rr * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = kRange.t[((w[0] + (1 << (P1 + 2))) >> (P1 + 3)) & 1023];
      for (int k = 0; k < 8; ++k) o[k] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CB);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CB + P1 + 3;
    const int64_t r = int64_t(1) << (s - 1);
    o[0] = kRange.t[int((tmp10 + tmp3 + r) >> s) & 1023];
    o[7] = kRange.t[int((tmp10 - tmp3 + r) >> s) & 1023];
    o[1] = kRange.t[int((tmp11 + tmp2 + r) >> s) & 1023];
    o[6] = kRange.t[int((tmp11 - tmp2 + r) >> s) & 1023];
    o[2] = kRange.t[int((tmp12 + tmp1 + r) >> s) & 1023];
    o[5] = kRange.t[int((tmp12 - tmp1 + r) >> s) & 1023];
    o[3] = kRange.t[int((tmp13 + tmp0 + r) >> s) & 1023];
    o[4] = kRange.t[int((tmp13 - tmp0 + r) >> s) & 1023];
  }
}

struct Decoder {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];

  int u16(int64_t at) const { return (data[at] << 8) | data[at + 1]; }

  int header(bool stop_at_frame);
  int scan(int64_t seg_end);
  int run();
  int output(uint8_t* out) const;
};

int Decoder::header(bool stop_at_frame) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
    return fail("not a JPEG file (no SOI marker)");
  pos = 2;
  for (;;) {
    while (pos < n && data[pos] != 0xFF) ++pos;  // tolerate stray bytes
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) return fail("JPEG file ends before its EOI marker");
    int m = data[pos++];
    if (m == 0xD9) return frame ? 0 : fail("JPEG file has no frame");
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (pos + 2 > n) return fail("truncated JPEG marker segment");
    int len = u16(pos);
    int64_t seg = pos + 2, seg_end = pos + len;
    if (len < 2 || seg_end > n) return fail("truncated JPEG marker segment");
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
      return fail("progressive JPEG is not supported (baseline and "
                  "extended sequential Huffman only)");
    if (m >= 0xC9 && m <= 0xCF && m != 0xCC)
      return fail("arithmetic-coded JPEG is not supported");
    if (m == 0xC3 || m == 0xC7 || m == 0xCB)
      return fail("lossless JPEG is not supported");
    if (m == 0xC5) return fail("hierarchical JPEG is not supported");
    if (m == 0xC0 || m == 0xC1) {
      if (frame) return fail("JPEG file has two frames");
      if (len < 8 || data[seg] != 8)
        return fail("JPEG sample precision other than 8 bits");
      height = u16(seg + 1);
      width = u16(seg + 3);
      ncomp = data[seg + 5];
      if (height == 0) return fail("JPEG with DNL-defined height");
      if (ncomp != 1 && ncomp != 3)
        return fail("JPEG with other than 1 or 3 components");
      if (len != 8 + 3 * ncomp) return fail("bad JPEG SOF segment");
      for (int i = 0; i < ncomp; ++i) {
        Component& c = comp[i];
        c.id = data[seg + 6 + 3 * i];
        c.h = data[seg + 7 + 3 * i] >> 4;
        c.v = data[seg + 7 + 3 * i] & 15;
        c.tq = data[seg + 8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
          return fail("bad JPEG component parameters");
        hmax = c.h > hmax ? c.h : hmax;
        vmax = c.v > vmax ? c.v : vmax;
      }
      for (int i = 0; i < ncomp; ++i) {
        Component& c = comp[i];
        int fh = hmax / c.h, fv = vmax / c.v;
        bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                  ((fh == 1 && fv == 1) || (fh == 2 && fv == 1) ||
                   (fh == 2 && fv == 2));
        if (!ok)
          return fail("JPEG chroma subsampling other than 4:4:4, 4:2:2 "
                      "and 4:2:0 is not supported");
      }
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int i = 0; i < ncomp; ++i) {
        Component& c = comp[i];
        c.width = int((int64_t(width) * c.h + hmax - 1) / hmax);
        c.height = int((int64_t(height) * c.v + vmax - 1) / vmax);
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
      }
      frame = true;
      if (stop_at_frame) return 0;
    } else if (m == 0xC4) {
      int64_t p = seg;
      while (p < seg_end) {
        int tc = data[p] >> 4, th = data[p] & 15;
        if (tc > 1 || th > 3 || p + 17 > seg_end)
          return fail("bad JPEG DHT segment");
        uint8_t bits[17];
        bits[0] = 0;
        int total = 0;
        for (int l = 1; l <= 16; ++l) total += bits[l] = data[p + l];
        if (total > 256 || p + 17 + total > seg_end)
          return fail("bad JPEG DHT segment");
        Huffman& h = tc ? ac[th] : dc[th];
        if (!h.build(bits, data + p + 17, total))
          return fail("bad JPEG Huffman table");
        p += 17 + total;
      }
    } else if (m == 0xDB) {
      int64_t p = seg;
      while (p < seg_end) {
        int pq = data[p] >> 4, tq = data[p] & 15;
        if (pq > 1 || tq > 3 || p + 1 + 64 * (pq + 1) > seg_end)
          return fail("bad JPEG DQT segment");
        for (int k = 0; k < 64; ++k)
          qt[tq][kZigzag[k]] = pq ? uint16_t(u16(p + 1 + 2 * k))
                                  : data[p + 1 + k];
        qt_defined[tq] = true;
        p += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xDD) {
      if (len != 4) return fail("bad JPEG DRI segment");
      restart = u16(seg);
    } else if (m == 0xDA) {
      if (!frame) return fail("JPEG scan before its frame");
      int r = scan(seg_end);
      if (r) return r;
      continue;  // scan() left pos after the entropy-coded data
    } else if (m == 0xE0) {
      if (len >= 7 && std::memcmp(data + seg, "JFIF\0", 5) == 0) jfif = true;
    } else if (m == 0xEE) {
      if (len >= 14 && std::memcmp(data + seg, "Adobe", 5) == 0) {
        adobe = true;
        adobe_transform = data[seg + 11];
      }
    } else if (m == 0xC8 || (m >= 0xF0 && m <= 0xFD && m != 0xFE)) {
      // JPG extensions: skipped as libjpeg skips them
    }
    // APPn, COM and everything else: skipped
    pos = seg_end;
  }
}

int Decoder::scan(int64_t seg_end) {
  int64_t seg = pos + 2;
  int ns = data[seg];
  if (ns < 1 || ns > ncomp || seg_end - seg != 4 + 2 * ns)
    return fail("bad JPEG SOS segment");
  Component* sc[4];
  int td[4], ta[4];
  for (int i = 0; i < ns; ++i) {
    int cid = data[seg + 1 + 2 * i];
    sc[i] = nullptr;
    for (int j = 0; j < ncomp; ++j)
      if (comp[j].id == cid) sc[i] = &comp[j];
    if (!sc[i]) return fail("JPEG scan names an unknown component");
    td[i] = data[seg + 2 + 2 * i] >> 4;
    ta[i] = data[seg + 2 + 2 * i] & 15;
    if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined || !ac[ta[i]].defined)
      return fail("JPEG scan uses an undefined Huffman table");
    Component& c = *sc[i];
    if (!c.latched) {
      if (!qt_defined[c.tq])
        return fail("JPEG component uses an undefined quantization table");
      std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
      c.latched = true;
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
    }
    c.dc_pred = 0;
  }
  int ss = data[seg_end - 3], se = data[seg_end - 2], ahal = data[seg_end - 1];
  if (ss != 0 || se != 63 || ahal != 0)
    return fail("JPEG scan is not sequential (spectral selection or "
                "successive approximation)");
  BitReader br;
  br.p = data + seg_end;
  br.end = data + n;
  int16_t coef[64];

  auto block = [&](int i, int bx, int by) {
    Component& c = *sc[i];
    std::memset(coef, 0, sizeof(coef));
    int t = br.decode(dc[td[i]]);
    if (t) c.dc_pred += extend(br.bits(t), t);
    coef[0] = int16_t(c.dc_pred);
    const Huffman& a = ac[ta[i]];
    for (int k = 1; k < 64;) {
      int rs = br.decode(a);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kZigzag[k]] = int16_t(extend(br.bits(s), s));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, c.quant, c.plane.data() + size_t(by) * 8 * stride + bx * 8,
               stride);
  };

  int64_t units;
  int ux = 0, uy = 0;
  if (ns == 1) {
    Component& c = *sc[0];
    ux = (c.width + 7) / 8;
    uy = (c.height + 7) / 8;
    units = int64_t(ux) * uy;
  } else {
    units = int64_t(mcux) * mcuy;
  }
  for (int64_t u = 0; u < units; ++u) {
    if (restart && u > 0 && u % restart == 0) {
      br.restart();
      for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    }
    if (ns == 1) {
      block(0, int(u % ux), int(u / ux));
    } else {
      int mx = int(u % mcux), my = int(u / mcux);
      for (int i = 0; i < ns; ++i)
        for (int y = 0; y < sc[i]->v; ++y)
          for (int x = 0; x < sc[i]->h; ++x)
            block(i, mx * sc[i]->h + x, my * sc[i]->v + y);
    }
  }
  // step to the marker after the entropy-coded data
  const uint8_t* p = br.p;
  while (p + 1 < data + n &&
         !(p[0] == 0xFF && p[1] != 0x00 && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
    ++p;
  pos = p - data;
  return 0;
}

// jdsample.c's fancy upsampling of one component into full-size rows
void upsample(const Component& c, int hmax, int vmax, int width, int height,
              std::vector<uint8_t>& out) {
  int fh = hmax / c.h, fv = vmax / c.v;
  int stride = c.bw * 8;
  const uint8_t* in = c.plane.data();
  out.assign(size_t(width) * height, 0);
  int cw = c.width;
  bool fancy = cw > 2;
  std::vector<uint8_t> row(size_t(cw) * 2 + 2);
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out.data() + size_t(y) * width;
    if (fh == 1 && fv == 1) {
      std::memcpy(o, in + size_t(y) * stride, width);
      continue;
    }
    if (fh == 2 && fv == 1) {
      const uint8_t* s = in + size_t(y) * stride;
      if (!fancy) {
        for (int x = 0; x < width; ++x) o[x] = s[x >> 1];
        continue;
      }
      uint8_t* r = row.data();
      r[0] = s[0];
      r[1] = uint8_t((s[0] * 3 + s[1] + 2) >> 2);
      for (int i = 1; i < cw - 1; ++i) {
        int v = s[i] * 3;
        r[2 * i] = uint8_t((v + s[i - 1] + 1) >> 2);
        r[2 * i + 1] = uint8_t((v + s[i + 1] + 2) >> 2);
      }
      r[2 * cw - 2] = uint8_t((s[cw - 1] * 3 + s[cw - 2] + 1) >> 2);
      r[2 * cw - 1] = s[cw - 1];
      std::memcpy(o, r, width);
      continue;
    }
    // h2v2
    int iy = y >> 1;
    if (!fancy) {
      const uint8_t* s = in + size_t(iy) * stride;
      for (int x = 0; x < width; ++x) o[x] = s[x >> 1];
      continue;
    }
    int ny = (y & 1) ? iy + 1 : iy - 1;
    if (ny < 0) ny = 0;
    if (ny > c.height - 1) ny = c.height - 1;
    const uint8_t* s0 = in + size_t(iy) * stride;
    const uint8_t* s1 = in + size_t(ny) * stride;
    uint8_t* r = row.data();
    int last = s0[0] * 3 + s1[0];
    int cur = last;
    int next = s0[1] * 3 + s1[1];
    r[0] = uint8_t((cur * 4 + 8) >> 4);
    r[1] = uint8_t((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int i = 1; i < cw - 1; ++i) {
      next = s0[i + 1] * 3 + s1[i + 1];
      r[2 * i] = uint8_t((cur * 3 + last + 8) >> 4);
      r[2 * i + 1] = uint8_t((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    r[2 * cw - 2] = uint8_t((cur * 3 + last + 8) >> 4);
    r[2 * cw - 1] = uint8_t((cur * 4 + 7) >> 4);
    std::memcpy(o, r, width);
  }
}

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

int Decoder::output(uint8_t* out) const {
  if (ncomp == 1) {
    const Component& c = comp[0];
    if (c.plane.empty()) return fail("JPEG component has no scan");
    for (int y = 0; y < height; ++y)
      std::memcpy(out + size_t(y) * width,
                  c.plane.data() + size_t(y) * c.bw * 8, width);
    return 0;
  }
  std::vector<uint8_t> planes[3];
  for (int i = 0; i < 3; ++i) {
    if (comp[i].plane.empty()) return fail("JPEG component has no scan");
    upsample(comp[i], hmax, vmax, width, height, planes[i]);
  }
  bool ycc = true;
  if (jfif) ycc = true;
  else if (adobe) ycc = adobe_transform != 0;
  else if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
    ycc = false;
  size_t np = size_t(width) * height;
  if (!ycc) {
    for (size_t k = 0; k < np; ++k) {
      out[3 * k] = planes[0][k];
      out[3 * k + 1] = planes[1][k];
      out[3 * k + 2] = planes[2][k];
    }
    return 0;
  }
  // jdcolor.c: build_ycc_rgb_table, ycc_rgb_convert
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static bool built = false;
  if (!built) {
    const int SB = 16;
    const int64_t half = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> SB);
      cb_b[i] = int((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    built = true;
  }
  for (size_t k = 0; k < np; ++k) {
    int y = planes[0][k], cb = planes[1][k], cr = planes[2][k];
    out[3 * k] = clamp255(y + cr_r[cr]);
    out[3 * k + 1] = clamp255(y + int((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * k + 2] = clamp255(y + cb_b[cb]);
  }
  return 0;
}

// ---------------------------------------------------------------- encoding

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Code {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(len, 0, sizeof(len));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++c) {
        code[vals[k]] = uint16_t(c);
        len[vals[k]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int bits) {
    acc = (acc << bits) | (v & ((1u << bits) - 1));
    n += bits;
    while (n >= 8) {
      uint8_t b = uint8_t(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
    acc &= (1u << n) - 1;
  }
  void flush() {
    if (n) put(0x7F, 8 - n);  // pad with 1-bits
  }
};

// libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (force_baseline)
void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = uint16_t(t);
  }
}

struct Dct {
  double c[8][8];
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        c[u][x] = (u ? 0.5 : 0.5 / std::sqrt(2.0)) *
                  std::cos((2 * x + 1) * u * M_PI / 16);
  }
};
const Dct kDct;

void encode_block(const uint8_t* src, int stride, const uint16_t* q,
                  const Code& dcc, const Code& acc, int& pred, BitWriter& bw) {
  double tmp[64], f[64];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += kDct.c[u][x] * (src[y * stride + x] - 128);
      tmp[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += kDct.c[v][y] * tmp[y * 8 + u];
      f[v * 8 + u] = s;
    }
  int zz[64];
  for (int k = 0; k < 64; ++k) {
    int nat = kZigzag[k];
    zz[k] = int(std::lround(f[nat] / q[nat]));
  }
  auto magnitude = [](int v) {
    int a = v < 0 ? -v : v, s = 0;
    while (a) { ++s; a >>= 1; }
    return s;
  };
  int diff = zz[0] - pred;
  pred = zz[0];
  int s = magnitude(diff);
  bw.put(dcc.code[s], dcc.len[s]);
  if (s) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    if (zz[k] == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(acc.code[0xF0], acc.len[0xF0]);
      run -= 16;
    }
    int v = zz[k];
    s = magnitude(v);
    int rs = (run << 4) | s;
    bw.put(acc.code[rs], acc.len[rs]);
    bw.put(uint32_t(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run) bw.put(acc.code[0], acc.len[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 255));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits,
             const uint8_t* vals) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + total);
  o.push_back(uint8_t(cls_id));
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  for (int i = 0; i < total; ++i) o.push_back(vals[i]);
}

}  // namespace

extern "C" {

const char* imageio_error() { return g_error; }

// the frame's size: rows, columns, channels (1 gray, 3 RGB)
int jpeg_info(const uint8_t* data, int64_t n, int* h, int* w, int* c) {
  Decoder d;
  d.data = data;
  d.n = n;
  int r = d.header(true);
  if (r) return r;
  *h = d.height;
  *w = d.width;
  *c = d.ncomp;
  return 0;
}

// decode into out [h, w, c] (c as jpeg_info gives it)
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out) {
  Decoder d;
  d.data = data;
  d.n = n;
  int r = d.header(false);
  if (r) return r;
  return d.output(out);
}

// encode img [h, w, c] (c 1 or 3) as baseline JPEG at quality; the bytes
// stay in a per-thread buffer: *out points at them, *size is their count
int jpeg_encode(const uint8_t* img, int h, int w, int c, int quality,
                const uint8_t** out, int64_t* size) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (c != 1 && c != 3))
    return fail("jpeg_encode takes 1 or 3 channels, sizes 1-65535");
  const int hs = c == 3 ? 2 : 1;  // 4:2:0 for colour
  const int mcu = 8 * hs;
  const int pw = (w + mcu - 1) / mcu * mcu, ph = (h + mcu - 1) / mcu * mcu;
  // jccolor.c rgb_ycc_convert, edges replicated to the MCU grid
  std::vector<uint8_t> planes[3];
  for (int i = 0; i < c; ++i) planes[i].resize(size_t(pw) * ph);
  const int64_t one_half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
  auto fix = [](double x) { return int64_t(x * (1 << 16) + 0.5); };
  const int64_t r_y = fix(0.29900), g_y = fix(0.58700), b_y = fix(0.11400);
  const int64_t r_cb = -fix(0.16874), g_cb = -fix(0.33126), b_cb = fix(0.5);
  const int64_t r_cr = fix(0.5), g_cr = -fix(0.41869), b_cr = -fix(0.08131);
  for (int y = 0; y < ph; ++y) {
    const uint8_t* row = img + size_t(y < h ? y : h - 1) * w * c;
    for (int x = 0; x < pw; ++x) {
      const uint8_t* p = row + size_t(x < w ? x : w - 1) * c;
      size_t k = size_t(y) * pw + x;
      if (c == 1) {
        planes[0][k] = p[0];
        continue;
      }
      int64_t r = p[0], g = p[1], b = p[2];
      planes[0][k] = uint8_t((r_y * r + g_y * g + b_y * b + one_half) >> 16);
      planes[1][k] = uint8_t(
          (r_cb * r + g_cb * g + b_cb * b + cbcr_off + one_half - 1) >> 16);
      planes[2][k] = uint8_t(
          (r_cr * r + g_cr * g + b_cr * b + cbcr_off + one_half - 1) >> 16);
    }
  }
  // jcsample.c h2v2_downsample: 2x2 means, the rounding bias alternating
  const int cw = pw / hs, ch = ph / hs;
  std::vector<uint8_t> chroma[2];
  if (c == 3) {
    for (int i = 0; i < 2; ++i) {
      chroma[i].resize(size_t(cw) * ch);
      const uint8_t* s = planes[i + 1].data();
      for (int y = 0; y < ch; ++y) {
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          const uint8_t* a = s + size_t(2 * y) * pw + 2 * x;
          chroma[i][size_t(y) * cw + x] =
              uint8_t((a[0] + a[1] + a[pw] + a[pw + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }
  uint16_t ql[64], qc[64];
  scaled_table(kStdLuma, quality, ql);
  scaled_table(kStdChroma, quality, qc);
  Code dcl, acl, dcc, acc;
  dcl.build(kDcLumaBits, kDcVals);
  acl.build(kAcLumaBits, kAcLumaVals);
  dcc.build(kDcChromaBits, kDcVals);
  acc.build(kAcChromaBits, kAcChromaVals);

  std::vector<uint8_t>& o = g_encoded;
  o.clear();
  o.reserve(size_t(w) * h * c / 4 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F',
                          0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), head, head + sizeof(head));
  for (int t = 0; t < (c == 3 ? 2 : 1); ++t) {
    const uint16_t* q = t ? qc : ql;
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int k = 0; k < 64; ++k) o.push_back(uint8_t(q[kZigzag[k]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * c);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(uint8_t(c));
  for (int i = 0; i < c; ++i) {
    o.push_back(uint8_t(i + 1));
    o.push_back(i == 0 ? uint8_t((hs << 4) | hs) : 0x11);
    o.push_back(i == 0 ? 0 : 1);
  }
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  if (c == 3) {
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * c);
  o.push_back(uint8_t(c));
  for (int i = 0; i < c; ++i) {
    o.push_back(uint8_t(i + 1));
    o.push_back(i == 0 ? 0x00 : 0x11);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  for (int my = 0; my < ph / mcu; ++my)
    for (int mx = 0; mx < pw / mcu; ++mx) {
      for (int y = 0; y < hs; ++y)
        for (int x = 0; x < hs; ++x)
          encode_block(planes[0].data() + size_t(my * mcu + 8 * y) * pw +
                           mx * mcu + 8 * x,
                       pw, ql, dcl, acl, pred[0], bw);
      for (int i = 0; i < (c == 3 ? 2 : 0); ++i)
        encode_block(chroma[i].data() + size_t(my * 8) * cw + mx * 8, cw, qc,
                     dcc, acc, pred[i + 1], bw);
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  *out = o.data();
  *size = int64_t(o.size());
  return 0;
}

// PNG: undo the row filters of raw (h rows of a filter byte and stride
// bytes) into out (h x stride); bpp is the bytes per pixel (at least 1)
int png_unfilter(const uint8_t* raw, int h, int64_t stride, int bpp,
                 uint8_t* out) {
  std::vector<uint8_t> zero(size_t(stride), 0);
  const uint8_t* prior = zero.data();
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = raw + size_t(y) * (stride + 1);
    int kind = s[0];
    ++s;
    uint8_t* o = out + size_t(y) * stride;
    switch (kind) {
      case 0:
        std::memcpy(o, s, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          o[i] = uint8_t(s[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) o[i] = uint8_t(s[i] + prior[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i)
          o[i] = uint8_t(s[i] + (((i >= bpp ? o[i - bpp] : 0) + prior[i]) >> 1));
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prior[i];
          int cc = i >= bpp ? prior[i - bpp] : 0;
          int p = a + b - cc;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
              pc = p > cc ? p - cc : cc - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
          o[i] = uint8_t(s[i] + pred);
        }
        break;
      default:
        return fail("unknown PNG row filter");
    }
    prior = o;
  }
  return 0;
}

}  // extern "C"
