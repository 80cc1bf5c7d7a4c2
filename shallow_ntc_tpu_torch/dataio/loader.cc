// Native image loader of the port: JPEG and PNG decode + crop on std::threads.
//
// The counterpart of shallow_ntc_tpu/dataio/loader.cc with the same three C
// entry points and their semantics (decode_image, image_dims,
// decode_crop_batch). The GPU machine has zlib's headers but neither
// libjpeg's nor libpng's, so this file carries its own decoders:
//
//  - JPEG: baseline, extended and progressive Huffman (SOF0/1/2), 8-bit,
//    one or three components at any integral sampling, restart intervals.
//    It computes what libjpeg(-turbo) does with its defaults and
//    out_color_space = JCS_RGB: the JDCT_ISLOW integer IDCT (jidctint.c),
//    "fancy" triangle upsampling for h2v1, h1v2 and h2v2 (jdsample.c), box
//    replication otherwise, and jdcolor.c's YCbCr -> RGB tables. Four
//    components (CMYK / YCCK), arithmetic coding, lossless and 12-bit files
//    fail, as libjpeg fails to make RGB of them.
//  - PNG on zlib, normalised to 8-bit RGB as the JAX loader's libpng
//    transforms do: 16-bit samples keep their high byte (png_set_strip_16),
//    palettes are looked up, 1/2/4-bit grey scaled to 8 bits, grey
//    replicated, alpha and tRNS dropped; Adam7 interlacing undone.
//
// Entropy data that ends early (a marker, or the end of the file, which
// counts as EOI) follows libjpeg's out-of-data rules (BitReader). Not
// ported: the block smoothing libjpeg applies to a progressive file whose
// scans stop early.
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cc -o libloader.so -lz

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// Status codes of the entry points (0 is success).
constexpr int kErrOpen = -1;         // the file cannot be read
constexpr int kErrSmall = -2;        // the caller's buffer is too small
constexpr int kErrFormat = -3;       // neither a JPEG nor a PNG
constexpr int kErrUnsupported = -4;  // a JPEG libjpeg cannot turn into RGB
constexpr int kErrCorrupt = -5;      // malformed or truncated

struct Image {
  std::vector<uint8_t> data;  // HWC, RGB
  int h = 0, w = 0;
  int status = kErrCorrupt;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long size = ok ? ftell(f) : -1;
  ok = ok && size >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out->resize(size_t(size));
    ok = fread(out->data(), 1, out->size(), f) == out->size();
  }
  fclose(f);
  return ok;
}

// --- JPEG ------------------------------------------------------------------
// Zigzag position -> natural (row-major) position, padded with 63s so that a
// run past the block's end (corrupt data) lands on the last coefficient, as
// libjpeg's jpeg_natural_order does.
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint16_t look[1 << kLookBits];  // (code length << 8) | symbol, 0 if longer
  int32_t maxcode[18];            // largest code of each length, -1 if none
  int32_t valoffset[18];          // symbol index of a code = code + valoffset
  uint8_t vals[256];
};

bool build_huffman(const uint8_t counts[16], const uint8_t* vals, int nvals, Huffman* t) {
  std::memcpy(t->vals, vals, size_t(nvals));
  std::memset(t->look, 0, sizeof(t->look));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t->valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= kLookBits) {
        int first = code << (kLookBits - len), n = 1 << (kLookBits - len);
        for (int j = 0; j < n; ++j) t->look[first + j] = uint16_t((len << 8) | vals[k]);
      }
    }
    t->maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) return false;  // more codes than the length holds
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  t->defined = true;
  return true;
}

// The entropy-coded bytes of a scan: 0xFF00 is a data byte 0xFF; any other
// 0xFF xx is a marker (or the data ends), where reading stops and zero bits
// follow. As in libjpeg's jdhuff.c, a request for more bits than the data
// holds sets `insufficient`: the decoder finishes that MCU on zero bits and
// leaves the following ones zero until a restart marker is found.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;    // bits in buf
  int pad = 0;  // of which the last `pad` are zeros past the data
  bool at_marker = false;
  bool insufficient = false;

  void fill() {
    while (n <= 56) {
      uint64_t b = 0;
      bool data = false;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            b = 0xFF;
            p += 2;
            data = true;
          } else {
            at_marker = true;
          }
        } else {
          b = *p++;
          data = true;
        }
      }
      if (!data) pad += 8;
      buf |= b << (56 - n);
      n += 8;
    }
  }
  void consume(int k) {
    buf <<= k;
    n -= k;
    if (n < pad) {
      insufficient = true;
      pad = n;
    }
  }
  int bits(int k) {  // k <= 16
    if (k == 0) return 0;
    if (n < k) fill();
    int v = int(buf >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    int e = t.look[buf >> (64 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int len = kLookBits + 1;
    int32_t code = int32_t(buf >> (64 - len));
    while (len <= 16 && code > t.maxcode[len]) {
      ++len;
      code = int32_t(buf >> (64 - len));
    }
    if (len > 16) {  // a bad code: libjpeg warns and takes symbol 0
      consume(16);
      return 0;
    }
    consume(len);
    return t.vals[(code + t.valoffset[len]) & 0xFF];
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
  int receive_extend(int s) { return s ? extend(bits(s), s) : 0; }
  // A restart: drop the buffered bits and step over the RSTn marker, which
  // also clears `insufficient`; at another marker stay there (jdmarker.c's
  // resync: the segment reads as empty).
  void restart() {
    buf = 0;
    n = pad = 0;
    at_marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        insufficient = false;
        return;
      }
      if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) return;  // another marker
      ++p;
    }
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;    // downsampled width and height (real samples)
  int bw = 0, bh = 0;    // blocks wide and high that hold real samples
  int abw = 0, abh = 0;  // blocks allocated: whole MCUs
  int pred = 0;
  std::vector<int16_t> coef;  // abh x abw blocks of 64, natural order
};

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t size) : d_(data), end_(data + size) {}

  // Header only: the frame's height and width.
  int dims(int* h, int* w) {
    const uint8_t* p = d_ + 2;
    while (true) {
      int m = next_marker(&p);
      if (m < 0) return kErrCorrupt;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9 || p + 2 > end_) return kErrCorrupt;
      int len = (p[0] << 8) | p[1];
      if (len < 2 || p + len > end_) return kErrCorrupt;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (len < 7) return kErrCorrupt;
        *h = (p[3] << 8) | p[4];
        *w = (p[5] << 8) | p[6];
        return (*h > 0 && *w > 0) ? 0 : kErrCorrupt;
      }
      p += len;
    }
  }

  int decode(Image* img) {
    const uint8_t* p = d_ + 2;
    bool frame = false;
    while (true) {
      int m = next_marker(&p);
      if (m < 0 && frame && scans_) break;  // the file ends: libjpeg inserts an EOI
      if (m < 0) return kErrCorrupt;
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no length
      if (p + 2 > end_) return kErrCorrupt;
      int len = (p[0] << 8) | p[1];
      if (len < 2 || p + len > end_) return kErrCorrupt;
      const uint8_t* seg = p + 2;
      int seglen = len - 2;
      p += len;
      int rc = 0;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (frame) return kErrCorrupt;
        frame = true;
        progressive_ = m == 0xC2;
        rc = read_frame(seg, seglen);
      } else if (m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        return kErrUnsupported;  // lossless, hierarchical or arithmetic-coded
      } else if (m == 0xC4) {
        rc = read_dht(seg, seglen);
      } else if (m == 0xDB) {
        rc = read_dqt(seg, seglen);
      } else if (m == 0xDD) {
        if (seglen < 2) return kErrCorrupt;
        restart_interval_ = (seg[0] << 8) | seg[1];
      } else if (m == 0xDA) {
        if (!frame) return kErrCorrupt;
        rc = read_scan(seg, seglen, &p);
      } else if (m == 0xE0) {
        if (seglen >= 14 && std::memcmp(seg, "JFIF\0", 5) == 0) saw_jfif_ = true;
      } else if (m == 0xEE) {
        if (seglen >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
          saw_adobe_ = true;
          adobe_transform_ = seg[11];
        }
      }
      if (rc) return rc;
    }
    if (!frame || !scans_) return kErrCorrupt;
    return output(img);
  }

 private:
  // The next marker code after *p (fill bytes skipped), *p left after it.
  int next_marker(const uint8_t** p) {
    const uint8_t* q = *p;
    while (q < end_ && *q != 0xFF) ++q;
    while (q < end_ && *q == 0xFF) ++q;
    if (q >= end_) return -1;
    *p = q + 1;
    return *q;
  }

  int read_frame(const uint8_t* s, int len) {
    if (len < 6) return kErrCorrupt;
    if (s[0] != 8) return kErrUnsupported;  // 12- or 16-bit samples
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height_ <= 0 || width_ <= 0 || len < 6 + 3 * nc || nc < 1) return kErrCorrupt;
    if (nc != 1 && nc != 3) return kErrUnsupported;  // CMYK / YCCK: no RGB
    comps_.resize(nc);
    for (int i = 0; i < nc; ++i) {
      const uint8_t* c = s + 6 + 3 * i;
      comps_[i].id = c[0];
      comps_[i].h = c[1] >> 4;
      comps_[i].v = c[1] & 15;
      comps_[i].tq = c[2];
      if (comps_[i].h < 1 || comps_[i].h > 4 || comps_[i].v < 1 || comps_[i].v > 4 ||
          comps_[i].tq > 3)
        return kErrCorrupt;
      hmax_ = std::max(hmax_, comps_[i].h);
      vmax_ = std::max(vmax_, comps_[i].v);
    }
    mcus_x_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v) return kErrUnsupported;  // fractional sampling
      c.dw = int((int64_t(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = int((int64_t(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.abw = mcus_x_ * c.h;
      c.abh = mcus_y_ * c.v;
      c.coef.assign(size_t(c.abw) * c.abh * 64, 0);
    }
    return 0;
  }

  int read_dht(const uint8_t* s, int len) {
    while (len > 0) {
      if (len < 17) return kErrCorrupt;
      int tc = s[0] >> 4, th = s[0] & 15;
      if (tc > 1 || th > 3) return kErrCorrupt;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[1 + i];
      if (total > 256 || len < 17 + total) return kErrCorrupt;
      if (!build_huffman(s + 1, s + 17, total, tc ? &ac_[th] : &dc_[th])) return kErrCorrupt;
      s += 17 + total;
      len -= 17 + total;
    }
    return 0;
  }

  int read_dqt(const uint8_t* s, int len) {
    while (len > 0) {
      int pq = s[0] >> 4, tq = s[0] & 15;
      int n = pq ? 129 : 65;
      if (tq > 3 || pq > 1 || len < n) return kErrCorrupt;
      for (int i = 0; i < 64; ++i)
        qt_[tq][kNatural[i]] = uint16_t(pq ? (s[1 + 2 * i] << 8) | s[2 + 2 * i] : s[1 + i]);
      qt_defined_[tq] = true;
      s += n;
      len -= n;
    }
    return 0;
  }

  int read_scan(const uint8_t* s, int len, const uint8_t** p) {
    if (len < 1) return kErrCorrupt;
    int ns = s[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return kErrCorrupt;
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == s[1 + 2 * i]) c = &k;
      if (!c) return kErrCorrupt;
      c->td = s[2 + 2 * i] >> 4;
      c->ta = s[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3) return kErrCorrupt;
      sc.push_back(c);
    }
    const uint8_t* t = s + 1 + 2 * ns;
    int ss = t[0], se = t[1], ah = t[2] >> 4, al = t[2] & 15;
    if (progressive_) {
      if (ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) || (ss > 0 && ns != 1))
        return kErrCorrupt;
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    // The tables this scan reads must be defined.
    for (Component* c : sc) {
      if (ss == 0 && ah == 0 && !dc_[c->td].defined) return kErrCorrupt;
      if (se > 0 && !ac_[c->ta].defined) return kErrCorrupt;
      c->pred = 0;
    }
    BitReader br{*p, end_};
    eobrun_ = 0;
    const int mcus_x = ns == 1 ? sc[0]->bw : mcus_x_;
    const int mcus_y = ns == 1 ? sc[0]->bh : mcus_y_;
    int to_restart = restart_interval_;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval_) {
          if (to_restart == 0) {
            br.restart();
            for (Component* c : sc) c->pred = 0;
            eobrun_ = 0;
            to_restart = restart_interval_;
          }
          --to_restart;
        }
        if (br.insufficient) continue;  // out of data: the MCU stays zero
        for (Component* c : sc) {
          int nv = ns == 1 ? 1 : c->v, nh = ns == 1 ? 1 : c->h;
          for (int v = 0; v < nv; ++v) {
            for (int h = 0; h < nh; ++h) {
              int by = ns == 1 ? my : my * c->v + v, bx = ns == 1 ? mx : mx * c->h + h;
              int16_t* blk = c->coef.data() + (size_t(by) * c->abw + bx) * 64;
              if (!progressive_) {
                decode_sequential(&br, c, blk);
              } else if (ss == 0) {
                decode_dc(&br, c, blk, ah, al);
              } else if (ah == 0) {
                decode_ac_first(&br, c, blk, ss, se, al);
              } else {
                decode_ac_refine(&br, c, blk, ss, se, al);
              }
            }
          }
        }
      }
    }
    // Continue after the scan's data, at its terminating marker.
    const uint8_t* q = br.p;
    while (q + 1 < end_ && !(q[0] == 0xFF && q[1] != 0x00 && !(q[1] >= 0xD0 && q[1] <= 0xD7)))
      ++q;
    *p = q;
    ++scans_;
    return 0;
  }

  void decode_sequential(BitReader* br, Component* c, int16_t* blk) {
    int s = br->decode(dc_[c->td]);
    c->pred += br->receive_extend(s);
    blk[0] = int16_t(c->pred);
    const Huffman& ac = ac_[c->ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br->decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(br->receive_extend(s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc(BitReader* br, Component* c, int16_t* blk, int ah, int al) {
    if (ah == 0) {
      int s = br->decode(dc_[c->td]);
      c->pred += br->receive_extend(s);
      blk[0] = int16_t(uint32_t(c->pred) << al);
    } else if (br->bits(1)) {
      blk[0] = int16_t(blk[0] | (1 << al));
    }
  }

  void decode_ac_first(BitReader* br, Component* c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huffman& ac = ac_[c->ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br->decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(uint32_t(br->receive_extend(s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br->bits(r);
        --eobrun_;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine.
  void decode_ac_refine(BitReader* br, Component* c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Huffman& ac = ac_[c->ta];
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; ++k) {
        int rs = br->decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br->bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br->bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br->bits(1) && (*coef & p1) == 0)
              *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br->bits(1) && (*coef & p1) == 0)
          *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun_;
    }
  }

  // jidctint.c jpeg_idct_islow: one dequantized 8x8 block into `out`
  // (row stride `stride`), range-limited as libjpeg's post-IDCT table does.
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int kConst = 13, kPass1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
    // Post-IDCT range limit: the low 10 bits as a signed value, + 128, clamped.
    auto limit = [](int64_t x) {
      int v = int(x & 1023);
      if (v >= 512) v -= 1024;
      v += 128;
      return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* i = in + c;
      const uint16_t* qq = q + c;
      if (!i[8] && !i[16] && !i[24] && !i[32] && !i[40] && !i[48] && !i[56]) {
        int dc = (i[0] * qq[0]) * (1 << kPass1);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
        continue;
      }
      int64_t z2 = i[16] * qq[16], z3 = i[48] * qq[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      z2 = i[0] * qq[0];
      z3 = i[32] * qq[32];
      int64_t tmp0 = (z2 + z3) * (1 << kConst), tmp1 = (z2 - z3) * (1 << kConst);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = i[56] * qq[56];
      tmp1 = i[40] * qq[40];
      tmp2 = i[24] * qq[24];
      tmp3 = i[8] * qq[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int n = kConst - kPass1;
      ws[0 * 8 + c] = int(descale(tmp10 + tmp3, n));
      ws[7 * 8 + c] = int(descale(tmp10 - tmp3, n));
      ws[1 * 8 + c] = int(descale(tmp11 + tmp2, n));
      ws[6 * 8 + c] = int(descale(tmp11 - tmp2, n));
      ws[2 * 8 + c] = int(descale(tmp12 + tmp1, n));
      ws[5 * 8 + c] = int(descale(tmp12 - tmp1, n));
      ws[3 * 8 + c] = int(descale(tmp13 + tmp0, n));
      ws[4 * 8 + c] = int(descale(tmp13 - tmp0, n));
    }
    const int n = kConst + kPass1 + 3;
    for (int r = 0; r < 8; ++r) {
      const int* w = ws + r * 8;
      uint8_t* o = out + size_t(r) * stride;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        uint8_t dc = limit(descale(w[0], kPass1 + 3));
        for (int x = 0; x < 8; ++x) o[x] = dc;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConst);
      int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConst);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = limit(descale(tmp10 + tmp3, n));
      o[7] = limit(descale(tmp10 - tmp3, n));
      o[1] = limit(descale(tmp11 + tmp2, n));
      o[6] = limit(descale(tmp11 - tmp2, n));
      o[2] = limit(descale(tmp12 + tmp1, n));
      o[5] = limit(descale(tmp12 - tmp1, n));
      o[3] = limit(descale(tmp13 + tmp0, n));
      o[4] = limit(descale(tmp13 - tmp0, n));
    }
  }

  // One component's samples at full resolution: IDCT, then jdsample.c's
  // upsampling. Sets *stride; rows and columns past the image are padding.
  bool component_plane(const Component& c, std::vector<uint8_t>* out, int* stride) {
    if (!qt_defined_[c.tq]) return false;
    const int pw = c.bw * 8;
    std::vector<uint8_t> plane(size_t(pw) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + (size_t(by) * c.abw + bx) * 64, qt_[c.tq],
                   plane.data() + size_t(by) * 8 * pw + bx * 8, pw);
    const int hr = hmax_ / c.h, vr = vmax_ / c.v;
    if (hr == 1 && vr == 1) {
      *stride = pw;
      out->swap(plane);
      return true;
    }
    *stride = width_;
    out->resize(size_t(width_) * height_);
    auto row_at = [&](int y) {  // context rows clamp to the real ones
      return plane.data() + size_t(y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y) * pw;
    };
    std::vector<uint8_t> row(size_t(c.dw) * hr + 2);
    const int last = c.dw - 1;
    for (int oy = 0; oy < height_; ++oy) {
      const uint8_t* in = row_at(oy / vr);
      uint8_t* o = out->data() + size_t(oy) * width_;
      if (hr == 2 && vr == 1 && c.dw > 2) {  // h2v1_fancy_upsample
        row[0] = in[0];
        row[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < last; ++x) {
          int v = in[x] * 3;
          row[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
          row[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
        }
        row[2 * last] = uint8_t((in[last] * 3 + in[last - 1] + 1) >> 2);
        row[2 * last + 1] = in[last];
        std::memcpy(o, row.data(), size_t(width_));
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        const uint8_t* other = row_at((oy % 2) ? oy / 2 + 1 : oy / 2 - 1);
        const int bias = (oy % 2) ? 2 : 1;
        for (int x = 0; x < width_; ++x) o[x] = uint8_t((in[x] * 3 + other[x] + bias) >> 2);
      } else if (hr == 2 && vr == 2 && c.dw > 2) {  // h2v2_fancy_upsample
        const uint8_t* other = row_at((oy % 2) ? oy / 2 + 1 : oy / 2 - 1);
        int this_sum = in[0] * 3 + other[0], next_sum = in[1] * 3 + other[1];
        row[0] = uint8_t((this_sum * 4 + 8) >> 4);
        row[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < last; ++x) {
          next_sum = in[x + 1] * 3 + other[x + 1];
          row[2 * x] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
          row[2 * x + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        row[2 * last] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        row[2 * last + 1] = uint8_t((this_sum * 4 + 7) >> 4);
        std::memcpy(o, row.data(), size_t(width_));
      } else {  // box replication (h2v1, h2v2 at width <= 2, int_upsample)
        for (int x = 0; x < width_; ++x) o[x] = in[x / hr];
      }
    }
    return true;
  }

  int output(Image* img) {
    const int nc = int(comps_.size());
    std::vector<uint8_t> planes[3];
    int strides[3];
    for (int i = 0; i < nc; ++i)
      if (!component_plane(comps_[i], &planes[i], &strides[i])) return kErrCorrupt;
    img->h = height_;
    img->w = width_;
    img->data.resize(size_t(width_) * height_ * 3);
    uint8_t* o = img->data.data();
    // Each output row's samples of component k.
    auto row = [&](int k, int y) { return planes[k].data() + size_t(y) * strides[k]; };
    if (nc == 1) {
      for (int y = 0; y < height_; ++y, o += size_t(width_) * 3) {
        const uint8_t* g = row(0, y);
        for (int x = 0; x < width_; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return 0;
    }
    bool rgb;  // jdapimin.c default_decompress_parms
    if (saw_jfif_) {
      rgb = false;
    } else if (saw_adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }
    if (rgb) {
      for (int y = 0; y < height_; ++y, o += size_t(width_) * 3)
        for (int k = 0; k < 3; ++k) {
          const uint8_t* p = row(k, y);
          for (int x = 0; x < width_; ++x) o[3 * x + k] = p[x];
        }
      return 0;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert, SCALEBITS 16.
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int r = 0; r < height_; ++r, o += size_t(width_) * 3) {
      const uint8_t *py = row(0, r), *pcb = row(1, r), *pcr = row(2, r);
      for (int x = 0; x < width_; ++x) {
        int y = py[x], cb = pcb[x], cr = pcr[x];
        o[3 * x] = clamp(y + cr_r[cr]);
        o[3 * x + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(y + cb_b[cb]);
      }
    }
    return 0;
  }

  const uint8_t* d_;
  const uint8_t* end_;
  bool progressive_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int restart_interval_ = 0, eobrun_ = 0, scans_ = 0;
  std::vector<Component> comps_;
  Huffman dc_[4], ac_[4];
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
};

// --- PNG -------------------------------------------------------------------
const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

int png_dims(const uint8_t* d, size_t size, int* h, int* w) {
  if (size < 33 || std::memcmp(d + 12, "IHDR", 4) != 0) return kErrCorrupt;
  *w = int(be32(d + 16));
  *h = int(be32(d + 20));
  return (*h > 0 && *w > 0) ? 0 : kErrCorrupt;
}

// Undo the five PNG filters on `rows` scanlines of `rowbytes` bytes, each
// after its filter byte; bpp is the filter's byte distance.
bool png_unfilter(uint8_t* data, int rows, size_t rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < rows; ++y) {
    uint8_t* line = data + size_t(y) * (rowbytes + 1);
    int ftype = line[0];
    uint8_t* x = line + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      int a = i >= size_t(bpp) ? x[i - bpp] : 0;
      int b = prev ? prev[i] : 0;
      int c = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return false;
      }
      x[i] = uint8_t(x[i] + pred);
    }
    prev = x;
  }
  return true;
}

int decode_png(const uint8_t* d, size_t size, Image* img) {
  int w, h;
  if (png_dims(d, size, &h, &w)) return kErrCorrupt;
  const int depth = d[24], ctype = d[25], interlace = d[28];
  const int channels = png_channels(ctype);
  bool depth_ok = (ctype == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                                  depth == 16)) ||
                  (ctype == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
                  ((ctype == 2 || ctype == 4 || ctype == 6) && (depth == 8 || depth == 16));
  if (!channels || !depth_ok || d[26] != 0 || d[27] != 0 || interlace > 1) return kErrCorrupt;
  // Chunks: CRCs of critical chunks checked (libpng errors on them),
  // ancillary chunks skipped.
  std::vector<uint8_t> idat;
  uint8_t palette[256 * 3] = {};  // entries past the PLTE's stay black, as libpng's
  bool have_plte = false, have_iend = false;
  size_t pos = 8;
  while (pos + 12 <= size) {
    uint32_t len = be32(d + pos);
    if (len > size - pos - 12) return kErrCorrupt;
    const uint8_t* type = d + pos + 4;
    const uint8_t* payload = d + pos + 8;
    bool critical = !(type[0] & 0x20);
    if (critical && uint32_t(crc32(crc32(0, type, 4), payload, len)) != be32(payload + len))
      return kErrCorrupt;
    if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) return kErrCorrupt;
      std::memcpy(palette, payload, len);
      have_plte = true;
    } else if (!std::memcmp(type, "IEND", 4)) {
      have_iend = true;
      break;
    }
    pos += 12 + len;
  }
  if (ctype == 3 && !have_plte) return kErrCorrupt;
  if (idat.empty() || !have_iend) return kErrCorrupt;
  // Adam7 passes (x0, y0, dx, dy), or one pass over the whole image.
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kAdam7 : kWhole;
  const int npass = interlace ? 7 : 1;
  const int bits_pp = channels * depth, bpp = std::max(1, bits_pp / 8);
  size_t total = 0;
  for (int i = 0; i < npass; ++i) {
    size_t pw = (size_t(w) - passes[i][0] + passes[i][2] - 1) / passes[i][2];
    size_t ph = (size_t(h) - passes[i][1] + passes[i][3] - 1) / passes[i][3];
    if (w > passes[i][0] && h > passes[i][1]) total += ph * ((pw * bits_pp + 7) / 8 + 1);
  }
  std::vector<uint8_t> raw(total);
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return kErrCorrupt;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zrc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zs.avail_out != 0 || (zrc != Z_STREAM_END && zrc != Z_BUF_ERROR && zrc != Z_OK))
    return kErrCorrupt;  // libpng: "Not enough image data"
  img->h = h;
  img->w = w;
  img->data.assign(size_t(h) * w * 3, 0);
  uint8_t* data = raw.data();
  const int maxval = (1 << depth) - 1;
  for (int i = 0; i < npass; ++i) {
    const int x0 = passes[i][0], y0 = passes[i][1], dx = passes[i][2], dy = passes[i][3];
    if (w <= x0 || h <= y0) continue;
    const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    const size_t rowbytes = (size_t(pw) * bits_pp + 7) / 8;
    if (!png_unfilter(data, ph, rowbytes, bpp)) return kErrCorrupt;
    for (int py = 0; py < ph; ++py) {
      const uint8_t* line = data + size_t(py) * (rowbytes + 1) + 1;
      uint8_t* out = img->data.data() + (size_t(y0 + py * dy) * w + x0) * 3;
      for (int px = 0; px < pw; ++px, out += size_t(dx) * 3) {
        // Each sample's 8-bit value: the high byte of 16, the scaled grey
        // or the palette index of 1/2/4.
        auto sample = [&](int k) -> int {
          size_t s = size_t(px) * channels + k;
          if (depth == 16) return line[2 * s];
          if (depth == 8) return line[s];
          int v = (line[s * depth / 8] >> (8 - depth - int(s * depth % 8))) & maxval;
          return ctype == 3 ? v : v * 255 / maxval;
        };
        if (ctype == 3) {
          std::memcpy(out, palette + 3 * sample(0), 3);
        } else if (ctype == 0 || ctype == 4) {
          out[0] = out[1] = out[2] = uint8_t(sample(0));
        } else {
          for (int k = 0; k < 3; ++k) out[k] = uint8_t(sample(k));
        }
      }
    }
    data += size_t(ph) * (rowbytes + 1);
  }
  return 0;
}

// --- dispatch --------------------------------------------------------------
bool is_jpeg(const std::vector<uint8_t>& d) {
  return d.size() >= 2 && d[0] == 0xFF && d[1] == 0xD8;
}
bool is_png(const std::vector<uint8_t>& d) {
  return d.size() >= 8 && !std::memcmp(d.data(), kPngSignature, 8);
}

Image decode_file(const char* path) {
  Image img;
  std::vector<uint8_t> d;
  if (!read_file(path, &d)) {
    img.status = kErrOpen;
    return img;
  }
  try {
    if (is_jpeg(d)) {
      img.status = JpegDecoder(d.data(), d.size()).decode(&img);
    } else if (is_png(d)) {
      img.status = decode_png(d.data(), d.size(), &img);
    } else {
      img.status = kErrFormat;
    }
  } catch (const std::bad_alloc&) {
    img.status = kErrCorrupt;
  }
  return img;
}

}  // namespace

extern "C" {

// Decode one image into `out` (max_bytes long) as uint8 HWC RGB; returns 0
// and fills h, w, or one of the negative status codes above.
int decode_image(const char* path, uint8_t* out, int64_t max_bytes, int* h, int* w) {
  Image img = decode_file(path);
  if (img.status) return img.status;
  const int64_t nbytes = int64_t(img.h) * img.w * 3;
  if (nbytes > max_bytes) return kErrSmall;
  std::memcpy(out, img.data.data(), size_t(nbytes));
  *h = img.h;
  *w = img.w;
  return 0;
}

// An image's height and width from its header, without decoding pixels:
// the file is read segment by segment up to the JPEG frame header or PNG IHDR.
int image_dims(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  std::vector<uint8_t> d(33);
  d.resize(fread(d.data(), 1, d.size(), f));
  int rc = kErrFormat;
  if (is_png(d)) {
    rc = png_dims(d.data(), d.size(), h, w);
  } else if (is_jpeg(d)) {
    d.resize(2);
    fseek(f, 2, SEEK_SET);
    rc = kErrCorrupt;
    uint8_t m[4];
    while (fread(m, 1, 2, f) == 2) {
      while (m[0] == 0xFF && m[1] == 0xFF) {
        if (fread(m + 1, 1, 1, f) != 1) break;
      }
      if (m[0] != 0xFF) break;
      if (m[1] == 0x01 || (m[1] >= 0xD0 && m[1] <= 0xD8)) continue;
      if (fread(m + 2, 1, 2, f) != 2) break;
      int len = (m[2] << 8) | m[3];
      if (len < 2) break;
      size_t at = d.size();
      d.insert(d.end(), m, m + 4);
      bool sof = m[1] >= 0xC0 && m[1] <= 0xCF && m[1] != 0xC4 && m[1] != 0xC8 && m[1] != 0xCC;
      if (sof) {
        d.resize(at + 2 + size_t(len));
        if (fread(d.data() + at + 4, 1, size_t(len) - 2, f) != size_t(len) - 2) break;
        rc = JpegDecoder(d.data(), d.size()).dims(h, w);
        break;
      }
      if (fseek(f, len - 2, SEEK_CUR) != 0) break;
      d.resize(at);
    }
  }
  fclose(f);
  return rc;
}

// Decode n images and write (random or center) patch crops into
// out [n, patch, patch, 3] uint8, using `threads` worker threads.
// seeds[i] selects the crop (seed < 0 => center crop; otherwise
// std::mt19937_64{seed} draws y0, then x0).
// Returns the number of failures (0 == all good); failed slots are zeroed.
int decode_crop_batch(const char** paths, int n, int patch, const int64_t* seeds, uint8_t* out,
                      int threads) {
  std::vector<int> failures(n, 0);
  const size_t patch_bytes = size_t(patch) * patch * 3;
  auto worker = [&](int start, int step) {
    for (int i = start; i < n; i += step) {
      Image img = decode_file(paths[i]);
      uint8_t* dst = out + size_t(i) * patch_bytes;
      if (img.status || img.h < patch || img.w < patch) {
        std::memset(dst, 0, patch_bytes);
        failures[i] = 1;
        continue;
      }
      int y0, x0;
      if (seeds[i] < 0) {
        y0 = (img.h - patch) / 2;
        x0 = (img.w - patch) / 2;
      } else {
        std::mt19937_64 rng{static_cast<uint64_t>(seeds[i])};
        y0 = int(rng() % uint64_t(img.h - patch + 1));
        x0 = int(rng() % uint64_t(img.w - patch + 1));
      }
      for (int y = 0; y < patch; ++y) {
        std::memcpy(dst + size_t(y) * patch * 3,
                    img.data.data() + (size_t(y0 + y) * img.w + x0) * 3, size_t(patch) * 3);
      }
    }
  };
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker, t, threads);
  worker(0, threads);
  for (auto& th : pool) th.join();
  int nfail = 0;
  for (int v : failures) nfail += v;
  return nfail;
}

}  // extern "C"
