// Native host entropy stage (SURVEY.md §2.1 components 1, 4, 7-10 native
// rule; §7.1 M2): byte/bit reader with 0xFF00 destuffing, canonical
// Huffman table build (T.81 Annex C), baseline sequential decode
// (T.81 §F.2.2), progressive decode (T.81 §G.2), restart-segment
// parallelism over std::thread (T.81 §E.2.4 makes segments independent).
//
// C ABI, consumed from Python via ctypes (tpujpeg/native/entropy.py).
// Coefficients are emitted in zigzag order into int32[padded_blocks][64]
// per frame component — the exact layout the device transform stage
// consumes (tpujpeg/transform.py dequantize()).
//
// The reference project's equivalent is its C++ host decoder core; the
// reference checkout is an empty mount (SURVEY.md §0), so citations are
// to the standard and survey, not reference file:line.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Error plumbing
// ---------------------------------------------------------------------------

enum ErrCode : int {
  OK = 0,
  ERR_HUFFMAN = 1,    // -> JpegHuffmanError
  ERR_TRUNCATED = 2,  // -> JpegTruncatedError
  ERR_SYNTAX = 3,     // -> JpegSyntaxError
};

struct ErrState {
  std::atomic<int> code{OK};
  char msg[256] = {0};

  void set(int c, const char* m) {
    int expected = OK;
    if (code.compare_exchange_strong(expected, c)) {
      std::snprintf(msg, sizeof(msg), "%s", m);
    }
  }
};

// ---------------------------------------------------------------------------
// Huffman tables (T.81 Annex C + §F.2.2.3 DECODE)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 8;

struct HuffTbl {
  bool present = false;
  uint8_t look_sym[1 << kLookBits];
  uint8_t look_len[1 << kLookBits];  // 0 => code longer than kLookBits
  int32_t maxcode[17];               // max code value of each length, -1 if none
  int32_t valoffset[17];             // huffval index = valoffset[l] + code
  uint8_t huffval[256];

  // counts: uint8[16] (codes of length 1..16); values: uint8[sum(counts)].
  bool build(const uint8_t* counts, const uint8_t* values) {
    std::memset(look_len, 0, sizeof(look_len));
    int total = 0;
    for (int i = 0; i < 16; i++) total += counts[i];
    if (total > 256) return false;
    std::memcpy(huffval, values, total);

    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
      int n = counts[l - 1];
      if (code + n > (1 << l)) return false;  // overfull table
      if (n) {
        valoffset[l] = k - code;
        if (l <= kLookBits) {
          // Expand every code of this length into the lookahead LUT.
          for (int i = 0; i < n; i++) {
            int32_t c = code + i;
            int lo = c << (kLookBits - l);
            int hi = lo + (1 << (kLookBits - l));
            for (int j = lo; j < hi; j++) {
              look_sym[j] = values[k + i];
              look_len[j] = static_cast<uint8_t>(l);
            }
          }
        }
        code += n;
        k += n;
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    present = true;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Bit reader over a destuffed entropy segment (T.81 §F.2.2.5 semantics;
// reads past end fabricate 1-bits like libjpeg, tracked for overrun)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  int64_t fed_pad_bits = 0;

  explicit BitReader(const uint8_t* d, size_t len) : data(d), n(len) {}

  inline void fill(int need) {
    while (cnt < need) {
      if (cnt < 56 && pos + 8 <= n) {
        // Bulk refill: big-endian load of 8 bytes, take at most 7 so the
        // shift below stays < 64 (a full-width shift is UB).
        uint64_t w;
        std::memcpy(&w, data + pos, 8);
        w = __builtin_bswap64(w);
        int take_bytes = (63 - cnt) >> 3;
        buf = (buf << (take_bytes * 8)) | (w >> (64 - take_bytes * 8));
        cnt += take_bytes * 8;
        pos += take_bytes;
        continue;
      }
      uint64_t b;
      if (pos < n) {
        b = data[pos++];
      } else {
        b = 0xFF;
        fed_pad_bits += 8;
      }
      buf = (buf << 8) | b;
      cnt += 8;
    }
  }

  inline uint32_t peek16() {
    fill(16);
    return static_cast<uint32_t>(buf >> (cnt - 16)) & 0xFFFF;
  }

  inline void skip(int nbits) { cnt -= nbits; }  // caller filled already

  inline int32_t receive(int nbits) {
    if (nbits == 0) return 0;
    fill(nbits);
    cnt -= nbits;
    return static_cast<int32_t>(buf >> cnt) & ((1 << nbits) - 1);
  }

  inline int receive_bit() {
    fill(1);
    cnt -= 1;
    return static_cast<int>(buf >> cnt) & 1;
  }

  // True iff bits beyond the real data were consumed.
  inline bool overrun() const {
    int64_t fed = static_cast<int64_t>(pos) * 8 + fed_pad_bits;
    return fed - cnt > static_cast<int64_t>(n) * 8;
  }
};

// T.81 §F.2.2.1 EXTEND.
static inline int32_t extend(int32_t v, int t) {
  return (t && v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

// T.81 §F.2.2.3 DECODE with 8-bit lookahead (structure per the survey's
// component #4 "LUT-based fast path"; same shape as any fast JPEG
// decoder's because the standard fixes the algorithm).
static inline int huff_decode(BitReader& br, const HuffTbl& t, ErrState& err) {
  uint32_t p16 = br.peek16();
  uint32_t idx = p16 >> (16 - kLookBits);
  int len = t.look_len[idx];
  if (len) {
    br.skip(len);
    return t.look_sym[idx];
  }
  int l = kLookBits + 1;
  int32_t code = static_cast<int32_t>(p16 >> (16 - l));
  while (code > t.maxcode[l]) {
    if (++l > 16) {  // check BEFORE shifting: 16-l would go negative
      err.set(ERR_HUFFMAN, "invalid Huffman code");
      return -1;
    }
    code = static_cast<int32_t>(p16 >> (16 - l));
  }
  br.skip(l);
  return t.huffval[t.valoffset[l] + code];
}

// One block of the SKELETON walk (symbol lengths only, no coefficient
// stores — except the DC PREDICTOR, which rides along for free: the
// diff bits are already read to advance the cursor, and EXTEND is three
// ops. Per-lane starting predictors let the fused pixels kernel decode
// skeleton-split lanes with true DCs, no post-hoc prefix fixup): the
// shared step of tj_scan_split and its speculative parallel variant.
// Leaves err set on bad DC size / AC overrun / invalid code.
static inline void skeleton_block(BitReader& br, const HuffTbl& dc,
                                  const HuffTbl& ac, ErrState& err,
                                  int32_t* pred) {
  int t = huff_decode(br, dc, err);
  if (t < 0) return;
  if (t > 15) {
    err.set(ERR_HUFFMAN, "bad DC size");
    return;
  }
  *pred += extend(br.receive(t), t);
  int k = 1;
  while (k < 64) {
    int rs = huff_decode(br, ac, err);
    if (rs < 0) return;
    int run = rs >> 4, size = rs & 15;
    if (size == 0) {
      if (run == 15) {
        k += 16;
        continue;
      }
      break;
    }
    k += run;
    if (k > 63) {
      err.set(ERR_HUFFMAN, "AC run past end of block");
      return;
    }
    br.receive(size);
    k++;
  }
}

// ---------------------------------------------------------------------------
// Geometry / scan parameter unpacking (layout defined in entropy.py)
// ---------------------------------------------------------------------------

constexpr int kMaxComps = 4;

struct Geom {
  int n_comps;
  int mcus_x, mcus_y;
  int h[kMaxComps], v[kMaxComps];
  int padded_wb[kMaxComps], padded_hb[kMaxComps];
  int width_blocks[kMaxComps], height_blocks[kMaxComps];
};

struct ScanDesc {
  int n_scan_comps;
  int ss, se, ah, al;
  int restart_interval;
  int comp_idx[kMaxComps];
  int dc_id[kMaxComps], ac_id[kMaxComps];
};

static Geom unpack_geom(const int32_t* g) {
  Geom geom;
  geom.n_comps = g[0];
  geom.mcus_x = g[1];
  geom.mcus_y = g[2];
  const int32_t* p = g + 3;
  for (int i = 0; i < geom.n_comps; i++) {
    geom.h[i] = p[0];
    geom.v[i] = p[1];
    geom.padded_wb[i] = p[2];
    geom.padded_hb[i] = p[3];
    geom.width_blocks[i] = p[4];
    geom.height_blocks[i] = p[5];
    p += 6;
  }
  return geom;
}

static ScanDesc unpack_scan(const int32_t* s) {
  ScanDesc d;
  d.n_scan_comps = s[0];
  d.ss = s[1];
  d.se = s[2];
  d.ah = s[3];
  d.al = s[4];
  d.restart_interval = s[5];
  const int32_t* p = s + 6;
  for (int i = 0; i < d.n_scan_comps; i++) {
    d.comp_idx[i] = p[0];
    d.dc_id[i] = p[1];
    d.ac_id[i] = p[2];
    p += 3;
  }
  return d;
}

// Packed Huffman specs from Python: 8 slots (tc*4+th), each
// [present:1][counts:16][values:256] bytes.
constexpr int kHSlot = 1 + 16 + 256;

static void build_tables(const uint8_t* hspec, HuffTbl* tbls, ErrState& err) {
  for (int slot = 0; slot < 8; slot++) {
    const uint8_t* p = hspec + slot * kHSlot;
    if (!p[0]) continue;
    if (!tbls[slot].build(p + 1, p + 17)) {
      err.set(ERR_SYNTAX, "overfull Huffman table");
    }
  }
}

// ---------------------------------------------------------------------------
// Destuffing (T.81 §B.1.1.5): strip 0xFF 0x00 pairs from one segment.
// ---------------------------------------------------------------------------

static size_t destuff(const uint8_t* src, size_t len, uint8_t* dst) {
  size_t o = 0;
  size_t i = 0;
  while (i < len) {
    const uint8_t* ff = static_cast<const uint8_t*>(
        std::memchr(src + i, 0xFF, len - i));
    if (!ff) {
      std::memcpy(dst + o, src + i, len - i);
      o += len - i;
      break;
    }
    size_t run = static_cast<size_t>(ff - (src + i));
    std::memcpy(dst + o, src + i, run + 1);  // include the 0xFF
    o += run + 1;
    i += run + 1;
    if (i < len && src[i] == 0x00) i++;  // drop the stuffed zero byte
  }
  return o;
}

// ---------------------------------------------------------------------------
// Per-MCU block enumeration (T.81 §A.2.3)
// ---------------------------------------------------------------------------

struct BlockRef {
  int sp;        // scan component position (predictor index)
  int ci;        // frame component index
  int64_t idx;   // block index into [padded_hb*padded_wb] grid
};

// Fill template of per-MCU offsets; actual index = base(ci, mcu) + offset.
struct McuOrder {
  int n_blocks = 0;
  int sp[kMaxComps * 16];
  int ci[kMaxComps * 16];
  int dv[kMaxComps * 16];  // v offset within MCU
  int dh[kMaxComps * 16];  // h offset within MCU

  McuOrder(const Geom& g, const ScanDesc& s) {
    if (s.n_scan_comps == 1) {
      // Non-interleaved scan: one block per MCU regardless of the
      // component's sampling factors (T.81 §A.2.3).
      sp[0] = 0;
      ci[0] = s.comp_idx[0];
      dv[0] = 0;
      dh[0] = 0;
      n_blocks = 1;
      return;
    }
    for (int p = 0; p < s.n_scan_comps; p++) {
      int c = s.comp_idx[p];
      for (int v = 0; v < g.v[c]; v++) {
        for (int h = 0; h < g.h[c]; h++) {
          sp[n_blocks] = p;
          ci[n_blocks] = c;
          dv[n_blocks] = v;
          dh[n_blocks] = h;
          n_blocks++;
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Baseline sequential scan decode of one restart segment
// (T.81 §F.2.2.1-F.2.2.4)
// ---------------------------------------------------------------------------

struct SegTask {
  const uint8_t* raw;  // raw (stuffed) bytes of this segment
  size_t raw_len;
  int64_t first_mcu;
  int64_t n_mcus;
  int seg_index;
};

static void decode_baseline_segment(
    const SegTask& seg, const Geom& g, const ScanDesc& s, const McuOrder& ord,
    const HuffTbl* dc_tbl[kMaxComps], const HuffTbl* ac_tbl[kMaxComps],
    int32_t* const* coeffs, std::vector<uint8_t>& scratch, ErrState& err) {
  scratch.resize(seg.raw_len);
  size_t dlen = destuff(seg.raw, seg.raw_len, scratch.data());
  BitReader br(scratch.data(), dlen);
  int32_t pred[kMaxComps] = {0, 0, 0, 0};

  bool interleaved = s.n_scan_comps > 1;
  int c0 = s.comp_idx[0];
  for (int64_t m = seg.first_mcu; m < seg.first_mcu + seg.n_mcus; m++) {
    int64_t mcu_y, mcu_x;
    if (interleaved) {
      mcu_y = m / g.mcus_x;
      mcu_x = m % g.mcus_x;
    } else {
      mcu_y = m / g.width_blocks[c0];
      mcu_x = m % g.width_blocks[c0];
    }
    for (int b = 0; b < ord.n_blocks; b++) {
      int ci = ord.ci[b];
      int sp = ord.sp[b];
      int64_t row, col;
      if (interleaved) {
        row = mcu_y * g.v[ci] + ord.dv[b];
        col = mcu_x * g.h[ci] + ord.dh[b];
      } else {
        row = mcu_y;
        col = mcu_x;
      }
      int32_t* out = coeffs[ci] + (row * g.padded_wb[ci] + col) * 64;

      int t = huff_decode(br, *dc_tbl[sp], err);
      if (t < 0) return;
      if (t > 15) {
        err.set(ERR_HUFFMAN, "bad DC size");
        return;
      }
      pred[sp] += extend(br.receive(t), t);
      out[0] = pred[sp];
      int k = 1;
      while (k < 64) {
        int rs = huff_decode(br, *ac_tbl[sp], err);
        if (rs < 0) return;
        int run = rs >> 4, size = rs & 15;
        if (size == 0) {
          if (run == 15) {
            k += 16;  // ZRL
            continue;
          }
          break;  // EOB
        }
        k += run;
        if (k > 63) {
          err.set(ERR_HUFFMAN, "AC run past end of block");
          return;
        }
        out[k] = extend(br.receive(size), size);
        k++;
      }
    }
    if (err.code.load(std::memory_order_relaxed) != OK) return;
  }
  if (br.overrun()) {
    char m[64];
    std::snprintf(m, sizeof(m), "entropy segment %d truncated", seg.seg_index);
    err.set(ERR_TRUNCATED, m);
  }
}

// ---------------------------------------------------------------------------
// Progressive scan decode of one restart segment (T.81 §G.2; same four
// scan kinds as tpujpeg/huffman.py: DC first/refine, AC first/refine)
// ---------------------------------------------------------------------------

static void decode_prog_segment(
    const SegTask& seg, const Geom& g, const ScanDesc& s, const McuOrder& ord,
    const HuffTbl* dc_tbl[kMaxComps], const HuffTbl* ac_tbl0,
    int32_t* const* coeffs, std::vector<uint8_t>& scratch, ErrState& err) {
  scratch.resize(seg.raw_len);
  size_t dlen = destuff(seg.raw, seg.raw_len, scratch.data());
  BitReader br(scratch.data(), dlen);
  int32_t pred[kMaxComps] = {0, 0, 0, 0};
  int64_t eobrun = 0;

  bool is_dc = s.ss == 0;
  bool refining = s.ah != 0;
  int32_t p1 = 1 << s.al;
  int32_t m1 = -(1 << s.al);  // -1<<n is UB pre-C++20
  bool interleaved = s.n_scan_comps > 1;
  int c0 = s.comp_idx[0];

  for (int64_t m = seg.first_mcu; m < seg.first_mcu + seg.n_mcus; m++) {
    if (is_dc) {
      int64_t mcu_y, mcu_x;
      if (interleaved) {
        mcu_y = m / g.mcus_x;
        mcu_x = m % g.mcus_x;
      } else {
        mcu_y = m / g.width_blocks[c0];
        mcu_x = m % g.width_blocks[c0];
      }
      for (int b = 0; b < ord.n_blocks; b++) {
        int ci = ord.ci[b];
        int sp = ord.sp[b];
        int64_t row, col;
        if (interleaved) {
          row = mcu_y * g.v[ci] + ord.dv[b];
          col = mcu_x * g.h[ci] + ord.dh[b];
        } else {
          row = mcu_y;
          col = mcu_x;
        }
        int32_t* out = coeffs[ci] + (row * g.padded_wb[ci] + col) * 64;
        if (refining) {
          if (br.receive_bit()) out[0] |= p1;  // §G.1.2.1
        } else {
          int t = huff_decode(br, *dc_tbl[sp], err);
          if (t < 0) return;
          if (t > 15) {
            err.set(ERR_HUFFMAN, "bad DC size");
            return;
          }
          pred[sp] += extend(br.receive(t), t);
          // Shift of a negative value is UB pre-C++20: go via uint32.
          out[0] = static_cast<int32_t>(
              static_cast<uint32_t>(pred[sp]) << s.al);
        }
      }
    } else {
      // AC scans are single-component, non-interleaved (parser-checked).
      int64_t by = m / g.width_blocks[c0];
      int64_t bx = m % g.width_blocks[c0];
      int32_t* out = coeffs[c0] + (by * g.padded_wb[c0] + bx) * 64;
      if (!refining) {
        // §G.2.2 / AC first pass.
        if (eobrun > 0) {
          eobrun--;
        } else {
          int k = s.ss;
          while (k <= s.se) {
            int rs = huff_decode(br, *ac_tbl0, err);
            if (rs < 0) return;
            int rr = rs >> 4, sz = rs & 15;
            if (sz) {
              k += rr;
              if (k > s.se) {
                err.set(ERR_HUFFMAN, "AC run past spectral band");
                return;
              }
              out[k] = static_cast<int32_t>(
                  static_cast<uint32_t>(extend(br.receive(sz), sz))
                  << s.al);
              k++;
            } else {
              if (rr != 15) {
                eobrun = (1LL << rr) - 1;
                if (rr) eobrun += br.receive(rr);
                break;
              }
              k += 16;  // ZRL
            }
          }
        }
      } else {
        // §G.1.2.3 / AC refinement.
        int k = s.ss;
        if (eobrun == 0) {
          while (k <= s.se) {
            int rs = huff_decode(br, *ac_tbl0, err);
            if (rs < 0) return;
            int rr = rs >> 4, sz = rs & 15;
            int32_t newval = 0;
            if (sz) {
              newval = br.receive_bit() ? p1 : m1;
            } else {
              if (rr != 15) {
                eobrun = 1LL << rr;
                if (rr) eobrun += br.receive(rr);
                break;
              }
            }
            while (k <= s.se) {
              int32_t cv = out[k];
              if (cv != 0) {
                if (br.receive_bit() && (cv & p1) == 0) {
                  out[k] = cv + (cv >= 0 ? p1 : m1);
                }
              } else {
                if (rr == 0) break;
                rr--;
              }
              k++;
            }
            if (sz) {
              if (k > s.se) {
                err.set(ERR_HUFFMAN, "refinement insert past band");
                return;
              }
              out[k] = newval;
            }
            k++;
          }
        }
        if (eobrun > 0) {
          while (k <= s.se) {
            int32_t cv = out[k];
            if (cv != 0) {
              if (br.receive_bit() && (cv & p1) == 0) {
                out[k] = cv + (cv >= 0 ? p1 : m1);
              }
            }
            k++;
          }
          eobrun--;
        }
      }
    }
    if (err.code.load(std::memory_order_relaxed) != OK) return;
  }
  if (br.overrun()) {
    char m[64];
    std::snprintf(m, sizeof(m), "entropy segment %d truncated", seg.seg_index);
    err.set(ERR_TRUNCATED, m);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Decode one scan (baseline or progressive) into the per-component
// coefficient grids. Returns ErrCode; on error err_msg is filled.
//
//   scan_data / scan_len : raw entropy bytes (stuffed, RSTn embedded)
//   rst_offsets / n_rst  : byte offsets of RSTn markers within scan_data
//   geom / scan_params   : packed as described in entropy.py
//   hspec                : 8 * (1+16+256) packed Huffman specs
//   coeff0..3            : int32[padded_hb*padded_wb*64] per frame comp
//   is_progressive       : frame is SOF2
//   n_threads            : worker threads for restart-segment parallelism
int tj_decode_scan(const uint8_t* scan_data, int64_t scan_len,
                   const int64_t* rst_offsets, int n_rst,
                   const int32_t* geom_p, const int32_t* scan_p,
                   const uint8_t* hspec, int32_t* coeff0, int32_t* coeff1,
                   int32_t* coeff2, int32_t* coeff3, int is_progressive,
                   int n_threads, char* err_msg, int err_len) {
  ErrState err;
  Geom g = unpack_geom(geom_p);
  ScanDesc s = unpack_scan(scan_p);
  McuOrder ord(g, s);
  int32_t* coeffs[kMaxComps] = {coeff0, coeff1, coeff2, coeff3};

  HuffTbl tbls[8];
  build_tables(hspec, tbls, err);

  bool is_dc_or_full = s.ss == 0;
  bool refining = s.ah != 0;
  const HuffTbl* dc_tbl[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
  const HuffTbl* ac_tbl[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
  for (int p = 0; p < s.n_scan_comps; p++) {
    if (is_dc_or_full && !refining) {
      const HuffTbl& t = tbls[0 * 4 + s.dc_id[p]];
      if (!t.present) {
        err.set(ERR_SYNTAX, "missing DC Huffman table");
      }
      dc_tbl[p] = &t;
    }
    if (!is_progressive || s.ss > 0) {
      const HuffTbl& t = tbls[1 * 4 + s.ac_id[p]];
      if (!t.present) {
        err.set(ERR_SYNTAX, "missing AC Huffman table");
      }
      ac_tbl[p] = &t;
    }
  }
  if (err.code.load() != OK) {
    std::snprintf(err_msg, err_len, "%s", err.msg);
    return err.code.load();
  }

  // Total MCU count for this scan.
  int64_t total_mcus;
  if (s.n_scan_comps > 1) {
    total_mcus = static_cast<int64_t>(g.mcus_x) * g.mcus_y;
  } else {
    int c0 = s.comp_idx[0];
    total_mcus =
        static_cast<int64_t>(g.width_blocks[c0]) * g.height_blocks[c0];
  }
  int64_t ri = s.restart_interval > 0 ? s.restart_interval : total_mcus;

  // Build segment tasks from RSTn offsets (component #9: the segment
  // index table / parallelism substrate).
  std::vector<SegTask> segs;
  int64_t mcu = 0;
  int64_t start = 0;
  for (int i = 0; i <= n_rst && mcu < total_mcus; i++) {
    int64_t end = (i < n_rst) ? rst_offsets[i] : scan_len;
    SegTask t;
    t.raw = scan_data + start;
    t.raw_len = static_cast<size_t>(end - start);
    t.first_mcu = mcu;
    t.n_mcus = std::min(ri, total_mcus - mcu);
    t.seg_index = i;
    segs.push_back(t);
    mcu += t.n_mcus;
    start = end + 2;  // skip the RSTn marker pair
  }
  if (mcu < total_mcus) {
    std::snprintf(err_msg, err_len,
                  "scan ended after %lld/%lld MCUs (missing restart segments)",
                  static_cast<long long>(mcu),
                  static_cast<long long>(total_mcus));
    return ERR_TRUNCATED;
  }

  auto run_range = [&](size_t lo, size_t hi) {
    std::vector<uint8_t> scratch;
    for (size_t i = lo; i < hi; i++) {
      if (err.code.load(std::memory_order_relaxed) != OK) return;
      if (is_progressive) {
        decode_prog_segment(segs[i], g, s, ord, dc_tbl, ac_tbl[0], coeffs,
                            scratch, err);
      } else {
        decode_baseline_segment(segs[i], g, s, ord, dc_tbl, ac_tbl, coeffs,
                                scratch, err);
      }
    }
  };

  int nt = n_threads;
  if (nt > static_cast<int>(segs.size())) nt = static_cast<int>(segs.size());
  if (nt <= 1) {
    run_range(0, segs.size());
  } else {
    std::vector<std::thread> workers;
    size_t per = (segs.size() + nt - 1) / nt;
    for (int w = 0; w < nt; w++) {
      size_t lo = w * per;
      size_t hi = std::min(segs.size(), lo + per);
      if (lo >= hi) break;
      workers.emplace_back(run_range, lo, hi);
    }
    for (auto& th : workers) th.join();
  }

  int code = err.code.load();
  if (code != OK) std::snprintf(err_msg, err_len, "%s", err.msg);
  return code;
}

// Destuff every restart segment of a scan directly into fixed-width
// per-lane word rows for the device wavefront kernel: row s holds
// segment s's bytes, 0xFF-padded to row_words*4 bytes, byte-swapped so
// a native int32 load yields the big-endian (MSB-first) word value.
// out_words: int32[n_seg * row_words]; out_bits: int32[n_seg] true bit
// lengths. Returns 0, or 1 if any segment overflows row_words.
int tj_destuff_rows(const uint8_t* scan_data, int64_t scan_len,
                    const int64_t* rst_offsets, int n_rst, int n_seg,
                    int row_words, int32_t* out_words, int32_t* out_bits,
                    int n_threads) {
  std::atomic<int> overflow{0};
  const size_t row_bytes = static_cast<size_t>(row_words) * 4;

  auto run_range = [&](int lo, int hi) {
    for (int s = lo; s < hi; s++) {
      int64_t start = (s == 0) ? 0 : rst_offsets[s - 1] + 2;
      int64_t end = (s < n_rst) ? rst_offsets[s] : scan_len;
      int64_t src_len = end - start;
      if (static_cast<size_t>(src_len) > row_bytes) {
        // Destuffing never expands, so clamping the (stuffed) source to
        // the row keeps the write in bounds; flag for the caller.
        overflow.store(1);
        src_len = static_cast<int64_t>(row_bytes);
      }
      uint8_t* row = reinterpret_cast<uint8_t*>(out_words) +
                     static_cast<size_t>(s) * row_bytes;
      size_t n = destuff(scan_data + start, static_cast<size_t>(src_len),
                         row);
      std::memset(row + n, 0xFF, row_bytes - n);
      out_bits[s] = static_cast<int32_t>(n * 8);
      // Byte-swap each word in place (MSB-first bit order as int32).
      for (size_t w = 0; w < row_bytes; w += 4) {
        uint32_t v;
        std::memcpy(&v, row + w, 4);
        v = __builtin_bswap32(v);
        std::memcpy(row + w, &v, 4);
      }
    }
  };

  int nt = n_threads;
  if (nt > n_seg) nt = n_seg;
  if (nt <= 1) {
    run_range(0, n_seg);
  } else {
    std::vector<std::thread> workers;
    int per = (n_seg + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int lo = t * per;
      int hi = std::min(n_seg, lo + per);
      if (lo >= hi) break;
      workers.emplace_back(run_range, lo, hi);
    }
    for (auto& th : workers) th.join();
  }
  return overflow.load();
}

// Skeleton-scan a no-restart baseline scan (SURVEY.md §5 long-context
// item 3/4: the serial prefix that unlocks device-parallel decode of a
// marker-free stream). Walks the DESTUFFED stream decoding only symbol
// lengths — no coefficient stores, no MCU geometry — and records the
// bit offset at every `every` MCUs. The device wavefront then decodes
// segment i from bit_offs[i] with DC predictors starting at 0; true
// DCs are recovered by a prefix fixup over per-segment DC totals
// (halo.dc_prefix_fixup across shards).
//
// bit_offs must hold ceil(total_mcus/every)+1 entries; the last entry
// gets the total bits consumed. dc_out (same entry count, n_scan_comps
// int32 each) receives the DC predictor values at each recorded MCU
// start — the per-lane priming that lets the fused pixels kernel skip
// the device-side DC prefix fixup. Returns ErrCode.
int tj_scan_split(const uint8_t* destuffed, int64_t dlen,
                  const int32_t* scan_p, const uint8_t* hspec,
                  const int32_t* blocks_sp,  // per-MCU block -> scan comp
                  int n_blocks, int64_t total_mcus, int64_t every,
                  int64_t* bit_offs, int32_t* dc_out,
                  char* err_msg, int err_len) {
  ErrState err;
  ScanDesc s = unpack_scan(scan_p);
  HuffTbl tbls[8];
  build_tables(hspec, tbls, err);
  const HuffTbl* dc_tbl[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
  const HuffTbl* ac_tbl[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
  for (int p = 0; p < s.n_scan_comps; p++) {
    const HuffTbl& dt = tbls[0 * 4 + s.dc_id[p]];
    const HuffTbl& at = tbls[1 * 4 + s.ac_id[p]];
    if (!dt.present || !at.present) {
      err.set(ERR_SYNTAX, "missing Huffman table");
    }
    dc_tbl[p] = &dt;
    ac_tbl[p] = &at;
  }
  if (err.code.load() != OK) {
    std::snprintf(err_msg, err_len, "%s", err.msg);
    return err.code.load();
  }

  BitReader br(destuffed, static_cast<size_t>(dlen));
  int64_t oi = 0;
  int32_t pred[kMaxComps] = {0, 0, 0, 0};
  for (int64_t m = 0; m < total_mcus; m++) {
    if (m % every == 0) {
      if (dc_out) {
        for (int p = 0; p < s.n_scan_comps; p++) {
          dc_out[oi * s.n_scan_comps + p] = pred[p];
        }
      }
      bit_offs[oi++] =
          static_cast<int64_t>(br.pos) * 8 + br.fed_pad_bits - br.cnt;
    }
    for (int b = 0; b < n_blocks; b++) {
      skeleton_block(br, *dc_tbl[blocks_sp[b]], *ac_tbl[blocks_sp[b]], err,
                     &pred[blocks_sp[b]]);
      if (err.code.load(std::memory_order_relaxed) != OK) break;
    }
    if (err.code.load(std::memory_order_relaxed) != OK) break;
  }
  if (dc_out) {
    for (int p = 0; p < s.n_scan_comps; p++) {
      dc_out[oi * s.n_scan_comps + p] = pred[p];
    }
  }
  bit_offs[oi] =
      static_cast<int64_t>(br.pos) * 8 + br.fed_pad_bits - br.cnt;
  if (err.code.load() == OK && br.overrun()) {
    err.set(ERR_TRUNCATED, "entropy stream truncated");
  }
  int code = err.code.load();
  if (code != OK) std::snprintf(err_msg, err_len, "%s", err.msg);
  return code;
}

// Speculative self-sync parallel skeleton scan (SURVEY.md §5
// long-context item 4, §7.2 hard-part 4; the technique of PAPERS.md:5
// "Accelerating JPEG Decompression on GPUs" and PAPERS.md:7 Recoil,
// adapted to host threads): the serial prefix that tj_scan_split pays
// on marker-free streams parallelizes by letting each worker decode
// speculatively from a byte-aligned guess and VALIDATING at stitch
// time.
//
//   phase 1 (parallel)  chunk c's worker decodes from chunk start,
//                       assuming it sits at an MCU boundary, and
//                       records the bit offset of every MCU start it
//                       sees (phase-0 block starts). Huffman codes
//                       self-synchronize, so a wrong guess converges
//                       to the true symbol alignment with high
//                       probability; until it does, the records are
//                       garbage that simply won't match. An invalid
//                       code before the first record restarts one
//                       byte later (another resync attempt); after
//                       records began, the worker stops — decode from
//                       a given (bit, phase) state is DETERMINISTIC,
//                       so one contiguous record run per chunk keeps
//                       the continuation property.
//   phase 2 (serial)    the stitch holds the EXACT decoder state. At
//                       each chunk it looks its bit offset up in the
//                       chunk's records: a hit proves every later
//                       record of that chunk is the exact decode
//                       continuation (determinism — regardless of how
//                       the worker got there), so the stitch
//                       fast-forwards through them, emitting every
//                       `every`-th MCU offset and counting absolute
//                       MCU indices the workers could not know. A
//                       miss (non-converged worker, pathological
//                       stream) falls back to exact serial decode of
//                       that chunk — correctness never depends on
//                       speculation succeeding.
//
// Output and error taxonomy are bit-identical to tj_scan_split (the
// equivalence is property-tested); only wall-clock differs.
int tj_scan_split_spec(const uint8_t* destuffed, int64_t dlen,
                       const int32_t* scan_p, const uint8_t* hspec,
                       const int32_t* blocks_sp, int n_blocks,
                       int64_t total_mcus, int64_t every,
                       int64_t* bit_offs, int32_t* dc_out, int n_threads,
                       char* err_msg, int err_len) {
  ErrState err;
  ScanDesc s = unpack_scan(scan_p);
  HuffTbl tbls[8];
  build_tables(hspec, tbls, err);
  const HuffTbl* dc_tbl[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
  const HuffTbl* ac_tbl[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
  for (int p = 0; p < s.n_scan_comps; p++) {
    const HuffTbl& dt = tbls[0 * 4 + s.dc_id[p]];
    const HuffTbl& at = tbls[1 * 4 + s.ac_id[p]];
    if (!dt.present || !at.present) {
      err.set(ERR_SYNTAX, "missing Huffman table");
    }
    dc_tbl[p] = &dt;
    ac_tbl[p] = &at;
  }
  if (err.code.load() != OK) {
    std::snprintf(err_msg, err_len, "%s", err.msg);
    return err.code.load();
  }

  // Chunking: enough chunks for balance, big enough to amortize the
  // resync prefix. Chunk 0 needs no speculation (bit 0 IS exact).
  const int64_t kMinChunk = 1 << 18;  // 256 KB
  int64_t n_chunks = n_threads > 1 ? std::min<int64_t>(
      4 * n_threads, std::max<int64_t>(1, dlen / kMinChunk)) : 1;
  std::vector<int64_t> chunk_start(n_chunks + 1);
  for (int64_t c = 0; c <= n_chunks; c++) {
    chunk_start[c] = dlen * c / n_chunks;
  }

  // Per-chunk MCU-start records (absolute bit offsets). Workers record
  // OVERLAP bytes past their chunk end: the stitch arrives in a chunk
  // near its start — before that chunk's worker has self-synced — so
  // the agreement point between the exact walk and a worker's run lies
  // a sync-distance past the chunk boundary. The overlap must exceed
  // the sync distance (typically well under a KB of stream).
  const int64_t kOverlapBits = (64 << 10) * 8;  // 64 KB
  std::vector<std::vector<int64_t>> recs(n_chunks);
  // Per-record DC predictor values (n_scan_comps per record), RELATIVE
  // to the worker run's start (where the worker assumed pred = 0). A
  // record run is a deterministic decode continuation from its attach
  // point, so relative DC deltas from the attach record onward are
  // exact even though the run's absolute base is unknown to the worker.
  const int nc = s.n_scan_comps;
  std::vector<std::vector<int32_t>> recs_dc(n_chunks);

  auto worker = [&](int64_t c) {
    std::vector<int64_t>& out = recs[c];
    std::vector<int32_t>& odc = recs_dc[c];
    const int64_t end_bits =
        std::min<int64_t>(chunk_start[c + 1] * 8 + kOverlapBits, dlen * 8);
    // Record capacity bound: one MCU start per two stream bytes is
    // already pathological; past it, stop and let the stitch walk
    // serially (flat streams decode fast serially anyway).
    const size_t cap = static_cast<size_t>(
        (chunk_start[c + 1] - chunk_start[c] + (kOverlapBits >> 3)) / 2
        + 1024);
    int64_t start_byte = chunk_start[c];
    while (true) {  // resync attempts: advance one byte per retry
      out.clear();
      odc.clear();
      BitReader br(destuffed, static_cast<size_t>(dlen));
      br.pos = static_cast<size_t>(start_byte);
      ErrState werr;
      int32_t pred[kMaxComps] = {0, 0, 0, 0};
      while (true) {
        int64_t bit =
            static_cast<int64_t>(br.pos) * 8 + br.fed_pad_bits - br.cnt;
        out.push_back(bit);
        for (int p = 0; p < nc; p++) odc.push_back(pred[p]);
        if (bit >= end_bits || out.size() > cap) return;  // run closed
        for (int b = 0; b < n_blocks; b++) {
          skeleton_block(br, *dc_tbl[blocks_sp[b]], *ac_tbl[blocks_sp[b]],
                         werr, &pred[blocks_sp[b]]);
          if (werr.code.load(std::memory_order_relaxed) != OK) break;
        }
        if (werr.code.load(std::memory_order_relaxed) != OK) {
          if (out.size() <= 1) {
            // Error before self-sync established anything: try the
            // next byte, unless the chunk is exhausted.
            start_byte += 1;
            if (start_byte * 8 < chunk_start[c + 1] * 8) break;  // retry
            out.clear();
            odc.clear();
            return;
          }
          // Error after records began: the run up to here is a valid
          // deterministic continuation; close it (drop the boundary
          // AFTER the failing MCU — it was never reached).
          return;
        }
        if (br.overrun()) return;  // ran off the stream: close the run
      }
    }
  };

  if (n_chunks > 1) {
    // Chunk 0's "speculation" is exact (it starts at true bit 0), so
    // its run lets the stitch teleport from the very first MCU.
    std::vector<std::thread> workers;
    int nt = std::min<int64_t>(n_threads, n_chunks);
    std::atomic<int64_t> next{0};
    for (int t = 0; t < nt; t++) {
      workers.emplace_back([&]() {
        for (int64_t c; (c = next.fetch_add(1)) < n_chunks;) worker(c);
      });
    }
    for (auto& th : workers) th.join();
  }

  // Serial stitch with record teleports: hold the exact state (bit,
  // MCU index); whenever the current bit appears in the owning chunk's
  // records, every later record of that run is the exact continuation
  // (decode from a state is deterministic) — consume them without
  // touching the bits. Otherwise decode ONE MCU exactly and re-probe:
  // per-MCU binary search is noise next to an MCU decode, and it lets
  // the stitch reattach at the agreement point anywhere in a chunk.
  BitReader br(destuffed, static_cast<size_t>(dlen));
  int64_t m = 0;   // absolute MCU index == count of MCUs fully decoded
  int64_t oi = 0;
  bool reader_live = true;  // br matches the current bit position
  int64_t bit = 0;
  int64_t c_at = 0;  // chunk owning `bit`
  int32_t pred[kMaxComps] = {0, 0, 0, 0};  // exact absolute predictors

  auto emit = [&](int64_t at_bit, const int32_t* dcvals) {
    if (m % every == 0) {
      if (dc_out) {
        for (int p = 0; p < nc; p++) dc_out[oi * nc + p] = dcvals[p];
      }
      bit_offs[oi++] = at_bit;
    }
  };

  while (m < total_mcus && err.code.load(std::memory_order_relaxed) == OK) {
    while (c_at + 1 < n_chunks && bit >= chunk_start[c_at + 1] * 8) c_at++;
    const std::vector<int64_t>& r = recs[c_at];
    auto it = std::lower_bound(r.begin(), r.end(), bit);
    if (it != r.end() && *it == bit && it + 1 != r.end()) {
      // Teleport: consume the run (all but its closing record, which
      // only marks where the worker stopped decoding). The stitch holds
      // exact absolute predictors at the attach point; the worker's
      // records hold run-relative values, so base + (rel - rel_attach)
      // is exact for every later record of the run (determinism).
      size_t i = static_cast<size_t>(it - r.begin());
      const std::vector<int32_t>& rdc = recs_dc[c_at];
      int32_t base[kMaxComps] = {0, 0, 0, 0};
      for (int p = 0; p < nc; p++) {
        base[p] = pred[p] - rdc[i * nc + p];
      }
      int32_t cur_dc[kMaxComps];
      while (m < total_mcus && i + 1 < r.size()) {
        for (int p = 0; p < nc; p++) cur_dc[p] = base[p] + rdc[i * nc + p];
        emit(r[i], cur_dc);
        m++;
        i++;
      }
      bit = r[i];
      for (int p = 0; p < nc; p++) pred[p] = base[p] + rdc[i * nc + p];
      reader_live = false;
      continue;
    }
    // Exact decode of one MCU.
    if (!reader_live) {
      br = BitReader(destuffed, static_cast<size_t>(dlen));
      br.pos = static_cast<size_t>(bit >> 3);
      br.receive(static_cast<int>(bit & 7));
      reader_live = true;
    }
    emit(bit, pred);
    for (int b = 0; b < n_blocks; b++) {
      skeleton_block(br, *dc_tbl[blocks_sp[b]], *ac_tbl[blocks_sp[b]], err,
                     &pred[blocks_sp[b]]);
      if (err.code.load(std::memory_order_relaxed) != OK) break;
    }
    if (err.code.load(std::memory_order_relaxed) != OK) break;
    m++;
    bit = static_cast<int64_t>(br.pos) * 8 + br.fed_pad_bits - br.cnt;
  }

  if (dc_out) {
    for (int p = 0; p < nc; p++) dc_out[oi * nc + p] = pred[p];
  }
  bit_offs[oi] = bit;
  if (err.code.load() == OK &&
      bit > static_cast<int64_t>(dlen) * 8) {
    err.set(ERR_TRUNCATED, "entropy stream truncated");
  }
  int code = err.code.load();
  if (code != OK) std::snprintf(err_msg, err_len, "%s", err.msg);
  return code;
}

// Entropy-scan terminator walk (the native twin of Python
// bitstream._find_scan_end, same T.81 §B.1.1.5/§E.2.4 semantics as the
// byte-serial reference in tests/test_bitstream.py): from `start`,
// classify every 0xFF pair as stuffed data (0x00), fill (0xFF), RSTn
// (record offset relative to start, skip) or a real marker (scan end).
// Returns the absolute end position (n when the scan runs to EOF).
// Writes up to rst_cap offsets; *n_rst always holds the TRUE count, so
// a caller whose buffer was too small re-calls with cap = *n_rst.
// memchr does the 0xFF hunt (SIMD-fast); this is the host parse stage's
// hot loop for multi-megabyte scans.
int64_t tj_find_scan_end(const uint8_t* data, int64_t n, int64_t start,
                         int64_t* rst_out, int64_t rst_cap,
                         int64_t* n_rst) {
  int64_t pos = start;
  int64_t cnt = 0;
  while (pos < n - 1) {
    const void* hit =
        std::memchr(data + pos, 0xFF, static_cast<size_t>(n - 1 - pos));
    if (!hit) break;
    pos = static_cast<const uint8_t*>(hit) - data;
    const uint8_t nxt = data[pos + 1];
    if (nxt == 0x00) {
      pos += 2;  // stuffed pair: both bytes belong to the scan
    } else if (nxt == 0xFF) {
      pos += 1;  // fill byte: re-examine from the second 0xFF
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {
      if (cnt < rst_cap) rst_out[cnt] = pos - start;
      cnt++;
      pos += 2;
    } else {
      *n_rst = cnt;
      return pos;  // real marker terminates the scan
    }
  }
  *n_rst = cnt;
  return n;
}

// Destuff a whole scan into `out` (callee-sized >= scan_len) and emit the
// segment start offsets within the destuffed buffer. seg_starts must hold
// n_rst+2 entries; seg_starts[n_segments] = total destuffed length.
// Returns the destuffed length. Used to prepare the device wavefront
// decoder's input (SURVEY.md §3.4 "ship segment table + bitstream").
int64_t tj_destuff_segments(const uint8_t* scan_data, int64_t scan_len,
                            const int64_t* rst_offsets, int n_rst,
                            uint8_t* out, int64_t* seg_starts) {
  int64_t o = 0;
  int64_t start = 0;
  for (int i = 0; i <= n_rst; i++) {
    int64_t end = (i < n_rst) ? rst_offsets[i] : scan_len;
    seg_starts[i] = o;
    o += static_cast<int64_t>(
        destuff(scan_data + start, static_cast<size_t>(end - start), out + o));
    start = end + 2;
  }
  seg_starts[n_rst + 1] = o;
  return o;
}

// One-pass scan walk: tj_find_scan_end + tj_destuff_segments fused so
// the multi-megabyte scan payload is read ONCE (the terminator walk
// already memchr-touches every byte; the destuffed copy rides the same
// runs). NOTE: measured on this host, parse()+destuff_rows (two memchr
// passes, rows written directly) beats walk+rows_from_dest (one pass +
// an intermediate buffer's extra write+read), so parse does NOT use
// this by default — it serves flows that need end + segment table +
// destuffed bytes together.
// Semantics are the exact union of the two: the walk classifies every
// 0xFF pair (T.81 §B.1.1.5 stuffing, §B.1.1.2 fill, §E.2.4 RSTn), and
// `out` (callee-sized >= n - start) receives the destuffed entropy
// bytes of every segment back to back. Contract mirrors the parents:
//   rst_out[cnt]   stuffed-byte offset of each RSTn, relative to start
//   seg_starts[i]  destuffed start of segment i; [n_rst+1] = total len
//   *n_rst         TRUE marker count; if it exceeds rst_cap the caller
//                  re-calls with a bigger cap (out writes are complete
//                  either way, but seg_starts past the cap were dropped)
// Returns the absolute scan end position (n when it runs to EOF).
// Fill bytes (0xFF 0xFF) are KEPT in `out` like destuff() keeps them:
// trailing fill decodes as the all-ones padding T.81 allows.
int64_t tj_scan_walk(const uint8_t* data, int64_t n, int64_t start,
                     int64_t* rst_out, int64_t rst_cap, int64_t* n_rst,
                     uint8_t* out, int64_t* seg_starts) {
  int64_t pos = start;
  int64_t copy_from = start;  // first byte not yet copied to out
  int64_t o = 0;
  int64_t cnt = 0;
  seg_starts[0] = 0;  // callers size seg_starts at rst_cap + 2 (>= 2)

  auto flush = [&](int64_t upto) {
    // Copy [copy_from, upto) into out; the caller advances copy_from.
    int64_t len = upto - copy_from;
    if (len > 0) {
      std::memcpy(out + o, data + copy_from, static_cast<size_t>(len));
      o += len;
    }
  };

  while (pos < n - 1) {
    const void* hit =
        std::memchr(data + pos, 0xFF, static_cast<size_t>(n - 1 - pos));
    if (!hit) break;
    pos = static_cast<const uint8_t*>(hit) - data;
    const uint8_t nxt = data[pos + 1];
    if (nxt == 0x00) {
      flush(pos + 1);        // keep the 0xFF, drop the stuffed zero
      copy_from = pos + 2;
      pos += 2;
    } else if (nxt == 0xFF) {
      pos += 1;              // fill byte: stays in the stream, re-examine
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {
      flush(pos);            // segment ends before the marker pair
      copy_from = pos + 2;
      if (cnt < rst_cap) {
        rst_out[cnt] = pos - start;
        seg_starts[cnt + 1] = o;
      }
      cnt++;
      pos += 2;
    } else {
      flush(pos);            // real marker terminates the scan
      *n_rst = cnt;
      if (cnt + 1 < rst_cap + 2) seg_starts[cnt + 1] = o;
      return pos;
    }
  }
  flush(n);                  // truncated scan: runs to EOF
  *n_rst = cnt;
  if (cnt + 1 < rst_cap + 2) seg_starts[cnt + 1] = o;
  return n;
}

// Row fill from an already-destuffed buffer (tj_scan_walk /
// tj_destuff_segments output): pure memcpy + 0xFF pad + word byte-swap
// per lane row — no memchr re-walk of the stream, which made the old
// tj_destuff_rows the biggest host-prep term (~50 ms / 268 MP).
// Layout contract identical to tj_destuff_rows. Returns 0, or 1 if any
// segment overflows row_words (writes clamped in bounds).
int tj_rows_from_dest(const uint8_t* dest, const int64_t* seg_starts,
                      int n_seg, int row_words, int32_t* out_words,
                      int32_t* out_bits, int n_threads) {
  std::atomic<int> overflow{0};
  const size_t row_bytes = static_cast<size_t>(row_words) * 4;

  auto run_range = [&](int lo, int hi) {
    for (int s = lo; s < hi; s++) {
      int64_t src_len = seg_starts[s + 1] - seg_starts[s];
      if (static_cast<size_t>(src_len) > row_bytes) {
        overflow.store(1);
        src_len = static_cast<int64_t>(row_bytes);
      }
      uint8_t* row = reinterpret_cast<uint8_t*>(out_words) +
                     static_cast<size_t>(s) * row_bytes;
      std::memcpy(row, dest + seg_starts[s], static_cast<size_t>(src_len));
      std::memset(row + src_len, 0xFF, row_bytes - src_len);
      out_bits[s] = static_cast<int32_t>(src_len * 8);
      for (size_t w = 0; w < row_bytes; w += 4) {
        uint32_t v;
        std::memcpy(&v, row + w, 4);
        v = __builtin_bswap32(v);
        std::memcpy(row + w, &v, 4);
      }
    }
  };

  int nt = n_threads;
  if (nt > n_seg) nt = n_seg;
  if (nt <= 1) {
    run_range(0, n_seg);
  } else {
    std::vector<std::thread> workers;
    int per = (n_seg + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      int lo = t * per;
      int hi = std::min(n_seg, lo + per);
      if (lo >= hi) break;
      workers.emplace_back(run_range, lo, hi);
    }
    for (auto& th : workers) th.join();
  }
  return overflow.load();
}

}  // extern "C"
