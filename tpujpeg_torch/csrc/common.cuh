// Shared helpers for the port's CUDA kernels (plain C interface, no
// PyTorch headers: built by tpujpeg_torch/kernels/build.py with nvcc for
// sm_90a and bound with ctypes).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;

// jdcolor.c fixed point (SCALEBITS 16): int(x * 65536 + 0.5) of 1.40200,
// 1.77200, 0.34414 and 0.71414, as transform.FIX_* compute them.
#define TJ_FIX_R_CR 91881
#define TJ_FIX_B_CB 116130
#define TJ_FIX_G_CB (-22554)
#define TJ_FIX_G_CR (-46802)
#define TJ_ONE_HALF (1 << 15)

__device__ __forceinline__ uint8_t tj_clamp_u8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// natural index -> zigzag position (T.81 A.6, bitstream.NATURAL_TO_ZIGZAG).
// A function over a local constexpr table: called with an unrolled loop
// index it folds to a constant, so the arrays it indexes stay in registers.
__host__ __device__ constexpr int tj_natural_to_zigzag(int n) {
  constexpr int8_t t[64] = {
      0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
      3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
      10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
      21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63,
  };
  return t[n];
}

// ---------------------------------------------------------------------------
// Huffman decoding over a lane's row of big-endian words (kernels A, 2, 7,
// 8 and 9). A lane's row holds W words; P is the power of two >= W.
// ---------------------------------------------------------------------------

// Per-lane error bits, as the reference's kernels set them.
#define TJ_ERR_BADCODE 1
#define TJ_ERR_RUN 2
#define TJ_ERR_TRUNC 4

// Word w of the row: row[w & (P-1)] inside the row, 0 in the [W, P) gap
// (the reference's binary-fold load over a P-word row), for reads past
// the segment's end.
__device__ __forceinline__ u32 tj_load_word(const u32* row, int w, int W, int P) {
  int i = w & (P - 1);
  return i < W ? __ldg(row + i) : 0u;
}

// 32-bit window at bit `cur`; the shift-by-32 case is guarded.
__device__ __forceinline__ u32 tj_window(const u32* row, int cur, int W, int P) {
  int w = cur >> 5;
  int sh = cur & 31;
  u32 hi = tj_load_word(row, w, W, P);
  if (sh == 0) return hi;
  return (hi << sh) | (tj_load_word(row, w + 1, W, P) >> (32 - sh));
}

// The same window from a two-word register cache (kernels A, 2 and 9):
// w0, w1 are words cw and cw + 1 of the row, starting at word cw0 (the
// word of the lane's first bit). A step of the callers moves
// the cursor by at most 32 bits (a code of at most 17 bits plus at most
// 15 value bits, or one chunk of at most 32 correction bits), so a new
// cursor word is almost always cw + 1 and costs one load; any other move
// reloads both words.
struct TjWords {
  const u32* row;
  int W, P;
  int cw;
  u32 w0, w1;

  __device__ __forceinline__ TjWords(const u32* r, int W_, int P_, int cw0 = 0)
      : row(r), W(W_), P(P_), cw(cw0) {
    w0 = tj_load_word(row, cw0, W, P);
    w1 = tj_load_word(row, cw0 + 1, W, P);
  }

  __device__ __forceinline__ u32 window(int cur) {
    const int w = cur >> 5;
    if (w != cw) {
      w0 = w == cw + 1 ? w1 : tj_load_word(row, w, W, P);
      w1 = tj_load_word(row, w + 1, W, P);
      cw = w;
    }
    return __funnelshift_l(w1, w0, cur & 31);  // (w0:w1) << (cur & 31), top word
  }
};

// TjWords with 16-byte fills (kernels 7 and 8): q0, q1 hold words
// 4cq .. 4cq + 7 of the row, loaded as two int4, for rows that start on a
// 16-byte boundary with W % 4 == 0 (a quad then lies wholly inside the
// row or wholly in the [W, P) gap). A lane of a few dozen symbols finds
// its bits in the first two loads; a move to the next quad costs one
// load, any other move two. Same window as tj_window for every cursor,
// under the same at-most-32-bits-a-step rule as TjWords.
struct TjWords16 {
  const u32* row;
  int W, P;
  int cq;
  uint4 q0, q1;

  __device__ __forceinline__ uint4 load(int q) const {
    const int i = (4 * q) & (P - 1);
    return i < W ? __ldg((const uint4*)(row + i)) : make_uint4(0u, 0u, 0u, 0u);
  }

  __device__ __forceinline__ TjWords16(const u32* r, int W_, int P_) : row(r), W(W_), P(P_), cq(0) {
    q0 = load(0);
    q1 = load(1);
  }

  __device__ __forceinline__ u32 window(int cur) {
    const int w = cur >> 5;
    const int q = w >> 2;
    if (q != cq) {
      q0 = q == cq + 1 ? q1 : load(q);
      q1 = load(q + 1);
      cq = q;
    }
    const int j = w & 3;
    const u32 hi = j == 0 ? q0.x : (j == 1 ? q0.y : (j == 2 ? q0.z : q0.w));
    const u32 lo = j == 0 ? q0.y : (j == 1 ? q0.z : (j == 2 ? q0.w : q1.x));
    return __funnelshift_l(lo, hi, cur & 31);
  }
};

// Canonical decode: the shortest length l whose maxcode admits the peeked
// code; length 17 (and huffval[0]) when none does. The walk starts at
// length l0 (lengths below it are known not to admit the code).
__device__ __forceinline__ void tj_decode_symbol(u32 win, const int* mc, const int* vo,
                                                 const uint8_t* hv, int& sym, int& len,
                                                 int l0 = 1) {
  len = 17;
  int idx = 0;
#pragma unroll
  for (int l = 1; l <= 16; ++l) {
    if (l < l0) continue;
    int peek = (int)(win >> (32 - l));
    if (peek <= mc[l]) {
      len = l;
      idx = peek + vo[l];
      break;
    }
  }
  idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
  sym = hv[idx];
}

// 9-bit lookahead: entry p of a table's 512 gives, for a window whose top
// nine bits are p, (length << 8) | symbol when some length l <= 9 admits
// the code (the shortest such l, by tj_decode_symbol's rule), else 0: the
// decode then walks the maxcodes from length 10, so codes of 10-16 bits,
// and invalid codes (length 17, huffval[0]), come out as tj_decode_symbol
// gives them. wavefront.lookahead_table is the plain form of this rule.
#define TJ_LOOKAHEAD_BITS 9

__device__ __forceinline__ uint16_t tj_lookahead_entry(int p, const int* mc, const int* vo,
                                                       const uint8_t* hv) {
#pragma unroll
  for (int l = 1; l <= TJ_LOOKAHEAD_BITS; ++l) {
    const int peek = p >> (TJ_LOOKAHEAD_BITS - l);
    if (peek <= mc[l]) {
      int idx = peek + vo[l];
      idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
      return (uint16_t)((l << 8) | hv[idx]);
    }
  }
  return 0;
}

__device__ __forceinline__ void tj_decode_lookahead(u32 win, const uint16_t* lut, const int* mc,
                                                    const int* vo, const uint8_t* hv, int& sym,
                                                    int& len) {
  const int e = lut[win >> (32 - TJ_LOOKAHEAD_BITS)];
  if (e) {
    len = e >> 8;
    sym = e & 255;
  } else {
    tj_decode_symbol(win, mc, vo, hv, sym, len, TJ_LOOKAHEAD_BITS + 1);
  }
}

// EXTEND of the `size` (0..15) magnitude bits after a `len` (<= 17) bit code.
__device__ __forceinline__ int tj_receive_extend(u32 win, int len, int size) {
  if (size <= 0) return 0;
  int mag = (int)((win << len) >> (32 - size));
  return mag < (1 << (size - 1)) ? mag - (1 << size) + 1 : mag;
}

// The `n` (0..15) raw bits after a `len` (<= 17) bit code, no EXTEND.
__device__ __forceinline__ int tj_receive_raw(u32 win, int len, int n) {
  return n > 0 ? (int)((win << len) >> (32 - n)) : 0;
}

__device__ __forceinline__ int tj_descale(u32 x, int n) {
  return ((int)(x + (1u << (n - 1)))) >> n;
}

// One 8-point islow butterfly (jidctint.c), inputs in[0..7] at stride
// `is`, outputs DESCALEd by `db` bits into out[0..7] at stride `os`.
// Arithmetic wraps modulo 2^32 like jnp's and torch's int32 (it is done
// in uint32_t; only DESCALE's shift is signed).
__device__ __forceinline__ void tj_idct_1d(const int* in, int is, int* out, int os, int db) {
  u32 s0 = in[0 * is], s1 = in[1 * is], s2 = in[2 * is], s3 = in[3 * is];
  u32 s4 = in[4 * is], s5 = in[5 * is], s6 = in[6 * is], s7 = in[7 * is];
  u32 z1 = (s2 + s6) * 4433u;
  u32 tmp2 = z1 + s6 * (u32)(-15137);
  u32 tmp3 = z1 + s2 * 6270u;
  u32 tmp0 = (s0 + s4) << 13;
  u32 tmp1 = (s0 - s4) << 13;
  u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  u32 t0 = s7, t1 = s5, t2 = s3, t3 = s1;
  u32 a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  u32 z5 = (a3 + a4) * 9633u;
  t0 *= 2446u;
  t1 *= 16819u;
  t2 *= 25172u;
  t3 *= 12299u;
  a1 *= (u32)(-7373);
  a2 *= (u32)(-20995);
  a3 = a3 * (u32)(-16069) + z5;
  a4 = a4 * (u32)(-3196) + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  out[0 * os] = tj_descale(tmp10 + t3, db);
  out[1 * os] = tj_descale(tmp11 + t2, db);
  out[2 * os] = tj_descale(tmp12 + t1, db);
  out[3 * os] = tj_descale(tmp13 + t0, db);
  out[4 * os] = tj_descale(tmp13 - t0, db);
  out[5 * os] = tj_descale(tmp12 - t1, db);
  out[6 * os] = tj_descale(tmp11 - t2, db);
  out[7 * os] = tj_descale(tmp10 - t3, db);
}

// islow IDCT of one dequantized natural-order block (columns, then rows),
// +128 and clamp, stored as 8 rows of 8 u8 samples at dst, `pitch` bytes
// apart (dst and pitch 8-byte aligned). Kernels A and 6 share it. coef(n)
// returns dequantized natural coefficient n; every index is a
// compile-time constant, so the block and the workspace stay in
// registers, and each column pass reads its 8 inputs just before it runs.
template <class Coef>
__device__ __forceinline__ void tj_idct_islow_store(const Coef& coef, uint8_t* dst, size_t pitch) {
  int ws[64];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int in[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) in[r] = coef(8 * r + c);
    tj_idct_1d(in, 1, ws + c, 8, 11);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int o[8];
    tj_idct_1d(ws + r * 8, 1, o, 1, 18);
    unsigned long long packed = 0ull;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      packed |= (unsigned long long)tj_clamp_u8((int)((u32)o[c] + 128u)) << (8 * c);
    *(unsigned long long*)(dst + (size_t)r * pitch) = packed;
  }
}
