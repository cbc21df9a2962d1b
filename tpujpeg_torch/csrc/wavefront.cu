// Kernel A: fused baseline Huffman decode + dequant + islow IDCT, one
// thread per lane (restart segment), u8 samples stored at their raster
// positions in the component planes.
//
// Replaces the Pallas kernel tpujpeg/kernels/wavefront_pallas.py
// _make_kernel (emit="pixels", pallas_call in run_wavefront). That kernel
// ran lanes in lockstep [8, K] vector groups with every Huffman table
// baked in as constants and a one-hot word load; here each thread walks
// its own lane with data-dependent control flow, reads its row of words
// from device memory, and takes the tables and quantizer sets as runtime
// data staged in shared memory.
//
// What bounds it on the H100: the per-symbol dependency chain (window,
// 16 maxcode compares, huffval lookup, cursor update) of each thread, and
// warp divergence between lanes whose blocks hold different numbers of
// symbols; bytes are small (the compressed rows plus the u8 planes).
// The design keeps everything per lane in registers and local memory and
// never leaves a lane's thread, so the only cost beyond the chain is the
// divergence; reducing that (lane sorting, warp-cooperative decode) is
// later work.
//
// Semantics follow the reference exactly, including on corrupt streams:
//  * words past the row read row[w & (P-1)] when that index is < W, else
//    0 (the reference's binary-fold load over a P = 2^ceil(log2 W) row);
//  * a DC code > 15 is BADCODE and decodes as size 0; lanes with an
//    error stop advancing, and their remaining blocks are all-zero (128);
//  * an AC value is stored even on the symbol that raises BADCODE; RUN
//    wins over BADCODE when one symbol raises both;
//  * TRUNC (cursor past seg_bits + 7) is checked once, at the end, and
//    ORed onto the lane's other bits;
//  * dequant and IDCT arithmetic wraps modulo 2^32 like jnp's int32 (it
//    is done in uint32_t; only DESCALE's shift is signed).

#include "common.cuh"

#define TJ_ERR_BADCODE 1
#define TJ_ERR_RUN 2
#define TJ_ERR_TRUNC 4
#define TJ_MAX_B 10

// ZIGZAG[k]: natural index of the k-th zigzag coefficient (T.81 A.6).
__constant__ int8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

struct Planes {
  uint8_t* p[4];
};

__device__ __forceinline__ u32 load_word(const u32* row, int w, int W, int P) {
  int i = w & (P - 1);
  return i < W ? row[i] : 0u;
}

// 32-bit window at bit `cur`; the shift-by-32 case is guarded.
__device__ __forceinline__ u32 window(const u32* row, int cur, int W, int P) {
  int w = cur >> 5;
  int sh = cur & 31;
  u32 hi = load_word(row, w, W, P);
  if (sh == 0) return hi;
  return (hi << sh) | (load_word(row, w + 1, W, P) >> (32 - sh));
}

// Canonical decode: the shortest length l whose maxcode admits the peeked
// code; length 17 (and huffval[0]) when none does.
__device__ __forceinline__ void decode_symbol(u32 win, const int* mc, const int* vo,
                                              const uint8_t* hv, int& sym, int& len) {
  len = 17;
  int idx = 0;
#pragma unroll
  for (int l = 1; l <= 16; ++l) {
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

// EXTEND of the `size` (0..15) magnitude bits after a `len` (<= 17) bit code.
__device__ __forceinline__ int receive_extend(u32 win, int len, int size) {
  if (size <= 0) return 0;
  int mag = (int)((win << len) >> (32 - size));
  return mag < (1 << (size - 1)) ? mag - (1 << size) + 1 : mag;
}

__device__ __forceinline__ int descale(u32 x, int n) {
  return ((int)(x + (1u << (n - 1)))) >> n;
}

// One 8-point islow butterfly (jidctint.c), inputs in[0..7] at stride
// `is`, outputs DESCALEd by `db` bits into out[0..7] at stride `os`.
__device__ __forceinline__ void idct_1d(const int* in, int is, int* out, int os, int db) {
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
  out[0 * os] = descale(tmp10 + t3, db);
  out[1 * os] = descale(tmp11 + t2, db);
  out[2 * os] = descale(tmp12 + t1, db);
  out[3 * os] = descale(tmp13 + t0, db);
  out[4 * os] = descale(tmp13 - t0, db);
  out[5 * os] = descale(tmp12 - t1, db);
  out[6 * os] = descale(tmp11 - t2, db);
  out[7 * os] = descale(tmp10 - t3, db);
}

// Shared memory: tables [B][2][34] int, qsets [nq][B][64] int (natural
// order), blk [B][4] int, comp [n_planes][4] int, huffval [B][2][256] u8.
__global__ void wavefront_pixels_kernel(
    const u32* __restrict__ bits, int W, int P, const int* __restrict__ seg_bits,
    const int* __restrict__ lane_m, const int* __restrict__ lane_q,
    const int* __restrict__ lane_meta, int L, const int* __restrict__ tables,
    const uint8_t* __restrict__ huffval, const int* __restrict__ qsets,
    const int* __restrict__ blk, const int* __restrict__ comp, int B, int nq,
    int n_planes, int mcus_x, Planes planes, int* __restrict__ err_out) {
  extern __shared__ int smem[];
  __shared__ int8_t s_zz[64];
  int* s_tab = smem;
  int* s_q = s_tab + B * 68;
  int* s_blk = s_q + nq * B * 64;
  int* s_comp = s_blk + B * 4;
  uint8_t* s_hv = (uint8_t*)(s_comp + n_planes * 4);
  for (int i = threadIdx.x; i < B * 68; i += blockDim.x) s_tab[i] = tables[i];
  for (int i = threadIdx.x; i < nq * B * 64; i += blockDim.x) s_q[i] = qsets[i];
  for (int i = threadIdx.x; i < B * 4; i += blockDim.x) s_blk[i] = blk[i];
  for (int i = threadIdx.x; i < n_planes * 4; i += blockDim.x) s_comp[i] = comp[i];
  for (int i = threadIdx.x; i < B * 512; i += blockDim.x) s_hv[i] = huffval[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s_zz[i] = kZigzag[i];
  __syncthreads();

  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const u32* row = bits + (size_t)lane * W;
  const int img = lane_meta[lane * 3 + 0];
  const int first = lane_meta[lane * 3 + 1];
  const int lm = lane_m[lane];
  const int* q_lane = s_q + lane_q[lane] * B * 64;

  int cur = 0;
  int err = 0;
  u32 pred[4] = {0u, 0u, 0u, 0u};
  int coef[64];
  int ws[64];

  for (int m = 0; m < lm; ++m) {
    const int g = first + m;
    const int my = g / mcus_x;
    const int mx = g - my * mcus_x;
    for (int b = 0; b < B; ++b) {
      const int* tb = s_tab + b * 68;
      const uint8_t* hv = s_hv + b * 512;
      const int ci = s_blk[b * 4 + 0];
#pragma unroll
      for (int i = 0; i < 64; ++i) coef[i] = 0;
      u32 dc = 0u;
      if (err == 0) {
        // DC symbol, EXTEND, predictor.
        u32 win = window(row, cur, W, P);
        int t, dlen;
        decode_symbol(win, tb, tb + 17, hv, t, dlen);
        const bool bad = dlen > 16 || t > 15;
        if (t > 15) t = 0;
        pred[ci] += (u32)receive_extend(win, dlen, t);
        cur += dlen + t;
        if (bad) err = TJ_ERR_BADCODE;
        // AC symbols until EOB, k = 64 or an error.
        int k = 1;
        while (k < 64 && err == 0) {
          win = window(row, cur, W, P);
          int rs, alen;
          decode_symbol(win, tb + 34, tb + 51, hv + 256, rs, alen);
          const int run = rs >> 4, size = rs & 15;
          const int val = receive_extend(win, alen, size);
          const int nk = k + (size > 0 ? run : 0);
          if (size > 0 && nk <= 63) coef[s_zz[nk]] = val;
          cur += alen + size;
          if (alen > 16) err = TJ_ERR_BADCODE;
          if (size > 0 && nk > 63) err = TJ_ERR_RUN;
          k = size > 0 ? nk + 1 : (run != 15 ? 64 : k + 16);
        }
        dc = pred[ci];
      }
      coef[0] = (int)dc;

      // Dequant (natural order) + islow IDCT: columns, then rows.
      const int* q = q_lane + b * 64;
#pragma unroll
      for (int i = 0; i < 64; ++i) coef[i] = (int)((u32)coef[i] * (u32)q[i]);
#pragma unroll
      for (int c = 0; c < 8; ++c) idct_1d(coef + c, 8, ws + c, 8, 11);
      const int sp = s_blk[b * 4 + 1], dv = s_blk[b * 4 + 2], dh = s_blk[b * 4 + 3];
      const int h = s_comp[sp * 4 + 0], v = s_comp[sp * 4 + 1];
      const int ph = s_comp[sp * 4 + 2], pw = s_comp[sp * 4 + 3];
      uint8_t* dst = planes.p[sp] + ((size_t)img * ph + (size_t)(my * v + dv) * 8) * pw +
                     (size_t)(mx * h + dh) * 8;
      for (int r = 0; r < 8; ++r) {
        int o[8];
        idct_1d(ws + r * 8, 1, o, 1, 18);
        unsigned long long packed = 0ull;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          packed |= (unsigned long long)tj_clamp_u8((int)((u32)o[c] + 128u)) << (8 * c);
        *(unsigned long long*)(dst + (size_t)r * pw) = packed;
      }
    }
  }
  const bool trunc = cur > seg_bits[lane] + 7 && lm > 0;
  err_out[lane] = err | (trunc ? TJ_ERR_TRUNC : 0);
}

extern "C" int tj_wavefront_pixels(const void* bits, int W, int P, const void* seg_bits,
                                   const void* lane_m, const void* lane_q,
                                   const void* lane_meta, int L, const void* tables,
                                   const void* huffval, const void* qsets, const void* blk,
                                   const void* comp, int B, int nq, int n_planes, int mcus_x,
                                   void* p0, void* p1, void* p2, void* p3, void* err,
                                   void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  if (B <= 0 || B > TJ_MAX_B || nq <= 0 || n_planes <= 0 || n_planes > 4 || (P & (P - 1)))
    return (int)cudaErrorInvalidValue;
  Planes planes = {{(uint8_t*)p0, (uint8_t*)p1, (uint8_t*)p2, (uint8_t*)p3}};
  const size_t smem = sizeof(int) * (B * 68 + nq * B * 64 + B * 4 + n_planes * 4) + B * 512;
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  wavefront_pixels_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const u32*)bits, W, P, (const int*)seg_bits, (const int*)lane_m, (const int*)lane_q,
      (const int*)lane_meta, L, (const int*)tables, (const uint8_t*)huffval,
      (const int*)qsets, (const int*)blk, (const int*)comp, B, nq, n_planes, mcus_x, planes,
      (int*)err);
  return (int)cudaGetLastError();
}
