// Kernels A and 2: baseline Huffman decode, one thread per lane (restart
// segment). Kernel A (tj_wavefront_pixels) fuses dequant + islow IDCT and
// stores u8 samples at their raster positions in the component planes;
// kernel 2 (tj_wavefront_coeff) stores each block's 64 zigzag int32
// coefficients (DC absolute) at its raster block index.
//
// Both replace the Pallas kernel tpujpeg/kernels/wavefront_pallas.py
// _make_kernel (emit="pixels" and emit="coeff", pallas_call in
// run_wavefront). That kernel ran lanes in lockstep [8, K] vector groups
// with every Huffman table baked in as constants and a one-hot word load;
// here each thread walks its own lane with data-dependent control flow,
// reads its row of words from device memory, and takes the tables and
// quantizer sets as runtime data staged in shared memory. The two emits
// share one decode loop (decode_lane), templated on the epilogue, and
// take the word load, window, symbol decode and EXTEND from common.cuh,
// as the progressive kernels of prog.cu do. The reference's coefficient
// emit needed an assembly pass of transposes after the kernel, which the
// raster-index stores here make unnecessary.
//
// What bounds them on the H100: the per-symbol dependency chain (window,
// 16 maxcode compares, huffval lookup, cursor update) of each thread, and
// warp divergence between lanes whose blocks hold different numbers of
// symbols. Kernel A moves few bytes (the compressed rows plus the u8
// planes); kernel 2 writes 256 bytes of coefficients per block, 16x the
// pixels, but still spends its time in the chain. The design keeps
// everything per lane in registers and local memory and never leaves a
// lane's thread, so the only cost beyond the chain is the divergence;
// reducing that (lane sorting, warp-cooperative decode) is later work.
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
//  * dequant and IDCT arithmetic wraps modulo 2^32 like jnp's int32;
//  * the reference keeps coefficient-mode AC values in 16-bit halves of an
//    int32; AC sizes are at most 15, so each value fits and the full int32
//    stored here is the same number.

#include "common.cuh"

#define TJ_MAX_B 10

// ZIGZAG[k]: natural index of the k-th zigzag coefficient (T.81 A.6).
static __constant__ int8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

// Per scan component: u8 planes (kernel A) or int32 coefficient arrays
// (kernel 2).
struct Outputs {
  void* p[4];
};

// Shared memory: tables [B][2][34] int, qsets [nq][B][64] int (natural
// order, pixels only), blk [B][4] int, comp [n_planes][4] int, huffval
// [B][2][256] u8.
struct LaneArgs {
  const u32* bits;
  int W, P;
  const int* seg_bits;
  const int* lane_m;
  const int* lane_q;
  const int* lane_meta;
  int L;
  const int* tables;
  const uint8_t* huffval;
  const int* qsets;
  const int* blk;
  const int* comp;
  int B, nq, n_planes, mcus_x;
  int* err_out;
};

struct Smem {
  const int* tab;
  const int* q;
  const int* blk;
  const int* comp;
  const uint8_t* hv;
  const int8_t* zz;
};

__device__ __forceinline__ Smem stage_smem(const LaneArgs& a, int nq) {
  extern __shared__ int smem[];
  __shared__ int8_t s_zz[64];
  int* s_tab = smem;
  int* s_q = s_tab + a.B * 68;
  int* s_blk = s_q + nq * a.B * 64;
  int* s_comp = s_blk + a.B * 4;
  uint8_t* s_hv = (uint8_t*)(s_comp + a.n_planes * 4);
  for (int i = threadIdx.x; i < a.B * 68; i += blockDim.x) s_tab[i] = a.tables[i];
  for (int i = threadIdx.x; i < nq * a.B * 64; i += blockDim.x) s_q[i] = a.qsets[i];
  for (int i = threadIdx.x; i < a.B * 4; i += blockDim.x) s_blk[i] = a.blk[i];
  for (int i = threadIdx.x; i < a.n_planes * 4; i += blockDim.x) s_comp[i] = a.comp[i];
  for (int i = threadIdx.x; i < a.B * 512; i += blockDim.x) s_hv[i] = a.huffval[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s_zz[i] = kZigzag[i];
  __syncthreads();
  return Smem{s_tab, s_q, s_blk, s_comp, s_hv, s_zz};
}

// Decode every block of one lane; for each, Epi::store(sm, lane, img, b,
// my, mx, coef) gets the finished block: natural order when
// Epi::kNatural, else zigzag, with coef[0] the absolute DC.
template <class Epi>
__device__ __forceinline__ void decode_lane(const LaneArgs& a, const Smem& sm, const Epi& epi,
                                            int lane) {
  const u32* row = a.bits + (size_t)lane * a.W;
  const int W = a.W, P = a.P;
  const int img = a.lane_meta[lane * 3 + 0];
  const int first = a.lane_meta[lane * 3 + 1];
  const int lm = a.lane_m[lane];

  int cur = 0;
  int err = 0;
  u32 pred[4] = {0u, 0u, 0u, 0u};
  int coef[64];

  for (int m = 0; m < lm; ++m) {
    const int g = first + m;
    const int my = g / a.mcus_x;
    const int mx = g - my * a.mcus_x;
    for (int b = 0; b < a.B; ++b) {
      const int* tb = sm.tab + b * 68;
      const uint8_t* hv = sm.hv + b * 512;
      const int ci = sm.blk[b * 4 + 0];
#pragma unroll
      for (int i = 0; i < 64; ++i) coef[i] = 0;
      u32 dc = 0u;
      if (err == 0) {
        // DC symbol, EXTEND, predictor.
        u32 win = tj_window(row, cur, W, P);
        int t, dlen;
        tj_decode_symbol(win, tb, tb + 17, hv, t, dlen);
        const bool bad = dlen > 16 || t > 15;
        if (t > 15) t = 0;
        pred[ci] += (u32)tj_receive_extend(win, dlen, t);
        cur += dlen + t;
        if (bad) err = TJ_ERR_BADCODE;
        // AC symbols until EOB, k = 64 or an error.
        int k = 1;
        while (k < 64 && err == 0) {
          win = tj_window(row, cur, W, P);
          int rs, alen;
          tj_decode_symbol(win, tb + 34, tb + 51, hv + 256, rs, alen);
          const int run = rs >> 4, size = rs & 15;
          const int val = tj_receive_extend(win, alen, size);
          const int nk = k + (size > 0 ? run : 0);
          if (size > 0 && nk <= 63) coef[Epi::kNatural ? sm.zz[nk] : nk] = val;
          cur += alen + size;
          if (alen > 16) err = TJ_ERR_BADCODE;
          if (size > 0 && nk > 63) err = TJ_ERR_RUN;
          k = size > 0 ? nk + 1 : (run != 15 ? 64 : k + 16);
        }
        dc = pred[ci];
      }
      coef[0] = (int)dc;
      epi.store(sm, lane, img, b, my, mx, coef);
    }
  }
  const bool trunc = cur > a.seg_bits[lane] + 7 && lm > 0;
  a.err_out[lane] = err | (trunc ? TJ_ERR_TRUNC : 0);
}

// The block's (plane or coefficient array, block row, block column).
__device__ __forceinline__ void block_place(const Smem& sm, int b, int my, int mx, int& sp,
                                            int& brow, int& bcol) {
  sp = sm.blk[b * 4 + 1];
  const int dv = sm.blk[b * 4 + 2], dh = sm.blk[b * 4 + 3];
  const int h = sm.comp[sp * 4 + 0], v = sm.comp[sp * 4 + 1];
  brow = my * v + dv;
  bcol = mx * h + dh;
}

// Kernel A's epilogue: dequant (natural order) + islow IDCT, u8 samples
// into planes[sp][img] at the block's raster position.
struct PixelsEpi {
  static constexpr bool kNatural = true;
  Outputs planes;
  int B;
  int lane_qset;
  __device__ __forceinline__ void store(const Smem& sm, int lane, int img, int b, int my, int mx,
                                        int* coef) const {
    const int* q = sm.q + (size_t)lane_qset * B * 64 + b * 64;
#pragma unroll
    for (int i = 0; i < 64; ++i) coef[i] = (int)((u32)coef[i] * (u32)q[i]);
    int sp, brow, bcol;
    block_place(sm, b, my, mx, sp, brow, bcol);
    const int ph = sm.comp[sp * 4 + 2], pw = sm.comp[sp * 4 + 3];
    uint8_t* dst = (uint8_t*)planes.p[sp] + ((size_t)img * ph + (size_t)brow * 8) * pw +
                   (size_t)bcol * 8;
    tj_idct_islow_store(coef, dst, (size_t)pw);
  }
};

// Kernel 2's epilogue: the zigzag block, DC absolute, into
// coeff[sp][img, brow * padded_wb + bcol, :].
struct CoeffEpi {
  static constexpr bool kNatural = false;
  Outputs coeff;
  __device__ __forceinline__ void store(const Smem& sm, int, int img, int b, int my, int mx,
                                        int* coef) const {
    int sp, brow, bcol;
    block_place(sm, b, my, mx, sp, brow, bcol);
    const int phb = sm.comp[sp * 4 + 2] >> 3, pwb = sm.comp[sp * 4 + 3] >> 3;
    int4* dst = (int4*)((int*)coeff.p[sp] +
                        (((size_t)img * phb + brow) * pwb + bcol) * 64);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dst[i] = make_int4(coef[4 * i], coef[4 * i + 1], coef[4 * i + 2], coef[4 * i + 3]);
  }
};

__global__ void wavefront_pixels_kernel(LaneArgs a, Outputs planes) {
  const Smem sm = stage_smem(a, a.nq);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  PixelsEpi epi{planes, a.B, a.lane_q[lane]};
  decode_lane(a, sm, epi, lane);
}

__global__ void wavefront_coeff_kernel(LaneArgs a, Outputs coeff) {
  const Smem sm = stage_smem(a, 0);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  CoeffEpi epi{coeff};
  decode_lane(a, sm, epi, lane);
}

static int launch(bool pixels, const void* bits, int W, int P, const void* seg_bits,
                  const void* lane_m, const void* lane_q, const void* lane_meta, int L,
                  const void* tables, const void* huffval, const void* qsets, const void* blk,
                  const void* comp, int B, int nq, int n_planes, int mcus_x, void* p0, void* p1,
                  void* p2, void* p3, void* err, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  if (B <= 0 || B > TJ_MAX_B || (pixels && nq <= 0) || n_planes <= 0 || n_planes > 4 ||
      (P & (P - 1)))
    return (int)cudaErrorInvalidValue;
  if (!pixels) nq = 0;
  LaneArgs a{(const u32*)bits, W, P, (const int*)seg_bits, (const int*)lane_m,
             (const int*)lane_q, (const int*)lane_meta, L, (const int*)tables,
             (const uint8_t*)huffval, (const int*)qsets, (const int*)blk, (const int*)comp,
             B, nq, n_planes, mcus_x, (int*)err};
  Outputs out = {{p0, p1, p2, p3}};
  const size_t smem = sizeof(int) * (B * 68 + nq * B * 64 + B * 4 + n_planes * 4) + B * 512;
  const int threads = 128;
  const int blocks = (L + threads - 1) / threads;
  if (pixels)
    wavefront_pixels_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a, out);
  else
    wavefront_coeff_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}

extern "C" int tj_wavefront_pixels(const void* bits, int W, int P, const void* seg_bits,
                                   const void* lane_m, const void* lane_q,
                                   const void* lane_meta, int L, const void* tables,
                                   const void* huffval, const void* qsets, const void* blk,
                                   const void* comp, int B, int nq, int n_planes, int mcus_x,
                                   void* p0, void* p1, void* p2, void* p3, void* err,
                                   void* stream) {
  return launch(true, bits, W, P, seg_bits, lane_m, lane_q, lane_meta, L, tables, huffval, qsets,
                blk, comp, B, nq, n_planes, mcus_x, p0, p1, p2, p3, err, stream);
}

// Kernel 2: as tj_wavefront_pixels without quantizers; c0..c3 are the
// int32 [N, padded_hb * padded_wb, 64] coefficient arrays of the scan's
// components (comp's plane_h and plane_w are 8x the padded block grid).
extern "C" int tj_wavefront_coeff(const void* bits, int W, int P, const void* seg_bits,
                                  const void* lane_m, const void* lane_meta, int L,
                                  const void* tables, const void* huffval, const void* blk,
                                  const void* comp, int B, int n_planes, int mcus_x, void* c0,
                                  void* c1, void* c2, void* c3, void* err, void* stream) {
  return launch(false, bits, W, P, seg_bits, lane_m, nullptr, lane_meta, L, tables, huffval,
                nullptr, blk, comp, B, 0, n_planes, mcus_x, c0, c1, c2, c3, err, stream);
}
