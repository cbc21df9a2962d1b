// Kernels A and 2: baseline Huffman decode, one thread per lane (a restart
// segment, or a piece of a scan cut at a skeleton-scan bit offset). Kernel
// A (tj_wavefront_pixels) fuses dequant + islow IDCT and stores u8 samples
// at their raster positions in the component planes; kernel 2
// (tj_wavefront_coeff) stores each block's 64 zigzag int32 coefficients
// (DC absolute) at its raster block index.
//
// Both replace the Pallas kernel tpujpeg/kernels/wavefront_pallas.py
// _make_kernel (emit="pixels" and emit="coeff", pallas_call in
// run_wavefront). That kernel ran lanes in lockstep [8, K] vector groups
// with every Huffman table baked in as constants and a one-hot word load;
// here each thread walks its own lane with data-dependent control flow,
// reads its row of words from device memory, and takes the tables and
// quantizer sets as runtime data staged in shared memory. The two emits
// share the block decode (decode_block), templated on where it stages the
// AC values: kernel A runs it lane by lane (decode_lane), kernel 2 a warp
// at a time in step (decode_warp_coeff).
//
// What bounds them on the H100: each lane's serial chain of symbols
// (about 477 per lane on the main path), the epilogue's integer work
// (kernel A: about 1,400 operations per block) and, for kernel 2, the 256
// bytes of coefficients it writes per block. Nothing a thread touches may
// go to local memory: with about a thousand threads per SM, a 256-byte
// block and a 256-byte IDCT workspace per thread outgrow L1, and their
// traffic goes to L2. So:
//  * a block's AC values are staged in shared memory as int16. Kernel
//    A's stage is coefficient-major, int16 [63][threads] (thread t's
//    value k at (k - 1) * threads + t: no bank conflicts), with a 64-bit
//    mask of the positions written in place of 64 zeroing stores; its
//    epilogue reads position k of its own column only through a
//    compile-time k, as mask bit ? staged value : 0;
//  * kernel 2's stage is block-major, int16 [threads][64], thread t's
//    value k at t * 64 + (k ^ 2 (t mod 32)): the swizzle puts the 32
//    lanes of a warp on 32 banks for any one k, and leaves each 8-byte
//    chunk of four positions whole (its two words swapped in odd rows).
//    The warp decodes in step, one block position at a time up to its
//    longest lane, and then writes its lanes' finished blocks itself:
//    lanes 0-15 the block of lane 2i and lanes 16-31 that of lane 2i + 1,
//    16 bytes (four positions) a lane, the place and DC from the owner by
//    shuffles and the values from the owner's stage row, which the reader
//    clears behind it (so no mask: a row holds zeros wherever its block
//    has none). Each store instruction then writes four whole 128-byte
//    lines; a lane that wrote its own block from registers touched 32
//    lines per instruction, half a sector each. (A dense int32 slot per
//    lane, copied out with one 256-byte cp.async.bulk, needs no warp
//    convergence but was slower on the main plan: its 32 KB of shared
//    memory per CTA leaves 5 CTAs per SM, too few for the decode chain);
//  * kernel A's epilogue dequantizes and runs both islow passes unrolled
//    in registers (tj_idct_islow_store, kernel 6's too);
//  * the window comes from a two-word register cache (TjWords) that loads
//    one word when the cursor enters the next one;
//  * a 9-bit lookahead table per Huffman table, built by each CTA from the
//    tables it stages, decodes codes of up to 9 bits with one shared load;
//    longer and invalid codes continue the maxcode walk at length 10.
//    Blocks whose tables are equal share one staged copy (lut_of).
//  * the block layout (blk, comp) and the table sharing come by value in
//    the kernel's arguments, and the quantizers are read in zigzag order
//    as the plan holds them, so a launch copies nothing to the card;
//  * kernel A has a second form, wavefront_pixels_kernel_mixed, for a
//    plan over images of several frame sizes that share everything above
//    (one launch for a stream chunk's geometry buckets, each of which
//    alone fills a fraction of a wave): each image's MCU width, and per
//    plane its height, width and byte offset in one flat output per
//    plane, come from a table of TJ_GEOM_WORDS int32 per image, staged in
//    shared memory with the tables. The lane body is one template; its
//    one-geometry instance is the kernel as it was.
//
// Semantics follow the reference exactly, including on corrupt streams:
//  * words past the row read row[w & (P-1)] when that index is < W, else
//    0 (the reference's binary-fold load over a P = 2^ceil(log2 W) row);
//  * a DC code > 15 is BADCODE and decodes as size 0; lanes with an
//    error stop advancing, and their remaining blocks are all-zero (128);
//  * an AC value is stored even on the symbol that raises BADCODE; RUN
//    wins over BADCODE when one symbol raises both;
//  * a lane starts at bit bit0[lane] of its row with its four DC
//    predictors loaded from dc0[lane * 4 + ci] (the reference's bit0_ref
//    and dc0_ref: pieces of a marker-free scan, or of a restart segment
//    over the row cap, cut at skeleton-scan offsets, primed with the
//    absolute predictors there); with null bit0/dc0 every lane starts at
//    bit 0 with zero predictors (restart segments);
//  * TRUNC (cursor past seg_bits + 7, seg_bits counted from the row's
//    first word) is checked once, at the end, and ORed onto the lane's
//    other bits;
//  * dequant and IDCT arithmetic wraps modulo 2^32 like jnp's int32;
//  * AC sizes are at most 15, so every AC value fits the int16 staging
//    (the reference keeps coefficient-mode AC values in 16-bit halves of
//    an int32 too); the absolute DC predictor stays an int32 register.

#include "common.cuh"

#define TJ_MAX_B 10
#define TJ_MAX_LUT 4
#define TJ_WF_THREADS 128
// A mixed launch's geometry table: per image, int32 [TJ_GEOM_WORDS] =
// mcus_x, 3 unused, then per scan component (plane_h, plane_w, byte
// offset / 64 of the image's plane in the component's flat output). At
// most TJ_MAX_GEOM images a launch (16 KB of shared memory).
#define TJ_GEOM_WORDS 16
#define TJ_MAX_GEOM 256

typedef unsigned long long u64;

// Per scan component: u8 planes (kernel A) or int32 coefficient arrays
// (kernel 2).
struct Outputs {
  void* p[4];
};

struct LaneArgs {
  const u32* bits;
  int W, P;
  const int* seg_bits;
  const int* lane_m;
  const int* lane_q;
  const int* lane_meta;
  const int* bit0;         // [L] start bit in the row, or null (0)
  const int* dc0;          // [L][4] primed predictors by frame component, or null (0)
  int L;
  const int* tables;       // [B][2][34] dc/ac maxcode | valoffset
  const uint8_t* huffval;  // [B][2][256]
  const int* qsets;        // [nq][B][64] zigzag order (pixels only)
  int B, nq, n_planes, mcus_x, n_lut;
  int blk[TJ_MAX_B][4];    // (ci, sp, dv, dh) of each block of an MCU
  int comp[4][4];          // (h, v, plane_h, plane_w) per scan component
  int lut_of[TJ_MAX_B];    // the staged table set of each block
  int lut_src[TJ_MAX_LUT]; // a block whose tables are table set u
  int* err_out;
};

// Stage sizes in int16: kernel A's [63][threads], kernel 2's [threads][64].
#define TJ_STAGE_A (63 * TJ_WF_THREADS)
#define TJ_STAGE_2 (64 * TJ_WF_THREADS)
#define TJ_FULL_WARP 0xffffffffu

// Shared memory: stage int16 [kStage], lut u16 [n_lut][2][512], tab int
// [n_lut][68], q int [nq][B][64], blk int [B][4], comp int [n_planes][4],
// lut_of int [B], geom int [n_geom][TJ_GEOM_WORDS] (mixed form only), hv
// u8 [n_lut][2][256].
struct Smem {
  int16_t* stage;
  const uint16_t* lut;
  const int* tab;
  const int* q;
  const int* blk;
  const int* comp;
  const int* lut_of;
  const int* geom;
  const uint8_t* hv;
};

static size_t smem_bytes(int stage, int B, int nq, int n_planes, int n_lut, int n_geom = 0) {
  return sizeof(int16_t) * stage + sizeof(uint16_t) * n_lut * 1024 +
         sizeof(int) * (n_lut * 68 + nq * B * 64 + B * 4 + n_planes * 4 + B +
                        n_geom * TJ_GEOM_WORDS) +
         n_lut * 512;
}

// Stage the tables, quantizers and layout (kMixed: and the n_geom images'
// geometry), then build the lookahead tables from the staged ones. Every
// index into the argument arrays is a compile-time constant.
template <int kStage, bool kMixed = false>
__device__ __forceinline__ Smem stage_smem(const LaneArgs& a, const int* geom = nullptr,
                                           int n_geom = 0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int16_t* s_stage = (int16_t*)smem_raw;
  uint16_t* s_lut = (uint16_t*)(s_stage + kStage);
  int* s_tab = (int*)(s_lut + a.n_lut * 1024);
  int* s_q = s_tab + a.n_lut * 68;
  int* s_blk = s_q + a.nq * a.B * 64;
  int* s_comp = s_blk + a.B * 4;
  int* s_lut_of = s_comp + a.n_planes * 4;
  int* s_geom = s_lut_of + a.B;
  uint8_t* s_hv = (uint8_t*)(s_geom + (kMixed ? n_geom * TJ_GEOM_WORDS : 0));
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < TJ_MAX_LUT; ++u) {
    if (u < a.n_lut) {
      const int src = a.lut_src[u];
      for (int i = tid; i < 68; i += blockDim.x) s_tab[u * 68 + i] = a.tables[src * 68 + i];
      for (int i = tid; i < 512; i += blockDim.x) s_hv[u * 512 + i] = a.huffval[src * 512 + i];
    }
  }
  for (int i = tid; i < a.nq * a.B * 64; i += blockDim.x) s_q[i] = a.qsets[i];
  if (kMixed)
    for (int i = tid; i < n_geom * TJ_GEOM_WORDS; i += blockDim.x) s_geom[i] = geom[i];
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < TJ_MAX_B; ++b) {
      if (b < a.B) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s_blk[b * 4 + j] = a.blk[b][j];
        s_lut_of[b] = a.lut_of[b];
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < a.n_planes) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s_comp[s * 4 + j] = a.comp[s][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < a.n_lut * 1024; i += blockDim.x) {
    const int t = i >> 9;  // u * 2 + (0 dc, 1 ac)
    const int* tb = s_tab + (t >> 1) * 68 + (t & 1) * 34;
    s_lut[i] = tj_lookahead_entry(i & 511, tb, tb + 17, s_hv + t * 256);
  }
  __syncthreads();
  return Smem{s_stage, s_lut, s_tab, s_q, s_blk, s_comp, s_lut_of, s_geom, s_hv};
}

// Where the block decode stages AC value k (1..63). Kernel A: its
// thread's column of the coefficient-major stage, and a mask of the
// positions written (the column is never cleared).
struct StageColumn {
  int16_t* st;  // sm.stage + threadIdx.x
  u64 nzm;
  __device__ __forceinline__ void put(int k, int val) {
    st[(k - 1) * TJ_WF_THREADS] = (int16_t)val;
    nzm |= 1ull << k;
  }
};

// Kernel 2: its thread's row of the block-major stage, swizzled. The row
// is all zeros when a block's decode starts (the warp store clears what
// it reads), so no mask is kept.
struct StageRow {
  int16_t* row;  // sm.stage + threadIdx.x * 64
  int swz;       // 2 * (threadIdx.x % 32)
  __device__ __forceinline__ void put(int k, int val) { row[k ^ swz] = (int16_t)val; }
};

// Zigzag position k (1..63, a compile-time constant) of kernel A's staged
// block.
__device__ __forceinline__ int staged(const int16_t* st, u64 nzm, int k) {
  return (nzm >> k) & 1ull ? (int)st[(k - 1) * TJ_WF_THREADS] : 0;
}

// The staged tables of block position b and its frame component.
struct BlockTables {
  const int* tb;         // dc maxcode | valoffset, then ac
  const uint8_t* hv;     // dc, then ac symbols
  const uint16_t* lut;   // dc, then ac lookahead
  int ci;
};

__device__ __forceinline__ BlockTables block_tables(const Smem& sm, int b) {
  const int u = sm.lut_of[b];
  return BlockTables{sm.tab + u * 68, sm.hv + u * 512, sm.lut + u * 1024, sm.blk[b * 4 + 0]};
}

// Decode one block at the lane's cursor: the DC symbol, EXTEND and the
// predictor, then AC symbols until EOB, k = 64 or an error, each nonzero
// AC value k into stage.put(k, value); returns the absolute DC. Sets err
// on BADCODE or RUN; callers run it only while err is 0.
template <class Stage>
__device__ __forceinline__ u32 decode_block(const BlockTables& bt, Stage& stage, TjWords& words,
                                            int& cur, int& err, u32& pred0, u32& pred1,
                                            u32& pred2, u32& pred3) {
  const int* tb = bt.tb;
  const uint8_t* hv = bt.hv;
  const uint16_t* lut = bt.lut;
  const int ci = bt.ci;
  // DC symbol, EXTEND, predictor.
  u32 win = words.window(cur);
  int t, dlen;
  tj_decode_lookahead(win, lut, tb, tb + 17, hv, t, dlen);
  const bool bad = dlen > 16 || t > 15;
  if (t > 15) t = 0;
  u32 p = ci == 0 ? pred0 : (ci == 1 ? pred1 : (ci == 2 ? pred2 : pred3));
  p += (u32)tj_receive_extend(win, dlen, t);
  pred0 = ci == 0 ? p : pred0;
  pred1 = ci == 1 ? p : pred1;
  pred2 = ci == 2 ? p : pred2;
  pred3 = ci >= 3 ? p : pred3;
  cur += dlen + t;
  if (bad) err = TJ_ERR_BADCODE;
  // AC symbols until EOB, k = 64 or an error.
  int k = 1;
  while (k < 64 && err == 0) {
    win = words.window(cur);
    int rs, alen;
    tj_decode_lookahead(win, lut + 512, tb + 34, tb + 51, hv + 256, rs, alen);
    const int run = rs >> 4, size = rs & 15;
    const int val = tj_receive_extend(win, alen, size);
    const int nk = k + (size > 0 ? run : 0);
    if (size > 0 && nk <= 63) stage.put(nk, val);
    cur += alen + size;
    if (alen > 16) err = TJ_ERR_BADCODE;
    if (size > 0 && nk > 63) err = TJ_ERR_RUN;
    k = size > 0 ? nk + 1 : (run != 15 ? 64 : k + 16);
  }
  return p;
}

// The block's output (plane or coefficient array), block row and column.
__device__ __forceinline__ void* block_place(const Smem& sm, const Outputs& out, int b, int my,
                                             int mx, int& sp, int& brow, int& bcol) {
  sp = sm.blk[b * 4 + 1];
  const int dv = sm.blk[b * 4 + 2], dh = sm.blk[b * 4 + 3];
  const int h = sm.comp[sp * 4 + 0], v = sm.comp[sp * 4 + 1];
  brow = my * v + dv;
  bcol = mx * h + dh;
  return sp == 0 ? out.p[0] : (sp == 1 ? out.p[1] : (sp == 2 ? out.p[2] : out.p[3]));
}

// Kernel A's epilogue: dequant + islow IDCT in registers, u8 samples into
// planes[sp][img] at the block's raster position; kMixed: into the flat
// planes[sp] at the image's offset, rows of the image's plane width.
struct PixelsEpi {
  Outputs planes;
  int B;
  int lane_qset;
  template <bool kMixed>
  __device__ __forceinline__ void store(const Smem& sm, int img, int b, int my, int mx,
                                        const int16_t* st, u64 nzm, u32 dc) const {
    const int* q = sm.q + (lane_qset * B + b) * 64;  // zigzag order
    int sp, brow, bcol;
    uint8_t* plane = (uint8_t*)block_place(sm, planes, b, my, mx, sp, brow, bcol);
    size_t pw;
    uint8_t* dst;
    if (kMixed) {
      const int* gs = sm.geom + img * TJ_GEOM_WORDS + 4 + sp * 3;  // (plane_h, plane_w, offset / 64)
      pw = (size_t)gs[1];
      dst = plane + (size_t)(u32)gs[2] * 64 + (size_t)brow * 8 * pw + (size_t)bcol * 8;
    } else {
      const int ph = sm.comp[sp * 4 + 2];
      pw = (size_t)sm.comp[sp * 4 + 3];
      dst = plane + ((size_t)img * ph + (size_t)brow * 8) * pw + (size_t)bcol * 8;
    }
    auto coef = [&](int n) -> int {
      const int k = tj_natural_to_zigzag(n);
      const u32 c = k == 0 ? dc : (u32)staged(st, nzm, k);
      return (int)(c * (u32)q[k]);
    };
    tj_idct_islow_store(coef, dst, pw);
  }
};

// A lane's DC predictors by frame component at its start: dc0's, or zeros
// (restart lanes).
__device__ __forceinline__ void start_preds(const LaneArgs& a, int lane, u32& pred0, u32& pred1,
                                            u32& pred2, u32& pred3) {
  pred0 = pred1 = pred2 = pred3 = 0u;
  if (a.dc0) {
    const int4 d = *(const int4*)(a.dc0 + (size_t)lane * 4);
    pred0 = (u32)d.x;
    pred1 = (u32)d.y;
    pred2 = (u32)d.z;
    pred3 = (u32)d.w;
  }
}

// Kernel A: decode every block of one lane and run the epilogue on each.
// A lane with an error stops advancing; its remaining blocks have all-zero
// coefficients. kMixed: the MCU width is the lane's image's.
template <bool kMixed>
__device__ __forceinline__ void decode_lane(const LaneArgs& a, const Smem& sm, const PixelsEpi& epi,
                                            int lane) {
  int cur = a.bit0 ? a.bit0[lane] : 0;
  TjWords words(a.bits + (size_t)lane * a.W, a.W, a.P, cur >> 5);
  const int img = a.lane_meta[lane * 3 + 0];
  const int first = a.lane_meta[lane * 3 + 1];
  const int lm = a.lane_m[lane];
  const int mcus_x = kMixed ? sm.geom[img * TJ_GEOM_WORDS] : a.mcus_x;
  int16_t* st = sm.stage + threadIdx.x;

  int err = 0;
  u32 pred0, pred1, pred2, pred3;  // per frame component
  start_preds(a, lane, pred0, pred1, pred2, pred3);

  for (int m = 0; m < lm; ++m) {
    const int g = first + m;
    const int my = g / mcus_x;
    const int mx = g - my * mcus_x;
    for (int b = 0; b < a.B; ++b) {
      const BlockTables bt = block_tables(sm, b);
      StageColumn stage{st, 0ull};
      u32 dc = 0u;
      if (err == 0) dc = decode_block(bt, stage, words, cur, err, pred0, pred1, pred2, pred3);
      epi.store<kMixed>(sm, img, b, my, mx, st, stage.nzm, dc);
    }
  }
  const bool trunc = cur > a.seg_bits[lane] + 7 && lm > 0;
  a.err_out[lane] = err | (trunc ? TJ_ERR_TRUNC : 0);
}

// Kernel 2: the warp decodes in step and writes its lanes' blocks itself.
// Every lane of the warp runs the block loop to the warp's longest lane,
// so the shuffles and __syncwarp below see all 32: a lane past its own
// MCUs, or past L, decodes nothing and has no block (its bit of `has` is
// 0); a lane with an error stops advancing, and its remaining blocks are
// all-zero (DC 0, nothing staged) and are written. Then, per block
// position, the warp writes its blocks in pairs: for pair i, lanes 0-15
// write the block of lane 2i and lanes 16-31 that of lane 2i + 1, lane j
// of a half positions 4j .. 4j+3 as one int4, the DC at position 0. The
// owner's block index and DC come by shuffle and the values from chunk
// j ^ i of the owner's stage row (its words swapped in odd rows); the
// reader clears the chunk, so every row is all zeros again for the next
// block. A block index fits 32 bits: the coefficient arrays of one
// launch hold far fewer than 2^32 blocks.
__device__ __forceinline__ void decode_warp_coeff(const LaneArgs& a, const Smem& sm,
                                                  const Outputs& out) {
  const int tid = threadIdx.x;
  const int wl = tid & 31;  // lane of the warp
  const int lane = blockIdx.x * blockDim.x + tid;
  const bool live = lane < a.L;
  const int ln = live ? lane : a.L - 1;  // a lane past L reads lane L - 1's inputs
  const int lm = live ? a.lane_m[ln] : 0;
  const int wm = __reduce_max_sync(TJ_FULL_WARP, (unsigned)lm);
  int cur = a.bit0 ? a.bit0[ln] : 0;
  TjWords words(a.bits + (size_t)ln * a.W, a.W, a.P, cur >> 5);
  const int img = a.lane_meta[ln * 3 + 0];
  const int first = a.lane_meta[ln * 3 + 1];
  StageRow stage{sm.stage + tid * 64, wl << 1};
#pragma unroll
  for (int i = 0; i < 8; ++i) ((int4*)stage.row)[i] = make_int4(0, 0, 0, 0);
  int16_t* wrows = sm.stage + (tid - wl) * 64;  // the warp's 32 rows
  const int half = wl >> 4, j = wl & 15;

  int err = 0;
  u32 pred0, pred1, pred2, pred3;  // per frame component
  start_preds(a, ln, pred0, pred1, pred2, pred3);

  for (int m = 0; m < wm; ++m) {
    const bool mine = m < lm;
    const u32 has = __ballot_sync(TJ_FULL_WARP, mine);
    const int g = first + m;
    const int my = g / a.mcus_x;
    const int mx = g - my * a.mcus_x;
    for (int b = 0; b < a.B; ++b) {
      u32 dc = 0u;
      if (mine && err == 0)
        dc = decode_block(block_tables(sm, b), stage, words, cur, err, pred0, pred1, pred2, pred3);
      int sp, brow, bcol;
      int4* base = (int4*)block_place(sm, out, b, my, mx, sp, brow, bcol);
      const int phb = sm.comp[sp * 4 + 2] >> 3, pwb = sm.comp[sp * 4 + 3] >> 3;
      const u32 bidx = ((u32)img * (u32)phb + (u32)brow) * (u32)pwb + (u32)bcol;
      __syncwarp();  // every stage row of this block position is written
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int src = 2 * i + half;
        const u32 o_bidx = __shfl_sync(TJ_FULL_WARP, bidx, src);
        const u32 o_dc = __shfl_sync(TJ_FULL_WARP, dc, src);
        uint2* chunk = (uint2*)(wrows + src * 64 + 4 * (j ^ i));
        const uint2 w = *chunk;
        *chunk = make_uint2(0u, 0u);
        const u32 p01 = half ? w.y : w.x, p23 = half ? w.x : w.y;
        const int4 c = make_int4(j == 0 ? (int)o_dc : (int)(p01 << 16) >> 16, (int)p01 >> 16,
                                 (int)(p23 << 16) >> 16, (int)p23 >> 16);
        if ((has >> src) & 1u) base[(size_t)o_bidx * 16 + j] = c;
      }
      __syncwarp();  // every stage row is read and cleared before the next decode
    }
  }
  if (live) {
    const bool trunc = cur > a.seg_bits[lane] + 7 && lm > 0;
    a.err_out[lane] = err | (trunc ? TJ_ERR_TRUNC : 0);
  }
}

__global__ void __launch_bounds__(TJ_WF_THREADS) wavefront_pixels_kernel(LaneArgs a,
                                                                         Outputs planes) {
  const Smem sm = stage_smem<TJ_STAGE_A>(a);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  PixelsEpi epi{planes, a.B, a.lane_q[lane]};
  decode_lane<false>(a, sm, epi, lane);
}

// Kernel A over images of several frame sizes: geom holds n_geom images'
// rows of TJ_GEOM_WORDS, lane_meta's image indexes them, and planes are the
// flat outputs, one per scan component.
__global__ void __launch_bounds__(TJ_WF_THREADS) wavefront_pixels_kernel_mixed(LaneArgs a,
                                                                               Outputs planes,
                                                                               const int* geom,
                                                                               int n_geom) {
  const Smem sm = stage_smem<TJ_STAGE_A, true>(a, geom, n_geom);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  PixelsEpi epi{planes, a.B, a.lane_q[lane]};
  decode_lane<true>(a, sm, epi, lane);
}

__global__ void __launch_bounds__(TJ_WF_THREADS) wavefront_coeff_kernel(LaneArgs a,
                                                                        Outputs coeff) {
  const Smem sm = stage_smem<TJ_STAGE_2>(a);
  decode_warp_coeff(a, sm, coeff);
}

// blk ([B][4]), comp ([n_planes][4]) and lut_of ([B]) are host int32
// arrays, read here into the kernel's arguments; every other pointer is a
// device pointer.
static int launch(bool pixels, const void* bits, int W, int P, const void* seg_bits,
                  const void* lane_m, const void* lane_q, const void* lane_meta,
                  const void* bit0, const void* dc0, int L,
                  const void* tables, const void* huffval, const void* qsets, const int* blk,
                  const int* comp, const int* lut_of, int B, int nq, int n_planes, int mcus_x,
                  const void* geom, int n_geom, void* p0, void* p1, void* p2, void* p3,
                  void* err, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  if (B <= 0 || B > TJ_MAX_B || (pixels && nq <= 0) || n_planes <= 0 || n_planes > 4 ||
      mcus_x <= 0 || W <= 0 || P < W || (P & (P - 1)) || (dc0 && ((uintptr_t)dc0 & 15)) ||
      (geom && (!pixels || n_geom <= 0 || n_geom > TJ_MAX_GEOM)))
    return (int)cudaErrorInvalidValue;
  if (!geom) n_geom = 0;
  if (!pixels) nq = 0;
  LaneArgs a{};
  a.bits = (const u32*)bits;
  a.W = W;
  a.P = P;
  a.seg_bits = (const int*)seg_bits;
  a.lane_m = (const int*)lane_m;
  a.lane_q = (const int*)lane_q;
  a.lane_meta = (const int*)lane_meta;
  a.bit0 = (const int*)bit0;
  a.dc0 = (const int*)dc0;
  a.L = L;
  a.tables = (const int*)tables;
  a.huffval = (const uint8_t*)huffval;
  a.qsets = (const int*)qsets;
  a.B = B;
  a.nq = nq;
  a.n_planes = n_planes;
  a.mcus_x = mcus_x;
  a.err_out = (int*)err;
  for (int u = 0; u < TJ_MAX_LUT; ++u) a.lut_src[u] = -1;
  for (int b = 0; b < B; ++b) {
    for (int j = 0; j < 4; ++j) a.blk[b][j] = blk[b * 4 + j];
    const int u = lut_of[b];
    if (a.blk[b][0] < 0 || a.blk[b][0] > 3 || a.blk[b][1] < 0 || a.blk[b][1] >= n_planes ||
        u < 0 || u >= TJ_MAX_LUT)
      return (int)cudaErrorInvalidValue;
    a.lut_of[b] = u;
    if (a.lut_src[u] < 0) a.lut_src[u] = b;
    if (u + 1 > a.n_lut) a.n_lut = u + 1;
  }
  for (int u = 0; u < a.n_lut; ++u)
    if (a.lut_src[u] < 0) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < n_planes; ++s)
    for (int j = 0; j < 4; ++j) a.comp[s][j] = comp[s * 4 + j];
  Outputs out = {{p0, p1, p2, p3}};
  const size_t smem = smem_bytes(pixels ? TJ_STAGE_A : TJ_STAGE_2, B, nq, n_planes, a.n_lut, n_geom);
  const int blocks = (L + TJ_WF_THREADS - 1) / TJ_WF_THREADS;
  if (geom) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(wavefront_pixels_kernel_mixed,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    wavefront_pixels_kernel_mixed<<<blocks, TJ_WF_THREADS, smem, (cudaStream_t)stream>>>(
        a, out, (const int*)geom, n_geom);
  } else if (pixels) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(wavefront_pixels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    wavefront_pixels_kernel<<<blocks, TJ_WF_THREADS, smem, (cudaStream_t)stream>>>(a, out);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(wavefront_coeff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    wavefront_coeff_kernel<<<blocks, TJ_WF_THREADS, smem, (cudaStream_t)stream>>>(a, out);
  }
  return (int)cudaGetLastError();
}

// Kernel A. qsets: int32 [nq][B][64] zigzag-order quantizer sets, lane_q
// each lane's set; bit0 (int32 [L]) and dc0 (int32 [L][4], 16-byte
// aligned) each lane's start bit and primed DC predictors, or null for
// restart lanes; p0..p3: u8 [N, plane_h, plane_w] planes of the scan's
// components. With geom (device int32 [n_geom][TJ_GEOM_WORDS], 1 <= n_geom
// <= TJ_MAX_GEOM) the mixed form runs: comp gives only (h, v), mcus_x is
// ignored, and p0..p3 are flat u8 outputs holding each image's plane at
// its offset.
extern "C" int tj_wavefront_pixels(const void* bits, int W, int P, const void* seg_bits,
                                   const void* lane_m, const void* lane_q,
                                   const void* lane_meta, const void* bit0, const void* dc0,
                                   int L, const void* tables, const void* huffval,
                                   const void* qsets, const int* blk, const int* comp,
                                   const int* lut_of, int B, int nq, int n_planes, int mcus_x,
                                   const void* geom, int n_geom, void* p0, void* p1, void* p2,
                                   void* p3, void* err, void* stream) {
  return launch(true, bits, W, P, seg_bits, lane_m, lane_q, lane_meta, bit0, dc0, L, tables,
                huffval, qsets, blk, comp, lut_of, B, nq, n_planes, mcus_x, geom, n_geom, p0, p1,
                p2, p3, err, stream);
}

// Kernel 2: as tj_wavefront_pixels without quantizers (bit0 and dc0 as
// there); c0..c3 are the int32 [N, padded_hb * padded_wb, 64] coefficient
// arrays of the scan's components (comp's plane_h and plane_w are 8x the
// padded block grid), each on a 16-byte boundary.
extern "C" int tj_wavefront_coeff(const void* bits, int W, int P, const void* seg_bits,
                                  const void* lane_m, const void* lane_meta, const void* bit0,
                                  const void* dc0, int L, const void* tables,
                                  const void* huffval, const int* blk, const int* comp,
                                  const int* lut_of, int B, int n_planes, int mcus_x, void* c0,
                                  void* c1, void* c2, void* c3, void* err, void* stream) {
  return launch(false, bits, W, P, seg_bits, lane_m, nullptr, lane_meta, bit0, dc0, L, tables,
                huffval, nullptr, blk, comp, lut_of, B, 0, n_planes, mcus_x, nullptr, 0, c0, c1, c2,
                c3, err, stream);
}

// Resident CTAs per SM of kernel A (pixels != 0) or kernel 2 at the
// dynamic shared memory a launch with B blocks per MCU, nq quantizer sets
// (kernel A), n_planes planes and n_lut table sets asks for; *smem gets
// those bytes. For timing tools: launches nothing.
extern "C" int tj_wavefront_occupancy(int pixels, int B, int nq, int n_planes, int n_lut,
                                      int* ctas, int* smem) {
  const size_t bytes =
      smem_bytes(pixels ? TJ_STAGE_A : TJ_STAGE_2, B, pixels ? nq : 0, n_planes, n_lut);
  const void* fn =
      pixels ? (const void*)wavefront_pixels_kernel : (const void*)wavefront_coeff_kernel;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, TJ_WF_THREADS, bytes);
}

// Resident CTAs per SM of kernel A's mixed form at the dynamic shared memory
// a launch over n_geom images with B blocks per MCU, nq quantizer sets,
// n_planes planes and n_lut table sets asks for; *smem gets those bytes.
extern "C" int tj_wavefront_occupancy_mixed(int B, int nq, int n_planes, int n_lut, int n_geom,
                                            int* ctas, int* smem) {
  const size_t bytes = smem_bytes(TJ_STAGE_A, B, nq, n_planes, n_lut, n_geom);
  const void* fn = (const void*)wavefront_pixels_kernel_mixed;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, TJ_WF_THREADS, bytes);
}
