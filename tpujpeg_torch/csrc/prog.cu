// Kernels 7, 8 and 9: the progressive scan kinds of T.81 §G that carry
// Huffman symbols, one thread per lane (restart segment), applied in
// place to a batch's coefficient state. Kernel 7 (tj_prog_dc_first)
// decodes DC first passes and stores pred << Al into the DC columns;
// kernel 8 (tj_prog_ac_first) decodes AC first passes over Ss..Se with
// EOB runs carried from block to block and adds val << Al into the band;
// kernel 9 (tj_prog_ac_refine) applies AC successive-approximation
// refinement (G.1.2.3) to the band of each block. DC refinement needs no
// kernel: its bits sit at fixed positions, so the host unpacks them into
// masks and the device ORs them in (kernels/wavefront_prog.py).
//
// They replace the Pallas kernels of tpujpeg/kernels/wavefront_prog.py:
// _make_dc_first_kernel (pallas_call in _run_dc_first),
// _make_ac_first_kernel (_run_ac_first) and _make_ac_refine_kernel
// (_run_ac_refine). Those ran lanes in lockstep [8, K] vector groups, one
// MCU per grid step, with the tables baked in (or as SMEM scalars), and
// wrote [G, M, B|64, 8, K] lane-layout blocks that the host code then
// converted to per-image grids (_flat_lanes, _scatter_dc_s,
// _grids_to_lanes_s, .at[].add/.set). Here each thread walks its own lane
// with data-dependent control flow, reads its row of words from device
// memory, takes the tables as runtime data staged in shared memory, and
// places each block at its raster index from the lane's first MCU (MCU g
// -> block row (g / mcus_x) * v + dv, column (g % mcus_x) * h + dh; a
// one-component scan walks blocks over width_blocks, so a padded grid's
// pad blocks are never touched). The state is per frame component int32
// [N, padded_blocks, 64] zigzag AC (column 0 left 0) and int32
// [N, padded_blocks] DC, which pipeline.transform_batch takes as is.
//
// Kernel 9 is the reference's closed-form band machine (cumsums over the
// 64 rows, rank chunks of 32 correction bits) in its serial form: the
// band's nonzero pattern is a 64-bit mask, the stop of a (run, size)
// symbol is the (r+1)-th zero at or after k (the 16th for ZRL), found by
// clearing low set bits, and the nonzeros before it take one correction
// bit each, in k order, from the cursor. Correction bits are consumed in
// k order whatever the chunking, so the two forms read the same bits.
//
// What bounds them on the H100: as for kernel A, the per-symbol dependency
// chain of each thread (window, table lookup, cursor update) and warp
// divergence between lanes of unequal length. Lanes are short (a few to a
// few dozen symbols each, rows 128 bytes apart), so memory latency per
// symbol and per-CTA set-up weigh more than arithmetic. The design keeps a
// lane's state in registers and never leaves the lane's thread, and keeps
// nothing in local memory:
//  * the window comes from a register word cache: kernels 7 and 8 fill it
//    with 16-byte loads (TjWords16: a lane's first 256 bits in two loads,
//    one load per 128 bits after), kernel 9 word by word (TjWords), not
//    two word loads per symbol;
//  * symbols come from a 9-bit lookahead table per Huffman table
//    (tj_decode_lookahead), the maxcode walk only from length 10. The
//    tables come with the plan (ScanPlan.luts, built once per distinct
//    table on the host by wavefront.lookahead_table) and each CTA copies
//    them into shared memory with 16-byte loads;
//  * one launch covers images with different Huffman tables: the plan
//    holds the distinct table sets and each image's set, and starts each
//    image's lanes on a CTA boundary where there is more than one set, so
//    a CTA stages the one set of its first lane's image and the hot loop
//    reads shared memory as with a single set;
//  * kernel 7 keeps one predictor register per scan component, picked by
//    selects (no array indexed at run time), and stages its DC values in
//    shared memory a few MCUs at a time, so that each row run of them
//    goes out in 16-byte stores, not one 4-byte store per block;
//  * kernel 8 never waits on the state: a first scan gives each band
//    position of a block at most one value (k only grows), which it adds
//    into the state with a fire-and-forget RED (atomicAdd, result unused:
//    the same wrapping int32 add, and no two lanes share a block);
//  * kernel 9 adds a 256-byte read of each block's band and, where a bit
//    changed it, a 256-byte write; the band machine runs on 64-bit masks
//    and the block sits in registers between load and write-back.
// Sorting lanes by length and warp-cooperative decode are later work.
//
// Semantics follow the reference's code, including on corrupt streams:
//  * the window is the one tj_window gives (TjWords and TjWords16 return
//    the same 32 bits for every cursor, past the row's end included): the
//    reference's register pair never advances more than 32 bits at once,
//    so it reads the same words;
//  * error codes are assigned, not ORed (RUN overwrites BADCODE on the
//    same symbol); TRUNC (cursor past seg_bits + 7 on a lane with MCUs)
//    is ORed once, at the end; a lane with an error stops advancing;
//  * kernel 7: one predictor per scan component; a DC size above 15 is
//    BADCODE and decodes as size 0; the block whose symbol raises still
//    stores its predictor, later blocks of the lane store 0;
//  * kernel 8: a pending EOB run skips a block and counts down; EOBr sets
//    the run to (1 << r) - 1 + r extra bits; ZRL adds 16 to k and is never
//    an error, even past Se; only a value with k + r > Se raises RUN; a
//    value is added even on the symbol that raises BADCODE;
//  * kernel 9: a size above 1 and a code longer than 16 bits are BADCODE;
//    a run whose zero is not found is RUN, a ZRL whose 16th zero is not
//    found runs to Se; a symbol that raises applies no correction but its
//    bits still move the cursor; EOBr sets the run to (1 << r) + r extra
//    bits and the run counts down when a tail completes, so a run pending
//    at block entry makes the whole band one tail; a correction adds +P1
//    or -P1 by sign where (v & P1) == 0; a newly significant +-P1 goes to
//    the stop;
//  * predictor sums, shifts and adds wrap modulo 2^32 like jnp's int32.

#include "common.cuh"

#define TJ_PROG_MAX_SP 4
#define TJ_PROG_MAX_B 10
#define TJ_PROG_THREADS 128

typedef unsigned long long u64;

// The lane plan every progressive kernel takes (kernels/wavefront_prog
// ScanPlan): rows of W words (W % 4 == 0, rows on 16-byte boundaries),
// P the power of two >= W; lane_meta [L][3]
// (image, first MCU, MCUs); per table set, tables [n_sets][n_sp][34]
// maxcode | valoffset, huffval [n_sets][n_sp][256] and the 9-bit
// lookahead tables luts [n_sets][n_sp][512] of the scan's components,
// 16-byte aligned; image_set [N], each image's set. With n_sets > 1 no
// CTA holds lanes of two sets.
struct ProgLanes {
  const u32* bits;
  int W, P;
  const int* seg_bits;
  const int* lane_meta;
  int L;
  const int* tables;
  const uint8_t* huffval;
  const uint16_t* luts;
  const int* image_set;
  int n_sets;
  int n_sp;
  int* err_out;
};

// The table set of the CTA's first lane's image into shared memory: its
// tables and symbols, and its lookahead tables 16 bytes a thread (1 KB,
// 64 int4, per table).
__device__ __forceinline__ void stage_tables(const ProgLanes& a, int* s_tab, uint8_t* s_hv,
                                             uint16_t* s_lut) {
  const size_t lane0 = (size_t)blockIdx.x * blockDim.x;
  const int set = a.n_sets > 1 ? a.image_set[a.lane_meta[lane0 * 3]] : 0;
  const int* tab = a.tables + (size_t)set * a.n_sp * 34;
  const uint8_t* hv = a.huffval + (size_t)set * a.n_sp * 256;
  const int4* lut = (const int4*)(a.luts + (size_t)set * a.n_sp * 512);
  for (int i = threadIdx.x; i < a.n_sp * 34; i += blockDim.x) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < a.n_sp * 256; i += blockDim.x) s_hv[i] = hv[i];
  for (int i = threadIdx.x; i < a.n_sp * 64; i += blockDim.x) ((int4*)s_lut)[i] = __ldg(lut + i);
}

__device__ __forceinline__ int lane_err(const ProgLanes& a, int lane, int err, int cur, int lm) {
  const bool trunc = cur > a.seg_bits[lane] + 7 && lm > 0;
  return err | (trunc ? TJ_ERR_TRUNC : 0);
}

// ---------------------------------------------------------------------------
// Kernel 7: DC first.
// ---------------------------------------------------------------------------

struct DcFirstArgs {
  ProgLanes ln;
  int B, mcus_x, al;
  int blk[TJ_PROG_MAX_B][3];     // (scan component, dv, dh) of each block of an MCU
  int comp[TJ_PROG_MAX_SP][4];   // (h, v, padded_wb, padded_blocks) per scan component
  int* dc[TJ_PROG_MAX_SP];       // int32 [N, padded_blocks] DC column per scan component
};

// A lane stages the DC values of up to TJ_DC_CHUNK MCUs in shared memory
// (int [TJ_DC_CHUNK * B][threads], value j of the chunk at row j), then
// stores each (component, block row) run of them along the DC column's
// row with 16-byte stores where the address allows: for 4:2:0 and 4 MCUs,
// two 32-byte Y runs and one 16-byte run per chroma component, against
// 24 scattered 4-byte stores. A run ends at the MCU row's end.
#define TJ_DC_CHUNK 4

__device__ __forceinline__ void store_dc_chunk(const DcFirstArgs& a, const int* s_comp,
                                               const int* s_bidx, const int* vals, int img,
                                               int cnt, int my, int mx) {
  for (int sp = 0; sp < a.ln.n_sp; ++sp) {
    const int* c = s_comp + sp * 4;
    const int h = c[0], v = c[1];
    int done = 0, y = my, x = mx;
    while (done < cnt) {
      const int run = min(cnt - done, a.mcus_x - x);  // MCUs left in this MCU row
      const int n = run * h;
      for (int dv = 0; dv < v; ++dv) {
        int* dst = a.dc[sp] + (size_t)img * c[3] + (size_t)(y * v + dv) * c[2] + x * h;
        const int* bix = s_bidx + (sp * 4 + dv) * 4;
        int i = 0;
        while (i < n) {
          if ((((uintptr_t)(dst + i)) & 15u) == 0 && i + 4 <= n) {
            int q[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int j = i + t;
              q[t] = vals[((done + j / h) * a.B + bix[j % h]) * TJ_PROG_THREADS];
            }
            *(int4*)(dst + i) = make_int4(q[0], q[1], q[2], q[3]);
            i += 4;
          } else {
            dst[i] = vals[((done + i / h) * a.B + bix[i % h]) * TJ_PROG_THREADS];
            ++i;
          }
        }
      }
      done += run;
      x += run;
      if (x == a.mcus_x) {
        x = 0;
        ++y;
      }
    }
  }
}

__global__ void __launch_bounds__(TJ_PROG_THREADS) prog_dc_first_kernel(DcFirstArgs a) {
  __shared__ int s_tab[TJ_PROG_MAX_SP * 34];
  __shared__ uint8_t s_hv[TJ_PROG_MAX_SP * 256];
  __shared__ __align__(16) uint16_t s_lut[TJ_PROG_MAX_SP * 512];
  __shared__ int s_blk[TJ_PROG_MAX_B * 3];
  __shared__ int s_comp[TJ_PROG_MAX_SP * 4];
  __shared__ int s_bidx[TJ_PROG_MAX_SP * 4 * 4];  // block of (sp, dv, dh) in an MCU
  extern __shared__ int s_out[];                  // [TJ_DC_CHUNK * B][threads]
  stage_tables(a.ln, s_tab, s_hv, s_lut);
  for (int i = threadIdx.x; i < a.B * 3; i += blockDim.x) s_blk[i] = a.blk[i / 3][i % 3];
  for (int i = threadIdx.x; i < a.ln.n_sp * 4; i += blockDim.x) s_comp[i] = a.comp[i / 4][i % 4];
  for (int i = threadIdx.x; i < a.B; i += blockDim.x)
    s_bidx[(a.blk[i][0] * 4 + a.blk[i][1]) * 4 + a.blk[i][2]] = i;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.ln.L) return;

  TjWords16 words(a.ln.bits + (size_t)lane * a.ln.W, a.ln.W, a.ln.P);
  const int img = a.ln.lane_meta[lane * 3 + 0];
  const int first = a.ln.lane_meta[lane * 3 + 1];
  const int lm = a.ln.lane_meta[lane * 3 + 2];
  int my = first / a.mcus_x;
  int mx = first - my * a.mcus_x;
  int* vals = s_out + threadIdx.x;
  int cur = 0, err = 0;
  // One predictor per scan component, in registers: sp picks by selects.
  u32 p0 = 0u, p1 = 0u, p2 = 0u, p3 = 0u;
  for (int m0 = 0; m0 < lm; m0 += TJ_DC_CHUNK) {
    const int cnt = min(TJ_DC_CHUNK, lm - m0);
    for (int j = 0, b = 0; j < cnt * a.B; ++j, b = b + 1 == a.B ? 0 : b + 1) {
      const int sp = s_blk[b * 3 + 0];
      int out = 0;
      if (err == 0) {
        // A step moves the cursor by at most 32 bits (a code of at most
        // 17 bits, then at most 15 value bits), as TjWords16 needs.
        const u32 win = words.window(cur);
        const int* tb = s_tab + sp * 34;
        int t, dlen;
        tj_decode_lookahead(win, s_lut + sp * 512, tb, tb + 17, s_hv + sp * 256, t, dlen);
        const bool bad = dlen > 16 || t > 15;
        if (t > 15) t = 0;
        u32 pred = sp == 0 ? p0 : (sp == 1 ? p1 : (sp == 2 ? p2 : p3));
        pred += (u32)tj_receive_extend(win, dlen, t);
        p0 = sp == 0 ? pred : p0;
        p1 = sp == 1 ? pred : p1;
        p2 = sp == 2 ? pred : p2;
        p3 = sp == 3 ? pred : p3;
        cur += dlen + t;
        out = (int)(pred << a.al);
        if (bad) err = TJ_ERR_BADCODE;
      }
      vals[j * TJ_PROG_THREADS] = out;
    }
    store_dc_chunk(a, s_comp, s_bidx, vals, img, cnt, my, mx);
    mx += cnt;
    while (mx >= a.mcus_x) {
      mx -= a.mcus_x;
      ++my;
    }
  }
  a.ln.err_out[lane] = lane_err(a.ln, lane, err, cur, lm);
}

// ---------------------------------------------------------------------------
// Kernels 8 and 9: one component, one block per MCU.
// ---------------------------------------------------------------------------

struct AcArgs {
  ProgLanes ln;
  int width_blocks, padded_wb, padded_blocks;
  int ss, se, al;
  int* state;  // int32 [N, padded_blocks, 64] zigzag AC of the scan's component
};

__device__ __forceinline__ int* block_of(const AcArgs& a, int img, int g) {
  const int brow = g / a.width_blocks;
  const int bcol = g - brow * a.width_blocks;
  return a.state + ((size_t)img * a.padded_blocks + (size_t)brow * a.padded_wb + bcol) * 64;
}

__global__ void __launch_bounds__(TJ_PROG_THREADS) prog_ac_first_kernel(AcArgs a) {
  __shared__ int s_tab[34];
  __shared__ uint8_t s_hv[256];
  __shared__ __align__(16) uint16_t s_lut[512];
  stage_tables(a.ln, s_tab, s_hv, s_lut);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.ln.L) return;

  TjWords16 words(a.ln.bits + (size_t)lane * a.ln.W, a.ln.W, a.ln.P);
  const int img = a.ln.lane_meta[lane * 3 + 0];
  const int first = a.ln.lane_meta[lane * 3 + 1];
  const int lm = a.ln.lane_meta[lane * 3 + 2];
  const int ss = a.ss, se = a.se;
  int cur = 0, err = 0, eob = 0;
  for (int m = 0; m < lm && err == 0; ++m) {
    if (eob > 0) {
      --eob;
      continue;
    }
    int* blk = block_of(a, img, first + m);
    int k = ss;
    while (k <= se) {
      // A step moves the cursor by at most 32 bits (a code of at most 17
      // bits, then at most 15 value bits or 14 EOBr bits), as TjWords16
      // needs.
      const u32 win = words.window(cur);
      int rs, alen;
      tj_decode_lookahead(win, s_lut, s_tab, s_tab + 17, s_hv, rs, alen);
      const int r = rs >> 4, s = rs & 15;
      if (alen > 16) err = TJ_ERR_BADCODE;
      if (s > 0) {
        const int nk = k + r;
        if (nk <= se)  // RED: nothing waits on the add
          atomicAdd(blk + nk, (int)((u32)tj_receive_extend(win, alen, s) << a.al));
        else
          err = TJ_ERR_RUN;
        cur += alen + s;
        k = nk + 1;
      } else if (r < 15) {  // EOBr: this block ends, r extra bits give the run
        eob = (1 << r) - 1 + tj_receive_raw(win, alen, r);
        cur += alen + r;
        break;
      } else {  // ZRL
        cur += alen;
        k += 16;
      }
      if (err) break;
    }
  }
  a.ln.err_out[lane] = lane_err(a.ln, lane, err, cur, lm);
}

// Position of the n-th (1-based) set bit of m, or 64 when m has fewer.
__device__ __forceinline__ int nth_set(u64 m, int n) {
  if (__popcll(m) < n) return 64;
  for (int i = 1; i < n; ++i) m &= m - 1;
  return __ffsll((long long)m) - 1;
}

// One correction bit, in k order from the cursor, for each position whose
// bit is set in `r`, up to 32 bits per window. Returns the mask of the
// positions whose bit is 1.
__device__ __forceinline__ u64 refine_bits(TjWords& words, int& cur, u64 r) {
  u64 hit = 0ull;
  while (r) {
    u32 win = words.window(cur);
    const int take = min(__popcll(r), 32);
    for (int i = 0; i < take; ++i) {
      const u64 low = r & (0ull - r);
      r ^= low;
      if ((int)win < 0) hit |= low;
      win <<= 1;
    }
    cur += take;
  }
  return hit;
}

// The band machine runs on bit masks of the block (bit j for zigzag
// position j): nz (nonzero within the band), fix ((v & p1) == 0), neg
// (v < 0), hit (correction bit 1), placed and placed_neg (newly
// significant coefficients and their signs). The block itself sits in 64
// registers between its load and its write-back, both through
// compile-time indices, so no array is indexed by a runtime value.
__global__ void __launch_bounds__(TJ_PROG_THREADS) prog_ac_refine_kernel(AcArgs a) {
  __shared__ int s_tab[34];
  __shared__ uint8_t s_hv[256];
  __shared__ __align__(16) uint16_t s_lut[512];
  stage_tables(a.ln, s_tab, s_hv, s_lut);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.ln.L) return;

  TjWords words(a.ln.bits + (size_t)lane * a.ln.W, a.ln.W, a.ln.P);
  const int img = a.ln.lane_meta[lane * 3 + 0];
  const int first = a.ln.lane_meta[lane * 3 + 1];
  const int lm = a.ln.lane_meta[lane * 3 + 2];
  const int ss = a.ss, se = a.se;
  const int p1 = 1 << a.al;
  const int m1 = (int)(0xFFFFFFFFu << a.al);
  const u64 band = (~0ull >> (63 - se)) & (~0ull << ss);  // rows ss..se
  int cur = 0, err = 0, eob = 0;
  for (int m = 0; m < lm && err == 0; ++m) {
    int4* blk = (int4*)block_of(a, img, first + m);
    int v[64];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int4 q = blk[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
    u64 nz = 0ull, fix = 0ull, neg = 0ull;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      nz |= (u64)(v[j] != 0) << j;
      fix |= (u64)((v[j] & p1) == 0) << j;
      neg |= (u64)(v[j] < 0) << j;
    }
    nz &= band;
    u64 hit = 0ull, placed = 0ull, placed_neg = 0ull;
    if (eob > 0) {
      // A pending run: the whole band is one tail of correction bits.
      hit = refine_bits(words, cur, nz);
      --eob;
    } else {
      int k = ss;
      while (true) {
        const u32 win = words.window(cur);
        int rs, alen;
        tj_decode_lookahead(win, s_lut, s_tab, s_tab + 17, s_hv, rs, alen);
        const int rr = rs >> 4, ds = rs & 15;
        const bool is_eob = ds == 0 && rr < 15;
        cur += alen + (ds > 0 ? 1 : (is_eob ? rr : 0));
        if (alen > 16 || ds > 1) err = TJ_ERR_BADCODE;
        int kstop = se + 1;
        bool place = false, place_neg = false;
        if (is_eob) {
          eob = (1 << rr) + tj_receive_raw(win, alen, rr);
        } else {
          // Stop: the (r+1)-th zero at or after k (16th for ZRL).
          const int found = nth_set(~nz & band & (~0ull << k), ds > 0 ? rr + 1 : 16);
          if (found < 64) {
            kstop = found;
            place = ds > 0;
            place_neg = tj_receive_raw(win, alen, 1) == 0;
          } else if (ds > 0) {
            err = TJ_ERR_RUN;
          }
        }
        if (err) break;
        const u64 below = kstop >= 64 ? ~0ull : (1ull << kstop) - 1ull;
        hit |= refine_bits(words, cur, nz & below & (~0ull << k));
        if (place) {
          // kstop was a zero of the band, never in nz: it takes +-p1.
          placed |= 1ull << kstop;
          if (place_neg) placed_neg |= 1ull << kstop;
        }
        k = kstop + 1;
        if (is_eob) {
          --eob;
          break;
        }
        if (k > se) break;
      }
    }
    // Corrections and placements made before an error are written too.
    const u64 corr = hit & fix;
    if (corr | placed) {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        u32 x = (u32)v[j];
        if ((corr >> j) & 1ull) x += (neg >> j) & 1ull ? (u32)-p1 : (u32)p1;
        if ((placed >> j) & 1ull) x = (placed_neg >> j) & 1ull ? (u32)m1 : (u32)p1;
        v[j] = (int)x;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        blk[i] = make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
  a.ln.err_out[lane] = lane_err(a.ln, lane, err, cur, lm);
}

// ---------------------------------------------------------------------------
// C entry points. Pointers are device pointers except blk and comp of
// tj_prog_dc_first, which are host int32 arrays read at launch.
// ---------------------------------------------------------------------------

static bool aligned16(const void* p) { return p && ((uintptr_t)p & 15u) == 0; }

static bool lanes_ok(const ProgLanes& l) {
  return l.W > 0 && l.W % 4 == 0 && aligned16(l.bits) && l.P >= l.W && (l.P & (l.P - 1)) == 0 &&
         l.n_sp > 0 && l.n_sp <= TJ_PROG_MAX_SP && aligned16(l.luts) && l.image_set && l.n_sets > 0;
}

static int blocks_for(int L) { return (L + TJ_PROG_THREADS - 1) / TJ_PROG_THREADS; }

// luts: uint16 [n_sets][n_sp][512] lookahead tables
// (wavefront.lookahead_table), 16-byte aligned; image_set: int32 [N].
extern "C" int tj_prog_dc_first(const void* bits, int W, int P, const void* seg_bits,
                                const void* lane_meta, int L, const void* tables,
                                const void* huffval, const void* luts, const void* image_set,
                                int n_sets, int n_sp, const int* blk, int B, const int* comp,
                                int mcus_x, int al, void* d0, void* d1, void* d2, void* d3,
                                void* err, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  DcFirstArgs a{};
  a.ln = ProgLanes{(const u32*)bits, W, P, (const int*)seg_bits, (const int*)lane_meta, L,
                   (const int*)tables, (const uint8_t*)huffval, (const uint16_t*)luts,
                   (const int*)image_set, n_sets, n_sp, (int*)err};
  if (!lanes_ok(a.ln) || B <= 0 || B > TJ_PROG_MAX_B || mcus_x <= 0 || al < 0 || al > 15)
    return (int)cudaErrorInvalidValue;
  a.B = B;
  a.mcus_x = mcus_x;
  a.al = al;
  for (int b = 0; b < B; ++b) {
    for (int i = 0; i < 3; ++i) a.blk[b][i] = blk[b * 3 + i];
    if (a.blk[b][0] < 0 || a.blk[b][0] >= n_sp || a.blk[b][1] < 0 || a.blk[b][1] > 3 ||
        a.blk[b][2] < 0 || a.blk[b][2] > 3)
      return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_sp; ++s)
    for (int i = 0; i < 4; ++i) a.comp[s][i] = comp[s * 4 + i];
  void* dcs[TJ_PROG_MAX_SP] = {d0, d1, d2, d3};
  for (int s = 0; s < n_sp; ++s) {
    if (!dcs[s]) return (int)cudaErrorInvalidValue;
    a.dc[s] = (int*)dcs[s];
  }
  prog_dc_first_kernel<<<blocks_for(L), TJ_PROG_THREADS,
                         sizeof(int) * TJ_DC_CHUNK * B * TJ_PROG_THREADS, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_ac(bool refine, const void* bits, int W, int P, const void* seg_bits,
                     const void* lane_meta, int L, const void* tables, const void* huffval,
                     const void* luts, const void* image_set, int n_sets, int width_blocks,
                     int padded_wb, int padded_blocks, int ss, int se, int al, void* state,
                     void* err, void* stream) {
  if (L <= 0) return (int)cudaSuccess;
  AcArgs a{};
  a.ln = ProgLanes{(const u32*)bits, W, P, (const int*)seg_bits, (const int*)lane_meta, L,
                   (const int*)tables, (const uint8_t*)huffval, (const uint16_t*)luts,
                   (const int*)image_set, n_sets, 1, (int*)err};
  if (!lanes_ok(a.ln) || width_blocks <= 0 ||
      padded_wb < width_blocks || padded_blocks <= 0 || ss < 1 || se < ss || se > 63 || al < 0 ||
      al > 15 || !aligned16(state))
    return (int)cudaErrorInvalidValue;
  a.width_blocks = width_blocks;
  a.padded_wb = padded_wb;
  a.padded_blocks = padded_blocks;
  a.ss = ss;
  a.se = se;
  a.al = al;
  a.state = (int*)state;
  if (refine)
    prog_ac_refine_kernel<<<blocks_for(L), TJ_PROG_THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    prog_ac_first_kernel<<<blocks_for(L), TJ_PROG_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 8: state is the int32 [N, padded_blocks, 64] AC array of the
// scan's component, on a 16-byte boundary; a lane's MCU g is block
// (g / width_blocks, g % width_blocks) of the padded grid. luts: the
// component's uint16 [n_sets][512] lookahead tables, 16-byte aligned;
// image_set: int32 [N].
extern "C" int tj_prog_ac_first(const void* bits, int W, int P, const void* seg_bits,
                                const void* lane_meta, int L, const void* tables,
                                const void* huffval, const void* luts, const void* image_set,
                                int n_sets, int width_blocks, int padded_wb, int padded_blocks,
                                int ss, int se, int al, void* state, void* err, void* stream) {
  return launch_ac(false, bits, W, P, seg_bits, lane_meta, L, tables, huffval, luts, image_set,
                   n_sets, width_blocks, padded_wb, padded_blocks, ss, se, al, state, err, stream);
}

// Kernel 9: as kernel 8 (each block moves as 16 int4 words).
extern "C" int tj_prog_ac_refine(const void* bits, int W, int P, const void* seg_bits,
                                 const void* lane_meta, int L, const void* tables,
                                 const void* huffval, const void* luts, const void* image_set,
                                 int n_sets, int width_blocks, int padded_wb, int padded_blocks,
                                 int ss, int se, int al, void* state, void* err, void* stream) {
  return launch_ac(true, bits, W, P, seg_bits, lane_meta, L, tables, huffval, luts, image_set,
                   n_sets, width_blocks, padded_wb, padded_blocks, ss, se, al, state, err, stream);
}
