// Fancy chroma upsampling + YCbCr -> RGB: the port's color stage.
//
// Three tiled kernels with one epilogue (store_rgb):
// - h2v2_tile_kernel (4:2:0): kernel B (tj_upsample_color_h2v2) and the
//   4:2:0 planar kernel (tj_upsample_color_h2v2_planar). It replaces the
//   Pallas kernel _kernel_h2v2 of tpujpeg/kernels/sample_color.py:97 with
//   both of its emits (upsample_color_h2v2_batch into u8 RGB, and with
//   packed_words=True as pipeline._color_stage(packed) calls it), and the
//   layout probes built on it (P1-P6): run_cur, run_cols, run_fused and
//   run_fused_pre in tools/color_probe.py, color_kernel in
//   tools/tail_variants.py and run_kernel in tools/color_profile.py. Those
//   worked on phase-split, edge-padded strips with 8-row halo blocks, all
//   for Mosaic's layout rules; none of that carries over.
// - h2v1_tile_kernel (4:2:2): kernel C (tj_upsample_color_h2v1) and the
//   4:2:2 planar kernel (tj_upsample_color_h2v1_planar). It replaces
//   _kernel_h2v1 (sample_color.py:146) with both of its emits.
// - color_444_tile_kernel (4:4:4): kernel D (tj_color_444). It replaces
//   _kernel_444 (sample_color.py:160), which has no packed16 emit.
// NHWC kernels write uint8 [N, H, W, 3]. Planar kernels write uint8
// [N, 3, H, W], whose bytes are the reference's packed16 uint16
// [N, 3, H, W/2] (low byte = even column), so W must be even there.
//
// What bounds them on the H100: bytes. At 32 x 2048^2 4:2:0 moves 604 MB
// (134.2 MB of luma and 67.1 MB of chroma in, 402.7 MB of RGB out), 0.180
// ms at 3.35 TB/s; 4:2:2 671 MB, 0.200 ms; 4:4:4 805 MB, 0.240 ms; against
// 22-32 integer operations per pixel. The design keeps the instructions
// per pixel few and the loads in flight while it computes:
// - the grid is (column tile, group of row tiles, image), so a thread's
//   offsets are products of block indices and strides: no index division;
// - each thread converts 16 pixels of one row of a tile of 16 output rows
//   x 256 columns: its luma as one 16-byte load and its RGB as three
//   16-byte stores (NHWC: 48 contiguous bytes, neighbouring threads on
//   neighbouring runs; planar: one store per plane, 256 contiguous bytes
//   of a row per 16 threads);
// - the color terms of two pixels are paired as 16-bit lanes by the byte
//   permute that also takes their >> 16, one DPX instruction adds luma and
//   clamps both, and byte permutes pack the lanes into the output words.
// Chroma, by sampling:
// - 4:2:0 stages a tile's chroma (10 rows x 130 columns per plane, clamped
//   at the planes' true edge: libjpeg's edge rule) in shared memory with
//   16-byte loads: each chroma byte comes from device memory about once
//   and every edge clamp is done at staging. A thread's taps come from the
//   10 blended columns it shares with its neighbours. A block converts 4
//   tiles down the image, loading the next tile's luma and chroma into
//   registers before it converts the current one; the staged chroma is
//   double-buffered, so one barrier per tile orders both.
// - 4:2:2 needs chroma columns x0/2 - 1 .. x0/2 + 8 of the thread's own
//   row: one 8-byte load per plane, and two edge bytes that its row
//   neighbours loaded, taken with 16-lane shuffles; the first and last
//   thread of a tile row load theirs clamped at the plane's edge.
// - 4:4:4 reads 16 bytes of each chroma plane, as luma.
// Without vertical reuse, the 4:2:2 and 4:4:4 blocks are one tile each,
// with no shared memory, no barrier and no loop: on the H100 that beat 2
// or 4 tiles per block, the next row loaded ahead (it spilled at 64
// registers) and 4:2:2 chroma staged in shared memory (PERF.md §6).
// Planes whose base or strides are not 16-byte aligned (luma; for 4:4:4
// any plane), and widths that are not a multiple of 16 (the ragged last
// tile, odd W), take the instance with masked byte loads and stores for
// those planes and RGB. The chroma planes' alignment (16, 8 or 1 bytes)
// is an argument of the 4:2:0 and 4:2:2 kernels.
//
// Arithmetic is jdsample.c's (h2v2 biases 8/7, shift 4; h2v1 biases
// 1/2, shift 2) and jdcolor.c's fixed point, as in transform.py.

#include "common.cuh"

// One plane: base pointer and strides in elements (last stride is 1).
struct Plane {
  const uint8_t* p;
  long long s_img, s_row;
  // The plane from image n0 on.
  Plane from(int n0) const { return Plane{p + (size_t)n0 * s_img, s_img, s_row}; }
  // Row r of image n.
  __device__ __forceinline__ const uint8_t* row(int n, int r) const {
    return p + (size_t)n * s_img + (size_t)r * s_row;
  }
};

namespace tile {
constexpr int kRows = 16;                       // output rows per tile (even)
constexpr int kCols = 256;                      // output columns per tile
constexpr int kTiles = 4;                       // 4:2:0 tiles per block, down the image
constexpr int kPix = 16;                        // output pixels per thread, in one row
constexpr int kRowThreads = kCols / kPix;       // threads per output row
constexpr int kThreads = kRows * kRowThreads;   // 256
constexpr int kCRows = kRows / 2 + 2;           // staged chroma rows r0/2 - 1 .. (r0 + kRows)/2
constexpr int kCCols = kCols / 2;               // chroma columns under the tile
constexpr int kOff = 16;                        // byte of chroma column c0/2 in a staged row
constexpr int kPitch = kOff + kCCols + 16;      // halos at kOff - 1 and kOff + kCCols
constexpr int kPlane = kCRows * kPitch;         // one staged chroma plane
constexpr int kChunks = kCCols / 16;            // 16-byte chunks of a staged row
constexpr int kSlots = kChunks + 2;             // and its two halo bytes
constexpr int kItems = kCRows * kSlots;         // staging items per chroma plane
static_assert(kRows % 2 == 0 && kCols % kPix == 0 && 2 * kItems <= kThreads, "tile shape");
static_assert(kRowThreads == 16, "a tile row's threads are one 16-lane shuffle segment");
}  // namespace tile

// Byte j (a constant) of a little-endian word, zero-extended.
__device__ __forceinline__ int byte_of(uint32_t w, int j) {
  return (int)__byte_perm(w, 0u, 0x4440u | (unsigned)j);
}

// ORs the bytes of columns x0 .. x0 + 15 below W (q points at column x0)
// into little-endian words: the byte instances' loads.
__device__ __forceinline__ void load_bytes(const uint8_t* q, int x0, int W, uint32_t (&w)[4]) {
#pragma unroll
  for (int j = 0; j < tile::kPix; ++j)
    if (x0 + j < W) w[j >> 2] |= (uint32_t)q[j] << (8 * (j & 3));
}

// Columns x0 .. x0 + 15 of a row (q points at column x0) as little-endian
// words: one 16-byte load (kVec: all 16 are in the row and q is 16-byte
// aligned), else bytes, 0 at or past W.
template <bool kVec>
__device__ __forceinline__ void load16(const uint8_t* q, int x0, int W, uint32_t (&w)[4]) {
  if (kVec) {
    const uint4 l = __ldg(reinterpret_cast<const uint4*>(q));
    w[0] = l.x, w[1] = l.y, w[2] = l.z, w[3] = l.w;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0u;
    load_bytes(q, x0, W, w);
  }
}

// ---------------------------------------------------------------------------
// The epilogue: YCbCr -> RGB of 16 pixels and their stores
// ---------------------------------------------------------------------------

// jdcolor.c's YCbCr -> RGB (transform.ycc_to_rgb) for two pixels at
// once, with the -128 chroma offsets folded into the rounding constants.
// Each term's >> 16 is the upper half of its 32-bit sum, so one byte
// permute shifts and pairs two of them as 16-bit lanes;
// __viaddmin_s16x2_relu(y, t, 255) is max(min(y + t, 255), 0) on both
// lanes, one DPX instruction on sm_90. In and out: lane 0 = the even
// pixel, lane 1 = the odd one.
constexpr int kR0 = TJ_ONE_HALF - 128 * TJ_FIX_R_CR;
constexpr int kG0 = TJ_ONE_HALF - 128 * (TJ_FIX_G_CB + TJ_FIX_G_CR);
constexpr int kB0 = TJ_ONE_HALF - 128 * TJ_FIX_B_CB;

__device__ __forceinline__ uint32_t hi_halves(int a, int b) {
  return __byte_perm((uint32_t)a, (uint32_t)b, 0x7632u);
}

__device__ __forceinline__ void ycc_rgb2(uint32_t y2, int cb0, int cb1, int cr0, int cr1,
                                         uint32_t& r, uint32_t& g, uint32_t& b) {
  const uint32_t lim = 0x00FF00FFu;
  r = __viaddmin_s16x2_relu(y2, hi_halves(TJ_FIX_R_CR * cr0 + kR0, TJ_FIX_R_CR * cr1 + kR0), lim);
  g = __viaddmin_s16x2_relu(y2, hi_halves(TJ_FIX_G_CB * cb0 + TJ_FIX_G_CR * cr0 + kG0,
                                          TJ_FIX_G_CB * cb1 + TJ_FIX_G_CR * cr1 + kG0), lim);
  b = __viaddmin_s16x2_relu(y2, hi_halves(TJ_FIX_B_CB * cb0 + kB0, TJ_FIX_B_CB * cb1 + kB0), lim);
}

// Output row r, columns x0 .. x0 + 15 of image n (x0 < W), from its luma
// bytes yw and its chroma values tb, tr. RGB is computed as pairs of
// 16-bit lanes (rgb[c][p]: pixels 2p and 2p + 1) and packed to bytes by
// byte permutes. kVec: the 16 pixels are all in the image and go out as
// 16-byte stores; otherwise as bytes, masked at W. kPlanar: out is uint8
// [N, 3, H, W], else [N, H, W, 3].
template <bool kVec, bool kPlanar>
__device__ __forceinline__ void store_rgb(const uint32_t (&yw)[4], const int (&tb)[tile::kPix],
                                          const int (&tr)[tile::kPix], int n, int r, int x0, int H,
                                          int W, uint8_t* __restrict__ out) {
  using namespace tile;
  uint32_t rgb[3][kPix / 2];
#pragma unroll
  for (int p = 0; p < kPix / 2; ++p) {
    const uint32_t y2 = __byte_perm(yw[p >> 1], 0u, (p & 1) ? 0x4342u : 0x4140u);
    ycc_rgb2(y2, tb[2 * p], tb[2 * p + 1], tr[2 * p], tr[2 * p + 1], rgb[0][p], rgb[1][p], rgb[2][p]);
  }
  // NHWC: pixels 4q .. 4q + 3 are the 12 bytes R0 G0 B0 R1 | G1 B1 R2 G2
  // | B2 R3 G3 B3 of words 3q .. 3q + 2 of the 48 output bytes.
  uint32_t nhwc[3 * kPix / 4];
  if (!kPlanar) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r01 = rgb[0][2 * q], g01 = rgb[1][2 * q], b01 = rgb[2][2 * q];
      const uint32_t r23 = rgb[0][2 * q + 1], g23 = rgb[1][2 * q + 1], b23 = rgb[2][2 * q + 1];
      nhwc[3 * q] = __byte_perm(__byte_perm(r01, g01, 0x0240u), b01, 0x2410u);
      nhwc[3 * q + 1] = __byte_perm(__byte_perm(g01, b01, 0x0062u), __byte_perm(r23, g23, 0x0040u), 0x5410u);
      nhwc[3 * q + 2] = __byte_perm(b23, __byte_perm(r23, g23, 0x0062u), 0x2540u);
    }
  }
  const size_t plane = (size_t)H * W;
  uint8_t* o = kPlanar ? out + (size_t)n * 3 * plane + (size_t)r * W + x0
                       : out + (((size_t)n * H + r) * W + x0) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // 16 output bytes as words: planar, plane c's (packed here, so that a
    // plane's lanes die once stored); NHWC, bytes 16c .. 16c + 15.
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = kPlanar ? __byte_perm(rgb[c][2 * q], rgb[c][2 * q + 1], 0x6420u) : nhwc[4 * c + q];
    uint8_t* dst = kPlanar ? o + c * plane : o + 16 * c;
    if (kVec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      const int n_bytes = kPlanar ? W - x0 : 3 * (W - x0) - 16 * c;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (b < n_bytes) dst[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// ---------------------------------------------------------------------------
// 4:2:0: kernel B and the 4:2:0 planar kernel
// ---------------------------------------------------------------------------

// Staging item `item` of a chroma plane (image base c) for the tile at
// rows from r0, columns from c0, loaded into registers: slot j of staged
// row s, which holds chroma row clamp(r0/2 - 1 + s). Slots below kChunks
// are the 16 columns from c0/2 + 16j, slot kChunks the left halo column
// c0/2 - 1 (in .x), the last slot the right halo c0/2 + kCCols; every
// row and column clamped into the plane. `align` (16, 8 or 1) divides
// the plane's base and strides.
__device__ __forceinline__ uint4 stage_load(const uint8_t* c, long long s_row, int Hc, int Wc,
                                            int r0, int c0, int align, int item) {
  using namespace tile;
  const int s = item / kSlots, j = item - s * kSlots, cc0 = c0 / 2;
  const uint8_t* row = c + (size_t)min(max(r0 / 2 - 1 + s, 0), Hc - 1) * s_row;
  if (j == kChunks) return make_uint4(__ldg(row + max(cc0 - 1, 0)), 0u, 0u, 0u);
  if (j == kChunks + 1) return make_uint4(__ldg(row + min(cc0 + kCCols, Wc - 1)), 0u, 0u, 0u);
  const int col = cc0 + 16 * j;
  if (col + 16 <= Wc && align == 16) return __ldg(reinterpret_cast<const uint4*>(row + col));
  if (col + 16 <= Wc && align == 8) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(row + col));
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(row + col) + 1);
    return make_uint4(a.x, a.y, b.x, b.y);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) w[b >> 2] |= (uint32_t)__ldg(row + min(col + b, Wc - 1)) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stores a loaded staging item into its plane's staged rows at sm.
__device__ __forceinline__ void stage_store(uint8_t* sm, int item, uint4 v) {
  using namespace tile;
  const int s = item / kSlots, j = item - s * kSlots;
  uint8_t* dst = sm + s * kPitch + kOff;
  if (j == kChunks)
    dst[-1] = (uint8_t)v.x;
  else if (j == kChunks + 1)
    dst[kCCols] = (uint8_t)v.x;
  else
    *reinterpret_cast<uint4*>(dst + 16 * j) = v;
}

// The 16 chroma taps of tile row i, thread k (output columns x0 .. x0 +
// 15, x0 = c0 + 16k), from one plane's staged rows at sm: the vertical
// blend v = 3 * near + far of chroma row i/2 of the tile with the row
// above (even i) or below (odd i), at the 10 staged columns x0/2 - 1 ..
// x0/2 + 8, then each output column from its chroma column (x3) and the
// left (even) or right (odd) neighbour: biases 8 and 7, shift 4.
__device__ __forceinline__ void h2v2_taps(const uint8_t* sm, int i, int k, int (&t)[tile::kPix]) {
  using namespace tile;
  const uint8_t* a = sm + ((i >> 1) + 1) * kPitch + kOff + 8 * k;
  const uint8_t* b = sm + ((i & 1) ? (i >> 1) + 2 : (i >> 1)) * kPitch + kOff + 8 * k;
  const uint2 aw = *reinterpret_cast<const uint2*>(a), bw = *reinterpret_cast<const uint2*>(b);
  int v[10];
  v[0] = 3 * a[-1] + b[-1];
  v[9] = 3 * a[8] + b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j + 1] = 3 * byte_of(j < 4 ? aw.x : aw.y, j & 3) + byte_of(j < 4 ? bw.x : bw.y, j & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[2 * j] = (3 * v[j + 1] + v[j] + 8) >> 4;
    t[2 * j + 1] = (3 * v[j + 1] + v[j + 2] + 7) >> 4;
  }
}

// Output row r, columns x0 .. x0 + 15 of image n, from its luma words lw
// (kVec; else loaded here as bytes, masked at W) and the tile's staged
// chroma at sm (two planes).
template <bool kVec, bool kPlanar>
__device__ __forceinline__ void convert_row(const Plane& y, const uint8_t* sm, int n, int r, int i,
                                            int k, int x0, int H, int W, uint4 lw,
                                            uint8_t* __restrict__ out) {
  using namespace tile;
  uint32_t yw[4] = {lw.x, lw.y, lw.z, lw.w};
  if (!kVec) load_bytes(y.p + (size_t)n * y.s_img + (size_t)r * y.s_row + x0, x0, W, yw);
  int tb[kPix], tr[kPix];
  h2v2_taps(sm, i, k, tb);
  h2v2_taps(sm + kPlane, i, k, tr);
  store_rgb<kVec, kPlanar>(yw, tb, tr, n, r, x0, H, W, out);
}

// Block (x, y, z) = (column tile, kTiles row tiles, image); thread (i, k)
// = (threadIdx.x / 16, threadIdx.x % 16) converts row r0 + i of each
// tile, columns c0 + 16k .. c0 + 16k + 15. The block walks its tiles
// down the image with the next tile's luma words and chroma staging item
// loaded into registers before it converts the current one, and the
// staged chroma double-buffered, so one barrier per tile orders both.
// kVec: the luma base and strides are 16-byte aligned and W % 16 == 0, so
// a thread's 16 pixels are all in the image and luma and RGB move as
// 16-byte words; otherwise as bytes, masked at W. calign: the chroma
// planes' alignment (stage_load).
template <bool kVec, bool kPlanar>
__global__ void __launch_bounds__(tile::kThreads, 4)
h2v2_tile_kernel(Plane y, Plane cb, Plane cr, int H, int W, int Hc, int Wc, int calign,
                 uint8_t* __restrict__ out) {
  using namespace tile;
  __shared__ __align__(16) uint8_t sm[2][2 * kPlane];
  const int n = blockIdx.z, c0 = blockIdx.x * kCols;
  const int i = threadIdx.x / kRowThreads, k = threadIdx.x % kRowThreads, x0 = c0 + kPix * k;
  const bool stager = threadIdx.x < 2 * kItems, second = threadIdx.x >= kItems;
  const int item = threadIdx.x - (second ? kItems : 0);
  const uint8_t* cbase = second ? cr.p + (size_t)n * cr.s_img : cb.p + (size_t)n * cb.s_img;
  const long long cs_row = second ? cr.s_row : cb.s_row;
  const uint8_t* ybase = y.p + (size_t)n * y.s_img + x0;
  int r0 = blockIdx.y * kRows * kTiles;
  const int r_end = min(H, r0 + kRows * kTiles);
  uint4 lnext = make_uint4(0u, 0u, 0u, 0u), cnext = lnext;
  auto fetch = [&](int rt) {
    if (kVec && rt + i < H && x0 < W)
      lnext = __ldg(reinterpret_cast<const uint4*>(ybase + (size_t)(rt + i) * y.s_row));
    if (stager) cnext = stage_load(cbase, cs_row, Hc, Wc, rt, c0, calign, item);
  };
  fetch(r0);
  for (int t = 0; r0 < r_end; ++t, r0 += kRows) {
    uint8_t* buf = sm[t & 1];
    if (stager) stage_store(buf + (second ? kPlane : 0), item, cnext);
    const uint4 lw = lnext;
    __syncthreads();
    if (r0 + kRows < r_end) fetch(r0 + kRows);
    if (r0 + i < H && x0 < W) convert_row<kVec, kPlanar>(y, buf, n, r0 + i, i, k, x0, H, W, lw, out);
  }
}

// ---------------------------------------------------------------------------
// 4:2:2: kernel C and the 4:2:2 planar kernel
// ---------------------------------------------------------------------------

// 8 bytes of a chroma row from column cc, each column clamped to the
// plane's Wc: one 8-byte load where all are inside and the plane is
// 8-byte aligned, else byte loads.
__device__ __forceinline__ uint2 chroma8(const uint8_t* row, int cc, int Wc, bool al8) {
  if (al8 && cc + 8 <= Wc) return __ldg(reinterpret_cast<const uint2*>(row + cc));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int b = 0; b < 8; ++b) w[b >> 2] |= (uint32_t)__ldg(row + min(cc + b, Wc - 1)) << (8 * (b & 3));
  return make_uint2(w[0], w[1]);
}

// The 16 chroma taps of a 4:2:2 thread from its 8 chroma columns w (from
// cc = x0/2) and its row neighbours' (16-lane shuffles within the tile
// row, mask seg; the row's first and last thread take `edge`, column cc -
// 1 or cc + 8 clamped into the plane): output column x0 + 2j blends
// column cc + j with its left neighbour (bias 1), x0 + 2j + 1 with its
// right (bias 2), shift 2.
__device__ __forceinline__ void h2v1_taps(uint2 w, int edge, int k, unsigned seg,
                                          int (&t)[tile::kPix]) {
  using namespace tile;
  const int left = (int)(__shfl_up_sync(seg, w.y, 1, kRowThreads) >> 24);
  const int right = (int)(__shfl_down_sync(seg, w.x, 1, kRowThreads) & 0xFFu);
  int v[10];
  v[0] = k == 0 ? edge : left;
  v[9] = k == kRowThreads - 1 ? edge : right;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j + 1] = byte_of(j < 4 ? w.x : w.y, j & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[2 * j] = (3 * v[j + 1] + v[j] + 1) >> 2;
    t[2 * j + 1] = (3 * v[j + 1] + v[j + 2] + 2) >> 2;
  }
}

// Block (x, y, z) = (column tile, row tile, image); thread (i, k) =
// (threadIdx.x / 16, threadIdx.x % 16) converts row r = r0 + i, columns
// x0 = c0 + 16k .. x0 + 15. Threads past W still load (clamped) chroma:
// their first column is the right edge of the thread before them. kVec:
// the luma base and strides are 16-byte aligned and W % 16 == 0; calign:
// the chroma planes' alignment (8 or 1).
template <bool kVec, bool kPlanar>
__global__ void __launch_bounds__(tile::kThreads, 4)
h2v1_tile_kernel(Plane y, Plane cb, Plane cr, int H, int W, int Wc, int calign,
                 uint8_t* __restrict__ out) {
  using namespace tile;
  const int n = blockIdx.z, r = blockIdx.y * kRows + threadIdx.x / kRowThreads;
  const int k = threadIdx.x % kRowThreads, x0 = blockIdx.x * kCols + kPix * k, cc = x0 / 2;
  if (r >= H) return;  // the whole tile row: its shuffle segment
  uint32_t yw[4] = {0u, 0u, 0u, 0u};
  if (x0 < W) load16<kVec>(y.row(n, r) + x0, x0, W, yw);
  const uint8_t *b = cb.row(n, r), *c = cr.row(n, r);
  const uint2 bw = chroma8(b, cc, Wc, calign == 8), cw = chroma8(c, cc, Wc, calign == 8);
  int b_edge = 0, c_edge = 0;
  if (k == 0 || k == kRowThreads - 1) {
    const int ec = k == 0 ? max(cc - 1, 0) : min(cc + 8, Wc - 1);
    b_edge = __ldg(b + ec);
    c_edge = __ldg(c + ec);
  }
  const unsigned seg = 0xFFFFu << (threadIdx.x & 16);
  int tb[kPix], tr[kPix];
  h2v1_taps(bw, b_edge, k, seg, tb);
  h2v1_taps(cw, c_edge, k, seg, tr);
  if (x0 < W) store_rgb<kVec, kPlanar>(yw, tb, tr, n, r, x0, H, W, out);
}

// ---------------------------------------------------------------------------
// 4:4:4: kernel D
// ---------------------------------------------------------------------------

// Block (x, y, z) = (column tile, row tile, image); thread (i, k) converts
// row r0 + i, columns x0 = c0 + 16k .. x0 + 15. kVec: all three planes'
// bases and strides are 16-byte aligned and W % 16 == 0, so each plane's
// 16 bytes are one load.
template <bool kVec>
__global__ void __launch_bounds__(tile::kThreads, 4)
color_444_tile_kernel(Plane y, Plane cb, Plane cr, int H, int W, uint8_t* __restrict__ out) {
  using namespace tile;
  const int n = blockIdx.z, r = blockIdx.y * kRows + threadIdx.x / kRowThreads;
  const int x0 = blockIdx.x * kCols + kPix * (threadIdx.x % kRowThreads);
  if (x0 >= W || r >= H) return;
  uint32_t yw[4], bw[4], cw[4];
  load16<kVec>(y.row(n, r) + x0, x0, W, yw);
  load16<kVec>(cb.row(n, r) + x0, x0, W, bw);
  load16<kVec>(cr.row(n, r) + x0, x0, W, cw);
  int tb[kPix], tr[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    tb[j] = byte_of(bw[j >> 2], j & 3);
    tr[j] = byte_of(cw[j >> 2], j & 3);
  }
  store_rgb<kVec, false>(yw, tb, tr, n, r, x0, H, W, out);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

static bool aligned_to(const void* p, long long s_img, long long s_row, int m) {
  return (uintptr_t)p % m == 0 && s_img % m == 0 && s_row % m == 0;
}

// Calls launch(grid, n0) once per 65,535 images (the grid's z limit)
// with grid (column tiles, groups of `tiles` row tiles, images from n0),
// checking each launch.
template <class Launch>
static int launch_tiles(int N, int H, int W, int tiles, Launch launch) {
  const int rows_per_block = tile::kRows * tiles;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const dim3 grid((W + tile::kCols - 1) / tile::kCols, (H + rows_per_block - 1) / rows_per_block,
                    N - n0 < 65535 ? N - n0 : 65535);
    launch(grid, n0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// Kernel B (kPlanar false) or the 4:2:0 planar kernel: picks the
// instance from the pointers and strides.
template <bool kPlanar>
static int launch_h2v2(const Plane& y, const Plane& cb, const Plane& cr, int N, int H, int W,
                       int Hc, int Wc, uint8_t* out, cudaStream_t s) {
  if (Hc != (H + 1) / 2 || Wc != (W + 1) / 2 || (kPlanar && (W & 1)))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W <= 0) return (int)cudaSuccess;
  const bool vec = aligned_to(y.p, y.s_img, y.s_row, 16) && W % 16 == 0 && (uintptr_t)out % 16 == 0;
  auto chroma_aligned = [&](int m) {
    return aligned_to(cb.p, cb.s_img, cb.s_row, m) && aligned_to(cr.p, cr.s_img, cr.s_row, m);
  };
  const int calign = chroma_aligned(16) ? 16 : chroma_aligned(8) ? 8 : 1;
  const auto kernel = vec ? h2v2_tile_kernel<true, kPlanar> : h2v2_tile_kernel<false, kPlanar>;
  return launch_tiles(N, H, W, tile::kTiles, [&](dim3 grid, int n0) {
    kernel<<<grid, tile::kThreads, 0, s>>>(y.from(n0), cb.from(n0), cr.from(n0), H, W, Hc, Wc, calign,
                                           out + (size_t)n0 * 3 * H * W);
  });
}

// Kernel C (kPlanar false) or the 4:2:2 planar kernel.
template <bool kPlanar>
static int launch_h2v1(const Plane& y, const Plane& cb, const Plane& cr, int N, int H, int W,
                       int Hc, int Wc, uint8_t* out, cudaStream_t s) {
  if (Hc != H || Wc != (W + 1) / 2 || (kPlanar && (W & 1))) return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W <= 0) return (int)cudaSuccess;
  const bool vec = aligned_to(y.p, y.s_img, y.s_row, 16) && W % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int calign =
      aligned_to(cb.p, cb.s_img, cb.s_row, 8) && aligned_to(cr.p, cr.s_img, cr.s_row, 8) ? 8 : 1;
  const auto kernel = vec ? h2v1_tile_kernel<true, kPlanar> : h2v1_tile_kernel<false, kPlanar>;
  return launch_tiles(N, H, W, 1, [&](dim3 grid, int n0) {
    kernel<<<grid, tile::kThreads, 0, s>>>(y.from(n0), cb.from(n0), cr.from(n0), H, W, Wc, calign,
                                           out + (size_t)n0 * 3 * H * W);
  });
}

static Plane plane(const void* p, long long s_img, long long s_row) {
  return Plane{(const uint8_t*)p, s_img, s_row};
}

extern "C" int tj_upsample_color_h2v2(const void* yp, long long ys_img, long long ys_row,
                                      const void* cbp, long long cbs_img, long long cbs_row,
                                      const void* crp, long long crs_img, long long crs_row,
                                      int N, int H, int W, int Hc, int Wc, void* out,
                                      void* stream) {
  return launch_h2v2<false>(plane(yp, ys_img, ys_row), plane(cbp, cbs_img, cbs_row),
                            plane(crp, crs_img, crs_row), N, H, W, Hc, Wc, (uint8_t*)out,
                            (cudaStream_t)stream);
}

extern "C" int tj_upsample_color_h2v2_planar(const void* yp, long long ys_img, long long ys_row,
                                             const void* cbp, long long cbs_img, long long cbs_row,
                                             const void* crp, long long crs_img, long long crs_row,
                                             int N, int H, int W, int Hc, int Wc, void* out,
                                             void* stream) {
  return launch_h2v2<true>(plane(yp, ys_img, ys_row), plane(cbp, cbs_img, cbs_row),
                           plane(crp, crs_img, crs_row), N, H, W, Hc, Wc, (uint8_t*)out,
                           (cudaStream_t)stream);
}

extern "C" int tj_upsample_color_h2v1(const void* yp, long long ys_img, long long ys_row,
                                      const void* cbp, long long cbs_img, long long cbs_row,
                                      const void* crp, long long crs_img, long long crs_row,
                                      int N, int H, int W, int Hc, int Wc, void* out,
                                      void* stream) {
  return launch_h2v1<false>(plane(yp, ys_img, ys_row), plane(cbp, cbs_img, cbs_row),
                            plane(crp, crs_img, crs_row), N, H, W, Hc, Wc, (uint8_t*)out,
                            (cudaStream_t)stream);
}

extern "C" int tj_upsample_color_h2v1_planar(const void* yp, long long ys_img, long long ys_row,
                                             const void* cbp, long long cbs_img, long long cbs_row,
                                             const void* crp, long long crs_img, long long crs_row,
                                             int N, int H, int W, int Hc, int Wc, void* out,
                                             void* stream) {
  return launch_h2v1<true>(plane(yp, ys_img, ys_row), plane(cbp, cbs_img, cbs_row),
                           plane(crp, crs_img, crs_row), N, H, W, Hc, Wc, (uint8_t*)out,
                           (cudaStream_t)stream);
}

// Kernel D: the 16-byte instance when all three planes and the output
// are 16-byte aligned and W % 16 == 0.
extern "C" int tj_color_444(const void* yp, long long ys_img, long long ys_row, const void* cbp,
                            long long cbs_img, long long cbs_row, const void* crp,
                            long long crs_img, long long crs_row, int N, int H, int W, void* out,
                            void* stream) {
  if ((long long)N * H * W <= 0) return (int)cudaSuccess;
  const Plane y = plane(yp, ys_img, ys_row), cb = plane(cbp, cbs_img, cbs_row),
              cr = plane(crp, crs_img, crs_row);
  const bool vec = aligned_to(yp, ys_img, ys_row, 16) && aligned_to(cbp, cbs_img, cbs_row, 16) &&
                   aligned_to(crp, crs_img, crs_row, 16) && W % 16 == 0 && (uintptr_t)out % 16 == 0;
  const auto kernel = vec ? color_444_tile_kernel<true> : color_444_tile_kernel<false>;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return launch_tiles(N, H, W, 1, [&](dim3 grid, int n0) {
    kernel<<<grid, tile::kThreads, 0, s>>>(y.from(n0), cb.from(n0), cr.from(n0), H, W,
                                           o + (size_t)n0 * 3 * H * W);
  });
}
