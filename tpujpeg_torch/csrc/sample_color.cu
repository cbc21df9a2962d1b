// Fancy chroma upsampling + YCbCr -> RGB: the port's color stage.
//
// 4:2:0 (kernel B and the 4:2:0 planar kernel): one tiled kernel body,
// h2v2_tile_kernel, with two epilogues. Kernel B
// (tj_upsample_color_h2v2) writes NHWC uint8 [N, H, W, 3]; the planar
// kernel (tj_upsample_color_h2v2_planar) writes planar uint8
// [N, 3, H, W], whose bytes are the reference's packed16 uint16
// [N, 3, H, W/2] (low byte = even column), so W must be even there. It
// replaces the Pallas kernel _kernel_h2v2 of
// tpujpeg/kernels/sample_color.py:97 with both of its emits
// (upsample_color_h2v2_batch into u8 RGB, and with packed_words=True as
// pipeline._color_stage(packed) calls it), and the layout probes built
// on it (P1-P6): run_cur, run_cols, run_fused and run_fused_pre in
// tools/color_probe.py, color_kernel in tools/tail_variants.py and
// run_kernel in tools/color_profile.py. Those worked on phase-split,
// edge-padded strips with 8-row halo blocks, all for Mosaic's layout
// rules; none of that carries over.
//
// What bounds it on the H100: bytes. 32 x 2048^2 needs 604 MB (134.2 MB
// of luma and 67.1 MB of chroma in, 402.7 MB of RGB out), 0.180 ms at
// 3.35 TB/s, against about 32 integer operations per pixel. The design
// keeps the instructions per pixel few and the loads in flight while it
// computes:
// - the grid is (column tile, group of row tiles, image), so a thread's
//   offsets are products of block indices and strides: no index division;
// - a tile of 16 output rows x 256 columns stages the chroma it reads
//   (10 rows x 130 columns per plane, clamped at the planes' true edge:
//   libjpeg's edge rule) in shared memory with 16-byte loads, so each
//   chroma byte comes from device memory about once and every edge
//   clamp is done at staging;
// - each thread converts 16 pixels of one row: its luma as one 16-byte
//   load, its 16 chroma taps per plane from the 10 blended columns it
//   shares with its neighbours, and its RGB as three 16-byte stores
//   (NHWC: 48 contiguous bytes, neighbouring threads on neighbouring
//   runs; planar: one store per plane, 256 contiguous bytes of a row
//   per 16 threads);
// - the color terms of two pixels are paired as 16-bit lanes by the
//   byte permute that also takes their >> 16, one DPX instruction adds
//   luma and clamps both, and byte permutes pack the lanes into the
//   output words;
// - a block converts 4 tiles down the image and loads the next tile's
//   luma and chroma into registers before it converts the current one;
//   the staged chroma is double-buffered, so one barrier per tile orders
//   both.
// Luma whose base or strides are not 16-byte aligned, and widths that
// are not a multiple of 16 (the ragged last tile, W = 2), take the
// instance with masked byte loads and stores for luma and RGB; it stages
// the chroma and computes the taps the same way.
//
// Kernels C (4:2:2) and D (4:4:4) keep one thread per output pixel, and
// the 4:2:2 planar kernel one thread per pixel pair, reading the planes
// in place.
//
// Arithmetic is jdsample.c's (h2v2 biases 8/7, shift 4; h2v1 biases
// 1/2, shift 2) and jdcolor.c's fixed point, as in transform.py.

#include "common.cuh"

// One plane: base pointer and strides in elements (last stride is 1).
struct Plane {
  const uint8_t* p;
  long long s_img, s_row;
  __device__ __forceinline__ int at(int n, int r, int c) const {
    return p[(size_t)n * s_img + (size_t)r * s_row + c];
  }
};

__device__ __forceinline__ int h2v1_tap(const Plane& c, int n, int y, int x, int Wc) {
  const int cx = x >> 1;
  const int nx = (x & 1) ? min(cx + 1, Wc - 1) : max(cx - 1, 0);
  return (3 * c.at(n, y, cx) + c.at(n, y, nx) + ((x & 1) ? 2 : 1)) >> 2;
}

__global__ void h2v1_kernel(Plane y, Plane cb, Plane cr, int N, int H, int W, int Wc,
                            uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * H * W) return;
  const int x = (int)(i % W);
  const long long t = i / W;
  const int r = (int)(t % H), n = (int)(t / H);
  tj_ycc_rgb(y.at(n, r, x), h2v1_tap(cb, n, r, x, Wc), h2v1_tap(cr, n, r, x, Wc), out + i * 3);
}

__global__ void color_444_kernel(Plane y, Plane cb, Plane cr, int N, int H, int W,
                                 uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * H * W) return;
  const int x = (int)(i % W);
  const long long t = i / W;
  const int r = (int)(t % H), n = (int)(t / H);
  tj_ycc_rgb(y.at(n, r, x), cb.at(n, r, x), cr.at(n, r, x), out + i * 3);
}

// ---------------------------------------------------------------------------
// The 4:2:0 tile kernel
// ---------------------------------------------------------------------------

namespace tile {
constexpr int kRows = 16;                       // output rows per tile (even)
constexpr int kCols = 256;                      // output columns per tile
constexpr int kTiles = 4;                       // tiles per block, down the image
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
}  // namespace tile

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

// Byte j (a constant) of a little-endian word, zero-extended.
__device__ __forceinline__ int byte_of(uint32_t w, int j) {
  return (int)__byte_perm(w, 0u, 0x4440u | (unsigned)j);
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

// tj_ycc_rgb's arithmetic for two pixels at once, with the -128 chroma
// offsets folded into the rounding constants. Each term's >> 16 is the
// upper half of its 32-bit sum, so one byte permute shifts and pairs two
// of them as 16-bit lanes; __viaddmin_s16x2_relu(y, t, 255) is max(min(y
// + t, 255), 0) on both lanes, one DPX instruction on sm_90. In and out:
// lane 0 = the even pixel, lane 1 = the odd one.
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

// Output row r, columns x0 .. x0 + 15 of image n, from its luma words lw
// (kVec; else loaded here as bytes, masked at W) and the tile's staged
// chroma at sm (two planes). RGB goes out as pairs of 16-bit lanes
// (rgb[c][p]: pixels 2p and 2p + 1), packed to bytes by byte permutes.
template <bool kVec, bool kPlanar>
__device__ __forceinline__ void convert_row(const Plane& y, const uint8_t* sm, int n, int r, int i,
                                            int k, int x0, int H, int W, uint4 lw,
                                            uint8_t* __restrict__ out) {
  using namespace tile;
  uint32_t yw[4] = {lw.x, lw.y, lw.z, lw.w};
  if (!kVec) {
    const uint8_t* q = y.p + (size_t)n * y.s_img + (size_t)r * y.s_row + x0;
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (x0 + j < W) yw[j >> 2] |= (uint32_t)q[j] << (8 * (j & 3));
  }
  int tb[kPix], tr[kPix];
  h2v2_taps(sm, i, k, tb);
  h2v2_taps(sm + kPlane, i, k, tr);
  uint32_t rgb[3][kPix / 2];
#pragma unroll
  for (int p = 0; p < kPix / 2; ++p) {
    const uint32_t y2 = __byte_perm(yw[p >> 1], 0u, (p & 1) ? 0x4342u : 0x4140u);
    ycc_rgb2(y2, tb[2 * p], tb[2 * p + 1], tr[2 * p], tr[2 * p + 1], rgb[0][p], rgb[1][p], rgb[2][p]);
  }
  if (kPlanar) {
    const size_t plane = (size_t)H * W;
    uint8_t* o = out + (size_t)n * 3 * plane + (size_t)r * W + x0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (kVec) {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = __byte_perm(rgb[c][2 * q], rgb[c][2 * q + 1], 0x6420u);
        *reinterpret_cast<uint4*>(o + c * plane) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          if (x0 + j < W) o[c * plane + j] = (uint8_t)(rgb[c][j >> 1] >> (16 * (j & 1)));
      }
    }
  } else {
    uint8_t* o = out + (((size_t)n * H + r) * W + x0) * 3;
    if (kVec) {
      // Pixels 4q .. 4q + 3 are the 12 bytes R0 G0 B0 R1 | G1 B1 R2 G2 |
      // B2 R3 G3 B3 of words 3q .. 3q + 2.
      uint32_t w[12];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t r01 = rgb[0][2 * q], g01 = rgb[1][2 * q], b01 = rgb[2][2 * q];
        const uint32_t r23 = rgb[0][2 * q + 1], g23 = rgb[1][2 * q + 1], b23 = rgb[2][2 * q + 1];
        w[3 * q] = __byte_perm(__byte_perm(r01, g01, 0x0240u), b01, 0x2410u);
        w[3 * q + 1] = __byte_perm(__byte_perm(g01, b01, 0x0062u), __byte_perm(r23, g23, 0x0040u), 0x5410u);
        w[3 * q + 2] = __byte_perm(b23, __byte_perm(r23, g23, 0x0062u), 0x2540u);
      }
      uint4* o4 = reinterpret_cast<uint4*>(o);
      o4[0] = make_uint4(w[0], w[1], w[2], w[3]);
      o4[1] = make_uint4(w[4], w[5], w[6], w[7]);
      o4[2] = make_uint4(w[8], w[9], w[10], w[11]);
    } else {
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (x0 + j < W) {
#pragma unroll
          for (int c = 0; c < 3; ++c) o[3 * j + c] = (uint8_t)(rgb[c][j >> 1] >> (16 * (j & 1)));
        }
    }
  }
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

static bool aligned_to(const void* p, long long s_img, long long s_row, int m) {
  return (uintptr_t)p % m == 0 && s_img % m == 0 && s_row % m == 0;
}

// Kernel B (kPlanar false) or the 4:2:0 planar kernel: picks the
// instance from the pointers and strides, and launches once per 65,535
// images (the grid's z limit).
template <bool kPlanar>
static int launch_h2v2(const void* yp, long long ys_img, long long ys_row, const void* cbp,
                       long long cbs_img, long long cbs_row, const void* crp, long long crs_img,
                       long long crs_row, int N, int H, int W, int Hc, int Wc, void* out,
                       void* stream) {
  if (Hc != (H + 1) / 2 || Wc != (W + 1) / 2 || (kPlanar && (W & 1)))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W <= 0) return (int)cudaSuccess;
  const bool vec = aligned_to(yp, ys_img, ys_row, 16) && W % 16 == 0 && (uintptr_t)out % 16 == 0;
  auto chroma_aligned = [&](int m) {
    return aligned_to(cbp, cbs_img, cbs_row, m) && aligned_to(crp, crs_img, crs_row, m);
  };
  const int calign = chroma_aligned(16) ? 16 : chroma_aligned(8) ? 8 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t out_img = (size_t)3 * H * W;
  const int rows_per_block = tile::kRows * tile::kTiles;
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const dim3 grid((W + tile::kCols - 1) / tile::kCols, (H + rows_per_block - 1) / rows_per_block,
                    N - n0 < 65535 ? N - n0 : 65535);
    const Plane y{(const uint8_t*)yp + n0 * ys_img, ys_img, ys_row};
    const Plane cb{(const uint8_t*)cbp + n0 * cbs_img, cbs_img, cbs_row};
    const Plane cr{(const uint8_t*)crp + n0 * crs_img, crs_img, crs_row};
    uint8_t* o = (uint8_t*)out + n0 * out_img;
    if (vec)
      h2v2_tile_kernel<true, kPlanar><<<grid, tile::kThreads, 0, s>>>(y, cb, cr, H, W, Hc, Wc, calign, o);
    else
      h2v2_tile_kernel<false, kPlanar><<<grid, tile::kThreads, 0, s>>>(y, cb, cr, H, W, Hc, Wc, calign, o);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// The 4:2:2 planar kernel (the packed16 layout)
//
// Replaces _kernel_h2v1 run with packed_words=True
// (upsample_color_h2v1_batch as pipeline._color_stage(packed) calls it).
// It writes planar uint8 [N, 3, H, W], the bytes of the reference's
// column-packed uint16 [N, 3, H, W/2] (low byte = even column), so W must
// be even. One thread per horizontal output pixel pair (2p, 2p+1): it
// reads the luma pair as one 16-bit word, takes both columns' chroma taps
// from the three chroma columns p-1, p, p+1 they share (clamped at the
// plane's edge), and stores one 16-bit word per plane. Bound by bytes (2
// input bytes and 3 output bytes per pixel).
// ---------------------------------------------------------------------------

// Luma bytes 2p and 2p+1 of row r: one 16-bit load when the plane's base
// and strides are even, else two byte loads.
template <bool kAligned>
__device__ __forceinline__ void luma_pair(const Plane& y, int n, int r, int p, int& y0, int& y1) {
  const uint8_t* q = y.p + (size_t)n * y.s_img + (size_t)r * y.s_row + 2 * p;
  if (kAligned) {
    const uint16_t w = __ldg(reinterpret_cast<const uint16_t*>(q));
    y0 = w & 0xFF;
    y1 = w >> 8;
  } else {
    y0 = q[0];
    y1 = q[1];
  }
}

// RGB of the pair, each channel's two bytes as one little-endian word.
__device__ __forceinline__ void store_pair(uint16_t* out, size_t plane, int y0, int y1,
                                           int cb0, int cb1, int cr0, int cr1) {
  uint8_t a[3], b[3];
  tj_ycc_rgb(y0, cb0, cr0, a);
  tj_ycc_rgb(y1, cb1, cr1, b);
  out[0] = (uint16_t)(a[0] | (b[0] << 8));
  out[plane] = (uint16_t)(a[1] | (b[1] << 8));
  out[2 * plane] = (uint16_t)(a[2] | (b[2] << 8));
}

// 4:2:2: chroma row r at columns p-1, p and p+1; biases 1 and 2, shift 2.
__device__ __forceinline__ void h2v1_pair_taps(const Plane& c, int n, int r, int p, int Wc,
                                               int& e, int& o) {
  const int v = 3 * c.at(n, r, p);
  e = (v + c.at(n, r, max(p - 1, 0)) + 1) >> 2;
  o = (v + c.at(n, r, min(p + 1, Wc - 1)) + 2) >> 2;
}

template <bool kAligned>
__global__ void planar_h2v1_kernel(Plane y, Plane cb, Plane cr, int N, int H, int Wp, int Wc,
                                   uint16_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * H * Wp) return;
  const int p = (int)(i % Wp);
  const long long t = i / Wp;
  const int r = (int)(t % H), n = (int)(t / H);
  int y0, y1, cb0, cb1, cr0, cr1;
  luma_pair<kAligned>(y, n, r, p, y0, y1);
  h2v1_pair_taps(cb, n, r, p, Wc, cb0, cb1);
  h2v1_pair_taps(cr, n, r, p, Wc, cr0, cr1);
  const size_t plane = (size_t)H * Wp;
  store_pair(out + (size_t)n * 3 * plane + (size_t)r * Wp + p, plane, y0, y1, cb0, cb1, cr0, cr1);
}

static inline unsigned grid_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

extern "C" int tj_upsample_color_h2v2(const void* yp, long long ys_img, long long ys_row,
                                      const void* cbp, long long cbs_img, long long cbs_row,
                                      const void* crp, long long crs_img, long long crs_row,
                                      int N, int H, int W, int Hc, int Wc, void* out,
                                      void* stream) {
  return launch_h2v2<false>(yp, ys_img, ys_row, cbp, cbs_img, cbs_row, crp, crs_img, crs_row, N,
                            H, W, Hc, Wc, out, stream);
}

extern "C" int tj_upsample_color_h2v2_planar(const void* yp, long long ys_img, long long ys_row,
                                             const void* cbp, long long cbs_img, long long cbs_row,
                                             const void* crp, long long crs_img, long long crs_row,
                                             int N, int H, int W, int Hc, int Wc, void* out,
                                             void* stream) {
  return launch_h2v2<true>(yp, ys_img, ys_row, cbp, cbs_img, cbs_row, crp, crs_img, crs_row, N,
                           H, W, Hc, Wc, out, stream);
}

extern "C" int tj_upsample_color_h2v1(const void* yp, long long ys_img, long long ys_row,
                                      const void* cbp, long long cbs_img, long long cbs_row,
                                      const void* crp, long long crs_img, long long crs_row,
                                      int N, int H, int W, int Hc, int Wc, void* out,
                                      void* stream) {
  const long long total = (long long)N * H * W;
  if (total <= 0) return (int)cudaSuccess;
  if (Hc != H || Wc != (W + 1) / 2) return (int)cudaErrorInvalidValue;
  Plane y{(const uint8_t*)yp, ys_img, ys_row}, cb{(const uint8_t*)cbp, cbs_img, cbs_row},
      cr{(const uint8_t*)crp, crs_img, crs_row};
  h2v1_kernel<<<grid_for(total, 256), 256, 0, (cudaStream_t)stream>>>(y, cb, cr, N, H, W, Wc,
                                                                      (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int tj_color_444(const void* yp, long long ys_img, long long ys_row, const void* cbp,
                            long long cbs_img, long long cbs_row, const void* crp,
                            long long crs_img, long long crs_row, int N, int H, int W, void* out,
                            void* stream) {
  const long long total = (long long)N * H * W;
  if (total <= 0) return (int)cudaSuccess;
  Plane y{(const uint8_t*)yp, ys_img, ys_row}, cb{(const uint8_t*)cbp, cbs_img, cbs_row},
      cr{(const uint8_t*)crp, crs_img, crs_row};
  color_444_kernel<<<grid_for(total, 256), 256, 0, (cudaStream_t)stream>>>(y, cb, cr, N, H, W,
                                                                           (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int tj_upsample_color_h2v1_planar(const void* yp, long long ys_img, long long ys_row,
                                             const void* cbp, long long cbs_img, long long cbs_row,
                                             const void* crp, long long crs_img, long long crs_row,
                                             int N, int H, int W, int Hc, int Wc, void* out,
                                             void* stream) {
  if ((W & 1) || Wc != W / 2 || Hc != H) return (int)cudaErrorInvalidValue;
  const int Wp = W / 2;
  const long long total = (long long)N * H * Wp;
  if (total <= 0) return (int)cudaSuccess;
  Plane y{(const uint8_t*)yp, ys_img, ys_row}, cb{(const uint8_t*)cbp, cbs_img, cbs_row},
      cr{(const uint8_t*)crp, crs_img, crs_row};
  const bool aligned = ((uintptr_t)yp % 2 == 0) && (ys_img % 2 == 0) && (ys_row % 2 == 0);
  const unsigned grid = grid_for(total, 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned)
    planar_h2v1_kernel<true><<<grid, 256, 0, s>>>(y, cb, cr, N, H, Wp, Wc, (uint16_t*)out);
  else
    planar_h2v1_kernel<false><<<grid, 256, 0, s>>>(y, cb, cr, N, H, Wp, Wc, (uint16_t*)out);
  return (int)cudaGetLastError();
}
