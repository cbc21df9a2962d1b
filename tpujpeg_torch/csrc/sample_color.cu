// Kernels B, C and D: fancy chroma upsampling + YCbCr -> RGB, one thread
// per output pixel, reading the cropped Y/Cb/Cr planes in place (edges
// clamped at the planes' true height and width, libjpeg's edge rule) and
// writing NHWC uint8 [N, H, W, 3]. Below them, the planar 4:2:0 and 4:2:2
// kernels that write the reference's packed16 layout.
//
// Replace the Pallas kernels in tpujpeg/kernels/sample_color.py:
// _kernel_h2v2 (upsample_color_h2v2_batch), _kernel_h2v1
// (upsample_color_h2v1_batch) and _kernel_444 (color_444_batch). Those
// worked on phase-split, edge-padded strips with 8-row halo blocks and
// packed u16 output, all for Mosaic's layout rules; none of that carries
// over. Each thread computes its pixel's taps directly.
//
// What bounds them on the H100: device memory traffic, about 1.5 (4:2:0),
// 2 (4:2:2) or 3 (4:4:4) input bytes and 3 output bytes per pixel at
// 3.35 TB/s; neighbouring threads read neighbouring bytes, and the
// chroma taps they share hit in L1/L2. The 3-byte stores are what a
// later, vectorized version would widen.
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

// h2v2: output (n, y, x) from chroma row y/2 blended with the row above
// (even y) or below (odd y), then column x/2 with its left (even x) or
// right (odd x) neighbour.
__device__ __forceinline__ int h2v2_tap(const Plane& c, int n, int y, int x, int Hc, int Wc) {
  const int cy = y >> 1, cx = x >> 1;
  const int ny = (y & 1) ? min(cy + 1, Hc - 1) : max(cy - 1, 0);
  const int nx = (x & 1) ? min(cx + 1, Wc - 1) : max(cx - 1, 0);
  const int v0 = 3 * c.at(n, cy, cx) + c.at(n, ny, cx);
  const int v1 = 3 * c.at(n, cy, nx) + c.at(n, ny, nx);
  return (3 * v0 + v1 + ((x & 1) ? 7 : 8)) >> 4;
}

__device__ __forceinline__ int h2v1_tap(const Plane& c, int n, int y, int x, int Wc) {
  const int cx = x >> 1;
  const int nx = (x & 1) ? min(cx + 1, Wc - 1) : max(cx - 1, 0);
  return (3 * c.at(n, y, cx) + c.at(n, y, nx) + ((x & 1) ? 2 : 1)) >> 2;
}

__global__ void h2v2_kernel(Plane y, Plane cb, Plane cr, int N, int H, int W, int Hc, int Wc,
                            uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * H * W) return;
  const int x = (int)(i % W);
  const long long t = i / W;
  const int r = (int)(t % H), n = (int)(t / H);
  tj_ycc_rgb(y.at(n, r, x), h2v2_tap(cb, n, r, x, Hc, Wc), h2v2_tap(cr, n, r, x, Hc, Wc),
             out + i * 3);
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
// Planar kernels (4:2:0 and 4:2:2 into the reference's packed16 layout)
//
// Replace _kernel_h2v2 and _kernel_h2v1 run with packed_words=True
// (upsample_color_h2v2_batch / _h2v1_batch as pipeline._color_stage(packed)
// calls them), and the layout probes built on _kernel_h2v2: run_cur,
// run_cols, run_fused and run_fused_pre in tools/color_probe.py,
// color_kernel in tools/tail_variants.py and run_kernel in
// tools/color_profile.py. They write planar uint8 [N, 3, H, W], whose bytes
// are the reference's column-packed uint16 [N, 3, H, W/2] (low byte = even
// column), so W must be even.
//
// One thread per horizontal output pixel pair (2p, 2p+1): it reads the luma
// pair as one 16-bit word (P3/P4's idea: no phase split), takes both
// columns' chroma taps from the three chroma columns p-1, p, p+1 they share
// (clamped at the plane's edge), and stores one 16-bit word per plane:
// three coalesced 2-byte stores in place of kernel B's 3-byte one. Bound by
// bytes, as kernels B and C are (1.5 or 2 input bytes and 3 output bytes per
// pixel).
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

// 4:2:0: chroma row r/2 blended with the row above (even r) or below (odd
// r), at columns p-1, p and p+1; even column biases 8, odd 7, shift 4.
__device__ __forceinline__ void h2v2_pair_taps(const Plane& c, int n, int r, int p, int Hc, int Wc,
                                               int& e, int& o) {
  const int cy = r >> 1;
  const int ny = (r & 1) ? min(cy + 1, Hc - 1) : max(cy - 1, 0);
  const int pl = max(p - 1, 0), pr = min(p + 1, Wc - 1);
  const int vl = 3 * c.at(n, cy, pl) + c.at(n, ny, pl);
  const int vc = 3 * c.at(n, cy, p) + c.at(n, ny, p);
  const int vr = 3 * c.at(n, cy, pr) + c.at(n, ny, pr);
  e = (3 * vc + vl + 8) >> 4;
  o = (3 * vc + vr + 7) >> 4;
}

// 4:2:2: chroma row r at columns p-1, p and p+1; biases 1 and 2, shift 2.
__device__ __forceinline__ void h2v1_pair_taps(const Plane& c, int n, int r, int p, int Wc,
                                               int& e, int& o) {
  const int v = 3 * c.at(n, r, p);
  e = (v + c.at(n, r, max(p - 1, 0)) + 1) >> 2;
  o = (v + c.at(n, r, min(p + 1, Wc - 1)) + 2) >> 2;
}

template <bool kAligned, bool kH2V2>
__global__ void planar_kernel(Plane y, Plane cb, Plane cr, int N, int H, int Wp, int Hc, int Wc,
                              uint16_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * H * Wp) return;
  const int p = (int)(i % Wp);
  const long long t = i / Wp;
  const int r = (int)(t % H), n = (int)(t / H);
  int y0, y1, cb0, cb1, cr0, cr1;
  luma_pair<kAligned>(y, n, r, p, y0, y1);
  if (kH2V2) {
    h2v2_pair_taps(cb, n, r, p, Hc, Wc, cb0, cb1);
    h2v2_pair_taps(cr, n, r, p, Hc, Wc, cr0, cr1);
  } else {
    h2v1_pair_taps(cb, n, r, p, Wc, cb0, cb1);
    h2v1_pair_taps(cr, n, r, p, Wc, cr0, cr1);
  }
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
  const long long total = (long long)N * H * W;
  if (total <= 0) return (int)cudaSuccess;
  if (Hc != (H + 1) / 2 || Wc != (W + 1) / 2) return (int)cudaErrorInvalidValue;
  Plane y{(const uint8_t*)yp, ys_img, ys_row}, cb{(const uint8_t*)cbp, cbs_img, cbs_row},
      cr{(const uint8_t*)crp, crs_img, crs_row};
  h2v2_kernel<<<grid_for(total, 256), 256, 0, (cudaStream_t)stream>>>(y, cb, cr, N, H, W, Hc, Wc,
                                                                      (uint8_t*)out);
  return (int)cudaGetLastError();
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

template <bool kH2V2>
static int launch_planar(const void* yp, long long ys_img, long long ys_row, const void* cbp,
                         long long cbs_img, long long cbs_row, const void* crp, long long crs_img,
                         long long crs_row, int N, int H, int W, int Hc, int Wc, void* out,
                         void* stream) {
  if ((W & 1) || Wc != W / 2 || Hc != (kH2V2 ? (H + 1) / 2 : H)) return (int)cudaErrorInvalidValue;
  const int Wp = W / 2;
  const long long total = (long long)N * H * Wp;
  if (total <= 0) return (int)cudaSuccess;
  Plane y{(const uint8_t*)yp, ys_img, ys_row}, cb{(const uint8_t*)cbp, cbs_img, cbs_row},
      cr{(const uint8_t*)crp, crs_img, crs_row};
  const bool aligned = ((uintptr_t)yp % 2 == 0) && (ys_img % 2 == 0) && (ys_row % 2 == 0);
  const unsigned grid = grid_for(total, 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned)
    planar_kernel<true, kH2V2><<<grid, 256, 0, s>>>(y, cb, cr, N, H, Wp, Hc, Wc, (uint16_t*)out);
  else
    planar_kernel<false, kH2V2><<<grid, 256, 0, s>>>(y, cb, cr, N, H, Wp, Hc, Wc, (uint16_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int tj_upsample_color_h2v2_planar(const void* yp, long long ys_img, long long ys_row,
                                             const void* cbp, long long cbs_img, long long cbs_row,
                                             const void* crp, long long crs_img, long long crs_row,
                                             int N, int H, int W, int Hc, int Wc, void* out,
                                             void* stream) {
  return launch_planar<true>(yp, ys_img, ys_row, cbp, cbs_img, cbs_row, crp, crs_img, crs_row, N,
                             H, W, Hc, Wc, out, stream);
}

extern "C" int tj_upsample_color_h2v1_planar(const void* yp, long long ys_img, long long ys_row,
                                             const void* cbp, long long cbs_img, long long cbs_row,
                                             const void* crp, long long crs_img, long long crs_row,
                                             int N, int H, int W, int Hc, int Wc, void* out,
                                             void* stream) {
  return launch_planar<false>(yp, ys_img, ys_row, cbp, cbs_img, cbs_row, crp, crs_img, crs_row, N,
                              H, W, Hc, Wc, out, stream);
}
