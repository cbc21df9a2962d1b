// Kernels B, C and D: fancy chroma upsampling + YCbCr -> RGB, one thread
// per output pixel, reading the cropped Y/Cb/Cr planes in place (edges
// clamped at the planes' true height and width, libjpeg's edge rule) and
// writing NHWC uint8 [N, H, W, 3].
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
