// Kernel 6: dequant + un-zigzag + islow IDCT + level shift/clamp of
// zigzag int32 coefficient blocks, one thread per 8x8 block, u8 samples
// stored straight at their raster positions in [N, padded_h, padded_w].
//
// Replaces the Pallas kernel tpujpeg/kernels/idct.py _kernel
// (dequant_idct_islow_cm). That kernel worked coefficient-major, [64, N]
// with one vector lane per block, so every butterfly was a full-width
// row op on the TPU's VPU; the transposes into and out of that layout
// (pipeline._build_batch, _cm_to_planes) were extra passes over device
// memory. Here each thread reads its block's 256 contiguous bytes as 16
// int4 loads, keeps the block in registers (every index into it is a
// compile-time constant after unrolling), and writes 8 rows of 8 samples
// into the plane, so neither transpose exists.
//
// What bounds it on the H100: at the main path's size the bytes (256 B
// read and 64 B written per block) and the integer work (about 1,400
// int32 operations per block) ask for about the same time, so it sits
// near both roofs; the design moves each byte once and does each
// operation once, with the quantizers in shared memory.
//
// Quantizers: one zigzag [64] table for the whole batch, or one per image
// ([N, 64], per_image_q), staged for the images the thread block covers.
// An optional DC column (int32 [N * nb]) replaces coefficient slot 0
// before dequant: the progressive decoder keeps DC apart. Arithmetic is
// the shared tj_idct_islow_store (kernel A's), wrapping like int32.

#include "common.cuh"

__global__ void dequant_idct_islow_kernel(const int* __restrict__ coef,
                                          const int* __restrict__ qtab, int per_image_q,
                                          const int* __restrict__ dc, int n_images, int phb,
                                          int pwb, uint8_t* __restrict__ out) {
  extern __shared__ int s_q[];  // [span][64] zigzag order
  const long long nb = (long long)phb * pwb;
  const long long total = n_images * nb;
  const long long first = (long long)blockIdx.x * blockDim.x;
  int img0 = 0, span = 1;
  if (per_image_q) {
    const long long end = first + blockDim.x - 1;
    const long long last = end < total ? end : total - 1;
    img0 = (int)(first / nb);
    span = (int)(last / nb) - img0 + 1;
  }
  for (int i = threadIdx.x; i < span * 64; i += blockDim.x)
    s_q[i] = qtab[(size_t)img0 * 64 + i];
  __syncthreads();

  const long long blk = first + threadIdx.x;
  if (blk >= total) return;
  const int img = (int)(blk / nb);
  const int b = (int)(blk - img * nb);

  int zz[64];
  const int4* src = (const int4*)(coef + blk * 64);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int4 v = __ldg(src + i);
    zz[4 * i] = v.x;
    zz[4 * i + 1] = v.y;
    zz[4 * i + 2] = v.z;
    zz[4 * i + 3] = v.w;
  }
  if (dc) zz[0] = __ldg(dc + blk);
  const int* q = s_q + (per_image_q ? (img - img0) * 64 : 0);
  int nat[64];
#pragma unroll
  for (int n = 0; n < 64; ++n) {
    const int k = tj_natural_to_zigzag(n);
    nat[n] = (int)((u32)zz[k] * (u32)q[k]);
  }
  const int brow = b / pwb, bcol = b - brow * pwb;
  const size_t pitch = (size_t)pwb * 8;
  uint8_t* dst = out + ((size_t)img * phb * 8 + (size_t)brow * 8) * pitch + (size_t)bcol * 8;
  tj_idct_islow_store([&](int n) { return nat[n]; }, dst, pitch);
}

// coef: int32 [n_images, phb * pwb, 64] zigzag; qtab: int32 [64], or
// [n_images, 64] with per_image_q; dc: int32 [n_images * phb * pwb] or
// null; out: u8 [n_images, phb * 8, pwb * 8].
extern "C" int tj_dequant_idct_islow(const void* coef, const void* qtab, int per_image_q,
                                     const void* dc, int n_images, int phb, int pwb, void* out,
                                     void* stream) {
  const long long total = (long long)n_images * phb * pwb;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  const int span = per_image_q ? (n_images < threads ? n_images : threads) : 1;
  dequant_idct_islow_kernel<<<(unsigned)blocks, threads, sizeof(int) * 64 * span,
                              (cudaStream_t)stream>>>(
      (const int*)coef, (const int*)qtab, per_image_q, (const int*)dc, n_images, phb, pwb,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
