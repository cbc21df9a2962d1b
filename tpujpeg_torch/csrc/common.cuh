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

// YCbCr -> RGB for one pixel into o[0..2].
__device__ __forceinline__ void tj_ycc_rgb(int y, int cb, int cr, uint8_t* o) {
  cb -= 128;
  cr -= 128;
  o[0] = tj_clamp_u8(y + ((TJ_FIX_R_CR * cr + TJ_ONE_HALF) >> 16));
  o[1] = tj_clamp_u8(y + ((TJ_FIX_G_CB * cb + TJ_FIX_G_CR * cr + TJ_ONE_HALF) >> 16));
  o[2] = tj_clamp_u8(y + ((TJ_FIX_B_CB * cb + TJ_ONE_HALF) >> 16));
}
