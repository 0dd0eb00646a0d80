// Shared helpers of the port's CUDA kernels (built with -fmad=false).
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#define PDR_FULL_MASK 0xffffffffu

// Squared distance with every product and sum rounded on its own, in the
// order the JAX reference uses: (dx*dx + dy*dy) + dz*dz.  An FMA-contracted
// form differs in the last bit, which can move a point across a radius
// boundary or change an FPS argmax.
__device__ __forceinline__ float pdr_sqdist3(float ax, float ay, float az,
                                             float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Every C entry returns the launch's error state (0 = cudaSuccess).
#define PDR_RETURN_LAUNCH_ERROR() return static_cast<int>(cudaGetLastError())
