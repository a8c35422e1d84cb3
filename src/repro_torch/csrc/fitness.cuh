// The first launch of both fitness bodies (pso_fitness.cu, float, and
// fitness_quantized.cu): each problem's G columns packed once into device
// scratch as bit rows, which every particle CTA then copies with 16-byte
// loads.
//
// On an engine mesh G has degree <= 4, so the particle CTAs walk a
// column's set bits (__ffs) for S G instead of multiplying by zeros.
#pragma once

#include "common.cuh"

namespace {

// Problem blockIdx.x's G columns as bit rows (row j holds the k with
// G[k, j] != 0), from G staged in shared memory (m * m bytes, 16-byte
// aligned and rounded up to 16).
__global__ void __launch_bounds__(256)
pack_gin_kernel(const uint8_t* __restrict__ G, uint32_t* __restrict__ gin,
                int m) {
  extern __shared__ __align__(16) uint8_t gs[];
  const int p = blockIdx.x, mm = m * m;
  const uint8_t* g = G + (size_t)p * mm;
  if (((uintptr_t)g & 15) == 0 && (mm & 15) == 0) {
    for (int w = threadIdx.x; w < mm / 16; w += blockDim.x)
      reinterpret_cast<uint4*>(gs)[w] = reinterpret_cast<const uint4*>(g)[w];
  } else {
    for (int b = threadIdx.x; b < mm; b += blockDim.x) gs[b] = g[b];
  }
  __syncthreads();
  // a thread a word, neighbouring threads on neighbouring columns
  const int W = rt::words(m);
  uint32_t* out = gin + (size_t)p * m * W;
  for (int idx = threadIdx.x; idx < m * W; idx += blockDim.x) {
    const int w = idx / m, col = idx - w * m;
    uint32_t word = 0;
#pragma unroll 8
    for (int b = 0; b < 32; ++b) {
      const int r = w * 32 + b;
      if (r < m && gs[r * m + col] != 0) word |= 1u << b;
    }
    out[col * W + w] = word;
  }
}

// The same from G in device memory, for the wide path (m > kMaxDim),
// where m * m bytes may not fit in shared memory.
__global__ void __launch_bounds__(256)
pack_gin_wide_kernel(const uint8_t* __restrict__ G,
                     uint32_t* __restrict__ gin, int m) {
  const int p = blockIdx.x, W = rt::words(m);
  const uint8_t* g = G + (size_t)p * m * m;
  uint32_t* out = gin + (size_t)p * m * W;
  for (int idx = threadIdx.x; idx < m * W; idx += blockDim.x) {
    const int w = idx / m, col = idx - w * m;
    uint32_t word = 0;
    for (int b = 0; b < 32; ++b) {
      const int r = w * 32 + b;
      if (r >= m) break;
      if (g[(size_t)r * m + col] != 0) word |= 1u << b;
    }
    out[(size_t)col * W + w] = word;
  }
}

// Launches pack_gin_kernel (pack_gin_wide_kernel past kMaxDim) for P
// problems on `st`: scratch receives P * m * words(m) words.
inline cudaError_t pack_gin(const uint8_t* G, uint32_t* scratch, int P,
                            int m, cudaStream_t st) {
  if (m > rt::kMaxDim) {
    pack_gin_wide_kernel<<<P, 256, 0, st>>>(G, scratch, m);
    return cudaGetLastError();
  }
  const size_t gsmem = (size_t)rt::align16(m * m);
  cudaError_t err = rt::allow_smem((const void*)pack_gin_kernel, gsmem);
  if (err != cudaSuccess) return err;
  pack_gin_kernel<<<P, 256, gsmem, st>>>(G, scratch, m);
  return cudaGetLastError();
}

}  // namespace
