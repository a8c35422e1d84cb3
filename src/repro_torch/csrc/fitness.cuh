// Block-wide edge-preserving fitness of one particle, shared by
// pso_fitness.cu and epoch_fused.cu.
//
// The tile S (n x m, row stride ld) is in shared memory. G enters as bit
// columns Gin (row j holds the k with G[k, j] = 1): on an engine mesh G has
// degree <= 4, so S G walks the set bits (__ffs) instead of multiplying by
// zeros. Skipping a +0.0 term leaves a float sum unchanged, so every sum
// below equals the dense left-to-right sum of the plain version
// (kernels/ref.py): SG[i, j] over k ascending, SGS[i, u] over j ascending,
// the squared residual over u within a row, then over rows.
#pragma once

#include "common.cuh"

namespace rt {

// -||Q - S G S^T||^2 in float32; the result reaches every thread.
__device__ inline float fitness_f32(const float* S, float* SG, float* R2,
                                    float* rows, float* bcast,
                                    const uint32_t* Gin, const uint8_t* q,
                                    int n, int m, int ld, int ldn) {
  const int W = words(m);
  for (int idx = threadIdx.x; idx < n * m; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    float acc = 0.0f;
    for (int w = 0; w < W; ++w) {
      uint32_t bits = Gin[j * W + w];
      while (bits) {
        const int k = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        acc = acc + S[i * ld + k];
      }
    }
    SG[i * ld + j] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, u = idx - i * n;
    const float* sg = SG + i * ld;
    const float* su = S + u * ld;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) acc = acc + sg[j] * su[j];
    const float r = (float)q[idx] - acc;
    R2[i * ldn + u] = r * r;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float acc = 0.0f;
    for (int u = 0; u < n; ++u) acc = acc + R2[i * ldn + u];
    rows[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    for (int i = 0; i < n; ++i) tot = tot + rows[i];
    *bcast = -tot;
  }
  __syncthreads();
  const float f = *bcast;
  __syncthreads();
  return f;
}

// Fixed-point body: uint8-valued S (held as int), int32 MACs, the squared
// int32 residual Q*scale^2 - S G S^T summed exactly in int64, returned as
// -(float)sum to every thread.
__device__ inline float fitness_u8(const int* S, int* SG,
                                   long long* part_sums, float* bcast,
                                   const uint32_t* Gin, const uint8_t* q,
                                   int n, int m, int ld, int scale) {
  const int W = words(m);
  for (int idx = threadIdx.x; idx < n * m; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    int acc = 0;
    for (int w = 0; w < W; ++w) {
      uint32_t bits = Gin[j * W + w];
      while (bits) {
        const int k = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        acc += S[i * ld + k];
      }
    }
    SG[i * ld + j] = acc;
  }
  __syncthreads();
  long long local = 0;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, u = idx - i * n;
    const int* sg = SG + i * ld;
    const int* su = S + u * ld;
    int acc = 0;
    for (int j = 0; j < m; ++j) acc += sg[j] * su[j];
    const long long r = (long long)((int)q[idx] * scale * scale - acc);
    local += r * r;
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) part_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long tot = 0;
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) tot += part_sums[w];
    *bcast = -__ll2float_rn(tot);
  }
  __syncthreads();
  const float f = *bcast;
  __syncthreads();
  return f;
}

}  // namespace rt
