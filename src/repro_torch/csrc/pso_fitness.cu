// Edge-preserving PSO fitness  f = -||Q - S G S^T||_F^2  per particle, the
// float body, batched over problems that each carry their own Q and G.
//
// Replaces the TPU kernel edge_fitness_pallas (_fitness_kernel in
// src/repro/kernels/pso_fitness.py); the fixed-point body is
// fitness_quantized.cu.
//
// Bound on the H100: at 56x144 the S G S^T product is ~0.45 M multiply-
// adds per particle on a 32 KB tile, so fp32 operations on CUDA cores
// bound it (no TF32: the body must match the plain version to the last
// bit). Design: one CTA per (problem, particle) packs G's columns, holds
// its S tile, S G and the squared residual in shared memory with an odd
// row stride (no bank conflicts when a warp walks rows), and sums in the
// plain version's order (fitness.cuh), bitwise equal to kernels/ref.py.
#include "fitness.cuh"

namespace {

constexpr int kThreads = 256;

// Only fitness_kernel<false> is instantiated: the template keeps the symbol
// the float kernel has had since it was written, under which kernel_ab.py
// holds its SASS against earlier builds.
template <bool QUANT>
__global__ void fitness_kernel(const void* __restrict__ S_,
                               const uint8_t* __restrict__ Q,
                               const uint8_t* __restrict__ G,
                               float* __restrict__ out, int N, int n, int m,
                               int scale) {
  static_assert(!QUANT, "the quantized body is fitness_quantized.cu");
  const int p = blockIdx.y, part = blockIdx.x;
  const int W = rt::words(m);
  const int ld = rt::odd_stride(m), ldn = rt::odd_stride(n);
  extern __shared__ long long sm64[];
  uint32_t* Gin = reinterpret_cast<uint32_t*>(sm64 + 32);       // m * W
  float* St = reinterpret_cast<float*>(Gin + m * W);            // n * ld
  float* SG = St + n * ld;                                      // n * ld
  float* R2 = SG + n * ld;                                      // n * ldn
  float* rows = R2 + n * ldn;                                   // n
  float* bcast = rows + n;                                      // 1

  rt::pack_cols(G + (size_t)p * m * m, m, Gin);
  const size_t base = ((size_t)p * N + part) * n * m;
  const uint8_t* q = Q + (size_t)p * n * n;
  for (int idx = threadIdx.x; idx < n * m; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    St[i * ld + j] = static_cast<const float*>(S_)[base + idx];
  }
  __syncthreads();
  const float f =
      rt::fitness_f32(St, SG, R2, rows, bcast, Gin, q, n, m, ld, ldn);
  if (threadIdx.x == 0) out[(size_t)p * N + part] = f;
}

size_t smem_bytes(int n, int m) {
  const int W = rt::words(m), ld = rt::odd_stride(m);
  return sizeof(long long) * 32 +
         sizeof(uint32_t) * ((size_t)m * W + 2 * (size_t)n * ld +
                             (size_t)n * rt::odd_stride(n) + n + 1);
}

}  // namespace

extern "C" int edge_fitness_f32(const void* S, const void* Q, const void* G,
                                void* out, int P, int N, int n, int m,
                                void* stream) {
  const size_t smem = smem_bytes(n, m);
  cudaError_t err =
      rt::allow_smem((const void*)fitness_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, P);
  fitness_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      S, (const uint8_t*)Q, (const uint8_t*)G, (float*)out, N, n, m, 1);
  return (int)cudaGetLastError();
}
