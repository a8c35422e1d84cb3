// The first launch of both fitness bodies (pso_fitness.cu, float, and
// fitness_quantized.cu): each problem's G columns packed once into device
// scratch as bit rows, which every particle CTA then copies with 16-byte
// loads.
//
// On an engine mesh G has degree <= 4, so the particle CTAs walk a
// column's set bits (__ffs) for S G instead of multiplying by zeros.
// Past n, m = 256 both bodies also split a particle's rows over several
// CTAs (pso_fitness.cu, fitness_quantized.cu), which the helpers at the
// end of this file serve.
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

// The same from G in device memory, for the wide path (m > kMaxDim,
// where m * m bytes may not fit in shared memory, or a row-split body):
// a thread a word (column col, rows 32 w..32 w + 31), neighbouring
// threads on neighbouring columns, its 32 byte loads issued at once, and
// grid (words / 256, P).
// One CTA a problem walking its words in turn took 0.35 ms at m = 528 on
// the H100, ahead of the fitness itself at (56, 528) (PERF.md). The grid
// also zeroes the `clear_words` words at `clear`: the row-split bodies'
// tickets and partial sums.
__global__ void __launch_bounds__(256)
pack_gin_wide_kernel(const uint8_t* __restrict__ G,
                     uint32_t* __restrict__ gin, int m,
                     uint32_t* __restrict__ clear, int clear_words) {
  const int p = blockIdx.y, W = rt::words(m);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int gid = idx + blockIdx.y * gridDim.x * blockDim.x;
  for (int c = gid; c < clear_words; c += gridDim.x * gridDim.y * blockDim.x)
    clear[c] = 0u;
  if (idx >= m * W) return;
  const uint8_t* g = G + (size_t)p * m * m;
  const int w = idx / m, col = idx - w * m;
  uint8_t v[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int r = w * 32 + b;
    v[b] = r < m ? __ldg(g + (size_t)r * m + col) : 0;
  }
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) word |= (v[b] != 0 ? 1u : 0u) << b;
  gin[(size_t)p * m * W + (size_t)col * W + w] = word;
}

// Launches pack_gin_kernel (pack_gin_wide_kernel past kMaxDim) for P
// problems on `st`: scratch receives P * m * words(m) words. With
// `clear_words` > 0 (a row-split body, wide by n or m) pack_gin_wide_kernel
// also zeroes that many words at `clear`, so that a call stays two
// launches. What lies there is owned by the row-split bodies: the float
// body's tickets (pso_fitness.cu, Scratch), the quantized body's 64-bit
// sums and tickets (fitness_quantized.cu, QScratch); a change to either
// layout changes the `clear` and `clear_words` its caller passes here.
inline cudaError_t pack_gin(const uint8_t* G, uint32_t* scratch, int P,
                            int m, cudaStream_t st, uint32_t* clear = nullptr,
                            int clear_words = 0) {
  if (m > rt::kMaxDim || clear_words > 0) {
    const int blocks = (m * rt::words(m) + 255) / 256;
    pack_gin_wide_kernel<<<dim3(blocks, P), 256, 0, st>>>(G, scratch, m,
                                                          clear, clear_words);
    return cudaGetLastError();
  }
  const size_t gsmem = (size_t)rt::align16(m * m);
  cudaError_t err = rt::allow_smem((const void*)pack_gin_kernel, gsmem);
  if (err != cudaSuccess) return err;
  pack_gin_kernel<<<P, 256, gsmem, st>>>(G, scratch, m);
  return cudaGetLastError();
}

// Asynchronous 16-byte copies into shared memory (the row-split bodies'
// staged chunks of S): src_bytes < 16 fills the rest with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Calls f(k) for each set bit k of a packed G column (W words at `col`,
// k ascending). The words are loaded 8 at a time, all before their walk,
// so that a thread waits out the loads' latency once for every 8.
template <typename F>
__device__ __forceinline__ void walk_column(const uint32_t* __restrict__ col,
                                            int W, F&& f) {
  for (int w0 = 0; w0 < W; w0 += 8) {
    uint32_t gb[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) gb[x] = w0 + x < W ? __ldg(col + w0 + x) : 0u;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      uint32_t bits = gb[x];
      while (bits) {
        const int k = (w0 + x) * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        f(k);
      }
    }
  }
}

// The number of SMs of the current device, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace
