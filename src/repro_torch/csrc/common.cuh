// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is launched from a plain C entry point (extern "C") that
// takes raw device pointers and a cudaStream_t, launches on that stream,
// and returns cudaGetLastError(). Nothing here allocates or synchronises.
//
// Bit rows. The matcher's 0/1 matrices (masks, candidate sets, the
// adjacency of Q and G) are held in shared memory as rows of 32-bit
// words: bit b of word w of row r is entry (r, 32*w + b). With n, m <= 256
// a row is at most 8 words, and every Ullmann support test becomes an AND
// and a non-zero check, exact like the integer products it replaces.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int kMaxDim = 256;          // n, m <= kMaxDim (8 words a row)
constexpr int kLaneBits = kMaxDim / 32;   // a lane's bits of a transposed row
constexpr float kNeg = -FLT_MAX;      // finfo(float32).min, the sentinel

__host__ __device__ inline int words(int cols) { return (cols + 31) >> 5; }

// Row stride of a float tile in shared memory: odd, so that threads
// walking consecutive rows at one column hit 32 different banks (a stride
// of 144 words would put them on 2 banks, a 16-way conflict).
__host__ __device__ inline int odd_stride(int cols) { return cols | 1; }

// Layout arithmetic of the kernels' shared-memory and scratch offsets.
__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int round_up(int x, int a) {
  return (x + a - 1) / a * a;
}
// A row stride of `a`-element chunks, an odd number of them: 16-byte
// (8-byte) loads by lanes walking consecutive rows then hit distinct banks.
__host__ __device__ inline int odd_chunks(int cols, int a) {
  const int x = round_up(cols, a);
  return (x / a) % 2 ? x : x + a;
}

// Pack rows x[r, c] != 0 of a row-major (rows, cols) byte matrix into bit
// rows (rows * words(cols) words), one word per thread iteration.
template <typename T>
__device__ inline void pack_rows(const T* __restrict__ x, int rows, int cols,
                                 uint32_t* bits) {
  const int W = words(cols);
  for (int idx = threadIdx.x; idx < rows * W; idx += blockDim.x) {
    const int r = idx / W, w = idx - r * W;
    uint32_t word = 0;
    for (int b = 0; b < 32; ++b) {
      const int c = w * 32 + b;
      if (c >= cols) break;
      if (x[(size_t)r * cols + c] != 0) word |= 1u << b;
    }
    bits[idx] = word;
  }
}

// Pack the columns of a square byte matrix: row c of the result holds the
// bits r with x[r, c] != 0.
template <typename T>
__device__ inline void pack_cols(const T* __restrict__ x, int dim,
                                 uint32_t* bits) {
  const int W = words(dim);
  for (int idx = threadIdx.x; idx < dim * W; idx += blockDim.x) {
    const int c = idx / W, w = idx - c * W;
    uint32_t word = 0;
    for (int b = 0; b < 32; ++b) {
      const int r = w * 32 + b;
      if (r >= dim) break;
      if (x[(size_t)r * dim + c] != 0) word |= 1u << b;
    }
    bits[idx] = word;
  }
}

__device__ inline bool test_bit(const uint32_t* row, int c) {
  return (row[c >> 5] >> (c & 31)) & 1u;
}

__device__ inline bool intersects(const uint32_t* a, const uint32_t* b,
                                  int W) {
  uint32_t acc = 0;
  for (int w = 0; w < W; ++w) acc |= a[w] & b[w];
  return acc != 0;
}

__device__ inline int popcount_row(const uint32_t* a, int W) {
  int c = 0;
  for (int w = 0; w < W; ++w) c += __popc(a[w]);
  return c;
}

// One Ullmann sweep on bit rows M (n x W), in place:
//   SO[u] = { j : M[u] & Gout[j] != 0 }   (u has a candidate v with j->v)
//   SI[u] = { j : M[u] & Gin[j]  != 0 }   (u has a candidate v with v->j)
//   M[i] &= AND_{u : Q[i,u]} SO[u]  &  AND_{u : Q[u,i]} SI[u]
// which keeps (i, j) iff no neighbour of i lost its support at j: exactly
// the (viol == 0) test of the integer form. Returns (per thread) whether a
// word it owns changed. Ends with __syncthreads().
__device__ inline bool ullmann_sweep(uint32_t* M, const uint32_t* Gout,
                                     const uint32_t* Gin,
                                     const uint32_t* Qrow,
                                     const uint32_t* Qcol, uint32_t* SO,
                                     uint32_t* SI, int n, int m) {
  const int W = words(m), Wn = words(n);
  for (int idx = threadIdx.x; idx < n * W; idx += blockDim.x) {
    const int u = idx / W, w = idx - u * W;
    uint32_t so = 0, si = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = w * 32 + b;
      if (j >= m) break;
      if (intersects(M + u * W, Gout + j * W, W)) so |= 1u << b;
      if (intersects(M + u * W, Gin + j * W, W)) si |= 1u << b;
    }
    SO[idx] = so;
    SI[idx] = si;
  }
  __syncthreads();
  bool changed = false;
  for (int idx = threadIdx.x; idx < n * W; idx += blockDim.x) {
    const int i = idx / W, w = idx - i * W;
    const uint32_t old = M[idx];
    uint32_t x = old;
    for (int wu = 0; wu < Wn; ++wu) {
      uint32_t out_nb = Qrow[i * Wn + wu];
      while (out_nb) {
        const int u = wu * 32 + __ffs(out_nb) - 1;
        out_nb &= out_nb - 1;
        x &= SO[u * W + w];
      }
      uint32_t in_nb = Qcol[i * Wn + wu];
      while (in_nb) {
        const int u = wu * 32 + __ffs(in_nb) - 1;
        in_nb &= in_nb - 1;
        x &= SI[u * W + w];
      }
    }
    M[idx] = x;
    changed |= (x != old);
  }
  __syncthreads();
  return changed;
}

// Block-wide argmax of (value, index) pairs: the largest value, ties to
// the smallest index (jnp.argmax / torch.argmax order). sv and si hold 33
// entries each. Every thread gets the result. Contains __syncthreads().
__device__ inline void block_argmax(float v, int idx, float* sv, int* si,
                                    float* out_v, int* out_i) {
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(full, v, off);
    const int oi = __shfl_down_sync(full, idx, off);
    if (ov > v || (ov == v && oi < idx)) { v = ov; idx = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = idx; }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? sv[lane] : kNeg;
    idx = lane < nwarps ? si[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(full, v, off);
      const int oi = __shfl_down_sync(full, idx, off);
      if (ov > v || (ov == v && oi < idx)) { v = ov; idx = oi; }
    }
    if (lane == 0) { sv[32] = v; si[32] = idx; }
  }
  __syncthreads();
  *out_v = sv[32];
  *out_i = si[32];
  __syncthreads();
}

// All ones in the first `bits` bits of a bit row of words(bits) words.
__device__ inline void fill_bits(uint32_t* row, int bits) {
  for (int w = threadIdx.x; w < words(bits); w += blockDim.x)
    row[w] = (w * 32 + 32 <= bits) ? 0xffffffffu
                                   : ((1u << (bits - w * 32)) - 1u);
}

// ref.greedy_project of one (n, m) S: n rounds of a masked global argmax
// over the flat index i*m + j (ties to the smallest index), each taken
// entry knocking out its row and column. An entry is taken only if its
// value is above finfo(float32).min. Writes asg[i] = j, or -1 for a row
// left empty. S may live in shared or global memory; mask is bit rows
// (n x words(m)); rows (words(n)), cols (words(m)) and red_v / red_i (33
// each) are scratch in shared memory. Ends with __syncthreads().
__device__ inline void greedy_assign(const float* S, const uint32_t* mask,
                                     uint32_t* rows, uint32_t* cols,
                                     int* asg, float* red_v, int* red_i,
                                     int n, int m) {
  const int W = words(m), nm = n * m;
  fill_bits(cols, m);
  fill_bits(rows, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) asg[i] = -1;
  __syncthreads();
  for (int round = 0; round < n; ++round) {
    float v = kNeg;
    int vi = INT32_MAX;
    for (int f = threadIdx.x; f < nm; f += blockDim.x) {
      const int i = f / m, j = f - i * m;
      if (test_bit(rows, i) && test_bit(cols, j) &&
          test_bit(mask + i * W, j)) {
        const float x = S[f];
        if (x > v || vi == INT32_MAX) { v = x; vi = f; }
      }
    }
    float best;
    int bf;
    block_argmax(v, vi, red_v, red_i, &best, &bf);
    if (threadIdx.x == 0 && best > kNeg) {
      const int i = bf / m, j = bf - i * m;
      asg[i] = j;
      rows[i >> 5] &= ~(1u << (i & 31));
      cols[j >> 5] &= ~(1u << (j & 31));
    }
    __syncthreads();
  }
}

// Copy `bytes` bytes with 16-byte loads where both ends allow it.
__device__ inline void copy_bytes(uint8_t* dst, const uint8_t* src,
                                  int bytes) {
  if (((uintptr_t)src & 15) == 0 && (bytes & 15) == 0) {
    for (int w = threadIdx.x; w < bytes / 16; w += blockDim.x)
      reinterpret_cast<uint4*>(dst)[w] =
          reinterpret_cast<const uint4*>(src)[w];
  } else {
    for (int b = threadIdx.x; b < bytes; b += blockDim.x) dst[b] = src[b];
  }
}

// Lane-transposed 0/1 matrices: byte X[r * 32 + l] holds in bit k the entry
// (r, l + 32 k), so that lane l of a warp owns the columns l + 32 k of a row
// (kLaneBits bits). A row is 32 bytes, two 16-byte words.

// Lane-transposed rows of a row-major (rows, cols) byte matrix x in shared
// memory: bit k of out[r * 32 + l] is x[r, l + 32 k] != 0.
__device__ inline void pack_rows_t(const uint8_t* x, int rows, int cols,
                                   uint8_t* out) {
  for (int idx = threadIdx.x; idx < rows * 32; idx += blockDim.x) {
    const int r = idx >> 5, l = idx & 31;
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < kLaneBits; ++k) {
      const int c = l + 32 * k;
      if (c < cols && x[r * cols + c] != 0) byte |= 1u << k;
    }
    out[idx] = (uint8_t)byte;
  }
}

// Lane-transposed columns of a square byte matrix x in shared memory: bit k
// of out[c * 32 + l] is x[l + 32 k, c] != 0 (neighbouring threads read
// neighbouring columns).
__device__ inline void pack_cols_t(const uint8_t* x, int dim, uint8_t* out) {
  for (int idx = threadIdx.x; idx < dim * 32; idx += blockDim.x) {
    const int l = idx / dim, c = idx - l * dim;
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < kLaneBits; ++k) {
      const int r = l + 32 * k;
      if (r < dim && x[r * dim + c] != 0) byte |= 1u << k;
    }
    out[c * 32 + l] = (uint8_t)byte;
  }
}

__device__ __forceinline__ void or4(uint4& a, const uint4& b) {
  a.x |= b.x;
  a.y |= b.y;
  a.z |= b.z;
  a.w |= b.w;
}

__device__ __forceinline__ void reduce_or4(uint4& a) {
  a.x = __reduce_or_sync(0xffffffffu, a.x);
  a.y = __reduce_or_sync(0xffffffffu, a.y);
  a.z = __reduce_or_sync(0xffffffffu, a.z);
  a.w = __reduce_or_sync(0xffffffffu, a.w);
}

// Byte `lane` of a 32-byte transposed row held as two words of 16 bytes.
__device__ __forceinline__ uint32_t byte_of(const uint4& lo, const uint4& hi,
                                            int lane) {
  const int w = (lane >> 2) & 3;
  const uint4& q = lane < 16 ? lo : hi;
  const uint32_t word = w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
  return (word >> (8 * (lane & 3))) & 0xffu;
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rt
