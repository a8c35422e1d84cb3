// Edge-preserving PSO fitness  f = -||Q - S G S^T||_F^2  per particle, the
// fixed-point body: uint8 S ~ S * scale, integer products, the squared
// residual summed exactly; batched over problems with their own Q and G.
//
// Replaces the TPU kernel edge_fitness_quantized_pallas
// (_fitness_kernel_quantized in src/repro/kernels/pso_fitness.py).
//
// Bound on the H100: integer operations, ~0.45 M multiply-adds per
// particle at 56x144, and under them the latency of shared-memory loads
// and the occupancy that hides it. The design is epoch_fused.cu's
// quantized step, whose costs were timed phase by phase (PERF.md):
//  * a first launch packs each problem's G columns once into device
//    scratch (fitness.cuh); a CTA copies its problem's with 16-byte loads;
//  * one CTA per (problem, particle) holds S as bytes and S G as 16-bit
//    words (<= 255 m) with an odd-chunk row stride, so that 8-byte (16-
//    byte) loads by lanes walking consecutive rows hit distinct banks;
//  * S G walks each column's G bits once for 8 rows;
//  * S G S^T runs on __dp2a over a 4 x 4 block of (i, u) pairs per thread,
//    accumulated unsigned (at m = 256 a sum reaches ~4.3e9, above 2^31);
//  * ~29 KB of shared memory at (56, 144): one wave of the main path's
//    512 CTAs at 4 or more an SM.
// The squared residual Q scale^2 - S G S^T is summed in 64 bits, wrapping
// as the plain version's int64 arithmetic does (kernels/ref.py), so the
// result is bitwise equal to it. Past n, m = 256 (kMaxDim) the wide body
// (fitness_u8_wide_kernel, below) holds S G in 32 bits and S G S^T in 64.
#include "fitness.cuh"

namespace {

constexpr int kThreads = 256;

using rt::align16;
using rt::odd_chunks;
using rt::round_up;

// Byte offsets of a quantized CTA's shared memory.
struct QLayout {
  int W, ldb, ldh;         // words of a bit row; S (bytes), S G (halfs)
  int gin, parts, sq, sg, total;
};

__host__ __device__ inline QLayout qlayout(int n, int m) {
  QLayout L;
  L.W = rt::words(m);
  L.ldb = odd_chunks(m, 8);
  L.ldh = odd_chunks(m, 8);
  L.gin = 0;
  L.parts = align16(4 * m * L.W);
  L.sq = L.parts + 8 * 32;
  L.sg = align16(L.sq + n * L.ldb);
  L.total = align16(L.sg + 2 * n * L.ldh);
  return L;
}

// Launch 2 of the quantized body: one particle (blockIdx.x) of one problem
// (blockIdx.y).
__global__ void __launch_bounds__(kThreads, 4)
fitness_u8_kernel(const uint8_t* __restrict__ S,
                  const uint32_t* __restrict__ gin_all,
                  const uint8_t* __restrict__ Q, float* __restrict__ out,
                  int N, int n, int m, int scale) {
  const int p = blockIdx.y, part = blockIdx.x, tid = threadIdx.x;
  const int nt = blockDim.x;
  const QLayout L = qlayout(n, m);
  const int W = L.W, ldb = L.ldb, ldh = L.ldh;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* Gin = reinterpret_cast<uint32_t*>(smem + L.gin);
  long long* part_sums = reinterpret_cast<long long*>(smem + L.parts);
  uint8_t* Sq = smem + L.sq;
  uint16_t* SGh = reinterpret_cast<uint16_t*>(smem + L.sg);

  // the problem's G columns, then the particle's bytes and zero columns up
  // to a multiple of 8 (the dot products read them)
  {
    const uint4* src =
        reinterpret_cast<const uint4*>(gin_all + (size_t)p * m * W);
    const int words = m * W;
    if ((words & 3) == 0) {
      for (int w = tid; w < words / 4; w += nt)
        reinterpret_cast<uint4*>(Gin)[w] = src[w];
    } else {
      const uint32_t* s32 = gin_all + (size_t)p * m * W;
      for (int w = tid; w < words; w += nt) Gin[w] = s32[w];
    }
  }
  const size_t base = ((size_t)p * N + part) * n * m;
  if ((m & 15) == 0 && ((uintptr_t)(S + base) & 15) == 0) {
    const int cpr = m >> 4;                   // 16-byte chunks a row
    for (int g = tid; g < n * cpr; g += nt) {
      const int i = g / cpr, c = g - i * cpr;
      const uint4 v = reinterpret_cast<const uint4*>(S + base + i * m)[c];
      uint2* dst = reinterpret_cast<uint2*>(Sq + i * ldb + 16 * c);
      dst[0] = make_uint2(v.x, v.y);
      dst[1] = make_uint2(v.z, v.w);
    }
  } else {
    for (int idx = tid; idx < n * m; idx += nt) {
      const int i = idx / m;
      Sq[i * ldb + idx - i * m] = S[base + idx];
    }
  }
  const int pad = round_up(m, 8) - m;
  for (int idx = tid; idx < n * pad; idx += nt)
    Sq[idx / pad * ldb + m + idx % pad] = 0;
  __syncthreads();

  // S G: each thread walks one column's bits (k ascending) for 8 rows;
  // columns past m are written as zeros
  constexpr int R = 8;
  {
    const int cols = round_up(m, 8);
    const int chunks = (n + R - 1) / R;
    for (int it = tid; it < cols * chunks; it += nt) {
      const int c = it / cols, j = it - c * cols, i0 = c * R;
      int acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0;
      if (j < m) {
        for (int w = 0; w < W; ++w) {
          uint32_t bits = Gin[j * W + w];
          while (bits) {
            const int kk = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (i0 + r < n) acc[r] += Sq[(i0 + r) * ldb + kk];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r < n) SGh[(i0 + r) * ldh + j] = (uint16_t)acc[r];
    }
  }
  __syncthreads();

  // S G S^T and the residual: thread (bi, bu) owns rows i = bi + B a and
  // u = bu + B b, a, b < 4; the squares wrap modulo 2^64 like the plain
  // version's int64 arithmetic
  const int B = (n + 3) / 4;
  const uint8_t* q = Q + (size_t)p * n * n;
  const long long s2 = (long long)scale * scale;
  unsigned long long local = 0;
  for (int it = tid; it < B * B; it += nt) {
    const int bi = it / B, bu = it - bi * B;
    int ir[4], ur[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ir[a] = min(bi + B * a, n - 1);
      ur[a] = min(bu + B * a, n - 1);
    }
    unsigned acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0u;
    for (int j = 0; j < m; j += 8) {
      uint2 sv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sv[b] = *reinterpret_cast<const uint2*>(Sq + ur[b] * ldb + j);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint4 g =
            *reinterpret_cast<const uint4*>(SGh + ir[a] * ldh + j);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] = __dp2a_lo(g.x, sv[b].x, acc[a][b]);
          acc[a][b] = __dp2a_hi(g.y, sv[b].x, acc[a][b]);
          acc[a][b] = __dp2a_lo(g.z, sv[b].y, acc[a][b]);
          acc[a][b] = __dp2a_hi(g.w, sv[b].y, acc[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = bi + B * a, u = bu + B * b;
        if (i < n && u < n) {
          const unsigned long long res =
              (unsigned long long)((long long)q[i * n + u] * s2 -
                                   (long long)acc[a][b]);
          local += res * res;
        }
      }
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) part_sums[tid >> 5] = (long long)local;
  __syncthreads();
  if (tid == 0) {
    unsigned long long tot = 0;
    for (int w = 0; w < (nt + 31) >> 5; ++w)
      tot += (unsigned long long)part_sums[w];
    out[(size_t)p * N + part] = -__ll2float_rn((long long)tot);
  }
}

// ---- The wide path (n or m > kMaxDim) ----
//
// Past 256 columns S G no longer fits 16 bits (255 m) and S G S^T no
// longer 32 (255^2 m^2), so the wide body holds S G as 32-bit words and
// sums S G S^T in 64 bits, a 32-bit product a term (255 * 255 m stays
// below 2^32 for m < 66,051). G's columns are read from the scratch in
// place; the tiles are in shared memory where they fit and in a slice
// of device scratch per CTA where not.
struct WLayout {
  int W, ldb, ldw;          // words of a bit row; S (bytes), S G (words)
  size_t sq, sg, tiles;     // tile offsets and bytes
};

__host__ __device__ inline WLayout wlayout(int n, int m) {
  WLayout L;
  L.W = rt::words(m);
  L.ldb = odd_chunks(m, 4);
  L.ldw = odd_chunks(m, 4);
  L.sq = 0;
  L.sg = rt::align16z((size_t)n * L.ldb);
  L.tiles = rt::align16z(L.sg + (size_t)4 * n * L.ldw);
  return L;
}

constexpr int kWideSmall = 8 * 32;     // the warps' partial sums
using rt::kSmemMax;

bool wide_in_smem(const WLayout& L) {
  return kWideSmall + L.tiles <= kSmemMax;
}

__global__ void __launch_bounds__(kThreads)
fitness_u8_wide_kernel(const uint8_t* __restrict__ S,
                       const uint32_t* __restrict__ gin_all,
                       const uint8_t* __restrict__ Q, float* __restrict__ out,
                       uint8_t* __restrict__ gtiles, int N, int n, int m,
                       int scale, int in_smem) {
  const int p = blockIdx.y, part = blockIdx.x, tid = threadIdx.x;
  const int nt = blockDim.x;
  const WLayout L = wlayout(n, m);
  const int W = L.W, ldb = L.ldb, ldw = L.ldw;
  extern __shared__ __align__(16) uint8_t smem[];
  long long* part_sums = reinterpret_cast<long long*>(smem);
  uint8_t* tiles = in_smem ? smem + kWideSmall
                           : gtiles + ((size_t)p * N + part) * L.tiles;
  uint8_t* Sq = tiles + L.sq;
  uint32_t* SG = reinterpret_cast<uint32_t*>(tiles + L.sg);
  const uint32_t* Gin = gin_all + (size_t)p * m * W;

  // the particle's bytes and zero columns up to a multiple of 4
  const size_t base = ((size_t)p * N + part) * n * m;
  for (size_t idx = tid; idx < (size_t)n * m; idx += nt) {
    const int i = (int)(idx / m);
    Sq[(size_t)i * ldb + idx - (size_t)i * m] = S[base + idx];
  }
  const int pad = round_up(m, 4) - m;
  for (int idx = tid; idx < n * pad; idx += nt)
    Sq[(size_t)(idx / pad) * ldb + m + idx % pad] = 0;
  __syncthreads();

  // S G: each thread walks one column's bits (k ascending) for 8 rows;
  // columns past m are written as zeros
  constexpr int R = 8;
  {
    const int cols = round_up(m, 4);
    const int chunks = (n + R - 1) / R;
    for (int it = tid; it < cols * chunks; it += nt) {
      const int c = it / cols, j = it - c * cols, i0 = c * R;
      uint32_t acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0;
      if (j < m) {
        for (int w = 0; w < W; ++w) {
          uint32_t bits = Gin[(size_t)j * W + w];
          while (bits) {
            const int kk = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (i0 + r < n) acc[r] += Sq[(size_t)(i0 + r) * ldb + kk];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r < n) SG[(size_t)(i0 + r) * ldw + j] = acc[r];
    }
  }
  __syncthreads();

  // S G S^T and the residual: thread (bi, bu) owns rows i = bi + B a and
  // u = bu + B b, a, b < 4; the sums are 64-bit and the squares wrap
  // modulo 2^64 like the plain version's int64 arithmetic
  const int B = (n + 3) / 4;
  const uint8_t* q = Q + (size_t)p * n * n;
  const long long s2 = (long long)scale * scale;
  unsigned long long local = 0;
  for (int it = tid; it < B * B; it += nt) {
    const int bi = it / B, bu = it - bi * B;
    int ir[4], ur[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ir[a] = min(bi + B * a, n - 1);
      ur[a] = min(bu + B * a, n - 1);
    }
    unsigned long long acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0ull;
    for (int j = 0; j < m; j += 4) {
      uint32_t sv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sv[b] = *reinterpret_cast<const uint32_t*>(Sq + (size_t)ur[b] * ldb +
                                                   j);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const uint4 g =
            *reinterpret_cast<const uint4*>(SG + (size_t)ir[a] * ldw + j);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t s = sv[b];
          acc[a][b] += g.x * (s & 0xffu);
          acc[a][b] += g.y * ((s >> 8) & 0xffu);
          acc[a][b] += g.z * ((s >> 16) & 0xffu);
          acc[a][b] += g.w * (s >> 24);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = bi + B * a, u = bu + B * b;
        if (i < n && u < n) {
          const unsigned long long res =
              (unsigned long long)((long long)q[(size_t)i * n + u] * s2 -
                                   (long long)acc[a][b]);
          local += res * res;
        }
      }
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) part_sums[tid >> 5] = (long long)local;
  __syncthreads();
  if (tid == 0) {
    unsigned long long tot = 0;
    for (int w = 0; w < (nt + 31) >> 5; ++w)
      tot += (unsigned long long)part_sums[w];
    out[(size_t)p * N + part] = -__ll2float_rn((long long)tot);
  }
}

}  // namespace

// Bytes of device scratch that edge_fitness_u8 needs: G's column bits,
// and on the wide path, where the tiles pass a block's shared memory, one
// tile slice per CTA.
extern "C" long long edge_fitness_u8_scratch_bytes(int P, int N, int n,
                                                   int m) {
  const long long gin = rt::align16z(4ull * P * m * rt::words(m));
  if (!rt::wide(n, m)) return gin;
  const WLayout L = wlayout(n, m);
  return gin + (wide_in_smem(L) ? 0 : (long long)P * N * L.tiles);
}

// The quantized body: uint8 S (P, N, n, m), Q and G uint8 (Q's values
// count, G is read as 0/1); two launches on `stream`. scratch holds
// edge_fitness_u8_scratch_bytes bytes.
extern "C" int edge_fitness_u8(const void* S, const void* Q, const void* G,
                               void* out, void* scratch, int P, int N, int n,
                               int m, int scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = pack_gin((const uint8_t*)G, (uint32_t*)scratch, P, m, st);
  if (err != cudaSuccess) return (int)err;
  if (rt::wide(n, m)) {
    const WLayout L = wlayout(n, m);
    const bool in_smem = wide_in_smem(L);
    const size_t smem = kWideSmall + (in_smem ? L.tiles : 0);
    uint8_t* gtiles =
        (uint8_t*)scratch + rt::align16z(4ull * P * m * rt::words(m));
    err = rt::allow_smem((const void*)fitness_u8_wide_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fitness_u8_wide_kernel<<<dim3(N, P), kThreads, smem, st>>>(
        (const uint8_t*)S, (const uint32_t*)scratch, (const uint8_t*)Q,
        (float*)out, gtiles, N, n, m, scale, in_smem);
    return (int)cudaGetLastError();
  }
  const size_t smem = qlayout(n, m).total;
  err = rt::allow_smem((const void*)fitness_u8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fitness_u8_kernel<<<dim3(N, P), kThreads, smem, st>>>(
      (const uint8_t*)S, (const uint32_t*)scratch, (const uint8_t*)Q,
      (float*)out, N, n, m, scale);
  return (int)cudaGetLastError();
}
