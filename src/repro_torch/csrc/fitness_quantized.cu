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
// result is bitwise equal to it. Past n, m = 256 (kMaxDim) a particle's
// rows are split over several CTAs, S G S^T on the integer tensor cores
// (fitness_u8_rows_kernel, below); where that does not fit in shared
// memory, one CTA a particle holds S G in 32 bits and S G S^T in 64
// (fitness_u8_wide_kernel).
#include "fitness.cuh"

namespace {

constexpr int kThreads = 256;

using rt::align16;
using rt::ld32;
using rt::mma_u8;
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

// ---- The row-split path (n or m > kMaxDim, where a CTA's part fits) ----
//
// Measured on the H100 at (312, 528), N = 64 (PERF.md): the kernel above
// ran one CTA a particle (64 CTAs on 132 SMs; at the Tier-0 call, N = 1,
// one CTA in all) on tiles in device scratch (~0.8 MB a CTA), and spent
// 69% of its cycles in S G S^T on CUDA cores, 64-bit sums of u32 x u8
// terms: 2.0 ms, slower than the plain version's two float64 cuBLAS
// products. Here a particle's rows are split over RB = ceil(n / R) CTAs
// (grid (N RB, P)), R = 16 MT rows each:
//  * a CTA stages its own rows of S (cp.async) and computes their S G by
//    walking G's column bits as above, into three byte planes of R rows;
//    the planes' OR over the CTA says how many carry bits (S G < 256 on
//    the main path's normalised rows and on the Tier-0 tile's one 255 a
//    row: one plane; any uint8 S: up to 255 m < 2^24, three);
//  * S's rows u stream through shared memory in chunks of U = 64 / MT
//    rows, double-buffered with cp.async, and S G S^T runs on the integer
//    tensor cores, mma.sync m16n8k32 u8 x u8 -> s32, a warp one 16 x 8
//    (i, u) tile of a chunk: each plane's sum over j is exact in s32
//    (at most 255 * 255 * round_up(m, 32) < 2^31 for m < 33,000), and
//    c0 + 2^8 c1 + 2^16 c2 is S G S^T exactly, in 64 bits;
//  * the squared residual wraps modulo 2^64 as the plain version's int64
//    arithmetic does; a wrapping sum does not depend on the order of its
//    terms, so each CTA adds its part into the particle's 64-bit sum
//    (atomicAdd) and the last CTA of the particle (a ticket; both zeroed
//    by the G packing launch) writes -float(sum): the bits of the plain
//    version.
// ~90 KB of shared memory at (312, 528) (two CTAs an SM). MT = 2 (32 rows
// a CTA) halves the re-reads of S; MT = 1 where that leaves fewer CTAs
// than twice the SMs (the Tier-0 call: 20 CTAs at (312, 528)). Against
// MT = 2 throughout (device time on the H100, kernel_ab.py --bucket
// against a copy without the rule; PERF.md) the rule took 0.66x the time
// at the Tier-0 call at (312, 528), 0.85x at (56, 528), N = 64, and 0.76x
// at its Tier-0 call, but 1.42x at (257, 771), P N = 8, whose 136 CTAs of
// ~143 KB, one an SM, spill into a second wave.
struct RLayout {
  int R, U, ldq, bufs, parts, misc, smem;
};

__host__ __device__ inline RLayout rlayout(int m, int MT) {
  RLayout L;
  L.R = 16 * MT;
  L.U = 64 / MT;
  L.ldq = round_up(m, 32) + 16;     // bytes; 16 mod 32: no bank conflicts
  L.bufs = align16(3 * L.R * L.ldq);          // after the three planes
  L.parts = align16(L.bufs + 2 * L.U * L.ldq);
  L.misc = L.parts + 8 * (kThreads / 32);
  L.smem = L.misc + 16;
  return L;
}

bool rows_fit(int m, int MT) {
  return (size_t)rlayout(m, MT).smem <= kSmemMax && m < 33000;
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
fitness_u8_rows_kernel(const uint8_t* __restrict__ S,
                       const uint32_t* __restrict__ gin_all,
                       const uint8_t* __restrict__ Q, float* __restrict__ out,
                       unsigned long long* __restrict__ sums,
                       unsigned* __restrict__ tickets, int N, int n, int m,
                       int scale) {
  constexpr int R = 16 * MT, U = 64 / MT;
  const int RB = (n + R - 1) / R;
  const int p = blockIdx.y, part = blockIdx.x / RB;
  const int r0 = (blockIdx.x - part * RB) * R, rows = min(R, n - r0);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5;
  const RLayout L = rlayout(m, MT);
  const int ldq = L.ldq, kq = round_up(m, 32), W = rt::words(m);
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* planes = smem;                 // plane b of own row l: (b R + l)
  uint8_t* buf0 = smem + L.bufs;          // chunk c in buffer c & 1
  uint8_t* buf1 = buf0 + (size_t)U * ldq; // (the own rows first)
  unsigned long long* part_sums =
      reinterpret_cast<unsigned long long*>(smem + L.parts);
  unsigned* misc = reinterpret_cast<unsigned*>(smem + L.misc);
  const uint32_t* Gin = gin_all + (size_t)p * m * W;
  const size_t pi = (size_t)p * N + part;
  const uint8_t* Sp = S + pi * n * m;
  const bool vec = (m & 15) == 0 && ((uintptr_t)Sp & 15) == 0;

  // rows [u0, u0 + cnt) of S into dst, one committed group
  auto stage = [&](uint8_t* dst, int u0, int cnt) {
    if (vec) {
      const int cpr = m >> 4;
      for (int g = tid; g < cnt * cpr; g += nt) {
        const int r = g / cpr, c = g - r * cpr;
        cp_async16(dst + r * ldq + 16 * c, Sp + (size_t)(u0 + r) * m + 16 * c);
      }
    } else {
      for (int idx = tid; idx < cnt * m; idx += nt) {
        const int r = idx / m;
        dst[r * ldq + idx - r * m] = Sp[(size_t)u0 * m + idx];
      }
    }
    cp_async_commit();
  };

  // zero columns past m of both buffers (the products read up to kq)
  const int pad = kq - m;
  for (int idx = tid; idx < 2 * U * pad; idx += nt)
    buf0[(idx / pad) * ldq + m + idx % pad] = 0;
  if (tid == 0) misc[0] = 0u;
  __syncthreads();
  stage(buf1, r0, rows);
  stage(buf0, 0, min(U, n));
  cp_async_wait<1>();
  __syncthreads();

  // S G of the own rows: a thread a column j (k ascending over G's set
  // bits), all R rows at once; the three byte planes, zero past m
  unsigned any = 0;
  for (int j = tid; j < kq; j += nt) {
    uint32_t acc[R];
#pragma unroll
    for (int l = 0; l < R; ++l) acc[l] = 0;
    if (j < m) {
      walk_column(Gin + (size_t)j * W, W, [&](int kk) {
#pragma unroll
        for (int l = 0; l < R; ++l)
          if (l < rows) acc[l] += buf1[l * ldq + kk];
      });
    }
#pragma unroll
    for (int l = 0; l < R; ++l) {
      any |= acc[l];
      planes[l * ldq + j] = (uint8_t)acc[l];
      planes[(R + l) * ldq + j] = (uint8_t)(acc[l] >> 8);
      planes[(2 * R + l) * ldq + j] = (uint8_t)(acc[l] >> 16);
    }
  }
  any = __reduce_or_sync(0xffffffffu, any);
  if (lane == 0 && any) atomicOr(misc, any);
  __syncthreads();
  const int np = misc[0] < 256u ? 1 : misc[0] < 65536u ? 2 : 3;

  // S G S^T by chunks of U rows u: warp (mt, nb) owns the 16 x 8 tile of
  // own rows 16 mt.. and chunk rows 8 nb..; the residual as each chunk's
  // sums complete
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp % MT, nb = warp / MT;
  const uint8_t* pa = planes + (mt * 16 + g) * ldq + t4 * 4;
  const uint8_t* pb = pa + 8 * ldq;
  const uint8_t* q = Q + (size_t)p * n * n;
  const long long s2 = (long long)scale * scale;
  const int nch = (n + U - 1) / U;
  unsigned long long local = 0;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(c & 1 ? buf0 : buf1, (c + 1) * U, min(U, n - (c + 1) * U));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* bp = (c & 1 ? buf1 : buf0) + (nb * 8 + g) * ldq + t4 * 4;
    int acc[3][4];
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0;
    for (int j0 = 0; j0 < kq; j0 += 32) {
      const uint32_t b0 = ld32(bp + j0), b1 = ld32(bp + j0 + 16);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        if (b < np) {
          const size_t o = (size_t)b * R * ldq + j0;
          uint32_t a[4];
          a[0] = ld32(pa + o);
          a[1] = ld32(pb + o);
          a[2] = ld32(pa + o + 16);
          a[3] = ld32(pb + o + 16);
          mma_u8(acc[b], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = mt * 16 + g + (e >> 1) * 8;
      const int u = c * U + nb * 8 + t4 * 2 + (e & 1);
      if (l < rows && u < n) {
        const unsigned long long sgs =
            (unsigned long long)(uint32_t)acc[0][e] +
            ((unsigned long long)(uint32_t)acc[1][e] << 8) +
            ((unsigned long long)(uint32_t)acc[2][e] << 16);
        const unsigned long long res = (unsigned long long)(
            (long long)q[(size_t)(r0 + l) * n + u] * s2 - (long long)sgs);
        local += res * res;
      }
    }
    __syncthreads();               // the buffer is staged again next turn
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) part_sums[warp] = local;
  __syncthreads();
  if (tid == 0) {
    unsigned long long tot = 0;
    for (int w = 0; w < nt >> 5; ++w) tot += part_sums[w];
    atomicAdd(sums + pi, tot);
    __threadfence();
    if (atomicAdd(tickets + pi, 1u) == (unsigned)RB - 1) {
      __threadfence();
      const unsigned long long all = atomicAdd(sums + pi, 0ull);
      out[pi] = -__ll2float_rn((long long)all);
    }
  }
}

// The wide body a call of P problems of N particles at (n, m) runs: the
// rows a CTA of the row-split kernel (16 or 32), or -1 for
// fitness_u8_wide_kernel, which runs only where the split does not fit
// in shared memory.
int wide_rows(int P, int N, int n, int m) {
  const int MT =
      (long long)P * N * ((n + 31) / 32) < 2LL * sm_count() ? 1 : 2;
  if (rows_fit(m, MT)) return 16 * MT;
  return rows_fit(m, 3 - MT) ? 16 * (3 - MT) : -1;
}

// Scratch of one call, in bytes: G's column bits, then on the wide path
// the particles' 64-bit sums and tickets (row-split) or, where the tiles
// pass a block's shared memory, one tile slice per CTA.
struct QScratch {
  size_t gin, sums, tickets, total;
};

QScratch qscratch(int P, int N, int n, int m) {
  QScratch s;
  s.gin = rt::align16z(4ull * P * m * rt::words(m));
  s.sums = s.tickets = s.total = s.gin;
  if (!rt::wide(n, m)) return s;
  if (wide_rows(P, N, n, m) > 0) {
    s.tickets = s.sums + 8ull * P * N;
    s.total = rt::align16z(s.tickets + 4ull * P * N);
  } else {
    const WLayout L = wlayout(n, m);
    if (!wide_in_smem(L)) s.total += (size_t)P * N * L.tiles;
  }
  return s;
}

}  // namespace

// Bytes of device scratch that edge_fitness_u8 needs: G's column bits,
// and on the wide path the row-split kernel's sums and tickets, or, where
// fitness_u8_wide_kernel's tiles pass a block's shared memory, one tile
// slice per CTA.
extern "C" long long edge_fitness_u8_scratch_bytes(int P, int N, int n,
                                                   int m) {
  return (long long)qscratch(P, N, n, m).total;
}

// The wide body the card runs for P problems of N particles at (n, m): 0
// on the narrow path, the rows a CTA of fitness_u8_rows_kernel, or -1 for
// fitness_u8_wide_kernel.
extern "C" int edge_fitness_u8_path(int P, int N, int n, int m) {
  return rt::wide(n, m) ? wide_rows(P, N, n, m) : 0;
}

// The quantized body: uint8 S (P, N, n, m), Q and G uint8 (Q's values
// count, G is read as 0/1); two launches on `stream`. scratch holds
// edge_fitness_u8_scratch_bytes bytes.
extern "C" int edge_fitness_u8(const void* S, const void* Q, const void* G,
                               void* out, void* scratch, int P, int N, int n,
                               int m, int scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (rt::wide(n, m)) {
    const QScratch sc = qscratch(P, N, n, m);
    uint8_t* base = (uint8_t*)scratch;
    const int rows = wide_rows(P, N, n, m);
    cudaError_t err = pack_gin(
        (const uint8_t*)G, (uint32_t*)scratch, P, m, st,
        (uint32_t*)(base + sc.sums),
        rows > 0 ? (int)((sc.total - sc.sums) / 4) : 0);
    if (err != cudaSuccess) return (int)err;
    if (rows > 0) {
      const int MT = rows / 16, RB = (n + rows - 1) / rows;
      const void* kern = MT == 1 ? (const void*)fitness_u8_rows_kernel<1>
                                 : (const void*)fitness_u8_rows_kernel<2>;
      const size_t smem = rlayout(m, MT).smem;
      err = rt::allow_smem(kern, smem);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid(N * RB, P);
      unsigned long long* sums = (unsigned long long*)(base + sc.sums);
      unsigned* tickets = (unsigned*)(base + sc.tickets);
      if (MT == 1)
        fitness_u8_rows_kernel<1><<<grid, kThreads, smem, st>>>(
            (const uint8_t*)S, (const uint32_t*)scratch, (const uint8_t*)Q,
            (float*)out, sums, tickets, N, n, m, scale);
      else
        fitness_u8_rows_kernel<2><<<grid, kThreads, smem, st>>>(
            (const uint8_t*)S, (const uint32_t*)scratch, (const uint8_t*)Q,
            (float*)out, sums, tickets, N, n, m, scale);
      return (int)cudaGetLastError();
    }
    const WLayout L = wlayout(n, m);
    const bool in_smem = wide_in_smem(L);
    const size_t smem = kWideSmall + (in_smem ? L.tiles : 0);
    err = rt::allow_smem((const void*)fitness_u8_wide_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fitness_u8_wide_kernel<<<dim3(N, P), kThreads, smem, st>>>(
        (const uint8_t*)S, (const uint32_t*)scratch, (const uint8_t*)Q,
        (float*)out, base + sc.gin, N, n, m, scale, in_smem);
    return (int)cudaGetLastError();
  }
  cudaError_t err = pack_gin((const uint8_t*)G, (uint32_t*)scratch, P, m, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = qlayout(n, m).total;
  err = rt::allow_smem((const void*)fitness_u8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fitness_u8_kernel<<<dim3(N, P), kThreads, smem, st>>>(
      (const uint8_t*)S, (const uint32_t*)scratch, (const uint8_t*)Q,
      (float*)out, N, n, m, scale);
  return (int)cudaGetLastError();
}
