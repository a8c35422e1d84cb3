// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is launched from a plain C entry point (extern "C") that
// takes raw device pointers and a cudaStream_t, launches on that stream,
// and returns cudaGetLastError(). Nothing here allocates or synchronises.
//
// Bit rows. The matcher's 0/1 matrices (masks, candidate sets, the
// adjacency of Q and G) are held as rows of 32-bit words: bit b of word w
// of row r is entry (r, 32*w + b), and every Ullmann support test becomes
// an AND and a non-zero check, exact like the integer products it
// replaces. Each kernel has two instantiations. Where n, m <= kMaxDim
// (256) a row is at most 8 words and a lane-transposed row one byte a
// lane (below); past that the wide helpers at the end of this file hold
// a lane's bits in 32-bit words, a plane of 32 words covering 1,024
// columns and a row as many planes as it needs, and the bit planes live
// in shared memory where they fit and in device scratch where they do
// not. The wide path takes any n, m whose buffers the card's memory
// holds.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int kMaxDim = 256;          // the narrow path: n, m <= kMaxDim
constexpr int kLaneBits = kMaxDim / 32;   // a lane's bits of a transposed row
constexpr float kNeg = -FLT_MAX;      // finfo(float32).min, the sentinel
constexpr size_t kSmemMax = 232448;   // 227 KB a block on the H100

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

__device__ inline int popcount_row(const uint32_t* a, int W) {
  int c = 0;
  for (int w = 0; w < W; ++w) c += __popc(a[w]);
  return c;
}

// Argmax over the warp of (value, index) pairs, ties to the lower index;
// every lane gets the result. Two warp reductions: the largest value as an
// order-preserving unsigned key (-0.0 counted as +0.0, since the two
// compare equal), then the smallest index among the lanes that hold it.
// Values are never NaN here.
__device__ __forceinline__ void warp_argmax(float& v, int& vi) {
  uint32_t key = __float_as_uint(v + 0.0f);
  key = (key & 0x80000000u) ? ~key : key | 0x80000000u;
  const uint32_t best = __reduce_max_sync(0xffffffffu, key);
  vi = (int)__reduce_min_sync(0xffffffffu,
                              key == best ? (uint32_t)vi : 0xffffffffu);
  v = __uint_as_float((best & 0x80000000u) ? best & 0x7fffffffu : ~best);
}

// One m16n8k32 product on the integer tensor cores, u8 x u8 summed into
// s32 (the PTX manual's fragments: with g = lane / 4 and t = lane % 4, a
// holds A's rows g and g + 8 at k = 4t..4t+3 and 16 + 4t..; b0, b1 B's
// column g at the same k; c C's rows g and g + 8 at columns 2t, 2t + 1).
__device__ __forceinline__ void mma_u8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Bit k set iff mask entry 4g + k is non-zero, from one 4-byte (uint8)
// or 16-byte (int32) load.
__device__ __forceinline__ uint32_t mask_group(const uint8_t* mask, int g) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(mask)[g];
  return ((w & 0xffu) != 0) | (((w & 0xff00u) != 0) << 1) |
         (((w & 0xff0000u) != 0) << 2) | (((w & 0xff000000u) != 0) << 3);
}
__device__ __forceinline__ uint32_t mask_group(const int32_t* mask, int g) {
  const int4 w = reinterpret_cast<const int4*>(mask)[g];
  return (w.x != 0) | ((w.y != 0) << 1) | ((w.z != 0) << 2) |
         ((w.w != 0) << 3);
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

// The free columns of lane l at the start of a chain: bit k for l + 32 k.
__device__ __forceinline__ uint32_t all_cols(int m) {
  const int lane = threadIdx.x & 31;
  uint32_t cols = 0;
#pragma unroll
  for (int k = 0; k < kLaneBits; ++k)
    if (lane + 32 * k < m) cols |= 1u << k;
  return cols;
}

// ref.greedy_project of one (n, m) S (row stride m, in shared or device
// memory), run by one warp: n rounds of a masked global argmax over the
// flat index i*m + j (ties to the smallest index), each taken entry
// knocking out its row and column; an entry is taken only if its value is
// above finfo(float32).min. maskT is the mask's lane-transposed rows. gv /
// gj hold every row's best (value, column) over its masked columns, ties
// to the lower column (kNeg and INT32_MAX for a row with none), and are
// the cache: a round takes the best row (ties to the lower row: the lowest
// flat index), sets it to (kNeg, INT32_MAX) and rescans only the rows
// whose cached column was just taken. It stops at the first round that
// takes nothing, as every later round would. Writes asg[i] (-1: none).
__device__ __forceinline__ void greedy_warp(const float* S, int n, int m,
                                            const uint8_t* maskT, float* gv,
                                            int* gj, int* asg) {
  const int lane = threadIdx.x & 31;
  uint32_t cols = all_cols(m);
  for (int i = lane; i < n; i += 32) asg[i] = -1;
  __syncwarp();
  for (int round = 0; round < n; ++round) {
    float v = kNeg;
    int row = INT32_MAX;
    for (int i = lane; i < n; i += 32)
      if (gv[i] > v) { v = gv[i]; row = i; }
    warp_argmax(v, row);
    if (!(v > kNeg)) break;          // nothing left: every later round too
    const int col = gj[row];
    __syncwarp();
    if (lane == 0) {
      asg[row] = col;
      gv[row] = kNeg;
      gj[row] = INT32_MAX;
    }
    if (lane == (col & 31)) cols &= ~(1u << (col >> 5));
    __syncwarp();
    // rescan the rows whose cached column was just taken
    for (int i0 = 0; i0 < n; i0 += 32) {
      uint32_t stale = __ballot_sync(
          0xffffffffu, i0 + lane < n && gj[i0 + lane] == col);
      while (stale) {
        const int i = i0 + __ffs(stale) - 1;
        stale &= stale - 1;
        const uint32_t ok = maskT[i * 32 + lane] & cols;
        float bv = kNeg;
        int bj = INT32_MAX;
#pragma unroll
        for (int k = 0; k < kLaneBits; ++k) {
          if ((ok >> k) & 1u) {
            const float s = S[i * m + lane + 32 * k];
            if (s > bv) { bv = s; bj = lane + 32 * k; }
          }
        }
        warp_argmax(bv, bj);
        if (lane == 0) {
          gv[i] = bv;
          gj[i] = bj;
        }
      }
    }
    __syncwarp();
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

// Byte `lane` of a 32-byte transposed row held as two words of 16 bytes,
// selected by value: a select through a reference to lo or hi can put both
// in local memory (it did in ullmann_refine.cu).
__device__ __forceinline__ uint32_t byte_of(const uint4& lo, const uint4& hi,
                                            int lane) {
  const int w = (lane >> 2) & 3;
  const bool h = lane >= 16;
  const uint32_t x = h ? hi.x : lo.x, y = h ? hi.y : lo.y;
  const uint32_t z = h ? hi.z : lo.z, v = h ? hi.w : lo.w;
  const uint32_t word = (w & 2) ? ((w & 1) ? v : z) : ((w & 1) ? y : x);
  return (word >> (8 * (lane & 3))) & 0xffu;
}

// One Jacobi Ullmann sweep on the lane-transposed candidates MT (n rows of
// 32 bytes), in place, run by nt threads (a whole number of warps; t is
// this thread's index among them). With the supports
//   SO[u] = { j : M[u] & Gout[j] != 0 } = OR_{v in M[u]} Gin[v]
//   SI[u] = { j : M[u] & Gin[j]  != 0 } = OR_{v in M[u]} Gout[v]
// it keeps M[i] &= AND_{u : Q[i,u]} SO[u] & AND_{u : Q[u,i]} SI[u], which
// keeps (i, j) iff no neighbour of i lost its support at j: the
// (viol == 0) test of the integer form. goutT / ginT are G's transposed
// rows and columns, qrow / qcol Q's and Q^T's bit rows (Wn words). A warp
// builds a row's supports: each lane ORs the 32-byte transposed G rows of
// its own candidates v = lane + 32 k, then the warp ORs the lanes' parts
// together (__reduce_or_sync) and each lane keeps its byte; every
// support is built before any row changes.
// With TRACK, only the rows whose candidates changed in the last sweep
// (dirty[u], all of them before the first) get new supports, since the
// others' are still those of their unchanged candidates; the rows that
// change are marked in next_dirty, and the sweep returns whether any did
// (every thread). Without, every row's supports are built, dirty and
// next_dirty are not read, and it returns false. Ends with a barrier.
template <bool TRACK>
__device__ __forceinline__ bool ullmann_sweep_t(
    const uint8_t* goutT, const uint8_t* ginT, const uint32_t* qrow,
    const uint32_t* qcol, int n, int Wn, uint8_t* MT, uint8_t* soT,
    uint8_t* siT, const uint8_t* dirty, uint8_t* next_dirty, int t,
    int nt) {
  const int lane = t & 31;
  for (int u = t >> 5; u < n; u += nt >> 5) {
    if (TRACK && !dirty[u]) continue;
    uint32_t mine = MT[u * 32 + lane];
    uint4 o0 = make_uint4(0, 0, 0, 0), o1 = o0, i0 = o0, i1 = o0;
    while (mine) {
      const int v = lane + 32 * (__ffs(mine) - 1);
      mine &= mine - 1;
      const uint4* gi = reinterpret_cast<const uint4*>(ginT + v * 32);
      const uint4* go = reinterpret_cast<const uint4*>(goutT + v * 32);
      or4(o0, gi[0]);
      or4(o1, gi[1]);
      or4(i0, go[0]);
      or4(i1, go[1]);
    }
    reduce_or4(o0);
    reduce_or4(o1);
    reduce_or4(i0);
    reduce_or4(i1);
    soT[u * 32 + lane] = (uint8_t)byte_of(o0, o1, lane);
    siT[u * 32 + lane] = (uint8_t)byte_of(i0, i1, lane);
  }
  if (TRACK)
    for (int i = t; i < n; i += nt) next_dirty[i] = 0;
  __syncthreads();
  bool changed = false;
  for (int idx = t; idx < n * 32; idx += nt) {
    const int i = idx >> 5, l = idx & 31;
    const uint32_t old = MT[idx];
    uint32_t x = old;
    for (int wu = 0; wu < Wn; ++wu) {
      uint32_t out_nb = qrow[i * Wn + wu];
      while (out_nb) {
        const int u = wu * 32 + __ffs(out_nb) - 1;
        out_nb &= out_nb - 1;
        x &= soT[u * 32 + l];
      }
      uint32_t in_nb = qcol[i * Wn + wu];
      while (in_nb) {
        const int u = wu * 32 + __ffs(in_nb) - 1;
        in_nb &= in_nb - 1;
        x &= siT[u * 32 + l];
      }
    }
    MT[idx] = (uint8_t)x;
    if (TRACK && x != old) {
      next_dirty[i] = 1;
      changed = true;
    }
  }
  if (!TRACK) {
    __syncthreads();
    return false;
  }
  return __syncthreads_or(changed) != 0;
}

// Q's bit rows and columns from its bytes qs (n x n, in shared memory), by
// the whole CTA: a warp a word, a ballot a word. qrow[i * Wn + w] bit b is
// Q[i, 32 w + b]; qcol[i * Wn + w] bit b is Q[32 w + b, i].
__device__ inline void pack_q_bits(const uint8_t* qs, int n, uint32_t* qrow,
                                   uint32_t* qcol) {
  const int Wn = words(n), lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < n * Wn; t += blockDim.x >> 5) {
    const int i = t / Wn, u = 32 * (t - i * Wn) + lane;
    const uint32_t row = __ballot_sync(0xffffffffu, u < n && qs[i * n + u]);
    const uint32_t col = __ballot_sync(0xffffffffu, u < n && qs[u * n + i]);
    if (lane == 0) {
      qrow[t] = row;
      qcol[t] = col;
    }
  }
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}


// ---- The wide path (n or m > kMaxDim) ----
//
// A wide lane-transposed row of `cols` columns is lane_words(cols) planes
// of 32 words: bit k of word w * 32 + l is the entry at column
// l + 32 (32 w + k), so lane l of a warp owns the columns l + 32 b (b < 
// words(cols)) as it does on the narrow path, b being bit b & 31 of
// plane b >> 5.

// Whether (n, m) takes a kernel's wide instantiation.
__host__ __device__ inline bool wide(int n, int m) {
  return n > kMaxDim || m > kMaxDim;
}

__host__ __device__ inline int lane_words(int cols) {
  return words(words(cols));
}
__host__ __device__ inline size_t align16z(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Column of bit k of plane w for lane l.
__device__ __forceinline__ int wcol(int lane, int w, int k) {
  return lane + 32 * (32 * w + k);
}

// Entry c of a wide transposed row.
__device__ __forceinline__ bool wtest(const uint32_t* row, int c) {
  const int b = c >> 5;
  return (row[(b >> 5) * 32 + (c & 31)] >> (b & 31)) & 1u;
}

// Lane l's bits of plane w that are columns below `cols`.
__device__ __forceinline__ uint32_t wall_cols(int lane, int w, int cols) {
  uint32_t bits = 0;
  for (int k = 0; k < 32 && wcol(lane, w, k) < cols; ++k) bits |= 1u << k;
  return bits;
}

// Wide transposed rows of a row-major (rows, cols) matrix x (any memory),
// by threads t of nt: out[(r * LW + w) * 32 + l] bit k is x[r, wcol] != 0.
template <typename T>
__device__ inline void wpack_rows(const T* x, int rows, int cols,
                                  uint32_t* out, int t, int nt) {
  const int per = 32 * lane_words(cols);
  for (int idx = t; idx < rows * per; idx += nt) {
    const int r = idx / per, q = idx - r * per;
    uint32_t word = 0;
    for (int k = 0; k < 32; ++k) {
      const int c = wcol(q & 31, q >> 5, k);
      if (c >= cols) break;
      if (x[(size_t)r * cols + c] != 0) word |= 1u << k;
    }
    out[idx] = word;
  }
}

// Wide transposed columns of a square (dim, dim) matrix x (any memory):
// row c of out holds the entries x[r, c] != 0 over r; neighbouring
// threads read neighbouring columns.
template <typename T>
__device__ inline void wpack_cols(const T* x, int dim, uint32_t* out, int t,
                                  int nt) {
  const int per = 32 * lane_words(dim);
  for (int idx = t; idx < dim * per; idx += nt) {
    const int q = idx / dim, c = idx - q * dim;
    uint32_t word = 0;
    for (int k = 0; k < 32; ++k) {
      const int r = wcol(q & 31, q >> 5, k);
      if (r >= dim) break;
      if (x[(size_t)r * dim + c] != 0) word |= 1u << k;
    }
    out[(size_t)c * per + q] = word;
  }
}

// The supports of one row, run by one warp: for every candidate v of the
// wide transposed row `cand` (all lanes walk all of them, so each lane
// builds its own words and no reduction is needed), so |= ginT[v] where
// `out` and si |= goutT[v] where `in`; written as row i of soT / siT.
__device__ inline void wsupports(const uint32_t* cand, int i, int lane,
                                 int LW, bool out, bool in,
                                 const uint32_t* goutT, const uint32_t* ginT,
                                 uint32_t* soT, uint32_t* siT) {
  const int per = 32 * LW;
  for (int w = 0; w < LW; ++w) {
    const int mine = w * 32 + lane;
    uint32_t o = 0, s = 0;
    for (int q = 0; q < per; ++q) {
      uint32_t bits = cand[q];
      while (bits) {
        const size_t v = wcol(q & 31, q >> 5, __ffs(bits) - 1);
        bits &= bits - 1;
        if (out) o |= ginT[v * per + mine];
        if (in) s |= goutT[v * per + mine];
      }
    }
    if (out) soT[(size_t)i * per + mine] = o;
    if (in) siT[(size_t)i * per + mine] = s;
  }
}

// One Jacobi Ullmann sweep on wide transposed candidates MT (n rows), in
// place, by threads t of nt (whole warps): ullmann_sweep_t<true> with
// wide rows. The supports of the rows marked in dirty are rebuilt, the
// rows that change are marked in next_dirty, and it returns whether any
// did (every thread). Ends with a barrier.
__device__ inline bool wsweep(const uint32_t* goutT, const uint32_t* ginT,
                              const uint32_t* qrow, const uint32_t* qcol,
                              int n, int Wn, int LW, uint32_t* MT,
                              uint32_t* soT, uint32_t* siT,
                              const uint8_t* dirty, uint8_t* next_dirty,
                              int t, int nt) {
  const int lane = t & 31, per = 32 * LW;
  for (int u = t >> 5; u < n; u += nt >> 5)
    if (dirty[u])
      wsupports(MT + (size_t)u * per, u, lane, LW, true, true, goutT, ginT,
                soT, siT);
  for (int i = t; i < n; i += nt) next_dirty[i] = 0;
  __syncthreads();
  bool changed = false;
  for (int idx = t; idx < n * per; idx += nt) {
    const int i = idx / per, q = idx - i * per;
    const uint32_t old = MT[idx];
    uint32_t x = old;
    for (int wu = 0; wu < Wn; ++wu) {
      uint32_t out_nb = qrow[i * Wn + wu];
      while (out_nb) {
        const int u = wu * 32 + __ffs(out_nb) - 1;
        out_nb &= out_nb - 1;
        x &= soT[(size_t)u * per + q];
      }
      uint32_t in_nb = qcol[i * Wn + wu];
      while (in_nb) {
        const int u = wu * 32 + __ffs(in_nb) - 1;
        in_nb &= in_nb - 1;
        x &= siT[(size_t)u * per + q];
      }
    }
    MT[idx] = x;
    if (x != old) {
      next_dirty[i] = 1;
      changed = true;
    }
  }
  return __syncthreads_or(changed) != 0;
}

// greedy_warp on wide rows, run by one warp: S (n, m) with row stride m
// in shared or device memory, maskT the mask's wide transposed rows (LW
// planes a row), gv / gj every row's cached best as greedy_warp has them,
// freeT one plane a lane of scratch (the columns still free). Writes
// asg[i] (-1: none).
__device__ __forceinline__ void wgreedy(const float* S, int n, int m, int LW,
                                        const uint32_t* maskT, float* gv,
                                        int* gj, uint32_t* freeT, int* asg) {
  const int lane = threadIdx.x & 31, per = 32 * LW;
  for (int w = 0; w < LW; ++w) freeT[w * 32 + lane] = wall_cols(lane, w, m);
  for (int i = lane; i < n; i += 32) asg[i] = -1;
  __syncwarp();
  for (int round = 0; round < n; ++round) {
    float v = kNeg;
    int row = INT32_MAX;
    for (int i = lane; i < n; i += 32)
      if (gv[i] > v) { v = gv[i]; row = i; }
    warp_argmax(v, row);
    if (!(v > kNeg)) break;          // nothing left: every later round too
    const int col = gj[row];
    __syncwarp();
    if (lane == 0) {
      asg[row] = col;
      gv[row] = kNeg;
      gj[row] = INT32_MAX;
    }
    if (lane == (col & 31)) {
      const int b = col >> 5;
      freeT[(b >> 5) * 32 + lane] &= ~(1u << (b & 31));
    }
    __syncwarp();
    // rescan the rows whose cached column was just taken
    for (int i0 = 0; i0 < n; i0 += 32) {
      uint32_t stale = __ballot_sync(
          0xffffffffu, i0 + lane < n && gj[i0 + lane] == col);
      while (stale) {
        const int i = i0 + __ffs(stale) - 1;
        stale &= stale - 1;
        float bv = kNeg;
        int bj = INT32_MAX;
        for (int w = 0; w < LW; ++w) {
          uint32_t ok = maskT[(size_t)i * per + w * 32 + lane] &
                        freeT[w * 32 + lane];
          while (ok) {
            const int j = wcol(lane, w, __ffs(ok) - 1);
            ok &= ok - 1;
            const float s = S[(size_t)i * m + j];
            if (s > bv) { bv = s; bj = j; }
          }
        }
        warp_argmax(bv, bj);
        if (lane == 0) {
          gv[i] = bv;
          gj[i] = bj;
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace rt
