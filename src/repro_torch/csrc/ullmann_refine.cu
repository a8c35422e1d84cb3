// One Ullmann refinement sweep for a batch of candidate matrices that
// share Q and G:
//   M' = M * [ Q [M G^T == 0] + Q^T [M G == 0] == 0 ].
//
// Replaces the TPU kernel ullmann_refine_step_pallas (src/repro/kernels/
// ullmann_refine.py, body _refine_kernel), which runs the four 0/1 products
// on the MXU.
//
// Bound on the H100: neither bytes (a 56x144 uint8 matrix is 8 KB in and 8
// KB out) nor operations once the products are bit operations. It is the
// latency of one CTA: loading its operands, packing them, two dependent
// passes and the write-out, each limited by the SM's shared-memory
// throughput. The first design packed G and Q from device memory a byte at
// a time in every CTA and ran a support pass that tested 32 columns
// against every word of a row. This one runs a CTA of 32 warps a particle
// (the 64 particles of a call are one wave):
//  * G, Q and the particle's candidates are loaded at once: G and Q as
//    bytes into shared memory, up to four 16-byte loads a thread in flight
//    before any store; the candidates lane-transposed (common.cuh: lane l
//    of a warp owns the columns l + 32 k of a row, one byte), two rows a
//    warp at a time;
//  * G is packed lane-transposed from there, four transposed bytes a
//    thread from eight 4-byte loads where m % 4 == 0 (common.cuh's byte
//    packs, eight loads a byte, otherwise), Q as bit rows and columns by
//    ballots;
//  * rt::ullmann_sweep_t, the sweep of finish_fused.cu and
//    prune_fixpoint.cu, builds the supports as unions of G's transposed
//    rows over a row's candidates, SO[u] = OR_{v in M[u]} Gin[v] and
//    SI[u] = OR_{v in M[u]} Gout[v], a warp a row, so that their cost
//    scales with the candidates and not with n m W; every support is built
//    before any row changes (the Jacobi semantics of the TPU kernel);
//  * the output is written 16 bytes at a time where the rows are aligned
//    (16 uint8 or 4 int32 entries of M, masked by the row's kept bits), a
//    warp's rows and chunks as one flat loop, so that their loads of M are
//    in flight together; M's own entries are kept.
// Entries of M are taken as non-negative, as
// the plain version's products need, so the output equals the plain
// version bit for bit for any of M's dtypes.
//
// Past n, m = 256 (rt::wide) a wide instantiation of two launches takes
// the sweep, with the wide bit planes of common.cuh (a lane's bits of a
// row in 32-bit words): G's m x m bytes alone pass a block's shared
// memory at m = 482, so nothing is staged as bytes. Launch 1 packs the
// operands that the batch shares once into device scratch, G's wide
// transposed rows and columns (rt::wpack_rows, rt::wpack_cols) and Q's
// bit rows and columns, straight from device memory, a CTA each. Launch
// 2 runs one CTA a candidate matrix: it packs its candidates (wide
// transposed rows), runs one rt::wsweep with every row dirty (every
// support built before any row changes: the Jacobi semantics of the TPU
// kernel) and writes M's own entries where a bit is kept. Its planes
// (candidates and supports) are in shared memory where they fit (up to
// n ~ 600 at m <= 1,024) and in its slice of device scratch where not;
// the packed operands are copied beside them where both fit, else read
// in place.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;

using rt::align16;
using rt::kLaneBits;

// Byte offsets of a CTA's shared memory: G's transposed rows and columns,
// Q's bit rows and columns, the particle's candidates and its supports out
// and in (32 bytes a row each), then the staged bytes of G and Q.
struct Layout {
  int Wn, goutT, ginT, qrow, qcol, cand, gs, qs, total;
};

__host__ __device__ inline Layout layout(int n, int m) {
  Layout L;
  L.Wn = rt::words(n);
  L.goutT = 0;
  L.ginT = align16(L.goutT + 32 * m);
  L.qrow = align16(L.ginT + 32 * m);
  L.qcol = align16(L.qrow + 4 * n * L.Wn);
  L.cand = align16(L.qcol + 4 * n * L.Wn);
  L.gs = align16(L.cand + 3 * 32 * n);
  L.qs = align16(L.gs + m * m);
  L.total = align16(L.qs + n * n);
  return L;
}

// A 0/1 matrix to stage into shared memory at one byte an entry, 1 where
// it is non-zero: `items` 16-byte chunks where its address and size allow
// them (vec), else `items` single entries.
template <typename T>
struct Src {
  const T* p;
  uint8_t* dst;
  int items;
  bool vec;
};

template <typename T>
__device__ __forceinline__ Src<T> source(const T* p, int count,
                                         uint8_t* dst) {
  constexpr int per = 16 / sizeof(T);
  const bool vec = ((uintptr_t)p & 15) == 0 && count % per == 0;
  return Src<T>{p, dst, vec ? count / per : count, vec};
}

template <typename T>
__device__ __forceinline__ uint4 load_item(const Src<T>& s, int i) {
  if (s.vec) return reinterpret_cast<const uint4*>(s.p)[i];
  return make_uint4((uint32_t)(s.p[i] != 0), 0u, 0u, 0u);
}

// Each byte of x as 1 where it is non-zero, else 0: bit 0 of a byte ORed
// with its other bits (only bits 0-3 of a byte feed bit 0, and those take
// bits 4-7 of the same byte).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return x & 0x01010101u;
}

template <typename T>
__device__ __forceinline__ void store_item(const Src<T>& s, int i, uint4 v) {
  if (!s.vec) {
    s.dst[i] = (uint8_t)v.x;
  } else if (sizeof(T) == 1) {
    reinterpret_cast<uint4*>(s.dst)[i] =
        make_uint4(nonzero_bytes(v.x), nonzero_bytes(v.y),
                   nonzero_bytes(v.z), nonzero_bytes(v.w));
  } else {
    reinterpret_cast<uint32_t*>(s.dst)[i] =
        (uint32_t)(v.x != 0) | ((uint32_t)(v.y != 0) << 8) |
        ((uint32_t)(v.z != 0) << 16) | ((uint32_t)(v.w != 0) << 24);
  }
}

// Stage G and Q into shared memory, by the whole CTA: one index space over both, up to four loads a thread issued before
// its stores.
template <typename GT, typename QT>
__device__ __forceinline__ void stage(const Src<GT>& g, const Src<QT>& q) {
  const int total = g.items + q.items;
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    uint4 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * blockDim.x;
      if (i < g.items)
        r[u] = load_item(g, i);
      else if (i < total)
        r[u] = load_item(q, i - g.items);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * blockDim.x;
      if (i < g.items)
        store_item(g, i, r[u]);
      else if (i < total)
        store_item(q, i - g.items, r[u]);
    }
  }
}

// G's lane-transposed rows and columns from its staged 0/1 bytes gs (m x m):
// bit k of goutT[r * 32 + l] is G[r, l + 32 k], of ginT[v * 32 + l]
// G[l + 32 k, v]. With m % 4 == 0 a thread makes four bytes from eight
// 4-byte loads: the words shifted by k and ORed put bit k of byte e in
// byte e (the bytes are 0/1), four times fewer loads than common.cuh's
// byte packs, which take any other m.
__device__ __forceinline__ void pack_g_rows(const uint8_t* gs, int m,
                                            uint8_t* goutT) {
  if (m % 4 != 0) {
    rt::pack_rows_t(gs, m, m, goutT);
    return;
  }
  const int mw = m / 4;                     // words a row
  // item (r, q): the bytes of lanes 4 q .. 4 q + 3 of row r
  for (int idx = threadIdx.x; idx < m * 8; idx += blockDim.x) {
    const int r = idx >> 3, q = idx & 7;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(gs + r * m);
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < kLaneBits; ++k)
      if (q + 8 * k < mw) acc |= row[q + 8 * k] << k;
    reinterpret_cast<uint32_t*>(goutT)[idx] = acc;
  }
}

__device__ __forceinline__ void pack_g_cols(const uint8_t* gs, int m,
                                            uint8_t* ginT) {
  if (m % 4 != 0) {
    rt::pack_cols_t(gs, m, ginT);
    return;
  }
  const int mw = m / 4;
  // item (p, l): lane l's bytes of columns 4 p .. 4 p + 3; neighbouring
  // threads take neighbouring lanes, so that the stores do not conflict
  for (int idx = threadIdx.x; idx < mw * 32; idx += blockDim.x) {
    const int p = idx >> 5, l = idx & 31;
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < kLaneBits; ++k) {
      const int r = l + 32 * k;
      if (r < m) acc |= reinterpret_cast<const uint32_t*>(gs + r * m)[p] << k;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ginT[(4 * p + e) * 32 + l] = (uint8_t)(acc >> (8 * e));
  }
}

// Bits k of a 4-bit group b as a byte mask: 0xff in byte k for bit k.
__device__ __forceinline__ uint32_t byte_mask(uint32_t b) {
  return ((b * 0x00204081u) & 0x01010101u) * 0xffu;
}

// Entries of M kept by the sweep, a 16-byte chunk at a time: 16 uint8 or 4
// int32 entries and their bits.
__device__ __forceinline__ uint4 keep(uint4 v, uint32_t bits, uint8_t) {
  v.x &= byte_mask(bits & 15u);
  v.y &= byte_mask((bits >> 4) & 15u);
  v.z &= byte_mask((bits >> 8) & 15u);
  v.w &= byte_mask((bits >> 12) & 15u);
  return v;
}
__device__ __forceinline__ uint4 keep(uint4 v, uint32_t bits, int32_t) {
  v.x = (bits & 1u) ? v.x : 0u;
  v.y = (bits & 2u) ? v.y : 0u;
  v.z = (bits & 4u) ? v.z : 0u;
  v.w = (bits & 8u) ? v.w : 0u;
  return v;
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

template <typename MT, typename QT, typename GT>
__global__ void __launch_bounds__(kThreads)
refine_kernel(const MT* __restrict__ M, const QT* __restrict__ Q,
              const GT* __restrict__ G, MT* __restrict__ out, int n, int m) {
  const Layout L = layout(n, m);
  extern __shared__ __align__(16) uint8_t sm[];
  const int lane = threadIdx.x & 31, gw = threadIdx.x >> 5;
  const size_t nm = (size_t)n * m;
  uint8_t* MT_ = sm + L.cand;
  uint8_t* soT = MT_ + 32 * n;
  uint8_t* siT = soT + 32 * n;
  uint32_t* qrow = reinterpret_cast<uint32_t*>(sm + L.qrow);
  uint32_t* qcol = reinterpret_cast<uint32_t*>(sm + L.qcol);

  stage(source(G, m * m, sm + L.gs), source(Q, n * n, sm + L.qs));
  // the particle's candidates, lane-transposed (for one k a warp reads 32
  // consecutive entries), two rows at a time
  const MT* Mp = M + blockIdx.x * nm;
  for (int i = gw; i < n; i += 2 * kWarps) {
    const int i2 = i + kWarps;
    uint32_t b1 = 0, b2 = 0;
#pragma unroll
    for (int k = 0; k < kLaneBits; ++k) {
      const int c = lane + 32 * k;
      if (c < m) {
        if (Mp[(size_t)i * m + c] != 0) b1 |= 1u << k;
        if (i2 < n && Mp[(size_t)i2 * m + c] != 0) b2 |= 1u << k;
      }
    }
    MT_[i * 32 + lane] = (uint8_t)b1;
    if (i2 < n) MT_[i2 * 32 + lane] = (uint8_t)b2;
  }
  __syncthreads();
  pack_g_rows(sm + L.gs, m, sm + L.goutT);
  pack_g_cols(sm + L.gs, m, sm + L.ginT);
  rt::pack_q_bits(sm + L.qs, n, qrow, qcol);
  __syncthreads();
  rt::ullmann_sweep_t<false>(sm + L.goutT, sm + L.ginT, qrow, qcol, n, L.Wn,
                             MT_, soT, siT, nullptr, nullptr, threadIdx.x,
                             kThreads);

  // the output: each of the warp's rows' kept bits as 8 words (ballots,
  // into the row's 32 bytes of soT, which the sweep no longer reads), then
  // M's entries where a bit is kept
  MT* o = out + blockIdx.x * nm;
  constexpr int V = 16 / sizeof(MT);        // entries a 16-byte chunk
  const bool vec = (m % V) == 0 && ((uintptr_t)Mp & 15) == 0 &&
                   ((uintptr_t)o & 15) == 0;
  if (!vec) {
    for (int i = gw; i < n; i += kWarps) {
      const uint32_t x = MT_[i * 32 + lane];
#pragma unroll
      for (int k = 0; k < kLaneBits; ++k) {
        const int c = lane + 32 * k;
        if (c < m)
          o[(size_t)i * m + c] =
              ((x >> k) & 1u) ? Mp[(size_t)i * m + c] : MT(0);
      }
    }
    return;
  }
  uint32_t* rows = reinterpret_cast<uint32_t*>(soT);
  for (int i = gw; i < n; i += kWarps) {
    const uint32_t x = MT_[i * 32 + lane];
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < kLaneBits; ++k) {
      const uint32_t w = __ballot_sync(kFull, (x >> k) & 1u);
      if (lane == k) mine = w;
    }
    if (lane < kLaneBits) rows[i * 8 + lane] = mine;
  }
  __syncwarp();
  // the warp's rows and their chunks as one loop
  const int cpr = m / V;
  const int nrows = gw < n ? (n - gw + kWarps - 1) / kWarps : 0;
  for (int it = lane; it < nrows * cpr; it += 32) {
    const int ri = it / cpr, q = it - ri * cpr;
    const int i = gw + ri * kWarps, c = q * V;
    const uint32_t bits =
        (rows[i * 8 + (c >> 5)] >> (c & 31)) & ((1u << V) - 1u);
    const size_t at = (size_t)i * cpr + q;
    reinterpret_cast<uint4*>(o)[at] =
        keep(reinterpret_cast<const uint4*>(Mp)[at], bits, MT());
  }
}

// ---- The wide instantiation ----

constexpr int kPackCtas = 3;    // launch 1: G's rows, G's columns, Q

// Byte offsets of the wide path: the packed operands (the record, in
// device scratch) and a CTA's planes (the work).
struct WLayout {
  int Wn, LW, per;
  size_t goutT, ginT, qrow, qcol, rec;      // record
  size_t cand, soT, siT, dirty, work;       // a CTA's
};

__host__ __device__ inline WLayout wlayout(int n, int m) {
  using rt::align16z;
  WLayout L;
  L.Wn = rt::words(n);
  L.LW = rt::lane_words(m);
  L.per = 32 * L.LW;
  const size_t rows_m = 4ull * m * L.per, rows_n = 4ull * n * L.per;
  L.goutT = 0;
  L.ginT = align16z(L.goutT + rows_m);
  L.qrow = align16z(L.ginT + rows_m);
  L.qcol = align16z(L.qrow + 4ull * n * L.Wn);
  L.rec = align16z(L.qcol + 4ull * n * L.Wn);
  L.cand = 0;
  L.soT = align16z(L.cand + rows_n);
  L.siT = align16z(L.soT + rows_n);
  L.dirty = align16z(L.siT + rows_n);   // two flags a row
  L.work = align16z(L.dirty + 2ull * n);
  return L;
}

// What of a sweep CTA is in shared memory (bit 0: its planes, 1: a copy of
// the record), and its bytes.
struct WPlace {
  int bits;
  size_t smem;
};

WPlace wplace(int n, int m) {
  const WLayout L = wlayout(n, m);
  WPlace w{0, 0};
  if (L.work <= rt::kSmemMax) {
    w.bits = 1;
    w.smem = L.work;
    if (L.work + L.rec <= rt::kSmemMax) {
      w.bits |= 2;
      w.smem += L.rec;
    }
  }
  return w;
}

// Launch 1: the record, from Q and G in device memory.
template <typename QT, typename GT>
__global__ void __launch_bounds__(kThreads)
pack_wide_kernel(const QT* __restrict__ Q, const GT* __restrict__ G,
                 uint8_t* __restrict__ rec, int n, int m) {
  const WLayout L = wlayout(n, m);
  if (blockIdx.x == 0)
    rt::wpack_rows(G, m, m, reinterpret_cast<uint32_t*>(rec + L.goutT),
                   threadIdx.x, blockDim.x);
  else if (blockIdx.x == 1)
    rt::wpack_cols(G, m, reinterpret_cast<uint32_t*>(rec + L.ginT),
                   threadIdx.x, blockDim.x);
  else {
    rt::pack_rows(Q, n, n, reinterpret_cast<uint32_t*>(rec + L.qrow));
    rt::pack_cols(Q, n, reinterpret_cast<uint32_t*>(rec + L.qcol));
  }
}

// Launch 2: one candidate matrix (blockIdx.x); `place` is WPlace::bits.
template <typename MT>
__global__ void __launch_bounds__(kThreads)
refine_wide_kernel(const MT* __restrict__ M, const uint8_t* __restrict__ rec,
                   uint8_t* __restrict__ work, MT* __restrict__ out, int n,
                   int m, int place) {
  const WLayout L = wlayout(n, m);
  extern __shared__ __align__(16) uint8_t sm[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t nm = (size_t)n * m;
  uint8_t* wk = (place & 1) ? sm : work + blockIdx.x * L.work;
  const uint8_t* rp = rec;
  if (place & 2) {
    rt::copy_bytes(sm + L.work, rec, (int)L.rec);
    rp = sm + L.work;
  }
  uint32_t* candT = reinterpret_cast<uint32_t*>(wk + L.cand);
  uint8_t* dirty = wk + L.dirty;
  const MT* Mp = M + blockIdx.x * nm;
  rt::wpack_rows(Mp, n, m, candT, tid, nt);
  for (int i = tid; i < n; i += nt) dirty[i] = 1;
  __syncthreads();
  rt::wsweep(reinterpret_cast<const uint32_t*>(rp + L.goutT),
             reinterpret_cast<const uint32_t*>(rp + L.ginT),
             reinterpret_cast<const uint32_t*>(rp + L.qrow),
             reinterpret_cast<const uint32_t*>(rp + L.qcol), n, L.Wn, L.LW,
             candT, reinterpret_cast<uint32_t*>(wk + L.soT),
             reinterpret_cast<uint32_t*>(wk + L.siT), dirty, dirty + n, tid,
             nt);
  MT* o = out + blockIdx.x * nm;
  for (size_t idx = tid; idx < nm; idx += nt) {
    const int i = (int)(idx / m), j = (int)(idx - (size_t)i * m);
    o[idx] = rt::wtest(candT + (size_t)i * L.per, j) ? Mp[idx] : MT(0);
  }
}

template <typename MT, typename QT, typename GT>
int launch_wide(const void* M, const void* Q, const void* G, void* out,
                void* scratch, int B, int n, int m, cudaStream_t st) {
  const WLayout L = wlayout(n, m);
  const WPlace w = wplace(n, m);
  pack_wide_kernel<QT, GT><<<kPackCtas, kThreads, 0, st>>>(
      (const QT*)Q, (const GT*)G, (uint8_t*)scratch, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = rt::allow_smem((const void*)refine_wide_kernel<MT>, w.smem);
  if (err != cudaSuccess) return (int)err;
  refine_wide_kernel<MT><<<B, kThreads, w.smem, st>>>(
      (const MT*)M, (const uint8_t*)scratch, (uint8_t*)scratch + L.rec,
      (MT*)out, n, m, w.bits);
  return (int)cudaGetLastError();
}

template <typename MT, typename QT, typename GT>
int launch(const void* M, const void* Q, const void* G, void* out,
           void* scratch, int B, int n, int m, void* stream) {
  if (rt::wide(n, m))
    return launch_wide<MT, QT, GT>(M, Q, G, out, scratch, B, n, m,
                                   (cudaStream_t)stream);
  const size_t smem = layout(n, m).total;
  const cudaError_t err =
      rt::allow_smem((const void*)refine_kernel<MT, QT, GT>, smem);
  if (err != cudaSuccess) return (int)err;
  refine_kernel<MT, QT, GT><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const MT*)M, (const QT*)Q, (const GT*)G, (MT*)out, n, m);
  return (int)cudaGetLastError();
}

template <typename MT, typename QT>
int launch_g(int g_i32, const void* M, const void* Q, const void* G,
             void* out, void* scratch, int B, int n, int m, void* stream) {
  return g_i32 ? launch<MT, QT, int32_t>(M, Q, G, out, scratch, B, n, m,
                                         stream)
               : launch<MT, QT, uint8_t>(M, Q, G, out, scratch, B, n, m,
                                         stream);
}

}  // namespace

// Bytes of device scratch that ullmann_refine_step needs for these
// shapes: none on the narrow path; on the wide one the packed operands,
// and each matrix's planes where they pass a block's shared memory.
extern "C" long long ullmann_refine_scratch_bytes(int B, int n, int m) {
  if (!rt::wide(n, m)) return 0;
  const WLayout L = wlayout(n, m);
  return (long long)(L.rec +
                     ((wplace(n, m).bits & 1) ? 0 : (size_t)B * L.work));
}

// M, out: (B, n, m) uint8 (m_i32 = 0) or int32; Q (n, n) and G (m, m),
// shared by the batch, each uint8 or int32 (q_i32, g_i32); scratch holds
// ullmann_refine_scratch_bytes bytes.
extern "C" int ullmann_refine_step(const void* M, const void* Q,
                                   const void* G, void* out, void* scratch,
                                   int B, int n, int m, int m_i32, int q_i32,
                                   int g_i32, void* stream) {
  if (m_i32)
    return q_i32 ? launch_g<int32_t, int32_t>(g_i32, M, Q, G, out, scratch,
                                              B, n, m, stream)
                 : launch_g<int32_t, uint8_t>(g_i32, M, Q, G, out, scratch,
                                              B, n, m, stream);
  return q_i32 ? launch_g<uint8_t, int32_t>(g_i32, M, Q, G, out, scratch, B,
                                            n, m, stream)
               : launch_g<uint8_t, uint8_t>(g_i32, M, Q, G, out, scratch, B,
                                            n, m, stream);
}

// An empty kernel on the grid and block of a B-particle sweep: the floor a
// launch of this shape cannot go below.
extern "C" int ullmann_refine_empty_launch(int B, void* stream) {
  empty_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
