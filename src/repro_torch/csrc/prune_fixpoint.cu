// Fused global pre-prune to fixpoint, batched over problems.
//
// Replaces the TPU kernel prune_fixpoint_pallas (src/repro/kernels/
// prune_fixpoint.py, bodies _prune_kernel and _fused_step). One iteration
// is a Jacobi Ullmann sweep (every support from the mask as it stood at
// the start of the sweep) followed by singleton-row injectivity
// elimination on the swept mask; the loop runs while anything changes and
// the sweep budget holds, and reports the sweeps run, the last one (which
// changes nothing) included.
//
// Bound on the H100: neither bytes (a 56x144 mask is 8 KB) nor operations.
// It is latency: a chain of up to `bound` dependent sweeps, each two
// barrier-separated passes, one CTA per problem. A per-phase timing of the
// earlier design (PERF.md) found 82% of a 6-sweep CTA in the support pass
// (each (row, word) item testing 32 columns in both directions against
// every word of the row) and 9% in packing operands from device memory a
// byte at a time. The design:
//  * G and Q are staged in shared memory with 16-byte loads and packed from
//    there; G lane-transposed (common.cuh: lane l of a warp owns the
//    columns l + 32 k of a row, one byte), Q as bit rows and columns;
//  * a warp owns the rows i = warp + nwarps r (up to 32 warps, 1024
//    threads, at most 8 rows a warp) and alone reads and writes their
//    candidates, lane-transposed in shared memory, and their flags (which
//    changed, which are singletons, which have a predecessor or successor
//    in Q), bit r of a register;
//  * supports are unions of G's transposed rows over a row's candidates,
//      SO[u] = OR_{v in M[u]} Gin[v],  SI[u] = OR_{v in M[u]} Gout[v],
//    each lane ORing its own candidates' 32-byte rows and the warp ORing
//    the lanes' parts; SO[u] only where u has a predecessor and SI[u] only
//    where it has a successor (no other row reads them); only rows whose
//    candidates changed in the last iteration (in the sweep or in the
//    elimination) are rebuilt, since an unchanged row has the supports of
//    the same candidates;
//  * pass 2 of an iteration sweeps the warp's rows against the supports,
//    counts each row's candidates with a warp reduction and lets a
//    singleton row claim its column (a shared OR); pass 1 of the next
//    iteration removes the claimed columns from every other row before it
//    rebuilds supports, and its barrier also carries the convergence flag
//    (__syncthreads_or). The claims alternate between two buffers;
//  * the pruned mask is written row by row, coalesced.
// Everything is exact, so the outputs are bitwise those of the integer
// form (kernels/ref.py). Past n, m = 256 (kMaxDim) prune_wide_kernel runs
// the same iteration on wide rows (see "The wide path" below).
#include "common.cuh"

namespace {

// Byte offsets of a CTA's shared memory.
struct Layout {
  int Wn, goutT, ginT, mt, qrow, qcol, soT, siT, claim, gs, qs, total;
};

using rt::align16;

__host__ __device__ inline Layout layout(int n, int m) {
  Layout L;
  L.Wn = rt::words(n);
  L.goutT = 0;                               // 32 m: G's rows
  L.ginT = align16(L.goutT + 32 * m);        // 32 m: G's columns
  L.mt = align16(L.ginT + 32 * m);           // 32 n: the mask
  L.qrow = align16(L.mt + 32 * n);           // n Wn words: Q's rows
  L.qcol = align16(L.qrow + 4 * n * L.Wn);   // n Wn words: Q's columns
  L.soT = align16(L.qcol + 4 * n * L.Wn);    // 32 n: supports, out
  L.siT = align16(L.soT + 32 * n);           // 32 n: supports, in
  L.claim = align16(L.siT + 32 * n);         // 2 x 32 words
  L.gs = L.claim + 4 * 64;                   // m m bytes: G staged
  L.qs = align16(L.gs + m * m);              // n n bytes: Q staged
  L.total = align16(L.qs + n * n);
  return L;
}

int warps_for(int n) { return n < 32 ? n : 32; }

// The supports of row i (candidates `cand`, lane l's byte) into soT, if
// a row reads them (`out`: i has a predecessor in Q), and into siT (`in`:
// i has a successor); the whole warp calls it.
__device__ __forceinline__ void supports(uint32_t cand, int i, int lane,
                                         bool out, bool in,
                                         const uint8_t* goutT,
                                         const uint8_t* ginT, uint8_t* soT,
                                         uint8_t* siT) {
  uint4 o0 = make_uint4(0, 0, 0, 0), o1 = o0, i0 = o0, i1 = o0;
  while (cand) {
    const int v = lane + 32 * (__ffs(cand) - 1);
    cand &= cand - 1;
    if (out) {
      const uint4* gi = reinterpret_cast<const uint4*>(ginT + v * 32);
      rt::or4(o0, gi[0]);
      rt::or4(o1, gi[1]);
    }
    if (in) {
      const uint4* go = reinterpret_cast<const uint4*>(goutT + v * 32);
      rt::or4(i0, go[0]);
      rt::or4(i1, go[1]);
    }
  }
  if (out) {
    rt::reduce_or4(o0);
    rt::reduce_or4(o1);
    soT[i * 32 + lane] = (uint8_t)rt::byte_of(o0, o1, lane);
  }
  if (in) {
    rt::reduce_or4(i0);
    rt::reduce_or4(i1);
    siT[i * 32 + lane] = (uint8_t)rt::byte_of(i0, i1, lane);
  }
}

template <typename MT>
__global__ void __launch_bounds__(1024)
prune_kernel(const MT* __restrict__ mask, const uint8_t* __restrict__ Q,
             const uint8_t* __restrict__ G, MT* __restrict__ out,
             int* __restrict__ sweeps, int n, int m, int bound) {
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const Layout L = layout(n, m);
  const int Wn = L.Wn;
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* goutT = sm + L.goutT;
  uint8_t* ginT = sm + L.ginT;
  uint8_t* MT_ = sm + L.mt;
  uint32_t* qrow = reinterpret_cast<uint32_t*>(sm + L.qrow);
  uint32_t* qcol = reinterpret_cast<uint32_t*>(sm + L.qcol);
  uint8_t* soT = sm + L.soT;
  uint8_t* siT = sm + L.siT;
  uint32_t* claim = reinterpret_cast<uint32_t*>(sm + L.claim);

  rt::copy_bytes(sm + L.gs, G + (size_t)p * m * m, m * m);
  rt::copy_bytes(sm + L.qs, Q + (size_t)p * n * n, n * n);
  for (int t = tid; t < 64; t += blockDim.x) claim[t] = 0;
  // the warp's rows of the mask, lane-transposed (for one k the warp reads
  // 32 consecutive entries)
  const MT* mk = mask + (size_t)p * n * m;
  for (int i = warp; i < n; i += nwarps) {
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < rt::kLaneBits; ++k) {
      const int c = lane + 32 * k;
      if (c < m && mk[(size_t)i * m + c] != 0) byte |= 1u << k;
    }
    MT_[i * 32 + lane] = (uint8_t)byte;
  }
  __syncthreads();
  rt::pack_rows_t(sm + L.gs, m, m, goutT);
  rt::pack_cols_t(sm + L.gs, m, ginT);
  rt::pack_q_bits(sm + L.qs, n, qrow, qcol);
  __syncthreads();
  // bit r of has_pred / has_succ: the warp's row r has a predecessor (its
  // SO is read) / a successor (its SI is read)
  uint32_t has_pred = 0, has_succ = 0;
  for (int r = 0, i = warp; i < n; ++r, i += nwarps) {
    uint32_t pred = 0, succ = 0;
    for (int wu = 0; wu < Wn; ++wu) {
      pred |= qcol[i * Wn + wu];
      succ |= qrow[i * Wn + wu];
    }
    has_pred |= (uint32_t)(pred != 0) << r;
    has_succ |= (uint32_t)(succ != 0) << r;
    supports(MT_[i * 32 + lane], i, lane, pred != 0, succ != 0, goutT, ginT,
             soT, siT);
  }
  __syncthreads();

  uint32_t single = 0;     // bit r: the warp's row r is a singleton
  int it = 0;
  for (;;) {
    // pass 2: the sweep of the warp's rows, their counts and the claims
    uint32_t* claimed = claim + 32 * (it & 1);
    uint32_t changed = 0;  // bit r: the warp's row r changed
    for (int r = 0, i = warp; i < n; ++r, i += nwarps) {
      const uint32_t x = MT_[i * 32 + lane];
      uint32_t y = x;
      for (int wu = 0; wu < Wn; ++wu) {
        uint32_t out_nb = qrow[i * Wn + wu];
        while (out_nb) {
          const int u = wu * 32 + __ffs(out_nb) - 1;
          out_nb &= out_nb - 1;
          y &= soT[u * 32 + lane];
        }
        uint32_t in_nb = qcol[i * Wn + wu];
        while (in_nb) {
          const int u = wu * 32 + __ffs(in_nb) - 1;
          in_nb &= in_nb - 1;
          y &= siT[u * 32 + lane];
        }
      }
      if (__any_sync(0xffffffffu, y != x)) {
        changed |= 1u << r;
        MT_[i * 32 + lane] = (uint8_t)y;
      }
      if (__reduce_add_sync(0xffffffffu, __popc(y)) == 1) {
        single |= 1u << r;
        if (y) atomicOr(&claimed[lane], y);
      } else {
        single &= ~(1u << r);
      }
    }
    __syncthreads();
    ++it;
    // pass 1: the claimed columns leave every row that is no singleton,
    // then the supports of the rows that changed
    const uint32_t gone = claimed[lane];
    if (tid < 32) claim[32 * (it & 1) + tid] = 0;
    for (int r = 0, i = warp; i < n; ++r, i += nwarps) {
      if ((single >> r) & 1u) continue;
      const uint32_t x = MT_[i * 32 + lane], y = x & ~gone;
      if (__any_sync(0xffffffffu, y != x)) {
        changed |= 1u << r;
        MT_[i * 32 + lane] = (uint8_t)y;
      }
    }
    if (it >= bound) break;
    for (int r = 0, i = warp; i < n; ++r, i += nwarps) {
      if ((changed >> r) & 1u)
        supports(MT_[i * 32 + lane], i, lane, (has_pred >> r) & 1u,
                 (has_succ >> r) & 1u, goutT, ginT, soT, siT);
    }
    if (!__syncthreads_or(changed != 0)) break;
  }

  // the pruned mask (each warp wrote only its own rows)
  MT* o = out + (size_t)p * n * m;
  for (int i = warp; i < n; i += nwarps) {
    const uint32_t x = MT_[i * 32 + lane];
#pragma unroll
    for (int k = 0; k < rt::kLaneBits; ++k) {
      const int c = lane + 32 * k;
      if (c < m) o[(size_t)i * m + c] = MT((x >> k) & 1u);
    }
  }
  if (tid == 0) sweeps[p] = it;
}

// ---- The wide path (n or m > kMaxDim) ----
//
// The same iteration on wide transposed rows (common.cuh), with the
// per-row flags as bytes (a warp may own more than 32 rows) and G packed
// straight from device memory. The n-sized part (the mask, the supports,
// Q's bits, the claims and the flags) is in shared memory where it fits,
// G's transposed rows and columns too where both fit, and either in the
// problem's slice of device scratch where not.
struct WLayout {
  int Wn, LW;
  size_t mt, so, si, qrow, qcol, claim, flags, rows;   // the n-sized part
  size_t gout, gin, g;                                 // G's part
};

__host__ __device__ inline WLayout wlayout(int n, int m) {
  WLayout L;
  L.Wn = rt::words(n);
  L.LW = rt::lane_words(m);
  const size_t plane = (size_t)n * 32 * L.LW * 4;
  L.mt = 0;
  L.so = rt::align16z(L.mt + plane);
  L.si = rt::align16z(L.so + plane);
  L.qrow = rt::align16z(L.si + plane);
  L.qcol = rt::align16z(L.qrow + (size_t)4 * n * L.Wn);
  L.claim = rt::align16z(L.qcol + (size_t)4 * n * L.Wn);
  L.flags = rt::align16z(L.claim + (size_t)2 * 32 * L.LW * 4);
  L.rows = rt::align16z(L.flags + (size_t)4 * n);
  L.gout = 0;
  L.gin = rt::align16z((size_t)m * 32 * L.LW * 4);
  L.g = 2 * L.gin;
  return L;
}

using rt::kSmemMax;

template <typename MT>
__global__ void __launch_bounds__(1024)
prune_wide_kernel(const MT* __restrict__ mask, const uint8_t* __restrict__ Q,
                  const uint8_t* __restrict__ G, MT* __restrict__ out,
                  int* __restrict__ sweeps, uint8_t* __restrict__ scratch,
                  int n, int m, int bound, int rows_smem, int g_smem) {
  const int p = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const WLayout L = wlayout(n, m);
  const int Wn = L.Wn, LW = L.LW, per = 32 * LW;
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* slice = scratch + (size_t)p * (L.rows + L.g);
  uint8_t* R = rows_smem ? sm : slice;
  uint8_t* Gp = g_smem ? sm + L.rows : slice + L.rows;
  uint32_t* goutT = reinterpret_cast<uint32_t*>(Gp + L.gout);
  uint32_t* ginT = reinterpret_cast<uint32_t*>(Gp + L.gin);
  uint32_t* MT_ = reinterpret_cast<uint32_t*>(R + L.mt);
  uint32_t* soT = reinterpret_cast<uint32_t*>(R + L.so);
  uint32_t* siT = reinterpret_cast<uint32_t*>(R + L.si);
  uint32_t* qrow = reinterpret_cast<uint32_t*>(R + L.qrow);
  uint32_t* qcol = reinterpret_cast<uint32_t*>(R + L.qcol);
  uint32_t* claim = reinterpret_cast<uint32_t*>(R + L.claim);
  uint8_t* changed = R + L.flags;     // n bytes each
  uint8_t* single = changed + n;
  uint8_t* has_pred = single + n;
  uint8_t* has_succ = has_pred + n;

  for (int t = tid; t < 2 * per; t += nt) claim[t] = 0;
  const MT* mk = mask + (size_t)p * n * m;
  for (int i = warp; i < n; i += nwarps)
    for (int w = 0; w < LW; ++w) {
      uint32_t word = 0;
      for (int k = 0; k < 32; ++k) {
        const int c = rt::wcol(lane, w, k);
        if (c >= m) break;
        if (mk[(size_t)i * m + c] != 0) word |= 1u << k;
      }
      MT_[(size_t)i * per + w * 32 + lane] = word;
    }
  const uint8_t* g = G + (size_t)p * m * m;
  rt::wpack_rows(g, m, m, goutT, tid, nt);
  rt::wpack_cols(g, m, ginT, tid, nt);
  rt::pack_q_bits(Q + (size_t)p * n * n, n, qrow, qcol);
  __syncthreads();
  for (int i = warp; i < n; i += nwarps) {
    uint32_t pred = 0, succ = 0;
    for (int wu = 0; wu < Wn; ++wu) {
      pred |= qcol[i * Wn + wu];
      succ |= qrow[i * Wn + wu];
    }
    if (lane == 0) {
      has_pred[i] = pred != 0;
      has_succ[i] = succ != 0;
    }
    rt::wsupports(MT_ + (size_t)i * per, i, lane, LW, pred != 0, succ != 0,
                  goutT, ginT, soT, siT);
  }
  __syncthreads();

  int it = 0;
  for (;;) {
    // pass 2: the sweep of the warp's rows, their counts and the claims
    uint32_t* claimed = claim + per * (it & 1);
    bool any = false;      // the warp changed a row (the same in every lane)
    for (int i = warp; i < n; i += nwarps) {
      uint32_t* row = MT_ + (size_t)i * per;
      bool diff = false;
      int cnt = 0;
      for (int w = 0; w < LW; ++w) {
        const int q = w * 32 + lane;
        const uint32_t x = row[q];
        uint32_t y = x;
        for (int wu = 0; wu < Wn; ++wu) {
          uint32_t out_nb = qrow[i * Wn + wu];
          while (out_nb) {
            const int u = wu * 32 + __ffs(out_nb) - 1;
            out_nb &= out_nb - 1;
            y &= soT[(size_t)u * per + q];
          }
          uint32_t in_nb = qcol[i * Wn + wu];
          while (in_nb) {
            const int u = wu * 32 + __ffs(in_nb) - 1;
            in_nb &= in_nb - 1;
            y &= siT[(size_t)u * per + q];
          }
        }
        if (y != x) {
          row[q] = y;
          diff = true;
        }
        cnt += __popc(y);
      }
      const bool ch = __any_sync(0xffffffffu, diff);
      const bool one = __reduce_add_sync(0xffffffffu, cnt) == 1;
      any |= ch;
      if (one)
        for (int w = 0; w < LW; ++w) {
          const uint32_t y = row[w * 32 + lane];
          if (y) atomicOr(&claimed[w * 32 + lane], y);
        }
      if (lane == 0) {
        changed[i] = ch;
        single[i] = one;
      }
    }
    __syncthreads();
    ++it;
    // pass 1: the claimed columns leave every row that is no singleton,
    // then the supports of the rows that changed
    for (int t = tid; t < per; t += nt) claim[per * (it & 1) + t] = 0;
    for (int i = warp; i < n; i += nwarps) {
      if (single[i]) continue;
      uint32_t* row = MT_ + (size_t)i * per;
      bool diff = false;
      for (int w = 0; w < LW; ++w) {
        const uint32_t x = row[w * 32 + lane], y = x & ~claimed[w * 32 + lane];
        if (y != x) {
          row[w * 32 + lane] = y;
          diff = true;
        }
      }
      if (__any_sync(0xffffffffu, diff)) {
        any = true;
        if (lane == 0) changed[i] = 1;
      }
    }
    if (it >= bound) break;
    __syncwarp();
    for (int i = warp; i < n; i += nwarps)
      if (changed[i])
        rt::wsupports(MT_ + (size_t)i * per, i, lane, LW, has_pred[i],
                      has_succ[i], goutT, ginT, soT, siT);
    if (!__syncthreads_or(any)) break;
  }

  // the pruned mask (each warp wrote only its own rows)
  MT* o = out + (size_t)p * n * m;
  for (int i = warp; i < n; i += nwarps) {
    const uint32_t* row = MT_ + (size_t)i * per;
    for (int w = 0; w < LW; ++w) {
      const uint32_t x = row[w * 32 + lane];
      for (int k = 0; k < 32; ++k) {
        const int c = rt::wcol(lane, w, k);
        if (c >= m) break;
        o[(size_t)i * m + c] = MT((x >> k) & 1u);
      }
    }
  }
  if (tid == 0) sweeps[p] = it;
}

template <typename MT>
int launch(const void* mask, const void* Q, const void* G, void* out,
           void* sweeps, void* scratch, int P, int n, int m, int max_iters,
           void* stream) {
  const int bound = max_iters > 0 ? max_iters : n * m + 1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!rt::wide(n, m)) {
    const size_t smem = layout(n, m).total;
    cudaError_t err = rt::allow_smem((const void*)prune_kernel<MT>, smem);
    if (err != cudaSuccess) return (int)err;
    prune_kernel<MT><<<P, 32 * warps_for(n), smem, st>>>(
        (const MT*)mask, (const uint8_t*)Q, (const uint8_t*)G, (MT*)out,
        (int*)sweeps, n, m, bound);
    return (int)cudaGetLastError();
  }
  const WLayout L = wlayout(n, m);
  const bool rows_smem = L.rows <= kSmemMax;
  const bool g_smem = rows_smem && L.rows + L.g <= kSmemMax;
  const size_t smem = (rows_smem ? L.rows : 0) + (g_smem ? L.g : 0);
  cudaError_t err = rt::allow_smem((const void*)prune_wide_kernel<MT>, smem);
  if (err != cudaSuccess) return (int)err;
  prune_wide_kernel<MT><<<P, 32 * warps_for(n), smem, st>>>(
      (const MT*)mask, (const uint8_t*)Q, (const uint8_t*)G, (MT*)out,
      (int*)sweeps, (uint8_t*)scratch, n, m, bound, rows_smem, g_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device scratch that prune_fixpoint needs for these shapes: none
// on the narrow path, each problem's bit planes on the wide one.
extern "C" long long prune_fixpoint_scratch_bytes(int P, int n, int m) {
  if (!rt::wide(n, m)) return 0;
  const WLayout L = wlayout(n, m);
  return (long long)P * (long long)(L.rows + L.g);
}

extern "C" int prune_fixpoint_u8(const void* mask, const void* Q,
                                 const void* G, void* out, void* sweeps,
                                 void* scratch, int P, int n, int m,
                                 int max_iters, void* stream) {
  return launch<uint8_t>(mask, Q, G, out, sweeps, scratch, P, n, m,
                         max_iters, stream);
}

extern "C" int prune_fixpoint_i32(const void* mask, const void* Q,
                                  const void* G, void* out, void* sweeps,
                                  void* scratch, int P, int n, int m,
                                  int max_iters, void* stream) {
  return launch<int32_t>(mask, Q, G, out, sweeps, scratch, P, n, m,
                         max_iters, stream);
}
