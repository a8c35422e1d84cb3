// The fused epoch tail: projections, Ullmann refinement, feasibility and
// the elite consensus, batched over problems.
//
// Replaces the TPU kernel epoch_finish_pallas (src/repro/kernels/
// finish_fused.py, bodies _finish_kernel, _batched_structured,
// _batched_greedy, _batched_sweep and _batched_feasible).
//
// Bound on the H100: latency. Each particle runs three chains of n
// dependent rounds (the structured projection M_a, the greedy projection
// and the structured re-projection M_b), each round a masked argmax whose
// winner decides the next round's candidates. The bytes (one 32 KB S tile
// per particle) and the operations are small; what counts is the length of
// a round and how many rounds wait on each other. The design, set by
// per-phase timings on the card (PERF.md):
//  * launch 1 packs each problem's operands once into device scratch, in
//    three CTAs a problem; more CTAs compute slices of the elite consensus
//    S_bar (the top-k by ranks, then a softmax and the weighted sum);
//  * launch 2, one CTA per (problem, particle), copies its problem's record
//    with 16-byte loads. Every projection chain runs inside one warp,
//    lane l owning the columns l + 32 k: a round's argmax is two warp
//    reductions (ties to the lower index, the jnp.argmax order) and a
//    __syncwarp, with no block barrier;
//  * the 0/1 matrices the chains and sweeps read are lane-transposed: byte
//    X[r * 32 + l] holds in bit k the entry (r, l + 32 k). A lane's
//    candidates in row i are one byte, avail_i & free & AND over the
//    predecessors u of Gout[asg[u]] (kept per placed row), so a round
//    loads one byte per predecessor and a lane's state is a few scalars
//    (per-lane arrays carried across rounds were put in local memory);
//  * the forward check keeps each column's count of free out-neighbours in
//    shared memory and lowers the counts of a taken column's in-neighbours;
//  * M_a (warp 0) and the greedy projection (warp 1) run at once, so the
//    critical path is 2n rounds, not 3n;
//  * the greedy projection caches each free row's best free masked column
//    (value, index; ties to the lower column); a round takes the best row
//    (ties to the lower row: the lowest flat index, as before) and rescans
//    only the rows whose cached column was just taken; it stops at the
//    first round that takes nothing, as every later round would;
//  * the row maximum of the candidate threshold is taken once per row, in
//    the same pass that seeds the greedy cache;
//  * an Ullmann sweep builds the supports of the rows whose candidates
//    changed as unions of G's transposed rows over those candidates, a
//    warp a row with every lane taking its own candidates, and the sweeps
//    stop once one changes nothing;
//  * S lives in shared memory (~52 KB a CTA at (56, 144): 4 CTAs an SM,
//    so the 512 particles of the main path's burst are one wave); where it
//    does not fit the chains read it from device memory.
// Past n, m = 256 (kMaxDim) prep_wide_kernel and finish_wide_kernel run
// the same steps on wide rows (common.cuh; see "The wide path" below),
// and finish_staged_kernel takes the particles where G's planes fit in
// shared memory ("The staged path").
// Integer outputs (M_hat, feasible) equal the plain version's bit for bit;
// S_bar is float32, with another summation order than the plain
// version's up to 256 and the same past it (consensus_slice_plain).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = rt::kMaxDim / 32;    // words of a bit row, at most 8
using rt::kSmemMax;
constexpr int kSliceEntries = 512;         // S_bar entries a consensus CTA
constexpr int kPackCtas = 3;   // launch 1's CTAs a problem for its record

using rt::align16;
using rt::all_cols;
using rt::warp_argmax;

// Byte offsets of one problem's record (written by launch 1) and of one
// particle CTA's shared memory, which starts with a copy of the record.
// goutT, ginT and maskT are lane-transposed (bit k of byte r * 32 + l is
// entry (r, l + 32 k) of G, of G's transpose and of the mask); qrow and
// qcol are Q's and Q^T's bit rows, qsucc each row's successor count and
// fo0 each column's out-degree.
struct Layout {
  int Wn;
  int goutT, ginT, maskT, qrow, qcol, qsucc, fo0, rec;   // record
  int soT, siT, dirty, img, asg_a, asg_p, asg_b, thr, gv, gj, fo, used, flag,
      s;
};

__host__ __device__ inline Layout layout(int n, int m) {
  Layout L;
  L.Wn = rt::words(n);
  L.goutT = 0;
  L.ginT = align16(L.goutT + 32 * m);
  L.maskT = align16(L.ginT + 32 * m);
  L.qrow = align16(L.maskT + 32 * n);
  L.qcol = align16(L.qrow + 4 * n * L.Wn);
  L.qsucc = align16(L.qcol + 4 * n * L.Wn);
  L.fo0 = align16(L.qsucc + 4 * n);
  L.rec = align16(L.fo0 + 4 * m);
  L.soT = L.rec;
  L.siT = align16(L.soT + 32 * n);
  L.dirty = align16(L.siT + 32 * n);    // two flags a row
  L.img = align16(L.dirty + 2 * n);
  L.asg_a = align16(L.img + 32 * n);
  L.asg_p = align16(L.asg_a + 4 * n);
  L.asg_b = align16(L.asg_p + 4 * n);
  L.thr = align16(L.asg_b + 4 * n);
  L.gv = align16(L.thr + 4 * n);
  L.gj = align16(L.gv + 4 * n);
  L.fo = align16(L.gj + 4 * n);
  L.used = align16(L.fo + 4 * m);
  L.flag = align16(L.used + 4 * kMaxW);
  L.s = align16(L.flag + 4);
  return L;
}

bool s_in_smem(int n, int m) {
  return (size_t)layout(n, m).s + 4 * (size_t)n * m <= kSmemMax;
}

// Slice blockIdx.x - kPackCtas of problem blockIdx.y's elite consensus
// (prep_kernel's consensus CTAs); sm holds N + 2 elite_k words.
__device__ __forceinline__ void consensus_slice(
    const float* __restrict__ S, const float* __restrict__ f_final,
    float* __restrict__ S_bar, int N, int n, int m, int elite_k, float temp,
    uint8_t* sm) {
  const int p = blockIdx.y, tid = threadIdx.x, nm = n * m;
  float* fw = reinterpret_cast<float*>(sm);     // N
  float* w = fw + N;                            // elite_k
  int* top = reinterpret_cast<int*>(w + elite_k);   // elite_k
  for (int i = tid; i < N; i += blockDim.x)
    fw[i] = f_final[(size_t)p * N + i];
  __syncthreads();
  // particle i's place in the descending order, ties to the lower index
  // (the order of elite_k argmax rounds, as top_k)
  for (int i = tid; i < N; i += blockDim.x) {
    const float fi = fw[i];
    int rank = 0;
    for (int j = 0; j < N; ++j)
      rank += fw[j] > fi || (fw[j] == fi && j < i);
    if (rank < elite_k) {
      top[rank] = i;
      w[rank] = fi;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const float f0 = w[0];
    float mx = rt::kNeg;
    for (int k = 0; k < elite_k; ++k) {
      w[k] = (w[k] - f0) / temp;
      mx = fmaxf(mx, w[k]);
    }
    float tot = 0.0f;
    for (int k = 0; k < elite_k; ++k) {
      w[k] = expf(w[k] - mx);
      tot = tot + w[k];
    }
    for (int k = 0; k < elite_k; ++k) w[k] = w[k] / tot;
  }
  __syncthreads();
  const int lo = (blockIdx.x - kPackCtas) * kSliceEntries;
  const int hi = min(nm, lo + kSliceEntries);
  for (int idx = lo + tid; idx < hi; idx += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < elite_k; ++k)
      acc = acc + w[k] * S[((size_t)p * N + top[k]) * nm + idx];
    S_bar[(size_t)p * nm + idx] = acc;
  }
}

// Launch 1. blockIdx.x < kPackCtas: a part of the problem's record, from
// its bytes staged in shared memory (0: G's transposed rows and each
// column's out-degree; 1: G's transposed columns; 2: Q's bit rows and
// columns, the successor counts and the mask's transposed rows).
// blockIdx.x >= kPackCtas: slice blockIdx.x - kPackCtas of the problem's
// elite consensus (top elite_k of f_final, ties to the lower index as
// top_k, each particle's place found by counting the ones ahead of it;
// then a softmax and the weighted sum of those S).
__global__ void __launch_bounds__(kThreads)
prep_kernel(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ Q,
            const uint8_t* __restrict__ G, uint8_t* __restrict__ rec,
            const float* __restrict__ S, const float* __restrict__ f_final,
            float* __restrict__ S_bar, int N, int n, int m, int elite_k,
            float temp) {
  const int p = blockIdx.y, tid = threadIdx.x;
  extern __shared__ __align__(16) uint8_t sm[];
  const int nm = n * m;
  if (blockIdx.x < kPackCtas) {
    const Layout L = layout(n, m);
    uint8_t* r = rec + (size_t)p * L.rec;
    if (blockIdx.x < 2) {
      rt::copy_bytes(sm, G + (size_t)p * m * m, m * m);
      __syncthreads();
      if (blockIdx.x == 1) {
        rt::pack_cols_t(sm, m, r + L.ginT);
        return;
      }
      rt::pack_rows_t(sm, m, m, r + L.goutT);
      __syncthreads();
      const uint32_t* rows = reinterpret_cast<const uint32_t*>(r + L.goutT);
      int* fo0 = reinterpret_cast<int*>(r + L.fo0);
      for (int j = tid; j < m; j += blockDim.x)
        fo0[j] = rt::popcount_row(rows + j * 8, 8);
      return;
    }
    uint8_t* q = sm;
    uint8_t* mk = q + align16(n * n);
    rt::copy_bytes(q, Q + (size_t)p * n * n, n * n);
    rt::copy_bytes(mk, mask + (size_t)p * nm, nm);
    __syncthreads();
    uint32_t* qrow = reinterpret_cast<uint32_t*>(r + L.qrow);
    rt::pack_rows(q, n, n, qrow);
    rt::pack_cols(q, n, reinterpret_cast<uint32_t*>(r + L.qcol));
    rt::pack_rows_t(mk, n, m, r + L.maskT);
    __syncthreads();
    int* qsucc = reinterpret_cast<int*>(r + L.qsucc);
    for (int i = tid; i < n; i += blockDim.x)
      qsucc[i] = rt::popcount_row(qrow + i * L.Wn, L.Wn);
    return;
  }
  consensus_slice(S, f_final, S_bar, N, n, m, elite_k, temp, sm);
}

// Operands of one particle CTA, all in shared memory but S where it does
// not fit.
struct Ctx {
  const uint8_t *goutT, *ginT;
  const uint32_t *qrow, *qcol;
  const int *qsucc, *fo0;
  const float* S;      // the particle's S tile, row stride m
  int n, m, W, Wn;
};

// ref.structured_project of one particle, run by one warp: rows in order,
// each on its best free candidate adjacent to every predecessor's image
// and with enough free out-neighbours left for its successors. availT is
// the lane-transposed initial candidates; fo (m counts) and img (n rows
// of 32 bytes: a placed row's image's transposed G row, zero for a row not
// placed) are scratch; with GUMBEL the score is the perturbed log S of the
// tau > 0 path (log(clip(S, 1e-9)) + tau * gum). Writes asg[i] (-1: none).
template <bool GUMBEL>
__device__ __forceinline__ void structured_warp(const Ctx& c,
                                                const uint8_t* availT,
                                                const float* gum, float tau,
                                                int* fo, uint8_t* img,
                                                int* asg) {
  const int lane = threadIdx.x & 31, n = c.n, m = c.m;
  uint32_t cols = all_cols(m);
  for (int j = lane; j < m; j += 32) fo[j] = c.fo0[j];
  for (int i = lane; i < n; i += 32) asg[i] = -1;
  for (int w = lane; w < n * 8; w += 32)
    reinterpret_cast<uint32_t*>(img)[w] = 0u;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    uint32_t cand = availT[i * 32 + lane] & cols;
    // every predecessor placed, and adjacent to the column
    for (int wu = 0; wu < c.Wn; ++wu) {
      uint32_t preds = c.qcol[i * c.Wn + wu];
      while (preds) {
        const int u = wu * 32 + __ffs(preds) - 1;
        preds &= preds - 1;
        cand &= img[u * 32 + lane];
      }
    }
    const int need = c.qsucc[i];
    float v = rt::kNeg;
    int vi = INT32_MAX;
    // the lane's columns, ascending; unrolled, so that their loads issue
    // together
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      if ((cand >> k) & 1u) {
        const int j = lane + 32 * k;
        const int free_out = fo[j];
        float s = c.S[i * m + j];
        if (GUMBEL) s = logf(fmaxf(s, 1e-9f)) + tau * gum[(size_t)i * m + j];
        if (free_out >= need && s > v) { v = s; vi = j; }
      }
    }
    warp_argmax(v, vi);
    if (v > rt::kNeg) {
      if (lane == 0) asg[i] = vi;
      img[i * 32 + lane] = c.goutT[vi * 32 + lane];
      if (lane == (vi & 31)) cols &= ~(1u << (vi >> 5));
      // vi's in-neighbours lose a free out-neighbour
      uint32_t in = c.ginT[vi * 32 + lane];
      while (in) {
        fo[lane + 32 * (__ffs(in) - 1)] -= 1;
        in &= in - 1;
      }
    }
    __syncwarp();
  }
}

// ref.is_feasible of a one-entry-per-row assignment (-1: empty row), run by
// one warp; `used` is kMaxW words of scratch.
__device__ __forceinline__ bool feasible_warp(const Ctx& c, const int* asg,
                                              uint32_t* used) {
  const int lane = threadIdx.x & 31, n = c.n;
  for (int k = lane; k < kMaxW; k += 32) used[k] = 0u;
  __syncwarp();
  bool ok = true;
  for (int i = lane; i < n; i += 32) {
    const int a = asg[i];
    if (a < 0) { ok = false; continue; }
    const uint32_t bit = 1u << (a & 31);
    if (atomicOr(&used[a >> 5], bit) & bit) ok = false;
  }
  if (!__all_sync(0xffffffffu, ok)) return false;
  for (int i = lane; i < n; i += 32) {
    const uint8_t* ga = c.goutT + asg[i] * 32;
    for (int wu = 0; wu < c.Wn; ++wu) {
      uint32_t succ = c.qrow[i * c.Wn + wu];
      while (succ) {
        const int b = asg[wu * 32 + __ffs(succ) - 1];
        succ &= succ - 1;
        if (!((ga[b & 31] >> (b >> 5)) & 1u)) ok = false;
      }
    }
  }
  return __all_sync(0xffffffffu, ok);
}

// Launch 2: one particle (blockIdx.x) of one problem (blockIdx.y).
template <bool SMEM>
__global__ void __launch_bounds__(kThreads, 4)
finish_kernel(const float* __restrict__ S_, const float* __restrict__ gum,
              const uint8_t* __restrict__ rec, uint8_t* __restrict__ M_hat,
              uint8_t* __restrict__ feas_out, int N, int n, int m,
              float gumbel_tau, float refine_threshold, int refine_iters) {
  const int p = blockIdx.y, part = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nt = blockDim.x;
  const int nwarps = nt >> 5, nm = n * m;
  const Layout L = layout(n, m);
  extern __shared__ __align__(16) uint8_t sm[];
  const size_t base = ((size_t)p * N + part) * nm;
  rt::copy_bytes(sm, rec + (size_t)p * L.rec, L.rec);
  float* St = reinterpret_cast<float*>(sm + L.s);
  if (SMEM) {
    if ((m & 3) == 0) {
      for (int g = tid; g < nm / 4; g += nt)
        reinterpret_cast<float4*>(St)[g] =
            reinterpret_cast<const float4*>(S_ + base)[g];
    } else {
      for (int idx = tid; idx < nm; idx += nt) St[idx] = S_[base + idx];
    }
  }
  __syncthreads();
  Ctx c;
  c.goutT = sm + L.goutT;
  c.ginT = sm + L.ginT;
  c.qrow = reinterpret_cast<const uint32_t*>(sm + L.qrow);
  c.qcol = reinterpret_cast<const uint32_t*>(sm + L.qcol);
  c.qsucc = reinterpret_cast<const int*>(sm + L.qsucc);
  c.fo0 = reinterpret_cast<const int*>(sm + L.fo0);
  c.S = SMEM ? St : S_ + base;
  c.n = n;
  c.m = m;
  c.W = rt::words(m);
  c.Wn = L.Wn;
  // the mask's transposed rows; after the chains, the candidate set
  uint8_t* maskT = sm + L.maskT;
  uint8_t* soT = sm + L.soT;
  uint8_t* siT = sm + L.siT;
  uint8_t* dirty = sm + L.dirty;
  uint8_t* img = sm + L.img;
  int* asg_a = reinterpret_cast<int*>(sm + L.asg_a);
  int* asg_p = reinterpret_cast<int*>(sm + L.asg_p);
  int* asg_b = reinterpret_cast<int*>(sm + L.asg_b);
  float* thr = reinterpret_cast<float*>(sm + L.thr);
  float* gv = reinterpret_cast<float*>(sm + L.gv);
  int* gj = reinterpret_cast<int*>(sm + L.gj);
  int* fo = reinterpret_cast<int*>(sm + L.fo);
  uint32_t* used = reinterpret_cast<uint32_t*>(sm + L.used);
  int* take_a = reinterpret_cast<int*>(sm + L.flag);

  // each row once, a warp a row: its maximum (the candidate threshold) and
  // its best masked column (the greedy cache)
  for (int i = warp; i < n; i += nwarps) {
    const uint32_t mk = maskT[i * 32 + lane];
    float mx = rt::kNeg, v = rt::kNeg;
    int vi = INT32_MAX;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      const int j = lane + 32 * k;
      if (j < m) {
        const float s = c.S[i * m + j];
        mx = fmaxf(mx, s);
        if (((mk >> k) & 1u) && s > v) { v = s; vi = j; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    warp_argmax(v, vi);
    if (lane == 0) {
      thr[i] = refine_threshold * mx;
      gv[i] = v;
      gj[i] = vi;
    }
  }
  __syncthreads();

  // M_a (warp 0, then its feasibility) beside the greedy projection (warp 1)
  bool feas_a = false;
  if (warp == 0) {
    const float* g = gum == nullptr ? nullptr : gum + base;
    if (gumbel_tau > 0.0f)
      structured_warp<true>(c, maskT, g, gumbel_tau, fo, img, asg_a);
    else
      structured_warp<false>(c, maskT, nullptr, 0.0f, fo, img, asg_a);
    feas_a = feasible_warp(c, asg_a, used);
  } else if (warp == 1) {
    rt::greedy_warp(c.S, n, m, maskT, gv, gj, asg_p);
  }
  __syncthreads();

  // candidate set S >= thr * rowmax or the greedy pick, masked, a warp a
  // row; it takes the place of the mask
  uint8_t* candT = maskT;
  for (int i = warp; i < n; i += nwarps) {
    const float t = thr[i];
    const int pick = asg_p[i];
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < kMaxW; ++k) {
      const int j = lane + 32 * k;
      if (j < m && (c.S[i * m + j] >= t || pick == j)) byte |= 1u << k;
    }
    candT[i * 32 + lane] &= (uint8_t)byte;
  }
  for (int i = tid; i < n; i += nt) dirty[i] = 1;
  __syncthreads();
  for (int it = 0; it < refine_iters; ++it) {
    uint8_t* d = dirty + (it & 1) * n;
    if (!rt::ullmann_sweep_t<true>(c.goutT, c.ginT, c.qrow, c.qcol, n, c.Wn,
                                   candT, soT, siT, d,
                                   dirty + n - (it & 1) * n, threadIdx.x,
                                   blockDim.x))
      break;                               // a fixpoint: later sweeps too
  }

  // M_b, the fallback to M_proj on empty rows, its feasibility; the merge
  if (warp == 0) {
    structured_warp<false>(c, candT, nullptr, 0.0f, fo, img, asg_b);
    for (int i = lane; i < n; i += 32) {      // a row's 32 bytes at once
      const uint4* row = reinterpret_cast<const uint4*>(candT + i * 32);
      const uint4 a = row[0], b = row[1];
      if ((a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w) == 0)
        asg_b[i] = asg_p[i];
    }
    __syncwarp();
    const bool feas_b = feasible_warp(c, asg_b, used);
    if (lane == 0) {
      feas_out[(size_t)p * N + part] = feas_a || feas_b;
      *take_a = feas_a;
    }
  }
  __syncthreads();
  const int* asg = *take_a ? asg_a : asg_b;
  uint8_t* out = M_hat + base;
  if ((nm & 3) == 0) {
    for (int wi = tid; wi < nm / 4; wi += nt) {
      int i = 4 * wi / m, j = 4 * wi - i * m;
      uint32_t word = 0;
      for (int b = 0; b < 4; ++b) {
        word |= (uint32_t)(asg[i] == j) << (8 * b);
        if (++j == m) { j = 0; ++i; }
      }
      reinterpret_cast<uint32_t*>(out)[wi] = word;
    }
  } else {
    for (int idx = tid; idx < nm; idx += nt) {
      const int i = idx / m;
      out[idx] = asg[i] == idx - i * m ? 1 : 0;
    }
  }
}

size_t prep_smem(int N, int n, int m, int elite_k) {
  const size_t g = (size_t)m * m, qm = (size_t)align16(n * n) + n * m;
  const size_t pack = g > qm ? g : qm;
  const size_t cons = sizeof(float) * (size_t)(N + 2 * elite_k);
  return pack > cons ? pack : cons;
}

// ---- The wide path (n or m > kMaxDim) ----
//
// The same two launches on wide transposed rows (common.cuh): a lane's
// bits of a row are 32-bit words, plane w holding its columns
// l + 32 (32 w + k), and the free columns of a chain are a plane in
// memory rather than a register. The record (G's transposed rows and
// columns, the mask's rows, Q's bits and counts) is packed straight from
// device memory. A particle CTA's working planes (the candidates, the
// supports, the placed rows' images, the flags and the chains' state) are
// in shared memory where they fit, else in its slice of device scratch;
// the record is copied beside them where both fit, else read in place,
// and S likewise after both.
struct WLayout {
  int Wn, LW, per, Wm;
  size_t goutT, ginT, maskT, qrow, qcol, qsucc, fo0, rec;     // record
  size_t cand, soT, siT, img, dirty, asg_a, asg_p, asg_b, thr, gv, gj, fo,
      free0, free1, used, flag, work;                         // a CTA's
};

__host__ __device__ inline WLayout wlayout(int n, int m) {
  using rt::align16z;
  WLayout L;
  L.Wn = rt::words(n);
  L.LW = rt::lane_words(m);
  L.per = 32 * L.LW;
  L.Wm = rt::words(m);
  const size_t rows_m = 4ull * m * L.per, rows_n = 4ull * n * L.per;
  L.goutT = 0;
  L.ginT = align16z(L.goutT + rows_m);
  L.maskT = align16z(L.ginT + rows_m);
  L.qrow = align16z(L.maskT + rows_n);
  L.qcol = align16z(L.qrow + 4ull * n * L.Wn);
  L.qsucc = align16z(L.qcol + 4ull * n * L.Wn);
  L.fo0 = align16z(L.qsucc + 4ull * n);
  L.rec = align16z(L.fo0 + 4ull * m);
  L.cand = 0;
  L.soT = align16z(L.cand + rows_n);
  L.siT = align16z(L.soT + rows_n);
  L.img = align16z(L.siT + rows_n);
  L.dirty = align16z(L.img + rows_n);    // two flags a row
  L.asg_a = align16z(L.dirty + 2ull * n);
  L.asg_p = align16z(L.asg_a + 4ull * n);
  L.asg_b = align16z(L.asg_p + 4ull * n);
  L.thr = align16z(L.asg_b + 4ull * n);
  L.gv = align16z(L.thr + 4ull * n);
  L.gj = align16z(L.gv + 4ull * n);
  L.fo = align16z(L.gj + 4ull * n);
  L.free0 = align16z(L.fo + 4ull * m);
  L.free1 = align16z(L.free0 + 4ull * L.per);
  L.used = align16z(L.free1 + 4ull * L.per);
  L.flag = align16z(L.used + 4ull * L.Wm);
  L.work = align16z(L.flag + 4);
  return L;
}

// What of a particle CTA is in shared memory (bit 0: the working planes,
// 1: a copy of the record, 2: S), and its bytes.
struct WPlace {
  int bits;
  size_t smem;
};

WPlace wplace(int n, int m) {
  const WLayout L = wlayout(n, m);
  const size_t s = 4ull * n * m;
  WPlace w{0, 0};
  if (L.work <= kSmemMax) {
    w.bits = 1;
    w.smem = L.work;
    if (L.work + L.rec <= kSmemMax) {
      w.bits |= 2;
      w.smem += L.rec;
      if (w.smem + s <= kSmemMax) {
        w.bits |= 4;
        w.smem += s;
      }
    }
  }
  return w;
}

// consensus_slice in the plain version's order of operations on the card
// as torch 2.11.0 (CUDA 12.8) sums on the H100, matched with a probe
// (PERF.md; the narrow path keeps its own). The order is internal to
// that torch build: another may sum otherwise, and the card test of S̄
// bit for bit past 256 then fails with no change here. It takes the
// softmax's sum over the elite as torch's warp softmax takes it (each of
// min(W, 32) lanes, W the next power of two of elite_k, sums its
// elements l, l + 32, ... in order, then halving offsets), and an
// entry's weighted sum over the elite as torch's sum over that axis
// takes it (four accumulators, k mod 4, combined 0 + 1, + 2, + 3). So S̄
// equals the plain version's bit for bit past 256.
__device__ __forceinline__ void consensus_slice_plain(
    const float* __restrict__ S, const float* __restrict__ f_final,
    float* __restrict__ S_bar, int N, int n, int m, int elite_k, float temp,
    uint8_t* sm) {
  const int p = blockIdx.y, tid = threadIdx.x, nm = n * m;
  float* fw = reinterpret_cast<float*>(sm);     // N
  float* w = fw + N;                            // elite_k
  int* top = reinterpret_cast<int*>(w + elite_k);   // elite_k
  float* part = reinterpret_cast<float*>(top + elite_k);   // 32 lanes
  for (int i = tid; i < N; i += blockDim.x)
    fw[i] = f_final[(size_t)p * N + i];
  __syncthreads();
  for (int i = tid; i < N; i += blockDim.x) {
    const float fi = fw[i];
    int rank = 0;
    for (int j = 0; j < N; ++j)
      rank += fw[j] > fi || (fw[j] == fi && j < i);
    if (rank < elite_k) {
      top[rank] = i;
      w[rank] = fi;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const float f0 = w[0];
    float mx = rt::kNeg;
    for (int k = 0; k < elite_k; ++k) {
      w[k] = (w[k] - f0) / temp;
      mx = fmaxf(mx, w[k]);
    }
    for (int k = 0; k < elite_k; ++k) w[k] = expf(w[k] - mx);
    int W = 1;
    while (W < elite_k) W <<= 1;
    const int lanes = W < 32 ? W : 32;
    for (int l = 0; l < lanes; ++l) {
      float acc = 0.0f;
      for (int k = l; k < W; k += 32) acc = acc + (k < elite_k ? w[k] : 0.0f);
      part[l] = acc;
    }
    for (int off = lanes / 2; off > 0; off >>= 1)
      for (int l = 0; l < off; ++l) part[l] = part[l] + part[l + off];
    const float tot = part[0];
    for (int k = 0; k < elite_k; ++k) w[k] = w[k] / tot;
  }
  __syncthreads();
  const int lo = (blockIdx.x - kPackCtas) * kSliceEntries;
  const int hi = min(nm, lo + kSliceEntries);
  for (int idx = lo + tid; idx < hi; idx += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int k = 0;
    for (; k + 4 <= elite_k; k += 4) {
      a0 = a0 + w[k] * S[((size_t)p * N + top[k]) * nm + idx];
      a1 = a1 + w[k + 1] * S[((size_t)p * N + top[k + 1]) * nm + idx];
      a2 = a2 + w[k + 2] * S[((size_t)p * N + top[k + 2]) * nm + idx];
      a3 = a3 + w[k + 3] * S[((size_t)p * N + top[k + 3]) * nm + idx];
    }
    if (k < elite_k) a0 = a0 + w[k] * S[((size_t)p * N + top[k]) * nm + idx];
    if (k + 1 < elite_k)
      a1 = a1 + w[k + 1] * S[((size_t)p * N + top[k + 1]) * nm + idx];
    if (k + 2 < elite_k)
      a2 = a2 + w[k + 2] * S[((size_t)p * N + top[k + 2]) * nm + idx];
    S_bar[(size_t)p * nm + idx] = ((a0 + a1) + a2) + a3;
  }
}

// Launch 1 of the wide path: prep_kernel with the record packed from
// device memory, and S̄ by consensus_slice_plain.
__global__ void __launch_bounds__(kThreads)
prep_wide_kernel(const uint8_t* __restrict__ mask,
                 const uint8_t* __restrict__ Q, const uint8_t* __restrict__ G,
                 uint8_t* __restrict__ rec, const float* __restrict__ S,
                 const float* __restrict__ f_final, float* __restrict__ S_bar,
                 int N, int n, int m, int elite_k, float temp) {
  const int p = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ __align__(16) uint8_t sm[];
  if (blockIdx.x < kPackCtas) {
    const WLayout L = wlayout(n, m);
    uint8_t* r = rec + (size_t)p * L.rec;
    const uint8_t* g = G + (size_t)p * m * m;
    if (blockIdx.x == 0) {
      uint32_t* rows = reinterpret_cast<uint32_t*>(r + L.goutT);
      rt::wpack_rows(g, m, m, rows, tid, nt);
      __syncthreads();
      int* fo0 = reinterpret_cast<int*>(r + L.fo0);
      for (int j = tid; j < m; j += nt)
        fo0[j] = rt::popcount_row(rows + (size_t)j * L.per, L.per);
    } else if (blockIdx.x == 1) {
      rt::wpack_cols(g, m, reinterpret_cast<uint32_t*>(r + L.ginT), tid, nt);
    } else {
      const uint8_t* q = Q + (size_t)p * n * n;
      uint32_t* qrow = reinterpret_cast<uint32_t*>(r + L.qrow);
      rt::pack_rows(q, n, n, qrow);
      rt::pack_cols(q, n, reinterpret_cast<uint32_t*>(r + L.qcol));
      rt::wpack_rows(mask + (size_t)p * n * m, n, m,
                     reinterpret_cast<uint32_t*>(r + L.maskT), tid, nt);
      __syncthreads();
      int* qsucc = reinterpret_cast<int*>(r + L.qsucc);
      for (int i = tid; i < n; i += nt)
        qsucc[i] = rt::popcount_row(qrow + (size_t)i * L.Wn, L.Wn);
    }
    return;
  }
  consensus_slice_plain(S, f_final, S_bar, N, n, m, elite_k, temp, sm);
}

// Operands of a wide particle CTA.
struct WCtx {
  const uint32_t *goutT, *ginT, *qrow, *qcol;
  const int *qsucc, *fo0;
  const float* S;      // the particle's S tile, row stride m
  int n, m, Wn, LW, per;
};

// structured_warp on wide rows: availT the initial candidates, fo (m
// counts), img (n wide rows) and freeT (one plane a lane: the columns
// still free) scratch. Writes asg[i] (-1: none).
template <bool GUMBEL>
__device__ __forceinline__ void wstructured(const WCtx& c,
                                            const uint32_t* availT,
                                            const float* gum, float tau,
                                            int* fo, uint32_t* img,
                                            uint32_t* freeT, int* asg) {
  const int lane = threadIdx.x & 31, n = c.n, m = c.m, per = c.per;
  for (int w = 0; w < c.LW; ++w) freeT[w * 32 + lane] = rt::wall_cols(lane, w, m);
  for (int j = lane; j < m; j += 32) fo[j] = c.fo0[j];
  for (int i = lane; i < n; i += 32) asg[i] = -1;
  for (size_t x = lane; x < (size_t)n * per; x += 32) img[x] = 0u;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const int need = c.qsucc[i];
    float v = rt::kNeg;
    int vi = INT32_MAX;
    for (int w = 0; w < c.LW; ++w) {
      const int q = w * 32 + lane;
      uint32_t cand = availT[(size_t)i * per + q] & freeT[q];
      // every predecessor placed, and adjacent to the column
      for (int wu = 0; wu < c.Wn; ++wu) {
        uint32_t preds = c.qcol[i * c.Wn + wu];
        while (preds) {
          const int u = wu * 32 + __ffs(preds) - 1;
          preds &= preds - 1;
          cand &= img[(size_t)u * per + q];
        }
      }
      while (cand) {                 // the lane's columns, ascending
        const int j = rt::wcol(lane, w, __ffs(cand) - 1);
        cand &= cand - 1;
        const int free_out = fo[j];
        float s = c.S[(size_t)i * m + j];
        if (GUMBEL) s = logf(fmaxf(s, 1e-9f)) + tau * gum[(size_t)i * m + j];
        if (free_out >= need && s > v) { v = s; vi = j; }
      }
    }
    rt::warp_argmax(v, vi);
    if (v > rt::kNeg) {
      if (lane == 0) asg[i] = vi;
      for (int w = 0; w < c.LW; ++w)
        img[(size_t)i * per + w * 32 + lane] =
            c.goutT[(size_t)vi * per + w * 32 + lane];
      if (lane == (vi & 31)) {
        const int b = vi >> 5;
        freeT[(b >> 5) * 32 + lane] &= ~(1u << (b & 31));
      }
      // vi's in-neighbours lose a free out-neighbour
      for (int w = 0; w < c.LW; ++w) {
        uint32_t in = c.ginT[(size_t)vi * per + w * 32 + lane];
        while (in) {
          fo[rt::wcol(lane, w, __ffs(in) - 1)] -= 1;
          in &= in - 1;
        }
      }
    }
    __syncwarp();
  }
}

// feasible_warp on wide rows; `used` is words(m) words of scratch.
__device__ __forceinline__ bool wfeasible(const WCtx& c, const int* asg,
                                          uint32_t* used) {
  const int lane = threadIdx.x & 31, n = c.n;
  for (int k = lane; k < rt::words(c.m); k += 32) used[k] = 0u;
  __syncwarp();
  bool ok = true;
  for (int i = lane; i < n; i += 32) {
    const int a = asg[i];
    if (a < 0) { ok = false; continue; }
    const uint32_t bit = 1u << (a & 31);
    if (atomicOr(&used[a >> 5], bit) & bit) ok = false;
  }
  if (!__all_sync(0xffffffffu, ok)) return false;
  for (int i = lane; i < n; i += 32) {
    const uint32_t* ga = c.goutT + (size_t)asg[i] * c.per;
    for (int wu = 0; wu < c.Wn; ++wu) {
      uint32_t succ = c.qrow[i * c.Wn + wu];
      while (succ) {
        const int b = asg[wu * 32 + __ffs(succ) - 1];
        succ &= succ - 1;
        if (!rt::wtest(ga, b)) ok = false;
      }
    }
  }
  return __all_sync(0xffffffffu, ok);
}

// Launch 2 of the wide path: one particle (blockIdx.x) of one problem
// (blockIdx.y); `place` is WPlace::bits.
__global__ void __launch_bounds__(kThreads)
finish_wide_kernel(const float* __restrict__ S_, const float* __restrict__ gum,
                   const uint8_t* __restrict__ rec, uint8_t* __restrict__ work,
                   uint8_t* __restrict__ M_hat,
                   uint8_t* __restrict__ feas_out, int N, int n, int m,
                   float gumbel_tau, float refine_threshold, int refine_iters,
                   int place) {
  const int p = blockIdx.y, part = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nt = blockDim.x;
  const int nwarps = nt >> 5;
  const WLayout L = wlayout(n, m);
  const int per = L.per;
  const size_t nm = (size_t)n * m, cta = (size_t)p * N + part;
  const size_t base = cta * nm;
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* wk = (place & 1) ? sm : work + cta * L.work;
  const uint8_t* rp = rec + (size_t)p * L.rec;
  if (place & 2) {
    rt::copy_bytes(sm + L.work, rp, (int)L.rec);
    rp = sm + L.work;
  }
  const float* S = S_ + base;
  if (place & 4) {
    float* St = reinterpret_cast<float*>(sm + L.work + L.rec);
    if ((m & 3) == 0) {
      for (size_t g = tid; g < nm / 4; g += nt)
        reinterpret_cast<float4*>(St)[g] =
            reinterpret_cast<const float4*>(S)[g];
    } else {
      for (size_t idx = tid; idx < nm; idx += nt) St[idx] = S[idx];
    }
    S = St;
  }
  __syncthreads();
  WCtx c;
  c.goutT = reinterpret_cast<const uint32_t*>(rp + L.goutT);
  c.ginT = reinterpret_cast<const uint32_t*>(rp + L.ginT);
  c.qrow = reinterpret_cast<const uint32_t*>(rp + L.qrow);
  c.qcol = reinterpret_cast<const uint32_t*>(rp + L.qcol);
  c.qsucc = reinterpret_cast<const int*>(rp + L.qsucc);
  c.fo0 = reinterpret_cast<const int*>(rp + L.fo0);
  c.S = S;
  c.n = n;
  c.m = m;
  c.Wn = L.Wn;
  c.LW = L.LW;
  c.per = per;
  const uint32_t* maskT = reinterpret_cast<const uint32_t*>(rp + L.maskT);
  uint32_t* candT = reinterpret_cast<uint32_t*>(wk + L.cand);
  uint32_t* soT = reinterpret_cast<uint32_t*>(wk + L.soT);
  uint32_t* siT = reinterpret_cast<uint32_t*>(wk + L.siT);
  uint32_t* img = reinterpret_cast<uint32_t*>(wk + L.img);
  uint8_t* dirty = wk + L.dirty;
  int* asg_a = reinterpret_cast<int*>(wk + L.asg_a);
  int* asg_p = reinterpret_cast<int*>(wk + L.asg_p);
  int* asg_b = reinterpret_cast<int*>(wk + L.asg_b);
  float* thr = reinterpret_cast<float*>(wk + L.thr);
  float* gv = reinterpret_cast<float*>(wk + L.gv);
  int* gj = reinterpret_cast<int*>(wk + L.gj);
  int* fo = reinterpret_cast<int*>(wk + L.fo);
  uint32_t* free0 = reinterpret_cast<uint32_t*>(wk + L.free0);
  uint32_t* free1 = reinterpret_cast<uint32_t*>(wk + L.free1);
  uint32_t* used = reinterpret_cast<uint32_t*>(wk + L.used);
  int* take_a = reinterpret_cast<int*>(wk + L.flag);

  // each row once, a warp a row: its maximum (the candidate threshold) and
  // its best masked column (the greedy cache)
  for (int i = warp; i < n; i += nwarps) {
    float mx = rt::kNeg, v = rt::kNeg;
    int vi = INT32_MAX;
    for (int w = 0; w < L.LW; ++w) {
      const uint32_t mk = maskT[(size_t)i * per + w * 32 + lane];
      for (int k = 0; k < 32; ++k) {
        const int j = rt::wcol(lane, w, k);
        if (j >= m) break;
        const float s = S[(size_t)i * m + j];
        mx = fmaxf(mx, s);
        if (((mk >> k) & 1u) && s > v) { v = s; vi = j; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    rt::warp_argmax(v, vi);
    if (lane == 0) {
      thr[i] = refine_threshold * mx;
      gv[i] = v;
      gj[i] = vi;
    }
  }
  __syncthreads();

  // M_a (warp 0, then its feasibility) beside the greedy projection (warp 1)
  bool feas_a = false;
  if (warp == 0) {
    const float* g = gum == nullptr ? nullptr : gum + base;
    if (gumbel_tau > 0.0f)
      wstructured<true>(c, maskT, g, gumbel_tau, fo, img, free0, asg_a);
    else
      wstructured<false>(c, maskT, nullptr, 0.0f, fo, img, free0, asg_a);
    feas_a = wfeasible(c, asg_a, used);
  } else if (warp == 1) {
    rt::wgreedy(c.S, n, m, c.LW, maskT, gv, gj, free1, asg_p);
  }
  __syncthreads();

  // candidate set S >= thr * rowmax or the greedy pick, masked, a warp a row
  for (int i = warp; i < n; i += nwarps) {
    const float t = thr[i];
    const int pick = asg_p[i];
    for (int w = 0; w < L.LW; ++w) {
      uint32_t word = 0;
      for (int k = 0; k < 32; ++k) {
        const int j = rt::wcol(lane, w, k);
        if (j >= m) break;
        if (S[(size_t)i * m + j] >= t || pick == j) word |= 1u << k;
      }
      const size_t q = (size_t)i * per + w * 32 + lane;
      candT[q] = maskT[q] & word;
    }
  }
  for (int i = tid; i < n; i += nt) dirty[i] = 1;
  __syncthreads();
  for (int it = 0; it < refine_iters; ++it) {
    uint8_t* d = dirty + (it & 1) * n;
    if (!rt::wsweep(c.goutT, c.ginT, c.qrow, c.qcol, n, c.Wn, c.LW, candT,
                    soT, siT, d, dirty + n - (it & 1) * n, tid, nt))
      break;                               // a fixpoint: later sweeps too
  }

  // M_b, the fallback to M_proj on empty rows, its feasibility; the merge
  if (warp == 0) {
    wstructured<false>(c, candT, nullptr, 0.0f, fo, img, free0, asg_b);
    for (int i = lane; i < n; i += 32) {
      uint32_t any = 0;
      for (int q = 0; q < per; ++q) any |= candT[(size_t)i * per + q];
      if (any == 0) asg_b[i] = asg_p[i];
    }
    __syncwarp();
    const bool feas_b = wfeasible(c, asg_b, used);
    if (lane == 0) {
      feas_out[cta] = feas_a || feas_b;
      *take_a = feas_a;
    }
  }
  __syncthreads();
  const int* asg = *take_a ? asg_a : asg_b;
  uint8_t* out = M_hat + base;
  for (size_t idx = tid; idx < nm; idx += nt) {
    const int i = (int)(idx / m);
    out[idx] = asg[i] == (int)(idx - (size_t)i * m) ? 1 : 0;
  }
}

// ---- The staged path (wide, one plane a lane, where it fits) ----
//
// Measured on the H100 at (312, 528) (PERF.md): finish_wide_kernel spent
// ~70% of its CTAs' cycles in the Ullmann sweeps and ~8% in the greedy
// chain beside M_a, because the record (~200 KB) did not fit beside the
// working planes and each sweep's supports walked every candidate of a
// row in every lane, two loads from device memory a candidate; a chain's
// round waited on its predecessors' Q^T words and on S, one load from
// device memory after another. finish_staged_kernel keeps the operands
// that come after a load's outcome in shared memory and lets only the
// ones known ahead come from device memory:
//  * G's transposed rows and columns (135 KB at (312, 528)) are copied
//    into shared memory; the placed rows' images are gone (a round ANDs
//    the predecessors' G rows by their assignment), and so are the
//    support planes: a sweep copies the candidates to a second buffer,
//    each warp builds a dirty row's supports with its lanes each OR-ing
//    their own candidates' G rows and one OR across the warp a word, and
//    ANDs them into the rows of its Q neighbours (atomicAnd in shared
//    memory), which equals rt::wsweep: a row not dirty has supports that
//    hold its neighbours' candidates already (they only shrink);
//  * a chain stages round i + 1's S row (and Gumbel row), available word
//    and predecessors' Q^T words with cp.async into a double buffer (in
//    the sweep's second buffer, idle during the chains) while round i
//    runs;
//  * the passes over S's rows and the greedy chain's rescans issue a
//    lane's loads of a row at once.
// It takes the wide shapes whose two candidate buffers fit beside G's
// planes (one plane a lane: m <= 1,024); finish_wide_kernel the rest.

constexpr int kPer = 32;      // words of a wide row with one plane a lane
constexpr int kStages = 4;    // a chain's staged rounds: i + 1 .. i + 3

struct SLayout {
  int ldS;
  size_t goutT, ginT, candA, candB, stS, stG, stA, stQ, qsucc, dirty, asg_a,
      asg_p, asg_b, thr, gv, gj, fo, free0, free1, used, flag, end;
};

__host__ __device__ inline SLayout slayout(int n, int m) {
  using rt::align16z;
  SLayout L;
  L.ldS = rt::round_up(m, 4);
  const size_t rows_m = 4ull * m * kPer, rows_n = 4ull * n * kPer;
  L.goutT = 0;
  L.ginT = align16z(L.goutT + rows_m);
  L.candA = align16z(L.ginT + rows_m);
  L.candB = align16z(L.candA + rows_n);
  // the chains' double buffers, inside candB
  L.stS = L.candB;
  L.stG = align16z(L.stS + 4ull * kStages * L.ldS);
  L.stA = align16z(L.stG + 4ull * kStages * L.ldS);
  L.stQ = align16z(L.stA + 4ull * kStages * kPer);
  const size_t staged =
      align16z(L.stQ + 4ull * kStages * rt::words(n)) - L.candB;
  L.qsucc = align16z(L.candB + (rows_n > staged ? rows_n : staged));
  L.dirty = align16z(L.qsucc + 4ull * n);    // two flags a row
  L.asg_a = align16z(L.dirty + 2ull * n);
  L.asg_p = align16z(L.asg_a + 4ull * n);
  L.asg_b = align16z(L.asg_p + 4ull * n);
  L.thr = align16z(L.asg_b + 4ull * n);
  L.gv = align16z(L.thr + 4ull * n);
  L.gj = align16z(L.gv + 4ull * n);
  L.fo = align16z(L.gj + 4ull * n);
  L.free0 = align16z(L.fo + 4ull * m);
  L.free1 = align16z(L.free0 + 4ull * kPer);
  L.used = align16z(L.free1 + 4ull * kPer);
  L.flag = align16z(L.used + 4ull * rt::words(m));
  L.end = align16z(L.flag + 4);
  return L;
}

bool staged_fits(int n, int m) {
  return rt::wide(n, m) && rt::lane_words(m) == 1 &&
         slayout(n, m).end <= kSmemMax;
}

// Word w of G's row v in shared memory: the row's 16-byte chunks are
// XOR-swizzled by v & 7, so that the lanes of a sweep, each reading
// chunk q of its own candidate's row v = l + 32 b, fall on distinct banks
// (unswizzled, the 128-byte rows put them all on one).
__device__ __forceinline__ int swz(int v, int w) {
  return (((w >> 2) ^ (v & 7)) << 2) | (w & 3);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait until at most kStages - 2 groups are pending: round i + 1's.
__device__ __forceinline__ void cp_async_wait_next() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Lane l's entries l + 32 b (b < 32) of row i of S (row stride m, any
// memory), loaded at once; 0 past m.
__device__ __forceinline__ void lane_row(const float* S, int i, int m,
                                         int lane, float* sv) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int j = lane + 32 * b;
    sv[b] = j < m ? S[(size_t)i * m + j] : 0.0f;
  }
}

// Stage round i's operands of a chain into buffer b (one warp).
template <bool GUMBEL, bool AVAIL>
__device__ __forceinline__ void stage_row(const SLayout& L, uint8_t* sm,
                                          const float* S, const float* gum,
                                          const uint32_t* availT,
                                          const uint32_t* qcol, int i, int b,
                                          int m, int Wn, int lane) {
  float* ds = reinterpret_cast<float*>(sm + L.stS) + b * L.ldS;
  for (int j = lane; j < m; j += 32) cp_async4(ds + j, S + (size_t)i * m + j);
  if (GUMBEL) {
    float* dg = reinterpret_cast<float*>(sm + L.stG) + b * L.ldS;
    for (int j = lane; j < m; j += 32)
      cp_async4(dg + j, gum + (size_t)i * m + j);
  }
  if (AVAIL)
    cp_async4(reinterpret_cast<uint32_t*>(sm + L.stA) + b * kPer + lane,
              availT + (size_t)i * kPer + lane);
  uint32_t* dq = reinterpret_cast<uint32_t*>(sm + L.stQ) + b * Wn;
  for (int w = lane; w < Wn; w += 32) cp_async4(dq + w, qcol + i * Wn + w);
  cp_async_commit();
}

// wstructured with one plane a lane, run by one warp, G's planes in
// shared memory and rounds i + 1 .. i + kStages - 1's operands staged
// (a ring of kStages buffers, one cp.async group a round) while round i
// runs.
// availT: the initial candidates, in device memory (AVAIL: staged) or
// shared memory; S (and gum) the particle's rows in device memory; fo
// (m counts) and freeT (32 words) scratch. Writes asg[i] (-1: none).
template <bool GUMBEL, bool AVAIL>
__device__ void chain_structured(const SLayout& L, uint8_t* sm,
                                 const WCtx& c, const uint32_t* availT,
                                 const float* S, const float* gum, float tau,
                                 int* fo, uint32_t* freeT, int* asg) {
  const int lane = threadIdx.x & 31, n = c.n, m = c.m, Wn = c.Wn;
  const int* qsucc = reinterpret_cast<const int*>(sm + L.qsucc);
  freeT[lane] = rt::wall_cols(lane, 0, m);
  for (int j = lane; j < m; j += 32) fo[j] = c.fo0[j];
  for (int i = lane; i < n; i += 32) asg[i] = -1;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stage_row<GUMBEL, AVAIL>(L, sm, S, gum, availT, c.qcol, s, s, m, Wn,
                               lane);
    else
      cp_async_commit();
  }
  cp_async_wait_next();
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const int b = i % kStages, ahead = i + kStages - 1;
    if (ahead < n)
      stage_row<GUMBEL, AVAIL>(L, sm, S, gum, availT, c.qcol, ahead,
                               ahead % kStages, m, Wn, lane);
    else
      cp_async_commit();
    const float* srow = reinterpret_cast<const float*>(sm + L.stS) + b * L.ldS;
    const float* grow = reinterpret_cast<const float*>(sm + L.stG) + b * L.ldS;
    const uint32_t* preds = reinterpret_cast<const uint32_t*>(sm + L.stQ) +
                            b * Wn;
    uint32_t cand = (AVAIL ? reinterpret_cast<const uint32_t*>(
                                 sm + L.stA)[b * kPer + lane]
                           : availT[i * kPer + lane]) &
                    freeT[lane];
    // every predecessor placed, and adjacent to the column
    for (int wu = 0; wu < Wn; ++wu) {
      uint32_t pr = preds[wu];
      while (pr) {
        const int u = wu * 32 + __ffs(pr) - 1;
        pr &= pr - 1;
        const int a = asg[u];
        cand &= a >= 0 ? c.goutT[a * kPer + swz(a, lane)] : 0u;
      }
    }
    const int need = qsucc[i];
    float v = rt::kNeg;
    int vi = INT32_MAX;
    while (cand) {                   // the lane's columns, ascending
      const int k = __ffs(cand) - 1;
      cand &= cand - 1;
      const int j = lane + 32 * k;
      const int free_out = fo[j];
      float s = srow[j];
      if (GUMBEL) s = logf(fmaxf(s, 1e-9f)) + tau * grow[j];
      if (free_out >= need && s > v) { v = s; vi = j; }
    }
    rt::warp_argmax(v, vi);
    if (v > rt::kNeg) {
      if (lane == 0) asg[i] = vi;
      if (lane == (vi & 31)) freeT[lane] &= ~(1u << (vi >> 5));
      // vi's in-neighbours lose a free out-neighbour
      uint32_t in = c.ginT[vi * kPer + swz(vi, lane)];
      while (in) {
        fo[lane + 32 * (__ffs(in) - 1)] -= 1;
        in &= in - 1;
      }
    }
    cp_async_wait_next();
    __syncwarp();
  }
  cp_async_wait_all();
}

// rt::wgreedy with one plane a lane, a rescanned row's loads issued at
// once.
__device__ void chain_greedy(const float* S, int n, int m,
                             const uint32_t* maskT, float* gv, int* gj,
                             uint32_t* freeT, int* asg) {
  const int lane = threadIdx.x & 31;
  freeT[lane] = rt::wall_cols(lane, 0, m);
  for (int i = lane; i < n; i += 32) asg[i] = -1;
  __syncwarp();
  for (int round = 0; round < n; ++round) {
    float v = rt::kNeg;
    int row = INT32_MAX;
    for (int i = lane; i < n; i += 32)
      if (gv[i] > v) { v = gv[i]; row = i; }
    rt::warp_argmax(v, row);
    if (!(v > rt::kNeg)) break;      // nothing left: every later round too
    const int col = gj[row];
    __syncwarp();
    if (lane == 0) {
      asg[row] = col;
      gv[row] = rt::kNeg;
      gj[row] = INT32_MAX;
    }
    if (lane == (col & 31)) freeT[lane] &= ~(1u << (col >> 5));
    __syncwarp();
    // rescan the rows whose cached column was just taken
    for (int i0 = 0; i0 < n; i0 += 32) {
      uint32_t stale = __ballot_sync(
          0xffffffffu, i0 + lane < n && gj[i0 + lane] == col);
      while (stale) {
        const int i = i0 + __ffs(stale) - 1;
        stale &= stale - 1;
        float sv[32];
        lane_row(S, i, m, lane, sv);
        const uint32_t ok = maskT[(size_t)i * kPer + lane] & freeT[lane];
        float bv = rt::kNeg;
        int bj = INT32_MAX;
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if (((ok >> k) & 1u) && sv[k] > bv) { bv = sv[k]; bj = lane + 32 * k; }
        rt::warp_argmax(bv, bj);
        if (lane == 0) {
          gv[i] = bv;
          gj[i] = bj;
        }
      }
    }
    __syncwarp();
  }
}

// rt::wsweep (one plane a lane) by scatter: NT = MT, then each dirty row
// u's supports, built by its warp, ANDed into NT's rows of u's Q
// neighbours; the rows that changed are marked in next_dirty. Returns
// whether any did (every thread). Ends with a barrier; NT then holds the
// candidates.
__device__ bool sweep_scatter(const uint32_t* goutT, const uint32_t* ginT,
                              const uint32_t* qrow, const uint32_t* qcol,
                              int n, int Wn, const uint32_t* MT,
                              uint32_t* NT, const uint8_t* dirty,
                              uint8_t* next_dirty, int t, int nt) {
  const int lane = t & 31;
  for (int idx = t; idx < n * kPer; idx += nt) NT[idx] = MT[idx];
  for (int i = t; i < n; i += nt) next_dirty[i] = 0;
  __syncthreads();
  for (int u = t >> 5; u < n; u += nt >> 5) {
    if (!dirty[u]) continue;
    // lane l ORs the G rows of its candidates l + 32 b, every word
    uint32_t so[kPer], si[kPer];
#pragma unroll
    for (int w = 0; w < kPer; ++w) { so[w] = 0u; si[w] = 0u; }
    uint32_t mine = MT[u * kPer + lane];
    while (mine) {
      const int v = lane + 32 * (__ffs(mine) - 1);
      mine &= mine - 1;
      const uint4* gi = reinterpret_cast<const uint4*>(ginT + v * kPer);
      const uint4* go = reinterpret_cast<const uint4*>(goutT + v * kPer);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const uint4 a = gi[q ^ (v & 7)], b = go[q ^ (v & 7)];
        so[4 * q] |= a.x;
        so[4 * q + 1] |= a.y;
        so[4 * q + 2] |= a.z;
        so[4 * q + 3] |= a.w;
        si[4 * q] |= b.x;
        si[4 * q + 1] |= b.y;
        si[4 * q + 2] |= b.z;
        si[4 * q + 3] |= b.w;
      }
    }
    uint32_t my_so = 0u, my_si = 0u;
#pragma unroll
    for (int w = 0; w < kPer; ++w) {
      const uint32_t a = __reduce_or_sync(0xffffffffu, so[w]);
      const uint32_t b = __reduce_or_sync(0xffffffffu, si[w]);
      if (lane == w) { my_so = a; my_si = b; }
    }
    // M[i] &= SO[u] where Q[i, u]; M[i] &= SI[u] where Q[u, i]
    for (int wu = 0; wu < Wn; ++wu) {
      uint32_t ins = qcol[u * Wn + wu];
      while (ins) {
        const int i = wu * 32 + __ffs(ins) - 1;
        ins &= ins - 1;
        atomicAnd(NT + i * kPer + lane, my_so);
      }
      uint32_t outs = qrow[u * Wn + wu];
      while (outs) {
        const int i = wu * 32 + __ffs(outs) - 1;
        outs &= outs - 1;
        atomicAnd(NT + i * kPer + lane, my_si);
      }
    }
  }
  __syncthreads();
  bool changed = false;
  for (int idx = t; idx < n * kPer; idx += nt) {
    if (NT[idx] != MT[idx]) {
      next_dirty[idx / kPer] = 1;
      changed = true;
    }
  }
  return __syncthreads_or(changed) != 0;
}

// wfeasible on G's swizzled rows (one plane a lane).
__device__ bool feasible_staged(const WCtx& c, const int* asg,
                                uint32_t* used) {
  const int lane = threadIdx.x & 31, n = c.n;
  for (int k = lane; k < rt::words(c.m); k += 32) used[k] = 0u;
  __syncwarp();
  bool ok = true;
  for (int i = lane; i < n; i += 32) {
    const int a = asg[i];
    if (a < 0) { ok = false; continue; }
    const uint32_t bit = 1u << (a & 31);
    if (atomicOr(&used[a >> 5], bit) & bit) ok = false;
  }
  if (!__all_sync(0xffffffffu, ok)) return false;
  for (int i = lane; i < n; i += 32) {
    const int a = asg[i];
    const uint32_t* ga = c.goutT + (size_t)a * kPer;
    for (int wu = 0; wu < c.Wn; ++wu) {
      uint32_t succ = c.qrow[i * c.Wn + wu];
      while (succ) {
        const int b = asg[wu * 32 + __ffs(succ) - 1];
        succ &= succ - 1;
        if (!((ga[swz(a, b & 31)] >> (b >> 5)) & 1u)) ok = false;
      }
    }
  }
  return __all_sync(0xffffffffu, ok);
}

// Launch 2 of the staged path: one particle (blockIdx.x) of one problem
// (blockIdx.y); the record as prep_wide_kernel packs it.
__global__ void __launch_bounds__(kThreads, 1)
finish_staged_kernel(const float* __restrict__ S_,
                     const float* __restrict__ gum,
                     const uint8_t* __restrict__ rec,
                     uint8_t* __restrict__ M_hat,
                     uint8_t* __restrict__ feas_out, int N, int n, int m,
                     float gumbel_tau, float refine_threshold,
                     int refine_iters) {
  const int p = blockIdx.y, part = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nt = blockDim.x;
  const int nwarps = nt >> 5;
  const WLayout R = wlayout(n, m);
  const SLayout L = slayout(n, m);
  const size_t nm = (size_t)n * m, cta = (size_t)p * N + part;
  const size_t base = cta * nm;
  extern __shared__ __align__(16) uint8_t sm[];
  const uint8_t* rp = rec + (size_t)p * R.rec;
  {
    const uint4* go = reinterpret_cast<const uint4*>(rp + R.goutT);
    const uint4* gi = reinterpret_cast<const uint4*>(rp + R.ginT);
    uint4* so = reinterpret_cast<uint4*>(sm + L.goutT);
    uint4* si = reinterpret_cast<uint4*>(sm + L.ginT);
    for (int x = tid; x < m * kPer / 4; x += nt) {
      const int v = x / (kPer / 4), q = x % (kPer / 4);
      const int y = v * (kPer / 4) + (q ^ (v & 7));
      so[y] = go[x];
      si[y] = gi[x];
    }
  }
  int* qsucc = reinterpret_cast<int*>(sm + L.qsucc);
  for (int i = tid; i < n; i += nt)
    qsucc[i] = reinterpret_cast<const int*>(rp + R.qsucc)[i];
  __syncthreads();
  const float* S = S_ + base;
  WCtx c;
  c.goutT = reinterpret_cast<const uint32_t*>(sm + L.goutT);
  c.ginT = reinterpret_cast<const uint32_t*>(sm + L.ginT);
  c.qrow = reinterpret_cast<const uint32_t*>(rp + R.qrow);
  c.qcol = reinterpret_cast<const uint32_t*>(rp + R.qcol);
  c.qsucc = qsucc;
  c.fo0 = reinterpret_cast<const int*>(rp + R.fo0);
  c.S = S;
  c.n = n;
  c.m = m;
  c.Wn = R.Wn;
  c.LW = 1;
  c.per = kPer;
  const uint32_t* maskT = reinterpret_cast<const uint32_t*>(rp + R.maskT);
  uint32_t* candA = reinterpret_cast<uint32_t*>(sm + L.candA);
  uint32_t* candB = reinterpret_cast<uint32_t*>(sm + L.candB);
  uint8_t* dirty = sm + L.dirty;
  int* asg_a = reinterpret_cast<int*>(sm + L.asg_a);
  int* asg_p = reinterpret_cast<int*>(sm + L.asg_p);
  int* asg_b = reinterpret_cast<int*>(sm + L.asg_b);
  float* thr = reinterpret_cast<float*>(sm + L.thr);
  float* gv = reinterpret_cast<float*>(sm + L.gv);
  int* gj = reinterpret_cast<int*>(sm + L.gj);
  int* fo = reinterpret_cast<int*>(sm + L.fo);
  uint32_t* free0 = reinterpret_cast<uint32_t*>(sm + L.free0);
  uint32_t* free1 = reinterpret_cast<uint32_t*>(sm + L.free1);
  uint32_t* used = reinterpret_cast<uint32_t*>(sm + L.used);
  int* take_a = reinterpret_cast<int*>(sm + L.flag);

  // each row once, a warp a row: its maximum (the candidate threshold) and
  // its best masked column (the greedy cache)
  for (int i = warp; i < n; i += nwarps) {
    float sv[32];
    lane_row(S, i, m, lane, sv);
    const uint32_t mk = maskT[(size_t)i * kPer + lane];
    float mx = rt::kNeg, v = rt::kNeg;
    int vi = INT32_MAX;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int j = lane + 32 * k;
      if (j < m) {
        mx = fmaxf(mx, sv[k]);
        if (((mk >> k) & 1u) && sv[k] > v) { v = sv[k]; vi = j; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    rt::warp_argmax(v, vi);
    if (lane == 0) {
      thr[i] = refine_threshold * mx;
      gv[i] = v;
      gj[i] = vi;
    }
  }
  __syncthreads();

  // M_a (warp 0, then its feasibility) beside the greedy projection (warp 1)
  bool feas_a = false;
  if (warp == 0) {
    const float* g = gum == nullptr ? nullptr : gum + base;
    if (gumbel_tau > 0.0f)
      chain_structured<true, true>(L, sm, c, maskT, S, g, gumbel_tau, fo,
                                   free0, asg_a);
    else
      chain_structured<false, true>(L, sm, c, maskT, S, nullptr, 0.0f, fo,
                                    free0, asg_a);
    feas_a = feasible_staged(c, asg_a, used);
  } else if (warp == 1) {
    chain_greedy(S, n, m, maskT, gv, gj, free1, asg_p);
  }
  __syncthreads();

  // candidate set S >= thr * rowmax or the greedy pick, masked, a warp a row
  for (int i = warp; i < n; i += nwarps) {
    float sv[32];
    lane_row(S, i, m, lane, sv);
    const float t = thr[i];
    const int pick = asg_p[i];
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int j = lane + 32 * k;
      if (j < m && (sv[k] >= t || pick == j)) word |= 1u << k;
    }
    const size_t q = (size_t)i * kPer + lane;
    candA[q] = maskT[q] & word;
  }
  for (int i = tid; i < n; i += nt) dirty[i] = 1;
  __syncthreads();
  uint32_t* cur = candA;
  uint32_t* nxt = candB;
  for (int it = 0; it < refine_iters; ++it) {
    uint8_t* d = dirty + (it & 1) * n;
    const bool changed =
        sweep_scatter(c.goutT, c.ginT, c.qrow, c.qcol, n, c.Wn, cur, nxt, d,
                      dirty + n - (it & 1) * n, tid, nt);
    uint32_t* x = cur;
    cur = nxt;
    nxt = x;
    if (!changed) break;                   // a fixpoint: later sweeps too
  }
  if (cur != candA) {          // the chains' buffers live in candB
    for (int idx = tid; idx < n * kPer; idx += nt) candA[idx] = cur[idx];
    __syncthreads();
  }

  // M_b, the fallback to M_proj on empty rows, its feasibility; the merge
  if (warp == 0) {
    chain_structured<false, false>(L, sm, c, candA, S, nullptr, 0.0f, fo,
                                   free0, asg_b);
    for (int i = lane; i < n; i += 32) {
      uint32_t any = 0;
      for (int q = 0; q < kPer; ++q) any |= candA[(size_t)i * kPer + q];
      if (any == 0) asg_b[i] = asg_p[i];
    }
    __syncwarp();
    const bool feas_b = feasible_staged(c, asg_b, used);
    if (lane == 0) {
      feas_out[cta] = feas_a || feas_b;
      *take_a = feas_a;
    }
  }
  __syncthreads();
  const int* asg = *take_a ? asg_a : asg_b;
  uint8_t* out = M_hat + base;
  for (size_t idx = tid; idx < nm; idx += nt) {
    const int i = (int)(idx / m);
    out[idx] = asg[i] == (int)(idx - (size_t)i * m) ? 1 : 0;
  }
}

}  // namespace

// Bytes of device scratch that epoch_finish needs for these shapes: the
// records, and on the wide path, where a particle's working planes pass
// a block's shared memory, one slice of them per CTA.
extern "C" long long epoch_finish_scratch_bytes(int P, int N, int n, int m) {
  if (!rt::wide(n, m)) return (long long)P * layout(n, m).rec;
  const WLayout L = wlayout(n, m);
  const bool work = !(wplace(n, m).bits & 1) && !staged_fits(n, m);
  return (long long)(P * L.rec + (work ? (size_t)P * N * L.work : 0));
}

// The particle kernel's instantiation at (n, m): 0 finish_kernel, 1
// finish_staged_kernel, 2 finish_wide_kernel.
extern "C" int epoch_finish_path(int n, int m) {
  if (!rt::wide(n, m)) return 0;
  return staged_fits(n, m) ? 1 : 2;
}

// The epoch tail of P problems: one launch for the records and S_bar, one
// for the particles. S, f_final, gum (or null when gumbel_tau == 0) are
// float32; mask, Q, G are uint8 0/1; scratch holds
// epoch_finish_scratch_bytes bytes.
extern "C" int epoch_finish(const void* S, const void* f_final,
                            const void* gum, const void* mask, const void* Q,
                            const void* G, void* M_hat, void* feasible_out,
                            void* S_bar, void* scratch, int P, int N, int n,
                            int m, float gumbel_tau, float refine_threshold,
                            int refine_iters, int elite_k,
                            float consensus_temp, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int slices = (n * m + kSliceEntries - 1) / kSliceEntries;
  if (rt::wide(n, m)) {
    const size_t psmem = sizeof(float) * (size_t)(N + 2 * elite_k + 32);
    cudaError_t err = rt::allow_smem((const void*)prep_wide_kernel, psmem);
    if (err != cudaSuccess) return (int)err;
    prep_wide_kernel<<<dim3(kPackCtas + slices, P), kThreads, psmem, st>>>(
        (const uint8_t*)mask, (const uint8_t*)Q, (const uint8_t*)G,
        (uint8_t*)scratch, (const float*)S, (const float*)f_final,
        (float*)S_bar, N, n, m, elite_k, consensus_temp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (staged_fits(n, m)) {
      const size_t smem = slayout(n, m).end;
      err = rt::allow_smem((const void*)finish_staged_kernel, smem);
      if (err != cudaSuccess) return (int)err;
      finish_staged_kernel<<<dim3(N, P), kThreads, smem, st>>>(
          (const float*)S, (const float*)gum, (const uint8_t*)scratch,
          (uint8_t*)M_hat, (uint8_t*)feasible_out, N, n, m, gumbel_tau,
          refine_threshold, refine_iters);
      return (int)cudaGetLastError();
    }
    const WLayout L = wlayout(n, m);
    const WPlace w = wplace(n, m);
    err = rt::allow_smem((const void*)finish_wide_kernel, w.smem);
    if (err != cudaSuccess) return (int)err;
    finish_wide_kernel<<<dim3(N, P), kThreads, w.smem, st>>>(
        (const float*)S, (const float*)gum, (const uint8_t*)scratch,
        (uint8_t*)scratch + (size_t)P * L.rec, (uint8_t*)M_hat,
        (uint8_t*)feasible_out, N, n, m, gumbel_tau, refine_threshold,
        refine_iters, w.bits);
    return (int)cudaGetLastError();
  }
  const size_t psmem = prep_smem(N, n, m, elite_k);
  cudaError_t err = rt::allow_smem((const void*)prep_kernel, psmem);
  if (err != cudaSuccess) return (int)err;
  prep_kernel<<<dim3(kPackCtas + slices, P), kThreads, psmem, st>>>(
      (const uint8_t*)mask, (const uint8_t*)Q, (const uint8_t*)G,
      (uint8_t*)scratch, (const float*)S, (const float*)f_final,
      (float*)S_bar, N, n, m, elite_k, consensus_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Layout L = layout(n, m);
  const bool in_smem = s_in_smem(n, m);
  const size_t smem = (size_t)L.s + (in_smem ? 4 * (size_t)n * m : 0);
  const void* kern = in_smem ? (const void*)finish_kernel<true>
                             : (const void*)finish_kernel<false>;
  err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
#define FINISH(SB)                                                         \
  finish_kernel<SB><<<dim3(N, P), kThreads, smem, st>>>(                   \
      (const float*)S, (const float*)gum, (const uint8_t*)scratch,         \
      (uint8_t*)M_hat, (uint8_t*)feasible_out, N, n, m, gumbel_tau,        \
      refine_threshold, refine_iters)
  if (in_smem)
    FINISH(true);
  else
    FINISH(false);
#undef FINISH
  return (int)cudaGetLastError();
}
