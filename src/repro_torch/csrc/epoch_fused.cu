// The swarm epoch: K inner PSO steps for every problem of a batch.
//
// Replaces the TPU kernel epoch_fused_pallas (src/repro/kernels/
// epoch_fused.py, body _epoch_kernel). Each step: velocity update and
// clip, mask, row normalisation by true division with a uniform fallback,
// an optional Q1.15 requantize, fitness, the local bests, and the global
// best of each problem. Outputs S_final, S*, f*, the f* trace and f_last.
//
// Bound on the H100: the global best S* couples every particle of a
// problem at every step, so step k+1 cannot start before step k has
// finished on all N particles, and a grid of P*N particle CTAs cannot all
// be resident for a barrier across them. So each inner step is one launch
// of a (N, P) grid, one CTA per particle, and the kernel boundary is the
// barrier. The last CTA of a problem to finish (an atomic ticket) selects
// the problem's global best. Particle state stays in device memory (L2
// holds much of a burst's ~50 MB); a step moves S, V and S_local (~83 MB
// for the main path's burst), ~25 us at the card's memory rate.
//
// Design, against what a per-phase timing of the earlier one-launch-pair
// design showed (PERF.md):
//  * per-problem operands (G's column bits, the mask's bits and row counts,
//    Q's bits) are built once per call by prologue_kernel into device
//    scratch; a step CTA copies its problem's few KB with 16-byte loads;
//  * the quantized tile is bytes, S G is 16-bit words (<= 255 m) and
//    S G S^T runs on __dp2a over a 4 x 4 block of (i, u) pairs per thread:
//    ~51 KB of shared memory at (56, 144), 4 CTAs an SM, one wave;
//  * the float S G S^T is register-blocked 4 x 4 with 16-byte shared
//    loads, every sum still over j ascending; the squared residuals wait in
//    registers and then reuse S G's space: ~73 KB, 3 CTAs an SM;
//  * S G walks each column's bits once for 8 rows;
//  * the velocity pass uses 16-byte global loads where m % 4 == 0.
// Where the tiles do not fit in shared memory they live in a slice of the
// scratch per CTA (SMEM = false). Any n, m run on these kernels (the
// S G words stay below 2^16 and S G S^T below 2^32 since S's rows are
// normalised); where the record passes a block's shared memory (~420 KB
// at (1000, 1100)) step_wide_kernel reads it from the scratch in place.
//
// Past n, m = 256, where a cluster of CTAs holds the tiles, each step is
// cluster_step_kernel instead (see "The cluster path" below).
//
// Numerics: -fmad=false and the plain version's order of operations
// (left-to-right float sums, IEEE division, rintf for round-half-even,
// exact integer sums) make the kernel agree with kernels/epoch_fused.py's
// plain version bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

struct Hyper {
  float omega, c1, c2, c3, v_max;
};

constexpr int kThreads = 256;
using rt::kSmemMax;

using rt::align16;
using rt::odd_chunks;
using rt::round_up;

// Byte offsets of the parts of one problem's record (prologue_kernel) and
// of one CTA's shared and tile memory.
struct Layout {
  int W, Wn, n4, ldf, ldh, ldb, ldn;
  int gbits, mbits, mrows, qbits, rec;    // record: G cols, mask, counts, Q
  int parts, rowf, rowi, rowr, misc, lut, small;   // shared, after the record
  int sq, st, sg, r2, tiles;              // tiles (shared or scratch)
  bool r2_alias;
};

__host__ __device__ inline Layout layout(int n, int m, bool quant) {
  Layout L;
  L.W = rt::words(m);
  L.Wn = rt::words(n);
  L.n4 = round_up(n, 4);
  L.ldf = odd_chunks(m, 4);     // floats
  L.ldh = odd_chunks(m, 8);     // 16-bit words
  L.ldb = odd_chunks(m, 8);     // bytes
  L.ldn = rt::odd_stride(n);    // floats
  L.gbits = 0;
  L.mbits = align16(L.gbits + 4 * m * L.W);
  L.mrows = align16(L.mbits + 4 * n * L.W);
  L.qbits = align16(L.mrows + 4 * n);
  L.rec = align16(L.qbits + 4 * n * L.Wn);
  L.parts = L.rec;
  L.rowf = L.parts + 8 * 32;
  L.rowi = L.rowf + 4 * L.n4;
  L.rowr = L.rowi + 4 * L.n4;
  L.misc = L.rowr + 4 * L.n4;
  L.lut = L.misc + 16;
  L.small = L.lut + (quant ? 4 * 256 : 0);
  const int B = (n + 3) / 4;
  L.r2_alias = B * B <= kThreads;
  const int r2_bytes = 4 * n * L.ldn;
  if (quant) {
    L.sq = 0;
    L.st = align16(n * L.ldb);
    L.sg = L.st;                          // S G (16-bit) reuses S's tile
    L.r2 = L.st;                          // unused
    const int t = 4 * n * L.ldf > 2 * n * L.ldh ? 4 * n * L.ldf
                                                : 2 * n * L.ldh;
    L.tiles = align16(L.st + t);
  } else {
    L.sq = 0;                             // unused
    L.st = 0;
    L.sg = align16(4 * n * L.ldf);
    const int sg_bytes = L.r2_alias && r2_bytes > 4 * n * L.ldf
                             ? r2_bytes : 4 * n * L.ldf;
    L.r2 = L.r2_alias ? L.sg : align16(L.sg + sg_bytes);
    L.tiles = align16(L.r2_alias ? L.sg + sg_bytes : L.r2 + r2_bytes);
  }
  return L;
}

// Whether the record fits in shared memory beside the small part: it
// does for every n, m <= kMaxDim; past that the wide step reads it in
// place.
bool rec_in_smem(const Layout& L) { return (size_t)L.small <= kSmemMax; }

// Shared bytes before the tiles.
size_t small_bytes(const Layout& L) {
  return rec_in_smem(L) ? L.small : L.small - L.rec;
}

bool tiles_in_smem(const Layout& L) {
  return small_bytes(L) + L.tiles <= kSmemMax;
}

// One problem's operands, once per call: G's column bits, the mask's row
// bits and row counts, Q's row bits; and the problem's ticket set to 0.
__global__ void prologue_kernel(const uint8_t* __restrict__ mask,
                                const uint8_t* __restrict__ Q,
                                const uint8_t* __restrict__ G,
                                uint8_t* __restrict__ rec,
                                int* __restrict__ tickets, int n, int m) {
  const int p = blockIdx.x;
  const Layout L = layout(n, m, false);
  uint8_t* r = rec + (size_t)p * L.rec;
  const uint8_t* mk = mask + (size_t)p * n * m;
  rt::pack_cols(G + (size_t)p * m * m, m,
                reinterpret_cast<uint32_t*>(r + L.gbits));
  rt::pack_rows(mk, n, m, reinterpret_cast<uint32_t*>(r + L.mbits));
  rt::pack_rows(Q + (size_t)p * n * n, n, n,
                reinterpret_cast<uint32_t*>(r + L.qbits));
  float* mrows = reinterpret_cast<float*>(r + L.mrows);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int c = 0;
    for (int j = 0; j < m; ++j) c += mk[i * m + j] != 0;
    mrows[i] = (float)c;
  }
  if (threadIdx.x == 0) tickets[p] = 0;
}

// ref.pso_update's velocity and position of one entry, same op order.
__device__ __forceinline__ float velocity(const Hyper& h, float a1, float a2,
                                          float a3, float s, float v0,
                                          float sl, float ss, float sb) {
  float v = h.omega * v0;
  v = v + a1 * (sl - s);
  v = v + a2 * (ss - s);
  v = v + a3 * (sb - s);
  return fminf(fmaxf(v, -h.v_max), h.v_max);
}

__device__ __forceinline__ uint32_t quantize(float s) {   // ref.quantize_s
  return (uint32_t)fminf(fmaxf(rintf(s * 255.0f), 0.0f), 255.0f);
}

// ref.pso_update's row normalisation of one entry: true division by the
// row sum, or the row's uniform share of its candidates for an empty row.
__device__ __forceinline__ float normalized(float x, float rs, bool keep,
                                            float mrow) {
  return rs > 1e-9f ? x / fmaxf(rs, 1e-9f)
                    : (float)keep / fmaxf(mrow, 1.0f);
}

// ref.row_normalize_quantized of one byte q, given its row's byte sum and
// that sum's Q1.15 reciprocal (mrow: the row's candidate count).
__device__ __forceinline__ uint32_t requantize(uint32_t q, bool keep, int row,
                                               int recip, int mrow) {
  if (!keep) return 0;
  if (row > 0) {
    const int prod = (int)q * recip * 255;
    return min(max((prod + (1 << 14)) >> 15, 0), 255);
  }
  return min(max(255 / max(mrow, 1), 1), 255);
}

__device__ __forceinline__ void keep_better(float& v, int& vi, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < vi)) { v = ov; vi = oi; }
}

// One inner step of one particle (blockIdx.x) of one problem (blockIdx.y);
// the problem's last CTA also selects its global best. With REC the
// problem's record is copied into shared memory; without (the wide path,
// where it does not fit) it is read from the scratch in place and the
// shared part starts at the partial sums.
template <bool QUANT, bool SMEM, bool REC>
__device__ __forceinline__ void step_body(
    float* __restrict__ S, float* __restrict__ V, float* __restrict__ Sl,
    float* __restrict__ fl, float* __restrict__ fcur,
    float* __restrict__ Sstar, float* __restrict__ fstar,
    float* __restrict__ trace, const float* __restrict__ Sbar,
    const uint8_t* __restrict__ rec, int* __restrict__ tickets,
    uint8_t* __restrict__ gtiles, const float* __restrict__ r_all, int N,
    int n, int m, int K, int k, Hyper h) {
  const int p = blockIdx.y, part = blockIdx.x, tid = threadIdx.x;
  const int nt = blockDim.x, nm = n * m;
  const Layout L = layout(n, m, QUANT);
  const int W = L.W, ldf = L.ldf, ldh = L.ldh, ldb = L.ldb;
  const int off = REC ? 0 : L.rec;       // the record's bytes, if not here
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tiles = SMEM ? smem + L.small - off
                        : gtiles + ((size_t)p * N + part) * L.tiles;
  const uint8_t* rp = REC ? smem : rec + (size_t)p * L.rec;
  const uint32_t* Gin = reinterpret_cast<const uint32_t*>(rp + L.gbits);
  const uint32_t* mbits = reinterpret_cast<const uint32_t*>(rp + L.mbits);
  const float* mrows = reinterpret_cast<const float*>(rp + L.mrows);
  const uint32_t* qbits = reinterpret_cast<const uint32_t*>(rp + L.qbits);
  long long* part_sums = reinterpret_cast<long long*>(smem + L.parts - off);
  float* rowf = reinterpret_cast<float*>(smem + L.rowf - off);
  int* rowi = reinterpret_cast<int*>(smem + L.rowi - off);
  int* rowr = reinterpret_cast<int*>(smem + L.rowr - off);
  int* misc = reinterpret_cast<int*>(smem + L.misc - off);
  float* lut = reinterpret_cast<float*>(smem + L.lut - off);
  uint8_t* Sq = tiles + L.sq;
  float* St = reinterpret_cast<float*>(tiles + L.st);
  // this particle's f_local, read before thread 0 can rewrite it
  const size_t pi = (size_t)p * N + part;
  const float f_old = fl[pi];

  // the problem's record, then the zero columns past m that the 16-byte
  // (8-byte) product loops read
  if (REC) {
    const uint4* src =
        reinterpret_cast<const uint4*>(rec + (size_t)p * L.rec);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int w = tid; w < L.rec / 16; w += nt) dst[w] = src[w];
  }
  if (QUANT) {
    for (int t = tid; t < 256; t += nt) lut[t] = (float)t / 255.0f;
    const int pad = round_up(m, 8) - m;
    for (int idx = tid; idx < n * pad; idx += nt)
      Sq[idx / pad * ldb + m + idx % pad] = 0;
  } else {
    const int pad = round_up(m, 4) - m;
    for (int idx = tid; idx < n * pad; idx += nt)
      St[idx / pad * ldf + m + idx % pad] = 0.0f;
  }
  __syncthreads();

  // velocity, clip, position, mask (ref.pso_update, same op order)
  const size_t pb = (size_t)p * nm;
  const size_t base = ((size_t)p * N + part) * nm;
  const float* r = r_all + (((size_t)p * K + k) * N + part) * 3;
  const float a1 = h.c1 * r[0], a2 = h.c2 * r[1], a3 = h.c3 * r[2];
  // 16-byte groups of four entries of a row where m % 4 == 0
  const bool vec = (m & 3) == 0;
  const int gpr = m >> 2;
  if (vec) {
    for (int g = tid; g < nm >> 2; g += nt) {
      const int i = g / gpr, j = (g - i * gpr) << 2;
      const float4 s = reinterpret_cast<const float4*>(S + base)[g];
      const float4 v = reinterpret_cast<const float4*>(V + base)[g];
      const float4 sl = reinterpret_cast<const float4*>(Sl + base)[g];
      const float4 ss = reinterpret_cast<const float4*>(Sstar + pb)[g];
      const float4 sb = reinterpret_cast<const float4*>(Sbar + pb)[g];
      const uint32_t mb = mbits[i * W + (j >> 5)] >> (j & 31);
      float4 vn, st;
      vn.x = velocity(h, a1, a2, a3, s.x, v.x, sl.x, ss.x, sb.x);
      vn.y = velocity(h, a1, a2, a3, s.y, v.y, sl.y, ss.y, sb.y);
      vn.z = velocity(h, a1, a2, a3, s.z, v.z, sl.z, ss.z, sb.z);
      vn.w = velocity(h, a1, a2, a3, s.w, v.w, sl.w, ss.w, sb.w);
      st.x = fmaxf(s.x + vn.x, 0.0f) * (float)(mb & 1u);
      st.y = fmaxf(s.y + vn.y, 0.0f) * (float)((mb >> 1) & 1u);
      st.z = fmaxf(s.z + vn.z, 0.0f) * (float)((mb >> 2) & 1u);
      st.w = fmaxf(s.w + vn.w, 0.0f) * (float)((mb >> 3) & 1u);
      reinterpret_cast<float4*>(V + base)[g] = vn;
      *reinterpret_cast<float4*>(St + i * ldf + j) = st;
    }
  } else {
    for (int idx = tid; idx < nm; idx += nt) {
      const int i = idx / m, j = idx - i * m;
      const float s = S[base + idx];
      const float v = velocity(h, a1, a2, a3, s, V[base + idx],
                               Sl[base + idx], Sstar[pb + idx],
                               Sbar[pb + idx]);
      V[base + idx] = v;
      St[i * ldf + j] =
          fmaxf(s + v, 0.0f) * (float)rt::test_bit(mbits + i * W, j);
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const float* row = St + i * ldf;
    float acc = 0.0f;
    int j = 0;
    for (; j + 4 <= m; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + j);
      acc = acc + x.x;
      acc = acc + x.y;
      acc = acc + x.z;
      acc = acc + x.w;
    }
    for (; j < m; ++j) acc = acc + row[j];
    rowf[i] = acc;
  }
  __syncthreads();
  // normalise (uniform fallback for an empty row); the float path writes S
  if (vec) {
    for (int g = tid; g < nm >> 2; g += nt) {
      const int i = g / gpr, j = (g - i * gpr) << 2;
      const float rs = rowf[i], mr = mrows[i];
      const float4 x = *reinterpret_cast<const float4*>(St + i * ldf + j);
      const uint32_t mb = mbits[i * W + (j >> 5)] >> (j & 31);
      float4 s;
      s.x = normalized(x.x, rs, mb & 1u, mr);
      s.y = normalized(x.y, rs, mb & 2u, mr);
      s.z = normalized(x.z, rs, mb & 4u, mr);
      s.w = normalized(x.w, rs, mb & 8u, mr);
      if (QUANT) {
        *reinterpret_cast<uint32_t*>(Sq + i * ldb + j) =
            quantize(s.x) | quantize(s.y) << 8 | quantize(s.z) << 16 |
            quantize(s.w) << 24;
      } else {
        *reinterpret_cast<float4*>(St + i * ldf + j) = s;
        reinterpret_cast<float4*>(S + base)[g] = s;
      }
    }
  } else {
    for (int idx = tid; idx < nm; idx += nt) {
      const int i = idx / m, j = idx - i * m;
      const float s = normalized(St[i * ldf + j], rowf[i],
                                 rt::test_bit(mbits + i * W, j), mrows[i]);
      if (QUANT) {
        Sq[i * ldb + j] = (uint8_t)quantize(s);
      } else {
        St[i * ldf + j] = s;
        S[base + idx] = s;
      }
    }
  }
  __syncthreads();
  if (QUANT) {
    // straight-through requantize: Q1.15 reciprocal renormalisation,
    // dequantize (lut[t] = t / 255) and the fitness's quantize_s, which
    // gives the same byte back
    for (int i = tid; i < n; i += nt) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(Sq + i * ldb);
      unsigned c = 0;
      for (int w = 0; w < round_up(m, 8) / 4; ++w)
        c = __dp4a(row[w], 0x01010101u, c);
      rowi[i] = (int)c;
      rowr[i] = (int)rintf(32768.0f / (float)max((int)c, 1));
    }
    __syncthreads();
    if (vec) {
      for (int g = tid; g < nm >> 2; g += nt) {
        const int i = g / gpr, j = (g - i * gpr) << 2;
        const int row = rowi[i], recip = rowr[i], mr = (int)mrows[i];
        uint32_t* sq = reinterpret_cast<uint32_t*>(Sq + i * ldb + j);
        const uint32_t w = *sq;
        const uint32_t mb = mbits[i * W + (j >> 5)] >> (j & 31);
        const uint32_t q0 = requantize(w & 0xffu, mb & 1u, row, recip, mr),
                       q1 = requantize((w >> 8) & 0xffu, mb & 2u, row, recip,
                                       mr),
                       q2 = requantize((w >> 16) & 0xffu, mb & 4u, row, recip,
                                       mr),
                       q3 = requantize(w >> 24, mb & 8u, row, recip, mr);
        *sq = q0 | q1 << 8 | q2 << 16 | q3 << 24;
        reinterpret_cast<float4*>(S + base)[g] =
            make_float4(lut[q0], lut[q1], lut[q2], lut[q3]);
      }
    } else {
      for (int idx = tid; idx < nm; idx += nt) {
        const int i = idx / m, j = idx - i * m;
        const uint32_t q =
            requantize(Sq[i * ldb + j], rt::test_bit(mbits + i * W, j),
                       rowi[i], rowr[i], (int)mrows[i]);
        Sq[i * ldb + j] = (uint8_t)q;
        S[base + idx] = lut[q];
      }
    }
    __syncthreads();
  }

  // fitness, S G: each thread walks one column's bits (k ascending) for 8
  // rows; columns past m are written as zeros
  constexpr int R = 8;
  {
    const int cols = QUANT ? round_up(m, 8) : round_up(m, 4);
    const int chunks = (n + R - 1) / R;
    uint16_t* SGh = reinterpret_cast<uint16_t*>(tiles + L.sg);
    float* SGf = reinterpret_cast<float*>(tiles + L.sg);
    for (int it = tid; it < cols * chunks; it += nt) {
      const int c = it / cols, j = it - c * cols, i0 = c * R;
      float accf[R];
      int acci[R];
#pragma unroll
      for (int r = 0; r < R; ++r) { accf[r] = 0.0f; acci[r] = 0; }
      if (j < m) {
        for (int w = 0; w < W; ++w) {
          uint32_t bits = Gin[j * W + w];
          while (bits) {
            const int kk = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (i0 + r < n) {
                if (QUANT)
                  acci[r] += Sq[(i0 + r) * ldb + kk];
                else
                  accf[r] = accf[r] + St[(i0 + r) * ldf + kk];
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r < n) {
          if (QUANT)
            SGh[(i0 + r) * ldh + j] = (uint16_t)acci[r];
          else
            SGf[(i0 + r) * ldf + j] = accf[r];
        }
      }
    }
  }
  __syncthreads();

  // fitness, S G S^T and the residual: thread (bi, bu) owns rows
  // i = bi + B a and u = bu + B b, a, b < 4
  const int B = (n + 3) / 4;
  if (QUANT) {
    const uint16_t* SGh = reinterpret_cast<const uint16_t*>(tiles + L.sg);
    long long local = 0;
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
            const long long q =
                rt::test_bit(qbits + i * L.Wn, u) ? 65025LL : 0LL;
            const long long res = q - (long long)acc[a][b];
            local += res * res;
          }
        }
    }
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if ((tid & 31) == 0) part_sums[tid >> 5] = local;
    __syncthreads();
    if (tid == 0) {
      long long tot = 0;
      for (int w = 0; w < (nt + 31) >> 5; ++w) tot += part_sums[w];
      reinterpret_cast<float*>(misc)[0] =
          -__ll2float_rn(tot) / 4228250625.0f;
    }
  } else {
    const float* SGf = reinterpret_cast<const float*>(tiles + L.sg);
    float* R2 = reinterpret_cast<float*>(tiles + L.r2);
    float r2[4][4];
    for (int it = tid; it < B * B; it += nt) {
      const int bi = it / B, bu = it - bi * B;
      int ir[4], ur[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ir[a] = min(bi + B * a, n - 1);
        ur[a] = min(bu + B * a, n - 1);
      }
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      for (int j = 0; j < m; j += 4) {
        float4 sv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          sv[b] = *reinterpret_cast<const float4*>(St + ur[b] * ldf + j);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 g =
              *reinterpret_cast<const float4*>(SGf + ir[a] * ldf + j);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = acc[a][b] + g.x * sv[b].x;
            acc[a][b] = acc[a][b] + g.y * sv[b].y;
            acc[a][b] = acc[a][b] + g.z * sv[b].z;
            acc[a][b] = acc[a][b] + g.w * sv[b].w;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = bi + B * a, u = bu + B * b;
          const float q = (i < n && u < n &&
                           rt::test_bit(qbits + i * L.Wn, u)) ? 1.0f : 0.0f;
          const float res = q - acc[a][b];
          r2[a][b] = res * res;
          if (!L.r2_alias && i < n && u < n) R2[i * L.ldn + u] = r2[a][b];
        }
    }
    if (L.r2_alias) {      // at most one block a thread: S G is read, reuse it
      __syncthreads();
      if (tid < B * B) {
        const int bi = tid / B, bu = tid - bi * B;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = bi + B * a, u = bu + B * b;
            if (i < n && u < n) R2[i * L.ldn + u] = r2[a][b];
          }
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += nt) {
      float acc = 0.0f;
      for (int u = 0; u < n; ++u) acc = acc + R2[i * L.ldn + u];
      rowf[i] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      float tot = 0.0f;
      for (int i = 0; i < n; ++i) tot = tot + rowf[i];
      reinterpret_cast<float*>(misc)[0] = -tot;
    }
  }
  __syncthreads();
  const float f = reinterpret_cast<const float*>(misc)[0];

  // local best (only this CTA touches its particle's S_local and f_local)
  if (f > f_old) {
    if (vec) {
      for (int g = tid; g < nm >> 2; g += nt) {
        const int i = g / gpr, j = (g - i * gpr) << 2;
        float4 v;
        if (QUANT) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(Sq + i * ldb + j);
          v = make_float4(lut[w & 0xffu], lut[(w >> 8) & 0xffu],
                          lut[(w >> 16) & 0xffu], lut[w >> 24]);
        } else {
          v = *reinterpret_cast<const float4*>(St + i * ldf + j);
        }
        reinterpret_cast<float4*>(Sl + base)[g] = v;
      }
    } else {
      for (int idx = tid; idx < nm; idx += nt) {
        const int i = idx / m, j = idx - i * m;
        Sl[base + idx] = QUANT ? lut[Sq[i * ldb + j]] : St[i * ldf + j];
      }
    }
  }
  if (tid == 0) {
    fl[pi] = fmaxf(f, f_old);
    fcur[pi] = f;
  }
  // the ticket: every write of this CTA is visible before it is taken
  __threadfence();
  __syncthreads();
  if (tid == 0) misc[1] = atomicAdd(tickets + p, 1) == N - 1;
  __syncthreads();
  if (!misc[1]) return;

  // the problem's last CTA: global best = the first argmax of the local
  // bests (read past L1, which may hold other CTAs' stale lines)
  __threadfence();
  if (tid < 32) {
    float v = __int_as_float(0xff800000);   // -inf
    int b = INT32_MAX;
    for (int i = tid; i < N; i += 32) {
      const float x = __ldcg(fl + (size_t)p * N + i);
      if (x > v || b == INT32_MAX) { v = x; b = i; }
    }
    for (int off = 16; off > 0; off >>= 1)
      keep_better(v, b, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, b, off));
    if (tid == 0) {
      const float fs = __ldcg(fstar + p);
      const bool better = v > fs;
      const float nf = better ? v : fs;
      fstar[p] = nf;
      trace[(size_t)p * K + k] = nf;
      misc[2] = better ? b : -1;
      tickets[p] = 0;
    }
  }
  __syncthreads();
  const int best = misc[2];
  if (best >= 0) {
    const float* src = Sl + ((size_t)p * N + best) * nm;
    if (vec) {
      for (int g = tid; g < nm >> 2; g += nt)
        reinterpret_cast<float4*>(Sstar + pb)[g] =
            __ldcg(reinterpret_cast<const float4*>(src) + g);
    } else {
      for (int idx = tid; idx < nm; idx += nt)
        Sstar[pb + idx] = __ldcg(src + idx);
    }
  }
}

#define STEP_PARAMS                                                         \
  float *__restrict__ S, float *__restrict__ V, float *__restrict__ Sl,     \
      float *__restrict__ fl, float *__restrict__ fcur,                     \
      float *__restrict__ Sstar, float *__restrict__ fstar,                 \
      float *__restrict__ trace, const float *__restrict__ Sbar,            \
      const uint8_t *__restrict__ rec, int *__restrict__ tickets,           \
      uint8_t *__restrict__ gtiles, const float *__restrict__ r_all, int N, \
      int n, int m, int K, int k, Hyper h
#define STEP_ARGS                                                          \
  S, V, Sl, fl, fcur, Sstar, fstar, trace, Sbar, rec, tickets, gtiles,     \
      r_all, N, n, m, K, k, h

template <bool QUANT, bool SMEM>
__global__ void __launch_bounds__(kThreads, QUANT ? 4 : 3)
step_kernel(STEP_PARAMS) {
  step_body<QUANT, SMEM, true>(STEP_ARGS);
}

// The wide path's step, where the record passes a block's shared memory.
template <bool QUANT, bool SMEM>
__global__ void __launch_bounds__(kThreads, QUANT ? 4 : 3)
step_wide_kernel(STEP_PARAMS) {
  step_body<QUANT, SMEM, false>(STEP_ARGS);
}

template <bool QUANT, bool SMEM, bool REC>
int launch_steps(size_t smem, float* S, float* V, float* Sl,
                 float* fl, float* fcur, float* Sstar, float* fstar,
                 float* trace, const float* Sbar, const uint8_t* rec,
                 int* tickets, uint8_t* gtiles, const float* r_all, int P,
                 int N, int n, int m, int K, const Hyper& h,
                 cudaStream_t st) {
  const void* kern = REC ? (const void*)step_kernel<QUANT, SMEM>
                         : (const void*)step_wide_kernel<QUANT, SMEM>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < K; ++k) {
    if (REC)
      step_kernel<QUANT, SMEM><<<dim3(N, P), kThreads, smem, st>>>(
          S, V, Sl, fl, fcur, Sstar, fstar, trace, Sbar, rec, tickets,
          gtiles, r_all, N, n, m, K, k, h);
    else
      step_wide_kernel<QUANT, SMEM><<<dim3(N, P), kThreads, smem, st>>>(
          S, V, Sl, fl, fcur, Sstar, fstar, trace, Sbar, rec, tickets,
          gtiles, r_all, N, n, m, K, k, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// ---- The cluster path (n or m > kMaxDim, where a cluster holds it) ----
//
// Measured on the H100 at (312, 528), N = 64 (PERF.md): step_kernel ran
// one 256-thread CTA a particle (64 CTAs on 132 SMs) on tiles in device
// scratch (~0.8 MB a CTA quantized, ~1.7 MB float, past the 50 MB L2 for
// the swarm), and spent 69% (quantized) and 88% (float) of its cycles in
// the n^2 m product, on CUDA cores. Here a particle is a thread-block
// cluster of C CTAs (C = 2, 4 or 8, the smallest whose CTA's part fits).
// Rank r owns the rows i in [r R, r R + R), R = ceil(n / C), and runs on
// them everything that is row-local: velocity, clip, mask, the row sums
// (a thread a row, left to right), normalise, quantize and requantize
// (each a pass of the whole CTA over a batch of rows), S G, the residual
// rows and the local best. The cluster.sync()s separate the phases; the
// kernel boundary is still the barrier across particles, and the
// problem's ticket and global-best selection are as above, taken by rank
// 0 of each cluster, the S* copy then split over the last cluster's
// ranks.
//  * Quantized: no float tile. Each CTA holds the whole byte tile (own
//    rows written in place, the others' copied over distributed shared
//    memory after the first cluster.sync) and its rows of S G as a high
//    and a low byte plane (S G < 2^16, as above). S G S^T runs on the
//    integer tensor cores, mma.sync m16n8k32 u8 x u8 -> s32, one 16-row
//    by 64-column tile a warp: sum_j hi S^T and sum_j lo S^T are exact in
//    s32 (each is at most 255 * 255 * round_up(m, 32) < 2^31 for
//    m < 33,000, whatever S's rows hold) and 256 hi + lo recombines them
//    into the u32 sum the dp2a loop above keeps (the same value mod 2^32),
//    then the int64 residual. A CTA's partial sum goes to every rank.
//  * Float: every sum keeps the plain version's order (j ascending in
//    S G and S G S^T, u then i ascending in the residual), so no tensor
//    cores and no FMA. A CTA holds its rows of St, of S G and of the
//    squared residuals (~215 KB at (312, 528), C = 8: the cluster's
//    8 x 227 KB hold the particle's ~1.7 MB but for the other ranks' St
//    rows, which the product stages 16 columns at a time over
//    distributed shared memory). Each row's residual sum goes to every
//    rank, and each rank sums the n rows in order.
// Where a CTA's part passes 227 KB at C = 8 the kernels above run. Where
// a cluster fits, the choice follows the times of the two on the H100
// (kernel_ab.py --crossover, N = 64, K = 12, random problems at m = 400
// and 528, P = 1, 2, 4 and 8 problems, PERF.md):
//  * step_kernel's tiles in device scratch: clusters, but quantized at
//    n < 128 only up to 128 particles. At (96, 528) quantized the
//    clusters took 0.47 and 0.80 of step_kernel's time at P = 1 and 2,
//    1.07 and 1.25 at P = 4 and 8; at n = 128 and 200 0.41 to 0.82 at
//    every P; float (tiles in scratch from (56, 528)) 0.34 to 0.91 at
//    every P.
//  * tiles in shared memory: clusters at most 64 particles a launch
//    (step_kernel's 64 CTAs leave half the SMs idle) and n >= 40. At
//    P = 1 the clusters took 0.81 to 1.01 of the time from n = 40, and
//    1.05 to 1.17 at n = 8; from P = 2 1.31 to 3.94.
// The scheduler's window-8 drains on the 512-engine platform launch the
// epoch at P = 1 (70 of 71 epoch calls, n = 8, 40 and 56, m = 336 to
// 528).
constexpr int kClusterMinRowsQuant = 128, kClusterMaxParticlesQuant = 128;
constexpr int kClusterMaxParticlesSmem = 64, kClusterMinRowsSmem = 40;

constexpr int kClusterMax = 8;
constexpr int kWarps = kThreads / 32;
// float: S G S^T's blocks a thread (at most kBlocks x kThreads blocks of
// 4 x 4), the columns of a staged chunk of St rows and its row stride (16
// bytes of padding: the lanes' rows fall on distinct banks), and the
// float4s of a chunk a thread moves (n <= kPre x kThreads / 4)
constexpr int kBlocks = 4, kChunk = 16, kLdB = kChunk + 4, kPre = 8;
constexpr int kGather = 8;     // quant: a thread's loads of the tile at once
constexpr int kVel = 4;        // the velocity pass's groups a thread loads

// Byte offsets of a cluster CTA's shared memory (quant: the whole byte
// tile, then this rank's high and low planes of S G, which hold RQ
// staged float rows during the first phase; float: this rank's rows of
// St and S G, the squared residuals or the staged St chunks, then every
// row's residual sum; both: each own row's sum, byte sum and reciprocal),
// and the rows a rank owns.
struct CLayout {
  int R, RQ, ldq, ldf, ldn, ldr;
  int sq, planes, st, sg, r2, rowf, rowv, lut, parts, slots, misc, smem;
};

__host__ __device__ inline CLayout clayout(int n, int m, bool quant,
                                           int C) {
  CLayout L;
  L.R = (n + C - 1) / C;
  L.ldq = round_up(m, 32) + 16;     // bytes; 16 mod 32: no bank conflicts
  L.ldf = odd_chunks(m, 4);         // floats
  L.ldn = rt::odd_stride(n);        // floats
  L.ldr = round_up(m, 4);           // floats of a staged row
  int end;
  L.RQ = 0;
  if (quant) {
    L.sq = 0;
    L.planes = align16(n * L.ldq);
    const int pl = 2 * L.R * L.ldq, rows = kWarps * 4 * L.ldr;
    const int bytes = pl > rows ? pl : rows;
    L.RQ = bytes / (4 * L.ldr);           // staged float rows (>= 8)
    end = align16(L.planes + bytes);
    L.st = L.sg = L.r2 = L.rowf = 0;      // unused
  } else {
    L.st = 0;
    L.sg = align16(4 * L.R * L.ldf);
    L.r2 = align16(L.sg + 4 * L.R * L.ldf);
    const int r2 = 4 * L.R * L.ldn, chunks = 2 * 4 * n * kLdB;
    L.rowf = align16(L.r2 + (r2 > chunks ? r2 : chunks));
    end = align16(L.rowf + 4 * n);
    L.sq = L.planes = 0;                  // unused
  }
  L.rowv = end;                           // 3 words a row of the rank
  L.lut = align16(L.rowv + 12 * L.R);
  L.parts = L.lut + (quant ? 4 * 256 : 0);
  L.slots = L.parts + 8 * kWarps;
  L.misc = L.slots + 8 * kClusterMax;
  L.smem = L.misc + 16;
  return L;
}

bool cluster_fits(int n, int m, bool quant, int C) {
  const CLayout L = clayout(n, m, quant, C);
  if ((size_t)L.smem > kSmemMax || m > 1024) return false;
  return quant || (n <= kPre * kThreads / 4 &&
                   ((L.R + 3) / 4) * ((n + 3) / 4) <= kBlocks * kThreads);
}

bool clusters_chosen(int particles, int n, int m, bool quant) {
#ifdef EPOCH_FUSED_CLUSTERS
  (void)particles, (void)n, (void)m, (void)quant;
  return EPOCH_FUSED_CLUSTERS != 0;
#else
  if (!tiles_in_smem(layout(n, m, quant)))
    return !quant || n >= kClusterMinRowsQuant ||
           particles <= kClusterMaxParticlesQuant;
  return particles <= kClusterMaxParticlesSmem && n >= kClusterMinRowsSmem;
#endif
}

// The cluster size of the step of `particles` particles (P N) at (n, m),
// 0 for the kernels above: past 256, where the rule above takes
// clusters, the smallest C whose part fits. A build for measurement may
// replace the rule with -DEPOCH_FUSED_CLUSTERS=0 (never) or =1 (wherever
// a cluster fits past 256).
int cluster_size(int particles, int n, int m, bool quant) {
  if (!rt::wide(n, m) || !clusters_chosen(particles, n, m, quant)) return 0;
  for (int C = 2; C <= kClusterMax; C *= 2)
    if (cluster_fits(n, m, quant, C)) return C;
  return 0;
}

using rt::ld32;
using rt::mma_u8;

// One inner step of one particle (blockIdx.x / C) of one problem
// (blockIdx.y) as a cluster of C CTAs; rank 0 of the problem's last
// cluster selects its global best.
template <bool QUANT>
__global__ void __launch_bounds__(kThreads, 1)
cluster_step_kernel(STEP_PARAMS, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int p = blockIdx.y, part = blockIdx.x / C, tid = threadIdx.x;
  const int nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  const size_t nm = (size_t)n * m;
  const Layout L = layout(n, m, false);         // the record's offsets
  const CLayout CL = clayout(n, m, QUANT, C);
  const int W = L.W, R = CL.R, r0 = rank * R;
  const int rows = max(0, min(n, r0 + R) - r0);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* rp = rec + (size_t)p * L.rec;
  const uint32_t* Gin = reinterpret_cast<const uint32_t*>(rp + L.gbits);
  const uint32_t* mbits = reinterpret_cast<const uint32_t*>(rp + L.mbits);
  const float* mrows = reinterpret_cast<const float*>(rp + L.mrows);
  const uint32_t* qbits = reinterpret_cast<const uint32_t*>(rp + L.qbits);
  long long* part_sums = reinterpret_cast<long long*>(smem + CL.parts);
  long long* slots = reinterpret_cast<long long*>(smem + CL.slots);
  int* misc = reinterpret_cast<int*>(smem + CL.misc);
  float* lut = reinterpret_cast<float*>(smem + CL.lut);
  uint8_t* Sq = smem + CL.sq;                   // quant: n rows of ldq
  uint8_t* hi = smem + CL.planes;               // quant: R rows each
  uint8_t* lo = hi + (size_t)R * CL.ldq;
  float* St = reinterpret_cast<float*>(smem + CL.st);   // float: R rows
  float* SGf = reinterpret_cast<float*>(smem + CL.sg);
  float* R2 = reinterpret_cast<float*>(smem + CL.r2);
  float* rowf = reinterpret_cast<float*>(smem + CL.rowf);
  const size_t pi = (size_t)p * N + part;
  const float f_old = fl[pi];     // read before rank 0 can rewrite it
  const size_t pb = (size_t)p * nm, base = pi * nm;
  const float* r = r_all + (((size_t)p * K + k) * N + part) * 3;
  const float a1 = h.c1 * r[0], a2 = h.c2 * r[1], a3 = h.c3 * r[2];
  const bool vec = (m & 3) == 0;

  // the zero columns past m of this rank's rows that the products read
  if (QUANT) {
    for (int t = tid; t < 256; t += nt) lut[t] = (float)t / 255.0f;
    const int pad = CL.ldq - m;
    for (int idx = tid; idx < rows * pad; idx += nt)
      Sq[(size_t)(r0 + idx / pad) * CL.ldq + m + idx % pad] = 0;
  } else {
    const int pad = round_up(m, 4) - m;
    for (int idx = tid; idx < rows * pad; idx += nt)
      St[idx / pad * CL.ldf + m + idx % pad] = 0.0f;
  }
  __syncthreads();

  // velocity, clip, position, mask (ref.pso_update, same op order), the
  // row sums (a thread a row, left to right), normalise; quantized,
  // quantize, the byte sums and the requantize. Each pass runs over a
  // batch of this rank's rows with every thread; quantized, a batch's
  // float rows are staged in the planes' space (RQ rows at a time), float
  // in St itself.
  const int gpr = m >> 2, batch = QUANT ? CL.RQ : max(rows, 1);
  float* rs_of = reinterpret_cast<float*>(smem + CL.rowv);
  int* sum_of = reinterpret_cast<int*>(rs_of + R);
  int* recip_of = sum_of + R;
  for (int b0 = 0; b0 < rows; b0 += batch) {
    const int nb = min(batch, rows - b0);
    float* rowbuf = QUANT ? reinterpret_cast<float*>(smem + CL.planes)
                          : St + b0 * CL.ldf;
    const int ldr = QUANT ? CL.ldr : CL.ldf;
    if (vec) {          // kVel groups' loads of a thread issued at once
      for (int g0 = tid; g0 < nb * gpr; g0 += kVel * nt) {
        float4 s[kVel], v[kVel], sl[kVel], ss[kVel], sb[kVel];
#pragma unroll
        for (int x = 0; x < kVel; ++x) {
          const int g = g0 + x * nt;
          if (g < nb * gpr) {
            const int lb = g / gpr, j = (g - lb * gpr) << 2;
            const size_t e = (size_t)(r0 + b0 + lb) * m + j;
            s[x] = *reinterpret_cast<const float4*>(S + base + e);
            v[x] = *reinterpret_cast<const float4*>(V + base + e);
            sl[x] = *reinterpret_cast<const float4*>(Sl + base + e);
            ss[x] = *reinterpret_cast<const float4*>(Sstar + pb + e);
            sb[x] = *reinterpret_cast<const float4*>(Sbar + pb + e);
          }
        }
#pragma unroll
        for (int x = 0; x < kVel; ++x) {
          const int g = g0 + x * nt;
          if (g < nb * gpr) {
            const int lb = g / gpr, j = (g - lb * gpr) << 2;
            const size_t e = (size_t)(r0 + b0 + lb) * m + j;
            const uint32_t mb =
                mbits[(r0 + b0 + lb) * W + (j >> 5)] >> (j & 31);
            float4 vn, st;
            vn.x = velocity(h, a1, a2, a3, s[x].x, v[x].x, sl[x].x, ss[x].x,
                            sb[x].x);
            vn.y = velocity(h, a1, a2, a3, s[x].y, v[x].y, sl[x].y, ss[x].y,
                            sb[x].y);
            vn.z = velocity(h, a1, a2, a3, s[x].z, v[x].z, sl[x].z, ss[x].z,
                            sb[x].z);
            vn.w = velocity(h, a1, a2, a3, s[x].w, v[x].w, sl[x].w, ss[x].w,
                            sb[x].w);
            st.x = fmaxf(s[x].x + vn.x, 0.0f) * (float)(mb & 1u);
            st.y = fmaxf(s[x].y + vn.y, 0.0f) * (float)((mb >> 1) & 1u);
            st.z = fmaxf(s[x].z + vn.z, 0.0f) * (float)((mb >> 2) & 1u);
            st.w = fmaxf(s[x].w + vn.w, 0.0f) * (float)((mb >> 3) & 1u);
            *reinterpret_cast<float4*>(V + base + e) = vn;
            *reinterpret_cast<float4*>(rowbuf + lb * ldr + j) = st;
          }
        }
      }
    } else {
      for (int idx = tid; idx < nb * m; idx += nt) {
        const int lb = idx / m, j = idx - lb * m;
        const size_t e = (size_t)(r0 + b0) * m + idx;
        const float s = S[base + e];
        const float v = velocity(h, a1, a2, a3, s, V[base + e], Sl[base + e],
                                 Sstar[pb + e], Sbar[pb + e]);
        V[base + e] = v;
        rowbuf[lb * ldr + j] =
            fmaxf(s + v, 0.0f) *
            (float)rt::test_bit(mbits + (r0 + b0 + lb) * W, j);
      }
    }
    __syncthreads();
    for (int lb = tid; lb < nb; lb += nt) {
      const float* row = rowbuf + lb * ldr;
      float acc = 0.0f;
      int j = 0;
      for (; j + 4 <= m; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + j);
        acc = acc + x.x;
        acc = acc + x.y;
        acc = acc + x.z;
        acc = acc + x.w;
      }
      for (; j < m; ++j) acc = acc + row[j];
      rs_of[b0 + lb] = acc;
    }
    __syncthreads();
    // normalise (uniform fallback for an empty row): quantized into the
    // tile's rows, float in place and into S
    if (vec) {
      for (int g = tid; g < nb * gpr; g += nt) {
        const int lb = g / gpr, j = (g - lb * gpr) << 2;
        const int i = r0 + b0 + lb;
        const float rs = rs_of[b0 + lb], mr = mrows[i];
        float4* xp = reinterpret_cast<float4*>(rowbuf + lb * ldr + j);
        const float4 x = *xp;
        const uint32_t mb = mbits[i * W + (j >> 5)] >> (j & 31);
        float4 v;
        v.x = normalized(x.x, rs, mb & 1u, mr);
        v.y = normalized(x.y, rs, mb & 2u, mr);
        v.z = normalized(x.z, rs, mb & 4u, mr);
        v.w = normalized(x.w, rs, mb & 8u, mr);
        if (QUANT) {
          *reinterpret_cast<uint32_t*>(Sq + (size_t)i * CL.ldq + j) =
              quantize(v.x) | quantize(v.y) << 8 | quantize(v.z) << 16 |
              quantize(v.w) << 24;
        } else {
          *xp = v;
          *reinterpret_cast<float4*>(S + base + (size_t)i * m + j) = v;
        }
      }
    } else {
      for (int idx = tid; idx < nb * m; idx += nt) {
        const int lb = idx / m, j = idx - lb * m, i = r0 + b0 + lb;
        const float v =
            normalized(rowbuf[lb * ldr + j], rs_of[b0 + lb],
                       rt::test_bit(mbits + i * W, j), mrows[i]);
        if (QUANT) {
          Sq[(size_t)i * CL.ldq + j] = (uint8_t)quantize(v);
        } else {
          rowbuf[lb * ldr + j] = v;
          S[base + (size_t)i * m + j] = v;
        }
      }
    }
    if (!QUANT) continue;
    __syncthreads();
    // straight-through requantize: the byte sums and their Q1.15
    // reciprocals, then S = the requantized bytes / 255
    for (int lb = tid; lb < nb; lb += nt) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          Sq + (size_t)(r0 + b0 + lb) * CL.ldq);
      unsigned c = 0;
      for (int w = 0; w < round_up(m, 4) / 4; ++w)
        c = __dp4a(row[w], 0x01010101u, c);
      sum_of[b0 + lb] = (int)c;
      recip_of[b0 + lb] = (int)rintf(32768.0f / (float)max((int)c, 1));
    }
    __syncthreads();
    if (vec) {
      for (int g = tid; g < nb * gpr; g += nt) {
        const int lb = g / gpr, j = (g - lb * gpr) << 2;
        const int i = r0 + b0 + lb, l = b0 + lb;
        const int row = sum_of[l], recip = recip_of[l], mr = (int)mrows[i];
        uint32_t* sq = reinterpret_cast<uint32_t*>(Sq + (size_t)i * CL.ldq + j);
        const uint32_t w = *sq;
        const uint32_t mb = mbits[i * W + (j >> 5)] >> (j & 31);
        const uint32_t q0 = requantize(w & 0xffu, mb & 1u, row, recip, mr),
                       q1 = requantize((w >> 8) & 0xffu, mb & 2u, row, recip,
                                       mr),
                       q2 = requantize((w >> 16) & 0xffu, mb & 4u, row, recip,
                                       mr),
                       q3 = requantize(w >> 24, mb & 8u, row, recip, mr);
        *sq = q0 | q1 << 8 | q2 << 16 | q3 << 24;
        *reinterpret_cast<float4*>(S + base + (size_t)i * m + j) =
            make_float4(lut[q0], lut[q1], lut[q2], lut[q3]);
      }
    } else {
      for (int idx = tid; idx < nb * m; idx += nt) {
        const int lb = idx / m, j = idx - lb * m;
        const int i = r0 + b0 + lb, l = b0 + lb;
        uint8_t* q = Sq + (size_t)i * CL.ldq + j;
        const uint32_t v = requantize(*q, rt::test_bit(mbits + i * W, j),
                                      sum_of[l], recip_of[l], (int)mrows[i]);
        *q = (uint8_t)v;
        S[base + (size_t)i * m + j] = lut[v];
      }
    }
    __syncthreads();           // the next batch reuses the staged rows
  }
  cluster.sync();      // every rank's rows are in place

  // S G of this rank's rows: each thread loads one column's bits at once
  // (m <= 1,024 here: at most 32 words) and walks them (k ascending) for
  // 8 rows at a time; columns past m are zeros
  constexpr int RB = 8;
  {
    const int cols = QUANT ? round_up(m, 32) : round_up(m, 4);
    for (int j = tid; j < cols; j += nt) {
      uint32_t gb[32];
#pragma unroll
      for (int w = 0; w < 32; ++w)
        gb[w] = j < m && w < W ? __ldg(Gin + j * W + w) : 0u;
      for (int l0 = 0; l0 < rows; l0 += RB) {
        float accf[RB];
        int acci[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q) { accf[q] = 0.0f; acci[q] = 0; }
#pragma unroll
        for (int w = 0; w < 32; ++w) {
          uint32_t bits = gb[w];
          while (bits) {
            const int kk = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
#pragma unroll
            for (int q = 0; q < RB; ++q) {
              if (l0 + q < rows) {
                if (QUANT)
                  acci[q] += Sq[(size_t)(r0 + l0 + q) * CL.ldq + kk];
                else
                  accf[q] = accf[q] + St[(l0 + q) * CL.ldf + kk];
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          if (l0 + q < rows) {
            if (QUANT) {
              const uint32_t sg = (uint32_t)acci[q] & 0xffffu;
              hi[(l0 + q) * CL.ldq + j] = (uint8_t)(sg >> 8);
              lo[(l0 + q) * CL.ldq + j] = (uint8_t)(sg & 0xffu);
            } else {
              SGf[(l0 + q) * CL.ldf + j] = accf[q];
            }
          }
        }
      }
    }
  }
  if (QUANT) {
    // the other ranks' rows of the byte tile, 16 bytes a load, a thread's
    // kGather loads issued before their stores
    uint4* tile = reinterpret_cast<uint4*>(Sq);
    const int per = CL.ldq / 16, total = n * per;
    for (int w0 = tid; w0 < total; w0 += kGather * nt) {
      uint4 v[kGather];
#pragma unroll
      for (int x = 0; x < kGather; ++x) {
        const int w = w0 + x * nt, src = w / per / R;
        if (w < total && src != rank)
          v[x] = *cluster.map_shared_rank(tile + w, src);
      }
#pragma unroll
      for (int x = 0; x < kGather; ++x) {
        const int w = w0 + x * nt;
        if (w < total && w / per / R != rank) tile[w] = v[x];
      }
    }
  }
  __syncthreads();

  float f;
  if (QUANT) {
    // S G S^T on the tensor cores: warp tile 16 rows (A: this rank's
    // planes) by 64 columns u (B: the tile's rows); rows and columns past
    // the edge are clamped and left out of the residual
    const int g = lane >> 2, t4 = lane & 3, kq = round_up(m, 32);
    const int MT = (rows + 15) >> 4, UT = (n + 63) >> 6;
    long long local = 0;
    for (int tile = warp; tile < MT * UT; tile += nwarps) {
      const int mt = tile / UT, ut = tile - mt * UT;
      const int la = min(mt * 16 + g, rows - 1);
      const int lb = min(mt * 16 + g + 8, rows - 1);
      const uint8_t* ha = hi + la * CL.ldq + t4 * 4;
      const uint8_t* hb = hi + lb * CL.ldq + t4 * 4;
      const uint8_t* la_ = lo + la * CL.ldq + t4 * 4;
      const uint8_t* lb_ = lo + lb * CL.ldq + t4 * 4;
      int bo[8];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        bo[nb] = min(ut * 64 + nb * 8 + g, n - 1) * CL.ldq + t4 * 4;
      int ch[8][4], cl[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) { ch[nb][e] = 0; cl[nb][e] = 0; }
      for (int j0 = 0; j0 < kq; j0 += 32) {
        uint32_t ah[4], al[4];
        ah[0] = ld32(ha + j0);
        ah[1] = ld32(hb + j0);
        ah[2] = ld32(ha + j0 + 16);
        ah[3] = ld32(hb + j0 + 16);
        al[0] = ld32(la_ + j0);
        al[1] = ld32(lb_ + j0);
        al[2] = ld32(la_ + j0 + 16);
        al[3] = ld32(lb_ + j0 + 16);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const uint32_t b0 = ld32(Sq + bo[nb] + j0);
          const uint32_t b1 = ld32(Sq + bo[nb] + j0 + 16);
          mma_u8(ch[nb], ah, b0, b1);
          mma_u8(cl[nb], al, b0, b1);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int li = mt * 16 + g + (e >> 1) * 8;
          const int u = ut * 64 + nb * 8 + t4 * 2 + (e & 1);
          if (li < rows && u < n) {
            const uint32_t acc = (uint32_t)ch[nb][e] * 256u +
                                 (uint32_t)cl[nb][e];
            const long long q =
                rt::test_bit(qbits + (r0 + li) * L.Wn, u) ? 65025LL : 0LL;
            const long long res = q - (long long)acc;
            local += res * res;
          }
        }
    }
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0) part_sums[warp] = local;
    __syncthreads();
    if (tid < C) {        // this rank's partial, into every rank's slots
      long long tot = 0;
      for (int w = 0; w < nwarps; ++w) tot += part_sums[w];
      cluster.map_shared_rank(slots, tid)[rank] = tot;
    }
    cluster.sync();
    long long tot = 0;
    for (int s = 0; s < C; ++s) tot += slots[s];
    f = -__ll2float_rn(tot) / 4228250625.0f;
  } else {
    // S G S^T and the squared residuals: thread t owns the blocks
    // t + nt x (x < kBlocks) of 4 x 4 entries, block (bi, bu) holding this
    // rank's rows bi + RBk a and the columns u = bu + UB b (a, b < 4). The
    // St rows u come in chunks of kChunk columns over distributed shared
    // memory, each chunk's loads issued before the last chunk's products
    // and stored after them into the other of two buffers (R2's space).
    const int RBk = (rows + 3) / 4, UB = (n + 3) / 4, nblk = RBk * UB;
    const int jend = round_up(m, 4), nch = (jend + kChunk - 1) / kChunk;
    float* buf = R2;
    const int items = n * (kChunk / 4);       // float4s of a chunk
    const float* src[kPre];
#pragma unroll
    for (int x = 0; x < kPre; ++x) {
      const int idx = min(tid + nt * x, items - 1), u = idx / (kChunk / 4);
      const int q = u / R;
      src[x] = cluster.map_shared_rank(St, q) + (u - q * R) * CL.ldf +
               (idx - u * (kChunk / 4)) * 4;
    }
    float4 pre[kPre];
    float acc[kBlocks][4][4];
#pragma unroll
    for (int x = 0; x < kBlocks; ++x)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[x][a][b] = 0.0f;
    for (int c = -1; c < nch; ++c) {
      const bool more = c + 1 < nch;
      if (c >= 0) __syncthreads();   // chunk c is in its buffer
      if (more) {                    // chunk c + 1's loads
#pragma unroll
        for (int x = 0; x < kPre; ++x) {
          const int idx = tid + nt * x;
          const int j = (c + 1) * kChunk + (idx % (kChunk / 4)) * 4;
          if (idx < items && j < jend)
            pre[x] = *reinterpret_cast<const float4*>(src[x] +
                                                      (c + 1) * kChunk);
        }
      }
      if (c >= 0) {
        const float* b = buf + (c & 1) * n * kLdB;
        const int j0 = c * kChunk, jn = min(kChunk, jend - j0);
#pragma unroll
        for (int x = 0; x < kBlocks; ++x) {
          const int it = tid + nt * x;
          if (it < nblk) {
            const int bi = it / UB, bu = it - bi * UB;
            int ir[4], uo[4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
              ir[a] = min(bi + RBk * a, rows - 1) * CL.ldf + j0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              uo[q] = min(bu + UB * q, n - 1) * kLdB;
            for (int jj = 0; jj < jn; jj += 4) {
              float4 sv[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                sv[q] = *reinterpret_cast<const float4*>(b + uo[q] + jj);
#pragma unroll
              for (int a = 0; a < 4; ++a) {
                const float4 gv =
                    *reinterpret_cast<const float4*>(SGf + ir[a] + jj);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  acc[x][a][q] = acc[x][a][q] + gv.x * sv[q].x;
                  acc[x][a][q] = acc[x][a][q] + gv.y * sv[q].y;
                  acc[x][a][q] = acc[x][a][q] + gv.z * sv[q].z;
                  acc[x][a][q] = acc[x][a][q] + gv.w * sv[q].w;
                }
              }
            }
          }
        }
      }
      if (more) {                    // into the other buffer
        float* b = buf + ((c + 1) & 1) * n * kLdB;
#pragma unroll
        for (int x = 0; x < kPre; ++x) {
          const int idx = tid + nt * x, qq = idx % (kChunk / 4);
          const int j = (c + 1) * kChunk + qq * 4;
          if (idx < items && j < jend)
            *reinterpret_cast<float4*>(b + (idx / (kChunk / 4)) * kLdB +
                                       qq * 4) = pre[x];
        }
      }
    }
    __syncthreads();                 // the buffers' space becomes R2
#pragma unroll
    for (int x = 0; x < kBlocks; ++x) {
      const int it = tid + nt * x;
      if (it < nblk) {
        const int bi = it / UB, bu = it - bi * UB;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int li = bi + RBk * a, u = bu + UB * q;
            if (li < rows && u < n) {
              const float qv =
                  rt::test_bit(qbits + (r0 + li) * L.Wn, u) ? 1.0f : 0.0f;
              const float res = qv - acc[x][a][q];
              R2[li * CL.ldn + u] = res * res;
            }
          }
      }
    }
    __syncthreads();
    // each row's sum over u ascending, into every rank's rowf
    for (int li = tid; li < rows; li += nt) {
      float acc = 0.0f;
      for (int u = 0; u < n; ++u) acc = acc + R2[li * CL.ldn + u];
      for (int s = 0; s < C; ++s)
        cluster.map_shared_rank(rowf, s)[r0 + li] = acc;
    }
    cluster.sync();
    if (tid == 0) {
      float tot = 0.0f;
      for (int i = 0; i < n; ++i) tot = tot + rowf[i];
      reinterpret_cast<float*>(misc)[0] = -tot;
    }
    __syncthreads();
    f = reinterpret_cast<const float*>(misc)[0];
  }

  // local best: this rank's rows of S_local (only this cluster touches
  // its particle's S_local and f_local)
  if (f > f_old) {
    for (int li = warp; li < rows; li += nwarps) {
      const size_t ro = base + (size_t)(r0 + li) * m;
      for (int j = lane; j < m; j += 32)
        Sl[ro + j] = QUANT ? lut[Sq[(size_t)(r0 + li) * CL.ldq + j]]
                           : St[li * CL.ldf + j];
    }
  }
  if (rank == 0 && tid == 0) {
    fl[pi] = fmaxf(f, f_old);
    fcur[pi] = f;
  }
  // the ticket: every write of the cluster is visible before it is taken
  __threadfence();
  cluster.sync();
  if (rank == 0) {
    if (tid == 0) misc[1] = atomicAdd(tickets + p, 1) == N - 1;
    __syncthreads();
    if (misc[1]) {
      // the problem's last cluster: global best = the first argmax of the
      // local bests (read past L1, which may hold other CTAs' stale lines)
      __threadfence();
      if (tid < 32) {
        float v = __int_as_float(0xff800000);   // -inf
        int b = INT32_MAX;
        for (int i = tid; i < N; i += 32) {
          const float x = __ldcg(fl + (size_t)p * N + i);
          if (x > v || b == INT32_MAX) { v = x; b = i; }
        }
        for (int off = 16; off > 0; off >>= 1)
          keep_better(v, b, __shfl_down_sync(0xffffffffu, v, off),
                      __shfl_down_sync(0xffffffffu, b, off));
        if (tid == 0) {
          const float fs = __ldcg(fstar + p);
          const bool better = v > fs;
          const float nf = better ? v : fs;
          fstar[p] = nf;
          trace[(size_t)p * K + k] = nf;
          misc[2] = better ? b : -1;
          tickets[p] = 0;
        }
      }
    } else if (tid == 0) {
      misc[2] = -1;
    }
    __syncthreads();
    const int best = misc[2];
    __syncthreads();
    if (tid < C) cluster.map_shared_rank(misc, tid)[2] = best;
  }
  cluster.sync();
  const int best = misc[2];
  if (best >= 0) {     // each rank copies its rows of the new S*
    __threadfence();
    const float* src = Sl + ((size_t)p * N + best) * nm;
    const size_t lo_e = (size_t)r0 * m, hi_e = (size_t)(r0 + rows) * m;
    for (size_t e = lo_e + tid; e < hi_e; e += nt)
      Sstar[pb + e] = __ldcg(src + e);
  }
}

template <bool QUANT>
int launch_cluster_steps(int C, size_t smem, float* S, float* V, float* Sl,
                         float* fl, float* fcur, float* Sstar, float* fstar,
                         float* trace, const float* Sbar, const uint8_t* rec,
                         int* tickets, uint8_t* gtiles, const float* r_all,
                         int P, int N, int n, int m, int K, const Hyper& h,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_step_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();      // a refused call leaves no error behind
    return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * C, P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int k = 0; k < K; ++k) {
    err = cudaLaunchKernelEx(&cfg, cluster_step_kernel<QUANT>, S, V, Sl, fl,
                             fcur, Sstar, fstar, trace, Sbar, rec, tickets,
                             gtiles, r_all, N, n, m, K, k, h, C);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// Scratch of one call, in bytes: the records, then the tickets, then
// (when the tiles do not fit in shared memory, and not on the cluster
// path) one tile slice per CTA.
struct Scratch {
  size_t rec, tickets, total;
};

Scratch scratch_parts(int P, int N, int n, int m, bool quant) {
  const Layout L = layout(n, m, quant);
  Scratch s;
  s.rec = (size_t)P * L.rec;
  s.tickets = (size_t)align16(4 * P);
  const bool tiles =
      !tiles_in_smem(L) && cluster_size(P * N, n, m, quant) == 0;
  s.total = s.rec + s.tickets + (tiles ? (size_t)P * N * L.tiles : 0);
  return s;
}

}  // namespace

// Bytes of device scratch that epoch_fused needs for these shapes.
extern "C" long long epoch_fused_scratch_bytes(int P, int N, int n, int m,
                                               int quantized) {
  return (long long)scratch_parts(P, N, n, m, quantized != 0).total;
}

// The step's instantiation for P problems of N particles at (n, m): C > 0
// for cluster_step_kernel on clusters of C, 0 for step_kernel (the record
// in shared memory), -1 for step_wide_kernel.
extern "C" int epoch_fused_path(int P, int N, int n, int m, int quantized) {
  const int C = cluster_size(P * N, n, m, quantized != 0);
  if (C > 0) return C;
  return rec_in_smem(layout(n, m, quantized != 0)) ? 0 : -1;
}

// All K steps of one epoch: one prologue launch and K step launches on
// `stream` (none when K = 0). S, V, Sl, fl, fcur, Sstar, fstar hold the
// initial state and are updated in place; mask, Q, G are uint8 0/1;
// scratch holds epoch_fused_scratch_bytes bytes.
extern "C" int epoch_fused(void* S, void* V, void* Sl, void* fl, void* fcur,
                           void* Sstar, void* fstar, const void* Sbar,
                           const void* mask, const void* Q, const void* G,
                           const void* r_all, void* trace, void* scratch,
                           int P, int N, int n, int m, int K, float omega,
                           float c1, float c2, float c3, float v_max,
                           int quantized, void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  const bool quant = quantized != 0;
  const Layout L = layout(n, m, quant);
  const Scratch sc = scratch_parts(P, N, n, m, quant);
  uint8_t* rec = (uint8_t*)scratch;
  int* tickets = (int*)(rec + sc.rec);
  uint8_t* gtiles = rec + sc.rec + sc.tickets;
  const cudaStream_t st = (cudaStream_t)stream;
  prologue_kernel<<<P, kThreads, 0, st>>>(
      (const uint8_t*)mask, (const uint8_t*)Q, (const uint8_t*)G, rec,
      tickets, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Hyper h{omega, c1, c2, c3, v_max};
  const int C = cluster_size(P * N, n, m, quant);
  if (C > 0) {
    const size_t csmem = clayout(n, m, quant, C).smem;
#define CLUSTER_STEPS(QB)                                                    \
  launch_cluster_steps<QB>(C, csmem, (float*)S, (float*)V, (float*)Sl,      \
                           (float*)fl, (float*)fcur, (float*)Sstar,          \
                           (float*)fstar, (float*)trace, (const float*)Sbar, \
                           rec, tickets, gtiles, (const float*)r_all, P, N,  \
                           n, m, K, h, st)
    return quant ? CLUSTER_STEPS(true) : CLUSTER_STEPS(false);
#undef CLUSTER_STEPS
  }
  const bool in_rec = rec_in_smem(L), in_smem = tiles_in_smem(L);
  const size_t smem = small_bytes(L) + (in_smem ? L.tiles : 0);
#define EPOCH_STEPS(QB, SB, RB)                                              \
  launch_steps<QB, SB, RB>(smem, (float*)S, (float*)V, (float*)Sl,        \
                           (float*)fl, (float*)fcur, (float*)Sstar,          \
                           (float*)fstar, (float*)trace, (const float*)Sbar, \
                           rec, tickets, gtiles, (const float*)r_all, P, N,  \
                           n, m, K, h, st)
  if (!in_rec) {
    if (quant)
      return in_smem ? EPOCH_STEPS(true, true, false)
                     : EPOCH_STEPS(true, false, false);
    return in_smem ? EPOCH_STEPS(false, true, false)
                   : EPOCH_STEPS(false, false, false);
  }
  if (quant)
    return in_smem ? EPOCH_STEPS(true, true, true)
                   : EPOCH_STEPS(true, false, true);
  return in_smem ? EPOCH_STEPS(false, true, true)
                 : EPOCH_STEPS(false, false, true);
#undef EPOCH_STEPS
}
