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
// Numerics: -fmad=false and the plain version's order of operations
// (left-to-right float sums, IEEE division, rintf for round-half-even,
// exact integer sums) make the kernel agree with kernels/epoch_fused.py's
// plain version bit for bit.
#include "common.cuh"

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

// Scratch of one call, in bytes: the records, then the tickets, then
// (when the tiles do not fit in shared memory) one tile slice per CTA.
struct Scratch {
  size_t rec, tickets, total;
};

Scratch scratch_parts(int P, int N, int n, int m, bool quant) {
  const Layout L = layout(n, m, quant);
  Scratch s;
  s.rec = (size_t)P * L.rec;
  s.tickets = (size_t)align16(4 * P);
  s.total = s.rec + s.tickets +
            (tiles_in_smem(L) ? 0 : (size_t)P * N * L.tiles);
  return s;
}

}  // namespace

// Bytes of device scratch that epoch_fused needs for these shapes.
extern "C" long long epoch_fused_scratch_bytes(int P, int N, int n, int m,
                                               int quantized) {
  return (long long)scratch_parts(P, N, n, m, quantized != 0).total;
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
