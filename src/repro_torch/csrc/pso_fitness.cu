// Edge-preserving PSO fitness  f = -||Q - S G S^T||_F^2  per particle, the
// float body, batched over problems that each carry their own Q and G.
//
// Replaces the TPU kernel edge_fitness_pallas (_fitness_kernel in
// src/repro/kernels/pso_fitness.py); the fixed-point body is
// fitness_quantized.cu.
//
// Bound on the H100: fp32 operations on CUDA cores, ~0.45 M multiply-adds
// of S G S^T per particle at 56x144 (no TF32 and no FMA: the body must
// match the plain version to the last bit), and under them the shared-
// memory loads that feed them and the occupancy that hides their latency.
// The design is the float step of epoch_fused.cu, whose costs were timed
// phase by phase (PERF.md):
//  * a first launch packs each problem's G columns once into device
//    scratch (fitness.cuh); a CTA copies its problem's with 16-byte loads;
//  * one CTA per (problem, particle) copies its S tile with 16-byte loads
//    where m % 4 == 0, into rows of an odd number of 16-byte chunks, so that
//    16-byte loads by lanes walking consecutive rows hit distinct banks;
//  * S G walks each column's G bits once for 8 rows;
//  * S G S^T is register-blocked 4 x 4 (i, u) pairs a thread with 16-byte
//    shared loads; the squared residuals wait in registers and then reuse
//    S G's space: ~69 KB at (56, 144), 3 CTAs an SM, the main path's 512
//    CTAs in two waves;
//  * where the tiles do not fit in shared memory they live in a slice of
//    device scratch per CTA (fitness_kernel<false>), chosen by the shape
//    before launch;
//  * past n, m = 256 (kMaxDim) a particle's rows are split over several
//    CTAs (fitness_rows_kernel, below), except where a CTA's part does
//    not fit in shared memory (fitness_wide_kernel, one CTA a particle,
//    which reads G's columns from the scratch in place: m words(m) words
//    may pass a block's shared memory); G is packed from device memory
//    (fitness.cuh).
// Every sum keeps the plain version's order (kernels/ref.py): SG[i, j] over
// k ascending, SGS[i, u] over j ascending, the squared residual over u
// within a row, then over rows. Skipping a +0.0 term (a zero of G, a zero
// column of padding) leaves a float sum unchanged, so with -fmad=false the
// result is bitwise the plain version's.
#include "fitness.cuh"

namespace {

constexpr int kThreads = 256;
using rt::kSmemMax;

using rt::align16;
using rt::odd_chunks;
using rt::round_up;

// Byte offsets of a CTA's shared memory (G's columns, the row sums) and
// of its tiles (S, S G and the squared residual R2, in shared
// memory after the small part or in device scratch).
struct Layout {
  int W, ldf, ldn, gin, rows, small, sg, r2, tiles;
  bool r2_alias;
};

__host__ __device__ inline Layout layout(int n, int m) {
  Layout L;
  L.W = rt::words(m);
  L.ldf = odd_chunks(m, 4);
  L.ldn = rt::odd_stride(n);
  L.gin = 0;
  L.rows = align16(4 * m * L.W);
  L.small = align16(L.rows + 4 * n);
  // R2 reuses S G's space when every thread holds at most one 4 x 4 block
  const int B = (n + 3) / 4;
  L.r2_alias = B * B <= kThreads;
  const int tile = 4 * n * L.ldf, r2_bytes = 4 * n * L.ldn;
  L.sg = align16(tile);                  // S at the start of the tiles
  const int sg_bytes = L.r2_alias && r2_bytes > tile ? r2_bytes : tile;
  L.r2 = L.r2_alias ? L.sg : align16(L.sg + sg_bytes);
  L.tiles = align16(L.r2_alias ? L.sg + sg_bytes : L.r2 + r2_bytes);
  return L;
}

// Shared bytes before the tiles: G's columns and the row sums, or on the
// wide path the row sums alone.
int small_bytes(const Layout& L, bool wide_path) {
  return wide_path ? L.small - L.rows : L.small;
}

bool tiles_in_smem(const Layout& L, bool wide_path) {
  return (size_t)small_bytes(L, wide_path) + L.tiles <= kSmemMax;
}

// One particle (blockIdx.x) of one problem (blockIdx.y). With GSM the
// problem's G columns are copied into shared memory; without (the wide
// path, where they may not fit) they are read from the scratch in place
// and the shared part starts at the row sums.
template <bool SMEM, bool GSM>
__device__ __forceinline__ void fitness_body(
    const float* __restrict__ S, const uint32_t* __restrict__ gin,
    const uint8_t* __restrict__ Q, float* __restrict__ out,
    uint8_t* __restrict__ gtiles, int N, int n, int m) {
  const int p = blockIdx.y, part = blockIdx.x, tid = threadIdx.x;
  const int nt = blockDim.x;
  const Layout L = layout(n, m);
  const int W = L.W, ldf = L.ldf;
  const int off = GSM ? 0 : L.rows;      // the G columns' bytes, if not here
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tiles = SMEM ? smem + L.small - off
                        : gtiles + ((size_t)p * N + part) * L.tiles;
  const uint32_t* src = gin + (size_t)p * m * W;
  uint32_t* Gin = GSM ? reinterpret_cast<uint32_t*>(smem + L.gin)
                      : const_cast<uint32_t*>(src);
  float* rowf = reinterpret_cast<float*>(smem + L.rows - off);
  float* St = reinterpret_cast<float*>(tiles);

  // the problem's G columns, then the particle's tile and zero columns up
  // to a multiple of 4 (the 16-byte product loads read them)
  if (GSM) {
    const int words = m * W;
    if ((words & 3) == 0) {
      for (int w = tid; w < words / 4; w += nt)
        reinterpret_cast<uint4*>(Gin)[w] =
            reinterpret_cast<const uint4*>(src)[w];
    } else {
      for (int w = tid; w < words; w += nt) Gin[w] = src[w];
    }
  }
  const size_t base = ((size_t)p * N + part) * n * m;
  if ((m & 3) == 0 && ((uintptr_t)(S + base) & 15) == 0) {
    const int gpr = m >> 2;                  // 16-byte groups a row
    for (int g = tid; g < n * gpr; g += nt) {
      const int i = g / gpr, j = (g - i * gpr) << 2;
      *reinterpret_cast<float4*>(St + i * ldf + j) =
          reinterpret_cast<const float4*>(S + base)[g];
    }
  } else {
    for (int idx = tid; idx < n * m; idx += nt) {
      const int i = idx / m;
      St[i * ldf + idx - i * m] = S[base + idx];
    }
  }
  const int pad = round_up(m, 4) - m;
  for (int idx = tid; idx < n * pad; idx += nt)
    St[idx / pad * ldf + m + idx % pad] = 0.0f;
  __syncthreads();

  // S G: each thread walks one column's bits (k ascending) for 8 rows;
  // columns past m are written as zeros
  constexpr int R = 8;
  float* SG = reinterpret_cast<float*>(tiles + L.sg);
  {
    const int cols = round_up(m, 4);
    const int chunks = (n + R - 1) / R;
    for (int it = tid; it < cols * chunks; it += nt) {
      const int c = it / cols, j = it - c * cols, i0 = c * R;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      if (j < m) {
        for (int w = 0; w < W; ++w) {
          uint32_t bits = Gin[j * W + w];
          while (bits) {
            const int kk = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (i0 + r < n) acc[r] = acc[r] + St[(i0 + r) * ldf + kk];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r < n) SG[(i0 + r) * ldf + j] = acc[r];
    }
  }
  __syncthreads();

  // S G S^T and the squared residual: thread (bi, bu) owns rows
  // i = bi + B a and u = bu + B b, a, b < 4
  const int B = (n + 3) / 4;
  const uint8_t* q = Q + (size_t)p * n * n;
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
            *reinterpret_cast<const float4*>(SG + ir[a] * ldf + j);
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
        const float res =
            (i < n && u < n ? (float)q[i * n + u] : 0.0f) - acc[a][b];
        r2[a][b] = res * res;
        if (!L.r2_alias && i < n && u < n) R2[i * L.ldn + u] = r2[a][b];
      }
  }
  if (L.r2_alias) {        // at most one block a thread: S G is read, reuse it
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
    out[(size_t)p * N + part] = -tot;
  }
}

// Launch 2: one particle (blockIdx.x) of one problem (blockIdx.y).
template <bool SMEM>
__global__ void __launch_bounds__(kThreads, 3)
fitness_kernel(const float* __restrict__ S, const uint32_t* __restrict__ gin,
               const uint8_t* __restrict__ Q, float* __restrict__ out,
               uint8_t* __restrict__ gtiles, int N, int n, int m) {
  fitness_body<SMEM, true>(S, gin, Q, out, gtiles, N, n, m);
}

// Launch 2 on the wide path (n or m > kMaxDim): G's columns read from
// the scratch.
template <bool SMEM>
__global__ void __launch_bounds__(kThreads, 3)
fitness_wide_kernel(const float* __restrict__ S,
                    const uint32_t* __restrict__ gin,
                    const uint8_t* __restrict__ Q, float* __restrict__ out,
                    uint8_t* __restrict__ gtiles, int N, int n, int m) {
  fitness_body<SMEM, false>(S, gin, Q, out, gtiles, N, n, m);
}

// ---- The row-split path (n or m > kMaxDim, where a CTA's part fits) ----
//
// Measured on the H100 at (312, 528), N = 64 (PERF.md): the wide kernel
// above ran one CTA a particle (64 CTAs on 132 SMs; one at the Tier-0
// call, N = 1) on ~1.3 MB of tiles in device scratch, and spent 91% of
// its cycles in S G S^T. Here a particle's rows are split over
// RB = ceil(n / R) CTAs (grid (N RB, P)), every sum in the plain order:
//  * a CTA stages its R own rows of S and computes their S G by walking
//    G's column bits (k ascending), into shared memory (R rows);
//  * S's rows u stream through shared memory in passes of UP = 4 UG rows
//    and, within a pass, chunks of J columns, ascending in j,
//    double-buffered with cp.async (J = 16 to 512, the widest whose two
//    buffers take at most kStageBytes: few chunks, and so few barriers,
//    where a pass has few rows): thread (rg, ug) owns the 4 x 4 (i, u)
//    block of own rows 4 rg.. and rows ug + UG b of the pass, its 16 sums
//    in registers across the chunks (mul then add, no FMA), S G read by
//    the lanes of a warp at one address (a broadcast);
//  * the squared residuals of a pass wait in shared memory; each own row
//    is summed over u ascending into the particle's row sums in device
//    scratch, and the particle's last CTA (a ticket, zeroed by the G
//    packing launch) sums the n rows in ascending i: the bits of the
//    plain version.
// The host picks UG = min(ceil(n / 4), 128) (one pass up to n = 512) and
// R = 4 min(8, 256 / UG) rows: R = 12, 26 CTAs a particle, ~91 KB at
// (312, 528). Fewer rows where the grid has fewer CTAs than twice the
// SMs lost more than it won on the H100 (device time, kernel_ab.py
// --bucket against a copy without the cut; PERF.md): 1.08x the time at
// the Tier-0 call at (312, 528) (R = 4), 1.34x at (56, 528), N = 64
// (R = 12 against 32), 0.92x at its Tier-0 call; phase 4f's float
// fitness calls (N = 64 at (312, 528) and (320, 512)) never took it.
// The split runs wherever its shared memory fits. At small n a particle
// has few 4 x 4 (i, u) blocks, the threads that can multiply, and one
// CTA a particle can be faster (n = 8, and n = 40 from 128 particles, by
// up to 1.7x; PERF.md); phase 4f's float calls do not reach that.
constexpr int kMaxRows = 32;
constexpr int kMaxJ = 512, kStageBytes = 48 * 1024;
// at least 4 warps a CTA: the own rows' S G and the staging have every
// thread, the product only the (R / 4) UG that own a block
constexpr int kMinThreads = 128;

// A staged chunk's row stride is J + 4 floats: an odd number of 16-byte
// pieces, so that lanes on consecutive rows hit distinct banks.
struct RLayout {
  int UP, lds, ldf, ldo, ldn, stage, r2, misc, smem;
};

__host__ __device__ inline RLayout rlayout(int n, int m, int R, int UG,
                                           int J) {
  RLayout L;
  L.UP = 4 * UG;
  L.lds = J + 4;
  L.ldf = round_up(m, 16);              // S G, floats
  L.ldo = round_up(m, 4);               // the own rows of S, floats
  L.ldn = round_up(n, 4) + 4;           // the squared residuals, floats
  L.stage = align16(4 * R * L.ldf);     // after S G
  const int chunks = 2 * L.UP * L.lds * 4, own = 4 * R * L.ldo;
  int bytes = chunks > own ? chunks : own;
  bytes = bytes > 4 * n ? bytes : 4 * n;  // the last CTA's n row sums
  L.r2 = align16(L.stage + bytes);
  L.misc = align16(L.r2 + 4 * R * L.ldn);
  L.smem = L.misc + 16;
  return L;
}

struct Split {
  int R, UG, J;
};

// The rows a CTA, u-groups of a pass and columns of a chunk of the
// row-split kernel, or R = -1 for fitness_wide_kernel.
Split float_split(int n, int m) {
  Split s;
  const int n4 = (n + 3) / 4;
  s.UG = n4 < 128 ? n4 : 128;
  int R = kThreads / s.UG;                     // row groups of 4
  R = 4 * (R < 1 ? 1 : R > kMaxRows / 4 ? kMaxRows / 4 : R);
  s.R = R < round_up(n, 4) ? R : round_up(n, 4);
  s.J = 16;
  while (2 * s.J <= kMaxJ && 2 * 4 * s.UG * (2 * s.J + 4) * 4 <= kStageBytes)
    s.J *= 2;
  if ((size_t)rlayout(n, m, s.R, s.UG, s.J).smem > kSmemMax) s.R = -1;
  return s;
}

__global__ void __launch_bounds__(kThreads, 2)
fitness_rows_kernel(const float* __restrict__ S,
                    const uint32_t* __restrict__ gin_all,
                    const uint8_t* __restrict__ Q, float* __restrict__ out,
                    float* __restrict__ rowsum, unsigned* __restrict__ tickets,
                    int N, int n, int m, int R, int UG, int J) {
  const int RB = (n + R - 1) / R;
  const int p = blockIdx.y, part = blockIdx.x / RB;
  const int r0 = (blockIdx.x - part * RB) * R, rows = min(R, n - r0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const RLayout L = rlayout(n, m, R, UG, J);
  const int W = rt::words(m), ldf = L.ldf, ldo = L.ldo, ldn = L.ldn;
  const int UP = L.UP, lds = L.lds, nJ = (L.ldf + J - 1) / J;
  extern __shared__ __align__(16) uint8_t smem[];
  float* SG = reinterpret_cast<float*>(smem);
  float* buf0 = reinterpret_cast<float*>(smem + L.stage);
  float* buf1 = buf0 + UP * lds;
  float* R2 = reinterpret_cast<float*>(smem + L.r2);
  unsigned* misc = reinterpret_cast<unsigned*>(smem + L.misc);
  const uint32_t* Gin = gin_all + (size_t)p * m * W;
  const size_t pi = (size_t)p * N + part;
  const float* Sp = S + pi * n * m;
  const bool vec = (m & 3) == 0 && ((uintptr_t)Sp & 15) == 0;

  // the own rows (stride ldo) over the chunk buffers' space
  if (vec) {
    const int gpr = m >> 2;
    for (int g = tid; g < rows * gpr; g += nt) {
      const int l = g / gpr, c = g - l * gpr;
      cp_async16(buf0 + l * ldo + 4 * c, Sp + (size_t)(r0 + l) * m + 4 * c);
    }
  } else {
    for (int idx = tid; idx < rows * m; idx += nt) {
      const int l = idx / m;
      buf0[l * ldo + idx - l * m] = Sp[(size_t)r0 * m + idx];
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S G of the own rows: a thread a column j (k ascending over G's set
  // bits), all rows at once; zero columns up to a multiple of 16
  for (int j = tid; j < ldf; j += nt) {
    float acc[kMaxRows];
#pragma unroll
    for (int l = 0; l < kMaxRows; ++l) acc[l] = 0.0f;
    if (j < m) {
      walk_column(Gin + (size_t)j * W, W, [&](int kk) {
#pragma unroll
        for (int l = 0; l < kMaxRows; ++l)
          if (l < rows) acc[l] = acc[l] + buf0[l * ldo + kk];
      });
    }
#pragma unroll
    for (int l = 0; l < kMaxRows; ++l)
      if (l < R) SG[l * ldf + j] = acc[l];
  }
  __syncthreads();            // the own rows are read: the buffers follow

  // S G S^T by passes of UP rows u and chunks of J columns (the last
  // one up to round_up(m, 16))
  const int rg = tid / UG, ug = tid - rg * UG;
  const bool active = rg < R / 4;
  const float* sg = SG + 4 * rg * ldf;
  const uint8_t* q = Q + (size_t)p * n * n;
  for (int u0 = 0; u0 < n; u0 += UP) {
    const int cnt = min(UP, n - u0);
    // rows [u0, u0 + cnt), columns [j0, j0 + J) up to ldf into dst, zero
    // past m
    auto stage = [&](float* dst, int j0) {
      const int jw = min(J, ldf - j0);
      if (vec) {
        for (int g = tid; g < cnt * (jw / 4); g += nt) {
          const int r = g / (jw / 4), c = 4 * (g - r * (jw / 4));
          float* d = dst + r * lds + c;
          if (j0 + c < m)
            cp_async16(d, Sp + (size_t)(u0 + r) * m + j0 + c);
          else
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int idx = tid; idx < cnt * jw; idx += nt) {
          const int r = idx / jw, c = idx - r * jw;
          dst[r * lds + c] =
              j0 + c < m ? Sp[(size_t)(u0 + r) * m + j0 + c] : 0.0f;
        }
      }
      cp_async_commit();
    };
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
    stage(buf0, 0);
    for (int c = 0; c < nJ; ++c) {
      if (c + 1 < nJ) {
        stage(c & 1 ? buf0 : buf1, (c + 1) * J);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const float* B = (c & 1 ? buf1 : buf0) + ug * lds;
        const int jn = min(J, ldf - c * J);
        for (int j16 = 0; j16 < jn; j16 += 16) {
#pragma unroll
          for (int jj = j16; jj < j16 + 16; jj += 4) {
            float4 sv[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)
              sv[b] =
                  *reinterpret_cast<const float4*>(B + UG * b * lds + jj);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float4 g = *reinterpret_cast<const float4*>(
                  sg + a * ldf + c * J + jj);
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                acc[a][b] = acc[a][b] + g.x * sv[b].x;
                acc[a][b] = acc[a][b] + g.y * sv[b].y;
                acc[a][b] = acc[a][b] + g.z * sv[b].z;
                acc[a][b] = acc[a][b] + g.w * sv[b].w;
              }
            }
          }
        }
      }
      __syncthreads();        // the buffer is staged again next turn
    }
    if (active) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int l = 4 * rg + a, u = u0 + ug + UG * b;
          if (l < rows && u < n) {
            const float res = (float)q[(size_t)(r0 + l) * n + u] - acc[a][b];
            R2[l * ldn + u] = res * res;
          }
        }
    }
  }
  __syncthreads();

  // each own row's sum over u ascending, into the particle's row sums
  for (int l = tid; l < rows; l += nt) {
    const float* row = R2 + l * ldn;
    float acc = 0.0f;
    int u = 0;
    for (; u + 4 <= n; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + u);
      acc = acc + x.x;
      acc = acc + x.y;
      acc = acc + x.z;
      acc = acc + x.w;
    }
    for (; u < n; ++u) acc = acc + row[u];
    rowsum[pi * n + r0 + l] = acc;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) misc[0] = atomicAdd(tickets + pi, 1u) == (unsigned)RB - 1;
  __syncthreads();
  if (misc[0]) {              // the particle's last CTA: the n rows in order
    __threadfence();
    float* all = buf0;
    for (int i = tid; i < n; i += nt) all[i] = __ldcg(rowsum + pi * n + i);
    __syncthreads();
    if (tid == 0) {
      float tot = 0.0f;
      for (int i = 0; i < n; ++i) tot = tot + all[i];
      out[pi] = -tot;
    }
  }
}

// Scratch of one call, in bytes: G's column bits, then on the wide path
// the row-split kernel's row sums and tickets or, where
// fitness_wide_kernel's tiles do not fit in shared memory, one tile slice
// per CTA.
struct Scratch {
  size_t gin, rowsum, tickets, total;
};

Scratch scratch_parts(int P, int N, int n, int m) {
  const Layout L = layout(n, m);
  Scratch s;
  s.gin = (size_t)align16(4 * m * L.W) * P;
  s.rowsum = s.tickets = s.total = s.gin;
  if (rt::wide(n, m) && float_split(n, m).R > 0) {
    s.tickets = rt::align16z(s.rowsum + 4ull * P * N * n);
    s.total = rt::align16z(s.tickets + 4ull * P * N);
    return s;
  }
  s.total = s.gin + (tiles_in_smem(L, rt::wide(n, m)) ? 0
                                                   : (size_t)P * N * L.tiles);
  return s;
}

template <bool SMEM, bool WIDE>
cudaError_t launch(size_t smem, const float* S, const uint32_t* gin,
                   const uint8_t* Q, float* out, uint8_t* gtiles, int P,
                   int N, int n, int m, cudaStream_t st) {
  const void* kern = WIDE ? (const void*)fitness_wide_kernel<SMEM>
                          : (const void*)fitness_kernel<SMEM>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  if (WIDE)
    fitness_wide_kernel<SMEM><<<dim3(N, P), kThreads, smem, st>>>(
        S, gin, Q, out, gtiles, N, n, m);
  else
    fitness_kernel<SMEM><<<dim3(N, P), kThreads, smem, st>>>(
        S, gin, Q, out, gtiles, N, n, m);
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch that edge_fitness_f32 needs for these shapes.
extern "C" long long edge_fitness_f32_scratch_bytes(int P, int N, int n,
                                                    int m) {
  return (long long)scratch_parts(P, N, n, m).total;
}

// The wide body the card runs for P problems of N particles at (n, m) (a
// choice of n and m alone): 0 on the narrow path, the rows a CTA of
// fitness_rows_kernel, or -1 for fitness_wide_kernel.
extern "C" int edge_fitness_f32_path(int P, int N, int n, int m) {
  return rt::wide(n, m) ? float_split(n, m).R : 0;
}

// The float body: S (P, N, n, m) float32, Q and G uint8 (Q's values
// count, G is read as 0/1); two launches on `stream`. scratch holds
// edge_fitness_f32_scratch_bytes bytes.
extern "C" int edge_fitness_f32(const void* S, const void* Q, const void* G,
                                void* out, void* scratch, int P, int N,
                                int n, int m, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout(n, m);
  const Scratch sc = scratch_parts(P, N, n, m);
  uint32_t* gin = (uint32_t*)scratch;
  uint8_t* gtiles = (uint8_t*)scratch + sc.gin;
  const bool w = rt::wide(n, m);
  if (w) {
    const Split sp = float_split(n, m);
    unsigned* tickets = (unsigned*)((uint8_t*)scratch + sc.tickets);
    cudaError_t err = pack_gin((const uint8_t*)G, gin, P, m, st, tickets,
                               sp.R > 0 ? P * N : 0);
    if (err != cudaSuccess) return (int)err;
    if (sp.R > 0) {
      const RLayout RL = rlayout(n, m, sp.R, sp.UG, sp.J);
      err = rt::allow_smem((const void*)fitness_rows_kernel, RL.smem);
      if (err != cudaSuccess) return (int)err;
      const int RB = (n + sp.R - 1) / sp.R;
      const int busy = round_up(sp.R / 4 * sp.UG, 32);
      const int threads = busy > kMinThreads ? busy : kMinThreads;
      fitness_rows_kernel<<<dim3(N * RB, P), threads, RL.smem, st>>>(
          (const float*)S, gin, (const uint8_t*)Q, (float*)out,
          (float*)((uint8_t*)scratch + sc.rowsum), tickets, N, n, m, sp.R,
          sp.UG, sp.J);
      return (int)cudaGetLastError();
    }
  } else {
    cudaError_t err = pack_gin((const uint8_t*)G, gin, P, m, st);
    if (err != cudaSuccess) return (int)err;
  }
  const bool in_smem = tiles_in_smem(L, w);
  const size_t smem = (size_t)small_bytes(L, w) + (in_smem ? L.tiles : 0);
  cudaError_t err;
#define FITNESS(SB, WB)                                                    \
  launch<SB, WB>(smem, (const float*)S, gin, (const uint8_t*)Q,           \
                 (float*)out, gtiles, P, N, n, m, st)
  if (w)
    err = in_smem ? FITNESS(true, true) : FITNESS(false, true);
  else
    err = in_smem ? FITNESS(true, false) : FITNESS(false, false);
#undef FITNESS
  return (int)err;
}
