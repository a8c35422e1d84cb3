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
//  * past n, m = 256 (kMaxDim) fitness_wide_kernel reads G's columns from
//    the scratch in place (m words(m) words may pass a block's shared
//    memory), and G is packed from device memory (fitness.cuh).
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

// Scratch of one call, in bytes: G's column bits, then (when the tiles do
// not fit in shared memory) one tile slice per CTA.
struct Scratch {
  size_t gin, total;
};

Scratch scratch_parts(int P, int N, int n, int m) {
  const Layout L = layout(n, m);
  Scratch s;
  s.gin = (size_t)align16(4 * m * L.W) * P;
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
  cudaError_t err = pack_gin((const uint8_t*)G, gin, P, m, st);
  if (err != cudaSuccess) return (int)err;
  const bool w = rt::wide(n, m);
  const bool in_smem = tiles_in_smem(L, w);
  const size_t smem = (size_t)small_bytes(L, w) + (in_smem ? L.tiles : 0);
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
