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
// finished on all N particles. The Pallas layout kept all N particles in
// VMEM; here one particle's S, V and S_local at 56x144 f32 already take
// 97 KB, and a grid of P*N particle CTAs cannot all be resident, so a
// software barrier across CTAs could deadlock. Design (b): per inner step
// one launch of a (N, P) grid, one CTA per particle, then one launch of a
// tiny (P,) grid that selects each problem's global best. The kernel
// boundary is the barrier; particle state stays in device memory (L2
// holds the ~50 MB of a burst). One C call issues all 2K launches on the
// caller's stream. Each step is bound by the fp32 (or int32) fitness on
// CUDA cores, with the row-sum chains as the latency floor.
//
// Numerics: -fmad=false and the plain version's order of operations
// (left-to-right sums, IEEE division, rintf for round-half-even) make the
// kernel agree with kernels/epoch_fused.py's plain version bit for bit.
#include "fitness.cuh"

namespace {

struct Hyper {
  float omega, c1, c2, c3, v_max;
};

__global__ void step_kernel(float* __restrict__ S, float* __restrict__ V,
                            float* __restrict__ Sl, float* __restrict__ fl,
                            float* __restrict__ fcur,
                            const float* __restrict__ Sstar,
                            const float* __restrict__ Sbar,
                            const uint8_t* __restrict__ mask,
                            const uint8_t* __restrict__ Q,
                            const uint8_t* __restrict__ G,
                            const float* __restrict__ r_all, int N, int n,
                            int m, int K, int k, Hyper h, int quantized) {
  const int p = blockIdx.y, part = blockIdx.x;
  const int W = rt::words(m), nm = n * m;
  const int ld = rt::odd_stride(m), ldn = rt::odd_stride(n);
  extern __shared__ long long sm64[];
  long long* part_sums = sm64;                                   // 32
  uint32_t* Gin = reinterpret_cast<uint32_t*>(sm64 + 32);        // m * W
  float* St = reinterpret_cast<float*>(Gin + m * W);             // n * ld
  int* Sq = reinterpret_cast<int*>(St);                          // aliases St
  float* SG = St + n * ld;                                       // n * ld
  float* R2 = SG + n * ld;                                       // n * ldn
  float* rowf = R2 + n * ldn;                                    // n
  int* rowi = reinterpret_cast<int*>(rowf + n);                  // n
  float* mrows = reinterpret_cast<float*>(rowi + n);             // n
  float* bcast = mrows + n;                                      // 1
  uint8_t* mk = reinterpret_cast<uint8_t*>(bcast + 1);           // n * m
  uint8_t* q = mk + nm;                                          // n * n

  const size_t pb = (size_t)p * nm;
  const size_t base = ((size_t)p * N + part) * nm;
  rt::pack_cols(G + (size_t)p * m * m, m, Gin);
  for (int idx = threadIdx.x; idx < nm; idx += blockDim.x)
    mk[idx] = mask[pb + idx] != 0;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    q[idx] = Q[(size_t)p * n * n + idx];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int c = 0;
    for (int j = 0; j < m; ++j) c += mk[i * m + j];
    mrows[i] = (float)c;
  }

  // velocity, clip, position, mask (ref.pso_update, same op order)
  const float* r = r_all + (((size_t)p * K + k) * N + part) * 3;
  const float a1 = h.c1 * r[0], a2 = h.c2 * r[1], a3 = h.c3 * r[2];
  for (int idx = threadIdx.x; idx < nm; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    const float s = S[base + idx];
    float v = h.omega * V[base + idx];
    v = v + a1 * (Sl[base + idx] - s);
    v = v + a2 * (Sstar[pb + idx] - s);
    v = v + a3 * (Sbar[pb + idx] - s);
    v = fminf(fmaxf(v, -h.v_max), h.v_max);
    V[base + idx] = v;
    St[i * ld + j] = fmaxf(s + v, 0.0f) * (float)mk[idx];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) acc = acc + St[i * ld + j];
    rowf[i] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nm; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    const float rs = rowf[i];
    const float uni = (float)mk[idx] / fmaxf(mrows[i], 1.0f);
    const float s = rs > 1e-9f ? St[i * ld + j] / fmaxf(rs, 1e-9f) : uni;
    if (quantized)   // quantize_s, in place
      Sq[i * ld + j] = (int)fminf(fmaxf(rintf(s * 255.0f), 0.0f), 255.0f);
    else
      St[i * ld + j] = s;
  }
  __syncthreads();
  if (quantized) {
    // straight-through requantize: Q1.15 reciprocal renormalisation,
    // dequantize, then the fitness's own quantize_s
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int c = 0;
      for (int j = 0; j < m; ++j) c += Sq[i * ld + j];
      rowi[i] = c;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nm; idx += blockDim.x) {
      const int i = idx / m, j = idx - i * m;
      const int row = rowi[i];
      int sq;
      if (row > 0) {
        const int recip = (int)rintf(32768.0f / (float)max(row, 1));
        const int prod = Sq[i * ld + j] * recip * 255;
        sq = mk[idx] ? min(max((prod + (1 << 14)) >> 15, 0), 255) : 0;
      } else {
        const int mr = (int)mrows[i];
        sq = mk[idx] ? min(max(255 / max(mr, 1), 1), 255) : 0;
      }
      const float s = (float)sq / 255.0f;
      S[base + idx] = s;
      Sq[i * ld + j] = (int)fminf(fmaxf(rintf(s * 255.0f), 0.0f), 255.0f);
    }
  } else {
    for (int idx = threadIdx.x; idx < nm; idx += blockDim.x)
      S[base + idx] = St[idx / m * ld + idx % m];
  }
  __syncthreads();

  const float f =
      quantized
          ? rt::fitness_u8(Sq, reinterpret_cast<int*>(SG), part_sums, bcast,
                           Gin, q, n, m, ld, 255) / 4228250625.0f
          : rt::fitness_f32(St, SG, R2, rowf, bcast, Gin, q, n, m, ld, ldn);
  // local best (only this CTA touches its particle's S_local and f_local)
  const size_t pi = (size_t)p * N + part;
  if (f > fl[pi])
    for (int idx = threadIdx.x; idx < nm; idx += blockDim.x)
      Sl[base + idx] = S[base + idx];
  __syncthreads();
  if (threadIdx.x == 0) {
    fl[pi] = fmaxf(f, fl[pi]);
    fcur[pi] = f;
  }
}

// Global best of each problem: the first argmax of the local bests.
__global__ void select_kernel(const float* __restrict__ Sl,
                              const float* __restrict__ fl,
                              float* __restrict__ Sstar,
                              float* __restrict__ fstar,
                              float* __restrict__ trace, int N, int nm,
                              int K, int k) {
  const int p = blockIdx.x;
  __shared__ int best;
  if (threadIdx.x == 0) {
    const float* f = fl + (size_t)p * N;
    int b = 0;
    for (int i = 1; i < N; ++i)
      if (f[i] > f[b]) b = i;
    const bool better = f[b] > fstar[p];
    if (better) fstar[p] = f[b];
    trace[(size_t)p * K + k] = fstar[p];
    best = better ? b : -1;
  }
  __syncthreads();
  if (best >= 0) {
    const float* src = Sl + ((size_t)p * N + best) * nm;
    for (int idx = threadIdx.x; idx < nm; idx += blockDim.x)
      Sstar[(size_t)p * nm + idx] = src[idx];
  }
}

size_t smem_bytes(int n, int m) {
  const int W = rt::words(m), ld = rt::odd_stride(m);
  return sizeof(long long) * 32 +
         sizeof(uint32_t) * ((size_t)m * W + 2 * (size_t)n * ld +
                             (size_t)n * rt::odd_stride(n) + 3 * n + 1) +
         (size_t)n * m + (size_t)n * n;
}

}  // namespace

// All K steps of one epoch: 2K launches on `stream`. S, V, Sl, fl, fcur,
// Sstar, fstar hold the initial state and are updated in place.
extern "C" int epoch_fused(void* S, void* V, void* Sl, void* fl, void* fcur,
                           void* Sstar, void* fstar, const void* Sbar,
                           const void* mask, const void* Q, const void* G,
                           const void* r_all, void* trace, int P, int N,
                           int n, int m, int K, float omega, float c1,
                           float c2, float c3, float v_max, int quantized,
                           void* stream) {
  const size_t smem = smem_bytes(n, m);
  cudaError_t err = rt::allow_smem((const void*)step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Hyper h{omega, c1, c2, c3, v_max};
  const cudaStream_t st = (cudaStream_t)stream;
  for (int k = 0; k < K; ++k) {
    step_kernel<<<dim3(N, P), 256, smem, st>>>(
        (float*)S, (float*)V, (float*)Sl, (float*)fl, (float*)fcur,
        (const float*)Sstar, (const float*)Sbar, (const uint8_t*)mask,
        (const uint8_t*)Q, (const uint8_t*)G, (const float*)r_all, N, n, m,
        K, k, h, quantized);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    select_kernel<<<P, 256, 0, st>>>((const float*)Sl, (const float*)fl,
                                     (float*)Sstar, (float*)fstar,
                                     (float*)trace, N, n * m, K, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
