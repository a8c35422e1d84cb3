// The fused epoch tail: projections, Ullmann refinement, feasibility and
// the elite consensus, batched over problems.
//
// Replaces the TPU kernel epoch_finish_pallas (src/repro/kernels/
// finish_fused.py, bodies _finish_kernel, _batched_structured,
// _batched_greedy, _batched_sweep and _batched_feasible).
//
// Bound on the H100: latency. The two structured projections and the
// greedy projection are n sequential rounds each of a masked argmax over
// one row (or over the whole matrix), with block barriers in between; the
// bytes (one 32 KB S tile per particle) and the operations are small.
// Design: launch 1 runs one CTA per (problem, particle), with S in shared
// memory as f32 and every 0/1 matrix (mask, candidate set, Q, G) as bit
// rows, the assignments as one column index per row. A round is one pass
// of the columns over the threads plus one block argmax (ties to the
// lowest index, the jnp.argmax order). Launch 2 runs one small CTA per
// problem for the elite consensus S_bar: elite_k unrolled argmax rounds
// (ties to the lower index, as top_k), a softmax and the weighted sum.
// Integer outputs (M_hat, feasible) are exact; S_bar is float32 with
// another summation order than the plain version's einsum.
#include "common.cuh"

namespace {

struct Smem {
  float* S;          // n * m
  uint32_t* mask;    // n * W
  uint32_t* cand;    // n * W
  uint32_t* Gout;    // m * W
  uint32_t* Gin;     // m * W
  uint32_t* Qrow;    // n * Wn
  uint32_t* Qcol;    // n * Wn
  uint32_t* SO;      // n * W
  uint32_t* SI;      // n * W
  uint32_t* cols;    // W      free target columns
  uint32_t* rows;    // Wn     free query rows (greedy)
  int* asg_a;        // n
  int* asg_p;        // n
  int* asg_b;        // n
  int* colcnt;       // m
  float* red_v;      // 64
  int* red_i;        // 64
  int* flag;         // 4
};

__device__ Smem carve(void* base, int n, int m) {
  const int W = rt::words(m), Wn = rt::words(n);
  Smem s;
  s.S = static_cast<float*>(base);
  s.mask = reinterpret_cast<uint32_t*>(s.S + n * m);
  s.cand = s.mask + n * W;
  s.Gout = s.cand + n * W;
  s.Gin = s.Gout + m * W;
  s.Qrow = s.Gin + m * W;
  s.Qcol = s.Qrow + n * Wn;
  s.SO = s.Qcol + n * Wn;
  s.SI = s.SO + n * W;
  s.cols = s.SI + n * W;
  s.rows = s.cols + W;
  s.asg_a = reinterpret_cast<int*>(s.rows + Wn);
  s.asg_p = s.asg_a + n;
  s.asg_b = s.asg_p + n;
  s.colcnt = s.asg_b + n;
  s.red_v = reinterpret_cast<float*>(s.colcnt + m);
  s.red_i = reinterpret_cast<int*>(s.red_v + 64);
  s.flag = s.red_i + 64;
  return s;
}

size_t smem_bytes(int n, int m) {
  const int W = rt::words(m), Wn = rt::words(n);
  return 4 * ((size_t)n * m + 5 * (size_t)n * W + 2 * (size_t)m * W +
              2 * (size_t)n * Wn + W + Wn + 3 * n + m + 64 + 64 + 4);
}

// Scores of the structured projection: S itself, or the Gumbel-perturbed
// log S of the tau > 0 path (ref: log(clip(S, 1e-9)) + tau * gum).
struct PlainScore {
  const float* S;
  int m;
  __device__ float operator()(int i, int j) const { return S[i * m + j]; }
};

struct GumbelScore {
  const float* S;
  const float* gum;
  float tau;
  int m;
  __device__ float operator()(int i, int j) const {
    return logf(fmaxf(S[i * m + j], 1e-9f)) + tau * gum[i * m + j];
  }
};

// ref.structured_project for one particle. `avail` rows are the initial
// candidates; scores come from score(i, j). Writes asg[i] (-1: none).
// Requires blockDim.x >= m (one thread per target column).
template <typename Score>
__device__ void structured(const Smem& s, const uint32_t* avail, Score score,
                           int* asg, int n, int m) {
  const int W = rt::words(m), Wn = rt::words(n);
  const int j = threadIdx.x;
  rt::fill_bits(s.cols, m);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    float v = rt::kNeg;
    int idx = j < m ? j : INT32_MAX;
    if (j < m && rt::test_bit(avail + i * W, j) && rt::test_bit(s.cols, j)) {
      // every predecessor placed, and adjacent to j
      bool ok = true;
      for (int wu = 0; wu < Wn && ok; ++wu) {
        uint32_t preds = s.Qcol[i * Wn + wu];
        while (preds) {
          const int u = wu * 32 + __ffs(preds) - 1;
          preds &= preds - 1;
          const int a = asg[u];
          if (a < 0 || !rt::test_bit(s.Gout + a * W, j)) { ok = false; break; }
        }
      }
      if (ok) {
        // forward checking: free out-neighbours of j cover i's successors
        int free_out = 0;
        for (int w = 0; w < W; ++w) free_out += __popc(s.Gout[j * W + w] & s.cols[w]);
        ok = free_out >= rt::popcount_row(s.Qrow + i * Wn, Wn);
      }
      if (ok) v = score(i, j);
    }
    float best;
    int bj;
    rt::block_argmax(v, idx, s.red_v, s.red_i, &best, &bj);
    if (threadIdx.x == 0) {
      const bool took = best > rt::kNeg;
      asg[i] = took ? bj : -1;
      if (took) s.cols[bj >> 5] &= ~(1u << (bj & 31));
    }
    __syncthreads();
  }
}

// ref.is_feasible for a one-entry-per-row assignment (-1: empty row).
__device__ bool feasible(const Smem& s, const int* asg, int n, int m) {
  const int W = rt::words(m), Wn = rt::words(n);
  for (int j = threadIdx.x; j < m; j += blockDim.x) s.colcnt[j] = 0;
  if (threadIdx.x == 0) s.flag[0] = 1;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int a = asg[i];
    if (a < 0) { s.flag[0] = 0; continue; }
    if (atomicAdd(&s.colcnt[a], 1) > 0) s.flag[0] = 0;
  }
  __syncthreads();
  const bool rows_cols_ok = s.flag[0] != 0;
  __syncthreads();
  bool ok = true;
  if (rows_cols_ok) {
    for (int i = threadIdx.x; i < n && ok; i += blockDim.x) {
      for (int wu = 0; wu < Wn && ok; ++wu) {
        uint32_t succ = s.Qrow[i * Wn + wu];
        while (succ) {
          const int u = wu * 32 + __ffs(succ) - 1;
          succ &= succ - 1;
          if (!rt::test_bit(s.Gout + asg[i] * W, asg[u])) { ok = false; break; }
        }
      }
    }
  }
  return __syncthreads_and(ok) && rows_cols_ok;
}

__global__ void finish_kernel(const float* __restrict__ S_,
                              const float* __restrict__ gum,
                              const uint8_t* __restrict__ mask,
                              const uint8_t* __restrict__ Q,
                              const uint8_t* __restrict__ G,
                              uint8_t* __restrict__ M_hat,
                              uint8_t* __restrict__ feas_out, int N, int n,
                              int m, float gumbel_tau, float refine_threshold,
                              int refine_iters) {
  const int p = blockIdx.y, part = blockIdx.x;
  const int W = rt::words(m);
  const int nm = n * m;
  extern __shared__ float smf[];
  const Smem s = carve(smf, n, m);
  const size_t base = ((size_t)p * N + part) * nm;
  for (int idx = threadIdx.x; idx < nm; idx += blockDim.x)
    s.S[idx] = S_[base + idx];
  rt::pack_rows(mask + (size_t)p * nm, n, m, s.mask);
  rt::pack_rows(G + (size_t)p * m * m, m, m, s.Gout);
  rt::pack_cols(G + (size_t)p * m * m, m, s.Gin);
  rt::pack_rows(Q + (size_t)p * n * n, n, n, s.Qrow);
  rt::pack_cols(Q + (size_t)p * n * n, n, s.Qcol);
  __syncthreads();

  // 1. (Gumbel-perturbed) structured projection M_a
  const float* g = gum == nullptr ? nullptr : gum + base;
  const float tau = gumbel_tau;
  const float* Ss = s.S;
  if (tau > 0.0f)
    structured(s, s.mask, GumbelScore{Ss, g, tau, m}, s.asg_a, n, m);
  else
    structured(s, s.mask, PlainScore{Ss, m}, s.asg_a, n, m);
  const bool feas_a = feasible(s, s.asg_a, n, m);

  // 2. greedy projection M_proj: n rounds of a masked global argmax
  rt::greedy_assign(Ss, s.mask, s.rows, s.cols, s.asg_p, s.red_v, s.red_i,
                    n, m);

  // 3. candidate set, refine_iters Ullmann sweeps, structured re-projection
  for (int idx = threadIdx.x; idx < n * W; idx += blockDim.x) {
    const int i = idx / W, w = idx - i * W;
    float rowmax = Ss[i * m];
    for (int j = 1; j < m; ++j) rowmax = fmaxf(rowmax, Ss[i * m + j]);
    const float thr = refine_threshold * rowmax;
    uint32_t word = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = w * 32 + b;
      if (j >= m) break;
      if (Ss[i * m + j] >= thr || s.asg_p[i] == j) word |= 1u << b;
    }
    s.cand[idx] = word & s.mask[idx];
  }
  __syncthreads();
  for (int it = 0; it < refine_iters; ++it)
    rt::ullmann_sweep(s.cand, s.Gout, s.Gin, s.Qrow, s.Qcol, s.SO, s.SI, n, m);
  structured(s, s.cand, PlainScore{Ss, m}, s.asg_b, n, m);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (rt::popcount_row(s.cand + i * W, W) == 0) s.asg_b[i] = s.asg_p[i];
  __syncthreads();
  const bool feas_b = feasible(s, s.asg_b, n, m);

  // 4. merge
  const int* asg = feas_a ? s.asg_a : s.asg_b;
  uint8_t* out = M_hat + base;
  for (int idx = threadIdx.x; idx < nm; idx += blockDim.x) {
    const int i = idx / m;
    out[idx] = asg[i] == idx - i * m ? 1 : 0;
  }
  if (threadIdx.x == 0) feas_out[(size_t)p * N + part] = feas_a || feas_b;
}

// Elite consensus: one CTA per problem.
__global__ void consensus_kernel(const float* __restrict__ S,
                                 const float* __restrict__ f_final,
                                 float* __restrict__ S_bar, int N, int nm,
                                 int elite_k, float temp) {
  const int p = blockIdx.x;
  extern __shared__ float cs[];
  float* fw = cs;                  // N
  float* w = fw + N;               // elite_k
  int* top = reinterpret_cast<int*>(w + elite_k);   // elite_k
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    fw[i] = f_final[(size_t)p * N + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < elite_k; ++k) {
      int b = 0;
      for (int i = 1; i < N; ++i)
        if (fw[i] > fw[b]) b = i;
      top[k] = b;
      w[k] = fw[b];
      fw[b] = rt::kNeg;
    }
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
  for (int idx = threadIdx.x; idx < nm; idx += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < elite_k; ++k)
      acc = acc + w[k] * S[((size_t)p * N + top[k]) * nm + idx];
    S_bar[(size_t)p * nm + idx] = acc;
  }
}

}  // namespace

extern "C" int epoch_finish(const void* S, const void* f_final,
                            const void* gum, const void* mask, const void* Q,
                            const void* G, void* M_hat, void* feasible_out,
                            void* S_bar, int P, int N, int n, int m,
                            float gumbel_tau, float refine_threshold,
                            int refine_iters, int elite_k,
                            float consensus_temp, void* stream) {
  const size_t smem = smem_bytes(n, m);
  cudaError_t err = rt::allow_smem((const void*)finish_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = m <= 128 ? 128 : 256;
  dim3 grid(N, P);
  finish_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)gum, (const uint8_t*)mask,
      (const uint8_t*)Q, (const uint8_t*)G, (uint8_t*)M_hat,
      (uint8_t*)feasible_out, N, n, m, gumbel_tau, refine_threshold,
      refine_iters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t csmem = sizeof(float) * (size_t)(N + 2 * elite_k);
  consensus_kernel<<<P, 256, csmem, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)f_final, (float*)S_bar, N, n * m,
      elite_k, consensus_temp);
  return (int)cudaGetLastError();
}
