// Fused global pre-prune to fixpoint, batched over problems.
//
// Replaces the TPU kernel prune_fixpoint_pallas (src/repro/kernels/
// prune_fixpoint.py, bodies _prune_kernel and _fused_step). One iteration
// is an Ullmann sweep followed by singleton-row injectivity elimination;
// the loop runs while anything changes and the sweep budget holds, and
// reports the sweeps run.
//
// Bound on the H100: neither bytes (a 56x144 mask is 8 KB) nor operations
// (a sweep is ~40 k word ops); it is latency, a chain of dependent sweeps
// with block barriers in between. Design: one CTA per problem, everything
// in shared memory as bit rows (common.cuh), so a sweep is a few word ANDs
// per thread, and the convergence flag comes from __syncthreads_or. All
// of it is exact, so outputs are bitwise those of the integer form.
#include "common.cuh"

namespace {

template <typename MT>
__global__ void prune_kernel(const MT* __restrict__ mask,
                             const uint8_t* __restrict__ Q,
                             const uint8_t* __restrict__ G,
                             MT* __restrict__ out, int* __restrict__ sweeps,
                             int n, int m, int bound) {
  const int p = blockIdx.x;
  const int W = rt::words(m), Wn = rt::words(n);
  extern __shared__ uint32_t sm[];
  uint32_t* M = sm;                   // n * W
  uint32_t* Gout = M + n * W;         // m * W   bits v: G[j, v]
  uint32_t* Gin = Gout + m * W;       // m * W   bits v: G[v, j]
  uint32_t* Qrow = Gin + m * W;       // n * Wn  bits u: Q[i, u]
  uint32_t* Qcol = Qrow + n * Wn;     // n * Wn  bits u: Q[u, i]
  uint32_t* SO = Qcol + n * Wn;       // n * W
  uint32_t* SI = SO + n * W;          // n * W
  uint32_t* claimed = SI + n * W;     // W
  uint32_t* single = claimed + W;     // n   (row is a singleton)

  const MT* mk = mask + (size_t)p * n * m;
  const uint8_t* q = Q + (size_t)p * n * n;
  const uint8_t* g = G + (size_t)p * m * m;
  rt::pack_rows(mk, n, m, M);
  rt::pack_rows(g, m, m, Gout);
  rt::pack_cols(g, m, Gin);
  rt::pack_rows(q, n, n, Qrow);
  rt::pack_cols(q, n, Qcol);
  __syncthreads();

  int it = 0;
  bool changed;
  do {
    bool mine = rt::ullmann_sweep(M, Gout, Gin, Qrow, Qcol, SO, SI, n, m);
    // injectivity: a singleton row claims its column from every other row
    for (int w = threadIdx.x; w < W; w += blockDim.x) claimed[w] = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      single[i] = rt::popcount_row(M + i * W, W) == 1;
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * W; idx += blockDim.x) {
      const int i = idx / W;
      if (single[i] && M[idx]) atomicOr(&claimed[idx - i * W], M[idx]);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * W; idx += blockDim.x) {
      const int i = idx / W;
      if (!single[i]) {
        const uint32_t x = M[idx] & ~claimed[idx - i * W];
        mine |= (x != M[idx]);
        M[idx] = x;
      }
    }
    changed = __syncthreads_or(mine);
    ++it;
  } while (changed && it < bound);

  MT* o = out + (size_t)p * n * m;
  for (int idx = threadIdx.x; idx < n * m; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    o[idx] = rt::test_bit(M + i * W, j) ? MT(1) : MT(0);
  }
  if (threadIdx.x == 0) sweeps[p] = it;
}

size_t smem_bytes(int n, int m) {
  const int W = rt::words(m), Wn = rt::words(n);
  return sizeof(uint32_t) *
         (size_t)(4 * n * W + 2 * m * W + 2 * n * Wn + W + n);
}

template <typename MT>
int launch(const void* mask, const void* Q, const void* G, void* out,
           void* sweeps, int P, int n, int m, int max_iters, void* stream) {
  const int bound = max_iters > 0 ? max_iters : n * m + 1;
  const size_t smem = smem_bytes(n, m);
  cudaError_t err = rt::allow_smem((const void*)prune_kernel<MT>, smem);
  if (err != cudaSuccess) return (int)err;
  prune_kernel<MT><<<P, 256, smem, (cudaStream_t)stream>>>(
      (const MT*)mask, (const uint8_t*)Q, (const uint8_t*)G, (MT*)out,
      (int*)sweeps, n, m, bound);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prune_fixpoint_u8(const void* mask, const void* Q,
                                 const void* G, void* out, void* sweeps,
                                 int P, int n, int m, int max_iters,
                                 void* stream) {
  return launch<uint8_t>(mask, Q, G, out, sweeps, P, n, m, max_iters,
                         stream);
}

extern "C" int prune_fixpoint_i32(const void* mask, const void* Q,
                                  const void* G, void* out, void* sweeps,
                                  int P, int n, int m, int max_iters,
                                  void* stream) {
  return launch<int32_t>(mask, Q, G, out, sweeps, P, n, m, max_iters,
                         stream);
}
