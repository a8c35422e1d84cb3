// One Ullmann refinement sweep for a batch of candidate matrices:
//   M' = M * [ Q [M G^T == 0] + Q^T [M G == 0] == 0 ].
//
// Replaces the TPU kernel ullmann_refine_step_pallas (src/repro/kernels/
// ullmann_refine.py, body _refine_kernel), which runs the four 0/1 products
// on the MXU.
//
// Bound on the H100: at 56x144 a particle's four products are ~3.2 M 0/1
// multiply-adds against ~16 KB of bytes, so operations would bound a dense
// kernel. Design: one CTA per particle packs M, Q (rows and columns) and G
// (out and in) into bit rows in shared memory (common.cuh) and runs one
// rt::ullmann_sweep, where a support test is an AND of 32 columns at once
// and a violation test ANDs the supports of i's neighbours. The sweep
// computes the supports of every row before it changes any, the Jacobi
// semantics of the TPU kernel. The output keeps M's own entries where the
// sweep keeps the bit (entries of M are taken as non-negative, as the
// plain version's products need), so it equals the plain version exactly
// for any of M's dtypes.
#include "common.cuh"

namespace {

template <typename MT, typename QT, typename GT>
__global__ void refine_kernel(const MT* __restrict__ M,
                              const QT* __restrict__ Q,
                              const GT* __restrict__ G, MT* __restrict__ out,
                              int n, int m) {
  const int b = blockIdx.x;
  const int W = rt::words(m), Wn = rt::words(n);
  const size_t nm = (size_t)n * m;
  extern __shared__ uint32_t smu[];
  uint32_t* Mb = smu;                 // n * W
  uint32_t* Gout = Mb + n * W;        // m * W
  uint32_t* Gin = Gout + m * W;       // m * W
  uint32_t* Qrow = Gin + m * W;       // n * Wn
  uint32_t* Qcol = Qrow + n * Wn;     // n * Wn
  uint32_t* SO = Qcol + n * Wn;       // n * W
  uint32_t* SI = SO + n * W;          // n * W

  const MT* Mp = M + (size_t)b * nm;
  rt::pack_rows(Mp, n, m, Mb);
  rt::pack_rows(G, m, m, Gout);
  rt::pack_cols(G, m, Gin);
  rt::pack_rows(Q, n, n, Qrow);
  rt::pack_cols(Q, n, Qcol);
  __syncthreads();
  rt::ullmann_sweep(Mb, Gout, Gin, Qrow, Qcol, SO, SI, n, m);
  MT* o = out + (size_t)b * nm;
  for (int idx = threadIdx.x; idx < (int)nm; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    o[idx] = rt::test_bit(Mb + i * W, j) ? Mp[idx] : MT(0);
  }
}

size_t smem_bytes(int n, int m) {
  const int W = rt::words(m), Wn = rt::words(n);
  return sizeof(uint32_t) *
         (4 * (size_t)n * W + 2 * (size_t)m * W + 2 * (size_t)n * Wn);
}

template <typename MT, typename QT, typename GT>
int launch(const void* M, const void* Q, const void* G, void* out, int B,
           int n, int m, void* stream) {
  const size_t smem = smem_bytes(n, m);
  cudaError_t err =
      rt::allow_smem((const void*)refine_kernel<MT, QT, GT>, smem);
  if (err != cudaSuccess) return (int)err;
  refine_kernel<MT, QT, GT><<<B, 256, smem, (cudaStream_t)stream>>>(
      (const MT*)M, (const QT*)Q, (const GT*)G, (MT*)out, n, m);
  return (int)cudaGetLastError();
}

template <typename MT, typename QT>
int launch_g(int g_i32, const void* M, const void* Q, const void* G,
             void* out, int B, int n, int m, void* stream) {
  return g_i32 ? launch<MT, QT, int32_t>(M, Q, G, out, B, n, m, stream)
               : launch<MT, QT, uint8_t>(M, Q, G, out, B, n, m, stream);
}

template <typename MT>
int launch_qg(int q_i32, int g_i32, const void* M, const void* Q,
              const void* G, void* out, int B, int n, int m,
              void* stream) {
  return q_i32 ? launch_g<MT, int32_t>(g_i32, M, Q, G, out, B, n, m, stream)
               : launch_g<MT, uint8_t>(g_i32, M, Q, G, out, B, n, m, stream);
}

}  // namespace

// M, out: (B, n, m) uint8 (m_i32 = 0) or int32; Q (n, n) and G (m, m),
// shared by the batch, each uint8 or int32 (q_i32, g_i32).
extern "C" int ullmann_refine_step(const void* M, const void* Q,
                                   const void* G, void* out, int B, int n,
                                   int m, int m_i32, int q_i32, int g_i32,
                                   void* stream) {
  return m_i32 ? launch_qg<int32_t>(q_i32, g_i32, M, Q, G, out, B, n, m,
                                    stream)
               : launch_qg<uint8_t>(q_i32, g_i32, M, Q, G, out, B, n, m,
                                    stream);
}
