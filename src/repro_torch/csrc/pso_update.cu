// One PSO step for a batch of particles: velocity, clip, position, mask
// and row normalisation (paper Algorithm 1 lines 8-11).
//
// Replaces the TPU kernel pso_update_pallas (src/repro/kernels/
// pso_update.py, body _pso_update_kernel). The TPU kernel normalises a
// row by a reciprocal multiply; this one divides (IEEE), as ref.pso_update
// and the epoch kernel's step do. With -fmad=false and their order of
// operations (velocity terms and row sums left to right, a fully masked
// or empty row falling back to the uniform row) the three agree bit for
// bit. The step is written out here and in epoch_fused.cu alike: calling
// shared helpers from epoch_fused.cu's step kernel made it ~3% slower on
// an H100 (kernel_ab.py against the kernel written out).
//
// Bound on the H100: bytes. A particle reads S, V, S_local (and the shared
// S*, S-bar, mask) once and writes S and V once, ~15 fp32 operations an
// entry: at 56x144 that is 0.16 MB a particle against 0.12 MFLOP. Design:
// one CTA per particle; the unnormalised row block and its 0/1 mask wait
// in shared memory (odd row stride, so one thread per row sums without
// bank conflicts) between the elementwise pass, the left-to-right row
// sums and the division. Rows go in blocks of `R` rows so that any
// n, m <= 256 fits 48 KB; at the main shapes one block holds all rows.
#include "common.cuh"

namespace {

struct Hyper {
  float omega, c1, c2, c3, v_max;
};

template <typename MT>
__global__ void pso_update_kernel(
    const float* __restrict__ S, const float* __restrict__ V,
    const float* __restrict__ Sl, const float* __restrict__ Sstar,
    const float* __restrict__ Sbar, const MT* __restrict__ mask,
    const float* __restrict__ r, float* __restrict__ S_out,
    float* __restrict__ V_out, int n, int m, int R, Hyper h) {
  const int b = blockIdx.x;
  const size_t base = (size_t)b * n * m;
  const int ld = rt::odd_stride(m);
  extern __shared__ float smf[];
  float* St = smf;                                         // R * ld
  float* rowf = St + (size_t)R * ld;                       // R
  float* mrows = rowf + R;                                 // R
  uint8_t* mk = reinterpret_cast<uint8_t*>(mrows + R);     // R * m
  const float a1 = h.c1 * r[b * 3], a2 = h.c2 * r[b * 3 + 1],
              a3 = h.c3 * r[b * 3 + 2];

  for (int r0 = 0; r0 < n; r0 += R) {
    const int rows = min(R, n - r0);
    const size_t off = (size_t)r0 * m;
    for (int idx = threadIdx.x; idx < rows * m; idx += blockDim.x)
      mk[idx] = mask[off + idx] != 0;
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      int c = 0;
      for (int j = 0; j < m; ++j) c += mk[i * m + j];
      mrows[i] = (float)c;
    }
    // velocity, clip, position, mask (ref.pso_update, same op order)
    for (int idx = threadIdx.x; idx < rows * m; idx += blockDim.x) {
      const int i = idx / m, j = idx - i * m;
      const size_t g = base + off + idx;
      const float s = S[g];
      float v = h.omega * V[g];
      v = v + a1 * (Sl[g] - s);
      v = v + a2 * (Sstar[off + idx] - s);
      v = v + a3 * (Sbar[off + idx] - s);
      v = fminf(fmaxf(v, -h.v_max), h.v_max);
      V_out[g] = v;
      St[i * ld + j] = fmaxf(s + v, 0.0f) * (float)mk[idx];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) acc = acc + St[i * ld + j];
      rowf[i] = acc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * m; idx += blockDim.x) {
      const int i = idx / m, j = idx - i * m;
      const float rs = rowf[i];
      const float uni = (float)mk[idx] / fmaxf(mrows[i], 1.0f);
      S_out[base + off + idx] =
          rs > 1e-9f ? St[i * ld + j] / fmaxf(rs, 1e-9f) : uni;
    }
    __syncthreads();
  }
}

// Rows a block holds in 48 KB (at least one).
int block_rows(int n, int m) {
  const size_t per_row =
      sizeof(float) * ((size_t)rt::odd_stride(m) + 2) + (size_t)m;
  const int R = (int)((48 * 1024) / per_row);
  return R < 1 ? 1 : (R > n ? n : R);
}

template <typename MT>
int launch(const void* S, const void* V, const void* Sl, const void* Sstar,
           const void* Sbar, const void* mask, const void* r, void* S_out,
           void* V_out, int B, int n, int m, Hyper h, void* stream) {
  const int R = block_rows(n, m);
  const size_t smem =
      sizeof(float) * ((size_t)R * rt::odd_stride(m) + 2 * (size_t)R) +
      (size_t)R * m;
  pso_update_kernel<MT><<<B, 256, smem, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)V, (const float*)Sl,
      (const float*)Sstar, (const float*)Sbar, (const MT*)mask,
      (const float*)r, (float*)S_out, (float*)V_out, n, m, R, h);
  return (int)cudaGetLastError();
}

}  // namespace

// S, V, Sl, S_out, V_out: (B, n, m) f32; Sstar, Sbar: (n, m) f32 shared
// by the batch; mask: (n, m) uint8 (mask_i32 = 0) or int32; r: (B, 3) f32.
extern "C" int pso_update(const void* S, const void* V, const void* Sl,
                          const void* Sstar, const void* Sbar,
                          const void* mask, const void* r, void* S_out,
                          void* V_out, int B, int n, int m, int mask_i32,
                          float omega, float c1, float c2, float c3,
                          float v_max, void* stream) {
  const Hyper h{omega, c1, c2, c3, v_max};
  if (mask_i32)
    return launch<int32_t>(S, V, Sl, Sstar, Sbar, mask, r, S_out, V_out, B,
                           n, m, h, stream);
  return launch<uint8_t>(S, V, Sl, Sstar, Sbar, mask, r, S_out, V_out, B, n,
                         m, h, stream);
}
