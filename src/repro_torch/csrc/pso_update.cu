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
// one warp per (particle, row), so that a call at (64, 56, 144) is 3,584
// warps in one wave over the card, each with its row's loads in flight at
// once (16-byte loads where m % 4 == 0 and every pointer is 16-byte
// aligned, 4-byte ones otherwise; the shared S*, S-bar and mask rows stay
// in L2 across particles). A lane keeps its entries in registers and
// counts its mask entries as an integer (exact in any order); the warp's
// unnormalised row waits in its own slice of shared memory while lane 0
// sums it strictly left to right (the plain version's seq_sum order, so
// no tree), then every lane divides its entries and stores them.
//
// Past m = 256 columns (n does not bound the narrow kernel) a wide
// instantiation takes the row: still a warp per (particle, row), lane l
// taking the entries l + 32 k in a runtime loop with 4-byte loads. The
// unnormalised row waits in the warp's slice of m floats of shared
// memory where a CTA's slices fit (m <= 14,528), else in S_out itself;
// lane 0 sums it left to right as above, and every lane divides its
// entries, read back with the mask.
// The same operations in the same order, so the same bits.
#include "common.cuh"

namespace {

constexpr int kRowFloats = rt::kMaxDim;   // a warp's slice of shared memory
// Warps (rows) a CTA. A sweep of 1, 2, 4, 8 and 16 on the H100 (PERF.md)
// put 2 and 4 within 0.5% of each other at (64, 56, 144), all five within 7%.
constexpr int kCtaWarps = 4;

struct Hyper {
  float omega, c1, c2, c3, v_max;
};

// One entry: the new velocity (into v_out) and the unnormalised masked
// position, in ref.pso_update's order of operations.
__device__ __forceinline__ float step(float s, float v0, float sl, float st,
                                      float sb, bool keep, const Hyper& h,
                                      float a1, float a2, float a3,
                                      float& v_out) {
  float v = h.omega * v0;
  v = v + a1 * (sl - s);
  v = v + a2 * (st - s);
  v = v + a3 * (sb - s);
  v = fminf(fmaxf(v, -h.v_max), h.v_max);
  v_out = v;
  return fmaxf(s + v, 0.0f) * (keep ? 1.0f : 0.0f);
}

// Row `row` = b * n + i of the batch, one warp. VEC: m % 4 == 0 and every
// pointer aligned, lane l owning the 4-entry groups l and l + 32;
// otherwise lane l owns the entries l + 32 k.
template <typename MT, bool VEC>
__global__ void pso_update_kernel(
    const float* __restrict__ S, const float* __restrict__ V,
    const float* __restrict__ Sl, const float* __restrict__ Sstar,
    const float* __restrict__ Sbar, const MT* __restrict__ mask,
    const float* __restrict__ r, float* __restrict__ S_out,
    float* __restrict__ V_out, int rows, int n, int m, Hyper h) {
  extern __shared__ __align__(16) float stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;                  // the whole warp
  const int b = row / n, i = row - b * n;
  const size_t g = (size_t)row * m, s = (size_t)i * m;
  float* x = stage + warp * kRowFloats;
  const float a1 = h.c1 * r[b * 3], a2 = h.c2 * r[b * 3 + 1],
              a3 = h.c3 * r[b * 3 + 2];
  constexpr int kPer = VEC ? 8 : rt::kLaneBits;   // entries a lane holds
  float xs[kPer];
  uint32_t keep = 0;                        // bit e for entry e of xs
  int cnt = 0;
  if (VEC) {
    const int m4 = m >> 2;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = lane + 32 * k;
      if (q < m4) {
        const float4 s4 = reinterpret_cast<const float4*>(S + g)[q];
        const float4 v4 = reinterpret_cast<const float4*>(V + g)[q];
        const float4 l4 = reinterpret_cast<const float4*>(Sl + g)[q];
        const float4 t4 = reinterpret_cast<const float4*>(Sstar + s)[q];
        const float4 b4 = reinterpret_cast<const float4*>(Sbar + s)[q];
        const uint32_t mk = rt::mask_group(mask + s, q);
        float4 vo, xo;
        xo.x = step(s4.x, v4.x, l4.x, t4.x, b4.x, mk & 1u, h, a1, a2, a3,
                    vo.x);
        xo.y = step(s4.y, v4.y, l4.y, t4.y, b4.y, mk & 2u, h, a1, a2, a3,
                    vo.y);
        xo.z = step(s4.z, v4.z, l4.z, t4.z, b4.z, mk & 4u, h, a1, a2, a3,
                    vo.z);
        xo.w = step(s4.w, v4.w, l4.w, t4.w, b4.w, mk & 8u, h, a1, a2, a3,
                    vo.w);
        reinterpret_cast<float4*>(V_out + g)[q] = vo;
        reinterpret_cast<float4*>(x)[q] = xo;
        xs[4 * k] = xo.x;
        xs[4 * k + 1] = xo.y;
        xs[4 * k + 2] = xo.z;
        xs[4 * k + 3] = xo.w;
        keep |= mk << (4 * k);
        cnt += __popc(mk);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      if (j < m) {
        const bool mk = mask[s + j] != 0;
        float vo;
        xs[k] = step(S[g + j], V[g + j], Sl[g + j], Sstar[s + j],
                     Sbar[s + j], mk, h, a1, a2, a3, vo);
        V_out[g + j] = vo;
        x[j] = xs[k];
        keep |= (uint32_t)mk << k;
        cnt += mk;
      }
    }
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  __syncwarp();
  float rs = 0.0f;
  if (lane == 0) {                          // strictly left to right
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int q = 0; q < (m >> 2); ++q) {
      const float4 t = x4[q];
      rs = rs + t.x;
      rs = rs + t.y;
      rs = rs + t.z;
      rs = rs + t.w;
    }
    for (int j = m & ~3; j < m; ++j) rs = rs + x[j];
  }
  rs = __shfl_sync(0xffffffffu, rs, 0);
  // the row over its clamped sum, or the uniform row (mask over its
  // clamped count): one division an entry either way
  const bool pos = rs > 1e-9f;
  const float den = pos ? fmaxf(rs, 1e-9f) : fmaxf((float)cnt, 1.0f);
#define OUT(e) ((pos ? xs[e] : (float)((keep >> (e)) & 1u)) / den)
  if (VEC) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = lane + 32 * k;
      if (q < (m >> 2))
        reinterpret_cast<float4*>(S_out + g)[q] =
            make_float4(OUT(4 * k), OUT(4 * k + 1), OUT(4 * k + 2),
                        OUT(4 * k + 3));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + 32 * k;
      if (j < m) S_out[g + j] = OUT(k);
    }
  }
#undef OUT
}

// The wide instantiation (see the head of the file): row `row` = b * n + i
// of the batch, one warp; x is the warp's slice of shared memory when
// in_smem, else the row of S_out.
template <typename MT>
__global__ void pso_update_wide_kernel(
    const float* __restrict__ S, const float* __restrict__ V,
    const float* __restrict__ Sl, const float* __restrict__ Sstar,
    const float* __restrict__ Sbar, const MT* __restrict__ mask,
    const float* __restrict__ r, float* S_out, float* __restrict__ V_out,
    int rows, int n, int m, Hyper h, bool in_smem) {
  extern __shared__ __align__(16) float stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;                  // the whole warp
  const int b = row / n, i = row - b * n;
  const size_t g = (size_t)row * m, s = (size_t)i * m;
  float* x = in_smem ? stage + (size_t)warp * m : S_out + g;
  const float a1 = h.c1 * r[b * 3], a2 = h.c2 * r[b * 3 + 1],
              a3 = h.c3 * r[b * 3 + 2];
  int cnt = 0;
  for (int j = lane; j < m; j += 32) {
    const bool mk = mask[s + j] != 0;
    float vo;
    x[j] = step(S[g + j], V[g + j], Sl[g + j], Sstar[s + j], Sbar[s + j],
                mk, h, a1, a2, a3, vo);
    V_out[g + j] = vo;
    cnt += mk;
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  __syncwarp();
  float rs = 0.0f;
  if (lane == 0)                            // strictly left to right
    for (int j = 0; j < m; ++j) rs = rs + x[j];
  rs = __shfl_sync(0xffffffffu, rs, 0);
  const bool pos = rs > 1e-9f;
  const float den = pos ? fmaxf(rs, 1e-9f) : fmaxf((float)cnt, 1.0f);
  for (int j = lane; j < m; j += 32)
    S_out[g + j] = (pos ? x[j] : (float)(mask[s + j] != 0)) / den;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename MT>
int launch(const void* S, const void* V, const void* Sl, const void* Sstar,
           const void* Sbar, const void* mask, const void* r, void* S_out,
           void* V_out, int B, int n, int m, Hyper h, void* stream) {
  const int rows = B * n;
  const int ctas = (rows + kCtaWarps - 1) / kCtaWarps;
  if (m > rt::kMaxDim) {
    const size_t wsmem = sizeof(float) * (size_t)m * kCtaWarps;
    const bool in_smem = wsmem <= rt::kSmemMax;
    const size_t smem = in_smem ? wsmem : 0;
    const cudaError_t err =
        rt::allow_smem((const void*)pso_update_wide_kernel<MT>, smem);
    if (err != cudaSuccess) return (int)err;
    pso_update_wide_kernel<MT><<<ctas, 32 * kCtaWarps, smem,
                                 (cudaStream_t)stream>>>(
        (const float*)S, (const float*)V, (const float*)Sl,
        (const float*)Sstar, (const float*)Sbar, (const MT*)mask,
        (const float*)r, (float*)S_out, (float*)V_out, rows, n, m, h,
        in_smem);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * kRowFloats * kCtaWarps;
  const bool vec =
      (m & 3) == 0 && aligned16(S) && aligned16(V) && aligned16(Sl) &&
      aligned16(Sstar) && aligned16(Sbar) && aligned16(S_out) &&
      aligned16(V_out) &&
      (reinterpret_cast<uintptr_t>(mask) & (4 * sizeof(MT) - 1)) == 0;
#define PSO_LAUNCH(VEC)                                                    \
  pso_update_kernel<MT, VEC><<<ctas, 32 * kCtaWarps, smem,                 \
                               (cudaStream_t)stream>>>(                    \
      (const float*)S, (const float*)V, (const float*)Sl,                  \
      (const float*)Sstar, (const float*)Sbar, (const MT*)mask,            \
      (const float*)r, (float*)S_out, (float*)V_out, rows, n, m, h)
  if (vec)
    PSO_LAUNCH(true);
  else
    PSO_LAUNCH(false);
#undef PSO_LAUNCH
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
