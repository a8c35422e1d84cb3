// Greedy argmax projection and the masked global argmax.
//
// Replaces the TPU kernels greedy_project_pallas (_project_kernel) and
// masked_argmax_pallas (_masked_argmax_kernel) in src/repro/kernels/
// argmax_project.py: the comparator tree of the paper's accelerator.
//
// greedy_project. Bound on the H100: latency. Each of the n picks is a
// masked argmax over all n*m entries that depends on the previous pick,
// so a particle is a chain of n block-wide reductions; its bytes (one S
// read, one M-hat written) and its n*n*m compares are small. Design: one
// CTA per particle runs rt::greedy_assign (common.cuh, the same chain as
// the fused epoch tail) over the flat index i*m + j with ties to the
// smallest index, the mask and the free rows and columns as bit rows in
// shared memory. S waits in shared memory when it fits (32 KB at 56x144);
// at larger shapes (256 KB at 256x256) the picks read it from global
// memory, where L1 and L2 hold it between rounds.
//
// masked_argmax. One CTA scans the entries (masked ones count as
// finfo(float32).min, like the plain version) and reduces with
// rt::block_argmax: the first maximum in row-major order, and (f32 min, 0)
// for an empty mask. A thread with no entry holds (f32 min, INT32_MAX),
// which a finite entry beats or ties and wins on its smaller index.
#include "common.cuh"

namespace {

// S in shared memory up to this many bytes of dynamic shared memory.
constexpr size_t kSmemCap = 160 * 1024;

size_t bits_bytes(int n, int m) {
  const int W = rt::words(m), Wn = rt::words(n);
  return sizeof(uint32_t) * ((size_t)n * W + W + Wn) + sizeof(int) * n +
         (sizeof(float) + sizeof(int)) * 33;
}

template <typename MT>
__global__ void greedy_kernel(const float* __restrict__ S,
                              const MT* __restrict__ mask,
                              uint8_t* __restrict__ out, int n, int m,
                              int s_in_smem) {
  const int b = blockIdx.x;
  const int W = rt::words(m), Wn = rt::words(n);
  const size_t nm = (size_t)n * m;
  extern __shared__ uint32_t smu[];
  uint32_t* mbits = smu;                                     // n * W
  uint32_t* cols = mbits + n * W;                            // W
  uint32_t* rows = cols + W;                                 // Wn
  int* asg = reinterpret_cast<int*>(rows + Wn);              // n
  float* red_v = reinterpret_cast<float*>(asg + n);          // 33
  int* red_i = reinterpret_cast<int*>(red_v + 33);           // 33
  float* Ss = reinterpret_cast<float*>(red_i + 33);          // n * m

  const float* Sp = S + (size_t)b * nm;
  rt::pack_rows(mask, n, m, mbits);
  if (s_in_smem) {
    for (int idx = threadIdx.x; idx < (int)nm; idx += blockDim.x)
      Ss[idx] = Sp[idx];
    Sp = Ss;
  }
  __syncthreads();
  rt::greedy_assign(Sp, mbits, rows, cols, asg, red_v, red_i, n, m);
  uint8_t* o = out + (size_t)b * nm;
  for (int idx = threadIdx.x; idx < (int)nm; idx += blockDim.x) {
    const int i = idx / m;
    o[idx] = asg[i] == idx - i * m ? 1 : 0;
  }
}

template <typename MT>
__global__ void masked_argmax_kernel(const float* __restrict__ X,
                                     const MT* __restrict__ mask,
                                     float* __restrict__ val,
                                     int* __restrict__ idx_out, int nm) {
  __shared__ float red_v[33];
  __shared__ int red_i[33];
  float v = rt::kNeg;
  int vi = INT32_MAX;
  for (int f = threadIdx.x; f < nm; f += blockDim.x) {
    const float x = mask[f] != 0 ? X[f] : rt::kNeg;
    if (x > v || vi == INT32_MAX) { v = x; vi = f; }
  }
  float best;
  int bf;
  rt::block_argmax(v, vi, red_v, red_i, &best, &bf);
  if (threadIdx.x == 0) {
    *val = best;
    *idx_out = bf;
  }
}

template <typename MT>
int launch_greedy(const void* S, const void* mask, void* out, int B, int n,
                  int m, void* stream) {
  const size_t s_bytes = sizeof(float) * (size_t)n * m;
  const int s_in_smem = bits_bytes(n, m) + s_bytes <= kSmemCap;
  const size_t smem = bits_bytes(n, m) + (s_in_smem ? s_bytes : 0);
  cudaError_t err = rt::allow_smem((const void*)greedy_kernel<MT>, smem);
  if (err != cudaSuccess) return (int)err;
  greedy_kernel<MT><<<B, 256, smem, (cudaStream_t)stream>>>(
      (const float*)S, (const MT*)mask, (uint8_t*)out, n, m, s_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// S: (B, n, m) f32; mask: (n, m) uint8 (mask_i32 = 0) or int32, shared by
// the batch; out: (B, n, m) uint8.
extern "C" int greedy_project(const void* S, const void* mask, void* out,
                              int B, int n, int m, int mask_i32,
                              void* stream) {
  return mask_i32 ? launch_greedy<int32_t>(S, mask, out, B, n, m, stream)
                  : launch_greedy<uint8_t>(S, mask, out, B, n, m, stream);
}

// X: (n*m) f32, mask: (n*m) uint8 or int32 → val (f32), idx (int32).
extern "C" int masked_argmax(const void* X, const void* mask, void* val,
                             void* idx, int nm, int mask_i32, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (mask_i32)
    masked_argmax_kernel<int32_t><<<1, 1024, 0, st>>>(
        (const float*)X, (const int32_t*)mask, (float*)val, (int*)idx, nm);
  else
    masked_argmax_kernel<uint8_t><<<1, 1024, 0, st>>>(
        (const float*)X, (const uint8_t*)mask, (float*)val, (int*)idx, nm);
  return (int)cudaGetLastError();
}
