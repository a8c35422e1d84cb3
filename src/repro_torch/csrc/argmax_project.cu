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
// masked_argmax. Bound on the H100: launch latency (one CTA reads at most
// 256 KB of X). One CTA of 1,024 threads scans the entries (masked ones
// count as finfo(float32).min, like the plain version), X in 16-byte
// loads where it is aligned, and reduces with warp shuffles around a
// single barrier: the first maximum in row-major order, and (f32 min, 0)
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

// The better of two (value, index) candidates: the larger value, ties to
// the smaller index.
__device__ __forceinline__ void keep_better(float& v, int& vi, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < vi)) { v = ov; vi = oi; }
}

// Entry f of the scan, in increasing f within a thread: the thread's first
// maximum, masked entries at f32 min.
__device__ __forceinline__ void scan_entry(float& v, int& vi, float x,
                                           bool keep, int f) {
  const float y = keep ? x : rt::kNeg;
  if (y > v || vi == INT32_MAX) { v = y; vi = f; }
}

// Bit k set iff mask entry 4g + k is non-zero, from one 4-byte (uint8)
// or 16-byte (int32) load.
__device__ __forceinline__ uint32_t mask_group(const uint8_t* mask, int g) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(mask)[g];
  return ((w & 0xffu) != 0) | (((w & 0xff00u) != 0) << 1) |
         (((w & 0xff0000u) != 0) << 2) | (((w & 0xff000000u) != 0) << 3);
}
__device__ __forceinline__ uint32_t mask_group(const int32_t* mask, int g) {
  const int4 w = reinterpret_cast<const int4*>(mask)[g];
  return (w.x != 0) | ((w.y != 0) << 1) | ((w.z != 0) << 2) |
         ((w.w != 0) << 3);
}

// One CTA: X as float4 and the mask in groups of four where both pointers
// are aligned for that, a scalar tail (or a scalar scan when they are
// not), then warp shuffles and one barrier.
template <typename MT>
__global__ void masked_argmax_kernel(const float* __restrict__ X,
                                     const MT* __restrict__ mask,
                                     float* __restrict__ val,
                                     int* __restrict__ idx_out, int nm) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  float v = rt::kNeg;
  int vi = INT32_MAX;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(X) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(mask) & (4 * sizeof(MT) - 1)) == 0;
  const int groups = aligned ? nm >> 2 : 0;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const float4 x = reinterpret_cast<const float4*>(X)[g];
    const uint32_t k = mask_group(mask, g);
    scan_entry(v, vi, x.x, k & 1u, 4 * g);
    scan_entry(v, vi, x.y, k & 2u, 4 * g + 1);
    scan_entry(v, vi, x.z, k & 4u, 4 * g + 2);
    scan_entry(v, vi, x.w, k & 8u, 4 * g + 3);
  }
  for (int f = 4 * groups + threadIdx.x; f < nm; f += blockDim.x)
    scan_entry(v, vi, X[f], mask[f] != 0, f);
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1)
    keep_better(v, vi, __shfl_down_sync(full, v, off),
                __shfl_down_sync(full, vi, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red_v[warp] = v; red_i[warp] = vi; }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? red_v[lane] : rt::kNeg;
    vi = lane < nwarps ? red_i[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1)
      keep_better(v, vi, __shfl_down_sync(full, v, off),
                  __shfl_down_sync(full, vi, off));
    if (lane == 0) { *val = v; *idx_out = vi; }
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

// X: (n*m) f32, mask: (n*m) bytes (mask_i32 = 0; uint8 or bool) or int32
// → val (f32), idx (int32).
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
