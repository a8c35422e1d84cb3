// Greedy argmax projection and the masked global argmax.
//
// Replaces the TPU kernels greedy_project_pallas (_project_kernel) and
// masked_argmax_pallas (_masked_argmax_kernel) in src/repro/kernels/
// argmax_project.py: the comparator tree of the paper's accelerator.
//
// greedy_project. Bound on the H100: latency. Each of the n picks is a
// masked argmax over the entries left that depends on the previous pick,
// so a particle is a chain of up to n dependent rounds; its bytes (one S
// read, one M-hat written) and its compares are small. Design: one CTA per
// particle. Its threads stage the mask's 0/1 bytes and S in shared memory,
// S where it fits (32 KB at 56x144, up to 200x220; past that the chain
// reads it from device memory, where L1 and L2 hold it), in one loop whose
// loads are all in flight at once; then a warp a row packs the mask
// lane-transposed (rt::pack_rows_t's layout) and seeds the row's best
// masked column (value, then the lower column) as a cache. Warp 0 then
// runs rt::greedy_warp, the chain of the fused epoch tail
// (finish_fused.cu): a round is one warp argmax over the rows' cached
// bests plus a rescan of the rows whose cached column was just taken,
// with no block barrier, and it stops at the first round that takes
// nothing. The other warps zero M-hat with 16-byte stores meanwhile; the
// ones follow from the assignment.
//
// Past n, m = 256 (rt::wide) a wide instantiation of two launches takes
// the projection, with the wide bit planes of common.cuh (a lane's bits
// of a row in 32-bit words, where the narrow chain's free columns and
// mask rows are one byte a lane). Launch 1 packs the mask's wide
// transposed rows once into device scratch, over as many CTAs as its
// words need. Launch 2, one CTA per particle, copies them beside the
// chain's state in
// shared memory where they fit (else reads them in place), and S after
// them where it fits too (else the chain reads S from device memory,
// where L1 and L2 hold it); a warp a row seeds the cache, and warp 0 runs
// rt::wgreedy, greedy_warp's chain on wide rows (the one the fused epoch
// tail runs past 256), while the others zero M-hat.
//
// masked_argmax. Bound on the H100: launch latency up to n, m = 256 (one
// CTA reads at most 256 KB of X), past it the one SM's read rate. One
// CTA of 1,024 threads scans the entries (masked ones
// count as finfo(float32).min, like the plain version), X in 16-byte
// loads where it is aligned, and reduces with warp shuffles around a
// single barrier: the first maximum in row-major order, and (f32 min, 0)
// for an empty mask. A thread with no entry holds (f32 min, INT32_MAX),
// which a finite entry beats or ties and wins on its smaller index.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kGreedyThreads = 256;
constexpr size_t kSmemMax = 232448;    // 227 KB a block on the H100

// Bytes of shared memory before S: maskT (32 n); gv, gj and asg (n
// each); the mask's 0/1 bytes (n m).
__host__ __device__ inline size_t greedy_fixed(int n, int m) {
  return (size_t)rt::align16(32 * n) + rt::align16(12 * n) +
         rt::align16(n * m);
}

template <typename MT, bool SMEM>
__global__ void __launch_bounds__(kGreedyThreads)
greedy_kernel(const float* __restrict__ S, const MT* __restrict__ mask,
              uint8_t* __restrict__ out, int n, int m) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int nm = n * m;
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* maskT = sm;                                        // 32 n
  float* gv = reinterpret_cast<float*>(sm + rt::align16(32 * n));   // n
  int* gj = reinterpret_cast<int*>(gv + n);                         // n
  int* asg = gj + n;                                                // n
  uint8_t* mk = sm + rt::align16(32 * n) + rt::align16(12 * n);     // nm
  float* Ss = reinterpret_cast<float*>(sm + greedy_fixed(n, m));    // nm
  const float* Sg = S + (size_t)blockIdx.x * nm;
#pragma unroll 4
  for (int e = tid; e < nm; e += nt) {
    mk[e] = mask[e] != 0;
    if (SMEM) Ss[e] = Sg[e];
  }
  __syncthreads();
  const float* Sp = SMEM ? Ss : Sg;
  // a warp a row: its mask bits and its best masked column
  for (int i = warp; i < n; i += nwarps) {
    uint32_t byte = 0;
    float v = rt::kNeg;
    int vi = INT32_MAX;
#pragma unroll
    for (int k = 0; k < rt::kLaneBits; ++k) {
      const int j = lane + 32 * k;
      if (j < m && mk[i * m + j]) {
        const float s = Sp[i * m + j];
        byte |= 1u << k;
        if (s > v) { v = s; vi = j; }
      }
    }
    maskT[i * 32 + lane] = (uint8_t)byte;
    rt::warp_argmax(v, vi);
    if (lane == 0) {
      gv[i] = v;
      gj[i] = vi;
    }
  }
  __syncthreads();
  uint8_t* o = out + (size_t)blockIdx.x * nm;
  if (warp == 0) {
    rt::greedy_warp(Sp, n, m, maskT, gv, gj, asg);
  } else {                       // M-hat's zeros, beside the chain
    if ((reinterpret_cast<uintptr_t>(o) & 15u) == 0 && (nm & 15) == 0) {
      for (int w = tid - 32; w < nm / 16; w += nt - 32)
        reinterpret_cast<uint4*>(o)[w] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int e = tid - 32; e < nm; e += nt - 32) o[e] = 0;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt)
    if (asg[i] >= 0) o[i * m + asg[i]] = 1;
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
    const uint32_t k = rt::mask_group(mask, g);
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

// ---- greedy_project's wide instantiation ----

constexpr int kWidePackThreads = 256;

// Bytes of a wide greedy CTA's chain state before the mask's planes: gv,
// gj and asg (n each), the free columns (one plane a lane).
__host__ __device__ inline size_t wgreedy_fixed(int n, int m) {
  return rt::align16z(12ull * n) + rt::align16z(128ull * rt::lane_words(m));
}

// Launch 1: the mask's wide transposed rows, by every thread of the grid.
template <typename MT>
__global__ void __launch_bounds__(kWidePackThreads)
pack_mask_wide_kernel(const MT* __restrict__ mask,
                      uint32_t* __restrict__ maskT, int n, int m) {
  rt::wpack_rows(mask, n, m, maskT, blockIdx.x * blockDim.x + threadIdx.x,
                 gridDim.x * blockDim.x);
}

// Launch 2: one particle (blockIdx.x). place bit 0: the mask's planes are
// copied into shared memory, bit 1: S too.
__global__ void __launch_bounds__(kGreedyThreads)
greedy_wide_kernel(const float* __restrict__ S,
                   const uint32_t* __restrict__ maskT_g,
                   uint8_t* __restrict__ out, int n, int m, int place) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int LW = rt::lane_words(m), per = 32 * LW;
  const size_t nm = (size_t)n * m, mask_bytes = 4ull * n * per;
  extern __shared__ __align__(16) uint8_t sm[];
  float* gv = reinterpret_cast<float*>(sm);                          // n
  int* gj = reinterpret_cast<int*>(gv + n);                          // n
  int* asg = gj + n;                                                 // n
  uint32_t* freeT = reinterpret_cast<uint32_t*>(sm + rt::align16z(12ull * n));
  size_t at = wgreedy_fixed(n, m);
  const uint32_t* maskT = maskT_g;
  if (place & 1) {
    rt::copy_bytes(sm + at, reinterpret_cast<const uint8_t*>(maskT_g),
                   (int)mask_bytes);
    maskT = reinterpret_cast<const uint32_t*>(sm + at);
    at += rt::align16z(mask_bytes);
  }
  const float* Sp = S + blockIdx.x * nm;
  if (place & 2) {
    float* Ss = reinterpret_cast<float*>(sm + at);
    for (size_t e = tid; e < nm; e += nt) Ss[e] = Sp[e];
    Sp = Ss;
  }
  __syncthreads();
  // a warp a row: its best masked column (value, then the lower column)
  for (int i = warp; i < n; i += nwarps) {
    float v = rt::kNeg;
    int vi = INT32_MAX;
    for (int w = 0; w < LW; ++w) {
      uint32_t mk = maskT[(size_t)i * per + w * 32 + lane];
      while (mk) {                   // the lane's columns, ascending
        const int j = rt::wcol(lane, w, __ffs(mk) - 1);
        mk &= mk - 1;
        const float s = Sp[(size_t)i * m + j];
        if (s > v) { v = s; vi = j; }
      }
    }
    rt::warp_argmax(v, vi);
    if (lane == 0) {
      gv[i] = v;
      gj[i] = vi;
    }
  }
  __syncthreads();
  uint8_t* o = out + blockIdx.x * nm;
  if (warp == 0) {
    rt::wgreedy(Sp, n, m, LW, maskT, gv, gj, freeT, asg);
  } else {                       // M-hat's zeros, beside the chain
    if ((reinterpret_cast<uintptr_t>(o) & 15u) == 0 && (nm & 15) == 0) {
      for (size_t w = tid - 32; w < nm / 16; w += nt - 32)
        reinterpret_cast<uint4*>(o)[w] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (size_t e = tid - 32; e < nm; e += nt - 32) o[e] = 0;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt)
    if (asg[i] >= 0) o[(size_t)i * m + asg[i]] = 1;
}

// What of a wide greedy CTA is in shared memory (WPlace::bits as
// greedy_wide_kernel reads them) and its bytes.
struct WPlace {
  int bits;
  size_t smem;
};

WPlace wplace(int n, int m) {
  const size_t mask_bytes = 4ull * n * 32 * rt::lane_words(m);
  const size_t s_bytes = 4ull * n * m;
  WPlace w{0, wgreedy_fixed(n, m)};
  if (w.smem + rt::align16z(mask_bytes) <= kSmemMax) {
    w.bits = 1;
    w.smem += rt::align16z(mask_bytes);
    if (w.smem + s_bytes <= kSmemMax) {
      w.bits |= 2;
      w.smem += s_bytes;
    }
  }
  return w;
}

template <typename MT>
int launch_greedy_wide(const void* S, const void* mask, void* out,
                       void* scratch, int B, int n, int m,
                       cudaStream_t st) {
  const size_t words = (size_t)n * 32 * rt::lane_words(m);
  const int ctas = (int)std::min<size_t>(
      (words + kWidePackThreads - 1) / kWidePackThreads, 1024);
  pack_mask_wide_kernel<MT><<<ctas, kWidePackThreads, 0, st>>>(
      (const MT*)mask, (uint32_t*)scratch, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const WPlace w = wplace(n, m);
  err = rt::allow_smem((const void*)greedy_wide_kernel, w.smem);
  if (err != cudaSuccess) return (int)err;
  greedy_wide_kernel<<<B, kGreedyThreads, w.smem, st>>>(
      (const float*)S, (const uint32_t*)scratch, (uint8_t*)out, n, m,
      w.bits);
  return (int)cudaGetLastError();
}

template <typename MT>
int launch_greedy(const void* S, const void* mask, void* out, void* scratch,
                  int B, int n, int m, void* stream) {
  if (rt::wide(n, m))
    return launch_greedy_wide<MT>(S, mask, out, scratch, B, n, m,
                                  (cudaStream_t)stream);
  const size_t fixed = greedy_fixed(n, m), s_bytes = sizeof(float) * n * m;
  const bool in_smem = fixed + s_bytes <= kSmemMax;
  const size_t smem = fixed + (in_smem ? s_bytes : 0);
  const void* kern = in_smem ? (const void*)greedy_kernel<MT, true>
                             : (const void*)greedy_kernel<MT, false>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
#define GREEDY(SMEM)                                                       \
  greedy_kernel<MT, SMEM><<<B, kGreedyThreads, smem, st>>>(                \
      (const float*)S, (const MT*)mask, (uint8_t*)out, n, m)
  if (in_smem)
    GREEDY(true);
  else
    GREEDY(false);
#undef GREEDY
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of device scratch that greedy_project needs for these shapes:
// none on the narrow path, the mask's wide transposed rows on the wide
// one.
extern "C" long long greedy_project_scratch_bytes(int n, int m) {
  if (!rt::wide(n, m)) return 0;
  return 4ll * n * 32 * rt::lane_words(m);
}

// S: (B, n, m) f32; mask: (n, m) uint8 (mask_i32 = 0) or int32, shared by
// the batch; out: (B, n, m) uint8; scratch holds
// greedy_project_scratch_bytes bytes.
extern "C" int greedy_project(const void* S, const void* mask, void* out,
                              void* scratch, int B, int n, int m,
                              int mask_i32, void* stream) {
  return mask_i32 ? launch_greedy<int32_t>(S, mask, out, scratch, B, n, m,
                                           stream)
                  : launch_greedy<uint8_t>(S, mask, out, scratch, B, n, m,
                                           stream);
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
