// Fused VQ nearest-code lookup with EMA statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel ae_wavenet_tpu/ops/vq_pallas.py vq_lookup_fused
// (body _kernel).  For latents z [N, D] and a codebook e [K, D], both f32:
//   d[n][k] = |e_k|^2 - 2 z_n . e_k       (f32 FMA, j ascending; |z_n|^2 is
//                                          constant per row and left out)
//   codes[n] = argmin_k d[n][k]           (first index on ties)
//   quant[n] = e[codes[n]]                (the codebook row, bit for bit)
//   counts[k] = #{n : codes[n] = k}       (an exact integer in f32)
//   sums[k]   = sum of z_n over codes[n] = k, n ascending (f32)
// Neither the [N, K] distances nor a one-hot matrix reach device memory.
//
// What bounds it: at the model's shapes (N in the hundreds, K = 512, D = 64)
// the work is tens of MFLOP over well under 1 MB, so the launches themselves
// dominate.  Design: two kernels on one stream.  `vq_assign_kernel` gives
// each block ROWS rows of z in shared memory; each thread walks its codes
// (k = tid, tid + THREADS, ..., ascending, so a strict `<` keeps the first
// minimum), reading the code's row through L1/L2 with 16-byte loads, and the
// block reduces (distance, index) pairs with ties to the lower index.
// `vq_stats_kernel` gives each code one warp, which scans codes[] in order
// and adds the matching rows of z one by one: sums are reduced in a fixed
// order (the same bits on every run) without float atomics and without
// per-block partials.  The ragged last tile is masked in the kernel.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;    // rows of z per block
constexpr int MAX_D = 256;  // widest latent the per-lane sums hold

__device__ __forceinline__ bool better(float d, int k, float bd, int bk) {
  return d < bd || (d == bd && k < bk);
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
vq_assign_kernel(const float* __restrict__ z, const float* __restrict__ e,
                 int N, int K, int D, int* __restrict__ codes,
                 float* __restrict__ quant) {
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                          // [ROWS, D]
  float* best_d = zt + ROWS * D;             // [WARPS, ROWS]
  int* best_k = (int*)(best_d + WARPS * ROWS);  // [WARPS, ROWS]
  int* code_s = best_k + WARPS * ROWS;       // [ROWS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * ROWS;
  const int n_rows = min(ROWS, N - row0);

  for (int i = tid; i < ROWS * D; i += THREADS)
    zt[i] = i / D < n_rows ? z[(size_t)row0 * D + i] : 0.f;
  __syncthreads();

  float bd[ROWS];
  int bk[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) { bd[r] = FLT_MAX; bk[r] = INT_MAX; }
  for (int k = tid; k < K; k += THREADS) {
    const float* ek = e + (size_t)k * D;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    float e2 = 0.f;
    if constexpr (VEC4) {
      for (int j = 0; j < D; j += 4) {
        const float4 ev = __ldg(reinterpret_cast<const float4*>(ek + j));
        e2 = fmaf(ev.x, ev.x, e2);
        e2 = fmaf(ev.y, ev.y, e2);
        e2 = fmaf(ev.z, ev.z, e2);
        e2 = fmaf(ev.w, ev.w, e2);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 zv = *reinterpret_cast<const float4*>(zt + r * D + j);
          acc[r] = fmaf(zv.x, ev.x, acc[r]);
          acc[r] = fmaf(zv.y, ev.y, acc[r]);
          acc[r] = fmaf(zv.z, ev.z, acc[r]);
          acc[r] = fmaf(zv.w, ev.w, acc[r]);
        }
      }
    } else {
      for (int j = 0; j < D; ++j) {
        const float ev = __ldg(ek + j);
        e2 = fmaf(ev, ev, e2);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(zt[r * D + j], ev, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float d = __fsub_rn(e2, __fmul_rn(2.0f, acc[r]));
      if (d < bd[r]) { bd[r] = d; bk[r] = k; }  // k ascends: first minimum
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float d = bd[r];
    int k = bk[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, o);
      const int ok = __shfl_xor_sync(0xffffffffu, k, o);
      if (better(od, ok, d, k)) { d = od; k = ok; }
    }
    if (lane == 0) { best_d[warp * ROWS + r] = d; best_k[warp * ROWS + r] = k; }
  }
  __syncthreads();
  if (tid < ROWS) {
    float d = best_d[tid];
    int k = best_k[tid];
    for (int w = 1; w < WARPS; ++w)
      if (better(best_d[w * ROWS + tid], best_k[w * ROWS + tid], d, k)) {
        d = best_d[w * ROWS + tid];
        k = best_k[w * ROWS + tid];
      }
    if (k >= K) k = 0;  // no finite distance on this row
    code_s[tid] = k;
    if (tid < n_rows) codes[row0 + tid] = k;
  }
  __syncthreads();
  for (int i = tid; i < n_rows * D; i += THREADS)
    quant[(size_t)row0 * D + i] = e[(size_t)code_s[i / D] * D + i % D];
}

// One warp per code: counts[k] and sums[k] over the rows whose code is k,
// rows taken in ascending order.
__global__ void __launch_bounds__(THREADS)
vq_stats_kernel(const float* __restrict__ z, const int* __restrict__ codes,
                int N, int K, int D, float* __restrict__ counts,
                float* __restrict__ sums) {
  const int lane = threadIdx.x % 32;
  const int k = blockIdx.x * WARPS + threadIdx.x / 32;
  if (k >= K) return;
  float acc[MAX_D / 32];
#pragma unroll
  for (int j = 0; j < MAX_D / 32; ++j) acc[j] = 0.f;
  int count = 0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    unsigned hit = __ballot_sync(0xffffffffu, n < N && codes[n] == k);
    count += __popc(hit);
    while (hit) {
      const float* zr = z + (size_t)(n0 + __ffs(hit) - 1) * D;
      hit &= hit - 1;
#pragma unroll
      for (int j = 0; j < MAX_D / 32; ++j)
        if (lane + 32 * j < D) acc[j] += zr[lane + 32 * j];
    }
  }
  if (lane == 0) counts[k] = (float)count;
#pragma unroll
  for (int j = 0; j < MAX_D / 32; ++j)
    if (lane + 32 * j < D) sums[(size_t)k * D + lane + 32 * j] = acc[j];
}

}  // namespace

extern "C" {

// codes [N] int32, quant [N, D], counts [K], sums [K, D] from z [N, D] and
// the codebook e [K, D] (all f32, contiguous), on `stream`; with counts
// null the second kernel (counts and sums) is not launched.  Returns
// cudaGetLastError() (0 = ok).
int awt_vq_lookup(const void* z, const void* e, int N, int K, int D,
                  void* codes, void* quant, void* counts, void* sums,
                  void* stream) {
  if (N < 1 || K < 1 || D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)ROWS * D + WARPS * ROWS) +
                      sizeof(int) * (WARPS * ROWS + ROWS);
  const dim3 grid((N + ROWS - 1) / ROWS);
  const bool vec4 = D % 4 == 0;
  auto kernel = vec4 ? vq_assign_kernel<true> : vq_assign_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)e, N, K, D, (int*)codes, (float*)quant);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!counts) return 0;  // the caller reads neither counts nor sums
  vq_stats_kernel<<<(K + WARPS - 1) / WARPS, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const int*)codes, N, K, D, (float*)counts, (float*)sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
