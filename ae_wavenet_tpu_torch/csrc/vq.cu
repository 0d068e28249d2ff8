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
// What bounds it: at the model's shapes (N = 27 latents a serving request,
// 640 a training step; K = 512, D = 64) the work is at most 42 MFLOP over
// under 0.5 MB, well under a microsecond of the card's rates, so what a
// call costs is latency: the launch, round trips to L2, a barrier.
//
// Design: one launch per call, with or without the statistics.  Each block
// takes RB = ceil(N / SMs) consecutive rows (so N = 27 runs on 27 SMs and
// N = 640 on 128), in passes of RPT <= 8 rows of z staged in shared memory;
// each thread walks its codes (k = tid, tid + THREADS, ..., ascending, so a
// strict `<` keeps the first minimum; one code each at K = 512), reading
// the code's row through L1/L2 with 16-byte loads, four in flight at a
// time, and the block reduces (distance, index) pairs with ties to the
// lower index, then writes codes and quant.  With statistics the launch is
// cooperative: a barrier across the grid, then one warp per code scans
// codes[] in order and adds the matching rows of z in that order, so sums
// are reduced in a fixed order (the same bits on every run) without float
// atomics and without per-block partials.  Each block with codes first
// stages codes[] and z in shared memory, up to 160 KB of rows at a time:
// read from L2 one by one, the rows of a code that many latents chose
// (dozens at the training step) cost one round trip each.  What is left is
// that code's serial adds: its warp takes the longest.
// The barrier's two counters live in a small buffer the caller keeps per
// stream; every barrier leaves the arrival count at zero, so no call needs
// a reset.  The shared-memory limit is raised once per kernel and device.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#include <algorithm>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RPT = 8;     // rows of z per pass
constexpr int MAX_D = 256;     // widest latent the per-lane sums hold
constexpr int STAGE_BYTES = 160 * 1024;  // z and codes[] staged per chunk of rows
constexpr int MAX_DEV = 64;
constexpr long long SPIN_LIMIT = 1LL << 34;  // clock cycles (several seconds)

__device__ __forceinline__ bool better(float d, int k, float bd, int bk) {
  return d < bd || (d == bd && k < bk);
}

// Barrier across a cooperative grid on bar = {arrivals, generation}: the
// last block to arrive sets the arrivals back to zero before it moves the
// generation on, so the buffer is ready for the next barrier or call.  A
// barrier not met within seconds traps: a launch fault, not a wait.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* gen = bar + 1;
    unsigned g, now;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(g) : "l"(gen) : "memory");
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(gen) : "memory");
    } else {
      const long long t0 = clock64();
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(gen)
                     : "memory");
        if (clock64() - t0 > SPIN_LIMIT) __trap();
      } while (now == g);
    }
    __threadfence();
  }
  __syncthreads();
}

// codes and quant for this block's rows; with counts, the statistics after
// a barrier across the grid.
template <int RPT, bool VEC4>
__global__ void __launch_bounds__(THREADS)
vq_kernel(const float* __restrict__ z, const float* __restrict__ e, int N, int K, int D,
          int RB, int CH, int* codes, float* quant, float* counts, float* sums,
          unsigned* bar) {
  extern __shared__ __align__(16) float smem[];
  float* zt = smem;                             // [RPT, D]
  float* best_d = zt + RPT * D;                 // [WARPS, RPT]
  int* best_k = (int*)(best_d + WARPS * RPT);   // [WARPS, RPT]
  int* code_s = best_k + WARPS * RPT;           // [RPT]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row_hi = min(N, (int)blockIdx.x * RB + RB);

  for (int row0 = blockIdx.x * RB; row0 < row_hi; row0 += RPT) {
    const int n_rows = min(RPT, row_hi - row0);
    __syncthreads();  // the previous pass is done with zt and code_s
    for (int i = tid; i < RPT * D; i += THREADS)
      zt[i] = i / D < n_rows ? __ldg(z + (size_t)row0 * D + i) : 0.f;
    __syncthreads();

    float bd[RPT];
    int bk[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { bd[r] = FLT_MAX; bk[r] = INT_MAX; }
    for (int k = tid; k < K; k += THREADS) {
      const float* ek = e + (size_t)k * D;
      float acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
      float e2 = 0.f;
      if constexpr (VEC4) {
#pragma unroll 4
        for (int j = 0; j < D; j += 4) {
          const float4 ev = __ldg(reinterpret_cast<const float4*>(ek + j));
          e2 = fmaf(ev.x, ev.x, e2);
          e2 = fmaf(ev.y, ev.y, e2);
          e2 = fmaf(ev.z, ev.z, e2);
          e2 = fmaf(ev.w, ev.w, e2);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float4 zv = *reinterpret_cast<const float4*>(zt + r * D + j);
            acc[r] = fmaf(zv.x, ev.x, acc[r]);
            acc[r] = fmaf(zv.y, ev.y, acc[r]);
            acc[r] = fmaf(zv.z, ev.z, acc[r]);
            acc[r] = fmaf(zv.w, ev.w, acc[r]);
          }
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < D; ++j) {
          const float ev = __ldg(ek + j);
          e2 = fmaf(ev, ev, e2);
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[r] = fmaf(zt[r * D + j], ev, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float d = __fsub_rn(e2, __fmul_rn(2.0f, acc[r]));
        if (d < bd[r]) { bd[r] = d; bk[r] = k; }  // k ascends: first minimum
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float d = bd[r];
      int k = bk[r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, d, o);
        const int ok = __shfl_xor_sync(0xffffffffu, k, o);
        if (better(od, ok, d, k)) { d = od; k = ok; }
      }
      if (lane == 0) { best_d[warp * RPT + r] = d; best_k[warp * RPT + r] = k; }
    }
    __syncthreads();
    if (tid < RPT) {
      float d = best_d[tid];
      int k = best_k[tid];
      for (int w = 1; w < WARPS; ++w)
        if (better(best_d[w * RPT + tid], best_k[w * RPT + tid], d, k)) {
          d = best_d[w * RPT + tid];
          k = best_k[w * RPT + tid];
        }
      if (k >= K) k = 0;  // no finite distance on this row
      code_s[tid] = k;
      if (tid < n_rows) codes[row0 + tid] = k;
    }
    __syncthreads();
    for (int i = tid; i < n_rows * D; i += THREADS)
      quant[(size_t)row0 * D + i] = __ldg(e + (size_t)code_s[i / D] * D + i % D);
  }
  if (!counts) return;

  // statistics: codes[] is complete once every block has passed the barrier
  grid_sync(bar);
  if ((int)blockIdx.x * WARPS >= K) return;  // no code for this block's warps
  float* zs = smem;                             // [CH, D] rows of z (after the barrier)
  int* cs = reinterpret_cast<int*>(zs + (size_t)CH * D);  // [CH] their codes
  const int gw = blockIdx.x * WARPS + warp, tw = gridDim.x * WARPS;
  for (int it = 0; it * tw < K; ++it) {
    const int k = gw + it * tw;  // this warp's code (none past K)
    float acc[MAX_D / 32];
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j) acc[j] = 0.f;
    int count = 0;
    for (int c0 = 0; c0 < N; c0 += CH) {
      const int cn = min(CH, N - c0);
      if (it == 0 || N > CH) {  // uniform in the block: one chunk is staged once
        __syncthreads();
        // codes[] through L2 (other blocks wrote it)
        for (int i = tid; i < cn; i += THREADS) cs[i] = __ldcg(codes + c0 + i);
        if constexpr (VEC4) {
          const float4* src = reinterpret_cast<const float4*>(z + (size_t)c0 * D);
          for (int i = tid; i < cn * D / 4; i += THREADS)
            reinterpret_cast<float4*>(zs)[i] = __ldg(src + i);
        } else {
          for (int i = tid; i < cn * D; i += THREADS) zs[i] = __ldg(z + (size_t)c0 * D + i);
        }
        __syncthreads();
      }
      if (k >= K) continue;
      for (int n0 = 0; n0 < cn; n0 += 32) {
        const int n = n0 + lane;
        unsigned hit = __ballot_sync(0xffffffffu, n < cn && cs[n] == k);
        count += __popc(hit);
        while (hit) {
          const float* zr = zs + (size_t)(n0 + __ffs(hit) - 1) * D;
          hit &= hit - 1;
#pragma unroll
          for (int j = 0; j < MAX_D / 32; ++j)
            if (lane + 32 * j < D) acc[j] += zr[lane + 32 * j];
        }
      }
    }
    if (k >= K) continue;
    if (lane == 0) counts[k] = (float)count;
#pragma unroll
    for (int j = 0; j < MAX_D / 32; ++j)
      if (lane + 32 * j < D) sums[(size_t)k * D + lane + 32 * j] = acc[j];
  }
}

typedef void (*VqKernel)(const float*, const float*, int, int, int, int, int, int*,
                         float*, float*, float*, unsigned*);

template <bool VEC4>
VqKernel pick(int rpt) {
  switch (rpt) {
    case 1: return vq_kernel<1, VEC4>;
    case 2: return vq_kernel<2, VEC4>;
    case 4: return vq_kernel<4, VEC4>;
    default: return vq_kernel<MAX_RPT, VEC4>;
  }
}

// The kernel's shared-memory limit, raised to the most a launch asks
// (STAGE_BYTES and the rest) once per kernel and device.
cudaError_t allow_smem(VqKernel kernel, int dev) {
  static VqKernel done[MAX_DEV][8] = {};
  VqKernel* slot = nullptr;
  if (dev < MAX_DEV)
    for (int i = 0; i < 8 && !slot; ++i)
      if (done[dev][i] == kernel || !done[dev][i]) slot = &done[dev][i];
  if (slot && *slot == kernel) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES + 16 * 1024);
  if (err == cudaSuccess && slot) *slot = kernel;
  return err;
}

// SMs of the current device (dev), asked once per device
int sm_count(int dev) {
  static int sms[MAX_DEV] = {0};
  if (dev < 0) return -1;
  if (dev >= MAX_DEV) {
    int n = 0;
    return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess
               ? n : -1;
  }
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms[dev];
}

}  // namespace

extern "C" {

// codes [N] int32, quant [N, D], counts [K], sums [K, D] from z [N, D] and
// the codebook e [K, D] (all f32, contiguous), on `stream`, in one launch.
// With counts null, counts and sums are not computed; else bar is two
// unsigned ints that are zero before the first call on the stream (every
// call leaves its arrival count at zero).  Returns cudaGetLastError()
// (0 = ok).
int awt_vq_lookup(const void* z, const void* e, int N, int K, int D, void* codes,
                  void* quant, void* counts, void* sums, void* bar, void* stream) {
  if (N < 1 || K < 1 || D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (counts && (!sums || !bar)) return (int)cudaErrorInvalidValue;
  int dev = -1;
  cudaError_t err = cudaGetDevice(&dev);
  const int sms = err == cudaSuccess ? sm_count(dev) : -1;
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int rb = (N + sms - 1) / sms;  // rows per block
  const int grid = (N + rb - 1) / rb;
  const int rpt = rb > 4 ? MAX_RPT : rb > 2 ? 4 : rb;  // one pass up to 8 rows
  const int ch = counts ? std::min(N, STAGE_BYTES / (4 * (D + 1))) : 0;  // staged rows
  const size_t smem = std::max(
      sizeof(float) * ((size_t)rpt * D + WARPS * rpt) + sizeof(int) * (WARPS * rpt + rpt),
      sizeof(float) * (size_t)ch * (D + 1));
  const VqKernel kernel = D % 4 == 0 ? pick<true>(rpt) : pick<false>(rpt);
  if ((err = allow_smem(kernel, dev)) != cudaSuccess) return (int)err;
  const float* zf = (const float*)z;
  const float* ef = (const float*)e;
  if (!counts) {
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        zf, ef, N, K, D, rb, 0, (int*)codes, (float*)quant, nullptr, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  // the statistics wait at a barrier across the grid: every block resident
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, zf, ef, N, K, D, rb, ch, (int*)codes,
                           (float*)quant, (float*)counts, (float*)sums, (unsigned*)bar);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
