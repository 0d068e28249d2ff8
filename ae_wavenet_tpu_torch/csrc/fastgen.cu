// Fused autoregressive WaveNet sampler for Hopper (sm_90a), bf16 weights.
//
// Replaces the TPU kernel ae_wavenet_tpu/ops/fastgen_pallas.py
// generate_fused (body _make_kernel): one launch generates T samples; each
// step embeds the previous id, runs every gated layer with its ring-buffer
// queue, the post-net, and Gumbel-max (or greedy) sampling.
//
// Contract (identical to the TPU kernel, including where bf16 rounding
// happens):
//   x = f32(embed[prev]); skip = 0
//   per layer l: slot = off[l] + (t0 + t) % d[l]
//     x_prev = ring[slot] (bf16); ring[slot] = bf16(x)      (read, then write)
//     y  = [x_prev | bf16(x) | cond_t] . W_in + b_in        (f32 accumulate)
//     h  = tanh(y[:n_dil]) * sigmoid(y[n_dil:])
//     rs = bf16(h) . W_out + b_out                           (f32 accumulate)
//     x += rs[:n_res]; skip += rs[n_res:]
//   logits = bf16(relu(bf16(relu(skip)) . P1 + b1)) . P2 + b2
//   id = argmax(logits)                      temperature 0, first index on ties
//   id = argmax(logits / T + g),  g = -log(-log(u + 1e-12) + 1e-12),
//        u = (bits >> 8) * 2^-24, bits from Philox4x32-10 with key (seed, 0)
//        and counter (column / 4, row, t0 + t, 0), word column % 4.
//
// What bounds it: every step must read all layer weights (25.6 MB in bf16
// at the flagship width) because the AR dependency allows no reuse across
// steps; they fit the H100's 50 MB L2, so after the first step they come
// from L2.  One SM alone pulls them far too slowly (a first design with one
// block per 8 rows measured about 4 ms per step), so the design spreads
// each step over a cluster of CL = 8 blocks:
//   * batch rows are independent for the whole rollout: each cluster owns
//     BT = 8 rows and loops over all T steps, with no synchronisation
//     between clusters;
//   * inside a cluster, block r computes the r-th slice of the output
//     columns of every GEMM, so it reads only 1/8 of the weights per step,
//     and pushes its slice of each activation (x_prev and bf16(x), h, the
//     post-net inputs, the per-slice argmax) into every block's shared
//     memory (distributed shared memory), followed by a cluster barrier;
//   * within a block the GEMM's reduction dimension is split across
//     threads, each loading 16 bytes (8 columns) per weight row so that
//     many loads are in flight, and each weight element serves BT rows.
// Widths that are not multiples of 8 * CL take a scalar-load path.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 8;          // batch rows per cluster
constexpr int CL = 8;          // blocks per cluster (column slices)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 8;      // column groups per GEMM pass (threads % 8)
constexpr int KLANES = THREADS / GROUPS;  // reduction lanes (threads / 8)
constexpr int MAX_LAYERS = 64;

struct RingMeta {
  int off[MAX_LAYERS];
  int dil[MAX_LAYERS];
};

struct Dims {
  int B, T, L, n_res, n_dil, n_skp, n_post, n_quant, n_cond;
  int nv_max;  // widest per-block column slice of any GEMM
};

struct Slice {
  int lo, hi;
  __device__ int n() const { return hi - lo; }
};

__device__ __forceinline__ Slice slice_of(int n, int r) {
  return Slice{n * r / CL, n * (r + 1) / CL};
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Philox4x32-10 (Salmon et al., SC'11), the Random123 round function.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k.x += W0; k.y += W1; }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float gumbel(uint32_t seed, int row, int t_abs,
                                        int col) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)(col >> 2), (uint32_t)row, (uint32_t)t_abs, 0u),
      make_uint2(seed, 0u));
  const int w = col & 3;
  const uint32_t bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return -logf(-logf(u + 1e-12f) + 1e-12f);
}

template <int VW>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float* w) {
  if constexpr (VW == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      w[2 * e] = f.x;
      w[2 * e + 1] = f.y;
    }
  } else {
    static_assert(VW == 1, "column groups are 8 (16-byte loads) or 1");
    w[0] = __bfloat162float(p[0]);
  }
}

// red[b][v] = sum_k in[b][k] * W[k][col(v)] for this block's BT rows and
// its virtual columns v in [0, n1 + n2): col(v) = c1 + v for v < n1, else
// c2 + v - n1.  VW consecutive columns per thread group (VW = 8 takes
// 16-byte loads: needs c1, c2, n1, n2 and ldw multiples of 8).  The k
// dimension is split over KLANES lanes, reduced by shuffles inside a warp
// and through `part` [WARPS][BT][nv_max] across warps.
template <int VW>
__device__ void slice_gemm(const float* in, int k_len,
                           const __nv_bfloat16* __restrict__ W, int ldw,
                           int c1, int n1, int c2, int n2, float* part,
                           float* red, int nv_max) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g_in = tid % GROUPS, kl = tid / GROUPS;
  const int nv = n1 + n2, n_groups = nv / VW;
  for (int g0 = 0; g0 < n_groups; g0 += GROUPS) {
    const int g = g0 + g_in;
    const bool active = g < n_groups;
    const int v0 = g * VW;
    const int col = v0 < n1 ? c1 + v0 : c2 + (v0 - n1);
    float acc[BT][VW];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[b][e] = 0.f;
    if (active) {
      const __nv_bfloat16* wp = W + col;
#pragma unroll 4
      for (int k = kl; k < k_len; k += KLANES) {
        float w[VW];
        load_cols<VW>(wp + (size_t)k * ldw, w);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xv = in[b * k_len + k];
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
        }
      }
    }
    // lanes l, l+8, l+16, l+24 of a warp hold the same columns
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        float a = acc[b][e];
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        acc[b][e] = a;
      }
    if (lane < GROUPS && active) {
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          part[(warp * BT + b) * nv_max + v0 + e] = acc[b][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < BT * nv; i += THREADS) {
    const int b = i / nv, v = i % nv;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(w * BT + b) * nv_max + v];
    red[b * nv_max + v] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void gemm(bool vec, const float* in, int k_len,
                                     const __nv_bfloat16* __restrict__ W,
                                     int ldw, int c1, int n1, int c2, int n2,
                                     float* part, float* red, int nv_max) {
  if (vec)
    slice_gemm<8>(in, k_len, W, ldw, c1, n1, c2, n2, part, red, nv_max);
  else
    slice_gemm<1>(in, k_len, W, ldw, c1, n1, c2, n2, part, red, nv_max);
}

// Store v at offset i of buffer `buf` in the shared memory of every block
// of the cluster (including this one).
__device__ __forceinline__ void push_all(cg::cluster_group& cluster,
                                         float* buf, int i, float v) {
#pragma unroll
  for (int q = 0; q < CL; ++q) cluster.map_shared_rank(buf, q)[i] = v;
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
fastgen_bf16_kernel(const __nv_bfloat16* __restrict__ w_in,   // [L, xin, 2*n_dil]
                    const float* __restrict__ b_in,           // [L, 2*n_dil]
                    const __nv_bfloat16* __restrict__ w_out,  // [L, n_dil, n_res+n_skp]
                    const float* __restrict__ b_out,          // [L, n_res+n_skp]
                    const __nv_bfloat16* __restrict__ embed,  // [n_quant, n_res]
                    const __nv_bfloat16* __restrict__ p1w,    // [n_skp, n_post]
                    const float* __restrict__ p1b,            // [n_post]
                    const __nv_bfloat16* __restrict__ p2w,    // [n_post, n_quant]
                    const float* __restrict__ p2b,            // [n_quant]
                    const __nv_bfloat16* __restrict__ cond,   // [T, B, n_cond]
                    const int* __restrict__ prev_id,          // [B]
                    __nv_bfloat16* __restrict__ ring,         // [sum d, B, n_res]
                    int* __restrict__ ids,                    // [B, T]
                    int* __restrict__ last_id,                // [B]
                    float* __restrict__ logits_out,           // [T, B, n_quant] or null
                    Dims D, RingMeta meta, int t0, uint32_t seed,
                    float inv_temp, int greedy, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * BT;
  const int tid = threadIdx.x;
  const int xin_len = 2 * D.n_res + D.n_cond;
  const int n_out = D.n_res + D.n_skp;
  const int nvm = D.nv_max;

  extern __shared__ float smem[];
  float* x = smem;                       // [BT, n_res]   (own slice used)
  float* skip = x + BT * D.n_res;        // [BT, n_skp]   (own slice used)
  float* xin = skip + BT * D.n_skp;      // [BT, xin_len] (pushed by all)
  float* hb = xin + BT * xin_len;        // [BT, n_dil]   (pushed by all)
  float* pb = hb + BT * D.n_dil;         // [BT, n_skp]   (pushed by all)
  float* p1 = pb + BT * D.n_skp;         // [BT, n_post]  (pushed by all)
  float* part = p1 + BT * D.n_post;      // [WARPS, BT, nv_max]
  float* red = part + WARPS * BT * nvm;  // [BT, nv_max]
  float* cand_v = red + BT * nvm;        // [CL, BT] (pushed by all)
  int* cand_i = (int*)(cand_v + CL * BT);  // [CL, BT] (pushed by all)
  int* prev = cand_i + CL * BT;            // [BT]

  const Slice rs = slice_of(D.n_res, rank), ss = slice_of(D.n_skp, rank);
  const Slice ds = slice_of(D.n_dil, rank), ps = slice_of(D.n_post, rank);
  const Slice qs = slice_of(D.n_quant, rank);

  if (tid < BT) prev[tid] = row0 + tid < D.B ? prev_id[row0 + tid] : 0;
  cluster.sync();  // every block of the cluster is running before any push

  for (int t = 0; t < D.T; ++t) {
    const int t_abs = t0 + t;
    for (int i = tid; i < BT * rs.n(); i += THREADS) {
      const int b = i / rs.n(), c = rs.lo + i % rs.n();
      x[b * D.n_res + c] =
          __bfloat162float(embed[(size_t)prev[b] * D.n_res + c]);
    }
    for (int i = tid; i < BT * ss.n(); i += THREADS) {
      const int b = i / ss.n(), c = ss.lo + i % ss.n();
      skip[b * D.n_skp + c] = 0.f;
    }
    for (int i = tid; i < BT * D.n_cond; i += THREADS) {
      const int b = i / D.n_cond, c = i % D.n_cond, row = row0 + b;
      xin[b * xin_len + 2 * D.n_res + c] =
          row < D.B ? __bfloat162float(cond[((size_t)t * D.B + row) * D.n_cond + c])
                    : 0.f;
    }
    __syncthreads();

    for (int l = 0; l < D.L; ++l) {
      // ring queue, own res slice: read x_prev, then store bf16(x)
      const int slot = meta.off[l] + t_abs % meta.dil[l];
      for (int i = tid; i < BT * rs.n(); i += THREADS) {
        const int b = i / rs.n(), c = rs.lo + i % rs.n(), row = row0 + b;
        const __nv_bfloat16 xb = __float2bfloat16(x[b * D.n_res + c]);
        float xp = 0.f;
        if (row < D.B) {
          __nv_bfloat16* p = ring + ((size_t)slot * D.B + row) * D.n_res + c;
          xp = __bfloat162float(*p);
          *p = xb;
        }
        push_all(cluster, xin, b * xin_len + c, xp);
        push_all(cluster, xin, b * xin_len + D.n_res + c, __bfloat162float(xb));
      }
      cluster.sync();

      // gate GEMM over own filter columns ds and the matching gate columns
      gemm(vec, xin, xin_len, w_in + (size_t)l * xin_len * 2 * D.n_dil,
           2 * D.n_dil, ds.lo, ds.n(), D.n_dil + ds.lo, ds.n(), part, red, nvm);
      const float* bl = b_in + (size_t)l * 2 * D.n_dil;
      for (int i = tid; i < BT * ds.n(); i += THREADS) {
        const int b = i / ds.n(), jj = i % ds.n(), j = ds.lo + jj;
        const float yf = red[b * nvm + jj] + bl[j];
        const float yg = red[b * nvm + ds.n() + jj] + bl[D.n_dil + j];
        const float sig = 1.f / (1.f + expf(-yg));
        push_all(cluster, hb, b * D.n_dil + j, round_bf16(tanhf(yf) * sig));
      }
      cluster.sync();

      // residual + skip GEMM over own res and skip columns
      gemm(vec, hb, D.n_dil, w_out + (size_t)l * D.n_dil * n_out, n_out,
           rs.lo, rs.n(), D.n_res + ss.lo, ss.n(), part, red, nvm);
      const float* bo = b_out + (size_t)l * n_out;
      for (int i = tid; i < BT * (rs.n() + ss.n()); i += THREADS) {
        const int b = i / (rs.n() + ss.n()), v = i % (rs.n() + ss.n());
        const float val = red[b * nvm + v];
        if (v < rs.n()) x[b * D.n_res + rs.lo + v] += val + bo[rs.lo + v];
        else {
          const int c = ss.lo + v - rs.n();
          skip[b * D.n_skp + c] += val + bo[D.n_res + c];
        }
      }
      __syncthreads();
    }

    // post-net
    for (int i = tid; i < BT * ss.n(); i += THREADS) {
      const int b = i / ss.n(), c = ss.lo + i % ss.n();
      push_all(cluster, pb, b * D.n_skp + c,
               round_bf16(fmaxf(skip[b * D.n_skp + c], 0.f)));
    }
    cluster.sync();
    gemm(vec, pb, D.n_skp, p1w, D.n_post, ps.lo, ps.n(), 0, 0, part, red, nvm);
    for (int i = tid; i < BT * ps.n(); i += THREADS) {
      const int b = i / ps.n(), j = ps.lo + i % ps.n();
      push_all(cluster, p1, b * D.n_post + j,
               round_bf16(fmaxf(red[b * nvm + j - ps.lo] + p1b[j], 0.f)));
    }
    cluster.sync();
    gemm(vec, p1, D.n_post, p2w, D.n_quant, qs.lo, qs.n(), 0, 0, part, red, nvm);
    for (int i = tid; i < BT * qs.n(); i += THREADS) {
      const int b = i / qs.n(), jj = i % qs.n(), j = qs.lo + jj, row = row0 + b;
      const float lg = red[b * nvm + jj] + p2b[j];
      if (logits_out != nullptr && row < D.B)
        logits_out[((size_t)t * D.B + row) * D.n_quant + j] = lg;
      red[b * nvm + jj] =
          greedy ? lg : lg * inv_temp + gumbel(seed, row, t_abs, j);
    }
    __syncthreads();

    // argmax, first index on ties: each block reduces its slice (one warp
    // per row), pushes (value, index); every block then reduces the CL
    // candidates in rank order, so all agree on the id
    const int warp = tid / 32, lane = tid % 32;
    for (int b = warp; b < BT; b += WARPS) {
      float best = 0.f;
      int arg = -1;  // -1: this lane saw no column
      for (int jj = lane; jj < qs.n(); jj += 32) {
        const float s = red[b * nvm + jj];
        if (arg < 0 || s > best) { best = s; arg = qs.lo + jj; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
        if (oa >= 0 && (arg < 0 || ob > best || (ob == best && oa < arg))) {
          best = ob;
          arg = oa;
        }
      }
      if (lane < CL) {
        cluster.map_shared_rank(cand_v, lane)[rank * BT + b] = best;
        cluster.map_shared_rank(cand_i, lane)[rank * BT + b] = arg;
      }
    }
    cluster.sync();
    if (tid < BT) {
      float best = 0.f;
      int arg = -1;
      for (int q = 0; q < CL; ++q) {
        const float v = cand_v[q * BT + tid];
        const int a = cand_i[q * BT + tid];
        if (a >= 0 && (arg < 0 || v > best)) { best = v; arg = a; }
      }
      prev[tid] = arg;
      const int row = row0 + tid;
      if (rank == 0 && row < D.B) {
        ids[(size_t)row * D.T + t] = arg;
        if (t == D.T - 1) last_id[row] = arg;
      }
    }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while others may still push to it
}

}  // namespace

extern "C" {

// Launches the sampler on `stream`; returns cudaGetLastError() (0 = ok).
int awt_fastgen_bf16(const void* w_in, const void* b_in, const void* w_out,
                     const void* b_out, const void* embed, const void* p1w,
                     const void* p1b, const void* p2w, const void* p2b,
                     const void* cond, const void* prev_id, void* ring,
                     void* ids, void* last_id, void* logits,
                     const int* offs, const int* dils, int B, int T, int L,
                     int n_res, int n_dil, int n_skp, int n_post, int n_quant,
                     int n_cond, int t0, int seed, float inv_temp, int greedy,
                     void* stream) {
  if (L > MAX_LAYERS || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  RingMeta meta;
  for (int l = 0; l < L; ++l) { meta.off[l] = offs[l]; meta.dil[l] = dils[l]; }
  auto widest = [](int n) { return (n + CL - 1) / CL; };
  int nv_max = 2 * widest(n_dil);
  nv_max = nv_max > widest(n_res) + widest(n_skp) ? nv_max
                                                  : widest(n_res) + widest(n_skp);
  nv_max = nv_max > widest(n_post) ? nv_max : widest(n_post);
  nv_max = nv_max > widest(n_quant) ? nv_max : widest(n_quant);
  const Dims D{B, T, L, n_res, n_dil, n_skp, n_post, n_quant, n_cond, nv_max};
  // 16-byte weight loads need every column slice on an 8-column boundary
  const int vec = n_res % (8 * CL) == 0 && n_dil % (8 * CL) == 0 &&
                  n_skp % (8 * CL) == 0 && n_post % (8 * CL) == 0 &&
                  n_quant % (8 * CL) == 0;
  const int xin_len = 2 * n_res + n_cond;
  const size_t smem =
      sizeof(float) * ((size_t)BT * (n_res + n_skp + xin_len + n_dil + n_skp +
                                     n_post) +
                       (size_t)WARPS * BT * nv_max + (size_t)BT * nv_max +
                       CL * BT) +
      sizeof(int) * (CL * BT + BT);
  cudaError_t err = cudaFuncSetAttribute(
      fastgen_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((B + BT - 1) / BT) * CL);
  fastgen_bf16_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)w_in, (const float*)b_in,
      (const __nv_bfloat16*)w_out, (const float*)b_out,
      (const __nv_bfloat16*)embed, (const __nv_bfloat16*)p1w,
      (const float*)p1b, (const __nv_bfloat16*)p2w, (const float*)p2b,
      (const __nv_bfloat16*)cond, (const int*)prev_id,
      (__nv_bfloat16*)ring, (int*)ids, (int*)last_id, (float*)logits, D,
      meta, t0, (uint32_t)seed, inv_temp, greedy, vec);
  return (int)cudaGetLastError();
}

const char* awt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
