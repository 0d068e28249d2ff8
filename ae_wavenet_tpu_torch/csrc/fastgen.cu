// Fused autoregressive WaveNet sampler for Hopper (sm_90a): bf16, int8 and
// int4 weights.
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
//
// Quantized branches (int8 and int4 weights), replacing the int8 and int4
// branches of the same TPU kernel.  Contract per layer and step; rings,
// embedding, post-net (bf16), Philox draws and argmax are as above:
//   xin = [x_prev | bf16(x) | cond_t]                         (f32 values)
//   sx  = max(max|xin|, 1e-9) * (1/127)   over the whole [B, xin] tile, every
//         real batch row together (rows past B are not counted)
//   xq  = clip(round_half_even(xin / sx), -127, 127)          (a division)
//   y   = f32(int32 sum xq . wq) * (sx * w_in_s[col]) + b_in  (gate in f32)
//   h   = tanh(y[:n_dil]) * sigmoid(y[n_dil:])                (f32, not bf16)
//   sh, hq from h the same way;  rs = f32(int32 sum hq . woq) * (sh * w_out_s)
//         + b_out;  x += rs[:n_res]; skip += rs[n_res:]
//   int4: a byte holds two 4-bit codes of one output column: the high nibble
//   is signed [-7, 7] (row k of the upper half of the rows), the low nibble
//   is code + 8 in [1, 15] (row k + K/2).  sum = xq_hi . hi + xq_lo . lo
//   - 8 * sum(xq_lo), the zero-point folded into a row-sum correction.
// Layout (this card's, not the TPU's): four consecutive k of one column sit
// in one 32-bit word ([K/4, N, 4] bytes) so one __dp4a consumes a word; a
// 16-byte load brings 4 columns x 4 k.  K is zero-padded to a multiple of 8.
// The integer sums are exact, so kernel and plain version differ only
// through tanhf/expf and the order of the post-net's f32 sums.
//
// The scale couples every batch row twice per layer.  Inside a cluster each
// block pushes its slice's max into every block's shared memory before the
// cluster barrier that the bf16 design already has there.  With more than
// one cluster (B > 8) every block instead does an atomicMax on a rotating
// slot in global memory and counts itself in; after the cluster barrier one
// thread spins until every block of the grid has arrived.  That needs all
// clusters resident at once: the launch is cooperative and the host refuses
// a batch above cudaOccupancyMaxActiveClusters.  A barrier that is not met
// within seconds traps (a loud failure, never a hang).

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
  int kg_in, kg_out;  // quantized: 32-bit words (4 k each) per activation row
};

enum Mode { BF16 = 0, INT8 = 1, INT4 = 2 };

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

// Lanes l, l+8, l+16, l+24 of a warp hold the same columns: add them and
// store the warp's partial sums.
template <typename T, int VW>
__device__ __forceinline__ void lanes_to_part(T (&acc)[BT][VW], bool active,
                                              int v0, T* part, int nv_max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      T a = acc[b][e];
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

// red[b][v] = sum over warps of part (minus sub[b] when given), in warp order.
template <typename T>
__device__ __forceinline__ void part_to_red(const T* part, T* red, int nv,
                                            int nv_max, const T* sub) {
  __syncthreads();
  for (int i = threadIdx.x; i < BT * nv; i += THREADS) {
    const int b = i / nv, v = i % nv;
    T s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(w * BT + b) * nv_max + v];
    red[b * nv_max + v] = sub != nullptr ? s - sub[b] : s;
  }
  __syncthreads();
}

// red[b][v] = sum_k in[b][k] * W[k][col(v)] for this block's BT rows and
// its virtual columns v in [0, n1 + n2): col(v) = c1 + v for v < n1, else
// c2 + v - n1.  VW consecutive columns per thread group (VW = 8 takes
// 16-byte loads: needs c1, c2, n1, n2 and ldw multiples of 8).  The k
// dimension is split over KLANES lanes, reduced by shuffles inside a warp
// and through `part` [WARPS][BT][nv_max] across warps.  Kept out of line: as
// a called function the bf16 step measured 6% faster than with the compiler's
// choice to inline it once three kernels share it (H100, 0.320 against 0.340
// ms per step at B = 1); the integer GEMM below measured the other way round.
template <int VW>
__device__ __noinline__ void slice_gemm(const float* in, int k_len,
                           const __nv_bfloat16* __restrict__ W, int ldw,
                           int c1, int n1, int c2, int n2, float* part,
                           float* red, int nv_max) {
  const int tid = threadIdx.x;
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
    lanes_to_part<float, VW>(acc, active, v0, part, nv_max);
  }
  part_to_red<float>(part, red, nv, nv_max, nullptr);
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


// ------------------------------------------------------ quantized branches

// Max over the block; every thread gets it.  `wred` holds WARPS floats.
__device__ __forceinline__ float block_max(float m, float* wred) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) wred[threadIdx.x / 32] = m;
  __syncthreads();
  float r = wred[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, wred[w]);
  __syncthreads();
  return r;
}

// The batch-wide max of non-negative floats, across the blocks of one
// cluster (slots in every block's shared memory) or of the whole grid
// (rotating slots and an arrival count in global memory).
struct BatchMax {
  unsigned long long* count;  // global: arrivals so far, zeroed by the host
  unsigned int* slots;        // global: 4 rotating maxima (float bits)
  int grid_wide;              // more than one cluster
};

constexpr long long SPIN_LIMIT = 1LL << 34;  // clock cycles (several seconds)

// Before the cluster barrier: publish this block's max m as reduction n.
__device__ __forceinline__ void max_publish(cg::cluster_group& cluster,
                                            const BatchMax& g, float m,
                                            float* cslots, int rank,
                                            unsigned long long n) {
  if (g.grid_wide) {
    if (threadIdx.x == 0) {
      atomicMax(g.slots + (n & 3), __float_as_uint(m));
      __threadfence();
      atomicAdd(g.count, 1ULL);
    }
  } else if (threadIdx.x < CL) {
    cluster.map_shared_rank(cslots, threadIdx.x)[rank] = m;
  }
}

// After the cluster barrier: the max of reduction n over every block.
__device__ __forceinline__ float max_collect(const BatchMax& g,
                                             const float* cslots, float* bcast,
                                             unsigned long long n) {
  if (!g.grid_wide) {
    float m = cslots[0];
#pragma unroll
    for (int q = 1; q < CL; ++q) m = fmaxf(m, cslots[q]);
    return m;
  }
  if (threadIdx.x == 0) {
    const unsigned long long want = (n + 1) * (unsigned long long)gridDim.x;
    const long long t_start = clock64();
    while (*(volatile unsigned long long*)g.count < want)
      if (clock64() - t_start > SPIN_LIMIT) __trap();
    __threadfence();
    *bcast = __uint_as_float(*(volatile unsigned int*)(g.slots + (n & 3)));
    // every block has arrived at n, so none still reads slot n - 1: clear
    // it for reduction n + 3 (ordered before it by the next arrivals)
    if (blockIdx.x == 0) atomicExch(g.slots + ((n + 3) & 3), 0u);
  }
  __syncthreads();
  return *bcast;
}

// q[b][g] = four int8 codes clip(rint(in[b][4g + j] / s), -127, 127), one
// warp per row; INT4 also leaves 8 * (sum of the codes of the upper half of
// the words) in zp[b].  Columns past len are zero, and so are the rows past
// n_real, which are not divided at all: their queue inputs are all zeros, and
// a zero numerator sends the IEEE division down its slow path.
template <bool INT4>
__device__ __forceinline__ void quantize_rows(const float* in, int len, int kg,
                                              int n_real, float s, int* q,
                                              int* zp) {
  static_assert(WARPS == BT, "one warp quantizes one batch row");
  const int b = threadIdx.x / 32, lane = threadIdx.x % 32;
  int lo_sum = 0;
  for (int g = lane; g < kg; g += 32) {
    int word = 0;
    if (b < n_real) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * g + j;
        const float v = k < len ? in[b * len + k] : 0.f;
        const int qi = (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
        word |= (qi & 0xff) << (8 * j);
        if (INT4 && g >= kg / 2) lo_sum += qi;
      }
    }
    q[b * kg + g] = word;
  }
  if (INT4) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lo_sum += __shfl_xor_sync(0xffffffffu, lo_sum, o);
    if (lane == 0) zp[b] = 8 * lo_sum;
  }
  __syncthreads();
}

template <int VW>
__device__ __forceinline__ void load_words(const int* p, int* w) {
  if constexpr (VW == 4) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = raw.x; w[1] = raw.y; w[2] = raw.z; w[3] = raw.w;
  } else {
    static_assert(VW == 1, "column groups are 4 (16-byte loads) or 1");
    w[0] = __ldg(p);
  }
}

// The integer counterpart of slice_gemm: red[b][v] = sum_k xq[b][k] *
// wq[k][col(v)] in int32.  xq holds kg words (4 k each) per row; W holds one
// word per (k group, column).  INT4: W has kg / 2 word rows, each byte two
// codes (see the top of the file), and zp[b] is subtracted.
template <int VW, bool INT4>
__device__ __forceinline__ void slice_gemm_q(const int* xq, int kg, const int* __restrict__ W,
                             int ldw, int c1, int n1, int c2, int n2,
                             const int* zp, int* part, int* red, int nv_max) {
  const int tid = threadIdx.x;
  const int g_in = tid % GROUPS, kl = tid / GROUPS;
  const int nv = n1 + n2, n_groups = nv / VW;
  const int kgw = INT4 ? kg / 2 : kg;
  for (int g0 = 0; g0 < n_groups; g0 += GROUPS) {
    const int g = g0 + g_in;
    const bool active = g < n_groups;
    const int v0 = g * VW;
    const int col = v0 < n1 ? c1 + v0 : c2 + (v0 - n1);
    int acc[BT][VW], acc_lo[BT][VW];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[b][e] = acc_lo[b][e] = 0;
    if (active) {
      const int* wp = W + col;
#pragma unroll 4
      for (int k = kl; k < kgw; k += KLANES) {
        int w[VW];
        load_words<VW>(wp + (size_t)k * ldw, w);
        if constexpr (INT4) {
          int w_hi[VW], w_lo[VW];  // hi: 16 * code as signed bytes
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            w_hi[e] = (int)((unsigned)w[e] & 0xF0F0F0F0u);
            w_lo[e] = (int)((unsigned)w[e] & 0x0F0F0F0Fu);
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const int xh = xq[b * kg + k], xl = xq[b * kg + kgw + k];
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              acc[b][e] = __dp4a(xh, w_hi[e], acc[b][e]);
              acc_lo[b][e] = __dp4a(xl, w_lo[e], acc_lo[b][e]);
            }
          }
        } else {
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const int xv = xq[b * kg + k];
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[b][e] = __dp4a(xv, w[e], acc[b][e]);
          }
        }
      }
    }
    if constexpr (INT4) {
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int e = 0; e < VW; ++e)  // the hi sum is an exact multiple of 16
          acc[b][e] = (acc[b][e] >> 4) + acc_lo[b][e];
    }
    lanes_to_part<int, VW>(acc, active, v0, part, nv_max);
  }
  part_to_red<int>(part, red, nv, nv_max, INT4 ? zp : nullptr);
}

template <bool INT4>
__device__ __forceinline__ void gemm_q(bool vec, const int* xq, int kg,
                                       const int* __restrict__ W, int ldw,
                                       int c1, int n1, int c2, int n2,
                                       const int* zp, int* part, int* red,
                                       int nv_max) {
  if (vec)
    slice_gemm_q<4, INT4>(xq, kg, W, ldw, c1, n1, c2, n2, zp, part, red, nv_max);
  else
    slice_gemm_q<1, INT4>(xq, kg, W, ldw, c1, n1, c2, n2, zp, part, red, nv_max);
}

// ------------------------------------------------------------- the kernel

// Everything but the pointers, which are kernel parameters of their own so
// that they carry __restrict__ (on a struct member it is ignored).
struct Args {
  BatchMax gmax;  // quantized only
  Dims D;
  RingMeta meta;
  int t0;
  uint32_t seed;
  float inv_temp;
  int greedy, vec, vecq;
};

template <int MODE>
__global__ void __launch_bounds__(THREADS)
fastgen_kernel(const void* __restrict__ w_in,            // bf16 [L, xin, 2*n_dil]; int8 words
                                                         // [L, kg_in, 2*n_dil]; int4 words
                                                         // [L, kg_in/2, 2*n_dil]
               const float* __restrict__ w_in_s,         // quantized: [L, 2*n_dil] scales
               const float* __restrict__ b_in,           // [L, 2*n_dil]
               const void* __restrict__ w_out,           // bf16 [L, n_dil, n_res+n_skp]; words as w_in
               const float* __restrict__ w_out_s,        // quantized: [L, n_res+n_skp]
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
               const Args a) {
  constexpr bool Q = MODE != BF16;
  constexpr bool I4 = MODE == INT4;
  const Dims& D = a.D;
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
  // quantized only (the bf16 launch does not allocate these)
  int* xq = prev + BT;                   // [BT, kg_in]  int8 x 4 per word
  int* hq = xq + BT * D.kg_in;           // [BT, kg_out]
  int* zp = hq + BT * D.kg_out;          // [BT] int4 zero-point corrections
  float* cmax_x = (float*)(zp + BT);     // [CL] (pushed by all) max|xin| slices
  float* cmax_h = cmax_x + CL;           // [CL] (pushed by all) max|h| slices
  float* wred = cmax_h + CL;             // [WARPS]
  float* bcast = wred + WARPS;           // [1]

  const Slice rs = slice_of(D.n_res, rank), ss = slice_of(D.n_skp, rank);
  const Slice ds = slice_of(D.n_dil, rank), ps = slice_of(D.n_post, rank);
  const Slice qs = slice_of(D.n_quant, rank);

  if (tid < BT) prev[tid] = row0 + tid < D.B ? prev_id[row0 + tid] : 0;
  cluster.sync();  // every block of the cluster is running before any push

  for (int t = 0; t < D.T; ++t) {
    const int t_abs = a.t0 + t;
    for (int i = tid; i < BT * rs.n(); i += THREADS) {
      const int b = i / rs.n(), c = rs.lo + i % rs.n();
      x[b * D.n_res + c] =
          __bfloat162float(embed[(size_t)prev[b] * D.n_res + c]);
    }
    for (int i = tid; i < BT * ss.n(); i += THREADS) {
      const int b = i / ss.n(), c = ss.lo + i % ss.n();
      skip[b * D.n_skp + c] = 0.f;
    }
    float cond_max = 0.f;  // quantized: max |cond_t| over this cluster's rows
    for (int i = tid; i < BT * D.n_cond; i += THREADS) {
      const int b = i / D.n_cond, c = i % D.n_cond, row = row0 + b;
      const float v =
          row < D.B ? __bfloat162float(cond[((size_t)t * D.B + row) * D.n_cond + c])
                    : 0.f;
      xin[b * xin_len + 2 * D.n_res + c] = v;
      cond_max = fmaxf(cond_max, fabsf(v));
    }
    if constexpr (Q) cond_max = block_max(cond_max, wred);
    __syncthreads();

    for (int l = 0; l < D.L; ++l) {
      // ring queue, own res slice: read x_prev, then store bf16(x)
      const int slot = a.meta.off[l] + t_abs % a.meta.dil[l];
      const unsigned long long n_red = 2ULL * ((unsigned long long)t * D.L + l);
      float m_loc = 0.f;
      for (int i = tid; i < BT * rs.n(); i += THREADS) {
        const int b = i / rs.n(), c = rs.lo + i % rs.n(), row = row0 + b;
        const __nv_bfloat16 xb = __float2bfloat16(x[b * D.n_res + c]);
        float xp = 0.f;
        if (row < D.B) {
          __nv_bfloat16* p = ring + ((size_t)slot * D.B + row) * D.n_res + c;
          xp = __bfloat162float(*p);
          *p = xb;
          m_loc = fmaxf(m_loc, fmaxf(fabsf(xp), fabsf(__bfloat162float(xb))));
        }
        push_all(cluster, xin, b * xin_len + c, xp);
        push_all(cluster, xin, b * xin_len + D.n_res + c, __bfloat162float(xb));
      }
      if constexpr (Q)
        max_publish(cluster, a.gmax, fmaxf(block_max(m_loc, wred), cond_max),
                    cmax_x, rank, n_red);
      cluster.sync();

      // gate GEMM over own filter columns ds and the matching gate columns
      const float* bl = b_in + (size_t)l * 2 * D.n_dil;
      if constexpr (Q) {
        const float sx =
            fmaxf(max_collect(a.gmax, cmax_x, bcast, n_red), 1e-9f) * (1.0f / 127.0f);
        quantize_rows<I4>(xin, xin_len, D.kg_in, D.B - row0, sx, xq, zp);
        const int kgw = I4 ? D.kg_in / 2 : D.kg_in;
        gemm_q<I4>(a.vecq, xq, D.kg_in,
                   (const int*)w_in + (size_t)l * kgw * 2 * D.n_dil, 2 * D.n_dil,
                   ds.lo, ds.n(), D.n_dil + ds.lo, ds.n(), zp, (int*)part,
                   (int*)red, nvm);
        const int* acc = (const int*)red;
        const float* ws = w_in_s + (size_t)l * 2 * D.n_dil;
        m_loc = 0.f;
        for (int i = tid; i < BT * ds.n(); i += THREADS) {
          const int b = i / ds.n(), jj = i % ds.n(), j = ds.lo + jj;
          const float yf = __fadd_rn(
              __fmul_rn((float)acc[b * nvm + jj], __fmul_rn(sx, ws[j])), bl[j]);
          const float yg = __fadd_rn(
              __fmul_rn((float)acc[b * nvm + ds.n() + jj],
                        __fmul_rn(sx, ws[D.n_dil + j])), bl[D.n_dil + j]);
          const float h = tanhf(yf) * (1.f / (1.f + expf(-yg)));
          if (row0 + b < D.B) m_loc = fmaxf(m_loc, fabsf(h));
          push_all(cluster, hb, b * D.n_dil + j, h);
        }
        max_publish(cluster, a.gmax, block_max(m_loc, wred), cmax_h, rank,
                    n_red + 1);
      } else {
        gemm(a.vec, xin, xin_len,
             (const __nv_bfloat16*)w_in + (size_t)l * xin_len * 2 * D.n_dil,
             2 * D.n_dil, ds.lo, ds.n(), D.n_dil + ds.lo, ds.n(), part, red, nvm);
        for (int i = tid; i < BT * ds.n(); i += THREADS) {
          const int b = i / ds.n(), jj = i % ds.n(), j = ds.lo + jj;
          const float yf = red[b * nvm + jj] + bl[j];
          const float yg = red[b * nvm + ds.n() + jj] + bl[D.n_dil + j];
          const float sig = 1.f / (1.f + expf(-yg));
          push_all(cluster, hb, b * D.n_dil + j, round_bf16(tanhf(yf) * sig));
        }
      }
      cluster.sync();

      // residual + skip GEMM over own res and skip columns
      const float* bo = b_out + (size_t)l * n_out;
      if constexpr (Q) {
        const float sh =
            fmaxf(max_collect(a.gmax, cmax_h, bcast, n_red + 1), 1e-9f) *
            (1.0f / 127.0f);
        quantize_rows<I4>(hb, D.n_dil, D.kg_out, D.B - row0, sh, hq, zp);
        const int kgw = I4 ? D.kg_out / 2 : D.kg_out;
        gemm_q<I4>(a.vecq, hq, D.kg_out,
                   (const int*)w_out + (size_t)l * kgw * n_out, n_out, rs.lo,
                   rs.n(), D.n_res + ss.lo, ss.n(), zp, (int*)part, (int*)red, nvm);
        const int* acc = (const int*)red;
        const float* ws = w_out_s + (size_t)l * n_out;
        for (int i = tid; i < BT * (rs.n() + ss.n()); i += THREADS) {
          const int b = i / (rs.n() + ss.n()), v = i % (rs.n() + ss.n());
          const int c = v < rs.n() ? rs.lo + v : D.n_res + ss.lo + v - rs.n();
          const float val = __fadd_rn(
              __fmul_rn((float)acc[b * nvm + v], __fmul_rn(sh, ws[c])), bo[c]);
          if (v < rs.n()) x[b * D.n_res + c] += val;
          else skip[b * D.n_skp + c - D.n_res] += val;
        }
      } else {
        gemm(a.vec, hb, D.n_dil,
             (const __nv_bfloat16*)w_out + (size_t)l * D.n_dil * n_out, n_out,
             rs.lo, rs.n(), D.n_res + ss.lo, ss.n(), part, red, nvm);
        for (int i = tid; i < BT * (rs.n() + ss.n()); i += THREADS) {
          const int b = i / (rs.n() + ss.n()), v = i % (rs.n() + ss.n());
          const float val = red[b * nvm + v];
          if (v < rs.n()) x[b * D.n_res + rs.lo + v] += val + bo[rs.lo + v];
          else {
            const int c = ss.lo + v - rs.n();
            skip[b * D.n_skp + c] += val + bo[D.n_res + c];
          }
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
    gemm(a.vec, pb, D.n_skp, p1w, D.n_post, ps.lo, ps.n(), 0, 0, part, red, nvm);
    for (int i = tid; i < BT * ps.n(); i += THREADS) {
      const int b = i / ps.n(), j = ps.lo + i % ps.n();
      push_all(cluster, p1, b * D.n_post + j,
               round_bf16(fmaxf(red[b * nvm + j - ps.lo] + p1b[j], 0.f)));
    }
    cluster.sync();
    gemm(a.vec, p1, D.n_post, p2w, D.n_quant, qs.lo, qs.n(), 0, 0, part, red, nvm);
    for (int i = tid; i < BT * qs.n(); i += THREADS) {
      const int b = i / qs.n(), jj = i % qs.n(), j = qs.lo + jj, row = row0 + b;
      const float lg = red[b * nvm + jj] + p2b[j];
      if (logits_out != nullptr && row < D.B)
        logits_out[((size_t)t * D.B + row) * D.n_quant + j] = lg;
      red[b * nvm + jj] =
          a.greedy ? lg : lg * a.inv_temp + gumbel(a.seed, row, t_abs, j);
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
        const int c = cand_i[q * BT + tid];
        if (c >= 0 && (arg < 0 || v > best)) { best = v; arg = c; }
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

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Fills the widths; returns the bytes of dynamic shared memory.
size_t plan(Args& a, int B, int T, int L, int n_res, int n_dil, int n_skp,
            int n_post, int n_quant, int n_cond, bool quantized) {
  auto widest = [](int n) { return (n + CL - 1) / CL; };
  int nv_max = 2 * widest(n_dil);
  nv_max = nv_max > widest(n_res) + widest(n_skp) ? nv_max
                                                  : widest(n_res) + widest(n_skp);
  nv_max = nv_max > widest(n_post) ? nv_max : widest(n_post);
  nv_max = nv_max > widest(n_quant) ? nv_max : widest(n_quant);
  const int xin_len = 2 * n_res + n_cond;
  a.D = Dims{B, T, L, n_res, n_dil, n_skp, n_post, n_quant, n_cond, nv_max,
             round_up(xin_len, 8) / 4, round_up(n_dil, 8) / 4};
  // 16-byte weight loads need every column slice on an 8-column boundary
  // (bf16) or a 4-column boundary (the quantized words)
  a.vec = n_res % (8 * CL) == 0 && n_dil % (8 * CL) == 0 &&
          n_skp % (8 * CL) == 0 && n_post % (8 * CL) == 0 &&
          n_quant % (8 * CL) == 0;
  a.vecq = n_res % (4 * CL) == 0 && n_dil % (4 * CL) == 0 && n_skp % (4 * CL) == 0;
  size_t smem =
      sizeof(float) * ((size_t)BT * (n_res + n_skp + xin_len + n_dil + n_skp +
                                     n_post) +
                       (size_t)WARPS * BT * nv_max + (size_t)BT * nv_max +
                       CL * BT) +
      sizeof(int) * (CL * BT + BT);
  if (quantized)
    smem += sizeof(int) * ((size_t)BT * (a.D.kg_in + a.D.kg_out) + BT) +
            sizeof(float) * (2 * CL + WARPS + 1);
  return smem;
}

// The launch: clusters of CL blocks; cooperative when the clusters must all
// be resident at once (the quantized kernels' grid-wide reduction).
struct Launch {
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg;

  Launch(size_t smem, int n_blocks, void* stream, bool cooperative) : cfg{} {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = CL;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.gridDim = dim3(n_blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attrs;
    cfg.numAttrs = cooperative ? 2 : 1;
  }
};

template <int MODE>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(fastgen_kernel<MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int MODE>
int launch(const void* w_in, const void* w_in_s, const void* b_in,
           const void* w_out, const void* w_out_s, const void* b_out,
           const void* embed, const void* p1w, const void* p1b, const void* p2w,
           const void* p2b, const void* cond, const void* prev_id, void* ring,
           void* ids, void* last_id, void* logits, void* scratch, const int* offs,
           const int* dils, int B, int T, int L, int n_res, int n_dil, int n_skp,
           int n_post, int n_quant, int n_cond, int t0, int seed, float inv_temp,
           int greedy, void* stream) {
  if (L > MAX_LAYERS || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  for (int l = 0; l < L; ++l) { a.meta.off[l] = offs[l]; a.meta.dil[l] = dils[l]; }
  const size_t smem = plan(a, B, T, L, n_res, n_dil, n_skp, n_post, n_quant,
                           n_cond, MODE != BF16);
  a.t0 = t0; a.seed = (uint32_t)seed; a.inv_temp = inv_temp; a.greedy = greedy;
  const int n_clusters = (B + BT - 1) / BT;
  a.gmax.count = (unsigned long long*)scratch;
  a.gmax.slots = (unsigned int*)((char*)scratch + 8);
  a.gmax.grid_wide = MODE != BF16 && n_clusters > 1;
  cudaError_t err = allow_smem<MODE>(smem);
  if (err != cudaSuccess) return (int)err;
  Launch l(smem, n_clusters * CL, stream, a.gmax.grid_wide);
  err = cudaLaunchKernelEx(
      &l.cfg, fastgen_kernel<MODE>, w_in, (const float*)w_in_s, (const float*)b_in,
      w_out, (const float*)w_out_s, (const float*)b_out,
      (const __nv_bfloat16*)embed, (const __nv_bfloat16*)p1w, (const float*)p1b,
      (const __nv_bfloat16*)p2w, (const float*)p2b, (const __nv_bfloat16*)cond,
      (const int*)prev_id, (__nv_bfloat16*)ring, (int*)ids, (int*)last_id,
      (float*)logits, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the bf16 sampler on `stream`; returns a CUDA error code (0 = ok).
int awt_fastgen_bf16(const void* w_in, const void* b_in, const void* w_out,
                     const void* b_out, const void* embed, const void* p1w,
                     const void* p1b, const void* p2w, const void* p2b,
                     const void* cond, const void* prev_id, void* ring,
                     void* ids, void* last_id, void* logits,
                     const int* offs, const int* dils, int B, int T, int L,
                     int n_res, int n_dil, int n_skp, int n_post, int n_quant,
                     int n_cond, int t0, int seed, float inv_temp, int greedy,
                     void* stream) {
  return launch<BF16>(w_in, nullptr, b_in, w_out, nullptr, b_out, embed, p1w, p1b,
                      p2w, p2b, cond, prev_id, ring, ids, last_id, logits, nullptr,
                      offs, dils, B, T, L, n_res, n_dil, n_skp, n_post, n_quant,
                      n_cond, t0, seed, inv_temp, greedy, stream);
}

// The most batch rows the quantized sampler can take at these widths: every
// cluster must be resident at once (its batch-wide scale is a grid-wide
// reduction).  Writes the bound to *max_batch; returns a CUDA error code.
int awt_fastgen_q_max_batch(int int4, int n_res, int n_dil, int n_skp,
                            int n_post, int n_quant, int n_cond,
                            int* max_batch) {
  Args a{};
  const size_t smem =
      plan(a, BT, 1, 1, n_res, n_dil, n_skp, n_post, n_quant, n_cond, true);
  cudaError_t err = int4 ? allow_smem<INT4>(smem) : allow_smem<INT8>(smem);
  if (err != cudaSuccess) return (int)err;
  Launch l(smem, CL, nullptr, false);
  int n_clusters = 0;
  err = int4 ? cudaOccupancyMaxActiveClusters(&n_clusters, fastgen_kernel<INT4>, &l.cfg)
             : cudaOccupancyMaxActiveClusters(&n_clusters, fastgen_kernel<INT8>, &l.cfg);
  if (err != cudaSuccess) return (int)err;
  *max_batch = n_clusters * BT;
  return 0;
}

// Launches the int8 (int4 = 0) or int4 (int4 = 1) sampler on `stream`.
// `scratch` is 32 zeroed bytes (the grid-wide reduction's count and slots).
// With more than one cluster the launch is cooperative, so it is refused
// when the clusters cannot all be resident.
int awt_fastgen_q(int int4, const void* w_in, const void* w_in_s,
                  const void* b_in, const void* w_out, const void* w_out_s,
                  const void* b_out, const void* embed, const void* p1w,
                  const void* p1b, const void* p2w, const void* p2b,
                  const void* cond, const void* prev_id, void* ring, void* ids,
                  void* last_id, void* logits, void* scratch, const int* offs,
                  const int* dils, int B, int T, int L, int n_res, int n_dil,
                  int n_skp, int n_post, int n_quant, int n_cond, int t0,
                  int seed, float inv_temp, int greedy, void* stream) {
  return (int4 ? launch<INT4> : launch<INT8>)(
      w_in, w_in_s, b_in, w_out, w_out_s, b_out, embed, p1w, p1b, p2w, p2b, cond,
      prev_id, ring, ids, last_id, logits, scratch, offs, dils, B, T, L, n_res,
      n_dil, n_skp, n_post, n_quant, n_cond, t0, seed, inv_temp, greedy, stream);
}

const char* awt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
