// Fused gated stack for training: forward and backward of one layer, two
// layers, the whole stack (forward) or a group of layers (backward), and
// the weight-gradient products.  Hand-written for Hopper (sm_90a), bound
// with ctypes (see ops/gated_cuda.py).
//
// Replaces the TPU kernels of ae_wavenet_tpu/ops/gated_pallas.py:
//   gated_layer_fused (K1b) and gated_pair_fused (K1)  -> gated_fwd_kernel<1|2>
//   gated_layer_bwd (K2b, saved-y and recompute modes) and
//   gated_pair_bwd (K2)                                -> gated_bwd_kernel<1|2>
//                                                         + gated_dw_kernel
//   gated_stack_fused (K7, every layer in one launch)  -> gated_stack_kernel
//   gated_group_bwd (K8, G >= 3 layers in one launch)  -> gated_group_kernel
//                                                         + gated_dw_kernel
// The contract (rounding points and masks) is written out at the top of
// ops/gated.py, which also holds the plain PyTorch version of each.
//
// Layout: time-major [B, P, C] bf16 streams (f32 skip / gcond), P = t_in
// rows, layer i valid from row vl_i.  Weights come zero-padded to 16-column
// multiples (Rp, Cp, Dp, Sp) so every WMMA tile is whole:
//   win  [2Rp + Cp][2Dp]  rows prev | cur | cond, cols f | g
//   wout [Dp][Rp + Sp]    cols res | skip
//
// What bounds it on this card.  At the flagship width a layer is two
// products per row, 928 x 512 and 256 x 640 (about 1.3 MFLOP per row, per
// direction), at roughly 1 FLOP per byte of the weights if they were
// re-read per row.  So the work is tensor-core bound as long as the weights
// are reused across many rows: a block takes 64 rows, keeps their xin
// (120 KB) and h in shared memory and streams the weights through WMMA
// fragments from L2 (1.3 MB per layer, resident in the 50 MB L2), so each
// weight byte is read once per 64 rows.
//
// What the design does about the TPU schedule.  The Pallas grid walks the
// time tiles of a batch row in order and carries state between them (the
// pair forward's prev-tap tail, the pair backward's f32 cotangent head,
// the weight gradients in resident output blocks).  Hopper's blocks run in
// no order, and the carries (up to 512 rows x 384 channels) do not fit in
// shared memory.  So:
//   * each block owns a chunk of rows of one batch row and walks its tiles
//     in order (ascending forward, descending backward); the rows a pair
//     needs from the neighbouring chunk are recomputed as a halo at the
//     chunk's start (forward: layer 1 on the dd2 rows below, into a
//     per-block scratch; backward: layer 2 on the dd2 rows above, which
//     only yields its prev-tap cotangent);
//   * inside a chunk the carried rows go through global memory that the
//     block itself wrote (mid, and the f32 cotangent between the two
//     layers of a pair), ordered by __syncthreads;
//   * the weight gradients are long-K products over every row of every
//     batch row: the backward writes g_y, h and g_out (bf16), and
//     gated_dw_kernel computes xin^T g_y and h^T g_out with split-K
//     partials in f32, reduced in a fixed order by gated_reduce_kernel
//     (deterministic); gated_colsum_kernel sums g_y and g_out over the
//     rows for the bias gradients the same way;
//   * the whole-stack forward and the grouped backward carry rows across
//     chunks for many layers (the sum of the dilations, up to 2,045 rows),
//     which a recomputed halo would pay for with more work than the layers
//     themselves.  They recompute nothing: one persistent, cooperative
//     launch of as many blocks as the card holds at once walks the layers
//     in order (layer-major), every block taking the same tiles of every
//     layer, with a barrier across the grid between two layers.  What a
//     tile needs from its neighbour (the previous layer's output dd rows
//     below it; the layer above's f32 cotangents) was written to global
//     memory before the barrier by whichever block owned those rows: the
//     inter-layer streams the backward needs anyway (or two buffers used
//     in turn when nothing is saved), and for the backward one f32 buffer
//     of same-row cotangents updated in place plus two f32 buffers of
//     prev-tap cotangents, written at row g - dd, used in turn.  A barrier
//     that is not met within seconds traps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TM = 64;      // rows per tile
constexpr int NWARP = 8;
constexpr int NTHR = 32 * NWARP;
constexpr int SKEW = 8;     // bf16 padding per shared-memory row
constexpr int STAGE = 512;  // f32 staging per warp (two 16x16 tiles)

struct Dims {
  int B, P, R, C, D, S, Rp, Cp, Dp, Sp;
  __host__ __device__ int kp() const { return 2 * Rp + Cp; }
  __host__ __device__ int rsp() const { return Rp + Sp; }
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 consecutive bf16 <-> f32 (16-byte aligned)
__device__ __forceinline__ void ld8(float* o, const bf16* p) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __bfloat162float(h[e]);
}
__device__ __forceinline__ void st8(bf16* p, const float* v) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(v[e]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void cp8(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) =
      src ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void ldf8(float* o, const float* p) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void stf8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Fill xin rows [t0, t0 + TM) in shared memory (columns prev | cur | cond,
// each zero-padded) from row pointers; rows >= nr and null pointers give
// zeros.  Only the tap columns are loaded when with_cond is false.
template <typename PrevF, typename CurF>
__device__ void load_xin(bf16* xs, const Dims& d, int b, int t0, int nr,
                         const bf16* cond, bool with_cond, PrevF prev, CurF cur,
                         int valid_lo) {
  const int ldx = d.kp() + SKEW;
  const int nc = (with_cond ? d.kp() : 2 * d.Rp) / 8;
  for (int i = threadIdx.x; i < TM * nc; i += NTHR) {
    const int rr = i / nc, col = (i % nc) * 8, g = t0 + rr;
    const bool in = rr < nr && g >= valid_lo;
    const bf16* src = nullptr;
    if (col < d.Rp) {
      if (in && col < d.R) { src = prev(g); if (src) src += col; }
    } else if (col < 2 * d.Rp) {
      if (in && col - d.Rp < d.R) src = cur(g) + (col - d.Rp);
    } else if (in && col - 2 * d.Rp < d.C) {
      src = cond + ((size_t)b * d.P + g) * d.C + (col - 2 * d.Rp);
    }
    cp8(xs + rr * ldx + col, src);
  }
}

// ------------------------------------------------------------- forward

struct FwdLayer {
  const bf16* win; const float* bin; const bf16* wout; const float* bout;
  bf16* y;  // [B, P, 2D] or null
  int dd;
};

struct FwdP {
  Dims d;
  const bf16* x; const bf16* cond; float* skip;
  bf16* mid; bf16* xout; bf16* halo;
  FwdLayer L[2];
  int r0, chunk;
};

// One layer on the tile whose xin is in shared memory.  The new residual
// row g goes to out + (g - out_row0) * R (nowhere when out is null); halo
// tiles write neither skip nor y.
__device__ void fwd_layer_tile(const FwdP& p, const FwdLayer& L, int b, int t0,
                               int nr, bf16* out, int out_row0, bool halo,
                               bf16* xs, bf16* hs, float* stage) {
  const Dims& d = p.d;
  const int ldx = d.kp() + SKEW, ldh = d.Dp + SKEW, ldw = 2 * d.Dp, lo = d.rsp();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stage + warp * STAGE;
  const int rr = lane >> 1, cc = (lane & 1) * 8;

  // y = xin @ w_in + b_in, gate, h -> shared memory (bf16)
  for (int ni = warp; ni < d.Dp / 16; ni += NWARP) {
    FragC af[4], ag[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      wmma::fill_fragment(af[mi], 0.f);
      wmma::fill_fragment(ag[mi], 0.f);
    }
    for (int k = 0; k < d.kp(); k += 16) {
      FragB bf, bg;
      wmma::load_matrix_sync(bf, L.win + (size_t)k * ldw + ni * 16, ldw);
      wmma::load_matrix_sync(bg, L.win + (size_t)k * ldw + d.Dp + ni * 16, ldw);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        FragA a;
        wmma::load_matrix_sync(a, xs + mi * 16 * ldx + k, ldx);
        wmma::mma_sync(af[mi], a, bf, af[mi]);
        wmma::mma_sync(ag[mi], a, bg, ag[mi]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      wmma::store_matrix_sync(st, af[mi], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, ag[mi], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = mi * 16 + rr, n0 = ni * 16 + cc, g = t0 + row;
      float yf[8], yg[8], hv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        yf[e] = st[rr * 16 + cc + e] + L.bin[n0 + e];
        yg[e] = st[256 + rr * 16 + cc + e] + L.bin[d.Dp + n0 + e];
        hv[e] = tanhf(yf[e]) * sigm(yg[e]);
      }
      if (!halo && L.y && row < nr && n0 < d.D) {
        bf16* yp = L.y + ((size_t)b * d.P + g) * 2 * d.D;
        st8(yp + n0, yf);
        st8(yp + d.D + n0, yg);
      }
      st8(hs + row * ldh + n0, hv);
      __syncwarp();
    }
  }
  __syncthreads();

  // out = h @ w_out + b_out; x' = bf16(x + bf16(res)); skip += skip term
  for (int nj = warp; nj < lo / 16; nj += NWARP) {
    FragC acc[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) wmma::fill_fragment(acc[mi], 0.f);
    for (int k = 0; k < d.Dp; k += 16) {
      FragB bw;
      wmma::load_matrix_sync(bw, L.wout + (size_t)k * lo + nj * 16, lo);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        FragA a;
        wmma::load_matrix_sync(a, hs + mi * 16 * ldh + k, ldh);
        wmma::mma_sync(acc[mi], a, bw, acc[mi]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      wmma::store_matrix_sync(st, acc[mi], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = mi * 16 + rr, n0 = nj * 16 + cc, g = t0 + row;
      if (row < nr) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = st[rr * 16 + cc + e] + L.bout[n0 + e];
        if (n0 < d.Rp) {
          if (n0 < d.R && out) {
            float xc[8];
            ld8(xc, xs + row * ldx + d.Rp + n0);
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = xc[e] + rbf(o[e]);
            st8(out + (size_t)(g - out_row0) * d.R + n0, o);
          }
        } else if (!halo && n0 - d.Rp < d.S) {
          float* sk = p.skip + ((size_t)b * d.P + g) * d.S + (n0 - d.Rp);
          float s[8];
          ldf8(s, sk);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[e] += o[e];
          stf8(sk, s);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

template <int NL>
__global__ void __launch_bounds__(NTHR) gated_fwd_kernel(FwdP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = p.d;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + TM * (d.kp() + SKEW);
  float* stage = reinterpret_cast<float*>(hs + TM * (d.Dp + SKEW));
  const int b = blockIdx.y;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  const int c0 = p.r0 + blockIdx.x * p.chunk;
  const int c1 = min(c0 + p.chunk, d.P);
  if (c0 >= c1) return;
  const bf16* xb = p.x + (size_t)b * d.P * d.R;
  const int dd1 = p.L[0].dd, dd2 = p.L[1].dd;
  auto prev1 = [&](int g) -> const bf16* {
    return g - dd1 >= 0 ? xb + (size_t)(g - dd1) * d.R : nullptr;
  };
  auto cur1 = [&](int g) -> const bf16* { return xb + (size_t)g * d.R; };
  bf16* hal = p.halo + (size_t)blk * dd2 * d.R;  // rows [c0 - dd2, c0)

  if (NL == 2) {
    // halo: layer 1 on the rows below the chunk that layer 2's prev tap reads
    for (int t0 = max(c0 - dd2, p.r0); t0 < c0; t0 += TM) {
      const int nr = min(TM, c0 - t0);
      load_xin(xs, d, b, t0, nr, p.cond, true, prev1, cur1, 0);
      __syncthreads();
      fwd_layer_tile(p, p.L[0], b, t0, nr, hal, c0 - dd2, true, xs, hs, stage);
    }
  }
  bf16* midb = p.mid + (size_t)b * d.P * d.R;
  auto prev2 = [&](int g) -> const bf16* {
    const int s = g - dd2;
    if (s < p.r0 || s < 0) return nullptr;
    if (s < c0) return hal + (size_t)(s - (c0 - dd2)) * d.R;
    return midb + (size_t)s * d.R;
  };
  auto cur2 = [&](int g) -> const bf16* { return midb + (size_t)g * d.R; };
  bf16* outb = (NL == 2 ? p.mid : p.xout) + (size_t)b * d.P * d.R;
  for (int t0 = c0; t0 < c1; t0 += TM) {
    const int nr = min(TM, c1 - t0);
    load_xin(xs, d, b, t0, nr, p.cond, true, prev1, cur1, 0);
    __syncthreads();
    fwd_layer_tile(p, p.L[0], b, t0, nr, outb, 0, false, xs, hs, stage);
    if (NL == 2) {
      load_xin(xs, d, b, t0, nr, p.cond, false, prev2, cur2, 0);
      __syncthreads();
      fwd_layer_tile(p, p.L[1], b, t0, nr, p.xout + (size_t)b * d.P * d.R, 0,
                     false, xs, hs, stage);
    }
  }
}

// ------------------------------------------------------------ backward

struct BwdLayer {
  const bf16* x; const bf16* y;  // y null: recompute mode
  const bf16* win; const float* bin; const bf16* wout;
  bf16* gy; bf16* h; bf16* gout;  // [B, P, 2D], [B, P, D], [B, P, R + S]
  int dd, vl;
};

struct BwdP {
  Dims d;
  const bf16* cond; const bf16* gxcur; const bf16* gxprev; const bf16* gskip;
  float* gcond; bf16* gxc; bf16* gxp;
  float* gcur2; float* gp2;  // the layer above -> this layer cotangent (f32)
  float* gp2w;               // where this layer writes its own prev-tap part
  float* yf;                 // recompute: f32 y [B, P, 2Dp]
  BwdLayer L[2];
  int prev_dd, cur_vl, r0, chunk;
};

// Where a layer's upstream comes from and where its cotangents go: bf16
// streams both ways (SINGLE), bf16 in and f32 out (UPPER; HALO writes only
// the prev-tap part), f32 in and bf16 out (LOWER), f32 both ways (INNER).
enum Mode { SINGLE = 0, UPPER = 1, LOWER = 2, HALO = 3, INNER = 4 };

// Upstream cotangent of the layer's output rows g, channels r..r+7 (before
// the layer's own valid mask).
__device__ __forceinline__ void gxn8(const BwdP& p, int mode, int b, int g,
                                     int r, float* o) {
  const Dims& d = p.d;
  const size_t off = ((size_t)b * d.P + g) * d.R + r;
  if (mode == LOWER || mode == INNER) {
    ldf8(o, p.gcur2 + off);
    if (g + p.L[1].dd < d.P) {
      float q[8];
      ldf8(q, p.gp2 + off);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] += q[e];
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = 0.f;
  if (g >= p.cur_vl) ld8(o, p.gxcur + off);
  if (p.prev_dd && g + p.prev_dd < d.P) {
    float q[8];
    ld8(q, p.gxprev + off + (size_t)p.prev_dd * d.R);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] += q[e];
  }
}

// The layer's f32 gate pre-activations at row g, gate channels n..n+7
// (f and g halves), zero on rows outside its lattice.
__device__ __forceinline__ void y8(const BwdP& p, const BwdLayer& L, int b,
                                   int g, bool ok, int n, float* yf, float* yg) {
  const Dims& d = p.d;
  if (!ok || g < L.vl || (L.y && n >= d.D)) {
#pragma unroll
    for (int e = 0; e < 8; ++e) yf[e] = yg[e] = 0.f;
    return;
  }
  if (L.y) {
    const bf16* yp = L.y + ((size_t)b * d.P + g) * 2 * d.D;
    ld8(yf, yp + n);
    ld8(yg, yp + d.D + n);
  } else {
    const float* yp = p.yf + ((size_t)b * d.P + g) * 2 * d.Dp;
    ldf8(yf, yp + n);
    ldf8(yg, yp + d.Dp + n);
  }
}

__device__ void bwd_layer_tile(const BwdP& p, int mode, int b, int t0, int nr,
                               int c0, unsigned char* U, float* stage) {
  const Dims& d = p.d;
  const BwdLayer& L = (mode == UPPER || mode == HALO) ? p.L[1] : p.L[0];
  const int lo = d.rsp(), ldo = lo + SKEW, ldy = 2 * d.Dp + SKEW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stage + warp * STAGE;
  const int rr = lane >> 1, cc = (lane & 1) * 8;
  bf16* gos = reinterpret_cast<bf16*>(U);
  bf16* gys = gos + TM * ldo;
  const size_t rowb = (size_t)b * d.P;

  if (!L.y) {
    // recompute mode: y = where(valid, xin @ w_in + b_in, 0) -> f32 scratch
    bf16* xs = reinterpret_cast<bf16*>(U);
    const int ldx = d.kp() + SKEW, ldw = 2 * d.Dp;
    const bf16* xb = L.x + rowb * d.R;
    load_xin(xs, d, b, t0, nr, p.cond, true,
             [&](int g) -> const bf16* {
               return g - L.dd >= 0 ? xb + (size_t)(g - L.dd) * d.R : nullptr;
             },
             [&](int g) -> const bf16* { return xb + (size_t)g * d.R; }, L.vl);
    __syncthreads();
    for (int ni = warp; ni < 2 * d.Dp / 16; ni += NWARP) {
      FragC acc[4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) wmma::fill_fragment(acc[mi], 0.f);
      for (int k = 0; k < d.kp(); k += 16) {
        FragB bw;
        wmma::load_matrix_sync(bw, L.win + (size_t)k * ldw + ni * 16, ldw);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          FragA a;
          wmma::load_matrix_sync(a, xs + mi * 16 * ldx + k, ldx);
          wmma::mma_sync(acc[mi], a, bw, acc[mi]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        wmma::store_matrix_sync(st, acc[mi], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = mi * 16 + rr, n0 = ni * 16 + cc, g = t0 + row;
        if (row < nr) {
          float v[8];
          const bool ok = g >= L.vl;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = ok ? st[rr * 16 + cc + e] + L.bin[n0 + e] : 0.f;
          stf8(p.yf + (rowb + g) * 2 * d.Dp + n0, v);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  // h (for dW_out) and g_out = bf16([gxn | gskip]) masked to valid rows
  for (int i = threadIdx.x; i < TM * (d.Dp / 8); i += NTHR) {
    const int row = i / (d.Dp / 8), n = (i % (d.Dp / 8)) * 8, g = t0 + row;
    if (mode == HALO || row >= nr || g < L.vl || n >= d.D) continue;
    float yf[8], yg[8], hv[8];
    y8(p, L, b, g, true, n, yf, yg);
#pragma unroll
    for (int e = 0; e < 8; ++e) hv[e] = tanhf(yf[e]) * sigm(yg[e]);
    st8(L.h + (rowb + g) * d.D + n, hv);
  }
  for (int i = threadIdx.x; i < TM * (lo / 8); i += NTHR) {
    const int row = i / (lo / 8), col = (i % (lo / 8)) * 8, g = t0 + row;
    const bool ok = row < nr && g >= L.vl;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    bool real = false;
    if (col < d.Rp) {
      if (ok && col < d.R) { gxn8(p, mode, b, g, col, v); real = true; }
    } else if (ok && col - d.Rp < d.S) {
      ld8(v, p.gskip + (rowb + g) * d.S + (col - d.Rp));
      real = true;
    }
    st8(gos + row * ldo + col, v);
    if (real && mode != HALO) {
      const int n = col < d.Rp ? col : col - d.Rp + d.R;
      st8(L.gout + (rowb + g) * (d.R + d.S) + n, v);
    }
  }
  __syncthreads();

  // g_h = g_out @ w_out^T; g_y = bf16([g_h s (1 - t^2) | g_h t s (1 - s)])
  for (int ni = warp; ni < d.Dp / 16; ni += NWARP) {
    FragC acc[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) wmma::fill_fragment(acc[mi], 0.f);
    for (int k = 0; k < lo; k += 16) {
      FragBc bw;  // w_out^T[k][n] = w_out[n][k]
      wmma::load_matrix_sync(bw, L.wout + (size_t)ni * 16 * lo + k, lo);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        FragA a;
        wmma::load_matrix_sync(a, gos + mi * 16 * ldo + k, ldo);
        wmma::mma_sync(acc[mi], a, bw, acc[mi]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      wmma::store_matrix_sync(st, acc[mi], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = mi * 16 + rr, n0 = ni * 16 + cc, g = t0 + row;
      float yf[8], yg[8], gf[8], gg[8];
      y8(p, L, b, g, row < nr, n0, yf, yg);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float gh = st[rr * 16 + cc + e];
        const float tf = tanhf(yf[e]), sg = sigm(yg[e]);
        gf[e] = gh * sg * (1.f - tf * tf);
        gg[e] = gh * tf * sg * (1.f - sg);
      }
      st8(gys + row * ldy + n0, gf);
      st8(gys + row * ldy + d.Dp + n0, gg);
      if (mode != HALO && row < nr && g >= L.vl && n0 < d.D) {
        bf16* gp = L.gy + (rowb + g) * 2 * d.D;
        st8(gp + n0, gf);
        st8(gp + d.D + n0, gg);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // g_xin = g_y @ w_in^T (f32) -> the input cotangents
  const int ncol = (mode == HALO ? d.Rp : d.kp()) / 16, ldw = 2 * d.Dp;
  for (int nj = warp; nj < ncol; nj += NWARP) {
    FragC acc[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) wmma::fill_fragment(acc[mi], 0.f);
    for (int k = 0; k < 2 * d.Dp; k += 16) {
      FragBc bw;  // w_in^T[k][n] = w_in[n][k]
      wmma::load_matrix_sync(bw, L.win + (size_t)nj * 16 * ldw + k, ldw);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        FragA a;
        wmma::load_matrix_sync(a, gys + mi * 16 * ldy + k, ldy);
        wmma::mma_sync(acc[mi], a, bw, acc[mi]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      wmma::store_matrix_sync(st, acc[mi], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = mi * 16 + rr, n0 = nj * 16 + cc, g = t0 + row;
      if (row < nr) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = st[rr * 16 + cc + e];
        if (n0 < d.Rp) {
          if (n0 < d.R) {
            if (mode == SINGLE || mode == LOWER) {
              st8(p.gxp + (rowb + g) * d.R + n0, v);
            } else {
              const int q = g - L.dd;
              if (q >= c0) stf8(p.gp2w + (rowb + q) * d.R + n0, v);
            }
          }
        } else if (n0 < 2 * d.Rp) {
          const int r = n0 - d.Rp;
          if (r < d.R) {
            float gx[8];
            if (g >= L.vl) {
              gxn8(p, mode, b, g, r, gx);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) gx[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) gx[e] += v[e];
            if (mode == UPPER || mode == INNER)
              stf8(p.gcur2 + (rowb + g) * d.R + r, gx);
            else st8(p.gxc + (rowb + g) * d.R + r, gx);
          }
        } else if (n0 - 2 * d.Rp < d.C) {
          float* gc = p.gcond + (rowb + g) * d.C + (n0 - 2 * d.Rp);
          float s[8];
          ldf8(s, gc);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[e] += v[e];
          stf8(gc, s);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

template <int NL>
__global__ void __launch_bounds__(NTHR) gated_bwd_kernel(BwdP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = p.d;
  const int ldx = d.kp() + SKEW, ldo = d.rsp() + SKEW, ldy = 2 * d.Dp + SKEW;
  const int ubytes = 2 * TM * max(ldx, ldo + ldy);
  float* stage = reinterpret_cast<float*>(smem + ubytes);
  const int b = blockIdx.y;
  const int c0 = p.r0 + blockIdx.x * p.chunk;
  const int c1 = min(c0 + p.chunk, d.P);
  if (c0 >= c1) return;
  if (NL == 2) {
    // halo: layer 2 on the rows above the chunk, for its prev-tap
    // cotangent into the chunk's top rows
    const int hi = min(c1 + p.L[1].dd, d.P);
    for (int t0 = c1; t0 < hi; t0 += TM)
      bwd_layer_tile(p, HALO, b, t0, min(TM, hi - t0), c0, smem, stage);
  }
  const int nt = (c1 - c0 + TM - 1) / TM;
  for (int k = nt - 1; k >= 0; --k) {  // descending tiles
    const int t0 = c0 + k * TM, nr = min(TM, c1 - t0);
    if (NL == 2) {
      bwd_layer_tile(p, UPPER, b, t0, nr, c0, smem, stage);
      bwd_layer_tile(p, LOWER, b, t0, nr, c0, smem, stage);
    } else {
      bwd_layer_tile(p, SINGLE, b, t0, nr, c0, smem, stage);
    }
  }
}

// ------------------------------------- whole stack / group, one launch

constexpr long long SPIN_LIMIT = 1LL << 34;  // clock cycles (several seconds)

// Barrier n (counted from 0) across a cooperative grid: every block's
// writes before it are visible to every block after it.  `count` starts
// at zero and only grows.
__device__ __forceinline__ void grid_barrier(unsigned long long* count, int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1ULL);
    const unsigned long long want = (unsigned long long)(n + 1) * gridDim.x;
    const long long t_start = clock64();
    while (*(volatile unsigned long long*)count < want)
      if (clock64() - t_start > SPIN_LIMIT) __trap();
    __threadfence();
  }
  __syncthreads();
}

// The most layers one launch takes: the per-layer tables travel by value in
// the kernel's parameters (4 KB in all), so no launch waits on a copy.
constexpr int MAX_FUSED = 40;

struct StackLayer {
  const bf16* win; const float* bin; const bf16* wout; const float* bout;
  bf16* y;          // [B, P, 2D] or null
  const bf16* xin;  // the layer's input stream [B, P, R]
  bf16* xout;       // its output stream, or null (the last layer's is unused)
  int dd;
};

struct StackP {
  Dims d;
  const bf16* cond; float* skip;
  unsigned long long* bar;
  int n_layers, r0, n_tiles;  // tiles of TM rows from r0, per batch row
  StackLayer layers[MAX_FUSED];
};

// Every layer on rows [r0, P), layer-major: tile k of every layer goes to
// block k mod gridDim.x, so a block adds its skip terms to rows that only
// it touches, and reads from other blocks only the previous layer's rows
// below its tile, complete since the barrier.
__global__ void __launch_bounds__(NTHR)
gated_stack_kernel(const __grid_constant__ StackP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = p.d;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + TM * (d.kp() + SKEW);
  float* stage = reinterpret_cast<float*>(hs + TM * (d.Dp + SKEW));
  FwdP fp;
  fp.d = d;
  fp.skip = p.skip;
  const int total = d.B * p.n_tiles;
  for (int l = 0; l < p.n_layers; ++l) {
    const StackLayer sl = p.layers[l];
    const FwdLayer fl{sl.win, sl.bin, sl.wout, sl.bout, sl.y, sl.dd};
    const int lo = l == 0 ? 0 : p.r0;  // x0 is valid from row 0
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int b = tile / p.n_tiles;
      const int t0 = p.r0 + (tile % p.n_tiles) * TM;
      const int nr = min(TM, d.P - t0);
      const bf16* xb = sl.xin + (size_t)b * d.P * d.R;
      load_xin(xs, d, b, t0, nr, p.cond, true,
               [&](int g) -> const bf16* {
                 const int s = g - fl.dd;
                 return s >= lo ? xb + (size_t)s * d.R : nullptr;
               },
               [&](int g) -> const bf16* { return xb + (size_t)g * d.R; }, 0);
      __syncthreads();
      fwd_layer_tile(fp, fl, b, t0, nr,
                     sl.xout ? sl.xout + (size_t)b * d.P * d.R : nullptr, 0,
                     false, xs, hs, stage);
    }
    if (l + 1 < p.n_layers) grid_barrier(p.bar, l);
  }
}

// The group's layers, lower layer first, are BwdLayer rows.

struct GroupP {
  Dims d;
  const bf16* cond; const bf16* gxcur; const bf16* gxprev; const bf16* gskip;
  float* gcond; bf16* gxc; bf16* gxp;
  float* gcur;    // f32 same-row cotangent between layers, updated in place
  float* gp[2];   // f32 prev-tap cotangents at row g - dd, used in turn
  unsigned long long* bar;
  int n_layers, prev_dd, cur_vl, r0, n_tiles;
  BwdLayer layers[MAX_FUSED];
};

// The group's layers from the top down, each on rows [r0, P) masked to its
// own lattice, layer-major with the forward's tile-to-block map: gcond rows
// belong to one block, and the cotangents a tile reads from other blocks
// (the layer above's prev-tap part for rows up to dd above it) are complete
// since the barrier.
__global__ void __launch_bounds__(NTHR)
gated_group_kernel(const __grid_constant__ GroupP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dims& d = p.d;
  const int ldx = d.kp() + SKEW, ldo = d.rsp() + SKEW, ldy = 2 * d.Dp + SKEW;
  const int ubytes = 2 * TM * max(ldx, ldo + ldy);
  float* stage = reinterpret_cast<float*>(smem + ubytes);
  BwdP q;
  q.d = d;
  q.cond = p.cond; q.gxcur = p.gxcur; q.gxprev = p.gxprev; q.gskip = p.gskip;
  q.gcond = p.gcond; q.gxc = p.gxc; q.gxp = p.gxp;
  q.gcur2 = p.gcur; q.yf = nullptr;
  q.prev_dd = p.prev_dd; q.cur_vl = p.cur_vl; q.r0 = p.r0; q.chunk = 0;
  const int total = d.B * p.n_tiles, top = p.n_layers - 1;
  for (int j = top; j >= 0; --j) {
    const BwdLayer bl = p.layers[j];
    const int mode = j == top ? UPPER : (j == 0 ? LOWER : INNER);
    // UPPER takes its layer from slot 1; LOWER and INNER take theirs from
    // slot 0 and the dilation of the layer above from slot 1
    if (j == top) {
      q.L[1] = bl;
    } else {
      q.L[0] = bl;
      q.L[1].dd = p.layers[j + 1].dd;
    }
    q.gp2 = p.gp[(top - j + 1) & 1];
    q.gp2w = p.gp[(top - j) & 1];
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int b = tile / p.n_tiles;
      const int t0 = p.r0 + (tile % p.n_tiles) * TM;
      bwd_layer_tile(q, mode, b, t0, min(TM, d.P - t0), p.r0, smem, stage);
    }
    if (j > 0) grid_barrier(p.bar, top - j);
  }
}

// Launch `kernel` with as many blocks as fit on the card at once (at most
// n_tiles), cooperatively: the grid barrier needs them all resident.
template <typename P>
int launch_resident(void (*kernel)(P), P& p, int n_tiles, int smem,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHR,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int blocks = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NTHR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// ------------------------------------------------------ weight gradients

constexpr int DW_BM = 128, DW_BN = 128, DW_BK = 32, DW_LD = DW_BN + SKEW;

struct DwP {
  int B, P, lo;     // rows [lo, P) of every batch row
  int kind;         // 0: A = xin gathered from x (dd) and cond; 1: A = a
  const bf16* x; const bf16* cond; int dd, R, C;
  const bf16* a; int ka;
  const bf16* g; int N;
  int M;            // A's columns (2R + C, or ka)
  float* part; long long rows_per;
};

// Columns m..m+7 of A's row (b, g); the widths are multiples of 8, so no
// 8-column chunk straddles two of xin's parts.
__device__ __forceinline__ uint4 dw_a8(const DwP& p, int b, int g, int m) {
  const size_t rb = (size_t)b * p.P;
  const uint4 z = make_uint4(0, 0, 0, 0);
  if (m >= p.M) return z;
  const bf16* src;
  if (p.kind == 1) src = p.a + (rb + g) * p.ka + m;
  else if (m < p.R) {
    if (g - p.dd < 0) return z;
    src = p.x + (rb + g - p.dd) * p.R + m;
  } else if (m < 2 * p.R) src = p.x + (rb + g) * p.R + (m - p.R);
  else src = p.cond + (rb + g) * p.C + (m - 2 * p.R);
  return *reinterpret_cast<const uint4*>(src);
}

// part[s][m][n] = sum over split s's rows of A[row][m] * G[row][n]:
// 128 x 128 output tiles, 8 warps of 64 x 32, 32 rows per step, the next
// step's rows prefetched into registers and a second shared buffer.
__global__ void __launch_bounds__(NTHR) gated_dw_kernel(DwP p) {
  __shared__ __align__(128) unsigned short sa[2][DW_BK * DW_LD];
  __shared__ __align__(128) unsigned short sb[2][DW_BK * DW_LD];
  const int ntn = (p.N + DW_BN - 1) / DW_BN;
  const int m0 = (blockIdx.x / ntn) * DW_BM, n0 = (blockIdx.x % ntn) * DW_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp >> 2, wn = warp & 3;
  const int nrw = p.P - p.lo;
  const long long total = (long long)p.B * nrw;
  const long long rs = (long long)blockIdx.y * p.rows_per;
  const long long re = min(total, rs + p.rows_per);
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  uint4 ra[2], rb[2];
  auto fetch = [&](long long r0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = threadIdx.x + j * NTHR, kr = c >> 4, cc = (c & 15) * 8;
      const long long rho = r0 + kr;
      ra[j] = rb[j] = make_uint4(0, 0, 0, 0);
      if (rho < re) {
        const int b = (int)(rho / nrw), g = p.lo + (int)(rho % nrw);
        ra[j] = dw_a8(p, b, g, m0 + cc);
        if (n0 + cc < p.N)
          rb[j] = *reinterpret_cast<const uint4*>(
              p.g + ((size_t)b * p.P + g) * p.N + n0 + cc);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = threadIdx.x + j * NTHR, kr = c >> 4, cc = (c & 15) * 8;
      *reinterpret_cast<uint4*>(&sa[buf][kr * DW_LD + cc]) = ra[j];
      *reinterpret_cast<uint4*>(&sb[buf][kr * DW_LD + cc]) = rb[j];
    }
  };
  fetch(rs);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (long long r0 = rs; r0 < re; r0 += DW_BK) {
    const bool more = r0 + DW_BK < re;
    if (more) fetch(r0 + DW_BK);
    const bf16* A = reinterpret_cast<const bf16*>(sa[buf]);
    const bf16* G = reinterpret_cast<const bf16*>(sb[buf]);
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 16) {
      FragAc a[4];  // A^T[m][k] = A[k][m]
      FragB bg[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], A + kk * DW_LD + wm * 64 + i * 16, DW_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bg[j], G + kk * DW_LD + wn * 32 + j * 16, DW_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bg[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  float* st = reinterpret_cast<float*>(sa) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 64 + i * 16 + e / 16;
        const int n = n0 + wn * 32 + j * 16 + e % 16;
        if (m < p.M && n < p.N)
          p.part[((size_t)blockIdx.y * p.M + m) * p.N + n] = st[e];
      }
      __syncwarp();
    }
}

// part[s][n] = sum over split s's rows of G[row][n] (the bias gradients)
__global__ void gated_colsum_kernel(const bf16* g, int P, int lo, int N,
                                    long long total, long long rows_per,
                                    float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int nrw = P - lo;
  const long long rs = (long long)blockIdx.y * rows_per;
  const long long re = min(total, rs + rows_per);
  float s = 0.f;
  if (rs < re) {
    int b = (int)(rs / nrw), r = lo + (int)(rs % nrw);
    for (long long rho = rs; rho < re; ++rho) {
      s += __bfloat162float(g[((size_t)b * P + r) * N + n]);
      if (++r == P) { r = lo; ++b; }
    }
  }
  part[(size_t)blockIdx.y * N + n] = s;
}

// out[i] = sum_s part[s][i], in order of s
__global__ void gated_reduce_kernel(const float* part, float* out, int splits,
                                    long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

int reduce(const float* part, float* out, int splits, long long n,
           cudaStream_t stream) {
  const long long nb = (n + 255) / 256;
  gated_reduce_kernel<<<(int)(nb < 1024 ? nb : 1024), 256, 0, stream>>>(
      part, out, splits, n);
  return (int)cudaGetLastError();
}

Dims dims_from(const int* iv) {
  Dims d;
  d.B = iv[0]; d.P = iv[1]; d.R = iv[2]; d.C = iv[3]; d.D = iv[4]; d.S = iv[5];
  d.Rp = iv[6]; d.Cp = iv[7]; d.Dp = iv[8]; d.Sp = iv[9];
  return d;
}

}  // namespace

extern "C" {

int awt_gated_fwd_smem(const int* iv) {
  Dims d = dims_from(iv);
  return 2 * TM * (d.kp() + SKEW) + 2 * TM * (d.Dp + SKEW) + 4 * NWARP * STAGE;
}

int awt_gated_bwd_smem(const int* iv) {
  Dims d = dims_from(iv);
  const int a = d.kp() + SKEW, c = d.rsp() + SKEW + 2 * d.Dp + SKEW;
  const int u = 2 * TM * (a > c ? a : c);
  return u + 4 * NWARP * STAGE;
}

// ptr: x, cond, skip, mid, xout, halo, then per layer win, bin, wout, bout, y
// iv: 10 dims, r0, chunk, dd1, dd2, n_chunks
int awt_gated_fwd(int nl, void* const* ptr, const int* iv, cudaStream_t stream) {
  FwdP p;
  p.d = dims_from(iv);
  p.x = (const bf16*)ptr[0]; p.cond = (const bf16*)ptr[1];
  p.skip = (float*)ptr[2]; p.mid = (bf16*)ptr[3]; p.xout = (bf16*)ptr[4];
  p.halo = (bf16*)ptr[5];
  for (int l = 0; l < 2; ++l) {
    void* const* q = ptr + 6 + 5 * l;
    p.L[l] = FwdLayer{(const bf16*)q[0], (const float*)q[1], (const bf16*)q[2],
                      (const float*)q[3], (bf16*)q[4], iv[12 + l]};
  }
  p.r0 = iv[10]; p.chunk = iv[11];
  const int smem = awt_gated_fwd_smem(iv);
  dim3 grid(iv[14], p.d.B);
  if (nl == 2) {
    cudaFuncSetAttribute(gated_fwd_kernel<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    gated_fwd_kernel<2><<<grid, NTHR, smem, stream>>>(p);
  } else {
    cudaFuncSetAttribute(gated_fwd_kernel<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    gated_fwd_kernel<1><<<grid, NTHR, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// ptr: cond, gxcur, gxprev, gskip, gcond, gxc, gxp, gcur2, gp2, yf, then per
//      layer x, y, win, bin, wout, gy, h, gout
// iv: 10 dims, prev_dd, cur_vl, r0, chunk, dd1, vl1, dd2, vl2, n_chunks
int awt_gated_bwd(int nl, void* const* ptr, const int* iv, cudaStream_t stream) {
  BwdP p;
  p.d = dims_from(iv);
  p.cond = (const bf16*)ptr[0]; p.gxcur = (const bf16*)ptr[1];
  p.gxprev = (const bf16*)ptr[2]; p.gskip = (const bf16*)ptr[3];
  p.gcond = (float*)ptr[4]; p.gxc = (bf16*)ptr[5]; p.gxp = (bf16*)ptr[6];
  p.gcur2 = (float*)ptr[7]; p.gp2 = p.gp2w = (float*)ptr[8];
  p.yf = (float*)ptr[9];
  for (int l = 0; l < 2; ++l) {
    void* const* q = ptr + 10 + 8 * l;
    p.L[l] = BwdLayer{(const bf16*)q[0], (const bf16*)q[1], (const bf16*)q[2],
                      (const float*)q[3], (const bf16*)q[4], (bf16*)q[5],
                      (bf16*)q[6], (bf16*)q[7], iv[14 + 2 * l], iv[15 + 2 * l]};
  }
  p.prev_dd = iv[10]; p.cur_vl = iv[11]; p.r0 = iv[12]; p.chunk = iv[13];
  const int smem = awt_gated_bwd_smem(iv);
  dim3 grid(iv[18], p.d.B);
  if (nl == 2) {
    cudaFuncSetAttribute(gated_bwd_kernel<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    gated_bwd_kernel<2><<<grid, NTHR, smem, stream>>>(p);
  } else {
    cudaFuncSetAttribute(gated_bwd_kernel<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    gated_bwd_kernel<1><<<grid, NTHR, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

int awt_gated_max_fused_layers() { return MAX_FUSED; }

// The whole-stack forward.  ptr: cond, skip, bar (one zeroed 64-bit count),
// then per layer win, bin, wout, bout, y, xin, xout
// iv: 10 dims, n_layers, r0, then dd per layer
int awt_gated_stack(void* const* ptr, const int* iv, cudaStream_t stream) {
  StackP p;
  p.d = dims_from(iv);
  p.cond = (const bf16*)ptr[0]; p.skip = (float*)ptr[1];
  p.bar = (unsigned long long*)ptr[2];
  p.n_layers = iv[10]; p.r0 = iv[11];
  p.n_tiles = (p.d.P - p.r0 + TM - 1) / TM;
  if (p.n_layers < 1 || p.n_layers > MAX_FUSED || p.n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.n_layers; ++l) {
    void* const* q = ptr + 3 + 7 * l;
    p.layers[l] = StackLayer{(const bf16*)q[0], (const float*)q[1],
                             (const bf16*)q[2], (const float*)q[3], (bf16*)q[4],
                             (const bf16*)q[5], (bf16*)q[6], iv[12 + l]};
  }
  return launch_resident(gated_stack_kernel, p, p.d.B * p.n_tiles,
                         awt_gated_fwd_smem(iv), stream);
}

// The grouped backward (saved y).  ptr: cond, gxcur, gxprev, gskip, gcond,
// gxc, gxp, gcur, gp0, gp1, bar (one zeroed 64-bit count), then per layer
// (lower layer first) x, y, win, bin, wout, gy, h, gout
// iv: 10 dims, n_layers, prev_dd, cur_vl, r0, then dd, vl per layer
int awt_gated_group(void* const* ptr, const int* iv, cudaStream_t stream) {
  GroupP p;
  p.d = dims_from(iv);
  p.cond = (const bf16*)ptr[0]; p.gxcur = (const bf16*)ptr[1];
  p.gxprev = (const bf16*)ptr[2]; p.gskip = (const bf16*)ptr[3];
  p.gcond = (float*)ptr[4]; p.gxc = (bf16*)ptr[5]; p.gxp = (bf16*)ptr[6];
  p.gcur = (float*)ptr[7]; p.gp[0] = (float*)ptr[8]; p.gp[1] = (float*)ptr[9];
  p.bar = (unsigned long long*)ptr[10];
  p.n_layers = iv[10]; p.prev_dd = iv[11]; p.cur_vl = iv[12]; p.r0 = iv[13];
  p.n_tiles = (p.d.P - p.r0 + TM - 1) / TM;
  if (p.n_layers < 2 || p.n_layers > MAX_FUSED || p.n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.n_layers; ++l) {
    void* const* q = ptr + 11 + 8 * l;
    p.layers[l] = BwdLayer{(const bf16*)q[0], (const bf16*)q[1], (const bf16*)q[2],
                           (const float*)q[3], (const bf16*)q[4], (bf16*)q[5],
                           (bf16*)q[6], (bf16*)q[7], iv[14 + 2 * l], iv[15 + 2 * l]};
  }
  return launch_resident(gated_group_kernel, p, p.d.B * p.n_tiles,
                         awt_gated_bwd_smem(iv), stream);
}

// ptr: x, cond, a, g, part, out, part_b, out_b
// iv: B, P, lo, kind, dd, R, C, ka, N, M, splits, rows_per, splits_b, rows_per_b
int awt_gated_dw(void* const* ptr, const int* iv, cudaStream_t stream) {
  DwP p;
  p.B = iv[0]; p.P = iv[1]; p.lo = iv[2]; p.kind = iv[3]; p.dd = iv[4];
  p.R = iv[5]; p.C = iv[6]; p.ka = iv[7]; p.N = iv[8]; p.M = iv[9];
  p.x = (const bf16*)ptr[0]; p.cond = (const bf16*)ptr[1];
  p.a = (const bf16*)ptr[2]; p.g = (const bf16*)ptr[3];
  p.part = (float*)ptr[4]; p.rows_per = iv[11];
  const int splits = iv[10], splits_b = iv[12];
  dim3 grid(((p.M + DW_BM - 1) / DW_BM) * ((p.N + DW_BN - 1) / DW_BN), splits);
  gated_dw_kernel<<<grid, NTHR, 0, stream>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if ((rc = reduce(p.part, (float*)ptr[5], splits, (long long)p.M * p.N, stream)))
    return rc;
  const long long total = (long long)p.B * (p.P - p.lo);
  dim3 gb((p.N + 255) / 256, splits_b);
  gated_colsum_kernel<<<gb, 256, 0, stream>>>(p.g, p.P, p.lo, p.N, total, iv[13],
                                              (float*)ptr[6]);
  if ((rc = (int)cudaGetLastError())) return rc;
  return reduce((const float*)ptr[6], (float*)ptr[7], splits_b, p.N, stream);
}

}  // extern "C"
