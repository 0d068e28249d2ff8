// Fused autoregressive WaveNet sampler for Hopper (sm_90a): bf16, int8 and
// int4 weights, and a mixture-of-logistics output, one kernel template.
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
// Mixture of logistics (MOL_BF16, bf16 weights; the port's own, no TPU
// kernel): the input is a sample x in [-1, 1] and P2 gives K = n_mix
// mixture parameters a row, [logits | means | log_scales] (n_quant = 3 K):
//   x0 = x * w_in0 + b_in0                    (f32, no fused multiply-add)
//   the layers and the post-net as above; P2's 3 K values of each row are
//   exchanged across the grid (one barrier, where the argmax's is);
//   k = argmax(logit_j / T + g_j), g_j the Gumbel draw of column j < K as
//       above (first index on ties); at temperature 0, k = argmax(logit_j)
//   x = clamp(mu_k + exp(max(log_s_k, log_scale_min)) * (log v - log(1 - v)),
//       -1, 1), v = clamp(u, 1e-5, 0.99999) with u the uniform of column K
//       of the same Philox stream; at temperature 0, x = clamp(mu_k, -1, 1)
//   the output is x (f32), and each block maps it into its own residual
//   columns for the next step.  2 L + 3 barriers a step, as above.
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
//   is code + 8 in [1, 15] (row k + Kp/2).  sum = xq_hi . hi + xq_lo . lo
//   - 8 * sum(xq_lo), the zero-point folded into a row-sum correction.
// The integer sums are exact, so kernel and plain version differ only
// through tanhf/expf and the order of the post-net's f32 sums.
//
// What bounds it on this card.  The AR dependency allows no reuse of a
// weight within a step, and every step needs all layer weights (25.6 MB in
// bf16 at the flagship width).  Streamed from L2 by a few SMs they bound the
// step at tens of GB/s per SM, so here they do not move: one persistent
// cooperative grid of G blocks (about one per SM; 128 at the flagship
// width) splits every matrix by output column, and block r keeps its share
// (its filter and gate columns of W_in, residual and skip columns of W_out,
// columns of P1 and P2: 201,728 bytes in bf16 at the flagship width) in
// shared memory for the whole launch, copied there once at the start, with
// its columns' biases, scales and embedding columns.  The share is K-major
// per owned column in 64-byte chunks (the host's share plan,
// ops/fastgen_cuda.share_plan).  Layers whose shares do not fit stay in
// global memory and the same code reads them through L2 each step.
//
// What remains per step is the dependency chain, 2 L + 3 grid barriers:
//   per layer: each block reads and writes the ring slots of its own
//     residual columns (loaded a layer ahead) and publishes x_prev and
//     bf16(x) there (global scratch); barrier; every block computes its
//     filter and gate columns over the whole xin and publishes h; barrier;
//     every block computes its residual and skip columns over the whole h
//     and updates its own columns of x and skip (which only it touches, in
//     shared memory while they fit);
//   post-net: relu(skip) of the own columns; barrier; P1 columns; barrier;
//     P2 columns and each row's best (score, index) over the own columns;
//     barrier; every block reduces all blocks' candidates in block order
//     (first index on ties), so all agree on the id without a further
//     exchange, and embeds it into its own columns.
// The products run on the tensor cores (mma.sync, bf16 or s8, 8 real rows
// of 16), each lane loading its operand straight from L2 into registers,
// several 16-byte loads in flight; the quantized branches quantize each
// value as it arrives.  At small B the barriers (an arrival and an L2 round
// trip each) and the operand round trips bound the step; at large B the
// activations' L2 reads, and for int8 / int4 the quantization, do.
// Exchanged data is written with plain stores before a barrier (release:
// the arrival is a red.release after the block's own barrier) and read after
// it (acquire) with ld.global.cg (L2, never a stale L1 line), never through
// the read-only path.  A barrier that is not met within seconds traps: a
// loud failure, never a hang.
//
// Quantized: every block reads the whole activation matrix for its own
// product, so it quantizes it itself; the batch-wide scale is the max of the
// blocks' published maxima over their own columns (written before the
// barrier that is there anyway) and of cond_t, which every block reads
// itself.  No reduction crosses the grid beyond the barriers of the bf16
// branch, and no batch bound exists: every phase loops over passes of 64
// rows.
//
// Sums are taken in a fixed order (no float atomics): two launches on the
// same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BT = 8;          // batch rows of a GEMM unit (an mma's real rows)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LAYERS = 64;
constexpr long long SPIN_LIMIT = 1LL << 34;  // clock cycles (several seconds)
constexpr int OWN_BYTES = 4096;  // shared memory for a block's x and skip columns

enum Mode { BF16 = 0, INT8 = 1, INT4 = 2, MOL_BF16 = 3 };

// Everything the kernel takes; the host fills it from two flat arrays.
struct Params {
  const uint8_t* share;        // [G, stride] the blocks' weight shares
  const float* w_in_s;         // quantized: [L, 2*n_dil] column scales
  const float* b_in;           // [L, 2*n_dil]
  const float* w_out_s;        // quantized: [L, n_res+n_skp]
  const float* b_out;          // [L, n_res+n_skp]
  const __nv_bfloat16* embed;  // [n_quant, n_res]
  const float* p1b;            // [n_post]
  const float* p2b;            // [n_quant]
  const __nv_bfloat16* cond;   // [T, B, n_cond]
  const int* prev_id;          // [B]
  __nv_bfloat16* ring;         // [sum d, B, n_res]
  int* ids;                    // [B, T]
  int* last_id;                // [B]
  float* logits;               // [T, B, n_quant] or null
  // scratch
  unsigned long long* count;   // barrier arrivals, zeroed by the host
  __nv_bfloat16* xg;           // [B, 2*n_res] x_prev | bf16(x)
  void* hg;                    // [B, n_dil] bf16 h (quantized: f32)
  __nv_bfloat16* pg;           // [B, n_skp] bf16(relu(skip))
  __nv_bfloat16* p1g;          // [B, n_post] bf16(relu(P1 out))
  float* cand_v;               // [B, G] each block's best score
  int* cand_i;                 // [B, G] and its column (-1: none)
  float* xo;                   // [B, n_res] x (own columns per block)
  float* so;                   // [B, n_skp] skip (own columns per block)
  float* maxx;                 // [G] quantized: published max|xin| slices
  float* maxh;                 // [G] quantized: published max|h| slices
  float* mix;                  // [B, 3 n_mix] MOL_BF16: the exchanged P2 outputs
  // MOL_BF16 in place of embed, prev_id, ids and last_id (null otherwise)
  const float* in0;            // [2, n_res] rows w_in0 and b_in0
  const float* x_prev;         // [B] the samples before the first step
  float* samples;              // [B, T]
  float* last_x;               // [B]
  int B, T, L, n_res, n_dil, n_skp, n_post, n_quant, n_cond, t0;
  uint32_t seed;
  int greedy;
  int G, R;                    // blocks; layers resident in shared memory
  int stride;                  // bytes of one block's share
  int part_units;              // partial sums per row: most owned columns + 1
  int smem;                    // dynamic shared memory bytes
  int c_in, c_out, c_p1, c_p2; // bytes of one owned column of each matrix
  int resident_bytes;          // the shared-memory room for the share
  int aux_bytes;               // then for own biases, scales, embedding columns
  int n_mix;                   // MOL_BF16: the components
  float inv_temp;
  float log_scale_min;         // MOL_BF16: the log-scales' floor
  long long* clocks;           // null, or [3]: block 0's cycles in all, in the
                               // grid barriers and in the layers' GEMMs
                               // (instrumentation)
  int off[MAX_LAYERS], dil[MAX_LAYERS];
};

__device__ __forceinline__ float bf2f(unsigned short u) {
  return __bfloat162float(__ushort_as_bfloat16(u));
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

__device__ __forceinline__ float uniform(uint32_t seed, int row, int t_abs, int col) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)(col >> 2), (uint32_t)row, (uint32_t)t_abs, 0u),
      make_uint2(seed, 0u));
  const int w = col & 3;
  const uint32_t bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float gumbel(uint32_t seed, int row, int t_abs,
                                        int col) {
  const float u = uniform(seed, row, t_abs, col);
  return -logf(-logf(u + 1e-12f) + 1e-12f);
}

// The grid-wide barrier: every block's writes before it are visible to
// every block after it.  One thread per block arrives (release) and spins
// (acquire) on a monotone count, after the block's own barrier; `target` and `cycles` (the time from its
// block's arrival to the release) live in that thread.
__device__ __forceinline__ void grid_sync(unsigned long long* count,
                                          unsigned long long& target, int G,
                                          long long& cycles) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long start = clock64();
    target += (unsigned long long)G;
    asm volatile("red.release.gpu.global.add.u64 [%0], %1;"
                 :: "l"(count), "l"(1ULL) : "memory");
    unsigned long long seen;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      if (clock64() - start > SPIN_LIMIT) __trap();
    }
    cycles += clock64() - start;
  }
  __syncthreads();
}

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

// The max of the G published slots (after the barrier); every thread gets it.
__device__ __forceinline__ float slots_max(const float* slots, int G, float* bc) {
  if (threadIdx.x < 32) {
    float m = 0.f;
    for (int q = threadIdx.x; q < G; q += 32) m = fmaxf(m, __ldcg(slots + q));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) *bc = m;
  }
  __syncthreads();
  const float m = *bc;
  __syncthreads();
  return m;
}

// ------------------------------------------------- the GEMMs (mma.sync)

constexpr int PASS = 64;  // batch rows per pass of a GEMM: 8 row tiles of BT

// An activation matrix in global memory: row r is [na values of a's row r
// | nb values of b's row r | zeros].  `a` is scratch that other blocks wrote
// in this launch, read through L2 (ld.global.cg), never through the
// read-only path; `b` is a read-only bf16 input.
struct Src {
  const void* a;
  int lda, na;
  bool a32;  // a holds f32 (the quantized branches' h), else bf16
  const unsigned short* b;
  int ldb, nb;
};

// value k of row r as a float
__device__ __forceinline__ float src_at(const Src& s, int r, int k) {
  if (k < s.na)
    return s.a32 ? __ldcg(static_cast<const float*>(s.a) + (size_t)r * s.lda + k)
                 : bf2f(__ldcg(static_cast<const unsigned short*>(s.a) + (size_t)r * s.lda + k));
  if (k < s.na + s.nb) return bf2f(__ldg(s.b + (size_t)r * s.ldb + (k - s.na)));
  return 0.f;
}

// values k .. k + 7 of row r as 8 bf16, one value at a time (the rare
// unaligned or straddling case, kept out of line: the kernel's hot loops
// stay small enough for the instruction cache)
__device__ __noinline__ uint4 bf16_oct_slow(const Src s, int r, int k) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(src_at(s, r, k + 2 * j), src_at(s, r, k + 2 * j + 1));
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return u;
}

// values k .. k + 7 of row r as 8 bf16 in 16 bytes (one load where aligned)
__device__ __forceinline__ uint4 bf16_oct(const Src& s, int r, int k) {
  if (!s.a32 && k % 8 == 0 && k + 8 <= s.na && s.lda % 8 == 0)
    return __ldcg(reinterpret_cast<const uint4*>(
        static_cast<const unsigned short*>(s.a) + (size_t)r * s.lda + k));
  if (k % 8 == 0 && k >= s.na && k + 8 <= s.na + s.nb && s.na % 8 == 0 &&
      s.ldb % 8 == 0)
    return __ldg(reinterpret_cast<const uint4*>(s.b + (size_t)r * s.ldb + (k - s.na)));
  return bf16_oct_slow(s, r, k);
}

__device__ __noinline__ uint4 f32_quad_slow(const Src s, int r, int k) {
  return make_uint4(__float_as_uint(src_at(s, r, k)), __float_as_uint(src_at(s, r, k + 1)),
                    __float_as_uint(src_at(s, r, k + 2)), __float_as_uint(src_at(s, r, k + 3)));
}

// values k .. k + 3 of f32 row r as the bits of a float4 (one load where
// aligned)
__device__ __forceinline__ uint4 f32_quad(const Src& s, int r, int k) {
  if (k % 4 == 0 && k + 4 <= s.na && s.lda % 4 == 0)
    return __ldcg(reinterpret_cast<const uint4*>(
        static_cast<const float*>(s.a) + (size_t)r * s.lda + k));
  return f32_quad_slow(s, r, k);
}

// clip(rint(q), -127, 127) for q = v / s, the correctly rounded quotient, as
// the contract says.  v * (1 / s) is within 3 ulps of it (2e-5 below 128),
// so the two round to the same integer unless that product lies within
// 1e-4 of a half-integer: code_fast returns -128 there, and code_exact
// (out of line) divides.  rs = 1 / s rounded.  Zeros (the padding among
// them) are 0.
__device__ __forceinline__ int code_fast(float v, float rs) {
  const float t = v * rs;
  if (fabsf(t - floorf(t) - 0.5f) < 1e-4f && v != 0.f) return -128;
  return (int)fminf(fmaxf(rintf(t), -127.f), 127.f);
}

__device__ __noinline__ int code_exact(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// the int8 codes of values k .. k + 15 of row r, four to a register (byte j
// of w[e]: value k + 4 e + j); `sum` gains them.  rs = 1 / sq rounded.
__device__ __forceinline__ void code_hex(const Src& s, int r, int k, float sq, float rs,
                                         uint32_t (&w)[4], int& sum) {
  uint4 raw[4];  // every load is issued before any value is used
  if (s.a32) {
#pragma unroll
    for (int e = 0; e < 4; ++e) raw[e] = f32_quad(s, r, k + 4 * e);
  } else {
    raw[0] = bf16_oct(s, r, k);
    raw[1] = bf16_oct(s, r, k + 8);
  }
  float v[16];
  if (s.a32) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[4 * e] = __uint_as_float(raw[e].x);
      v[4 * e + 1] = __uint_as_float(raw[e].y);
      v[4 * e + 2] = __uint_as_float(raw[e].z);
      v[4 * e + 3] = __uint_as_float(raw[e].w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[e]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[8 * e + 2 * j] = f.x;
        v[8 * e + 2 * j + 1] = f.y;
      }
    }
  }
  int c[16];
  bool near = false;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    c[j] = code_fast(v[j], rs);
    near |= c[j] == -128;
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c[j] == -128) c[j] = code_exact(v[j], sq);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x |= (uint32_t)(c[4 * e + j] & 0xff) << (8 * j);
      sum += c[4 * e + j];
    }
    w[e] = x;
  }
}

// d[0..1] += the product's row g, columns 2 t and 2 t + 1.  Each product
// starts from zero and is added in f32 by the caller's FADD: the tensor
// core's own accumulation of a running sum rounds more coarsely than f32
// (measured: 5e-3 of max |logits| against the plain version after one
// step, 1e-7 this way).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float e[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(e[0]), "=f"(e[1]), "=f"(e[2]), "=f"(e[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  d[0] += e[0];
  d[1] += e[1];
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Units of a pass: (row tile, group of 8 owned columns, K segment), at
// least one per warp where the tiles and groups allow.
struct Units {
  int nrt, ncg, ks;
  __device__ Units(int nrows, int ncols)
      : nrt((nrows + BT - 1) / BT), ncg((ncols + 7) / 8),
        ks(nrt * ncg >= WARPS ? 1 : WARPS / (nrt * ncg)) {}
};

// Sums of this block's ncols owned columns (cb bytes each, K-major, at W:
// its shared memory for a resident share, global memory otherwise) against
// rows [row0, row0 + nrows) (nrows <= PASS) of src, whose inputs 0 .. K-1
// are the contraction, on the tensor cores (mma.sync
// m16n8k16 bf16 or m16n8k32 s8, f32 / s32 sums; rows 8-15 of each 16-row
// operand are zero).  A warp takes one unit: 8 rows, 8 columns and a
// segment of 64-byte column chunks.  Within a chunk lane (g, t) takes 16
// contiguous bytes of column g and the same inputs of row g, straight from
// L2 (quantized on the way in with scale sq): two products with the inputs
// of the mma's K in a permuted order, the same for both operands.  Several
// chunks' loads are in flight at once.  The sums go to part[((s * nrt + rt)
// * BT + row) * pu + col] (f32 for bf16 weights, int32 otherwise).  INT4:
// byte i of a column holds input i (high nibble, 16 x code) and input
// half + i (low nibble, code + 8): two products, the first shifted back by
// 4 at the end; 8 * the sum of each row's codes of the upper inputs (the
// zero-point correction) goes to col = ncols.
template <int MODE>
__device__ __noinline__ void share_gemm(const Src src, int K, float sq, const uint8_t* W,
                                        int ncols, int cb, int row0, int nrows, int pu,
                                        void* part_) {
  using Acc = typename std::conditional<MODE == BF16, float, int>::type;
  constexpr int U = MODE == BF16 ? 8 : 2;  // chunks in flight
  constexpr int KC = MODE == BF16 ? 32 : 64;  // inputs per chunk
  Acc* part = reinterpret_cast<Acc*>(part_);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column group
  const Units un(nrows, ncols);
  const int nch = cb / 64, seg = (nch + un.ks - 1) / un.ks;
  const int half = (K + 7) / 8 * 4;  // INT4: input i pairs with half + i
  const float rs = MODE == BF16 ? 0.f : __frcp_rn(sq);
  for (int u = warp; u < un.nrt * un.ncg * un.ks; u += WARPS) {
    const int rt = u % un.nrt, cg = (u / un.nrt) % un.ncg, s = u / (un.nrt * un.ncg);
    const int row = row0 + rt * BT + g;
    const bool row_on = rt * BT + g < nrows;
    const int col = cg * 8 + g;  // this lane's weight column
    const uint8_t* wc = W + (size_t)(col < ncols ? col : 0) * cb;
    const int c_lo = s * seg, c_hi = min(nch, c_lo + seg);
    Acc d[4] = {0, 0, 0, 0};
    int dl[4] = {0, 0, 0, 0}, zsum = 0;
    for (int c0 = c_lo; c0 < c_hi; c0 += U) {
      uint4 bw[U];
#pragma unroll
      for (int j = 0; j < U; ++j)
        bw[j] = col < ncols && c0 + j < c_hi
                    ? *reinterpret_cast<const uint4*>(wc + 64 * (c0 + j) + 16 * t)
                    : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (MODE == BF16) {
        uint4 av[U];
#pragma unroll
        for (int j = 0; j < U; ++j)
          av[j] = row_on && c0 + j < c_hi ? bf16_oct(src, row, KC * (c0 + j) + 8 * t)
                                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const uint32_t a1[4] = {av[j].x, 0u, av[j].y, 0u};
          const uint32_t a2[4] = {av[j].z, 0u, av[j].w, 0u};
          mma_bf16(d, a1, bw[j].x, bw[j].y);
          mma_bf16(d, a2, bw[j].z, bw[j].w);
        }
      } else {  // quantized on the way in
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int i0 = KC * (c0 + j) + 16 * t;  // byte index = input index
          uint32_t q[4] = {0u, 0u, 0u, 0u}, ql[4] = {0u, 0u, 0u, 0u};
          int unused = 0;
          if (row_on && c0 + j < c_hi) {
            code_hex(src, row, i0, sq, rs, q, unused);
            // int4: inputs half + i only for bytes i below half (the rest
            // of a column's bytes are padding, zero in the weights)
            if (MODE == INT4 && i0 < half) code_hex(src, row, half + i0, sq, rs, ql, zsum);
          }
          const uint32_t hm = MODE == INT4 ? 0xF0F0F0F0u : 0xFFFFFFFFu;
          const uint32_t a1[4] = {q[0], 0u, q[1], 0u};
          const uint32_t a2[4] = {q[2], 0u, q[3], 0u};
          mma_s8(d, a1, bw[j].x & hm, bw[j].y & hm);
          mma_s8(d, a2, bw[j].z & hm, bw[j].w & hm);
          if constexpr (MODE == INT4) {
            const uint32_t b1[4] = {ql[0], 0u, ql[1], 0u};
            const uint32_t b2[4] = {ql[2], 0u, ql[3], 0u};
            mma_s8(dl, b1, bw[j].x & 0x0F0F0F0Fu, bw[j].y & 0x0F0F0F0Fu);
            mma_s8(dl, b2, bw[j].z & 0x0F0F0F0Fu, bw[j].w & 0x0F0F0F0Fu);
          }
        }
      }
    }
    if constexpr (MODE == INT4) {
      d[0] = (d[0] >> 4) + dl[0];  // the high products: exact multiples of 16
      d[1] = (d[1] >> 4) + dl[1];
      zsum += __shfl_xor_sync(0xffffffffu, zsum, 1);
      zsum += __shfl_xor_sync(0xffffffffu, zsum, 2);
    }
    if (row_on) {  // d[0], d[1]: row g, columns 2 t and 2 t + 1 of the group
      Acc* out = part + ((size_t)(s * un.nrt + rt) * BT + g) * pu;
      const int c = cg * 8 + 2 * t;
      if (c < ncols) out[c] = d[0];
      if (c + 1 < ncols) out[c + 1] = d[1];
      if (MODE == INT4 && cg == 0 && t == 0) out[ncols] = (Acc)(8 * zsum);
    }
  }
}

// Column v's sum for pass row i (of nrows; ncols columns), its K segments
// added in order.
template <typename Acc>
__device__ __forceinline__ Acc part_sum(const void* part_, int nrows, int ncols, int pu,
                                        int i, int v) {
  const Acc* part = reinterpret_cast<const Acc*>(part_);
  const Units un(nrows, ncols);
  const int rt = i / BT, r = i % BT;
  Acc s = 0;
  for (int q = 0; q < un.ks; ++q) s += part[((size_t)(q * un.nrt + rt) * BT + r) * pu + v];
  return s;
}

// ------------------------------------------------------------- the kernel

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
fastgen_kernel(const __grid_constant__ Params p) {
  constexpr bool MOL = MODE == MOL_BF16;
  constexpr int WQ = MOL ? BF16 : MODE;  // the weights' mode
  constexpr bool Q = WQ != BF16;
  constexpr bool I4 = WQ == INT4;
  using Acc = typename std::conditional<Q, int, float>::type;
  const long long t_start = clock64();
  long long bar_cycles = 0, gemm_cycles = 0;  // block 0, thread 0: instrumentation
  const int r = blockIdx.x, G = p.G, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int B = p.B, n_res = p.n_res, n_dil = p.n_dil, n_skp = p.n_skp;
  const int xin_len = 2 * n_res + p.n_cond, pu = p.part_units;
  // own columns: [lo, lo + n) of each width, as the host's share plan
  const int f_lo = n_dil * r / G, nf = n_dil * (r + 1) / G - f_lo;
  const int r_lo = n_res * r / G, nr = n_res * (r + 1) / G - r_lo;
  const int s_lo = n_skp * r / G, ns = n_skp * (r + 1) / G - s_lo;
  const int q1_lo = p.n_post * r / G, nq1 = p.n_post * (r + 1) / G - q1_lo;
  const int q2_lo = p.n_quant * r / G, nq2 = p.n_quant * (r + 1) / G - q2_lo;
  const int post_bytes = nq1 * p.c_p1 + nq2 * p.c_p2;
  const int layer_bytes = 2 * nf * p.c_in + (nr + ns) * p.c_out;
  const uint8_t* gshare = p.share + (size_t)r * p.stride;

  extern __shared__ __align__(16) uint8_t smem[];
  // after the resident share: the own columns' biases (and scales) of every
  // layer, of the post-net, and the embedding's own columns
  const int pl = 2 * nf + nr + ns;  // per layer: filter, gate, res, skip
  float* a_b = reinterpret_cast<float*>(smem + p.resident_bytes);  // [L, pl]
  float* a_s = a_b + p.L * pl;                                     // [L, pl]
  float* a_p1 = a_s + p.L * pl;                                    // [nq1]
  float* a_p2 = a_p1 + nq1;                                        // [nq2]
  __nv_bfloat16* a_emb = reinterpret_cast<__nv_bfloat16*>(a_p2 + nq2);  // [n_quant, nr]
  float* a_in0 = a_p2 + nq2;  // MOL: [2, nr] own columns of w_in0, b_in0
  void* part = smem + p.resident_bytes + p.aux_bytes;              // [PASS, pu]
  float* sc = reinterpret_cast<float*>(part) + PASS * pu;          // [PASS, pu]
  float* wred = sc + PASS * pu;                                    // [WARPS]
  float* bc = wred + WARPS;                                        // [1]
  // this block's columns of x and skip: in shared memory when they fit
  const bool own_smem = B * (nr + ns) * 4 <= OWN_BYTES;
  float* xs = own_smem ? reinterpret_cast<float*>(smem + p.smem - OWN_BYTES) : p.xo + r_lo;
  float* ss = own_smem ? xs + B * nr : p.so + s_lo;
  const int x_ld = own_smem ? nr : n_res, s_ld = own_smem ? ns : n_skp;

  // the resident share: post-net, then the first R layers
  const int resident = post_bytes + p.R * layer_bytes;
  for (int i = tid; i < resident / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = __ldg(reinterpret_cast<const uint4*>(gshare) + i);
  const uint8_t* post1 = smem;
  const uint8_t* post2 = smem + nq1 * p.c_p1;
  for (int i = tid; i < p.L * pl; i += THREADS) {
    const int l = i / pl, v = i % pl;
    const int ci = v < nf ? f_lo + v : n_dil + f_lo + v - nf;  // column of W_in
    const int co = v < 2 * nf + nr ? r_lo + v - 2 * nf : n_res + s_lo + v - 2 * nf - nr;
    const size_t li = (size_t)l * 2 * n_dil + ci, lo = (size_t)l * (n_res + n_skp) + co;
    a_b[i] = v < 2 * nf ? p.b_in[li] : p.b_out[lo];
    if constexpr (Q) a_s[i] = v < 2 * nf ? p.w_in_s[li] : p.w_out_s[lo];
  }
  for (int j = tid; j < nq1; j += THREADS) a_p1[j] = p.p1b[q1_lo + j];
  for (int j = tid; j < nq2; j += THREADS) a_p2[j] = p.p2b[q2_lo + j];
  if constexpr (MOL) {
    for (int i = tid; i < 2 * nr; i += THREADS)
      a_in0[i] = p.in0[(size_t)(i / nr) * n_res + r_lo + i % nr];
  } else {
    for (int i = tid; i < p.n_quant * nr; i += THREADS)
      a_emb[i] = p.embed[(size_t)(i / nr) * n_res + r_lo + i % nr];
  }
  __syncthreads();

  for (int i = tid; i < B * nr; i += THREADS) {
    const int b = i / nr, c = i % nr;
    if constexpr (MOL)
      xs[b * x_ld + c] = __fadd_rn(__fmul_rn(p.x_prev[b], a_in0[c]), a_in0[nr + c]);
    else
      xs[b * x_ld + c] = __bfloat162float(a_emb[p.prev_id[b] * nr + c]);
  }
  for (int i = tid; i < B * ns; i += THREADS) ss[(i / ns) * s_ld + i % ns] = 0.f;
  // this thread's first ring item (row b0, own column c0) is loaded one
  // layer ahead: the load waits out the barriers of the layer before
  const bool pre_on = tid < B * nr;
  const int b0 = pre_on ? tid / nr : 0, c0 = pre_on ? r_lo + tid % nr : 0;
  __nv_bfloat16 pre{};
  if (pre_on) pre = p.ring[((size_t)(p.off[0] + p.t0 % p.dil[0]) * B + b0) * n_res + c0];
  unsigned long long target = 0;
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const int t_abs = p.t0 + t;
    const unsigned short* cond_t =
        reinterpret_cast<const unsigned short*>(p.cond) + (size_t)t * B * p.n_cond;
    float cond_max = 0.f;  // quantized: max |cond_t| over every row
    if constexpr (Q) {
      for (int i = tid; i < B * p.n_cond; i += THREADS)
        cond_max = fmaxf(cond_max, fabsf(bf2f(__ldg(cond_t + i))));
      cond_max = block_max(cond_max, wred);
    }
    const Src xin{p.xg, 2 * n_res, 2 * n_res, false, cond_t, p.n_cond, p.n_cond};
    const Src hsrc{p.hg, n_dil, n_dil, Q, cond_t, 0, 0};

    for (int l = 0; l < p.L; ++l) {
      const uint8_t* W = (l < p.R ? smem : gshare) + post_bytes + (size_t)l * layer_bytes;
      const float* bl = a_b + l * pl;  // own filter, gate, res, skip columns
      const float* sl = a_s + l * pl;
      // 1. own ring slots: read x_prev, then store bf16(x); publish both
      const int slot = p.off[l] + t_abs % p.dil[l];
      float m = 0.f;
      auto ring_item = [&](int i, __nv_bfloat16 xp, __nv_bfloat16* rp) {
        const int b = i / nr, c = r_lo + i % nr;
        const __nv_bfloat16 xb = __float2bfloat16(xs[b * x_ld + c - r_lo]);
        *rp = xb;
        p.xg[b * 2 * n_res + c] = xp;
        p.xg[b * 2 * n_res + n_res + c] = xb;
        if constexpr (Q)
          m = fmaxf(m, fmaxf(fabsf(__bfloat162float(xp)), fabsf(__bfloat162float(xb))));
      };
      if (pre_on) ring_item(tid, pre, p.ring + ((size_t)slot * B + b0) * n_res + c0);
      for (int i = tid + THREADS; i < B * nr; i += THREADS) {
        __nv_bfloat16* rp = p.ring + ((size_t)slot * B + i / nr) * n_res + r_lo + i % nr;
        ring_item(i, *rp, rp);
      }
      if (pre_on && (l + 1 < p.L || t + 1 < p.T)) {
        const int nslot = l + 1 < p.L ? p.off[l + 1] + t_abs % p.dil[l + 1]
                                      : p.off[0] + (t_abs + 1) % p.dil[0];
        pre = p.ring[((size_t)nslot * B + b0) * n_res + c0];
      }
      if constexpr (Q) {
        m = block_max(m, wred);
        if (tid == 0) p.maxx[r] = m;
      }
      grid_sync(p.count, target, G, bar_cycles);

      // 2. own filter and gate columns over the whole xin
      float sx = 0.f;
      if constexpr (Q)
        sx = fmaxf(fmaxf(slots_max(p.maxx, G, bc), cond_max), 1e-9f) * (1.0f / 127.0f);
      m = 0.f;
      for (int row0 = 0; row0 < B; row0 += PASS) {
        const int nrows = min(PASS, B - row0);
        const long long g0 = clock64();
        share_gemm<WQ>(xin, xin_len, sx, W, 2 * nf, p.c_in, row0, nrows, pu, part);
        __syncthreads();
        gemm_cycles += clock64() - g0;
        for (int i = tid; i < nrows * nf; i += THREADS) {
          const int b = i / nf, jj = i % nf, j = f_lo + jj;
          const Acc zb = I4 ? part_sum<Acc>(part, nrows, 2 * nf, pu, b, 2 * nf) : 0;
          const Acc af = part_sum<Acc>(part, nrows, 2 * nf, pu, b, jj) - zb;
          const Acc ag = part_sum<Acc>(part, nrows, 2 * nf, pu, b, nf + jj) - zb;
          if constexpr (Q) {
            const float yf = __fadd_rn(__fmul_rn((float)af, __fmul_rn(sx, sl[jj])), bl[jj]);
            const float yg = __fadd_rn(__fmul_rn((float)ag, __fmul_rn(sx, sl[nf + jj])),
                                       bl[nf + jj]);
            const float h = tanhf(yf) * (1.f / (1.f + expf(-yg)));
            m = fmaxf(m, fabsf(h));
            reinterpret_cast<float*>(p.hg)[(size_t)(row0 + b) * n_dil + j] = h;
          } else {
            const float yf = af + bl[jj], yg = ag + bl[nf + jj];
            const float sig = 1.f / (1.f + expf(-yg));
            reinterpret_cast<__nv_bfloat16*>(p.hg)[(size_t)(row0 + b) * n_dil + j] =
                __float2bfloat16(tanhf(yf) * sig);
          }
        }
        __syncthreads();
      }
      if constexpr (Q) {
        m = block_max(m, wred);
        if (tid == 0) p.maxh[r] = m;
      }
      grid_sync(p.count, target, G, bar_cycles);

      // 3. own residual and skip columns over the whole h
      float sh = 0.f;
      if constexpr (Q) sh = fmaxf(slots_max(p.maxh, G, bc), 1e-9f) * (1.0f / 127.0f);
      const int nv = nr + ns;
      for (int row0 = 0; row0 < B; row0 += PASS) {
        const int nrows = min(PASS, B - row0);
        const long long g0 = clock64();
        share_gemm<WQ>(hsrc, n_dil, sh, W + (size_t)2 * nf * p.c_in, nv, p.c_out, row0,
                       nrows, pu, part);
        __syncthreads();
        gemm_cycles += clock64() - g0;
        for (int i = tid; i < nrows * nv; i += THREADS) {
          const int b = i / nv, v = i % nv, row = row0 + b;
          float val;
          if constexpr (Q) {
            const Acc a = part_sum<Acc>(part, nrows, nv, pu, b, v) -
                          (I4 ? part_sum<Acc>(part, nrows, nv, pu, b, nv) : 0);
            val = __fadd_rn(__fmul_rn((float)a, __fmul_rn(sh, sl[2 * nf + v])),
                            bl[2 * nf + v]);
          } else {
            val = part_sum<Acc>(part, nrows, nv, pu, b, v) + bl[2 * nf + v];
          }
          if (v < nr) xs[row * x_ld + v] += val;
          else ss[row * s_ld + v - nr] += val;
        }
        __syncthreads();
      }
    }

    // post-net: bf16(relu(skip)) of the own columns
    for (int i = tid; i < B * ns; i += THREADS) {
      const int b = i / ns, c = i % ns;
      p.pg[b * n_skp + s_lo + c] = __float2bfloat16(fmaxf(ss[b * s_ld + c], 0.f));
    }
    grid_sync(p.count, target, G, bar_cycles);
    const Src psrc{p.pg, n_skp, n_skp, false, cond_t, 0, 0};
    for (int row0 = 0; row0 < B; row0 += PASS) {
      const int nrows = min(PASS, B - row0);
      share_gemm<BF16>(psrc, n_skp, 0.f, post1, nq1, p.c_p1, row0, nrows, pu, part);
      __syncthreads();
      for (int i = tid; i < nrows * nq1; i += THREADS) {
        const int b = i / nq1, jj = i % nq1, j = q1_lo + jj;
        p.p1g[(size_t)(row0 + b) * p.n_post + j] = __float2bfloat16(
            fmaxf(part_sum<float>(part, nrows, nq1, pu, b, jj) + a_p1[jj], 0.f));
      }
      __syncthreads();
    }
    grid_sync(p.count, target, G, bar_cycles);
    const Src p1src{p.p1g, p.n_post, p.n_post, false, cond_t, 0, 0};
    for (int row0 = 0; row0 < B; row0 += PASS) {
      const int nrows = min(PASS, B - row0);
      share_gemm<BF16>(p1src, p.n_post, 0.f, post2, nq2, p.c_p2, row0, nrows, pu, part);
      __syncthreads();
      for (int i = tid; i < nrows * nq2; i += THREADS) {
        const int b = i / nq2, jj = i % nq2, j = q2_lo + jj, row = row0 + b;
        const float lg = part_sum<float>(part, nrows, nq2, pu, b, jj) + a_p2[jj];
        if (p.logits != nullptr)
          p.logits[((size_t)t * B + row) * p.n_quant + j] = lg;
        if constexpr (MOL)
          p.mix[(size_t)row * p.n_quant + j] = lg;
        else
          sc[b * pu + jj] = p.greedy ? lg : lg * p.inv_temp + gumbel(p.seed, row, t_abs, j);
      }
      __syncthreads();
      if constexpr (MOL) continue;
      for (int b = tid; b < nrows; b += THREADS) {  // this block's best, first on ties
        float best = 0.f;
        int arg = -1;
        for (int jj = 0; jj < nq2; ++jj) {
          const float s = sc[b * pu + jj];
          if (arg < 0 || s > best) { best = s; arg = q2_lo + jj; }
        }
        p.cand_v[(size_t)(row0 + b) * G + r] = best;
        p.cand_i[(size_t)(row0 + b) * G + r] = arg;
      }
      __syncthreads();
    }
    grid_sync(p.count, target, G, bar_cycles);

    if constexpr (MOL) {
      // every block draws each row's sample from the exchanged mixture (one
      // warp a row, a component a lane; every block computes the same bits)
      // and maps it into its own columns
      const int K = p.n_mix;
      for (int b = warp; b < B; b += WARPS) {
        const float* mrow = p.mix + (size_t)b * p.n_quant;
        float best = 0.f;
        int arg = -1;
        if (lane < K) {
          const float lg = __ldcg(mrow + lane);
          best = p.greedy ? lg : __fadd_rn(__fmul_rn(lg, p.inv_temp),
                                           gumbel(p.seed, b, t_abs, lane));
          arg = lane;
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
        float x = __ldcg(mrow + K + arg);
        if (!p.greedy) {
          const float ls = fmaxf(__ldcg(mrow + 2 * K + arg), p.log_scale_min);
          const float v = fminf(fmaxf(uniform(p.seed, b, t_abs, K), 1e-5f), 0.99999f);
          x = __fadd_rn(x, __fmul_rn(expf(ls), __fsub_rn(logf(v), logf(__fsub_rn(1.f, v)))));
        }
        x = fminf(fmaxf(x, -1.f), 1.f);
        if (r == 0 && lane == 0) {
          p.samples[(size_t)b * p.T + t] = x;
          if (t == p.T - 1) p.last_x[b] = x;
        }
        if (t + 1 < p.T) {
          for (int c = lane; c < nr; c += 32)
            xs[b * x_ld + c] = __fadd_rn(__fmul_rn(x, a_in0[c]), a_in0[nr + c]);
          for (int c = lane; c < ns; c += 32) ss[b * s_ld + c] = 0.f;
        }
      }
      __syncthreads();
      continue;
    }

    // every block reduces all candidates in block order (so first index on
    // ties: blocks own ascending columns) and embeds the id in its columns
    for (int b = warp; b < B; b += WARPS) {
      float best = 0.f;
      int arg = -1;
      for (int q = lane; q < G; q += 32) {
        const float v = __ldcg(p.cand_v + (size_t)b * G + q);
        const int c = __ldcg(p.cand_i + (size_t)b * G + q);
        if (c >= 0 && (arg < 0 || v > best)) { best = v; arg = c; }
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
      if (r == 0 && lane == 0) {
        p.ids[(size_t)b * p.T + t] = arg;
        if (t == p.T - 1) p.last_id[b] = arg;
      }
      if (t + 1 < p.T) {
        for (int c = lane; c < nr; c += 32)
          xs[b * x_ld + c] = __bfloat162float(a_emb[arg * nr + c]);
        for (int c = lane; c < ns; c += 32) ss[b * s_ld + c] = 0.f;
      }
    }
    __syncthreads();
  }
  if (p.clocks != nullptr && r == 0 && tid == 0) {
    p.clocks[0] = clock64() - t_start;
    p.clocks[1] = bar_cycles;
    p.clocks[2] = gemm_cycles;
  }
}

template <int MODE>
int launch(Params& p, int* max_blocks, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&fastgen_kernel<MODE>);
  cudaError_t err = cudaFuncSetAttribute(
      fastgen_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fastgen_kernel<MODE>,
                                                      THREADS, p.smem);
  if (err != cudaSuccess) return (int)err;
  *max_blocks = per_sm * n_sms;
  // every block spins on the others: all must be resident at once
  if (*max_blocks < p.G) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(p.G), dim3(THREADS), args,
                                    (size_t)p.smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// The card's SM count and the shared memory one block may opt in to.
int awt_fastgen_device(int* n_sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return (int)err;
}

// Launches the sampler (mode 0 bf16, 1 int8, 2 int4, 3 bf16 with the
// mixture-of-logistics tail) on `stream` as one
// cooperative grid; returns a CUDA error code (0 = ok).  ptrs and ints in
// the order of ops/fastgen_cuda.generate_fused; *max_blocks gets how many
// blocks of this size the card holds at once (the launch is refused below
// the plan's block count).
int awt_fastgen(int mode, const unsigned long long* ptrs, const int* ints,
                float inv_temp, float log_scale_min, int* max_blocks, void* stream) {
  Params p{};
  int k = 0;
  p.share = (const uint8_t*)ptrs[k++];
  p.w_in_s = (const float*)ptrs[k++];
  p.b_in = (const float*)ptrs[k++];
  p.w_out_s = (const float*)ptrs[k++];
  p.b_out = (const float*)ptrs[k++];
  p.embed = (const __nv_bfloat16*)ptrs[k++];
  p.p1b = (const float*)ptrs[k++];
  p.p2b = (const float*)ptrs[k++];
  p.cond = (const __nv_bfloat16*)ptrs[k++];
  p.prev_id = (const int*)ptrs[k++];
  p.ring = (__nv_bfloat16*)ptrs[k++];
  p.ids = (int*)ptrs[k++];
  p.last_id = (int*)ptrs[k++];
  p.logits = (float*)ptrs[k++];
  p.count = (unsigned long long*)ptrs[k++];
  p.xg = (__nv_bfloat16*)ptrs[k++];
  p.hg = (void*)ptrs[k++];
  p.pg = (__nv_bfloat16*)ptrs[k++];
  p.p1g = (__nv_bfloat16*)ptrs[k++];
  p.cand_v = (float*)ptrs[k++];
  p.cand_i = (int*)ptrs[k++];
  p.xo = (float*)ptrs[k++];
  p.so = (float*)ptrs[k++];
  p.maxx = (float*)ptrs[k++];
  p.maxh = (float*)ptrs[k++];
  p.clocks = (long long*)ptrs[k++];
  p.mix = (float*)ptrs[k++];
  p.in0 = (const float*)ptrs[k++];
  p.x_prev = (const float*)ptrs[k++];
  p.samples = (float*)ptrs[k++];
  p.last_x = (float*)ptrs[k++];
  k = 0;
  p.B = ints[k++]; p.T = ints[k++]; p.L = ints[k++];
  p.n_res = ints[k++]; p.n_dil = ints[k++]; p.n_skp = ints[k++];
  p.n_post = ints[k++]; p.n_quant = ints[k++]; p.n_cond = ints[k++];
  p.t0 = ints[k++]; p.seed = (uint32_t)ints[k++]; p.greedy = ints[k++];
  p.G = ints[k++]; p.R = ints[k++]; p.stride = ints[k++];
  p.part_units = ints[k++]; p.smem = ints[k++];
  p.c_in = ints[k++]; p.c_out = ints[k++]; p.c_p1 = ints[k++]; p.c_p2 = ints[k++];
  p.resident_bytes = ints[k++]; p.aux_bytes = ints[k++]; p.n_mix = ints[k++];
  if (p.L < 1 || p.L > MAX_LAYERS || p.B < 1 || p.T < 1 || p.G < 1 || p.R < 0 ||
      p.R > p.L)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.L; ++l) {
    p.off[l] = ints[k + l];
    p.dil[l] = ints[k + p.L + l];
  }
  p.inv_temp = inv_temp;
  p.log_scale_min = log_scale_min;
  if (mode == MOL_BF16 && (p.n_mix < 1 || p.n_mix > 32 || p.n_quant != 3 * p.n_mix ||
                           !p.in0 || !p.x_prev || !p.samples || !p.last_x || !p.mix))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case BF16: return launch<BF16>(p, max_blocks, s);
    case INT8: return launch<INT8>(p, max_blocks, s);
    case INT4: return launch<INT4>(p, max_blocks, s);
    case MOL_BF16: return launch<MOL_BF16>(p, max_blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* awt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
