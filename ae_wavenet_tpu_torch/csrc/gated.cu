// Fused gated stack for training: forward and backward of one layer, two
// layers, the whole stack (forward) or a group of layers (backward), and
// the weight-gradient products.  Hand-written for Hopper (sm_90a), bound
// with ctypes (see ops/gated_cuda.py).
//
// Replaces the TPU kernels of ae_wavenet_tpu/ops/gated_pallas.py:
//   gated_layer_fused (K1b) and gated_pair_fused (K1)  -> wg_fwd_kernel<1|2>
//     (K1b's non-causal three-tap mode, WaveGlow's:      wg_same_kernel)
//   gated_layer_bwd (K2b) and gated_pair_bwd (K2)      -> wg_bwd_kernel<1|2>
//                                                         + wg_dw_kernel
//     (K2b's recompute mode, no saved y: wg_bwd_kernel<1, true>)
//   gated_stack_fused (K7, every layer in one launch)  -> wg_stack_kernel
//   gated_group_bwd (K8, G >= 3 layers in one launch)  -> wg_group_kernel
//                                                         + wg_dw_kernel
// The contract (rounding points and masks) is written out at the top of
// ops/gated.py, which also holds the plain PyTorch version of each.
// K1b has a second, non-causal mode with three taps (WaveGlow's layers,
// wg_same_kernel): on every row g of [0, P),
//   y = [x[g-dd] | x[g] | x[g+dd]] @ bf16(w_in) + b_in + f32(addend[g])
// with zeros for indices outside [0, P) and the addend [B, P, 2D] bf16
// optional; w_in is [3R][2D] (the third part's rows take the cond rows'
// place, C = R) and no y is saved; the rest as the two-tap contract.
//
// Layout: time-major [B, P, C] bf16 streams (f32 skip / gcond), P = t_in
// rows, layer i valid from row vl_i.
//
// One tile core, "Hopper core" below (wgmma fed by TMA), runs every kernel
// on the weights as they are:
//   win  [2R + C][2D]  rows prev | cur | cond, cols f | g
//   wout [D][R + S]    cols res | skip
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
//     only yields its prev-tap cotangent); the chunks are sized so that all
//     blocks are resident at once (one wave), which keeps the halo at
//     dd2 / chunk of a layer;
//   * inside a chunk the carried rows go through global memory that the
//     block itself wrote (mid, and the f32 cotangent between the two
//     layers of a pair), ordered by a barrier of the block's threads;
//   * the weight gradients are long-K products over every row of every
//     batch row: the backward writes g_y, h and g_out (bf16), and
//     wg_dw_kernel computes xin^T g_y and h^T g_out, and the column sums of
//     g_y and g_out for the bias gradients, with split-K partials in f32,
//     reduced in a fixed order by gated_reduce_kernel (deterministic);
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
//     prev-tap cotangents, written at row g - dd, used in turn.  Rows that
//     another block wrote in the launch are read through L2 (cp.async.cg,
//     ld.global.cg), never from a stale L1 line.  A barrier that is not met
//     within seconds traps.

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime's driver entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TM = 64;  // rows per tile

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 consecutive bf16 -> f32 (16-byte aligned)
__device__ __forceinline__ void ld8(float* o, const bf16* p) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __bfloat162float(h[e]);
}
// ============================================================ Hopper core
//
// K1 (pair forward), K1b (one layer forward), K7 (the whole stack forward),
// K2, K2b in both modes and K8 (pair, one layer and group backward) and
// every weight-gradient product run here: wgmma fed by TMA, in blocks of
// three warpgroups.
//
// What bounds it.  A 64-row tile of one layer is 64 x 1.28 MFLOP against
// 1.28 MB of weights (chorowski), so the weights are re-read from L2 once
// per 64 rows of every layer: about 64 bytes per SM per cycle at the
// tensor cores' peak.  The tile core keeps the activations of the tile in
// shared memory and streams only the weights, in K-slabs of 32 KB, through
// a ring that one producer thread keeps full with TMA while two consumer
// warpgroups run wgmma on the slabs that have arrived.
//
// Layout of a tile.  Activations sit in shared memory as K-major tiles of
// 64 rows x 64 columns (8 KB, the 128-byte swizzle of wgmma's canonical
// layout: the 16-byte group c of row r at group c ^ (r % 8)), one run of
// such atoms per part: xin = [prev | cur | cond], each part zero-padded to
// a multiple of 64 columns, so a width that is any multiple of 8 works and
// nothing is padded in the model.  The weights are read unpadded: TMA fills
// what lies beyond a tensor's edge with zeros.
//
// Forward (per layer and tile):
//   y = xin @ w_in: warpgroup w takes gate channels [128 c, 128 c + 128)
//     for c = w, w + 2, ...: one m64n256 accumulator, f in its first 128
//     columns, g in its last 128 (four TMA boxes of 64 channels: f lo, f hi,
//     g lo, g hi), so the gate is thread-local; w_in is [K][N] with N
//     contiguous, read as wgmma's MN-major (transposed) B;
//   the gate, the saved y and h are computed from the accumulator
//     registers; h goes to shared memory in the K-major layout (over the
//     prev part of xin, which y no longer needs, when it fits);
//   out = h @ w_out: columns [res | skip] in chunks of 128 (m64n128), the
//     residual add and the f32 skip accumulation from the registers.
// Backward (per layer and tile):
//   g_out = bf16([gxn | gskip]) built in shared memory (and written for
//     dW_out); g_h = g_out @ w_out^T: w_out [D][R + S] is K-major as B =
//     w_out^T, so the same tensor is read through wgmma's other operand
//     layout; no transposed copy;
//   g_y from the registers into shared memory (over g_out) and to global
//     memory for dW_in; g_xin = g_y @ w_in^T (w_in again K-major as B),
//     scattered into prev / cur / cond from the registers.
//   The tile's epilogues (global loads and stores in the accumulator's
//     layout, 4 to 8 bytes a thread) take most of its time, the products
//     a tenth.  So the pair backward keeps two tiles in flight where two
//     g_out tiles and two ring stages fit (ops/gated_cuda.bwd_plan): each
//     consumer warpgroup takes a tile of its own and the two take turns at
//     the tensor cores (Turn), one's epilogue under the other's products.
//   The pair forward (K1) moves its epilogue traffic by TMA where the widths
//     are multiples of 128 and leave room (ops/gated_cuda.fwd_plan;
//     wg_fwd_kernel<2, true>): y is staged in 8 KB slots of shared memory
//     (xin's prev atoms beyond h, its cond part, and a few atoms after xin)
//     and stored by bulk copies; the tile's f32 skip rows come into the same
//     slots by TMA under the out products, take the skip terms there and go
//     back by TMA; the new residual rows are written over xin's cur part and
//     stored from there, and layer 2 takes that part as its own cur part.
//     Its epilogues test nothing per element, and the kernel runs its tile
//     from one call site: what paid was the code the tile runs (fetched cold
//     for each inlined copy), more than the traffic.
//   K2b's recompute mode (no saved y) first runs the forward's gate pass on
//     the tile's xin (y = xin @ w_in + b_in, f32 from the accumulator, as
//     the reference keeps it): the gate goes to a per-block scratch of
//     132 x 128 KB at chorowski, which stays in L2, and comes back to the
//     same thread in the g_h epilogue; then the tile as above, g_out built
//     over xin.
// Weight gradients: part[s] = A^T G over split s's rows, A = xin (gathered
// by TMA from x at two row offsets and cond) or h, G = g_y or g_out; both
// come in by TMA and feed wgmma as MN-major operands (128 x 256 output
// tiles); the blocks of the first output-row tile also sum G's columns
// from the same shared-memory slabs (the bias gradients), so no second pass
// reads G.  The split partials are reduced in a fixed order
// (gated_reduce_kernel): two launches give the same bits.
// Whole stack and group (K7, K8): the same tiles, one cooperative launch
// that walks the layers in order (see the top of the file); the producer
// thread streams the weights of every tile of every layer in the order the
// consumers take them and never waits at the grid barrier, which the 256
// consumer threads alone meet: weights are read-only, so it may run a layer
// ahead, as far as the ring's empty barriers let it.

constexpr int WG_THREADS = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int ATOM = 8192;       // 64 rows x 64 bf16, 128-byte swizzle
constexpr int SLAB = 32768;      // one ring stage
constexpr int HALF = 16384;      // one consumer warpgroup's share of a stage
constexpr int MAX_STAGES = 4;
constexpr int SMEM_CAP = 232448;
constexpr int DW_SLAB = 49152;   // A 2 x 8 KB + G 4 x 8 KB
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
// K1's staged epilogue: at most MAX_SLOTS slots of one atom each, for y's
// 64-column atoms or the f32 skip's boxes of SKIP_BOX columns (128 bytes a
// row, the span of the swizzle); the skip rows' mbarrier after the ring's
constexpr int MAX_SLOTS = 16;
constexpr int SKIP_BOX = 32;
constexpr int SKIP_BAR = 8;
constexpr long long SPIN_LIMIT = 1LL << 34;  // clock cycles (several seconds)
// The most layers one whole-stack or group launch takes: the per-layer
// tables (tensor maps and pointers) travel by value in the kernel's
// parameters, so no launch waits on a copy; CUDA >= 12.1 allows 32,764
// bytes of them.
constexpr int MAX_FUSED = 40;
constexpr int MAX_PARAM_BYTES = 32764;

// Where a layer's upstream comes from and where its cotangents go: bf16
// streams both ways (SINGLE), bf16 in and f32 out (UPPER; HALO writes only
// the prev-tap part), f32 in and bf16 out (LOWER), f32 both ways (INNER).
enum Mode { SINGLE = 0, UPPER = 1, LOWER = 2, HALO = 3, INNER = 4 };

struct WgDims {
  int B, P, R, C, D, S;
  int Ra, Ca, Da, Oa, Ya;  // 64-column atoms of n_res, cond, n_dil, n_res + n_skp, 2 n_dil
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------ barriers, TMA, wgmma

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// Waits until the barrier's phase differs from `parity`; traps after
// several seconds (a protocol fault, not a wait).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long t0 = 0;
  for (int spin = 1;; ++spin) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(a), "r"(parity) : "memory");
    if (ok) return;
    if ((spin & 1023) == 0) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > SPIN_LIMIT) __trap();
    }
  }
}
__device__ __forceinline__ void tma2(void* dst, const CUtensorMap* map, uint64_t* bar,
                                     int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)), "l"(map),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void tma3(void* dst, const CUtensorMap* map, uint64_t* bar,
                                     int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)), "l"(map),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
// shared -> global (TMA), in this thread's bulk async-group
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, const void* src, int c0,
                                           int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          map), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// this thread's bulk stores have read their shared memory (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// this thread's completed async-proxy writes to global memory -> ordered
// before its generic accesses that follow (and, through a barrier, other
// threads')
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}
// Named barriers beside the consumers' (1): the pair backward's two tiles in
// flight (wg_bwd_kernel) use one consumer warpgroup's own (2 + w), the
// tensor cores' turns (TURN: warpgroup 0 may go, TURN + 1: warpgroup 1 may
// go) and the prev-tap carry between the two tiles (CARRY: warpgroup 0's
// UPPER stores have landed, for warpgroup 1; CARRY + 1 and CARRY + 2 in
// turn, pair by pair, warpgroup 1's for warpgroup 0).
constexpr int BAR_WG = 2, BAR_TURN = 4, BAR_CARRY = 6;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// generic-proxy writes to shared memory -> visible to wgmma
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across a wait
template <int N>
__device__ __forceinline__ void acc_fence(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}
template <int N>
__device__ __forceinline__ void acc_zero(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// Shared-memory matrix descriptors, 128-byte swizzle.  K-major: rows of 128
// bytes, 8-row groups 1024 bytes apart.  MN-major: 64-element MN atoms
// `lbo` bytes apart, 8-row K groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kdesc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t mndesc(uint32_t a, uint32_t lbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x 128] += A * B, bf16 in, f32 accumulate; A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D[64 x 256] += A * B, bf16 in, f32 accumulate; A and B from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


// The gate's tanh and sigmoid in the epilogues, from the hardware exp2 and
// reciprocal (a few instructions each, against tens for tanhf and an IEEE
// division), short enough that the fully unrolled epilogues stay small.
// fsigm is within a few f32 ulps of 1 / (1 + expf(-v)).  ftanh's
// 1 - 2 / (e^{2v} + 1) has an absolute error of about 1e-7, which near
// v = 0 is a large relative one (1e-3 at |v| = 1e-5, above bf16's half-ulp),
// so below |v| = 0.03 the series v - v^3/3 takes over (relative error under
// 2 v^4 / 15 = 1.1e-7 there; the formula's stays under 4e-6 above it):
// both far below the bf16 rounding that follows.
__device__ __forceinline__ float fsigm(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float ftanh(float v) {
  const float t = 1.f - __fdividef(2.f, __expf(2.f * v) + 1.f);
  return fabsf(v) < 0.03f ? v * (1.f - v * v * (1.f / 3.f)) : t;
}

// byte offset of (row, col) in a run of K-major atoms
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * ATOM + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}
// byte offset of f32 (row, col) in a box of 64 rows x SKIP_BOX columns,
// 128-byte swizzle: the 16-byte group c of row r at group c ^ (r % 8)
__device__ __forceinline__ int skip_swz(int row, int col) {
  return row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}
__device__ __forceinline__ void ld2(const bf16* p, float& a, float& b) {
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(h);
  b = __high2float(h);
}
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  u.x = pack2(v[0], v[1]); u.y = pack2(v[2], v[3]);
  u.z = pack2(v[4], v[5]); u.w = pack2(v[6], v[7]);
  return u;
}

// The ring: stage index and phase, advanced in the same order by the
// producer and by every consumer thread.
struct Pipe {
  int st, n;
  uint32_t ph;
  __device__ void next() {
    if (++st == n) { st = 0; ph ^= 1; }
  }
  __device__ void skip(int k) {  // k slabs that another warpgroup takes
    st += k;
    const int w = st / n;
    st -= w * n;
    ph ^= w & 1;
  }
};

// The 8 consumer warps each arrive once on a slab's empty barrier; a slab
// that one warpgroup alone takes (ARRIVE = 2) is released by its 4 warps
// arriving twice.
template <int ARRIVE = 1>
__device__ __forceinline__ void release(uint64_t* empty, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    if constexpr (ARRIVE == 1)
      mbar_arrive(empty + st);
    else
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_u32(empty + st)), "r"(ARRIVE) : "memory");
  }
}

// One warpgroup's pass over `ns` slabs of the ring: issue(stage, j) runs
// the wgmma of slab j (active warpgroups only), and the slab goes back to
// the producer as soon as those products are done: with the activation
// tile resident beside the ring, few stages fit, and a slab held through
// the next one's products would leave one fewer in flight (slower on the
// H100, forward and backward).  Both warpgroups walk every slab, or
// (ARRIVE = 2) one warpgroup alone takes these slabs.
template <int ARRIVE = 1, typename Issue>
__device__ __forceinline__ void mma_slabs(int ns, bool act, Pipe& pp, uint64_t* full,
                                          uint64_t* empty, unsigned char* ring,
                                          Issue issue) {
  for (int j = 0; j < ns; ++j) {
    mbar_wait(full + pp.st, pp.ph);
    if (act) {
      wg_fence();
      issue(smem_u32(ring + pp.st * SLAB), j);
      wg_commit();
      wg_wait<0>();
    }
    release<ARRIVE>(empty, pp.st);
    pp.next();
  }
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int n) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Fill the xin tile (rows [t0, t0 + TM), parts prev | cur | cond) from row
// pointers with cp.async: every copy in flight at once;
// rows >= nr, rows below valid_lo and null pointers give zeros (a copy of
// 0 source bytes), and so do the columns past each part's width.  Only the
// tap parts are written when with_cond is false, and the cur part is left
// as it is when CUR is false.
template <bool CUR = true, typename PrevF, typename CurF>
__device__ void wg_load_xin(unsigned char* xs, const WgDims& d, int b, int t0, int nr,
                            const bf16* cond, bool with_cond, PrevF prev, CurF cur,
                            int valid_lo) {
  const int gr = d.Ra * 8, nt = CUR ? 2 * gr : gr, ng = with_cond ? nt + d.Ca * 8 : nt;
  const uint32_t xa = smem_u32(xs);
  for (int i = threadIdx.x; i < TM * ng; i += CONSUMERS) {
    const int row = i / ng, q = i - row * ng, g = t0 + row;
    const int part = q < gr ? 0 : q < nt ? 1 : 2;
    const int col = (q - (part == 2 ? nt : part * gr)) * 8;
    const bool in = row < nr && g >= valid_lo;
    const bf16* src = nullptr;
    if (in) {
      if (part == 0) {
        if (col < d.R) { src = prev(g); if (src) src += col; }
      } else if (part == 1) {
        if (col < d.R) src = cur(g) + col;
      } else if (col < d.C) {
        src = cond + ((size_t)b * d.P + g) * d.C + col;
      }
    }
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     xa + part * d.Ra * ATOM + swz(row, col)),
                 "l"(src ? src : cond), "r"(src ? 16 : 0) : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ------------------------------------------------------------- forward

// v, opaque to the compiler: values derived from it inside a loop are not
// hoisted out of that loop (and held in registers across it)
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

struct WgFwdLayer {
  CUtensorMap win[3];  // prev, cur, cond rows of w_in as [rows][f | g][n_dil]
  CUtensorMap wout;    // w_out [n_dil][n_res + n_skp]
  const float* bin; const float* bout;
  bf16* y;  // [B, P, 2D] or null
  // whole stack only: the layer's input stream [B, P, R] and its output
  // stream (null for the last layer, whose output nothing reads)
  const bf16* xin; bf16* xout;
  int dd;
};

struct WgFwdP {
  WgFwdLayer L[2];
  WgDims d;
  const bf16* x; const bf16* cond; float* skip;
  bf16* mid; bf16* xout; bf16* halo;
  int r0, chunk, nst, hoff, roff, boff;  // byte offsets of h, the ring, the barriers
  // the staged epilogue (wg_fwd_kernel<2, true>): each layer's new residual
  // rows (om: mid, xout) and y (ym), the f32 skip (sk, boxes of 64 rows x
  // SKIP_BOX columns), through the slots at byte offsets slot[]: y's atom a
  // in slot a, the skip's box j in slot j
  CUtensorMap om[2], ym[2], sk;
  int slot[MAX_SLOTS];
  // K1b's three-tap mode (wg_same_kernel): x [B, P, R] read by TMA (boxes
  // of 64 rows x 64 columns), and the bf16 addend [B, P, 2D] of y, or null
  CUtensorMap xm;
  const bf16* add;
};

// K1b's three-tap mode's mbarrier: the tile's xin has landed
__device__ __forceinline__ uint64_t* xin_bar(const WgFwdP& p, unsigned char* sm) {
  return reinterpret_cast<uint64_t*>(sm + p.boff + BAR_BYTES);
}

// the staged epilogue's mbarrier: the tile's skip rows have landed
__device__ __forceinline__ uint64_t* skip_bar(const WgFwdP& p, unsigned char* sm) {
  return reinterpret_cast<uint64_t*>(sm + p.boff + BAR_BYTES);
}

// The gate pass's weight slabs (w_in through its three part maps, prev,
// cur and cond rows), in the order wg_gate_pass takes them: the forward's
// first product and K2b's recomputed y.
__device__ void wg_gate_produce(const CUtensorMap* win, const WgDims& d, Pipe& pp,
                                uint64_t* full, uint64_t* empty, unsigned char* ring) {
  const int gch = (d.D + 127) >> 7;
  for (int pass = 0; 2 * pass < gch; ++pass) {
    const int nw = min(2, gch - 2 * pass);
    for (int part = 0; part < 3; ++part) {
      const int ns = ((part < 2 ? d.R : d.C) + 31) >> 5;
      for (int j = 0; j < ns; ++j) {
        mbar_wait(empty + pp.st, pp.ph ^ 1);
        unsigned char* st = ring + pp.st * SLAB;
        uint64_t* fb = full + pp.st;
        mbar_expect_tx(fb, nw * HALF);
        for (int w = 0; w < nw; ++w) {
          const int ch = 2 * pass + w;
          for (int q = 0; q < 4; ++q)  // f lo, f hi, g lo, g hi
            tma3(st + w * HALF + q * 4096, &win[part], fb, ch * 128 + (q & 1) * 64,
                 q >> 1, j * 32);
        }
        pp.next();
      }
    }
  }
}

// y = xin @ w_in on the xin tile at shared address xa (consumer threads):
// warpgroup w takes gate channels [128 ch, 128 ch + 128) for ch = 2 pass +
// w, in one m64n256 accumulator, f in its first 128 columns and g in its
// last 128 (acc[i * 4 + hf * 2 + e] is row r_lo + 8 hf, f channel 128 ch +
// c_lo + 8 i + e; acc[(i + 16) * 4 + ...] the same g channel), so the gate
// is thread-local.  epi(pass, ch, acc) runs on each active block after a
// barrier of the consumers: both warpgroups have read xin by then.
template <typename Epi>
__device__ __forceinline__ void wg_gate_pass(const WgDims& d, uint32_t xa, Pipe& pp,
                                             uint64_t* full, uint64_t* empty,
                                             unsigned char* ring, Epi epi) {
  const int wg = threadIdx.x >> 7;
  const int gch = (d.D + 127) >> 7;
  for (int pass = 0; 2 * pass < gch; ++pass) {
    const int ch = 2 * pass + wg;
    const bool act = ch < gch;
    float acc[128];
    acc_zero<128>(acc);
    for (int part = 0; part < 3; ++part) {
      const uint32_t pa = xa + part * d.Ra * ATOM;
      mma_slabs(((part < 2 ? d.R : d.C) + 31) >> 5, act, pp, full, empty, ring,
                [&](uint32_t st, int j) {
                  const uint32_t a0 = pa + (j >> 1) * ATOM + (j & 1) * 64;
                  const uint32_t b0 = st + wg * HALF;
#pragma unroll
                  for (int kk = 0; kk < 2; ++kk)
                    wgmma_n256<0, 1>(acc, kdesc(a0 + kk * 32), mndesc(b0 + kk * 2048, 4096));
                });
    }
    acc_fence<128>(acc);
    consumers_sync();
    if (act) epi(pass, ch, acc);
  }
}

// The weight slabs of one layer on one tile, in the order the consumers
// take them.
__device__ void wg_fwd_produce(const WgFwdLayer& L, const WgDims& d, Pipe& pp,
                               uint64_t* full, uint64_t* empty, unsigned char* ring) {
  wg_gate_produce(L.win, d, pp, full, empty, ring);
  const int och = (d.R + d.S + 127) >> 7;
  for (int pass = 0; 2 * pass < och; ++pass) {
    const int nw = min(2, och - 2 * pass);
    for (int j = 0; j < d.Da; ++j) {
      mbar_wait(empty + pp.st, pp.ph ^ 1);
      unsigned char* st = ring + pp.st * SLAB;
      uint64_t* fb = full + pp.st;
      mbar_expect_tx(fb, nw * HALF);
      for (int w = 0; w < nw; ++w)
        for (int q = 0; q < 2; ++q)
          tma2(st + w * HALF + q * 8192, &L.wout, fb, (2 * pass + w) * 128 + q * 64,
               j * 64);
      pp.next();
    }
  }
}

// One layer on the tile whose xin is in shared memory (consumer threads).
// The new residual row g goes to out + (g - out_row0) * R (nowhere when out
// is null); halo tiles write neither skip nor y.  P: WgFwdP or WgStackArgs
// (d, skip and the byte offsets of h and the ring).  The epilogue of out
// loads the f32 skip rows of NCB of its 16 column blocks at a time, before
// it adds to any of them.  With NCB < 16 (the whole stack's tile) each
// epilogue also derives this thread's rows and columns anew, so that the
// compiler does not keep their swizzled offsets in registers across the
// products.
// STAGED (K1's staged epilogue, WgFwdP; widths that are multiples of 128,
// fwd_plan): y goes to its slots and thread 0 stores it by TMA (p.ym[layer])
// once the gate epilogue is done, waits until those stores have read the
// slots, and loads the tile's skip rows into the same slots (skip_bar, phase
// *sph), which land under the out products; the out epilogue adds the skip
// terms there and writes x' over xin's cur part, and thread 0 stores both by
// TMA (p.om[layer], p.sk) in its bulk group.  The caller waits on that group
// before anything lands on those regions or reads the rows stored.  Every
// 128-column chunk is all real, all x' or all skip, so these epilogues test
// nothing per element: they write every row, since rows past nr lie past P
// and TMA stores none of them, and y of a halo tile lands in slots that
// nothing stores (halo tiles take the epilogue of out above).
// SAME (K1b's three-tap mode, WgFwdP): y takes p.add's row (f32 of bf16)
// before the gate, where p.add is not null.
template <typename P, int NCB = 16, bool STAGED = false, bool SAME = false>
__device__ void wg_fwd_tile(const P& p, const WgFwdLayer& L, int b, int t0, int nr,
                            bf16* out, int out_row0, bool halo, unsigned char* sm,
                            Pipe& pp, uint64_t* full, uint64_t* empty, int layer = 0,
                            uint32_t* sph = nullptr) {
  const WgDims& d = p.d;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int r_lo0 = (tid >> 5) * 16 + ((tid & 31) >> 2), c_lo0 = (tid & 3) * 2;
  unsigned char* ring = sm + p.roff;
  unsigned char* hs = sm + p.hoff;
  const uint32_t xa = smem_u32(sm), ha = smem_u32(hs);
  const size_t rowb = (size_t)b * d.P;

  // y = xin @ w_in + b_in; gate; h -> shared memory (over xin's prev part,
  // which both warpgroups have read before the epilogue)
  wg_gate_pass(d, xa, pp, full, empty, ring, [&](int, int ch, float* acc) {
    const int r_lo = NCB < 16 ? opaque(r_lo0) : r_lo0;
    const int c_lo = NCB < 16 ? opaque(c_lo0) : c_lo0;
    if constexpr (STAGED) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = ch * 128 + c_lo + i * 8, m = d.D + n;
        const float bf0 = __ldg(L.bin + n), bf1 = __ldg(L.bin + n + 1);
        const float bg0 = __ldg(L.bin + m), bg1 = __ldg(L.bin + m + 1);
        unsigned char* yf = sm + p.slot[n >> 6];
        unsigned char* yg = sm + p.slot[m >> 6];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r_lo + hf * 8;
          const float yf0 = acc[i * 4 + hf * 2] + bf0, yf1 = acc[i * 4 + hf * 2 + 1] + bf1;
          const float yg0 = acc[(i + 16) * 4 + hf * 2] + bg0;
          const float yg1 = acc[(i + 16) * 4 + hf * 2 + 1] + bg1;
          *reinterpret_cast<uint32_t*>(yf + swz(row, n & 63)) = pack2(yf0, yf1);
          *reinterpret_cast<uint32_t*>(yg + swz(row, m & 63)) = pack2(yg0, yg1);
          *reinterpret_cast<uint32_t*>(hs + swz(row, n)) =
              pack2(ftanh(yf0) * fsigm(yg0), ftanh(yf1) * fsigm(yg1));
        }
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = ch * 128 + c_lo + i * 8;
      const bool nin = n < d.D;
      float bf0 = 0.f, bf1 = 0.f, bg0 = 0.f, bg1 = 0.f;
      if (nin) {
        bf0 = __ldg(L.bin + n); bf1 = __ldg(L.bin + n + 1);
        bg0 = __ldg(L.bin + d.D + n); bg1 = __ldg(L.bin + d.D + n + 1);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r_lo + hf * 8, g = t0 + row;
        float yf0 = acc[i * 4 + hf * 2] + bf0, yf1 = acc[i * 4 + hf * 2 + 1] + bf1;
        float yg0 = acc[(i + 16) * 4 + hf * 2] + bg0;
        float yg1 = acc[(i + 16) * 4 + hf * 2 + 1] + bg1;
        if constexpr (SAME) {
          if (p.add && nin && row < nr) {
            const bf16* ap = p.add + (rowb + g) * 2 * d.D + n;
            float a0, a1;
            ld2(ap, a0, a1);
            yf0 += a0; yf1 += a1;
            ld2(ap + d.D, a0, a1);
            yg0 += a0; yg1 += a1;
          }
        }
        if (!halo && L.y && nin && row < nr) {
          bf16* yp = L.y + (rowb + g) * 2 * d.D + n;
          st2(yp, yf0, yf1);
          st2(yp + d.D, yg0, yg1);
        }
        if (n < d.Da * 64) {
          const float h0 = nin ? ftanh(yf0) * fsigm(yg0) : 0.f;
          const float h1 = nin ? ftanh(yf1) * fsigm(yg1) : 0.f;
          *reinterpret_cast<uint32_t*>(hs + swz(row, n)) = pack2(h0, h1);
        }
      }
    }
  });
  fence_async();
  consumers_sync();
  if constexpr (STAGED) {
    if (!halo && threadIdx.x == 0) {
      if (L.y) {  // y from its slots, which the skip rows then take
        for (int a = 0; a < d.Ya; ++a) tma_store3(&p.ym[layer], sm + p.slot[a], a * 64, t0, b);
        bulk_commit();
        bulk_wait<true>();
      }
      const int nskb = d.S / SKIP_BOX;
      uint64_t* sb = skip_bar(p, sm);
      mbar_expect_tx(sb, nskb * ATOM);
      for (int j = 0; j < nskb; ++j) tma3(sm + p.slot[j], &p.sk, sb, j * SKIP_BOX, t0, b);
    }
  }

  // out = h @ w_out + b_out; x' = bf16(x + bf16(res)); skip += skip term
  const int och = (d.R + d.S + 127) >> 7, lo = d.R + d.S;
  const unsigned char* xc = sm + d.Ra * ATOM;  // the cur part: the residual input
  for (int pass = 0; 2 * pass < och; ++pass) {
    const int ch = 2 * pass + wg;
    const bool act = ch < och;
    float acc[64];
    acc_zero<64>(acc);
    mma_slabs(d.Da, act, pp, full, empty, ring, [&](uint32_t st, int j) {
      const uint32_t a0 = ha + j * ATOM, b0 = st + wg * HALF;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n128<0, 1>(acc, kdesc(a0 + kk * 32), mndesc(b0 + kk * 2048, 8192));
    });
    acc_fence<64>(acc);
    if (!act) continue;
    const int r_lo = NCB < 16 ? opaque(r_lo0) : r_lo0;
    const int c_lo = NCB < 16 ? opaque(c_lo0) : c_lo0;
    if constexpr (STAGED) {
      if (!halo) {
        const int n0 = ch * 128;
        if (n0 < d.R) {  // x' over the cur part
          unsigned char* xw = sm + d.Ra * ATOM;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int n = n0 + c_lo + i * 8;
            const float b0 = __ldg(L.bout + n), b1 = __ldg(L.bout + n + 1);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = r_lo + hf * 8;
              const float o0 = acc[i * 4 + hf * 2] + b0, o1 = acc[i * 4 + hf * 2 + 1] + b1;
              float x0, x1;
              ld2(reinterpret_cast<const bf16*>(xw + swz(row, n)), x0, x1);
              *reinterpret_cast<uint32_t*>(xw + swz(row, n)) = pack2(x0 + rbf(o0), x1 + rbf(o1));
            }
          }
        } else {
          mbar_wait(skip_bar(p, sm), *sph);  // the skip rows have landed
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int n = n0 + c_lo + i * 8, c = n - d.R;
            const float b0 = __ldg(L.bout + n), b1 = __ldg(L.bout + n + 1);
            unsigned char* sb = sm + p.slot[(unsigned)c / SKIP_BOX];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = r_lo + hf * 8;
              const float o0 = acc[i * 4 + hf * 2] + b0, o1 = acc[i * 4 + hf * 2 + 1] + b1;
              float2* q = reinterpret_cast<float2*>(sb + skip_swz(row, c));
              const float2 v = *q;
              *q = make_float2(v.x + o0, v.y + o1);
            }
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int i0 = 0; i0 < 16; i0 += NCB) {
      float2 sk[NCB][2];  // the skip rows this thread adds to, loaded first
#pragma unroll
      for (int ii = 0; ii < NCB; ++ii) {
        const int n = ch * 128 + c_lo + (i0 + ii) * 8;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r_lo + hf * 8;
          sk[ii][hf] = !halo && n >= d.R && n < lo && row < nr
                           ? *reinterpret_cast<const float2*>(
                                 p.skip + (rowb + t0 + row) * d.S + (n - d.R))
                           : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int ii = 0; ii < NCB; ++ii) {
        const int i = i0 + ii, n = ch * 128 + c_lo + i * 8;
        if (n >= lo) continue;
        const float b0 = __ldg(L.bout + n), b1 = __ldg(L.bout + n + 1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r_lo + hf * 8, g = t0 + row;
          if (row >= nr) continue;
          const float o0 = acc[i * 4 + hf * 2] + b0, o1 = acc[i * 4 + hf * 2 + 1] + b1;
          if (n < d.R) {
            if (out) {
              float x0, x1;
              ld2(reinterpret_cast<const bf16*>(xc + swz(row, n)), x0, x1);
              st2(out + (size_t)(g - out_row0) * d.R + n, x0 + rbf(o0), x1 + rbf(o1));
            }
          } else if (!halo) {
            *reinterpret_cast<float2*>(p.skip + (rowb + g) * d.S + (n - d.R)) =
                make_float2(sk[ii][hf].x + o0, sk[ii][hf].y + o1);
          }
        }
      }
    }
  }
  if constexpr (STAGED) {
    if (!halo) {  // x' and the skip rows out by TMA
      fence_async();
      consumers_sync();
      if (threadIdx.x == 0) {
        for (int a = 0; a < d.Ra; ++a)
          tma_store3(&p.om[layer], sm + (d.Ra + a) * ATOM, a * 64, t0, b);
        for (int j = 0; j < d.S / SKIP_BOX; ++j)
          tma_store3(&p.sk, sm + p.slot[j], j * SKIP_BOX, t0, b);
        bulk_commit();
      }
      *sph ^= 1;
    }
  }
}

// NL = 1: K1b; NL = 2: K1, with its epilogues staged (STAGED) where the
// widths leave room (ops/gated_cuda.fwd_plan).  Staged, thread 0 orders its
// bulk stores (wg_fwd_tile) with what follows: before a tile's xin lands on
// the slots and the cur part, they have read them; before layer 2 reads
// layer 1's rows of mid (prev tap; its cur part is layer 1's x', left in
// shared memory) and loads the skip rows layer 1 stored, they are complete.
// The staged kernel calls the tile from one place, for the halo tiles and
// both layers: the tile's code is long (its epilogues unrolled), and when
// the kernel inlined it three times, fetching a gate epilogue's code cold
// took as long as its work (a clock64 split of the tile).
template <int NL, bool STAGED = false>
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_fwd_kernel(const __grid_constant__ WgFwdP p) {
  static_assert(!STAGED || NL == 2, "the staged epilogue is the pair's");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const WgDims& d = p.d;
  const int b = blockIdx.y;
  const int c0 = p.r0 + blockIdx.x * p.chunk;
  const int c1 = min(c0 + p.chunk, d.P);
  if (c0 >= c1) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.boff);
  uint64_t* empty = full + MAX_STAGES;
  if constexpr (STAGED) if (threadIdx.x == 0) mbar_init(skip_bar(p, sm), 1);
  init_ring(full, empty, p.nst);  // its fence and barrier cover skip_bar's init
  const int dd1 = p.L[0].dd, dd2 = NL == 2 ? p.L[1].dd : 0;
  const int h0 = NL == 2 ? max(c0 - dd2, p.r0) : c0;  // first halo row
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      Pipe pp{0, p.nst, 0};
      unsigned char* ring = sm + p.roff;
      for (int t0 = h0; t0 < c0; t0 += TM) wg_fwd_produce(p.L[0], d, pp, full, empty, ring);
      for (int t0 = c0; t0 < c1; t0 += TM)
        for (int l = 0; l < NL; ++l) wg_fwd_produce(p.L[l], d, pp, full, empty, ring);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    Pipe pp{0, p.nst, 0};
    const bf16* xb = p.x + (size_t)b * d.P * d.R;
    auto prev1 = [&](int g) -> const bf16* {
      return g - dd1 >= 0 ? xb + (size_t)(g - dd1) * d.R : nullptr;
    };
    auto cur1 = [&](int g) -> const bf16* { return xb + (size_t)g * d.R; };
    bf16* hal = p.halo + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * dd2 * d.R;
    bf16* midb = p.mid + (size_t)b * d.P * d.R;
    auto prev2 = [&](int g) -> const bf16* {
      const int s = g - dd2;
      if (s < p.r0 || s < 0) return nullptr;
      if (s < c0) return hal + (size_t)(s - (c0 - dd2)) * d.R;
      return midb + (size_t)s * d.R;
    };
    auto cur2 = [&](int g) -> const bf16* { return midb + (size_t)g * d.R; };
    if constexpr (STAGED) {
      // one call site of the tile, so that its code is in the kernel once:
      // the halo tiles (layer 1 below the chunk), then layers 1 and 2 of
      // each tile of the chunk
      uint32_t sph = 0;  // skip_bar's phase
      const int nh = (c0 - h0 + TM - 1) / TM, nt = (c1 - c0 + TM - 1) / TM;
      for (int s = 0; s < nh + 2 * nt; ++s) {
        const bool halo = s < nh;
        const int l = halo ? 0 : (s - nh) & 1;
        const int t0 = halo ? h0 + s * TM : c0 + ((s - nh) >> 1) * TM;
        const int nr = min(TM, (halo ? c0 : c1) - t0);
        if (threadIdx.x == 0) {
          if (l) {
            bulk_wait<false>();
            fence_async_global();
          } else {
            bulk_wait<true>();
          }
        }
        consumers_sync();
        if (l) wg_load_xin<false>(sm, d, b, t0, nr, p.cond, true, prev2, cur2, 0);
        else wg_load_xin(sm, d, b, t0, nr, p.cond, true, prev1, cur1, 0);
        fence_async();
        consumers_sync();
        bf16* out = halo ? hal : (l ? p.xout : p.mid) + (size_t)b * d.P * d.R;
        wg_fwd_tile<WgFwdP, 16, true>(p, p.L[l], b, t0, nr, out, halo ? c0 - dd2 : 0, halo, sm,
                                      pp, full, empty, l, &sph);
      }
      if (threadIdx.x == 0) bulk_wait<false>();
      return;
    }
    for (int t0 = h0; t0 < c0; t0 += TM) {  // layer 1 below the chunk, for layer 2's prev tap
      const int nr = min(TM, c0 - t0);
      consumers_sync();
      wg_load_xin(sm, d, b, t0, nr, p.cond, true, prev1, cur1, 0);
      fence_async();
      consumers_sync();
      wg_fwd_tile(p, p.L[0], b, t0, nr, hal, c0 - dd2, true, sm, pp, full, empty);
    }
    bf16* out1 = (NL == 2 ? p.mid : p.xout) + (size_t)b * d.P * d.R;
    for (int t0 = c0; t0 < c1; t0 += TM) {
      const int nr = min(TM, c1 - t0);
      consumers_sync();
      wg_load_xin(sm, d, b, t0, nr, p.cond, true, prev1, cur1, 0);
      fence_async();
      consumers_sync();
      wg_fwd_tile(p, p.L[0], b, t0, nr, out1, 0, false, sm, pp, full, empty);
      if (NL == 2) {
        consumers_sync();
        wg_load_xin(sm, d, b, t0, nr, p.cond, false, prev2, cur2, 0);
        fence_async();
        consumers_sync();
        wg_fwd_tile(p, p.L[1], b, t0, nr, p.xout + (size_t)b * d.P * d.R, 0, false, sm,
                    pp, full, empty);
      }
    }
  }
}

// K1b's three-tap mode (WaveGlow's non-causal layer; C = R, the cond part of
// xin and of w_in the next tap's): one layer on every row of each block's
// chunk, xin = [x[g - dd] | x[g] | x[g + dd]], y plus the addend p.add where
// it is not null, no y saved.  The two-tap kernel's single-layer loop with
// the tile's SAME mode, xin loaded by TMA: thread 0 loads each part's atoms
// as boxes of x at rows t0 - dd, t0 and t0 + dd, and TMA fills the rows
// outside [0, P) (and the columns past R) with zeros: the padding at both
// ends.  Every thread orders its accesses to the previous tile's xin and h
// (generic proxy) before those loads (async proxy) by a proxy fence and the
// consumers' barrier.
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_same_kernel(const __grid_constant__ WgFwdP p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const WgDims& d = p.d;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * p.chunk;
  const int c1 = min(c0 + p.chunk, d.P);
  if (c0 >= c1) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.boff);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xbar = xin_bar(p, sm);
  if (threadIdx.x == 0) mbar_init(xbar, 1);
  init_ring(full, empty, p.nst);  // its fence and barrier cover xbar's init
  const int dd = p.L[0].dd;
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      Pipe pp{0, p.nst, 0};
      for (int t0 = c0; t0 < c1; t0 += TM) wg_fwd_produce(p.L[0], d, pp, full, empty, sm + p.roff);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  Pipe pp{0, p.nst, 0};
  uint32_t xph = 0;  // xbar's phase
  bf16* out = p.xout + (size_t)b * d.P * d.R;
  for (int t0 = c0; t0 < c1; t0 += TM) {
    const int nr = min(TM, c1 - t0);
    fence_async();
    consumers_sync();
    if (threadIdx.x == 0) {
      mbar_expect_tx(xbar, 3 * d.Ra * ATOM);
      for (int part = 0; part < 3; ++part)
        for (int a = 0; a < d.Ra; ++a)
          tma3(sm + (part * d.Ra + a) * ATOM, &p.xm, xbar, a * 64, t0 + (part - 1) * dd, b);
    }
    mbar_wait(xbar, xph);
    xph ^= 1;
    wg_fwd_tile<WgFwdP, 16, false, true>(p, p.L[0], b, t0, nr, out, 0, false, sm, pp, full,
                                        empty);
  }
}

// ------------------------------------------------ whole stack, one launch

// The whole-stack forward's tile loads its skip rows 8 column blocks at a
// time and derives its rows and columns in each epilogue (wg_fwd_tile):
// with the layer's pointers read from a table by index (not constants, as in
// K1), the layer loop's state and K1's register use together would spill.
constexpr int STACK_NCB = 8;

// Barrier n (counted from 0) across a cooperative grid of Hopper blocks,
// met by the consumer threads alone: every consumer's writes before it are
// visible to every block after it.  One thread arrives (red.release) after
// the consumers' own barrier and spins (ld.acquire) on a count that starts
// at zero and only grows; the rest wait at the consumers' barrier.  A
// barrier not met within seconds traps: a schedule fault, not a wait.
__device__ __forceinline__ void wg_grid_sync(unsigned long long* count, int n) {
  consumers_sync();
  if (threadIdx.x == 0) {
    const unsigned long long want = (unsigned long long)(n + 1) * gridDim.x;
    asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(count), "l"(1ULL)
                 : "memory");
    const long long t_start = clock64();
    unsigned long long seen;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(seen) : "l"(count)
                   : "memory");
      if (seen >= want) break;
      if (clock64() - t_start > SPIN_LIMIT) __trap();
    }
  }
  consumers_sync();
}

struct WgStackArgs {
  WgDims d;
  const bf16* cond; float* skip;
  unsigned long long* bar;
  int n_layers, r0, n_tiles, nst, hoff, roff, boff;  // tiles of TM rows from r0, per batch row
  WgFwdLayer L[MAX_FUSED];
};
static_assert(sizeof(WgStackArgs) <= MAX_PARAM_BYTES, "the whole-stack table passes the "
              "kernel parameter limit: lower MAX_FUSED");

// K7: every layer on rows [r0, P), layer-major: tile k of every layer goes
// to block k mod gridDim.x, so a block adds its skip terms to rows that
// only it touches, and reads from other blocks only the previous layer's
// rows at and below its tile (through L2: cp.async.cg), complete since the
// barrier.  With two mid buffers used in turn, the barrier also orders a
// layer's reads of a buffer before the next-but-one layer's writes to it.
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_stack_kernel(const __grid_constant__ WgStackArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const WgDims& d = p.d;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.boff);
  uint64_t* empty = full + MAX_STAGES;
  init_ring(full, empty, p.nst);
  const int total = d.B * p.n_tiles;
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      Pipe pp{0, p.nst, 0};
      unsigned char* ring = sm + p.roff;
      for (int l = 0; l < p.n_layers; ++l)
        for (int tile = blockIdx.x; tile < total; tile += gridDim.x)
          wg_fwd_produce(p.L[l], d, pp, full, empty, ring);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    Pipe pp{0, p.nst, 0};
    for (int l = 0; l < p.n_layers; ++l) {
      const WgFwdLayer& L = p.L[l];
      const int lo = l == 0 ? 0 : p.r0;  // x0 is valid from row 0
      const int dd = L.dd;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int b = tile / p.n_tiles;
        const int t0 = p.r0 + (tile % p.n_tiles) * TM;
        const int nr = min(TM, d.P - t0);
        const bf16* xb = L.xin + (size_t)b * d.P * d.R;
        consumers_sync();
        wg_load_xin(sm, d, b, t0, nr, p.cond, true,
                    [&](int g) -> const bf16* {
                      return g - dd >= lo ? xb + (size_t)(g - dd) * d.R : nullptr;
                    },
                    [&](int g) -> const bf16* { return xb + (size_t)g * d.R; }, 0);
        fence_async();
        consumers_sync();
        wg_fwd_tile<WgStackArgs, STACK_NCB>(
            p, L, b, t0, nr, L.xout ? L.xout + (size_t)b * d.P * d.R : nullptr, 0, false, sm,
            pp, full, empty);
      }
      if (l + 1 < p.n_layers) wg_grid_sync(p.bar, l);
    }
  }
}

// ------------------------------------------------------------ backward

struct WgBwdLayer {
  CUtensorMap woutT;  // w_out [n_dil][n_res + n_skp], read as B = w_out^T
  CUtensorMap winT;   // w_in [2 n_res + n_cond][2 n_dil], read as B = w_in^T
  const bf16* y;
  bf16* gy; bf16* h; bf16* gout;  // [B, P, 2D], [B, P, D], [B, P, R + S]
  int dd, vl;
};

struct WgBwdP {
  WgBwdLayer L[2];
  WgDims d;
  const bf16* cond; const bf16* gxcur; const bf16* gxprev; const bf16* gskip;
  float* gcond; bf16* gxc; bf16* gxp;
  float* gcur; float* gp2;  // the pair's layer 2 -> layer 1 cotangent (f32)
  // K2b's recompute mode (no saved y): w_in as the forward reads it (the
  // three part maps), b_in, the layer's input stream x [B, P, R], and the
  // gate scratch, REC_SLOTS float4 per block and pass of the gate
  CUtensorMap win[3];
  const float* bin; const bf16* x; float4* gate;
  int prev_dd, cur_vl, r0, chunk, nst, yoff, roff, boff;  // g_out at 0, g_y at yoff
  int tiles, tstride;  // the pair's tiles in flight (1 or 2), tstride bytes apart
  // two tiles in flight: each layer's g_out and g_y streams, stored by TMA
  CUtensorMap om[2][2];
};

// Per block and gate pass, one float4 (tanh y_f, sigmoid y_g at two
// channels) for each of a consumer thread's 16 column blocks x 2 rows.
constexpr int REC_SLOTS = 32 * CONSUMERS;

// A layer's place in the launch: its mode, and for LOWER and INNER the
// dilation of the layer above and that layer's f32 prev-tap cotangent
// (read at row g when g + dd_above < P); for UPPER, INNER and HALO where
// this layer's own prev-tap cotangent goes (written at row g - dd).  The
// same-row f32 cotangent between two layers is p.gcur, updated in place.
struct Link {
  int mode, dd_above;
  const float* gin;
  float* gpo;
};

// f32 rows that other blocks of the launch (or this one, a layer earlier)
// wrote: read through L2 (ld.global.cg), never from a stale L1 line
__device__ __forceinline__ float2 ldcg2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ void ldcg8(float* o, const float* p) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// Upstream cotangent of the layer's output row g, channels r and r + 1
// (r..r+7 for wg_gxn8), before the layer's own valid mask.  P: WgBwdP or
// WgGroupArgs.
template <typename P>
__device__ __forceinline__ void wg_gxn2(const P& p, const Link& k, int b, int g, int r,
                                        float& o0, float& o1) {
  const WgDims& d = p.d;
  const size_t off = ((size_t)b * d.P + g) * d.R + r;
  if (k.mode == LOWER || k.mode == INNER) {
    const float2 a = ldcg2(p.gcur + off);
    o0 = a.x; o1 = a.y;
    if (g + k.dd_above < d.P) {
      const float2 q = ldcg2(k.gin + off);
      o0 += q.x; o1 += q.y;
    }
    return;
  }
  o0 = o1 = 0.f;
  if (g >= p.cur_vl) ld2(p.gxcur + off, o0, o1);
  if (p.prev_dd && g + p.prev_dd < d.P) {
    float q0, q1;
    ld2(p.gxprev + off + (size_t)p.prev_dd * d.R, q0, q1);
    o0 += q0; o1 += q1;
  }
}
template <typename P>
__device__ __forceinline__ void wg_gxn8(const P& p, const Link& k, int b, int g, int r,
                                        float* o) {
  const WgDims& d = p.d;
  const size_t off = ((size_t)b * d.P + g) * d.R + r;
  if (k.mode == LOWER || k.mode == INNER) {
    ldcg8(o, p.gcur + off);
    if (g + k.dd_above < d.P) {
      float q[8];
      ldcg8(q, k.gin + off);
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

// The weight slabs of one layer on one tile, in the order the consumers take
// them.  With two tiles in flight (solo) g_xin's slabs come one 128-column
// chunk at a time, two K-slabs a stage, and each turn's slabs go out `reps`
// times in a row, once for each consumer warpgroup's tile.
__device__ void wg_bwd_produce(const WgBwdLayer& L, const WgDims& d, int mode, Pipe& pp,
                               uint64_t* full, uint64_t* empty, unsigned char* ring,
                               int reps = 1, bool solo = false) {
  const int ch1 = (d.D + 127) >> 7;
  const int ch2 = ((mode == HALO ? d.R : 2 * d.R + d.C) + 127) >> 7;
  for (int k = 0; k < 2; ++k) {
    const int nch = k == 0 ? ch1 : ch2, ns = k == 0 ? d.Oa : d.Ya;
    const CUtensorMap* map = k == 0 ? &L.woutT : &L.winT;
    if (solo && k == 1) {  // g_xin one 128-column chunk a turn, two K-slabs a stage
      for (int ch = 0; ch < nch; ++ch)
        for (int r = 0; r < reps; ++r)
          for (int q = 0; 2 * q < ns; ++q) {
            const int nb = min(2, ns - 2 * q);
            mbar_wait(empty + pp.st, pp.ph ^ 1);
            unsigned char* st = ring + pp.st * SLAB;
            uint64_t* fb = full + pp.st;
            mbar_expect_tx(fb, nb * HALF);
            for (int e = 0; e < nb; ++e) tma2(st + e * HALF, map, fb, (2 * q + e) * 64, ch * 128);
            pp.next();
          }
      continue;
    }
    for (int pass = 0; 2 * pass < nch; ++pass) {
      const int nw = min(2, nch - 2 * pass);
      for (int r = 0; r < reps; ++r)
        for (int j = 0; j < ns; ++j) {
          mbar_wait(empty + pp.st, pp.ph ^ 1);
          unsigned char* st = ring + pp.st * SLAB;
          uint64_t* fb = full + pp.st;
          mbar_expect_tx(fb, nw * HALF);
          for (int w = 0; w < nw; ++w)
            tma2(st + w * HALF, map, fb, j * 64, (2 * pass + w) * 128);
          pp.next();
        }
    }
  }
}

// Two tiles in flight (the pair backward, wg_bwd_kernel): each consumer
// warpgroup takes a tile of its own and every column of it, and the two
// take turns at the tensor cores, product phase by product phase, in the
// order the producer streams the slabs (A's phase, B's phase, A's next,
// ...), so that one warpgroup's epilogue (the g_out build, the gate
// derivative with its loads of y, the g_xin scatter) runs while the other's
// products do.  The turns also keep a warpgroup from waiting on a ring
// stage more than one fill ahead of it (an mbarrier's parity cannot tell
// them apart).  Warpgroup 0 (A) takes the higher tile of each pair;
// `partner` says whether B has a tile in this pair, and sync_a whether A
// waits for B's turn before its next phase.  Each warpgroup's ring position
// steps over the other's slabs of the same phase (as many as its own).
struct Turn {
  int wg;
  bool partner, sync_a;
  __device__ __forceinline__ void before(Pipe& pp, int ns) {
    if (wg) {
      bar_sync(BAR_TURN + 1, 256);
      pp.skip(ns);
    } else if (sync_a) {
      bar_sync(BAR_TURN, 256);
    }
  }
  __device__ __forceinline__ void after(Pipe& pp, int ns) {
    if (wg) {
      bar_arrive(BAR_TURN, 256);
    } else {
      if (partner) {
        bar_arrive(BAR_TURN + 1, 256);
        pp.skip(ns);
      }
      sync_a = partner;
    }
  }
};

// This thread's first gate slot of pass `pass` in the block's scratch,
// derived anew at each use (opaque): a pointer kept across the tile's
// products would cost registers the epilogues need.
__device__ __forceinline__ float4* rec_slot(const WgBwdP& p, int pass) {
  const int blk = opaque(blockIdx.y * gridDim.x + blockIdx.x);
  return p.gate + ((size_t)blk * ((p.d.D + 255) >> 8) + pass) * REC_SLOTS + threadIdx.x;
}

// K2b's recompute mode, ahead of the backward tile (consumer threads): the
// tile's xin (x at g - dd and g, cond; zeros below the layer's lattice) in
// shared memory at 0, y = xin @ w_in + b_in in f32 from the gate pass's
// accumulator, and from it tanh(y_f) and sigmoid(y_g), f32, into this
// thread's slots of the block's scratch.  wg_bwd_tile's g_h pass reads the
// slots back (and writes h from them, as from a saved y): its accumulator
// maps each thread to the same (row, channel) pairs, so the round trip is
// the thread's own (no barrier, no fence) and stays in L2.  (h written here
// instead kept one more pointer live across the tile's products: ptxas
// spilled the tile loop's bounds.)
__device__ void wg_gate_recompute(const WgBwdP& p, int b, int t0, int nr, unsigned char* sm,
                                  Pipe& pp, uint64_t* full, uint64_t* empty) {
  const WgDims& d = p.d;
  const WgBwdLayer& L = p.L[0];
  const int tid = threadIdx.x & 127;
  const int r_lo = (tid >> 5) * 16 + ((tid & 31) >> 2), c_lo = (tid & 3) * 2;
  const size_t rowb = (size_t)b * d.P;
  const bf16* xb = p.x + rowb * d.R;
  consumers_sync();  // the previous tile's last products have read shared memory
  wg_load_xin(sm, d, b, t0, nr, p.cond, true,
              [&](int g) -> const bf16* {
                return g - L.dd >= 0 ? xb + (size_t)(g - L.dd) * d.R : nullptr;
              },
              [&](int g) -> const bf16* { return xb + (size_t)g * d.R; }, L.vl);
  fence_async();
  consumers_sync();
  wg_gate_pass(d, smem_u32(sm), pp, full, empty, sm + p.roff,
               [&](int pass, int ch, float* acc) {
    float4* slot = rec_slot(p, pass);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int n = ch * 128 + c_lo + i * 8;
      const bool nin = n < d.D;
      float bf0 = 0.f, bf1 = 0.f, bg0 = 0.f, bg1 = 0.f;
      if (nin) {
        bf0 = __ldg(p.bin + n); bf1 = __ldg(p.bin + n + 1);
        bg0 = __ldg(p.bin + d.D + n); bg1 = __ldg(p.bin + d.D + n + 1);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r_lo + hf * 8, g = t0 + row;
        const bool ok = nin && row < nr && g >= L.vl;
        const float tf0 = ftanh(acc[i * 4 + hf * 2] + bf0);
        const float tf1 = ftanh(acc[i * 4 + hf * 2 + 1] + bf1);
        const float sg0 = fsigm(acc[(i + 16) * 4 + hf * 2] + bg0);
        const float sg1 = fsigm(acc[(i + 16) * 4 + hf * 2 + 1] + bg1);
        __stcg(slot + (i * 2 + hf) * CONSUMERS,
               ok ? make_float4(tf0, tf1, sg0, sg1) : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  });
}

// Two tiles in flight, g_h: pass `pass` of nch 128-column chunks over ns
// slabs, both chunks 2 pass and 2 pass + 1 (both halves of each slab) in
// this warpgroup's turn.  -> the halves it took (the chunks that exist).
__device__ __forceinline__ int wg_bwd_pass(float (*acc)[64], int pass, int nch, int ns,
                                           uint32_t a_base, Pipe& pp, uint64_t* full,
                                           uint64_t* empty, unsigned char* ring, Turn* tn) {
  const int nh = min(2, nch - 2 * pass);
  acc_zero<64>(acc[0]);
  acc_zero<64>(acc[1]);
  tn->before(pp, ns);
  mma_slabs<2>(ns, true, pp, full, empty, ring, [&](uint32_t st, int j) {
    const uint32_t a0 = a_base + j * ATOM;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (h < nh) wgmma_n128<0, 0>(acc[h], kdesc(a0 + kk * 32), kdesc(st + h * HALF + kk * 32));
  });
  tn->after(pp, ns);
  acc_fence<64>(acc[0]);
  acc_fence<64>(acc[1]);
  return nh;
}

// Two tiles in flight, g_xin: the products of one 128-column chunk in this
// warpgroup's turn, over ns K-slabs that come two to a ring stage (the
// slab order and the products of the lockstep pass, one chunk at a time).
__device__ __forceinline__ void wg_bwd_chunk(float* acc, int ns, uint32_t a_base, Pipe& pp,
                                             uint64_t* full, uint64_t* empty,
                                             unsigned char* ring, Turn* tn) {
  const int nq = (ns + 1) >> 1;
  acc_zero<64>(acc);
  tn->before(pp, nq);
  mma_slabs<2>(nq, true, pp, full, empty, ring, [&](uint32_t st, int q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * q + e;
      if (j < ns) {
        const uint32_t a0 = a_base + j * ATOM;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n128<0, 0>(acc, kdesc(a0 + kk * 32), kdesc(st + e * HALF + kk * 32));
      }
    }
  });
  tn->after(pp, nq);
  acc_fence<64>(acc);
}

// One layer's backward on one tile (consumer threads); rows below c0 take
// no prev-tap cotangent.  P: WgBwdP or WgGroupArgs.  REC: K2b's recompute
// mode, after wg_gate_recompute on the same tile (the gate from the
// block's scratch), else the gate from the saved y.  SOLO: one of two tiles
// in flight (WgBwdP, saved y): this warpgroup alone, on its own g_out and
// g_y at p.tstride x wg, its product phases in turn with the other
// warpgroup's (tn), with the products and K order of the two warpgroups'
// lockstep passes: g_h in passes of both 128-column halves (two m64n128
// accumulators, since g_y lands over g_out), g_xin one 128-column chunk a
// turn, its upstream loaded before the turn (the g_out build leaves gxn in
// f32 in gcur, so that load is one stream).  Its g_out and g_y tiles go to
// L.gout and L.gy from shared memory by TMA (om), in one thread's bulk
// group, which that thread waits on before g_y or the next tile's g_out
// lands on them.
template <typename P, bool REC = false, bool SOLO = false>
__device__ void wg_bwd_tile(const P& p, const WgBwdLayer& L, const Link& k, int b, int t0,
                            int nr, int c0, unsigned char* sm, Pipe& pp, uint64_t* full,
                            uint64_t* empty, Turn* tn = nullptr,
                            const CUtensorMap* om = nullptr) {
  static_assert(!(REC && SOLO), "two tiles in flight take saved y");
  constexpr int NT = SOLO ? 128 : CONSUMERS;      // threads on the tile
  const WgDims& d = p.d;
  const int mode = k.mode;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int me = SOLO ? tid : threadIdx.x;
  const int r_lo = (tid >> 5) * 16 + ((tid & 31) >> 2), c_lo = (tid & 3) * 2;
  unsigned char* ring = sm + p.roff;
  if constexpr (SOLO) sm += wg * p.tstride;
  unsigned char* ys = sm + p.yoff;
  const uint32_t ga = smem_u32(sm), ya = smem_u32(ys);
  const size_t rowb = (size_t)b * d.P;
  const int lo = d.R + d.S;
  auto tile_sync = [&] {
    if constexpr (SOLO) bar_sync(BAR_WG + wg, 128);
    else consumers_sync();
  };
  if constexpr (SOLO) if (tid == 0) bulk_wait<true>();  // the last tile's g_y is out
  tile_sync();
  // g_out = bf16([gxn | gskip]) masked to valid rows (h, for dW_out, comes
  // with g_y); each thread loads NB groups of 8 before it stores any (more
  // when one warpgroup builds the tile alone)
  constexpr int NB = SOLO ? 16 : 8;
  const int no = TM * d.Oa * 8;
  for (int i0 = me; i0 < no; i0 += NB * NT) {
    float v[NB][8];
    bool real[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int i = i0 + u * NT, row = i / (d.Oa * 8), col = (i % (d.Oa * 8)) * 8;
      const int g = t0 + row;
      const bool ok = i < no && row < nr && g >= L.vl;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
      real[u] = false;
      if (col < d.R) {
        if (ok) { wg_gxn8(p, k, b, g, col, v[u]); real[u] = true; }
      } else if (ok && col < lo) {
        ld8(v[u], p.gskip + (rowb + g) * d.S + (col - d.R));
        real[u] = true;
      }
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int i = i0 + u * NT, row = i / (d.Oa * 8), col = (i % (d.Oa * 8)) * 8;
      if (i >= no) continue;
      const uint4 w = pack8(v[u]);
      *reinterpret_cast<uint4*>(sm + swz(row, col)) = w;
      if (!SOLO && real[u] && mode != HALO)
        *reinterpret_cast<uint4*>(L.gout + (rowb + t0 + row) * lo + col) = w;
      if constexpr (SOLO) {  // gxn in f32 into gcur, the g_xin epilogue's one load of it
        if (real[u] && col < d.R) {
          float4* q = reinterpret_cast<float4*>(p.gcur + (rowb + t0 + row) * d.R + col);
          q[0] = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
          q[1] = make_float4(v[u][4], v[u][5], v[u][6], v[u][7]);
        }
      }
    }
  }
  fence_async();
  tile_sync();
  if constexpr (SOLO) {
    if (tid == 0) {  // g_out for dW_out, from shared memory
      for (int a = 0; a < d.Oa; ++a) tma_store3(om, sm + a * ATOM, a * 64, t0, b);
      bulk_commit();
    }
  }

  // g_h = g_out @ w_out^T; g_y = bf16([g_h s (1 - t^2) | g_h t s (1 - s)])
  const int ch1 = (d.D + 127) >> 7;
  if constexpr (SOLO) {
    for (int pass = 0; 2 * pass < ch1; ++pass) {
      const int ch0 = 2 * pass;
      float acc[2][64];
      const int nh = wg_bwd_pass(acc, pass, ch1, d.Oa, ga, pp, full, empty, ring, tn);
      if (tid == 0) bulk_wait<true>();  // and by the store of g_out
      tile_sync();  // g_out is read by every warp of the tile before g_y lands on it
      if (ch0 >= ch1) continue;
      // one half's epilogue, CBH column blocks at a time (fewer live registers
      // while the other half's accumulator waits)
      auto half = [&](auto hct, auto cbt) {
        constexpr int hc = decltype(hct)::value, CBH = decltype(cbt)::value;
        const int ch = ch0 + hc;
#pragma unroll
        for (int hh = 0; hh < 16 / CBH; ++hh) {
          uint32_t yv[CBH][2][2];  // this thread's saved y (f, g pairs), loaded first
#pragma unroll
          for (int ii = 0; ii < CBH; ++ii) {
            const int n = ch * 128 + c_lo + (hh * CBH + ii) * 8;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = r_lo + hf * 8, g = t0 + row;
              yv[ii][hf][0] = yv[ii][hf][1] = 0u;
              if (n < d.D && row < nr && g >= L.vl) {
                const bf16* yp = L.y + (rowb + g) * 2 * d.D + n;
                yv[ii][hf][0] = __ldg(reinterpret_cast<const unsigned int*>(yp));
                yv[ii][hf][1] = __ldg(reinterpret_cast<const unsigned int*>(yp + d.D));
              }
            }
          }
#pragma unroll
          for (int ii = 0; ii < CBH; ++ii) {
            const int i = hh * CBH + ii, n = ch * 128 + c_lo + i * 8;
            if (n >= d.D) continue;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = r_lo + hf * 8, g = t0 + row;
              const bool ok = row < nr && g >= L.vl;
              const float gh0 = acc[hc][i * 4 + hf * 2], gh1 = acc[hc][i * 4 + hf * 2 + 1];
              float yf0, yf1, yg0, yg1;
              ld2(reinterpret_cast<const bf16*>(&yv[ii][hf][0]), yf0, yf1);
              ld2(reinterpret_cast<const bf16*>(&yv[ii][hf][1]), yg0, yg1);
              const float tf0 = ftanh(yf0), sg0 = fsigm(yg0), tf1 = ftanh(yf1), sg1 = fsigm(yg1);
              const float gf0 = gh0 * sg0 * (1.f - tf0 * tf0), gf1 = gh1 * sg1 * (1.f - tf1 * tf1);
              const float gg0 = gh0 * tf0 * sg0 * (1.f - sg0), gg1 = gh1 * tf1 * sg1 * (1.f - sg1);
              *reinterpret_cast<uint32_t*>(ys + swz(row, n)) = pack2(gf0, gf1);
              *reinterpret_cast<uint32_t*>(ys + swz(row, d.D + n)) = pack2(gg0, gg1);
              if (ok) st2(L.h + (rowb + g) * d.D + n, tf0 * sg0, tf1 * sg1);
            }
          }
        }
      };
      using std::integral_constant;
      half(integral_constant<int, 0>{}, integral_constant<int, 4>{});
      if (nh > 1) half(integral_constant<int, 1>{}, integral_constant<int, 8>{});
    }
  } else {
    for (int pass = 0; 2 * pass < ch1; ++pass) {
      const int ch = 2 * pass + wg;
      const bool act = ch < ch1;
      float acc[64];
      acc_zero<64>(acc);
      mma_slabs(d.Oa, act, pp, full, empty, ring, [&](uint32_t st, int j) {
        const uint32_t a0 = ga + j * ATOM, b0 = st + wg * HALF;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n128<0, 0>(acc, kdesc(a0 + kk * 32), kdesc(b0 + kk * 32));
      });
      acc_fence<64>(acc);
      consumers_sync();  // g_out is read by both warpgroups before g_y lands on it
      if (!act) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // two halves of 8 column blocks: fewer live registers
        // this thread's gate inputs, loaded first: the saved y (f, g pairs),
        // or the recomputed tanh y_f, sigmoid y_g from the block's scratch
        uint32_t yv[8][2][2];
        float4 gv[REC ? 8 : 1][2];
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int n = ch * 128 + c_lo + (hh * 8 + ii) * 8;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = r_lo + hf * 8, g = t0 + row;
            if constexpr (REC) {
              gv[ii][hf] = __ldcg(rec_slot(p, pass) + ((hh * 8 + ii) * 2 + hf) * CONSUMERS);
            } else {
              yv[ii][hf][0] = yv[ii][hf][1] = 0u;
              if (n < d.D && row < nr && g >= L.vl) {
                const bf16* yp = L.y + (rowb + g) * 2 * d.D + n;
                yv[ii][hf][0] = __ldg(reinterpret_cast<const unsigned int*>(yp));
                yv[ii][hf][1] = __ldg(reinterpret_cast<const unsigned int*>(yp + d.D));
              }
            }
          }
        }
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int i = hh * 8 + ii, n = ch * 128 + c_lo + i * 8;
          if (n >= d.D) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = r_lo + hf * 8, g = t0 + row;
            const bool ok = row < nr && g >= L.vl;
            const float gh0 = acc[i * 4 + hf * 2], gh1 = acc[i * 4 + hf * 2 + 1];
            float tf0, tf1, sg0, sg1;
            if constexpr (REC) {
              tf0 = gv[ii][hf].x; tf1 = gv[ii][hf].y; sg0 = gv[ii][hf].z; sg1 = gv[ii][hf].w;
            } else {
              float yf0, yf1, yg0, yg1;
              ld2(reinterpret_cast<const bf16*>(&yv[ii][hf][0]), yf0, yf1);
              ld2(reinterpret_cast<const bf16*>(&yv[ii][hf][1]), yg0, yg1);
              tf0 = ftanh(yf0); sg0 = fsigm(yg0); tf1 = ftanh(yf1); sg1 = fsigm(yg1);
            }
            const float gf0 = gh0 * sg0 * (1.f - tf0 * tf0), gf1 = gh1 * sg1 * (1.f - tf1 * tf1);
            const float gg0 = gh0 * tf0 * sg0 * (1.f - sg0), gg1 = gh1 * tf1 * sg1 * (1.f - sg1);
            *reinterpret_cast<uint32_t*>(ys + swz(row, n)) = pack2(gf0, gf1);
            *reinterpret_cast<uint32_t*>(ys + swz(row, d.D + n)) = pack2(gg0, gg1);
            if (ok && mode != HALO) {
              bf16* gp = L.gy + (rowb + g) * 2 * d.D + n;
              st2(gp, gf0, gf1);
              st2(gp + d.D, gg0, gg1);
              st2(L.h + (rowb + g) * d.D + n, tf0 * sg0, tf1 * sg1);
            }
          }
        }
      }
    }
  }
  for (int i = me; i < TM * (d.Ya * 8 - d.D / 4); i += NT) {
    const int w = d.Ya * 8 - d.D / 4, row = i / w, col = 2 * d.D + (i % w) * 8;
    *reinterpret_cast<uint4*>(ys + swz(row, col)) = make_uint4(0, 0, 0, 0);
  }
  fence_async();
  tile_sync();
  if constexpr (SOLO) {
    if (tid == 0 && mode != HALO) {  // g_y for dW_in, from shared memory
      for (int a = 0; a < d.Ya; ++a) tma_store3(om + 1, ys + a * ATOM, a * 64, t0, b);
      bulk_commit();
    }
  }

  // g_xin = g_y @ w_in^T (f32) -> the input cotangents: column block i of
  // chunk ch, rows r_lo + 8 hf, loads its upstream first (gxn for cur
  // columns, gcond for cond columns; pre), then scatters with the products
  const int ncols = mode == HALO ? d.R : 2 * d.R + d.C, ch2 = (ncols + 127) >> 7;
  if constexpr (SOLO) {
    auto load_pre = [&](int ch, int i, int hf) {
      const int n = ch * 128 + c_lo + i * 8, row = r_lo + hf * 8, g = t0 + row;
      float2 q = make_float2(0.f, 0.f);
      if (n >= ncols || row >= nr || n < d.R) return q;
      if (n < 2 * d.R) {  // gxn, which the g_out build left in gcur
        if (g >= L.vl) q = ldcg2(p.gcur + (rowb + g) * d.R + (n - d.R));
      } else {
        q = *reinterpret_cast<const float2*>(p.gcond + (rowb + g) * d.C + (n - 2 * d.R));
      }
      return q;
    };
    auto scatter = [&](int ch, int i, int hf, float v0, float v1, float2 q) {
      const int n = ch * 128 + c_lo + i * 8, row = r_lo + hf * 8, g = t0 + row;
      if (n >= ncols || row >= nr) return;
      if (n < d.R) {
        if (mode == SINGLE || mode == LOWER) {
          st2(p.gxp + (rowb + g) * d.R + n, v0, v1);
        } else {
          const int s = g - L.dd;
          if (s >= c0)
            *reinterpret_cast<float2*>(k.gpo + (rowb + s) * d.R + n) = make_float2(v0, v1);
        }
      } else if (n < 2 * d.R) {
        const int r = n - d.R;
        if (mode == UPPER || mode == INNER)
          *reinterpret_cast<float2*>(p.gcur + (rowb + g) * d.R + r) =
              make_float2(q.x + v0, q.y + v1);
        else
          st2(p.gxc + (rowb + g) * d.R + r, q.x + v0, q.y + v1);
      } else {
        *reinterpret_cast<float2*>(p.gcond + (rowb + g) * d.C + (n - 2 * d.R)) =
            make_float2(q.x + v0, q.y + v1);
      }
    };
    // one 128-column chunk a turn, its upstream loaded before the turn: the
    // loads run under the other warpgroup's products and this one's
    for (int ch = 0; ch < ch2; ++ch) {
      float2 pre[16][2];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) pre[i][hf] = load_pre(ch, i, hf);
      float acc[64];
      wg_bwd_chunk(acc, d.Ya, ya, pp, full, empty, ring, tn);
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          scatter(ch, i, hf, acc[i * 4 + hf * 2], acc[i * 4 + hf * 2 + 1], pre[i][hf]);
    }
  } else {
    for (int pass = 0; 2 * pass < ch2; ++pass) {
      const int ch = 2 * pass + wg;
      const bool act = ch < ch2;
      float acc[64];
      acc_zero<64>(acc);
      mma_slabs(d.Ya, act, pp, full, empty, ring, [&](uint32_t st, int j) {
        const uint32_t a0 = ya + j * ATOM, b0 = st + wg * HALF;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n128<0, 0>(acc, kdesc(a0 + kk * 32), kdesc(b0 + kk * 32));
      });
      acc_fence<64>(acc);
      if (!act) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // two halves of 8 column blocks: fewer live registers
        float2 pre[8][2];  // gxn for cur columns, gcond for cond columns, loaded first
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int n = ch * 128 + c_lo + (hh * 8 + ii) * 8;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = r_lo + hf * 8, g = t0 + row;
            pre[ii][hf] = make_float2(0.f, 0.f);
            if (n >= ncols || row >= nr || n < d.R) continue;
            if (n < 2 * d.R) {
              if (g >= L.vl) wg_gxn2(p, k, b, g, n - d.R, pre[ii][hf].x, pre[ii][hf].y);
            } else {
              pre[ii][hf] = *reinterpret_cast<const float2*>(p.gcond + (rowb + g) * d.C +
                                                               (n - 2 * d.R));
            }
          }
        }
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int i = hh * 8 + ii, n = ch * 128 + c_lo + i * 8;
          if (n >= ncols) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = r_lo + hf * 8, g = t0 + row;
            if (row >= nr) continue;
            const float v0 = acc[i * 4 + hf * 2], v1 = acc[i * 4 + hf * 2 + 1];
            const float2 q = pre[ii][hf];
            if (n < d.R) {
              if (mode == SINGLE || mode == LOWER) {
                st2(p.gxp + (rowb + g) * d.R + n, v0, v1);
              } else {
                const int s = g - L.dd;
                if (s >= c0)
                  *reinterpret_cast<float2*>(k.gpo + (rowb + s) * d.R + n) = make_float2(v0, v1);
              }
            } else if (n < 2 * d.R) {
              const int r = n - d.R;
              if (mode == UPPER || mode == INNER)
                *reinterpret_cast<float2*>(p.gcur + (rowb + g) * d.R + r) =
                    make_float2(q.x + v0, q.y + v1);
              else
                st2(p.gxc + (rowb + g) * d.R + r, q.x + v0, q.y + v1);
            } else {
              *reinterpret_cast<float2*>(p.gcond + (rowb + g) * d.C + (n - 2 * d.R)) =
                  make_float2(q.x + v0, q.y + v1);
            }
          }
        }
      }
    }
  }
}

// NL = 1: K2b (REC: its recompute mode, y from xin @ w_in ahead of each
// tile); NL = 2: K2.
template <int NL, bool REC = false>
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_bwd_kernel(const __grid_constant__ WgBwdP p) {
  static_assert(!REC || NL == 1, "the recompute mode takes one layer");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const WgDims& d = p.d;
  const int b = blockIdx.y;
  const int c0 = p.r0 + blockIdx.x * p.chunk;
  const int c1 = min(c0 + p.chunk, d.P);
  if (c0 >= c1) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.boff);
  uint64_t* empty = full + MAX_STAGES;
  init_ring(full, empty, p.nst);
  // halo: layer 2 on the rows above the chunk, for its prev-tap cotangent
  // into the chunk's top rows
  const int hi = NL == 2 ? min(c1 + p.L[1].dd, d.P) : c1;
  const int nt = (c1 - c0 + TM - 1) / TM;
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      Pipe pp{0, p.nst, 0};
      unsigned char* ring = sm + p.roff;
      for (int t0 = c1; t0 < hi; t0 += TM) wg_bwd_produce(p.L[1], d, HALO, pp, full, empty, ring);
      if (NL == 2 && p.tiles == 2) {
        for (int k = nt - 1; k >= 0; k -= 2)
          for (int l = 1; l >= 0; --l)
            wg_bwd_produce(p.L[l], d, l ? UPPER : LOWER, pp, full, empty, ring, k >= 1 ? 2 : 1,
                           true);
      } else for (int k = nt - 1; k >= 0; --k) {
        if (NL == 2) {
          wg_bwd_produce(p.L[1], d, UPPER, pp, full, empty, ring);
          wg_bwd_produce(p.L[0], d, LOWER, pp, full, empty, ring);
        } else {
          if (REC) wg_gate_produce(p.win, d, pp, full, empty, ring);
          wg_bwd_produce(p.L[0], d, SINGLE, pp, full, empty, ring);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    Pipe pp{0, p.nst, 0};
    const Link halo{HALO, 0, nullptr, p.gp2}, upper{UPPER, 0, nullptr, p.gp2};
    const Link lower{LOWER, p.L[1].dd, p.gp2, nullptr}, single{SINGLE, 0, nullptr, nullptr};
    for (int t0 = c1; t0 < hi; t0 += TM)
      wg_bwd_tile(p, p.L[1], halo, b, t0, min(TM, hi - t0), c0, sm, pp, full, empty);
    if constexpr (NL == 2) if (p.tiles == 2) {
      // two tiles in flight: tiles k (warpgroup 0) and k - 1 (warpgroup 1),
      // descending; LOWER of a tile reads the prev-tap cotangents that
      // UPPER of the tile above it (the other warpgroup's) writes, so it
      // waits on a CARRY barrier that the other warpgroup arrives at after
      // those stores, with a fence: nothing else orders the two.  Warpgroup
      // 1 arrives once a pair for warpgroup 0's LOWER of the next pair, and
      // may arrive again before warpgroup 0 has met the last arrival: its
      // arrivals take two barriers in turn.
      const int wg = threadIdx.x >> 7;
      consumers_sync();  // the halo's prev-tap cotangents have landed
      Turn tn{wg, false, false};
      for (int k = nt - 1; k >= 0; k -= 2) {
        const int mine = k - wg;
        if (mine < 0) break;
        tn.partner = k >= 1;
        const int t0 = c0 + mine * TM, nr = min(TM, c1 - t0);
        wg_bwd_tile<WgBwdP, false, true>(p, p.L[1], upper, b, t0, nr, c0, sm, pp, full,
                                         empty, &tn, p.om[1]);
        if (wg == 0 ? k >= 1 : k >= 2) {  // a LOWER of the other warpgroup's reads them
          __threadfence_block();
          bar_arrive(wg ? BAR_CARRY + 1 + ((k >> 1) & 1) : BAR_CARRY, 256);
        }
        if (wg == 1) bar_sync(BAR_CARRY, 256);
        else if (k < nt - 1) bar_sync(BAR_CARRY + 1 + (((k + 2) >> 1) & 1), 256);
        wg_bwd_tile<WgBwdP, false, true>(p, p.L[0], lower, b, t0, nr, c0, sm, pp, full,
                                         empty, &tn, p.om[0]);
      }
      if (wg == 0 && tn.sync_a) bar_sync(BAR_TURN, 256);  // warpgroup 1's last turn
      if ((threadIdx.x & 127) == 0) bulk_wait<false>();
      return;
    }
    for (int k = nt - 1; k >= 0; --k) {  // descending tiles
      const int t0 = c0 + k * TM, nr = min(TM, c1 - t0);
      if (NL == 2) {
        wg_bwd_tile(p, p.L[1], upper, b, t0, nr, c0, sm, pp, full, empty);
        wg_bwd_tile(p, p.L[0], lower, b, t0, nr, c0, sm, pp, full, empty);
      } else {
        if constexpr (REC) wg_gate_recompute(p, b, t0, nr, sm, pp, full, empty);
        wg_bwd_tile<WgBwdP, REC>(p, p.L[0], single, b, t0, nr, c0, sm, pp, full, empty);
      }
    }
  }
}

// ------------------------------------------------------ group, one launch

struct WgGroupArgs {
  WgDims d;
  const bf16* cond; const bf16* gxcur; const bf16* gxprev; const bf16* gskip;
  float* gcond; bf16* gxc; bf16* gxp;
  float* gcur;    // f32 same-row cotangent between layers, updated in place
  float* gp[2];   // f32 prev-tap cotangents at row g - dd, used in turn
  unsigned long long* bar;
  int n_layers, prev_dd, cur_vl, r0, n_tiles, nst, yoff, roff, boff;
  WgBwdLayer L[MAX_FUSED];  // lower layer first
};
static_assert(sizeof(WgGroupArgs) <= MAX_PARAM_BYTES, "the group table passes the kernel "
              "parameter limit: lower MAX_FUSED");

// K8's data gradients: the group's layers from the top down (UPPER, INNER
// ..., LOWER), each on rows [r0, P) masked to its own lattice, layer-major
// with the forward's tile-to-block map: gcur and gcond rows belong to one
// block, and the prev-tap cotangents a tile reads from other blocks (the
// layer above's, for rows up to dd above it, in the gp buffer it wrote) are
// complete since the barrier, which also orders a layer's reads of one gp
// buffer before the next-but-one layer's writes to it.
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_group_kernel(const __grid_constant__ WgGroupArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const WgDims& d = p.d;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.boff);
  uint64_t* empty = full + MAX_STAGES;
  init_ring(full, empty, p.nst);
  const int total = d.B * p.n_tiles, top = p.n_layers - 1;
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      Pipe pp{0, p.nst, 0};
      unsigned char* ring = sm + p.roff;
      for (int j = top; j >= 0; --j) {
        const int mode = j == top ? UPPER : (j == 0 ? LOWER : INNER);
        for (int tile = blockIdx.x; tile < total; tile += gridDim.x)
          wg_bwd_produce(p.L[j], d, mode, pp, full, empty, ring);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    Pipe pp{0, p.nst, 0};
    for (int j = top; j >= 0; --j) {
      const Link k{j == top ? UPPER : (j == 0 ? LOWER : INNER),
                   j < top ? p.L[j + 1].dd : 0, p.gp[(top - j + 1) & 1],
                   p.gp[(top - j) & 1]};
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int b = tile / p.n_tiles;
        const int t0 = p.r0 + (tile % p.n_tiles) * TM;
        // the layer's table row by a fresh index each tile: its pointers are
        // not held in registers across the tile loop (which would spill)
        wg_bwd_tile(p, p.L[opaque(j)], k, b, t0, min(TM, d.P - t0), p.r0, sm, pp, full,
                    empty);
      }
      if (j > 0) wg_grid_sync(p.bar, top - j);
    }
  }
}

// ------------------------------------------------------ weight gradients

struct WgDwP {
  CUtensorMap ma[2];  // A's boxes: kind 0: x (both taps) and cond; kind 1: a
  CUtensorMap mg;     // G's boxes
  float* part; float* part_b;
  int P, lo, kind, dd, R, C, M, N, Ra, atoms;  // atoms: A's 64-column atoms, per part
  int nsb, total, per, ntn, nst;  // slabs per batch row, slabs, slabs per split
};

// Row m of A's per-part padded columns -> its row of dW (-1: padding)
__device__ __forceinline__ int dw_row(const WgDwP& p, int m) {
  if (p.kind == 1) return m < p.M ? m : -1;
  const int a = m >> 6, c = m & 63;
  if (a < p.Ra) return a * 64 + c < p.R ? a * 64 + c : -1;
  if (a < 2 * p.Ra) return (a - p.Ra) * 64 + c < p.R ? p.R + (a - p.Ra) * 64 + c : -1;
  return (a - 2 * p.Ra) * 64 + c < p.C ? 2 * p.R + (a - 2 * p.Ra) * 64 + c : -1;
}

// part[s][m][n] = sum over split s's rows of A[row][m] G[row][n]: output
// tiles of 128 x 256 (warpgroup w: rows 64 w .. 64 w + 63), 64 rows of
// every batch row per slab; blocks of the first row tile also write
// part_b[s][n] = the sum of G[row][n] over the same rows.
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_dw_kernel(const __grid_constant__ WgDwP p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.nst * DW_SLAB);
  uint64_t* empty = full + MAX_STAGES;
  init_ring(full, empty, p.nst);
  const int mt = blockIdx.x / p.ntn, n0 = (blockIdx.x % p.ntn) * 256;
  const int s0 = blockIdx.y * p.per, s1 = min(s0 + p.per, p.total);
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS) {
      Pipe pp{0, p.nst, 0};
      for (int s = s0; s < s1; ++s) {
        const int b = s / p.nsb, g0 = p.lo + (s % p.nsb) * 64;
        mbar_wait(empty + pp.st, pp.ph ^ 1);
        unsigned char* st = sm + pp.st * DW_SLAB;
        uint64_t* fb = full + pp.st;
        const int nw = min(2, p.atoms - 2 * mt);
        mbar_expect_tx(fb, (nw + 4) * 8192);
        for (int w = 0; w < nw; ++w) {
          const int a = 2 * mt + w;
          if (p.kind == 1) tma3(st + w * 8192, &p.ma[0], fb, a * 64, g0, b);
          else if (a < p.Ra) tma3(st + w * 8192, &p.ma[0], fb, a * 64, g0 - p.dd, b);
          else if (a < 2 * p.Ra) tma3(st + w * 8192, &p.ma[0], fb, (a - p.Ra) * 64, g0, b);
          else tma3(st + w * 8192, &p.ma[1], fb, (a - 2 * p.Ra) * 64, g0, b);
        }
        for (int q = 0; q < 4; ++q)
          tma3(st + 16384 + q * 8192, &p.mg, fb, n0 + q * 64, g0, b);
        pp.next();
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const bool act = 2 * mt + wg < p.atoms, sums = mt == 0;
    const int col = threadIdx.x, cq = col >> 6, cc = col & 63;
    Pipe pp{0, p.nst, 0};
    float acc[128];
    acc_zero<128>(acc);
    float cs = 0.f;
    int pend = -1;
    for (int s = s0; s < s1; ++s) {
      mbar_wait(full + pp.st, pp.ph);
      unsigned char* st = sm + pp.st * DW_SLAB;
      if (act) {
        const uint32_t a0 = smem_u32(st) + wg * 8192, b0 = smem_u32(st) + 16384;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n256<1, 1>(acc, mndesc(a0 + kk * 2048, 8192), mndesc(b0 + kk * 2048, 8192));
        wg_commit();
      }
      if (sums) {
        const unsigned char* gcol = st + 16384 + cq * 8192 + (cc & 7) * 2;
#pragma unroll 8
        for (int k = 0; k < 64; ++k)
          cs += __bfloat162float(*reinterpret_cast<const bf16*>(
              gcol + k * 128 + (((cc >> 3) ^ (k & 7)) << 4)));
      }
      if (act) wg_wait<1>();
      if (pend >= 0) release(empty, pend);
      pend = pp.st;
      pp.next();
    }
    if (act) wg_wait<0>();
    if (pend >= 0) release(empty, pend);
    acc_fence<128>(acc);
    float* part = p.part + (size_t)blockIdx.y * p.M * p.N;
    if (act) {
      const int r_lo = (tid >> 5) * 16 + ((tid & 31) >> 2), c_lo = (tid & 3) * 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = dw_row(p, mt * 128 + wg * 64 + r_lo + hf * 8);
        if (m < 0) continue;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int n = n0 + i * 8 + c_lo;
          if (n < p.N)
            *reinterpret_cast<float2*>(part + (size_t)m * p.N + n) =
                make_float2(acc[i * 4 + hf * 2], acc[i * 4 + hf * 2 + 1]);
        }
      }
    }
    if (sums && n0 + col < p.N) p.part_b[(size_t)blockIdx.y * p.N + n0 + col] = cs;
  }
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

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links the runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
  }
  return fn;
}

// A bf16 (or `type`) tensor map, 128-byte swizzle, zeros past the edges.
// dims and box innermost first; strides in bytes of dims 1.. .
bool tensor_map(CUtensorMap* m, const void* base, int rank, const uint64_t* dims,
                const uint64_t* strides, const uint32_t* box,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t gd[3], gs[2];
  cuuint32_t bx[3], es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gd[i] = dims[i];
    bx[i] = box[i];
    if (i) gs[i - 1] = strides[i - 1];
  }
  return fn(m, type, rank, const_cast<void*>(base), gd, gs,
            bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [rows][cols] row-major, boxes of br rows x bc columns
bool map2(CUtensorMap* m, const bf16* base, int cols, int rows, int bc, int br) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {(uint32_t)bc, (uint32_t)br};
  return tensor_map(m, base, 2, dims, strides, box);
}

// [B, P, C] streams, boxes of 64 rows x 64 columns of one batch row
bool map_stream(CUtensorMap* m, const bf16* base, int B, int P, int C) {
  const uint64_t dims[3] = {(uint64_t)C, (uint64_t)P, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)C * 2, (uint64_t)P * C * 2};
  const uint32_t box[3] = {64, 64, 1};
  return tensor_map(m, base, 3, dims, strides, box);
}

// the f32 skip stream [B, P, S], boxes of 64 rows x SKIP_BOX columns
bool map_skip(CUtensorMap* m, const float* base, int B, int P, int S) {
  const uint64_t dims[3] = {(uint64_t)S, (uint64_t)P, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)S * 4, (uint64_t)P * S * 4};
  const uint32_t box[3] = {SKIP_BOX, 64, 1};
  return tensor_map(m, base, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

WgDims wg_dims(const int* iv) {
  WgDims d;
  d.B = iv[0]; d.P = iv[1]; d.R = iv[2]; d.C = iv[3]; d.D = iv[4]; d.S = iv[5];
  d.Ra = (d.R + 63) / 64; d.Ca = (d.C + 63) / 64; d.Da = (d.D + 63) / 64;
  d.Oa = (d.R + d.S + 63) / 64; d.Ya = (2 * d.D + 63) / 64;
  return d;
}

// Shared memory of the Hopper kernels: the tiles, then as many ring stages
// as fit (2 to MAX_STAGES), then `bars` bytes of barriers; bytes > SMEM_CAP
// when even two stages do not fit.
struct Layout { int tiles, aux, nst, bytes; };

Layout ring_layout(int tiles, int aux, int stage, int bars = BAR_BYTES) {
  Layout l{tiles, aux, 0, 0};
  l.nst = (SMEM_CAP - 1024 - bars - tiles) / stage;
  if (l.nst > MAX_STAGES) l.nst = MAX_STAGES;
  l.bytes = l.nst < 2 ? SMEM_CAP + 1 : 1024 + tiles + l.nst * stage + bars;
  return l;
}

// forward: xin at 0, h over xin's prev part when one gate pass writes it
// and it fits there (aux = its offset), else after xin
Layout fwd_layout(const WgDims& d) {
  const int xin = (2 * d.Ra + d.Ca) * ATOM;
  const bool alias = (d.D + 127) / 128 <= 2 && d.Da <= d.Ra;
  return ring_layout(alias ? xin : xin + d.Da * ATOM, alias ? 0 : xin, SLAB);
}

// K1b's three-tap mode: the forward's tiles (C = R), its xin barrier after
// the ring's
Layout same_layout(const WgDims& d) {
  const Layout l = fwd_layout(d);
  return ring_layout(l.tiles, l.aux, SLAB, BAR_BYTES + 8);
}

// K1's staged epilogue (ops/gated_cuda.fwd_plan), for n_res, n_dil and
// n_skp multiples of 128 (every 128-column chunk of the epilogues all real,
// all x' or all skip): the forward's xin with h over its prev part (one gate
// pass), and as many 8 KB slots as y has atoms or the skip has boxes: xin's
// prev atoms beyond h, its cond part (both free once the gate pass has read
// them: layer 2 reloads cond), then the rest after xin (aux = their
// offset); the skip rows' mbarrier after the ring's.  bytes > SMEM_CAP
// where the widths are not such multiples, h does not go over prev, the
// slots pass MAX_SLOTS or two stages do not fit.
Layout fwd_staged_layout(const WgDims& d) {
  const int xin = (2 * d.Ra + d.Ca) * ATOM, have = d.Ra - d.Da + d.Ca;
  const int need = d.Ya > d.S / SKIP_BOX ? d.Ya : d.S / SKIP_BOX;
  if (d.R % 128 || d.D % 128 || d.S % 128 || d.D > 256 || d.Da > d.Ra || need > MAX_SLOTS)
    return Layout{xin, xin, 0, SMEM_CAP + 1};
  const int extra = need > have ? need - have : 0;
  return ring_layout(xin + extra * ATOM, xin, SLAB, BAR_BYTES + SKIP_BAR);
}

// backward: g_out at 0, g_y over it when one g_h pass writes it and it
// fits there (aux = its offset), else after g_out; `tiles` such tiles in
// flight, side by side (the pair backward's second at tiles / 2)
Layout bwd_layout(const WgDims& d, int tiles = 1) {
  const int go = d.Oa * ATOM;
  const bool alias = (d.D + 127) / 128 <= 2 && d.Ya <= d.Oa;
  return ring_layout(tiles * (alias ? go : go + d.Ya * ATOM), alias ? 0 : go, SLAB);
}

// K2b's recompute mode: the backward's tiles, and the forward's xin at 0
// before them (g_out is built over xin once the gate pass has read it)
Layout bwd_rec_layout(const WgDims& d) {
  const Layout l = bwd_layout(d);
  const int xin = (2 * d.Ra + d.Ca) * ATOM;
  return ring_layout(l.tiles > xin ? l.tiles : xin, l.aux, SLAB);
}

template <typename P>
int wg_launch(void (*kernel)(P), const P& p, dim3 grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, WG_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename P>
int wg_blocks_per_sm(void (*kernel)(P), int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, WG_THREADS, smem);
  return err != cudaSuccess ? -(int)err : n;
}

// w_in's rows [row0, row0 + rows) as [rows][f | g][D], boxes of 32 rows x
// 64 channels of f or of g
bool map_win_part(CUtensorMap* m, const bf16* win, int row0, int rows, int D) {
  const uint64_t dims[3] = {(uint64_t)D, 2, (uint64_t)rows};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)D * 4};
  const uint32_t box[3] = {64, 1, 32};
  return tensor_map(m, win + (size_t)row0 * 2 * D, 3, dims, strides, box);
}

// A forward layer's tensor maps: w_in [2R + C][2D] by parts, w_out [D][R + S]
bool map_fwd_layer(WgFwdLayer& L, const WgDims& d, const bf16* win, const bf16* wout) {
  return map_win_part(&L.win[0], win, 0, d.R, d.D) &&
         map_win_part(&L.win[1], win, d.R, d.R, d.D) &&
         map_win_part(&L.win[2], win, 2 * d.R, d.C, d.D) &&
         map2(&L.wout, wout, d.R + d.S, d.D, 64, 64);
}

// A backward layer's: the same tensors read as B = w_out^T and B = w_in^T
bool map_bwd_layer(WgBwdLayer& L, const WgDims& d, const bf16* win, const bf16* wout) {
  return map2(&L.woutT, wout, d.R + d.S, d.D, 64, 128) &&
         map2(&L.winT, win, 2 * d.D, 2 * d.R + d.C, 64, 128);
}

// Launch `kernel` cooperatively on `grid` blocks: its grid barrier needs
// them all resident at once, so a grid the card cannot hold at these widths
// is refused (cudaErrorCooperativeLaunchTooLarge), never run.
template <typename P>
int launch_coop(void (*kernel)(P), const P& p, int grid, int smem, cudaStream_t stream) {
  const int per_sm = wg_blocks_per_sm(kernel, smem);
  if (per_sm < 0) return -per_sm;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1 || grid > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// The kernels' shared memory: > 232,448 when the widths do not fit.  iv
// (here and below): the 6 dims B, P, R, C, D, S, then each entry point's own.
int awt_gated_wg_fwd_smem(const int* iv) { return fwd_layout(wg_dims(iv)).bytes; }
int awt_gated_wg_same_smem(const int* iv) { return same_layout(wg_dims(iv)).bytes; }
int awt_gated_wg_bwd_smem(const int* iv) { return bwd_layout(wg_dims(iv)).bytes; }
int awt_gated_wg_bwd_rec_smem(const int* iv) { return bwd_rec_layout(wg_dims(iv)).bytes; }

// K2b's recompute mode: the gate scratch's float4 per block
long long awt_gated_rec_slots(const int* iv) {
  return (long long)((wg_dims(iv).D + 255) >> 8) * REC_SLOTS;
}

// Blocks of a kernel that one SM holds at these widths (negative: a CUDA
// error).  kind 0: the forward, 1: the backward, 2: the whole stack, 3: the
// group, 4: the single-layer backward's recompute mode, 5: the pair
// backward with two tiles in flight, 6: the pair forward with its epilogue
// staged, 7: K1b's three-tap mode.
int awt_gated_wg_blocks(int kind, const int* iv) {
  const WgDims d = wg_dims(iv);
  switch (kind) {
    case 0: return wg_blocks_per_sm(wg_fwd_kernel<2>, fwd_layout(d).bytes);
    case 1: return wg_blocks_per_sm(wg_bwd_kernel<2>, bwd_layout(d).bytes);
    case 2: return wg_blocks_per_sm(wg_stack_kernel, fwd_layout(d).bytes);
    case 3: return wg_blocks_per_sm(wg_group_kernel, bwd_layout(d).bytes);
    case 4: return wg_blocks_per_sm(wg_bwd_kernel<1, true>, bwd_rec_layout(d).bytes);
    case 5: return wg_blocks_per_sm(wg_bwd_kernel<2>, bwd_layout(d, 2).bytes);
    case 6: return wg_blocks_per_sm(wg_fwd_kernel<2, true>, fwd_staged_layout(d).bytes);
    case 7: return wg_blocks_per_sm(wg_same_kernel, same_layout(d).bytes);
  }
  return -(int)cudaErrorInvalidValue;
}

// ptr: x, cond, skip, mid, xout, halo, then per layer (two slots) win, bin,
// wout, bout, y (weights unpadded: win [2R + C][2D], wout [D][R + S] bf16;
// biases f32), then the three-tap mode's addend (or null)
// iv: 6 dims, r0, chunk, dd1, dd2, n_chunks, staged (1: the pair's epilogue
// staged, where its layout fits: ops/gated_cuda.fwd_plan), taps (3: K1b's
// three-tap mode, C = R and w_in's cond rows the next tap's; r0 = 0, no y)
int awt_gated_fwd(int nl, void* const* ptr, const int* iv, cudaStream_t stream) {
  WgFwdP p;
  const WgDims d = p.d = wg_dims(iv);
  p.x = (const bf16*)ptr[0]; p.cond = (const bf16*)ptr[1];
  p.skip = (float*)ptr[2]; p.mid = (bf16*)ptr[3]; p.xout = (bf16*)ptr[4];
  p.halo = (bf16*)ptr[5];
  for (int l = 0; l < nl; ++l) {
    void* const* q = ptr + 6 + 5 * l;
    WgFwdLayer& L = p.L[l];
    if (!map_fwd_layer(L, d, (const bf16*)q[0], (const bf16*)q[2]))
      return (int)cudaErrorInvalidValue;
    L.bin = (const float*)q[1]; L.bout = (const float*)q[3]; L.y = (bf16*)q[4];
    L.xin = nullptr; L.xout = nullptr;
    L.dd = iv[8 + l];
  }
  p.r0 = iv[6]; p.chunk = iv[7];
  p.add = (const bf16*)ptr[16];
  const bool staged = iv[11] != 0, same = iv[12] == 3;
  if (staged && nl != 2) return (int)cudaErrorInvalidValue;
  if (same && (nl != 1 || d.C != d.R || p.r0 != 0 || p.L[0].y))
    return (int)cudaErrorInvalidValue;
  const Layout lay = staged ? fwd_staged_layout(d) : same ? same_layout(d) : fwd_layout(d);
  if (lay.nst < 2) return (int)cudaErrorInvalidValue;
  p.nst = lay.nst; p.hoff = staged ? 0 : lay.aux; p.roff = lay.tiles;
  p.boff = lay.tiles + lay.nst * SLAB;
  const dim3 grid(iv[10], d.B);
  if (staged) {
    if (!map_stream(&p.om[0], p.mid, d.B, d.P, d.R) ||
        !map_stream(&p.om[1], p.xout, d.B, d.P, d.R) ||
        !map_skip(&p.sk, p.skip, d.B, d.P, d.S))
      return (int)cudaErrorInvalidValue;
    for (int l = 0; l < 2; ++l)
      if (p.L[l].y && !map_stream(&p.ym[l], p.L[l].y, d.B, d.P, 2 * d.D))
        return (int)cudaErrorInvalidValue;
    // the slots: xin's prev atoms beyond h, its cond part, then after xin
    const int spare = d.Ra - d.Da;
    for (int k = 0; k < MAX_SLOTS; ++k)
      p.slot[k] = k < spare ? (d.Da + k) * ATOM
                  : k < spare + d.Ca ? (2 * d.Ra + k - spare) * ATOM
                                     : lay.aux + (k - spare - d.Ca) * ATOM;
    return wg_launch(wg_fwd_kernel<2, true>, p, grid, lay.bytes, stream);
  }
  if (same) {
    if (!map_stream(&p.xm, p.x, d.B, d.P, d.R)) return (int)cudaErrorInvalidValue;
    return wg_launch(wg_same_kernel, p, grid, lay.bytes, stream);
  }
  return nl == 2 ? wg_launch(wg_fwd_kernel<2>, p, grid, lay.bytes, stream)
                 : wg_launch(wg_fwd_kernel<1>, p, grid, lay.bytes, stream);
}

// ptr: cond, gxcur, gxprev, gskip, gcond, gxc, gxp, gcur, gp2, then per
// layer (two slots) y, win, wout, gy, h, gout (weights unpadded), then x,
// bin and the gate scratch (awt_gated_rec_slots float4 per block), read
// only in the recompute mode: one layer whose y is null.
// iv: 6 dims, prev_dd, cur_vl, r0, chunk, dd1, vl1, dd2, vl2, n_chunks,
// tiles in flight (2: a pair whose two tiles fit, ops/gated_cuda.bwd_plan)
int awt_gated_bwd(int nl, void* const* ptr, const int* iv, cudaStream_t stream) {
  WgBwdP p;
  const WgDims d = p.d = wg_dims(iv);
  p.cond = (const bf16*)ptr[0]; p.gxcur = (const bf16*)ptr[1];
  p.gxprev = (const bf16*)ptr[2]; p.gskip = (const bf16*)ptr[3];
  p.gcond = (float*)ptr[4]; p.gxc = (bf16*)ptr[5]; p.gxp = (bf16*)ptr[6];
  p.gcur = (float*)ptr[7]; p.gp2 = (float*)ptr[8];
  for (int l = 0; l < nl; ++l) {
    void* const* q = ptr + 9 + 6 * l;
    WgBwdLayer& L = p.L[l];
    if (!map_bwd_layer(L, d, (const bf16*)q[1], (const bf16*)q[2]))
      return (int)cudaErrorInvalidValue;
    L.y = (const bf16*)q[0]; L.gy = (bf16*)q[3]; L.h = (bf16*)q[4]; L.gout = (bf16*)q[5];
    L.dd = iv[10 + 2 * l]; L.vl = iv[11 + 2 * l];
  }
  const bool rec = p.L[0].y == nullptr;
  if (rec) {
    if (nl != 1 || !ptr[21] || !ptr[22] || !ptr[23] ||
        !map_win_part(&p.win[0], (const bf16*)ptr[10], 0, d.R, d.D) ||
        !map_win_part(&p.win[1], (const bf16*)ptr[10], d.R, d.R, d.D) ||
        !map_win_part(&p.win[2], (const bf16*)ptr[10], 2 * d.R, d.C, d.D))
      return (int)cudaErrorInvalidValue;
    p.x = (const bf16*)ptr[21]; p.bin = (const float*)ptr[22]; p.gate = (float4*)ptr[23];
  }
  p.prev_dd = iv[6]; p.cur_vl = iv[7]; p.r0 = iv[8]; p.chunk = iv[9];
  p.tiles = iv[15];
  if (p.tiles != 1 && (p.tiles != 2 || nl != 2 || rec)) return (int)cudaErrorInvalidValue;
  for (int l = 0; p.tiles == 2 && l < nl; ++l)
    if (!map_stream(&p.om[l][0], p.L[l].gout, d.B, d.P, d.R + d.S) ||
        !map_stream(&p.om[l][1], p.L[l].gy, d.B, d.P, 2 * d.D))
      return (int)cudaErrorInvalidValue;
  const Layout lay = rec ? bwd_rec_layout(d) : bwd_layout(d, p.tiles);
  if (lay.nst < 2) return (int)cudaErrorInvalidValue;
  p.nst = lay.nst; p.yoff = lay.aux; p.roff = lay.tiles; p.tstride = lay.tiles / p.tiles;
  p.boff = lay.tiles + lay.nst * SLAB;
  const dim3 grid(iv[14], d.B);
  if (rec) return wg_launch(wg_bwd_kernel<1, true>, p, grid, lay.bytes, stream);
  return nl == 2 ? wg_launch(wg_bwd_kernel<2>, p, grid, lay.bytes, stream)
                 : wg_launch(wg_bwd_kernel<1>, p, grid, lay.bytes, stream);
}

int awt_gated_max_fused_layers() { return MAX_FUSED; }

// The whole-stack forward.  ptr: cond, skip, bar (one zeroed 64-bit count),
// then per layer win, bin, wout, bout, y, xin, xout (weights unpadded)
// iv: 6 dims, n_layers, r0, grid, then dd per layer
int awt_gated_stack(void* const* ptr, const int* iv, cudaStream_t stream) {
  WgStackArgs p;
  const WgDims d = p.d = wg_dims(iv);
  p.cond = (const bf16*)ptr[0]; p.skip = (float*)ptr[1];
  p.bar = (unsigned long long*)ptr[2];
  p.n_layers = iv[6]; p.r0 = iv[7];
  p.n_tiles = (d.P - p.r0 + TM - 1) / TM;
  if (p.n_layers < 1 || p.n_layers > MAX_FUSED || p.n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.n_layers; ++l) {
    void* const* q = ptr + 3 + 7 * l;
    WgFwdLayer& L = p.L[l];
    if (!map_fwd_layer(L, d, (const bf16*)q[0], (const bf16*)q[2]))
      return (int)cudaErrorInvalidValue;
    L.bin = (const float*)q[1]; L.bout = (const float*)q[3]; L.y = (bf16*)q[4];
    L.xin = (const bf16*)q[5]; L.xout = (bf16*)q[6];
    L.dd = iv[9 + l];
  }
  const Layout lay = fwd_layout(d);
  if (lay.nst < 2) return (int)cudaErrorInvalidValue;
  p.nst = lay.nst; p.hoff = lay.aux; p.roff = lay.tiles;
  p.boff = lay.tiles + lay.nst * SLAB;
  return launch_coop(wg_stack_kernel, p, iv[8], lay.bytes, stream);
}

// The grouped backward (saved y).  ptr: cond, gxcur, gxprev, gskip, gcond,
// gxc, gxp, gcur, gp0, gp1, bar (one zeroed 64-bit count), then per layer
// (lower layer first) y, win, wout, gy, h, gout (weights unpadded)
// iv: 6 dims, n_layers, prev_dd, cur_vl, r0, grid, then dd, vl per layer
int awt_gated_group(void* const* ptr, const int* iv, cudaStream_t stream) {
  WgGroupArgs p;
  const WgDims d = p.d = wg_dims(iv);
  p.cond = (const bf16*)ptr[0]; p.gxcur = (const bf16*)ptr[1];
  p.gxprev = (const bf16*)ptr[2]; p.gskip = (const bf16*)ptr[3];
  p.gcond = (float*)ptr[4]; p.gxc = (bf16*)ptr[5]; p.gxp = (bf16*)ptr[6];
  p.gcur = (float*)ptr[7]; p.gp[0] = (float*)ptr[8]; p.gp[1] = (float*)ptr[9];
  p.bar = (unsigned long long*)ptr[10];
  p.n_layers = iv[6]; p.prev_dd = iv[7]; p.cur_vl = iv[8]; p.r0 = iv[9];
  p.n_tiles = (d.P - p.r0 + TM - 1) / TM;
  if (p.n_layers < 2 || p.n_layers > MAX_FUSED || p.n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.n_layers; ++l) {
    void* const* q = ptr + 11 + 6 * l;
    WgBwdLayer& L = p.L[l];
    if (!map_bwd_layer(L, d, (const bf16*)q[1], (const bf16*)q[2]))
      return (int)cudaErrorInvalidValue;
    L.y = (const bf16*)q[0]; L.gy = (bf16*)q[3]; L.h = (bf16*)q[4]; L.gout = (bf16*)q[5];
    L.dd = iv[11 + 2 * l]; L.vl = iv[12 + 2 * l];
  }
  const Layout lay = bwd_layout(d);
  if (lay.nst < 2) return (int)cudaErrorInvalidValue;
  p.nst = lay.nst; p.yoff = lay.aux; p.roff = lay.tiles;
  p.boff = lay.tiles + lay.nst * SLAB;
  return launch_coop(wg_group_kernel, p, iv[10], lay.bytes, stream);
}

// dW = A^T G and db = the column sums of G over rows [lo, P) of every batch
// row, A = xin (kind 0: gathered from x at row g - dd and g, and cond) or a
// (kind 1, [B, P, ka]).  ptr: x, cond, a, g, part, out, part_b, out_b
// iv: B, P, lo, kind, dd, R, C, ka, N, M, splits
int awt_gated_dw(void* const* ptr, const int* iv, cudaStream_t stream) {
  WgDwP p;
  const int B = iv[0];
  p.P = iv[1]; p.lo = iv[2]; p.kind = iv[3]; p.dd = iv[4]; p.R = iv[5]; p.C = iv[6];
  const int ka = iv[7];
  p.N = iv[8]; p.M = iv[9];
  const int splits = iv[10];
  p.Ra = (p.R + 63) / 64;
  bool ok = map_stream(&p.mg, (const bf16*)ptr[3], B, p.P, p.N);
  if (p.kind == 0) {
    ok = ok && map_stream(&p.ma[0], (const bf16*)ptr[0], B, p.P, p.R) &&
         map_stream(&p.ma[1], (const bf16*)ptr[1], B, p.P, p.C);
    p.atoms = 2 * p.Ra + (p.C + 63) / 64;
  } else {
    ok = ok && map_stream(&p.ma[0], (const bf16*)ptr[2], B, p.P, ka);
    p.atoms = (ka + 63) / 64;
  }
  if (!ok || splits < 1) return (int)cudaErrorInvalidValue;
  p.part = (float*)ptr[4]; p.part_b = (float*)ptr[6];
  p.nsb = (p.P - p.lo + 63) / 64;
  p.total = B * p.nsb;
  p.per = (p.total + splits - 1) / splits;
  p.ntn = (p.N + 255) / 256;
  const Layout lay = ring_layout(0, 0, DW_SLAB);
  p.nst = lay.nst;
  const dim3 grid(((p.atoms + 1) / 2) * p.ntn, splits);
  int rc = wg_launch(wg_dw_kernel, p, grid, lay.bytes, stream);
  if (rc) return rc;
  if ((rc = reduce(p.part, (float*)ptr[5], splits, (long long)p.M * p.N, stream)))
    return rc;
  return reduce(p.part_b, (float*)ptr[7], splits, p.N, stream);
}

}  // extern "C"
