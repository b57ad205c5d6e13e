// Row softmax through the paper's LUT pipeline (§VI, eqs 10-12), for sm_90a.
//
// Replaces the TPU kernel `lut_softmax_2d` of the reference
// (src/repro/kernels/lut_softmax.py: bodies `_softmax_kernel_fixed`,
// `_softmax_kernel_float`, `_reciprocal_q24_body`).
//
// What it computes, per row of a [M, N] float32 array:
//   z_i  = clip(max_j x_j - x_i, 0, 10)
//   fixed: z_q = rint(z_i * 2^24); num_i = EXP_Q24[clip(z_q >> 19, 0, 319)]
//          s   = sum_i ((num_i + 2^(pre-1)) >> pre)          (int32)
//          inv = reciprocal_q24(s) >> pre   (ilog2 ladder, mantissa to [1,2),
//                                            INV_Q24 lookup, saturating shift)
//          y_i = fixed_mul(num_i, inv) * 2^-24   (12/12-bit limbs, int32)
//   float: num_i = EXP_F32[clip(int(z_i * 32), 0, 319)]; y_i = num_i / sum num
// The pre-shift is the ROUNDING form of `core/approx.py::_pre_shift`, not the
// truncating `num >> pre` of the TPU kernel body: the two agree at pre == 0
// (N <= 64) and the rounding form is the oracle's.  The int32 sum is
// order-free, and the float variant sums in float64, where the table entries
// (multiples of 2^-38 not above 1) add exactly for rows of up to 2^14: so
// every path below equals the plain version bit for bit.
//
// What bounds it here: bytes.  A row is 27 to 99 floats on the KWT path and
// the arithmetic is a few dozen integer ops per element, so the kernel is
// bound by reading x and writing y once each (and, at small M, by the call).
// A first kernel reached 40 % of that bound at [405504, 99]: a warp read its
// row from device memory three times in 4-byte loads at any 4-byte offset,
// looked each exp up twice, and walked ~12 rows one after the other, none
// of the next row's loads in flight while a row was reduced.  The arithmetic
// is not small either: ~25 instructions an element and ~40 a row keep the
// SMs issuing for about two thirds of the byte bound, so it has to overlap
// the copies, not follow them.
//
// The slab path (this design):
//   - A slab is R whole rows, R * N floats, one contiguous byte range; R is a
//     multiple of 4 chosen by the launcher (`slab_rows_for`): as many rows
//     as fill kSlabFloats (2 KB), at least 4.  A slab of a 16-byte aligned
//     array therefore starts on a 16-byte boundary, as the bulk copy
//     requires.  Rows of up to kMaxSlabN = 128 floats take this path when
//     x and out both start on a 16-byte boundary.
//   - Every warp runs its own ring of kStages = 3 slabs in shared memory:
//     lane 0 copies slab i + 1 in with the 1-D bulk copy (`cp.async.bulk ...
//     mbarrier::complete_tx::bytes`, no tensor map) while the warp computes
//     slab i in place, and copies slab i back out with the bulk store
//     (`cp.async.bulk.global.shared::cta`); a stage takes its next load once
//     its store has read it (`wait_group.read`).  The warp waits on its own
//     mbarrier and meets the block's other warps only once, to stage the
//     tables.  (A block-wide ring, one slab of 12-16 KB a block and every
//     warp waiting for the slowest at two barriers a slab, left the SMs
//     idle between slabs and measured slower on the H100.)
//   - Each block takes a compact run of 4 warps x per_warp slabs (per_warp =
//     the card's share, 1 to kMaxPerWarp), dealt to its warps in turn, and
//     blocks are launched in order, so the blocks in flight stream one
//     compact stretch of x.  (A persistent grid striding over the whole
//     array measured slower, as it did for the GELU.)
//   - A row is read from shared memory once, into VPL registers per lane (a
//     template parameter from N: 1 for N <= 32, 2 for N <= 64, 4 for N <=
//     128); its LUT exp is computed once and kept in registers; then the
//     row max, the int32 row sum, one reciprocal and the stores.  Where a
//     row spans the warp (N > 16) the max and the sum are one `redux.sync`
//     each (the max over int keys in float order), not five shuffles: the
//     shuffles and the shared-memory loads and stores share one pipe.  A
//     warp holds 4 rows at once, whose reductions interleave; for N <= 16
//     it holds 32 / G rows side by side as well, G the power of two >= N,
//     and reduces with shuffles inside each group of G lanes.
//   - The last slab may be short (M not a multiple of R): its copy is the
//     whole 16-byte units, and the < 4 floats past them are loaded and stored
//     by single lanes.
// The global path, one warp per row straight from device memory (that first
// kernel), is taken for a base (of x or out) that is not 16-byte aligned,
// or a row longer than kMaxSlabN floats.  Both paths
// compute the same bits.  The tables (2 x 320 words) are staged in shared
// memory once per block on both paths.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_geometry.cuh"

namespace {

// The SM count of the current device, read once per device and kept.
int sm_count() {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cacheable = dev >= 0 && dev < kMaxDevices;
  if (cacheable && cached[dev] > 0) return cached[dev];
  int sms = 0;
  // on failure the error stays pending and the launcher's
  // cudaGetLastError() reports it
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    return 1;
  if (cacheable) cached[dev] = sms;
  return sms;
}

constexpr int kEntries = 320;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 4096;      // global path
constexpr int kSlabWarps = 4;         // the slab path's blocks: 4 warps
constexpr int kSlabThreads = 32 * kSlabWarps;
constexpr int kSlabFloats = 512;      // one slab of a warp, 2 KB
constexpr int kMaxSlabN = kSlabFloats / 4;
constexpr int kStages = 3;  // a slab computed, the next loading, the last storing
constexpr int kMaxPerWarp = 4;  // slabs a warp walks, at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float row_max(const float* xr, int n, int lane) {
  float mx = -INFINITY;
  for (int i = lane; i < n; i += 32) mx = fmaxf(mx, xr[i]);
  return warp_max(mx);
}

// The clip of z = max - x to [0, 10] is left to the index clamps: z is
// never negative (max >= x; an inf - inf NaN converts to 0, as the clip
// made it), and z > 10 indexes past 319 (the conversions saturate) and is
// clamped there, as the clip at 10 made it.

// floor(log2(x)), 0 for x <= 1: the value of the compare ladder of
// core/fixedpoint.py::ilog2, from a count of leading zeros.
__device__ __forceinline__ int ilog2(int x) { return x > 1 ? 31 - __clz(x) : 0; }

// core/lut.py::reciprocal_q24 with range reduction.
__device__ __forceinline__ int reciprocal_q24(int s, const int* inv_tab) {
  const int t = ilog2(s) - 24;
  const int tp = t > 0 ? t : 0;
  const int tn = t < 0 ? -t : 0;
  const int m = (s >> tp) << tn;  // mantissa in [1, 2), Q8.24
  int idx = (m >> 19) - 1;
  idx = idx < 0 ? 0 : (idx > kEntries - 1 ? kEntries - 1 : idx);
  const int inv_m = inv_tab[idx];
  if (t >= 0) return inv_m >> tp;
  // saturating left shift: compare against INT32_MAX >> tn BEFORE shifting
  const int limit = 0x7fffffff >> tn;
  return inv_m > limit ? 0x7fffffff : (inv_m << tn);
}

// core/fixedpoint.py::fixed_mul(nonneg=True): (a * b) >> 24 in 12/12 limbs,
// ah*bh + ((ah*bl + al*bh) >> 12) + ((al*bl) >> 24).  The last term is 0
// for every a and b (al, bl < 2^12), so it is left out.
__device__ __forceinline__ int fixed_mul_nonneg(int a, int b) {
  const int ah = a >> 12, al = a & 0xFFF;
  const int bh = b >> 12, bl = b & 0xFFF;
  return ah * bh + ((ah * bl + al * bh) >> 12);
}

__device__ __forceinline__ int exp_q24(const int* exp_tab, float mx, float x) {
  const float z = __fsub_rn(mx, x);
  const int z_q = __float2int_rn(__fmul_rn(z, 16777216.0f));  // ALU_TO_FIXED
  return exp_tab[min(z_q >> 19, kEntries - 1)];                // ALU_EXP
}

__device__ __forceinline__ float q24_to_float(int y) {
  return __fmul_rn(__int2float_rn(y), 5.9604644775390625e-08f);  // 2^-24
}

// The float variant's table, held as raw 32-bit words.
__device__ __forceinline__ float exp_f32(const int* exp_tab, float mx, float x) {
  const float z = __fsub_rn(mx, x);
  const int idx = __float2int_rz(__fmul_rn(z, 32.0f));  // truncation, not rounding
  return __int_as_float(exp_tab[min(idx, kEntries - 1)]);
}

// ---------------------------------------------------------------------------
// the global path: one warp per row, straight from device memory
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
softmax_fixed_kernel(const float* __restrict__ x, const int* __restrict__ exp_g,
                     const int* __restrict__ inv_g, float* __restrict__ out,
                     int m, int n, int pre) {
  __shared__ int exp_tab[kEntries];
  __shared__ int inv_tab[kEntries];
  for (int i = threadIdx.x; i < kEntries; i += kThreads) {
    exp_tab[i] = exp_g[i];
    inv_tab[i] = inv_g[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = pre > 0 ? (1 << (pre - 1)) : 0;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < m;
       row += (long long)gridDim.x * kWarps) {
    const float* xr = x + row * n;
    float* yr = out + row * n;
    const float mx = row_max(xr, n, lane);
    int s = 0;
    for (int i = lane; i < n; i += 32)
      s += (exp_q24(exp_tab, mx, xr[i]) + half) >> pre;
    s = warp_sum(s);
    const int inv = reciprocal_q24(s, inv_tab) >> pre;           // ALU_INVERT
    for (int i = lane; i < n; i += 32)
      yr[i] = q24_to_float(fixed_mul_nonneg(exp_q24(exp_tab, mx, xr[i]), inv));
  }
}

__global__ void __launch_bounds__(kThreads)
softmax_float_kernel(const float* __restrict__ x, const int* __restrict__ exp_g,
                     float* __restrict__ out, int m, int n) {
  __shared__ int exp_tab[kEntries];
  for (int i = threadIdx.x; i < kEntries; i += kThreads) exp_tab[i] = exp_g[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < m;
       row += (long long)gridDim.x * kWarps) {
    const float* xr = x + row * n;
    float* yr = out + row * n;
    const float mx = row_max(xr, n, lane);
    double s = 0.0;
    for (int i = lane; i < n; i += 32) s += (double)exp_f32(exp_tab, mx, xr[i]);
    const float total = (float)warp_sum(s);
    for (int i = lane; i < n; i += 32)
      yr[i] = __fdiv_rn(exp_f32(exp_tab, mx, xr[i]), total);
  }
}

// ---------------------------------------------------------------------------
// the slab path
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` of asynchronous copy.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// All but the newest bulk store have read their shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// This thread's shared-memory writes are ordered before later bulk copies.
__device__ __forceinline__ void fence_to_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A float's bits as an int whose signed order is the float order (NaN
// aside), so that a whole warp's max is one redux.sync; and back.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// The rows of one warp's slab in shared memory, in place.  Lane `col` of a
// group of G lanes holds elements col, col + G, ... of a row (VPL of them,
// VPL > 1 only with G = 32); the warp holds 32 / G rows side by side and
// kDeep rows one behind the other, whose reduction chains interleave.
template <int G, int VPL, bool kFixed>
__device__ __forceinline__ void softmax_rows(float* buf, int rows, int n,
                                             const int* exp_tab,
                                             const int* inv_tab, int pre) {
  constexpr int kSide = 32 / G;
  constexpr int kDeep = 4;
  const int lane = threadIdx.x & 31;
  const int sub = lane / G, col = lane % G;
  const int half = pre > 0 ? (1 << (pre - 1)) : 0;
  for (int r0 = 0; r0 < rows; r0 += kSide * kDeep) {
    float* row[kDeep];
    int lim[kDeep];  // n, or 0 for the groups past the last row (they idle)
    float v[kDeep][VPL], mx[kDeep];
#pragma unroll
    for (int q = 0; q < kDeep; ++q) {
      const int r = r0 + q * kSide + sub;
      lim[q] = r < rows ? n : 0;
      row[q] = buf + r * n;
      mx[q] = -INFINITY;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int i = col + j * G;
        v[q][j] = i < lim[q] ? row[q][i] : -INFINITY;
        mx[q] = fmaxf(mx[q], v[q][j]);
      }
    }
    if constexpr (G == 32) {
#pragma unroll
      for (int q = 0; q < kDeep; ++q)
        mx[q] = from_order_key(__reduce_max_sync(kFull, order_key(mx[q])));
    } else {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < kDeep; ++q)
          mx[q] = fmaxf(mx[q], __shfl_xor_sync(kFull, mx[q], o));
    }
    if constexpr (kFixed) {
      int e[kDeep][VPL], s[kDeep];
#pragma unroll
      for (int q = 0; q < kDeep; ++q) {
        s[q] = 0;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          e[q][j] = 0;
          if (col + j * G < lim[q]) {
            e[q][j] = exp_q24(exp_tab, mx[q], v[q][j]);
            s[q] += (e[q][j] + half) >> pre;
          }
        }
      }
      if constexpr (G == 32) {
#pragma unroll
        for (int q = 0; q < kDeep; ++q) s[q] = __reduce_add_sync(kFull, s[q]);
      } else {
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
          for (int q = 0; q < kDeep; ++q) s[q] += __shfl_xor_sync(kFull, s[q], o);
      }
#pragma unroll
      for (int q = 0; q < kDeep; ++q) {
        const int inv = reciprocal_q24(s[q], inv_tab) >> pre;    // ALU_INVERT
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          if (col + j * G < lim[q])
            row[q][col + j * G] = q24_to_float(fixed_mul_nonneg(e[q][j], inv));
      }
    } else {
      float e[kDeep][VPL];
      double s[kDeep];
#pragma unroll
      for (int q = 0; q < kDeep; ++q) {
        s[q] = 0.0;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          e[q][j] = 0.0f;
          if (col + j * G < lim[q]) {
            e[q][j] = exp_f32(exp_tab, mx[q], v[q][j]);
            s[q] += (double)e[q][j];
          }
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < kDeep; ++q) s[q] += __shfl_xor_sync(kFull, s[q], o);
#pragma unroll
      for (int q = 0; q < kDeep; ++q) {
        const float total = (float)s[q];
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          if (col + j * G < lim[q])
            row[q][col + j * G] = __fdiv_rn(e[q][j], total);
      }
    }
  }
}

// Every warp runs its own ring of kStages slabs: lane 0 copies them in and
// out, the warp computes; the warps of a block meet only to stage the tables.
template <int G, int VPL, bool kFixed>
__global__ void __launch_bounds__(kSlabThreads)
softmax_slab_kernel(const float* __restrict__ x, const int* __restrict__ exp_g,
                    const int* __restrict__ inv_g, float* __restrict__ out,
                    int m, int n, int slab_rows, int per_warp, int pre) {
  extern __shared__ __align__(128) float rings[];  // per warp kStages slabs
  __shared__ int exp_tab[kEntries];
  __shared__ int inv_tab[kFixed ? kEntries : 1];
  __shared__ __align__(8) uint64_t full[kSlabWarps][kStages];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab_elems = slab_rows * n;  // a multiple of 4
  float* ring = rings + warp * kStages * slab_elems;
  uint64_t* bar = full[warp];
  // the block's run of kSlabWarps * per_warp slabs, dealt to its warps in
  // turn, so that the blocks in flight stream one compact stretch of x
  const long long span = (long long)kSlabWarps * per_warp;
  const long long all = ((long long)m + slab_rows - 1) / slab_rows;
  const long long nslabs = min(all, (blockIdx.x + 1ll) * span);
  const long long first = blockIdx.x * span + warp;
  const long long step = kSlabWarps;
  // floats of slab s: all of it but in the last slab, when M % R != 0
  auto elems_of = [&](long long s) {
    const long long left = (long long)m - s * slab_rows;
    return (left < slab_rows ? (int)left : slab_rows) * n;
  };
  // lane 0: the warp's it-th slab into its stage, by one bulk copy of its
  // whole 16-byte units (an arrival with a byte count of 0 completes the
  // phase where there are none)
  auto issue = [&](int it) {
    const long long s = first + it * step;
    if (s >= nslabs) return;
    const int b = it % kStages;
    const uint32_t bytes = (uint32_t)(elems_of(s) & ~3) * 4u;
    mbar_expect(&bar[b], bytes);
    if (bytes)
      bulk_load(ring + b * slab_elems, x + s * slab_elems, bytes, &bar[b]);
  };

  // the first copy is under way while the tables are staged
  if (lane == 0) {
    for (int b = 0; b < kStages; ++b) mbar_init(&bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue(0);
  }
  for (int i = threadIdx.x; i < kEntries; i += kSlabThreads) {
    exp_tab[i] = exp_g[i];
    if constexpr (kFixed) inv_tab[i] = inv_g[i];
  }
  __syncthreads();

  long long s = first;
  for (int it = 0; s < nslabs; ++it, s += step) {
    // slab it + 1 goes into the stage that held slab it - 2: computed before
    // the __syncwarp of iteration it - 2, and its store has read it once all
    // but the newest store (slab it - 1) have
    if (lane == 0) {
      bulk_wait_read_all_but_newest();
      issue(it + 1);
    }
    const int b = it % kStages;
    float* buf = ring + b * slab_elems;
    const int elems = elems_of(s);
    const int whole = elems & ~3;
    const long long e0 = s * slab_elems;
    mbar_wait(&bar[b], (uint32_t)(it / kStages) & 1u);
    if (whole != elems) {
      // the < 4 floats past the last 16-byte unit: only in the last slab,
      // which is also this warp's last, so no later copy lands on them
      if (lane < elems - whole) buf[whole + lane] = x[e0 + whole + lane];
      __syncwarp();
    }
    softmax_rows<G, VPL, kFixed>(buf, elems / n, n, exp_tab, inv_tab, pre);
    fence_to_async_proxy();
    __syncwarp();
    if (lane == 0 && whole) bulk_store(out + e0, buf, (uint32_t)whole * 4u);
    if (lane < elems - whole) out[e0 + whole + lane] = buf[whole + lane];
  }
  if (lane == 0) bulk_wait_all();
}

// blocks of the slab kernel an SM holds at the largest rings (registers,
// shared memory), asked once per kernel; 0 when the query failed
template <bool kFixed, int G, int VPL>
int slab_blocks_per_sm() {
  static int per_sm = 0;
  if (per_sm == 0) {
    int fit = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &fit, softmax_slab_kernel<G, VPL, kFixed>, kSlabThreads,
            kSlabWarps * kStages * sizeof(float) * kSlabFloats) != cudaSuccess)
      return 0;
    per_sm = fit > 0 ? fit : 1;
  }
  return per_sm;
}

template <bool kFixed, int G, int VPL>
int launch_slab(const float* x, const int* exp_tab, const int* inv_tab,
                float* out, int m, int n, int slab_rows, int pre,
                cudaStream_t stream, LaunchGeo* geo) {
  auto kernel = softmax_slab_kernel<G, VPL, kFixed>;
  const int per_sm = slab_blocks_per_sm<kFixed, G, VPL>();
  if (per_sm == 0) return (int)cudaGetLastError();
  // each warp walks the card's share of slabs, from 1 to kMaxPerWarp
  const long long warps = (long long)sm_count() * per_sm * kSlabWarps;
  const long long nslabs = ((long long)m + slab_rows - 1) / slab_rows;
  const long long share = nslabs / warps;
  const int per_warp = (int)(share < 1 ? 1 : (share > kMaxPerWarp ? kMaxPerWarp : share));
  const long long span = (long long)kSlabWarps * per_warp;
  const int blocks = (int)((nslabs + span - 1) / span);
  const size_t smem = kSlabWarps * kStages * sizeof(float) * (size_t)slab_rows * n;
  if (geo) return put_geo({blocks, kSlabThreads, (long long)smem, G * 16 + VPL}, geo);
  kernel<<<blocks, kSlabThreads, smem, stream>>>(x, exp_tab, inv_tab, out, m, n,
                                                 slab_rows, per_warp, pre);
  return (int)cudaGetLastError();
}

// The slab kernel for rows of n floats: G lanes a row, VPL floats a lane.
template <bool kFixed>
int launch_slab_for(const float* x, const int* exp_tab, const int* inv_tab,
                    float* out, int m, int n, int slab_rows, int pre,
                    cudaStream_t stream, LaunchGeo* geo) {
#define REPRO_SLAB(g, vpl)                                                \
  return launch_slab<kFixed, g, vpl>(x, exp_tab, inv_tab, out, m, n,    \
                                     slab_rows, pre, stream, geo)
  if (n <= 1) REPRO_SLAB(1, 1);
  if (n <= 2) REPRO_SLAB(2, 1);
  if (n <= 4) REPRO_SLAB(4, 1);
  if (n <= 8) REPRO_SLAB(8, 1);
  if (n <= 16) REPRO_SLAB(16, 1);
  if (n <= 32) REPRO_SLAB(32, 1);
  if (n <= 64) REPRO_SLAB(32, 2);
  REPRO_SLAB(32, 4);
#undef REPRO_SLAB
}

// Rows per slab of the slab path for rows of n floats, or 0 for the
// global path: a base that is not 16-byte aligned, or rows longer than
// kMaxSlabN.  A multiple of 4 (so that every slab starts 16-byte aligned),
// as many as fill kSlabFloats, at least 4 for any n <= kMaxSlabN.
int slab_rows_for(int n, bool aligned) {
  if (!aligned || n < 1 || n > kMaxSlabN) return 0;
  return kSlabFloats / n / 4 * 4;
}

bool aligned16(const void* x, const void* out) {
  return ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
          15) == 0;
}

// core/approx.py::pre_shift_bits: max(0, ceil(log2 n) - 6).
int pre_shift_bits(int n) {
  const int bits = n > 1 ? 32 - __builtin_clz((unsigned)(n - 1)) : 0;
  return bits > 6 ? bits - 6 : 0;
}

inline int blocks_for(int m) {
  const int b = (m + kWarps - 1) / kWarps;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// The launcher's choice of path, for a report: rows per slab for rows of
// n floats at a 16-byte aligned (aligned != 0) or unaligned base, 0 for
// the global path.
extern "C" int lut_softmax_slab_rows(int n, int aligned) {
  return slab_rows_for(n, aligned != 0);
}

namespace {

int run_fixed(const float* x, const int* exp_tab, const int* inv_tab,
              float* out, int m, int n, cudaStream_t stream, LaunchGeo* geo) {
  const int pre = pre_shift_bits(n);
  const int slab_rows = slab_rows_for(n, aligned16(x, out));
  if (slab_rows)
    return launch_slab_for<true>(x, exp_tab, inv_tab, out, m, n, slab_rows, pre,
                                 stream, geo);
  if (geo) return put_geo({blocks_for(m), kThreads, 0, 0}, geo);
  softmax_fixed_kernel<<<blocks_for(m), kThreads, 0, stream>>>(
      x, exp_tab, inv_tab, out, m, n, pre);
  return (int)cudaGetLastError();
}

int run_float(const float* x, const float* exp_tab, float* out, int m, int n,
              cudaStream_t stream, LaunchGeo* geo) {
  const int* words = reinterpret_cast<const int*>(exp_tab);
  const int slab_rows = slab_rows_for(n, aligned16(x, out));
  if (slab_rows)
    return launch_slab_for<false>(x, words, nullptr, out, m, n, slab_rows, 0,
                                  stream, geo);
  if (geo) return put_geo({blocks_for(m), kThreads, 0, 0}, geo);
  softmax_float_kernel<<<blocks_for(m), kThreads, 0, stream>>>(x, words, out, m,
                                                               n);
  return (int)cudaGetLastError();
}

template <bool kFixed>
int slab_occupancy(int g, int vpl) {
  switch (g * 16 + vpl) {
    case 17: return slab_blocks_per_sm<kFixed, 1, 1>();
    case 33: return slab_blocks_per_sm<kFixed, 2, 1>();
    case 65: return slab_blocks_per_sm<kFixed, 4, 1>();
    case 129: return slab_blocks_per_sm<kFixed, 8, 1>();
    case 257: return slab_blocks_per_sm<kFixed, 16, 1>();
    case 513: return slab_blocks_per_sm<kFixed, 32, 1>();
    case 514: return slab_blocks_per_sm<kFixed, 32, 2>();
    case 516: return slab_blocks_per_sm<kFixed, 32, 4>();
    default: return -1;
  }
}

}  // namespace

extern "C" int lut_softmax_fixed_launch(const float* x, const int* exp_tab,
                                        const int* inv_tab, float* out, int m,
                                        int n, cudaStream_t stream) {
  return run_fixed(x, exp_tab, inv_tab, out, m, n, stream, nullptr);
}

extern "C" int lut_softmax_float_launch(const float* x, const float* exp_tab,
                                        float* out, int m, int n,
                                        cudaStream_t stream) {
  return run_float(x, exp_tab, out, m, n, stream, nullptr);
}

// The launchers' geometry for the same arguments (the addresses only for
// their alignment): out4 = grid, threads, dynamic shared memory, variant
// (0 the global path, G * 16 + VPL a slab kernel).  Launches nothing.
extern "C" int lut_softmax_geometry(const float* x, float* out, int m, int n,
                                    int fixed, long long* out4) {
  LaunchGeo* geo = reinterpret_cast<LaunchGeo*>(out4);
  return fixed ? run_fixed(x, nullptr, nullptr, out, m, n, nullptr, geo)
               : run_float(x, nullptr, out, m, n, nullptr, geo);
}

// Blocks of the slab kernel (G lanes a row, VPL floats a lane) an SM
// holds, as the launcher asks it; -1 for a kernel that is not built.
extern "C" int lut_softmax_occupancy(int g, int vpl, int fixed) {
  return fixed ? slab_occupancy<true>(g, vpl) : slab_occupancy<false>(g, vpl);
}
