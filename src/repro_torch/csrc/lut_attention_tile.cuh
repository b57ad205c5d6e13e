// What the two flash-LUT attention sources share: lut_attention.cu (the
// kernel for D <= 128, the entry points, and what both kernels compute)
// and lut_attention_wide.cu (the kernel for 128 < D <= 256).  Both use the
// launch arguments, the 3xTF32 products, the copies, the quad reductions,
// the LUT probe, the epilogue, the SM count and the occupancy query; the
// staging of rows and one key tile's QK^T, online softmax step and P V
// below are lut_attention.cu's.  Two sources so that nvcc builds the two
// kernels' instances at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch_geometry.cuh"

namespace lut_attention {


constexpr int kEntries = 320;
constexpr int kMaxWarps = 8;
constexpr int kMaxNt = 16;              // key fragments of 8 a tile: bk <= 128
constexpr int kMaxDt = 32;              // depth fragments: D <= 256
constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 232448;        // bytes a block may opt into on sm_90

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* tab;
  void* out;
  long long sq[3], sk[3], sv[3], so[3];   // batch, head, row strides
  int hq, hkv, lq, lk, d, bk;
  int causal, use_lut;
  float scale;
  int is_bf16;
  int splits, wpb, items;    // query-row splits per head, warps a block, items
  int stages, vec_in, vec_out;
};

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: what cvt.rna.tf32.f32 gives for a finite x, in two
// integer operations), lo = x - hi is exact; the tensor core reads lo's top
// 10 mantissa bits (it ignores the low 13 bits of a TF32 operand), so lo
// is truncated there, an error below 2^-22 |x|
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// not volatile: the compiler interleaves independent products, which an
// in-order warp needs to keep the tensor cores busy
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// d = a * b with a zero accumulator (the zero register, no moves)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d += t, rounded to nearest (the tensor core's own accumulation is not)
__device__ __forceinline__ void add4(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] = __fadd_rn(d[c], t[c]);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// e^{-clip(x, 0, 10)}: the table probe of the reference, or expf
__device__ __forceinline__ float exp_neg(const float* tab, float x, int use_lut) {
  const float z = fminf(fmaxf(x, 0.0f), 10.0f);
  if (!use_lut) return expf(-z);
  // z * 32 is exact and in [0, 320]: adding 2^23 rounded toward zero
  // leaves its integer part in the low mantissa bits (int() truncates),
  // without a conversion instruction
  const int idx = __float_as_int(__fadd_rz(__fmul_rn(z, 32.0f), 8388608.0f))
                  - 0x4b000000;
  return tab[min(idx, kEntries - 1)];
}

// Stage `rows` rows of `d` elements, `src_stride` elements apart, into
// shared rows of `srow` floats.  float32: asynchronous copies (16 bytes
// where `vec`, else 4); bfloat16: loaded, converted and stored (8 values a
// load where `vec`).
__device__ __forceinline__ void stage_rows(float* dst, const void* src_v,
                                           long long src_stride, int rows,
                                           int d, int srow, int vec,
                                           int is_bf16) {
  if (!is_bf16) {
    const float* src = static_cast<const float*>(src_v);
    if (vec) {
      const int cpr = d >> 2;
      for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
        const int r = i / cpr, c = (i - r * cpr) << 2;
        cp_async16(dst + r * srow + c, src + r * src_stride + c);
      }
    } else {
      for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
        const int r = i / d, c = i - r * d;
        cp_async4(dst + r * srow + c, src + r * src_stride + c);
      }
    }
    return;
  }
  const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(src_v);
  if (vec) {
    const int cpr = d >> 3;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) << 3;
      const uint4 u = *reinterpret_cast<const uint4*>(src + r * src_stride + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      float* o = dst + r * srow + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        o[2 * j] = f.x;
        o[2 * j + 1] = f.y;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      dst[r * srow + c] = __bfloat162float(src[r * src_stride + c]);
    }
  }
}

// out[i], out[i + 1] (the second where `two`), in out's dtype
__device__ __forceinline__ void store2(void* out, long long i, float x,
                                       float y, bool two, int vec,
                                       int is_bf16) {
  if (is_bf16) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + i;
    if (two && vec) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    } else {
      p[0] = __float2bfloat16_rn(x);
      if (two) p[1] = __float2bfloat16_rn(y);
    }
  } else {
    float* p = static_cast<float*>(out) + i;
    if (two && vec) {
      *reinterpret_cast<float2*>(p) = make_float2(x, y);
    } else {
      p[0] = x;
      if (two) p[1] = y;
    }
  }
}

// p = E(m_new - s) over the score fragment, in place, 0 on a dead lane
// (past the tile, or masked), and the p sums of rows g and g + 8.  The
// mode is a template argument so that the loop has no branch and the
// table probes of the whole fragment can be in flight at once.
template <int NT, bool LUT>
__device__ __forceinline__ void exp_tile(float (&sc)[NT][4], const float* tab,
                                         float mn0, float mn1, int end,
                                         int lim0, int lim1, int causal,
                                         float& ps0, float& ps1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jc = j * 8 + (c & 1);
      const float sv = sc[j][c];
      float p = exp_neg(tab, __fsub_rn(c < 2 ? mn0 : mn1, sv), LUT);
      const bool dead = jc >= end ||
          (causal ? jc > (c < 2 ? lim0 : lim1) : (sv <= 0.5f * kNeg));
      if (dead) p = 0.0f;
      sc[j][c] = p;
      if (c < 2) ps0 = __fadd_rn(ps0, p); else ps1 = __fadd_rn(ps1, p);
    }
  }
}

// S = Q K^T for the tile on the tensor cores: sc[j] holds rows g, g + 8,
// keys 8j + 2t, +1.  3xTF32, the small terms first; each depth fragment's
// products go into a fresh accumulator, added rounding to nearest (the
// tensor core truncates as it accumulates), JC key fragments a pass so
// that no product waits on the one before it.  qs: the warp's 16 Q rows,
// ks: the tile's K rows, both in shared rows of DT * 8 + 4 floats.
template <int DT, int NT>
__device__ __forceinline__ void qk_tile(float (&sc)[NT][4], const float* qs,
                                        const float* ks, int g, int t) {
  constexpr int srow = DT * 8 + 4;
  constexpr int JC = NT < 4 ? NT : 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[j][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    const float* q0 = qs + g * srow + kk * 8 + t;
    const float* q1 = q0 + 8 * srow;
    unsigned ah[4], al[4];
    split(q0[0], ah[0], al[0]);
    split(q1[0], ah[1], al[1]);
    split(q0[4], ah[2], al[2]);
    split(q1[4], ah[3], al[3]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += JC) {
      // (j0 + j < NT is known at compile time: NT = 13 ends short)
      unsigned bh[JC][2], bl[JC][2];
      float pt[JC][4];
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        if (j0 + j < NT) {
          const float* kr = ks + ((j0 + j) * 8 + g) * srow + kk * 8 + t;
          split(kr[0], bh[j][0], bl[j][0]);
          split(kr[4], bh[j][1], bl[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < JC; ++j)
        if (j0 + j < NT) mma_tf32_zero(pt[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < JC; ++j)
        if (j0 + j < NT) mma_tf32(pt[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < JC; ++j)
        if (j0 + j < NT) mma_tf32(pt[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < JC; ++j)
        if (j0 + j < NT) add4(sc[j0 + j], pt[j]);
    }
  }
}

// The online softmax step of rows g and g + 8 (rw + g, rw + 8 + g) over
// the tile's scores: scale and mask them, fold the tile max into m, turn
// sc into p in place, fold the p sums into l; al0, al1 are the rescale of
// the rows' earlier output.
template <int NT>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[NT][4], const float* tab, const Args& a, int tile, int rw,
    int g, int t, float& m0, float& m1, float& l0, float& l1, float& al0,
    float& al1) {
  // with jc = j * 8 + (c & 1), the key of sc[j][c] is key0 + jc + 2t:
  // past the tile where jc >= end, masked (causal) where jc > lim
  const int row0 = rw + g;
  const int end = a.bk - 2 * t;
  const int lim0 = a.causal ? row0 + (a.lk - a.lq) - tile * a.bk - 2 * t
                            : 0x7fffffff;
  const int lim1 = a.causal ? lim0 + 8 : 0x7fffffff;
  float mt0 = -CUDART_INF_F, mt1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jc = j * 8 + (c & 1);
      float sv = __fmul_rn(sc[j][c], a.scale);
      if (jc >= end) sv = -CUDART_INF_F;
      else if (jc > (c < 2 ? lim0 : lim1)) sv = kNeg;
      sc[j][c] = sv;
      if (c < 2) mt0 = fmaxf(mt0, sv); else mt1 = fmaxf(mt1, sv);
    }
  }
  mt0 = quad_max(mt0);
  mt1 = quad_max(mt1);
  const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
  float ps0 = 0.0f, ps1 = 0.0f;
  if (a.use_lut)
    exp_tile<NT, true>(sc, tab, mn0, mn1, end, lim0, lim1, a.causal, ps0, ps1);
  else
    exp_tile<NT, false>(sc, tab, mn0, mn1, end, lim0, lim1, a.causal, ps0,
                        ps1);
  ps0 = quad_sum(ps0);
  ps1 = quad_sum(ps1);
  al0 = exp_neg(tab, __fsub_rn(mn0, m0), a.use_lut);
  al1 = exp_neg(tab, __fsub_rn(mn1, m1), a.use_lut);
  l0 = __fadd_rn(__fmul_rn(al0, l0), ps0);
  l1 = __fadd_rn(__fmul_rn(al1, l1), ps1);
  m0 = mn0;
  m1 = mn1;
}

// o = alpha * o + P V over DO depth fragments: the score fragment of keys
// 8j + 2t, +1 is the A operand of depth indices t, t + 4; V is read at the
// same keys.  vs: the tile's V rows (rows of SROW floats) at the first
// column of the warp's depth.
template <int DO, int NT, int SROW>
__device__ __forceinline__ void pv_tile(float (&o)[DO][4],
                                        const float (&sc)[NT][4], float al0,
                                        float al1, const float* vs, int g,
                                        int t) {
#pragma unroll
  for (int dt = 0; dt < DO; ++dt) {
    o[dt][0] = __fmul_rn(al0, o[dt][0]);
    o[dt][1] = __fmul_rn(al0, o[dt][1]);
    o[dt][2] = __fmul_rn(al1, o[dt][2]);
    o[dt][3] = __fmul_rn(al1, o[dt][3]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    unsigned ph[4], pl[4];
    split(sc[j][0], ph[0], pl[0]);
    split(sc[j][2], ph[1], pl[1]);
    split(sc[j][1], ph[2], pl[2]);
    split(sc[j][3], ph[3], pl[3]);
    const float* v0 = vs + (j * 8 + 2 * t) * SROW + g;
    // 3xTF32, the small terms first, into a fresh accumulator per key
    // fragment added rounding to nearest (the tensor core truncates as
    // it accumulates); DC depth fragments at a time
    constexpr int DC = DO < 4 ? DO : 4;
#pragma unroll
    for (int d0 = 0; d0 < DO; d0 += DC) {
      unsigned bh[DC][2], bl[DC][2];
      float pt[DC][4];
#pragma unroll
      for (int e = 0; e < DC; ++e) {
        split(v0[(d0 + e) * 8], bh[e][0], bl[e][0]);
        split(v0[SROW + (d0 + e) * 8], bh[e][1], bl[e][1]);
      }
#pragma unroll
      for (int e = 0; e < DC; ++e)
        mma_tf32_zero(pt[e], pl, bh[e][0], bh[e][1]);
#pragma unroll
      for (int e = 0; e < DC; ++e) mma_tf32(pt[e], ph, bl[e][0], bl[e][1]);
#pragma unroll
      for (int e = 0; e < DC; ++e) {
        mma_tf32(pt[e], ph, bh[e][0], bh[e][1]);
        add4(o[d0 + e], pt[e]);
      }
    }
  }
}

// The epilogue of an item: out = o / max(l, 1e-30) at rows row0, row0 + 8
// and the DO depth fragments from column c0.
template <int DO>
__device__ __forceinline__ void store_tile(const float (&o)[DO][4],
                                           const Args& a, int pair, int row0,
                                           int c0, int t, float l0,
                                           float l1) {
  const int b = pair / a.hq, h = pair - b * a.hq;
  const int row1 = row0 + 8;
  const float i0 = fmaxf(l0, 1e-30f), i1 = fmaxf(l1, 1e-30f);
  const long long ob = b * a.so[0] + h * a.so[1];
#pragma unroll
  for (int dt = 0; dt < DO; ++dt) {
    const int col = c0 + dt * 8 + 2 * t;
    if (col < a.d) {
      const bool two = col + 1 < a.d;
      if (row0 < a.lq)
        store2(a.out, ob + (long long)row0 * a.so[2] + col,
               __fdiv_rn(o[dt][0], i0), __fdiv_rn(o[dt][1], i0), two,
               a.vec_out, a.is_bf16);
      if (row1 < a.lq)
        store2(a.out, ob + (long long)row1 * a.so[2] + col,
               __fdiv_rn(o[dt][2], i1), __fdiv_rn(o[dt][3], i1), two,
               a.vec_out, a.is_bf16);
    }
  }
}

// the SMs of the current device
inline int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

// Blocks of `threads` threads and `bytes` of shared memory of one kernel
// that fit an SM; the kernel opts into kMaxSmem at the first question, and
// the last answer is kept.  One of these per kernel instance.
struct Occupancy {
  bool opted = false;
  int last_threads = -1, last_result = 0;
  long long last_bytes = -1;

  int operator()(void (*kernel)(const Args), int threads, long long bytes) {
    if (!opted) {
      if (cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem) != cudaSuccess)
        return 0;
      opted = true;
    }
    if (threads != last_threads || bytes != last_bytes) {
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, kernel, threads, (size_t)bytes) != cudaSuccess)
        return 0;
      last_threads = threads;
      last_bytes = bytes;
      last_result = n;
    }
    return last_result;
  }
};

// lut_attention_wide.cu: the launcher for 128 < D <= 256 (the arguments
// checked, as run() in lut_attention.cu does), and the occupancy of its
// instances (DT 24 or 32, NT 4 or 16; -1 for one that is not built)
int launch_wide(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo);
int wide_occupancy(int dt, int nt, int threads, long long bytes);

}  // namespace lut_attention
