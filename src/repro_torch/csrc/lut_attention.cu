// Flash attention with the paper's LUT exp in the online softmax, for sm_90a.
//
// Replaces the TPU kernel `lut_attention` of the reference
// (src/repro/kernels/lut_attention.py: body `_attn_kernel`, table probe
// `_lut_exp_f32`).
//
// What it computes, for q [B, Hq, Lq, D] and k, v [B, Hkv, Lk, D]
// (query head h reads key/value head h / (Hq / Hkv)), float32 or bfloat16
// in, float32 arithmetic, out in q's dtype.  Per query row, over the key
// axis cut into tiles of `bk` keys (bk divides Lk: the wrapper passes the
// reference's own tile edge), with m = -1e30, l = 0, acc = 0 at the start:
//   s_j   = (q . k_j) * scale            masked (causal) lanes: s_j = -1e30
//   m_new = max(m, max_j s_j)            over the tile
//   p_j   = E(clip(m_new - s_j, 0, 10))  0 on a masked lane (causal), or
//                                        where s_j <= -5e29 (non-causal)
//   alpha = E(clip(m_new - m, 0, 10))
//   l     = alpha * l + sum_j p_j;  acc = alpha * acc + sum_j p_j v_j;  m = m_new
// and at the end out = acc / max(l, 1e-30).  E(z) is EXP_F32[clip(int(z*32),
// 0, 319)] (int() truncates) in the LUT mode and expf(-z) in the exact mode.
// Causal: query row r (0-based) sees key c iff r + (Lk - Lq) >= c, queries
// right-aligned against the keys.  The rescale alpha is itself a table probe
// quantised to 1/32 bins, so the answer depends on where the key tiles are
// cut; the kernel cuts exactly where the reference does and does the update
// only there.  No atomics, and every sum has a fixed order, so a result is
// the same from run to run.
//
// Operands are strided: element strides for batch, head and row of q, k, v
// and out (the depth axis has stride 1), so the model's [B, L, H, D]
// projections go in as views and the output can be written in the layout
// the next projection reads.
//
// What bounds it here.  At KWT-1's shape (Lq = Lk = 99, D = 64, one head)
// q, k, v and out are 101 KB per head and the products 2.5 MFLOP per head:
// on the CUDA cores (67 TFLOP/s float32) the operations bind, on the tensor
// cores the bytes would.  What the design does:
// - Both products on the tensor cores, mma.sync m16n8k8 TF32 with the 3xTF32
//   split: a = a_hi + a_lo with a_hi = a rounded to TF32 (as cvt.rna.tf32,
//   in two integer operations), a_lo = a - a_hi, which the tensor core
//   truncates to TF32; a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.  That keeps about
//   21 bits of each operand; single-pass TF32 (10 bits) would move a score
//   by ~5e-4, across a 1/32 LUT bin for a few per cent of the scores
//   (tests/test_torch_attention.py emulates both).  The tensor core
//   truncates as it accumulates, so each depth fragment of QK^T and each key
//   fragment of P.V goes into a fresh accumulator that is added to the sum
//   rounding to nearest: chained, the truncations moved scores by ~1e-6
//   (LUT bins in rows of 1000 keys) and the outputs enough that 12 layers
//   of the integer pipeline changed the argmax of 7 KWT-1 samples in 64.
//   mma.sync runs TF32 at a fraction of wgmma's rate, and the splits and
//   the LUT softmax cost as many instructions as the products (PERF.md).
// - FlashAttention-2's layout: each warp owns 16 query rows; the score tile
//   of a whole key tile (bk <= 128 keys, at most 16 fragments of 8 keys)
//   stays in registers; the row max and the p sum reduce over the four
//   threads that share a row.  The keys of the P.V product are taken in the
//   order in which the score fragment holds them (key 2t of a group of 8 as
//   depth index t, key 2t+1 as t+4), so P goes from the score accumulator
//   straight into the A operand, with no shuffle and no shared memory.
// - K and V are read once per (batch, head) per query-row split: a block
//   owns up to 8 warps (128 query rows) of one head, and splits the query
//   rows over several blocks only where the heads alone would not fill the
//   card.  Q, K and V are staged with 16-byte cp.async (float32; bfloat16 is
//   converted to float32 as it is staged, through registers) into shared
//   rows of D + 4 floats, so that every fragment load is free of bank
//   conflicts.  A block walks several (head, split) items, and key tiles,
//   with a ring of two stages: the next tile is in flight while it computes
//   this one.
// - Ragged edges are masked in the kernel, never padded in device memory:
//   key tiles of any width (a partial fragment of 8 keys), D not a multiple
//   of 8, Lq of 1, and GQA by h / (Hq / Hkv).  The pads of shared memory
//   that meet data in a product are zeroed once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kEntries = 320;
constexpr int kMaxWarps = 8;
constexpr int kMaxNt = 16;              // key fragments of 8 a tile: bk <= 128
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

// shared memory of one block, in floats: the table, the Q buffers
// [stages][wpb * 16][srow], the K/V stages [stages][2][nt * 8][srow]
__host__ __device__ inline long long smem_floats(int stages, int wpb, int nt,
                                                 int srow) {
  return kEntries + (long long)stages * wpb * 16 * srow
         + (long long)stages * 2 * nt * 8 * srow;
}

// DT depth fragments of 8 and NT key fragments of 8, both at least what
// the shape needs: the loops run over all of them, with no test inside, so
// that the compiler can interleave the products; the pads are zeros in
// shared memory (a zero depth adds nothing to a score; a key past the tile
// gets p = 0 and a zero V row).
// (one block an SM, all 255 registers: without the 1, ptxas caps the
// fragments at 186 registers and the kernel runs a fifth slower at KWT-1)
template <int DT, int NT>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
attn_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int srow = DT * 8 + 4;     // 4 * odd floats: no bank conflicts
  float* tab = smem;
  float* qbuf = tab + kEntries;
  const int qfloats = a.wpb * 16 * srow;
  float* kvbuf = qbuf + a.stages * qfloats;
  constexpr int kvfloats = 2 * NT * 8 * srow;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = a.lk / a.bk;
  const int group = a.hq / a.hkv;
  const int mine = blockIdx.x < a.items
      ? (a.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nsteps = mine * tiles;
  const int es = a.is_bf16 ? 2 : 4;
  const char* q = static_cast<const char*>(a.q);
  const char* k = static_cast<const char*>(a.k);
  const char* v = static_cast<const char*>(a.v);

  {   // zero the pads once; no copy writes them.  A pad that meets real
      // data in a product must be a finite zero: the depth past D (all of
      // shared memory then, it is rare) and the V rows past the tile.  Rows
      // past Lq and K rows past the tile only make scores that are never
      // stored or are masked.
    if (a.d < DT * 8) {
      const long long n4 = (smem_floats(a.stages, a.wpb, NT, srow) - kEntries) / 4;
      float4* z = reinterpret_cast<float4*>(qbuf);
      for (long long i = threadIdx.x; i < n4; i += blockDim.x)
        z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const int n = (NT * 8 - a.bk) * srow;
      for (int st = 0; st < a.stages; ++st) {
        float* vz = kvbuf + st * kvfloats + (NT * 8 + a.bk) * srow;
        for (int i = threadIdx.x; i < n; i += blockDim.x) vz[i] = 0.0f;
      }
    }
    for (int i = threadIdx.x; i < kEntries; i += blockDim.x) tab[i] = a.tab[i];
  }
  __syncthreads();

  // issue the copies of step s: Q with an item's first tile, K and V always
  auto issue = [&](int s) {
    const int li = s / tiles, tile = s - li * tiles;
    const int item = blockIdx.x + li * gridDim.x;
    const int pair = item / a.splits, sp = item - pair * a.splits;
    const int b = pair / a.hq, h = pair - b * a.hq, hk = h / group;
    if (tile == 0) {
      const int r0 = sp * a.wpb * 16;
      const int rows = min(a.wpb * 16, a.lq - r0);
      stage_rows(qbuf + (a.stages > 1 ? (li & 1) : 0) * qfloats,
                 q + es * (b * a.sq[0] + h * a.sq[1] + (long long)r0 * a.sq[2]),
                 a.sq[2], rows, a.d, srow, a.vec_in, a.is_bf16);
    }
    const long long key0 = (long long)tile * a.bk;
    float* kv = kvbuf + (a.stages > 1 ? (s & 1) : 0) * kvfloats;
    stage_rows(kv, k + es * (b * a.sk[0] + hk * a.sk[1] + key0 * a.sk[2]),
               a.sk[2], a.bk, a.d, srow, a.vec_in, a.is_bf16);
    stage_rows(kv + NT * 8 * srow,
               v + es * (b * a.sv[0] + hk * a.sv[1] + key0 * a.sv[2]),
               a.sv[2], a.bk, a.d, srow, a.vec_in, a.is_bf16);
    cp_commit();
  };

  float o[DT][4];
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  // two stages: the next step's copies are in flight during this one;
  // one stage: they start after it (other blocks on the SM fill the gap)
  if (nsteps > 0) issue(0);
  for (int s = 0; s < nsteps; ++s) {
    if (a.stages > 1 && s + 1 < nsteps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const int li = s / tiles, tile = s - li * tiles;
    const int item = blockIdx.x + li * gridDim.x;
    const int pair = item / a.splits, sp = item - pair * a.splits;
    const int rw = sp * a.wpb * 16 + warp * 16;     // the warp's first row
    if (warp < a.wpb && rw < a.lq) {
      const float* qs = qbuf + (a.stages > 1 ? (li & 1) : 0) * qfloats
                        + warp * 16 * srow;
      const float* ks = kvbuf + (a.stages > 1 ? (s & 1) : 0) * kvfloats;
      const float* vs = ks + NT * 8 * srow;
      if (tile == 0) {
        m0 = m1 = kNeg;
        l0 = l1 = 0.0f;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[dt][c] = 0.0f;
      }
      // S = Q K^T for the tile on the tensor cores: sc[j] holds rows g,
      // g + 8, keys 8j + 2t, +1.  3xTF32, the small terms first; each depth
      // fragment's products go into a fresh accumulator, added rounding to
      // nearest (the tensor core truncates as it accumulates), JC key
      // fragments a pass so that no product waits on the one before it.
      constexpr int JC = NT < 4 ? NT : 4;
      float sc[NT][4];
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
      // scale and mask, the tile max of rows g and g + 8
      // with jc = j * 8 + (c & 1), the key of sc[j][c] is key0 + jc + 2t:
      // past the tile where jc >= end, masked (causal) where jc > lim
      const int row0 = rw + g, row1 = row0 + 8;
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
        exp_tile<NT, true>(sc, tab, mn0, mn1, end, lim0, lim1, a.causal, ps0,
                           ps1);
      else
        exp_tile<NT, false>(sc, tab, mn0, mn1, end, lim0, lim1, a.causal, ps0,
                            ps1);
      ps0 = quad_sum(ps0);
      ps1 = quad_sum(ps1);
      const float al0 = exp_neg(tab, __fsub_rn(mn0, m0), a.use_lut);
      const float al1 = exp_neg(tab, __fsub_rn(mn1, m1), a.use_lut);
      l0 = __fadd_rn(__fmul_rn(al0, l0), ps0);
      l1 = __fadd_rn(__fmul_rn(al1, l1), ps1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] = __fmul_rn(al0, o[dt][0]);
        o[dt][1] = __fmul_rn(al0, o[dt][1]);
        o[dt][2] = __fmul_rn(al1, o[dt][2]);
        o[dt][3] = __fmul_rn(al1, o[dt][3]);
      }
      // O += P V: the score fragment of keys 8j + 2t, +1 is the A operand
      // of depth indices t, t + 4; V is read at the same keys
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned ph[4], pl[4];
        split(sc[j][0], ph[0], pl[0]);
        split(sc[j][2], ph[1], pl[1]);
        split(sc[j][1], ph[2], pl[2]);
        split(sc[j][3], ph[3], pl[3]);
        const float* v0 = vs + (j * 8 + 2 * t) * srow + g;
        // 3xTF32, the small terms first, into a fresh accumulator per key
        // fragment added rounding to nearest (the tensor core truncates as
        // it accumulates); DC depth fragments at a time
        constexpr int DC = DT < 4 ? DT : 4;
#pragma unroll
        for (int d0 = 0; d0 < DT; d0 += DC) {
          unsigned bh[DC][2], bl[DC][2];
          float pt[DC][4];
#pragma unroll
          for (int e = 0; e < DC; ++e) {
            split(v0[(d0 + e) * 8], bh[e][0], bl[e][0]);
            split(v0[srow + (d0 + e) * 8], bh[e][1], bl[e][1]);
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
      if (tile == tiles - 1) {     // the epilogue of the item
        const int b = pair / a.hq, h = pair - b * a.hq;
        const float i0 = fmaxf(l0, 1e-30f), i1 = fmaxf(l1, 1e-30f);
        const long long ob = b * a.so[0] + h * a.so[1];
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const int col = dt * 8 + 2 * t;
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
    }
    __syncthreads();               // the stages read here may be refilled
    if (a.stages == 1 && s + 1 < nsteps) issue(s + 1);
  }
}

int sm_count() {
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

// blocks of `threads` threads and `bytes` of shared memory that fit an SM
template <int DT, int NT>
int blocks_per_sm(int threads, long long bytes) {
  static bool opted = false;
  static int last_threads = -1, last_result = 0;
  static long long last_bytes = -1;
  if (!opted) {
    if (cudaFuncSetAttribute(attn_kernel<DT, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem) != cudaSuccess)
      return 0;
    opted = true;
  }
  if (threads != last_threads || bytes != last_bytes) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, attn_kernel<DT, NT>, threads, (size_t)bytes) != cudaSuccess)
      return 0;
    last_threads = threads;
    last_bytes = bytes;
    last_result = n;
  }
  return last_result;
}

template <int DT, int NT>
int launch(Args& a, long long pairs, cudaStream_t stream) {
  constexpr int srow = DT * 8 + 4;
  const int groups = (a.lq + 15) / 16;            // 16-row query groups
  const int sms = sm_count();
  // split the query rows of a head over several blocks only where the
  // heads alone would not give every SM two blocks
  int splits = pairs >= 2LL * sms ? 1
      : (int)((2LL * sms + pairs - 1) / pairs);
  splits = splits < 1 ? 1 : (splits > groups ? groups : splits);
  int wpb = (groups + splits - 1) / splits;
  if (wpb > kMaxWarps) wpb = kMaxWarps;
  const int tiles = a.lk / a.bk;
  for (;;) {
    splits = (groups + wpb - 1) / wpb;
    const long long items = pairs * splits;
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int threads = 32 * wpb;
    // a ring of two stages, unless one stage lets twice the blocks share
    // an SM (then a block's copies overlap the others' products) and the
    // keys are one tile
    const long long bytes1 = smem_floats(1, wpb, NT, srow) * 4;
    const long long bytes2 = smem_floats(2, wpb, NT, srow) * 4;
    const int bps1 =
        bytes1 <= kMaxSmem ? blocks_per_sm<DT, NT>(threads, bytes1) : 0;
    const int bps2 =
        bytes2 <= kMaxSmem ? blocks_per_sm<DT, NT>(threads, bytes2) : 0;
    const bool one = tiles == 1 && (bps1 >= 2 * bps2 || items <= (long long)bps1 * sms);
    const int stages = one ? 1 : 2;
    const long long bytes = one ? bytes1 : bytes2;
    const int bps = one ? bps1 : bps2;
    const long long cap = (long long)bps * sms;
    const long long grid = items < cap ? items : cap;
    if (bps <= 0) {
      if (wpb == 1) return (int)cudaErrorInvalidValue;
      wpb = (wpb + 1) / 2;
      continue;
    }
    a.splits = splits;
    a.wpb = wpb;
    a.items = (int)items;
    a.stages = stages;
    attn_kernel<DT, NT><<<(unsigned)grid, threads, (size_t)bytes, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

// the built shapes: D <= 8, 64, 128 and bk <= 32, 128, and KWT-1's
// 99 keys in 13 fragments
template <int DT>
int launch_nt(Args& a, long long pairs, cudaStream_t stream) {
  if (a.bk <= 32) return launch<DT, 4>(a, pairs, stream);
  if (a.bk > 96 && a.bk <= 104) return launch<DT, 13>(a, pairs, stream);
  return launch<DT, 16>(a, pairs, stream);
}

int launch_any(Args& a, long long pairs, cudaStream_t stream) {
  if (a.d <= 8) return launch_nt<1>(a, pairs, stream);
  if (a.d <= 64) return launch_nt<8>(a, pairs, stream);
  return launch_nt<16>(a, pairs, stream);
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Strides are in elements, per operand (batch, head, row); the depth axis
// has stride 1.  Refused (cudaErrorInvalidValue): D > 128, bk > 128, a bk
// that does not divide Lk, Hq not a multiple of Hkv.
extern "C" int lut_attention_launch(
    const void* q, const void* k, const void* v, const float* tab, void* out,
    int b, int hq, int hkv, int lq, int lk, int d, int bk, int causal,
    int use_lut, int is_bf16, float scale, int sqb, int sqh, int sql, int skb,
    int skh, int skl, int svb, int svh, int svl, int sob, int soh, int sol,
    cudaStream_t stream) {
  if (hkv <= 0 || hq % hkv || bk <= 0 || bk > 8 * kMaxNt || lk % bk || d <= 0
      || d > 128)
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)b * hq;
  if (pairs == 0 || lq == 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.tab = tab; a.out = out;
  a.sq[0] = sqb; a.sq[1] = sqh; a.sq[2] = sql;
  a.sk[0] = skb; a.sk[1] = skh; a.sk[2] = skl;
  a.sv[0] = svb; a.sv[1] = svh; a.sv[2] = svl;
  a.so[0] = sob; a.so[1] = soh; a.so[2] = sol;
  a.hq = hq; a.hkv = hkv; a.lq = lq; a.lk = lk; a.d = d; a.bk = bk;
  a.causal = causal; a.use_lut = use_lut; a.scale = scale;
  a.is_bf16 = is_bf16;
  // 16-byte staging (8 bf16 or 4 f32 a vector) where every row starts on
  // 16 bytes; 8-byte pair stores where every output row starts on 8
  const int per16 = is_bf16 ? 8 : 4;
  const int es = is_bf16 ? 2 : 4;
  a.vec_in = d % per16 == 0 && aligned(q, 16) && aligned(k, 16)
             && aligned(v, 16);
  for (int s : {sqb, sqh, sql, skb, skh, skl, svb, svh, svl})
    a.vec_in = a.vec_in && s % per16 == 0;
  a.vec_out = aligned(out, 2 * es) && sob % 2 == 0 && soh % 2 == 0
              && sol % 2 == 0;
  return launch_any(a, pairs, stream);
}
