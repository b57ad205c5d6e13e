// The flash-LUT attention for 128 < D <= 256, for sm_90a.  With
// lut_attention.cu it replaces the TPU kernel `lut_attention` of the
// reference (src/repro/kernels/lut_attention.py, `_attn_kernel`), which
// tiles any D; that file's header comment says what both kernels compute:
// the online softmax over key tiles of `bk` keys (the reference's own tile
// edge), m, l and acc changed only at those edges, the rescale a LUT
// probe.  Reached through lut_attention_launch, which checks the
// arguments.
//
// What bounds it.  At nemotron-4-340b's causal GQA (2, 96(8), 1024, 1024,
// 192) the two products are 2 x 38.7 GFLOP over the causal pairs and the
// bytes are 327 MB of float32 q, k, v and out (164 MB in bf16): the
// products bind.  Their floor on this card is the tensor cores' TF32 rate
// over three (3xTF32, 165 TFLOP/s): 0.47 ms in float32; in bf16 QK^T is
// one exact bf16 product (989 TFLOP/s) and P V, at float32 accuracy, three
// (p in three bf16 parts, 330 TFLOP/s): 0.16 ms.  mma.sync reaches a
// fraction of those rates, and the splits,
// the adds that round each fragment's products to nearest and the LUT
// softmax cost as many instructions as the products.  What the design
// does about it:
//
// - Causal: a block walks only the key tiles its rows can see, up to
//   (r_last + Lk - Lq) / bk.  A tile past a row's last key leaves m, l
//   and acc as they are (m_new = m, the probe of 0 is exactly 1, p = 0),
//   so skipping it is exact.  A block whose rows see no key (Lq > Lk)
//   walks one fully masked tile and writes 0 / 1e-30 = 0.
// - Each score is computed once.  A block holds up to 4 groups of 16 query
//   rows, two warps a group; the two split the KEYS of every tile (16 of
//   every 32) and each keeps the output of the whole depth for its keys
//   (DT fragments).  They exchange their partial row maxima through shared
//   memory once a tile, so both rescale by the same m; each keeps its own
//   l and acc, which are summed once, at the end of the item.
// - bf16 as bf16: Q, K and V are staged as bf16 (16-byte cp.async) and
//   read with ldmatrix.  QK^T is one mma.sync m16n8k16 bf16 product per
//   16 of depth, exact products summed in float32.  P V keeps P whole: p =
//   hi + mid + lo in three bf16 parts (exactly), three products against V
//   (V has no low part).  float32 keeps the 3xTF32 products of
//   lut_attention.cu (split, three m16n8k8 products, each depth fragment
//   into a fresh accumulator added rounding to nearest), now once a score;
//   its Q and K fragments come by ldmatrix too (a TF32 element is a pair
//   of b16).
// - Copies overlap products: a tile streams through a ring of slots as
//   its K chunks, then its V chunks, and the chunks of the next S - 1
//   steps are in flight during each step.  Tiles of <= 128 keys take
//   chunks of 64 float32 or 128 bf16 keys (S = 3 at D <= 192, 2 at D <=
//   256: what fits beside the Q rows), tiles of <= 32 chunks of 32 (S =
//   4).  The rescale stays at
//   the reference's tile edge: after the last K chunk of a tile the scores
//   of all its keys are in registers, and only then are m, l and acc
//   moved.  Q is staged at the start of each item (its buffer held the
//   last item's partner outputs, as float32; in bf16 the depth past D and
//   the rows past Lq are then zeroed, since the products read them).  A
//   step costs a barrier and the copies' latency, so fewer, larger chunks
//   are faster.
// - Items (a head's block of query rows) are handed out last rows first,
//   in a snake over the blocks: under a causal mask the last rows see the
//   most tiles, and each block then gets about the same number of tiles.
//
// Budget of an instance (DT = 24 / 32: D <= 192 / 256; NT = 4 / 16: key
// tiles of <= 32 / <= 128 keys).  Registers: the output 4 DT floats a
// thread (96 / 128), the warp's scores 2 NT (32 at NT = 16), m and l 4,
// the fragments of one k-step; one block of 8 warps an SM (launch bounds:
// 255 registers at most; ptxas spills up to ~150 bytes in float32).
// Shared memory (bytes): the table and the row maxima 1792, Q gpb * 16
// rows of DT * 8 + 4 floats whatever the dtype, and S slots of the larger
// of the two dtypes' chunks (bf16 rows of DT * 8 + 8 values): for 4 row
// groups 205 568 (NT 16) / 152 320 (NT 4) at D = 192, 203 520 / 201 472
// at D = 256.  Phase `build` of chip_smoke.py prints ptxas' registers and
// spills of each instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_geometry.cuh"
#include "lut_attention_tile.cuh"

namespace {

using namespace lut_attention;

// the table and the row maxima [group][warp of the pair][16], in bytes
constexpr int kHeadBytes = (kEntries + kMaxWarps * 16) * 4;

// The two builds of a depth: key tiles of <= 32 keys stream in chunks of
// 32 through a ring of 4 slots; tiles of <= 128 in chunks of 64 float32
// or 128 bf16 keys (about the same bytes) through as many slots as fit
// beside the Q rows of 4 groups (3 at D <= 192, 2 at D <= 256).  A warp
// of a pair takes half of each chunk.
template <int DT, int NT, bool BF16>
struct Ring {
  static constexpr int kChunk = NT <= 4 ? 32 : (BF16 ? 128 : 64);
  static constexpr int kStages = NT <= 4 ? 4 : (DT <= 24 ? 3 : 2);
};

// bytes of a ring slot, the same for both dtypes (the larger of the two
// chunks), so that the launch geometry does not depend on the dtype
template <int DT, int NT>
__host__ __device__ constexpr int slot_bytes() {
  constexpr int f32 = Ring<DT, NT, false>::kChunk * (DT * 8 + 4) * 4;
  constexpr int bf16 = Ring<DT, NT, true>::kChunk * (DT * 8 + 8) * 2;
  return f32 > bf16 ? f32 : bf16;
}

template <int DT, int NT>
long long wide_smem_bytes(int gpb) {
  return kHeadBytes + (long long)gpb * 16 * (DT * 8 + 4) * 4
         + (long long)Ring<DT, NT, false>::kStages * slot_bytes<DT, NT>();
}

// mma.sync m16n8k16, bf16 in, float32 sum: d = a b (zero accumulator) and
// d += a b
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, each lane naming one row;
// ldsm_x4_t transposes each
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) = hi + mid + lo exactly, each part a pair of bf16 (x in the low
// half): hi rounds x to 8 bits, x - hi is exact and mid rounds it, and
// what is left has at most 8 significant bits
__device__ __forceinline__ void split3(float x, float y, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bf2_bits(h);
  mid = bf2_bits(m);
  lo = bf2_bits(__floats2bfloat162_rn(__fsub_rn(rx, mf.x),
                                      __fsub_rn(ry, mf.y)));
}

__device__ __forceinline__ void bar_pair(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id));
}

// Stage `rows` rows of `d` elements, `stride` elements apart, into shared
// rows of ROWB bytes: asynchronous copies of 16 bytes where `vec`, else
// of 4 (float32) or loads and stores (bf16, no 4-byte copy of one value).
template <bool BF16, int ROWB>
__device__ __forceinline__ void stage(char* dst, const char* src,
                                      long long stride, int rows, int d,
                                      int vec) {
  if (!BF16) {
    const float* s = reinterpret_cast<const float*>(src);
    if (vec) {
      const int cpr = d >> 2;
      for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
        const int r = i / cpr, c = (i - r * cpr) << 2;
        cp_async16(reinterpret_cast<float*>(dst + r * ROWB) + c,
                   s + r * stride + c);
      }
    } else {
      for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
        const int r = i / d, c = i - r * d;
        cp_async4(reinterpret_cast<float*>(dst + r * ROWB) + c,
                  s + r * stride + c);
      }
    }
    return;
  }
  const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(src);
  if (vec) {
    const int cpr = d >> 3;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) << 3;
      cp_async16(reinterpret_cast<float*>(dst + r * ROWB + 2 * c),
                 s + r * stride + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      reinterpret_cast<__nv_bfloat16*>(dst + r * ROWB)[c] = s[r * stride + c];
    }
  }
}

// The warp's scores of one chunk: sc[j0 .. j0 + F) = its 8 F keys (F
// fragments of 8) against the group's 16 rows over the whole depth.  qs:
// the group's Q rows, ks: the warp's first K row of the chunk.
template <int DT, int F, bool BF16, int NT>
__device__ __forceinline__ void qk_chunk(float (&sc)[NT][4], int j0,
                                         const char* qs, const char* ks,
                                         int lane) {
  if constexpr (BF16) {
    constexpr int ROWB = (DT * 8 + 8) * 2;
    const char* qa = qs + (lane & 15) * ROWB + (lane >> 4) * 16;
    const char* kb = ks + (((lane >> 4) & 1) * 8 + (lane & 7)) * ROWB
                     + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < DT / 2; ++kk) {
      unsigned a[4];
      ldsm_x4(a, qa + kk * 32);
#pragma unroll
      for (int f = 0; f < F; f += 2) {
        unsigned bq[4];
        ldsm_x4(bq, kb + f * 8 * ROWB + kk * 32);
        float p0[4], p1[4];
        mma_bf16_zero(p0, a, bq[0], bq[1]);
        mma_bf16_zero(p1, a, bq[2], bq[3]);
        add4(sc[j0 + f], p0);
        add4(sc[j0 + f + 1], p1);
      }
    }
  } else {
    // a TF32 fragment element is a pair of b16: ldmatrix gives lane (g, t)
    // the float t of row g of an 8 x 4-float matrix, so A (rows g, g + 8,
    // depth t, t + 4) is one x4 load of Q, and B (keys g, depth t, t + 4)
    // of two key fragments one x4 load of K
    constexpr int ROWB = (DT * 8 + 4) * 4;
    const char* qa = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROWB
                     + (lane >> 4) * 16;
    const char* kb = ks + ((lane & 7) + (lane >> 4) * 8) * ROWB
                     + ((lane >> 3) & 1) * 16;
    // unrolled by 4, not fully: fully, ptxas hoists loads until it spills
#pragma unroll 4
    for (int kk = 0; kk < DT; ++kk) {
      unsigned ah[4], al[4], r[4];
      unsigned bh[F][2], bl[F][2];
      ldsm_x4(r, qa + kk * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), ah[i], al[i]);
#pragma unroll
      for (int f = 0; f < F; f += 2) {
        ldsm_x4(r, kb + f * 8 * ROWB + kk * 32);
        split(__uint_as_float(r[0]), bh[f][0], bl[f][0]);
        split(__uint_as_float(r[1]), bh[f][1], bl[f][1]);
        split(__uint_as_float(r[2]), bh[f + 1][0], bl[f + 1][0]);
        split(__uint_as_float(r[3]), bh[f + 1][1], bl[f + 1][1]);
      }
      // 3xTF32, the small terms first, into a fresh accumulator (as
      // lut_attention.cu's qk_tile: the same bits)
      float p[F][4];
#pragma unroll
      for (int f = 0; f < F; ++f) mma_tf32_zero(p[f], al, bh[f][0], bh[f][1]);
#pragma unroll
      for (int f = 0; f < F; ++f) mma_tf32(p[f], ah, bl[f][0], bl[f][1]);
#pragma unroll
      for (int f = 0; f < F; ++f) mma_tf32(p[f], ah, bh[f][0], bh[f][1]);
#pragma unroll
      for (int f = 0; f < F; ++f) add4(sc[j0 + f], p[f]);
    }
  }
}

// o += P V over the warp's 8 F keys of one chunk: sc[j0 + f] holds p of
// keys 8 f .. 8 f + 7; vs: the warp's first V row of the chunk.
template <int DT, int F, bool BF16, int NT>
__device__ __forceinline__ void pv_chunk(float (&o)[DT][4],
                                         const float (&sc)[NT][4], int j0,
                                         const char* vs, int lane) {
  if constexpr (BF16) {
    constexpr int ROWB = (DT * 8 + 8) * 2;
    const char* vb = vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * ROWB
                     + (lane >> 4) * 16;
#pragma unroll
    for (int f = 0; f < F; f += 2) {
      // the score fragments of 16 keys are the A operand of k16 as they are
      const float (&s0)[4] = sc[j0 + f];
      const float (&s1)[4] = sc[j0 + f + 1];
      unsigned hi[4], mid[4], lo[4];
      split3(s0[0], s0[1], hi[0], mid[0], lo[0]);
      split3(s0[2], s0[3], hi[1], mid[1], lo[1]);
      split3(s1[0], s1[1], hi[2], mid[2], lo[2]);
      split3(s1[2], s1[3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int e = 0; e < DT / 2; ++e) {
        unsigned b[4];
        ldsm_x4_t(b, vb + f * 8 * ROWB + e * 32);
        float p0[4], p1[4];
        mma_bf16_zero(p0, lo, b[0], b[1]);
        mma_bf16_zero(p1, lo, b[2], b[3]);
        mma_bf16(p0, mid, b[0], b[1]);
        mma_bf16(p1, mid, b[2], b[3]);
        mma_bf16(p0, hi, b[0], b[1]);
        mma_bf16(p1, hi, b[2], b[3]);
        add4(o[2 * e], p0);
        add4(o[2 * e + 1], p1);
      }
    }
  } else {
    constexpr int SROW = DT * 8 + 4;
    constexpr int DC = 4;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float (&s)[4] = sc[j0 + f];
      // key 2t of the fragment is depth index t, key 2t + 1 is t + 4 (as
      // lut_attention.cu's pv_tile)
      unsigned ph[4], pl[4];
      split(s[0], ph[0], pl[0]);
      split(s[2], ph[1], pl[1]);
      split(s[1], ph[2], pl[2]);
      split(s[3], ph[3], pl[3]);
      const float* v0 = reinterpret_cast<const float*>(vs)
                        + (f * 8 + 2 * t) * SROW + g;
#pragma unroll
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += DC) {
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
}

// the key of sc[j][c] within its tile, for the warp `half` of a pair:
// fragment j is chunk j / F, keys 8 F half + 8 (j % F) of it
template <int F>
__device__ __forceinline__ int key_of(int j, int c, int half, int t) {
  return (j / F) * (16 * F) + half * 8 * F + (j % F) * 8 + 2 * t + (c & 1);
}

// the causal limits of rows rw + g and rw + g + 8 in tile `tile`: a key
// past its limit is masked
__device__ __forceinline__ void limits(const Args& a, int tile, int rw, int g,
                                       int& lim0, int& lim1) {
  if (a.causal) {
    lim0 = rw + g + (a.lk - a.lq) - tile * a.bk;
    lim1 = lim0 + 8;
  } else {
    lim0 = lim1 = 0x7fffffff;
  }
}

// scale and mask the warp's scores of a tile in place (past the tile:
// -inf; masked: -1e30) and give their row maxima, over the quad
template <int NT, int F>
__device__ __forceinline__ void mask_tile(float (&sc)[NT][4], const Args& a,
                                          int tile, int rw, int g, int t,
                                          int half, float& mt0, float& mt1) {
  int lim0, lim1;
  limits(a, tile, rw, g, lim0, lim1);
  mt0 = mt1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = key_of<F>(j, c, half, t);
      float sv = __fmul_rn(sc[j][c], a.scale);
      if (kp >= a.bk) sv = -CUDART_INF_F;
      else if (kp > (c < 2 ? lim0 : lim1)) sv = kNeg;
      sc[j][c] = sv;
      if (c < 2) mt0 = fmaxf(mt0, sv); else mt1 = fmaxf(mt1, sv);
    }
  }
  mt0 = quad_max(mt0);
  mt1 = quad_max(mt1);
}

// p = E(m_new - s) in place, 0 on a dead lane, and the p sums of the rows
template <int NT, int F, bool LUT>
__device__ __forceinline__ void exp_wide(float (&sc)[NT][4], const float* tab,
                                         float mn0, float mn1, int bk,
                                         int lim0, int lim1, int causal,
                                         int half, int t, float& ps0,
                                         float& ps1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = key_of<F>(j, c, half, t);
      const float sv = sc[j][c];
      float p = exp_neg(tab, __fsub_rn(c < 2 ? mn0 : mn1, sv), LUT);
      const bool dead = kp >= bk ||
          (causal ? kp > (c < 2 ? lim0 : lim1) : (sv <= 0.5f * kNeg));
      if (dead) p = 0.0f;
      sc[j][c] = p;
      if (c < 2) ps0 = __fadd_rn(ps0, p); else ps1 = __fadd_rn(ps1, p);
    }
  }
}

// The online softmax step at the tile's edge, with mt the tile's row
// maxima over both warps: m_new, p in place, the warp's l, and the
// rescale of its output
template <int DT, int NT, int F>
__device__ __forceinline__ void softmax_wide(
    float (&sc)[NT][4], float (&o)[DT][4], const float* tab, const Args& a,
    int tile, int rw, int g, int t, int half, float mt0, float mt1, float& m0,
    float& m1, float& l0, float& l1) {
  int lim0, lim1;
  limits(a, tile, rw, g, lim0, lim1);
  const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
  float ps0 = 0.0f, ps1 = 0.0f;
  if (a.use_lut)
    exp_wide<NT, F, true>(sc, tab, mn0, mn1, a.bk, lim0, lim1, a.causal,
                          half, t, ps0, ps1);
  else
    exp_wide<NT, F, false>(sc, tab, mn0, mn1, a.bk, lim0, lim1, a.causal, half,
                        t, ps0, ps1);
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
}

// an item: the query rows [r0, r0 + 16 gpb) of one (batch, head) pair
struct Item {
  int pair, b, h, hk, r0, nt;   // nt: the key tiles its rows can see
};

// The rank of block `block`'s li-th item: ranks in a snake over the
// blocks.  Rank r takes the split splits - 1 - r / pairs (the last rows
// first).  The kernel and lut_attention_wide_steps walk items by these.
__host__ __device__ inline int rank_of(int li, int grid, int block) {
  return li * grid + ((li & 1) ? grid - 1 - block : block);
}

__host__ __device__ inline void item_at(const Args& a, int r, Item& it) {
  const int pairs = a.items / a.splits;
  const int rows_pb = (a.wpb >> 1) * 16;
  const int tiles = a.lk / a.bk;
  const int qq = r / pairs;
  it.pair = r - qq * pairs;
  it.b = it.pair / a.hq;
  it.h = it.pair - it.b * a.hq;
  it.hk = it.h / (a.hq / a.hkv);
  it.r0 = (a.splits - 1 - qq) * rows_pb;
  it.nt = tiles;
  if (a.causal) {
    const int last = (it.r0 + rows_pb < a.lq ? it.r0 + rows_pb : a.lq) - 1
                     + (a.lk - a.lq);
    it.nt = last < 0 ? 1 : (last / a.bk + 1 < tiles ? last / a.bk + 1
                                                     : tiles);
  }
}

template <int DT, int NT, bool BF16>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
attn_wide_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  constexpr int CK = Ring<DT, NT, BF16>::kChunk;   // keys a chunk
  constexpr int S = Ring<DT, NT, BF16>::kStages;   // ring slots
  constexpr int F = CK / 16;          // a warp's fragments of 8 keys a chunk
  constexpr int NCH = NT * 8 / CK;    // chunks a tile, at most
  constexpr int NW = NT / 2;          // a warp's fragments a tile
  constexpr int SROW = DT * 8 + 4;    // floats: Q, the partner outputs
  constexpr int ROWB = BF16 ? (DT * 8 + 8) * 2 : SROW * 4;  // a staged row
  constexpr int SLOT = slot_bytes<DT, NT>();       // bytes a ring slot
  const int gpb = a.wpb >> 1;
  const int rows_pb = gpb * 16;
  float* tab = reinterpret_cast<float*>(smem);
  float* xmax = tab + kEntries;
  char* qreg = smem + kHeadBytes;
  char* ring = qreg + rows_pb * SROW * 4;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp >> 1, half = warp & 1;
  const int nck = (a.bk + CK - 1) / CK;
  const int es = BF16 ? 2 : 4;
  const char* q = static_cast<const char*>(a.q);

  {   // zeros in every staged row (the depth past D, the keys past a tile
      // meet real data in the products and must be finite), and the table
    const int n4 = (rows_pb * SROW * 4 + S * SLOT) / 16;
    float4* z = reinterpret_cast<float4*>(qreg);
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < kEntries; i += blockDim.x) tab[i] = a.tab[i];
  }
  __syncthreads();

  const int grid = (int)gridDim.x, block = (int)blockIdx.x;
  auto stage_q = [&](const Item& it) {
    const int n = min(rows_pb, a.lq - it.r0);
    stage<BF16, ROWB>(
        qreg,
        q + es * (it.b * a.sq[0] + it.h * a.sq[1]
                  + (long long)it.r0 * a.sq[2]),
        a.sq[2], n, a.d, a.vec_in);
    if constexpr (BF16) {
      // the last item's partner outputs lie over these rows as float32, and
      // half a float may read as a bf16 Inf or NaN, which times K's zero
      // depth past D gives NaN: zero the depth past D, and the rows past
      // Lq (bytes the copies above do not write)
      constexpr int W = DT * 8;
      const int pad = W - a.d;
      for (int i = threadIdx.x; i < n * pad; i += blockDim.x) {
        const int r = i / pad;
        reinterpret_cast<__nv_bfloat16*>(qreg + r * ROWB)[a.d + i - r * pad] =
            __float2bfloat16(0.0f);
      }
      for (int i = threadIdx.x; i < (rows_pb - n) * W; i += blockDim.x) {
        const int r = n + i / W;
        reinterpret_cast<__nv_bfloat16*>(qreg + r * ROWB)[i % W] =
            __float2bfloat16(0.0f);
      }
    }
  };

  // the producer: the chunks in the order the steps take them (per tile
  // its K chunks, then its V chunks), one commit group a call
  int p_li = 0, p_tile = 0, p_ph = 0, p_c = 0, p_slot = 0;
  Item pit;
  bool p_done = rank_of(0, grid, block) >= a.items;
  if (!p_done) item_at(a, rank_of(0, grid, block), pit);
  auto issue = [&]() {
    if (!p_done) {
      const long long* st = p_ph ? a.sv : a.sk;
      const char* base = static_cast<const char*>(p_ph ? a.v : a.k);
      const long long key0 = (long long)p_tile * a.bk + p_c * CK;
      stage<BF16, ROWB>(ring + p_slot * SLOT,
                        base + es * (pit.b * st[0] + pit.hk * st[1]
                                     + key0 * st[2]),
                        st[2], min(CK, a.bk - p_c * CK), a.d, a.vec_in);
      p_slot = p_slot + 1 == S ? 0 : p_slot + 1;
      if (++p_c == nck) {
        p_c = 0;
        if (p_ph == 0) {
          p_ph = 1;
        } else {
          p_ph = 0;
          if (++p_tile == pit.nt) {
            p_tile = 0;
            const int r = rank_of(++p_li, grid, block);
            if (r >= a.items) p_done = true; else item_at(a, r, pit);
          }
        }
      }
    }
    cp_commit();
  };

  // a step: its chunk has landed and every warp is past the last step;
  // the slot read there takes the chunk S - 1 steps ahead
  int c_slot = 0;
  auto step = [&]() -> const char* {
    cp_wait<S - 2>();
    __syncthreads();
    issue();
    const char* cur = ring + c_slot * SLOT;
    c_slot = c_slot + 1 == S ? 0 : c_slot + 1;
    return cur;
  };

  if (!p_done) stage_q(pit);          // in the first chunk's group
  for (int i = 0; i < S - 1; ++i) issue();

  float o[DT][4];
  float sc[NW][4];
  for (int li = 0;; ++li) {
    const int r = rank_of(li, grid, block);
    if (r >= a.items) break;
    Item it;
    item_at(a, r, it);
    if (li > 0) {
      __syncthreads();               // the partner outputs of the last item
      stage_q(it);
      cp_commit();
      cp_wait<0>();
    }
    const int rw = it.r0 + grp * 16;      // the group's first row
    const bool live = rw < a.lq;
    const char* qs = qreg + grp * 16 * ROWB;
    float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[dt][c] = 0.0f;
    for (int tile = 0; tile < it.nt; ++tile) {
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.0f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (c < nck) {
          const char* ks = step() + half * (CK / 2) * ROWB;
          if (live) qk_chunk<DT, F, BF16>(sc, c * F, qs, ks, lane);
        }
      }
      float mt0 = 0.0f, mt1 = 0.0f;
      if (live) {
        mask_tile<NW, F>(sc, a, tile, rw, g, t, half, mt0, mt1);
        if (t == 0) {
          xmax[(grp * 2 + half) * 16 + g] = mt0;
          xmax[(grp * 2 + half) * 16 + g + 8] = mt1;
        }
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (c < nck) {
          const char* vs = step() + half * (CK / 2) * ROWB;
          if (live) {
            if (c == 0) {      // the partner's maxima are in: the tile edge
              const float* px = xmax + (grp * 2 + (half ^ 1)) * 16;
              softmax_wide<DT, NW, F>(sc, o, tab, a, tile, rw, g, t, half,
                                      fmaxf(mt0, px[g]), fmaxf(mt1, px[g + 8]),
                                      m0, m1, l0, l1);
            }
            pv_chunk<DT, F, BF16>(o, sc, c * F, vs, lane);
          }
        }
      }
    }
    if (live) {   // the epilogue: the pair's two outputs and sums added
      float* cb = reinterpret_cast<float*>(qreg) + grp * 16 * SROW;
      if (half) {
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const int col = dt * 8 + 2 * t;
          *reinterpret_cast<float2*>(cb + g * SROW + col) =
              make_float2(o[dt][0], o[dt][1]);
          *reinterpret_cast<float2*>(cb + (g + 8) * SROW + col) =
              make_float2(o[dt][2], o[dt][3]);
        }
        if (t == 0) {
          cb[g * SROW + DT * 8] = l0;
          cb[(g + 8) * SROW + DT * 8] = l1;
        }
      }
      bar_pair(1 + grp);
      if (!half) {
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const int col = dt * 8 + 2 * t;
          const float2 u =
              *reinterpret_cast<const float2*>(cb + g * SROW + col);
          const float2 w =
              *reinterpret_cast<const float2*>(cb + (g + 8) * SROW + col);
          o[dt][0] = __fadd_rn(o[dt][0], u.x);
          o[dt][1] = __fadd_rn(o[dt][1], u.y);
          o[dt][2] = __fadd_rn(o[dt][2], w.x);
          o[dt][3] = __fadd_rn(o[dt][3], w.y);
        }
        l0 = __fadd_rn(l0, cb[g * SROW + DT * 8]);
        l1 = __fadd_rn(l1, cb[(g + 8) * SROW + DT * 8]);
        store_tile<DT>(o, a, it.pair, rw + g, 0, t, l0, l1);
      }
    }
  }
  cp_wait<0>();
}

template <int DT, int NT, bool BF16>
int blocks_per_sm(int threads, long long bytes) {
  static Occupancy occupancy;
  return occupancy(attn_wide_kernel<DT, NT, BF16>, threads, bytes);
}

// the blocks an SM holds of both dtypes' kernels (the geometry does not
// depend on the dtype)
template <int DT, int NT>
int blocks_both(int threads, long long bytes) {
  const int f = blocks_per_sm<DT, NT, false>(threads, bytes);
  const int h = blocks_per_sm<DT, NT, true>(threads, bytes);
  return f < h ? f : h;
}

// up to 4 groups of 16 query rows a block, two warps a group; fewer where
// an SM holds no block.  Query rows are split over several blocks only
// where the heads alone would not give every SM two items.
template <int DT, int NT>
int launch_dt(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo) {
  constexpr int S = Ring<DT, NT, false>::kStages;
  const int groups = (a.lq + 15) / 16;
  const int sms = sm_count();
  int splits = pairs >= 2LL * sms ? 1
      : (int)((2LL * sms + pairs - 1) / pairs);
  splits = splits < 1 ? 1 : (splits > groups ? groups : splits);
  int gpb = (groups + splits - 1) / splits;
  if (gpb > kMaxWarps / 2) gpb = kMaxWarps / 2;
  for (;;) {
    splits = (groups + gpb - 1) / gpb;
    const long long items = pairs * splits;
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int threads = 64 * gpb;
    const long long bytes = wide_smem_bytes<DT, NT>(gpb);
    const int bps =
        bytes <= kMaxSmem ? blocks_both<DT, NT>(threads, bytes) : 0;
    if (bps <= 0) {
      if (gpb == 1) return (int)cudaErrorInvalidValue;
      gpb = (gpb + 1) / 2;
      continue;
    }
    const long long cap = (long long)bps * sms;
    const long long grid = items < cap ? items : cap;
    a.splits = splits;
    a.wpb = 2 * gpb;
    a.items = (int)items;
    a.stages = S;
    if (geo)
      return put_geo({grid, threads, bytes, (DT * 100 + NT) * 10 + S}, geo);
    if (a.is_bf16)
      attn_wide_kernel<DT, NT, true>
          <<<(unsigned)grid, threads, (size_t)bytes, stream>>>(a);
    else
      attn_wide_kernel<DT, NT, false>
          <<<(unsigned)grid, threads, (size_t)bytes, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

// the built shapes: D <= 192, 256 and bk <= 32 (NT 4), 128 (NT 16)
template <int DT>
int launch_nt(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo) {
  if (a.bk <= 32) return launch_dt<DT, 4>(a, pairs, stream, geo);
  return launch_dt<DT, 16>(a, pairs, stream, geo);
}

template <int DT>
int occupancy_nt(int nt, int threads, long long bytes) {
  switch (nt) {
    case 4: return blocks_both<DT, 4>(threads, bytes);
    case 16: return blocks_both<DT, 16>(threads, bytes);
    default: return -1;
  }
}

}  // namespace

namespace lut_attention {

int launch_wide(Args& a, long long pairs, cudaStream_t stream,
                LaunchGeo* geo) {
  if (a.d <= 192) return launch_nt<24>(a, pairs, stream, geo);
  return launch_nt<32>(a, pairs, stream, geo);
}

int wide_occupancy(int dt, int nt, int threads, long long bytes) {
  switch (dt) {
    case 24: return occupancy_nt<24>(nt, threads, bytes);
    case 32: return occupancy_nt<32>(nt, threads, bytes);
    default: return -1;
  }
}

}  // namespace lut_attention

// The (item, key tile) steps of the launch that lut_attention_launch makes
// for these arguments (128 < D <= 256), walked by the kernel's own rank_of
// and item_at over the launcher's geometry: out3 = the steps the blocks
// walk, those of a walk over every tile, the busiest block's.  Launches
// nothing; refuses what the launcher refuses, and D <= 128.
extern "C" int lut_attention_wide_steps(int b, int hq, int hkv, int lq,
                                        int lk, int d, int bk, int causal,
                                        long long* out3) {
  out3[0] = out3[1] = out3[2] = 0;
  if (hkv <= 0 || hq % hkv || bk <= 0 || bk > 8 * lut_attention::kMaxNt
      || lk % bk || d <= 128 || d > 8 * lut_attention::kMaxDt)
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)b * hq;
  if (pairs == 0 || lq == 0) return 0;
  lut_attention::Args a = {};
  a.hq = hq; a.hkv = hkv; a.lq = lq; a.lk = lk; a.d = d; a.bk = bk;
  a.causal = causal;
  LaunchGeo geo = {0, 0, 0, 0};
  const int code = lut_attention::launch_wide(a, pairs, nullptr, &geo);
  if (code) return code;
  const int grid = (int)geo.grid;
  for (int block = 0; block < grid; ++block) {
    long long n = 0;
    for (int li = 0;; ++li) {
      const int r = rank_of(li, grid, block);
      if (r >= a.items) break;
      Item it;
      item_at(a, r, it);
      n += it.nt;
    }
    out3[0] += n;
    if (n > out3[2]) out3[2] = n;
  }
  out3[1] = (long long)a.items * (lk / bk);
  return 0;
}
