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
// - Above D = 128, up to D = 256, lut_attention_wide.cu: its own design
//   (its header comment), sharing lut_attention_tile.cuh's arguments,
//   3xTF32 split, LUT probe and epilogue with this kernel.
// - Ragged edges are masked in the kernel, never padded in device memory:
//   key tiles of any width (a partial fragment of 8 keys), D not a multiple
//   of 8, Lq of 1, and GQA by h / (Hq / Hkv).  The pads of shared memory
//   that meet data in a product are zeroed once per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "launch_geometry.cuh"
#include "lut_attention_tile.cuh"

namespace {

using namespace lut_attention;

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
      float sc[NT][4], al0, al1;
      qk_tile<DT, NT>(sc, qs, ks, g, t);
      softmax_tile<NT>(sc, tab, a, tile, rw, g, t, m0, m1, l0, l1, al0, al1);
      pv_tile<DT, NT, srow>(o, sc, al0, al1, vs, g, t);
      if (tile == tiles - 1)       // the epilogue of the item
        store_tile<DT>(o, a, pair, rw + g, 0, t, l0, l1);
    }
    __syncthreads();               // the stages read here may be refilled
    if (a.stages == 1 && s + 1 < nsteps) issue(s + 1);
  }
}

template <int DT, int NT>
int blocks_per_sm(int threads, long long bytes) {
  static Occupancy occupancy;
  return occupancy(attn_kernel<DT, NT>, threads, bytes);
}

template <int DT, int NT>
int launch(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo) {
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
  // where two stages fit at no width (D = 128 with tiles of 128 keys, the
  // dense LMs' causal attention), one stage, refilled after each step
  const int wpb0 = wpb;
  bool force_one = false;
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
    const bool one = force_one ||
        (tiles == 1 && (bps1 >= 2 * bps2 || items <= (long long)bps1 * sms));
    const int stages = one ? 1 : 2;
    const long long bytes = one ? bytes1 : bytes2;
    const int bps = one ? bps1 : bps2;
    const long long cap = (long long)bps * sms;
    const long long grid = items < cap ? items : cap;
    if (bps <= 0) {
      if (wpb == 1) {
        if (force_one) return (int)cudaErrorInvalidValue;
        force_one = true;
        wpb = wpb0;
        continue;
      }
      wpb = (wpb + 1) / 2;
      continue;
    }
    a.splits = splits;
    a.wpb = wpb;
    a.items = (int)items;
    a.stages = stages;
    if (geo)
      return put_geo({grid, threads, bytes, (DT * 100 + NT) * 10 + stages},
                     geo);
    attn_kernel<DT, NT><<<(unsigned)grid, threads, (size_t)bytes, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

// the built shapes: D <= 8, 64, 128 and bk <= 32, 128, and KWT-1's
// 99 keys in 13 fragments
template <int DT>
int launch_nt(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo) {
  if (a.bk <= 32) return launch<DT, 4>(a, pairs, stream, geo);
  if (a.bk > 96 && a.bk <= 104) return launch<DT, 13>(a, pairs, stream, geo);
  return launch<DT, 16>(a, pairs, stream, geo);
}

int launch_any(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo) {
  if (a.d <= 8) return launch_nt<1>(a, pairs, stream, geo);
  if (a.d <= 64) return launch_nt<8>(a, pairs, stream, geo);
  if (a.d <= 128) return launch_nt<16>(a, pairs, stream, geo);
  return launch_wide(a, pairs, stream, geo);     // lut_attention_wide.cu
}

template <int DT>
int occupancy_nt(int nt, int threads, long long bytes) {
  switch (nt) {
    case 4: return blocks_per_sm<DT, 4>(threads, bytes);
    case 13: return blocks_per_sm<DT, 13>(threads, bytes);
    case 16: return blocks_per_sm<DT, 16>(threads, bytes);
    default: return -1;
  }
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Strides are in elements, per operand (batch, head, row); the depth axis
// has stride 1.  Refused (cudaErrorInvalidValue): D > 256, bk > 128, a bk
// that does not divide Lk, Hq not a multiple of Hkv.
int run(const void* q, const void* k, const void* v, const float* tab,
        void* out, int b, int hq, int hkv, int lq, int lk, int d, int bk,
        int causal, int use_lut, int is_bf16, float scale, int sqb, int sqh,
        int sql, int skb, int skh, int skl, int svb, int svh, int svl, int sob,
        int soh, int sol, cudaStream_t stream, LaunchGeo* geo) {
  if (hkv <= 0 || hq % hkv || bk <= 0 || bk > 8 * kMaxNt || lk % bk || d <= 0
      || d > 8 * kMaxDt)
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
  return launch_any(a, pairs, stream, geo);
}

}  // namespace

extern "C" int lut_attention_launch(
    const void* q, const void* k, const void* v, const float* tab, void* out,
    int b, int hq, int hkv, int lq, int lk, int d, int bk, int causal,
    int use_lut, int is_bf16, float scale, int sqb, int sqh, int sql, int skb,
    int skh, int skl, int svb, int svh, int svl, int sob, int soh, int sol,
    cudaStream_t stream) {
  return run(q, k, v, tab, out, b, hq, hkv, lq, lk, d, bk, causal, use_lut,
             is_bf16, scale, sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob,
             soh, sol, stream, nullptr);
}

// The launcher's geometry for the same arguments: out4 = grid, threads,
// dynamic shared memory, variant ((DT * 100 + NT) * 10 + stages; DT > 16
// is attn_wide_kernel).
// Launches nothing; no heads or no query rows report a grid of 0.
extern "C" int lut_attention_geometry(int b, int hq, int hkv, int lq, int lk,
                                      int d, int bk, long long* out4) {
  LaunchGeo* geo = reinterpret_cast<LaunchGeo*>(out4);
  *geo = {0, 0, 0, 0};
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, b, hq, hkv, lq, lk,
             d, bk, 0, 1, 0, 1.0f, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, nullptr,
             geo);
}

// Blocks an SM holds of the kernel built for DT depth and NT key fragments
// with `threads` threads and `bytes` of shared memory, as the launcher
// asks it; -1 for a kernel that is not built.
extern "C" int lut_attention_occupancy(int dt, int nt, int threads,
                                       long long bytes) {
  switch (dt) {
    case 1: return occupancy_nt<1>(nt, threads, bytes);
    case 8: return occupancy_nt<8>(nt, threads, bytes);
    case 16: return occupancy_nt<16>(nt, threads, bytes);
    case 24:
    case 32: return lut_attention::wide_occupancy(dt, nt, threads, bytes);
    default: return -1;
  }
}
