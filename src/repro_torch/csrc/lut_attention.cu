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
// only there.
//
// What bounds it here: at KWT-1's shape (Lq = Lk = 99, D = 64, one head) the
// f32 operations (4 * Lq * Lk * D per head) and the bytes of q, k, v and out
// are about even against the card's peaks (the bound is the operations, by
// a hair); at KWT-Tiny's (27 x 27, D = 8) and at small B the launch itself.
// A tile of keys is small (at most 128 x D floats), and each is read by all
// the query rows of a block.  Design, simple first: one block per (batch,
// query head, 32-row query tile) — rows are independent, so the query tiling
// is the block's own choice and does not change any result — and a loop
// over the key tiles inside the block takes the place of the TPU's
// sequential grid axis.  A key tile and its value tile are staged in shared
// memory as float32 (keys with an odd row stride, so that 32 lanes reading
// 32 keys at one depth hit 32 banks); one warp owns a query row at a time:
// each lane scores keys lane, lane + 32, ... with a sequential dot over D,
// the tile max and the p sum are warp shuffles, the p row goes through
// shared memory to the P.V product, in which each lane owns output columns
// lane, lane + 32, ...  The running (m, l, acc) of the block's rows and the
// 320-entry table live in shared memory.  No atomics and a fixed order of
// every sum, so a result is the same from run to run.  Ragged Lq and D are
// masked in the kernel; nothing is padded.  Scalar loads and CUDA-core FMAs
// only: no tensor cores, no TMA, no pipelining of the key tiles.  Every FMA
// of the score and P.V loops reads shared memory, and that, not the card's
// float rate, is what keeps it far above its bound at large B (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEntries = 320;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;               // query rows per block
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;        // bytes a block may opt into on sm_90

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// e^{-clip(x, 0, 10)}: the table probe of the reference, or expf
__device__ __forceinline__ float exp_neg(const float* tab, float x, int use_lut) {
  const float z = fminf(fmaxf(x, 0.0f), 10.0f);
  if (!use_lut) return expf(-z);
  int idx = __float2int_rz(__fmul_rn(z, 32.0f));
  idx = idx < 0 ? 0 : (idx > kEntries - 1 ? kEntries - 1 : idx);
  return tab[idx];
}

// shared memory of one block, in floats (the layout is in attn_kernel);
// a shape that needs more than a block may have is refused at launch
inline long long smem_floats(int d, int bk) {
  return kEntries + (long long)bk * (d | 1) + (long long)bk * d
         + 2LL * kRows * d + (long long)kWarps * bk + 2LL * kRows;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ tab_g,
            T* __restrict__ out, int hq, int hkv, int lq, int lk, int d,
            int bk, int q_tiles, int causal, int use_lut, float scale) {
  extern __shared__ float smem[];
  const int ks_stride = d | 1;
  float* tab = smem;
  float* ks = tab + kEntries;                    // [bk][ks_stride]
  float* vs = ks + bk * ks_stride;               // [bk][d]
  float* qs = vs + bk * d;                       // [kRows][d]
  float* accs = qs + kRows * d;                  // [kRows][d]
  float* ps = accs + kRows * d;                  // [kWarps][bk]
  float* ms = ps + kWarps * bk;                  // [kRows]
  float* ls = ms + kRows;                        // [kRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;           // b * hq + h
  const int h = bh % hq;
  const int b = bh / hq;
  const int hk = h / (hq / hkv);
  const int r0 = tile * kRows;
  const long long q_base = ((long long)bh * lq + r0) * d;
  const long long kv_base = ((long long)b * hkv + hk) * lk * d;

  for (int i = tid; i < kEntries; i += kThreads) tab[i] = tab_g[i];
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int row = r0 + i / d;
    qs[i] = row < lq ? load_f32(q, q_base + i) : 0.0f;
    accs[i] = 0.0f;
  }
  for (int i = tid; i < kRows; i += kThreads) {
    ms[i] = kNeg;
    ls[i] = 0.0f;
  }
  float* pw = ps + warp * bk;

  for (int kt = 0; kt < lk; kt += bk) {
    __syncthreads();                             // the previous tile is done
    const long long t_base = kv_base + (long long)kt * d;
    for (int i = tid; i < bk * d; i += kThreads) {
      const int j = i / d;
      const int c = i - j * d;
      ks[j * ks_stride + c] = load_f32(k, t_base + i);
      vs[i] = load_f32(v, t_base + i);
    }
    __syncthreads();
    for (int i = warp; i < kRows; i += kWarps) {
      const int row = r0 + i;
      if (row >= lq) break;                      // warp-uniform
      const int qpos = row + (lk - lq);
      const float* qr = qs + i * d;
      // scores of this tile, and the tile max
      float mt = -CUDART_INF_F;
      for (int j = lane; j < bk; j += 32) {
        const float* kr = ks + j * ks_stride;
        float a = 0.0f;
        for (int c = 0; c < d; ++c) a = fmaf(qr[c], kr[c], a);
        float s = __fmul_rn(a, scale);
        if (causal && qpos < kt + j) s = kNeg;
        pw[j] = s;
        mt = fmaxf(mt, s);
      }
      mt = warp_max(mt);
      const float m_old = ms[i];
      const float m_new = fmaxf(m_old, mt);
      float psum = 0.0f;
      for (int j = lane; j < bk; j += 32) {
        const float s = pw[j];
        float p = exp_neg(tab, __fsub_rn(m_new, s), use_lut);
        if (causal ? (qpos < kt + j) : (s <= 0.5f * kNeg)) p = 0.0f;
        pw[j] = p;
        psum = __fadd_rn(psum, p);
      }
      psum = warp_sum(psum);
      const float alpha = exp_neg(tab, __fsub_rn(m_new, m_old), use_lut);
      __syncwarp();                              // the p row is in shared memory
      float* ar = accs + i * d;
      for (int c = lane; c < d; c += 32) {
        float a = 0.0f;
        for (int j = 0; j < bk; ++j) a = fmaf(pw[j], vs[j * d + c], a);
        ar[c] = __fadd_rn(__fmul_rn(alpha, ar[c]), a);
      }
      __syncwarp();                              // pw is rewritten by the next row
      if (lane == 0) {
        ls[i] = __fadd_rn(__fmul_rn(alpha, ls[i]), psum);
        ms[i] = m_new;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    if (r0 + r < lq)
      store_f32(out, q_base + i, __fdiv_rn(accs[i], fmaxf(ls[r], 1e-30f)));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* tab,
           void* out, int b, int hq, int hkv, int lq, int lk, int d, int bk,
           int causal, int use_lut, float scale, cudaStream_t stream) {
  const long long bytes = smem_floats(d, bk) * (long long)sizeof(float);
  const int q_tiles = (lq + kRows - 1) / kRows;
  const long long blocks = (long long)b * hq * q_tiles;
  if (bytes > kMaxSmem || blocks > 0x7fffffffLL || hkv <= 0 || hq % hkv
      || bk <= 0 || lk % bk)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  attn_kernel<T><<<(unsigned)blocks, kThreads, (size_t)bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, tab, (T*)out, hq, hkv, lq, lk, d,
      bk, q_tiles, causal, use_lut, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lut_attention_launch(const void* q, const void* k, const void* v,
                                    const float* tab, void* out, int b, int hq,
                                    int hkv, int lq, int lk, int d, int bk,
                                    int causal, int use_lut, int is_bf16,
                                    float scale, cudaStream_t stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, tab, out, b, hq, hkv, lq, lk, d, bk,
                                 causal, use_lut, scale, stream);
  return launch<float>(q, k, v, tab, out, b, hq, hkv, lq, lk, d, bk, causal,
                       use_lut, scale, stream);
}
