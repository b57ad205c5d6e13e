// The flash-LUT attention for 128 < D <= 256, for sm_90a.  With
// lut_attention.cu it replaces the TPU kernel `lut_attention` of the
// reference (src/repro/kernels/lut_attention.py), which tiles any D; that
// file's header comment says what both kernels compute.  Here the layout
// of lut_attention.cu would pass 255 registers a thread and, at key tiles
// of 128, the 227 KB of shared memory a block may use.  Reached through
// lut_attention_launch, which checks the arguments.
//
// What bounds it.  At nemotron-4-340b's causal GQA (2, 96(8), 1024, 1024,
// 192) the two products are 2 x 38.7 GFLOP over 327 MB of float32 q, k,
// v and out: the operations bind (1.15 ms at the CUDA cores' 67 TFLOP/s,
// 0.10 ms for the bytes at 3.35 TB/s).  The 3xTF32 mma.sync products and
// the LUT softmax run as in lut_attention.cu, and each score tile is
// computed by two warps (below), so the QK^T products are done twice.

#include <cuda_runtime.h>

#include "launch_geometry.cuh"
#include "lut_attention_tile.cuh"

namespace {

using namespace lut_attention;

// shared memory of one block, in floats: the table, Q [wpb / 2 * 16][srow]
// and one buffer of [nt * 8][srow] that holds a tile's K and then its V
__host__ __device__ inline long long wide_smem_floats(int wpb, int nt,
                                                      int srow) {
  return kEntries + (long long)(wpb / 2) * 16 * srow + (long long)nt * 8 * srow;
}

// 128 < D <= 256 (DT = 24 or 32).  The D <= 128 layout would hold DT
// output fragments a warp beside the score tile, past 255 registers, and
// two stages of K and V at 128 keys pass the 227 KB a block may use.  So:
// - two warps share each group of 16 query rows (warps 2i and 2i + 1):
//   both compute the group's scores over the whole depth, the same
//   instructions on the same data, so their m, l and p are the same bits,
//   and each keeps the output of one half of the depth, DT / 2 fragments:
//   the registers of the D <= 128 layout, for a third more products;
// - one buffer of shared memory holds the tile's K and then its V: K is
//   staged, the scores taken, V is copied in over K while the softmax step
//   runs on the scores in registers, then P V.  The rescale stays at the
//   reference's tile edges; only the staging is split.
// At D = 256 and 4 row groups (8 warps) the block takes 196 KB.
template <int DT, int NT>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
attn_wide_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int srow = DT * 8 + 4;     // 4 * odd floats: no bank conflicts
  constexpr int DO = DT / 2;           // output fragments a warp keeps
  const int gpb = a.wpb >> 1;          // row groups a block
  float* tab = smem;
  float* qbuf = tab + kEntries;
  float* kvbuf = qbuf + gpb * 16 * srow;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = (warp & 1) * DO * 8;  // the warp's first output column
  const int tiles = a.lk / a.bk;
  const int group = a.hq / a.hkv;
  const int mine = blockIdx.x < a.items
      ? (a.items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nsteps = mine * tiles;
  const int es = a.is_bf16 ? 2 : 4;
  const char* q = static_cast<const char*>(a.q);
  const char* k = static_cast<const char*>(a.k);
  const char* v = static_cast<const char*>(a.v);

  {   // zero the pads once, as attn_kernel does: the rows past the tile
      // are K's and V's alike, and no copy writes them
    if (a.d < DT * 8) {
      const long long n4 = (wide_smem_floats(a.wpb, NT, srow) - kEntries) / 4;
      float4* z = reinterpret_cast<float4*>(qbuf);
      for (long long i = threadIdx.x; i < n4; i += blockDim.x)
        z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const int n = (NT * 8 - a.bk) * srow;
      float* vz = kvbuf + a.bk * srow;
      for (int i = threadIdx.x; i < n; i += blockDim.x) vz[i] = 0.0f;
    }
    for (int i = threadIdx.x; i < kEntries; i += blockDim.x) tab[i] = a.tab[i];
  }
  __syncthreads();

  float o[DO][4];
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;
  for (int s = 0; s < nsteps; ++s) {
    const int li = s / tiles, tile = s - li * tiles;
    const int item = blockIdx.x + li * gridDim.x;
    const int pair = item / a.splits, sp = item - pair * a.splits;
    const int b = pair / a.hq, h = pair - b * a.hq, hk = h / group;
    const long long key0 = (long long)tile * a.bk;
    const int rw = (sp * gpb + (warp >> 1)) * 16;   // the group's first row
    const bool live = rw < a.lq;
    if (tile == 0) {
      const int r0 = sp * gpb * 16;
      stage_rows(qbuf,
                 q + es * (b * a.sq[0] + h * a.sq[1] + (long long)r0 * a.sq[2]),
                 a.sq[2], min(gpb * 16, a.lq - r0), a.d, srow, a.vec_in,
                 a.is_bf16);
    }
    stage_rows(kvbuf, k + es * (b * a.sk[0] + hk * a.sk[1] + key0 * a.sk[2]),
               a.sk[2], a.bk, a.d, srow, a.vec_in, a.is_bf16);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    float sc[NT][4];
    if (live) {
      if (tile == 0) {
        m0 = m1 = kNeg;
        l0 = l1 = 0.0f;
#pragma unroll
        for (int dt = 0; dt < DO; ++dt)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[dt][c] = 0.0f;
      }
      qk_tile<DT, NT>(sc, qbuf + (warp >> 1) * 16 * srow, kvbuf, g, t);
    }
    __syncthreads();               // K is read: V takes its place
    stage_rows(kvbuf, v + es * (b * a.sv[0] + hk * a.sv[1] + key0 * a.sv[2]),
               a.sv[2], a.bk, a.d, srow, a.vec_in, a.is_bf16);
    cp_commit();
    float al0 = 1.0f, al1 = 1.0f;
    if (live)
      softmax_tile<NT>(sc, tab, a, tile, rw, g, t, m0, m1, l0, l1, al0, al1);
    cp_wait<0>();
    __syncthreads();
    if (live) {
      pv_tile<DO, NT, srow>(o, sc, al0, al1, kvbuf + c0, g, t);
      if (tile == tiles - 1)       // the epilogue of the item
        store_tile<DO>(o, a, pair, rw + g, c0, t, l0, l1);
    }
    __syncthreads();               // V and Q are read: the next step refills
  }
}

template <int DT, int NT>
int blocks_per_sm(int threads, long long bytes) {
  static Occupancy occupancy;
  return occupancy(attn_wide_kernel<DT, NT>, threads, bytes);
}

// one stage, two warps a group of 16 query rows, up to 4 groups a block;
// fewer where an SM holds no block
template <int DT, int NT>
int launch_dt(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo) {
  constexpr int srow = DT * 8 + 4;
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
    const long long bytes = wide_smem_floats(2 * gpb, NT, srow) * 4;
    const int bps =
        bytes <= kMaxSmem ? blocks_per_sm<DT, NT>(threads, bytes) : 0;
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
    a.stages = 1;
    if (geo)
      return put_geo({grid, threads, bytes, (DT * 100 + NT) * 10 + 1}, geo);
    attn_wide_kernel<DT, NT>
        <<<(unsigned)grid, threads, (size_t)bytes, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

// the built shapes: D <= 192, 256 and bk <= 32, 128
template <int DT>
int launch_nt(Args& a, long long pairs, cudaStream_t stream, LaunchGeo* geo) {
  if (a.bk <= 32) return launch_dt<DT, 4>(a, pairs, stream, geo);
  return launch_dt<DT, 16>(a, pairs, stream, geo);
}

template <int DT>
int occupancy_nt(int nt, int threads, long long bytes) {
  switch (nt) {
    case 4: return blocks_per_sm<DT, 4>(threads, bytes);
    case 16: return blocks_per_sm<DT, 16>(threads, bytes);
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
