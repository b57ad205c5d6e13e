// INT8 x INT8 -> INT32 matmul with the power-of-2 requant epilogue, for sm_90a.
//
// Replaces the TPU kernel `int8_matmul_raw` of the reference
// (src/repro/kernels/int8_matmul.py, body `_int8_matmul_kernel`) together
// with the wrapper arithmetic of src/repro/kernels/ops.py::int8_matmul, and
// folds in the whole contract of core/quant.py::int_exec_einsum.
//
// What it computes: acc[m, n] = sum_k x[m, k] * w[k, n] in int32, then
//   acc >>= shift (or <<= -shift);  optional clip to the INT16 range
//   (the paper's residual type, applied BEFORE the requant);
//   out_mode 0: float32(acc) * scale * 2^-axis[n]   (scale = 2^-out_exp,
//               axis = the weight's int8 per-column exponents or absent;
//               powers of two, so the float32 result is exact)
//   out_mode 1 / 2: the raw int32 / int16 accumulator of `int8_matmul_raw`.
// Its inputs, as they are stored:
//   x: int8 [M, K], or float32 [M, K] quantised as it is loaded by eq 9,
//      q = clamp(floor(x * 2^x_exp + 0.5), lo, hi) for x_bits-wide [lo, hi],
//      with the same two float32 roundings as core/quant.py::quantize_act;
//   w: int8 [K, N], or the nibble-packed int4 payload of a QTensor (flat
//      row-major [K, N], low nibble = even index, (v ^ 8) - 8), unpacked as
//      it is staged.
//
// What bounds it here: bytes.  The main path has K <= 256 and N <= 256, so
// an output of 4 bytes costs K multiply-adds, far below the tensor cores'
// rate; at KWT-1 B = 4096 the float32 output is 90 % of the bytes.  The
// design, for that:
// - mma.sync m16n8k32 s8.s8.s32 (exact in any order); K is zero-padded to
//   32 in shared memory only.
// - A block owns tiles of 32 rows by all of N (wider N is cut into column
//   blocks, and so is N at small batches, where there are too few row tiles
//   to fill the card), so x is read once, and walks several row tiles.  The whole
//   weight (at most 64 KB of int8 on the main path) is staged once per
//   block, N-major with K contiguous, the layout the B fragment wants, a
//   nibble-packed payload unpacked on the way; rows of K + 16 bytes keep
//   every fragment load free of bank conflicts.
// - x tiles come through a ring of two stages by cp.async, the next tile in
//   flight while this one is multiplied: int8 rows as they are (16 bytes a
//   copy where K allows), float32 rows as they are, quantised in shared
//   memory once they have landed.
// - The epilogue (shift, clip, convert, scale) runs in registers; each warp
//   stages its own 16-row piece of the tile through shared memory and
//   stores it with 16-byte vectors, whole 128-byte lines at N = 256, with
//   no block barrier between the products and the stores.  Tiles of 32
//   rows keep the staging small enough for three blocks an SM.
// Ragged M, K and N are masked in the kernel; nothing is padded in device
// memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int BM = 32;                    // rows a tile
constexpr int kThreads = 256;             // 8 warps:
constexpr int WM = BM / 16;               //   WM row strips of 16 rows
constexpr int WN = 8 / WM;                //   x WN column groups
constexpr int kMaxNb = 256;               // columns a block
constexpr int kMaxSmem = 232448;
constexpr int kStages = 2;               // the ring of x tiles

struct Args {
  const void* x;
  const void* w;
  void* out;
  const int8_t* axis;
  int m, k, n;
  int shift, clip16, out_mode;
  float scale;
  int x_f32, x_bits, w_int4;
  float x_scale;
  int kpad, rb, kf;       // K padded to 32, bytes an int8 x row, floats a
                          // float32 x row, in shared memory
  int nb, col_blocks;     // columns a block, column blocks
  int tiles, xvec, ovec;  // row tiles of BM; copy widths
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// eq 9 on one activation: clamp(floor(x * 2^e + 0.5), lo, hi), the two
// float32 roundings of quantize_act, then the int8 container
__device__ __forceinline__ int quant(float x, float x_scale, float lo, float hi) {
  const float q = floorf(__fadd_rn(__fmul_rn(x, x_scale), 0.5f));
  return __float2int_rz(fminf(fmaxf(q, lo), hi));
}

// 2^-a for an int8 exponent, exactly: a float built from its bits (2^-127
// is the one subnormal; a = -128 gives inf, as exp2 does in float32)
__device__ __forceinline__ float pow2_neg(int a) {
  return a == 127 ? __int_as_float(0x00400000)
                  : __int_as_float((127 - a) << 23);
}

// Stage the x rows [row0, row0 + rows): int8 x into `xq` (rows of a.rb
// bytes) by cp.async, 16, 8 or 4 bytes a copy, or byte by byte where K is
// ragged; float32 x into `xf` (rows of a.kf floats) by cp.async, 16 or 4
// bytes a copy, for quantise_x to quantise once it has landed.
__device__ __forceinline__ void stage_x(const Args& a, int8_t* xq, float* xf,
                                        long long row0, int rows) {
  const int K = a.k;
  if (a.x_f32) {
    const float* x = static_cast<const float*>(a.x) + row0 * K;
    const int per = a.xvec ? 4 : 1;
    const int cpr = K / per;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * per;
      cp_async(xf + r * a.kf + c, x + (long long)r * K + c, 4 * per);
    }
    return;
  }
  const int8_t* x = static_cast<const int8_t*>(a.x) + row0 * K;
  if (a.xvec) {
    const int cpr = K / a.xvec;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * a.xvec;
      cp_async(xq + r * a.rb + c, x + (long long)r * K + c, a.xvec);
    }
  } else {
    for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
      const int r = i / K, c = i - r * K;
      xq[r * a.rb + c] = x[(long long)r * K + c];
    }
  }
}

// eq 9 on the landed float32 rows: xf -> the int8 tile xq
__device__ __forceinline__ void quantise_x(const Args& a, const float* xf,
                                           int8_t* xq, int rows) {
  const int K = a.k;
  const float lo = -(float)(1 << (a.x_bits - 1));
  const float hi = (float)((1 << (a.x_bits - 1)) - 1);
  if ((K & 3) == 0) {       // 4 floats a load, one 32-bit store
    const int cpr = K >> 2;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) << 2;
      const float4 f = *reinterpret_cast<const float4*>(xf + r * a.kf + c);
      const unsigned word = (unsigned)(quant(f.x, a.x_scale, lo, hi) & 0xff)
          | ((unsigned)(quant(f.y, a.x_scale, lo, hi) & 0xff) << 8)
          | ((unsigned)(quant(f.z, a.x_scale, lo, hi) & 0xff) << 16)
          | ((unsigned)(quant(f.w, a.x_scale, lo, hi) & 0xff) << 24);
      *reinterpret_cast<unsigned*>(xq + r * a.rb + c) = word;
    }
  } else {
    for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
      const int r = i / K, c = i - r * K;
      xq[r * a.rb + c] = (int8_t)quant(xf[r * a.kf + c], a.x_scale, lo, hi);
    }
  }
}

// Stage the weight columns [n0, n0 + cols) into `ws`, N-major: ws[n * rb + k].
// A thread gathers 16 k of one column (consecutive threads, consecutive
// columns: each byte load of a warp is one coalesced run) and stores them as
// one 16-byte vector; rows of 16 * odd bytes keep those stores free of bank
// conflicts.  An int4 payload is unpacked as it lands.
__device__ __forceinline__ void stage_w(const Args& a, int8_t* ws, int n0,
                                        int cols) {
  const int K = a.k, N = a.n;
  const uint8_t* w = static_cast<const uint8_t*>(a.w);
  const int chunks = (K + 15) >> 4;
  for (int i = threadIdx.x; i < cols * chunks; i += blockDim.x) {
    const int kc = i / cols, nn = i - kc * cols;
    unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int kk = kc * 16 + e;
      if (kk < K) {
        const long long f = (long long)kk * N + n0 + nn;
        int v;
        if (a.w_int4) {
          v = ((((int)w[f >> 1] >> ((int)(f & 1) * 4)) & 0xf) ^ 8) - 8;
        } else {
          v = (int)(int8_t)w[f];
        }
        word[e >> 2] |= ((unsigned)v & 0xffu) << ((e & 3) * 8);
      }
    }
    *reinterpret_cast<uint4*>(ws + nn * a.rb + kc * 16) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// QF: n fragments of 8 a warp; 8 warps = WM row strips of 16 x WN column
// groups, so a block covers BM rows by NBP = WN * QF * 8 columns
template <int QF>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const Args a) {
  extern __shared__ int4 smem16[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem16);
  constexpr int NBP = WN * QF * 8;         // staged columns, padded
  // each warp stages its own 16 x (8 QF) piece of the out tile, in rows of
  // 8 * odd words (conflict-free pair stores), and stores it itself
  constexpr int wpitch = QF % 2 ? QF * 8 : QF * 8 + 8;
  int* ost = reinterpret_cast<int*>(smem); // [8 warps][16][wpitch]
  float* cs = reinterpret_cast<float*>(ost + 8 * 16 * wpitch);   // [NBP]
  int8_t* ws = reinterpret_cast<int8_t*>(cs + NBP);          // [NBP][rb]
  // int8 x: a ring of int8 tiles; float32 x: a ring of float32 tiles,
  // each quantised into the one int8 tile once it has landed
  constexpr int S = kStages;
  const int xqn = a.x_f32 ? 1 : S;
  int8_t* xq = ws + NBP * a.rb;                              // [xqn][BM][rb]
  float* xf = reinterpret_cast<float*>(xq + xqn * BM * a.rb);  // [S][BM][kf]
  const int xqbytes = BM * a.rb, xffloats = BM * a.kf;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % WM, quarter = warp / WM;
  const int cb = blockIdx.x % a.col_blocks;
  const int n0 = cb * a.nb;
  const int cols = min(a.nb, a.n - n0);

  {   // zero the weight and int8 x stages once: their pads are never written
    const int n16 = (NBP * a.rb + xqn * xqbytes) / 16;
    int4* z = reinterpret_cast<int4*>(ws);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_int4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < NBP; i += blockDim.x)
      cs[i] = (a.axis != nullptr && i < cols) ? pow2_neg(a.axis[n0 + i]) : 1.0f;
  }
  __syncthreads();
  stage_w(a, ws, n0, cols);

  // the row tiles of this block's column block, strided over the blocks
  // that share it
  const int sharing = (int)gridDim.x / a.col_blocks;
  const int first = blockIdx.x / a.col_blocks;
  const int mine = first < a.tiles ? (a.tiles - 1 - first) / sharing + 1 : 0;
  auto tile_row = [&](int i) {
    return (long long)(first + i * sharing) * BM;
  };
  // tile i goes into stage i % S; one commit group per tile, empty past
  // the last, so that when tile i is waited for, S - 2 groups are younger
  auto issue = [&](int i) {
    if (i < mine) {
      const long long row0 = tile_row(i);
      stage_x(a, xq + (a.x_f32 ? 0 : i % S) * xqbytes, xf + (i % S) * xffloats,
              row0, (int)min((long long)BM, a.m - row0));
    }
    cp_commit();
  };
  for (int i = 0; i < S - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    cp_wait<S - 2>();
    // x tile i (and at i = 0 the weight) in place, tile i - 1 done with
    __syncthreads();
    issue(i + S - 1);        // into the stage that tile i - 1 freed
    const long long row0 = tile_row(i);
    const int rows = (int)min((long long)BM, a.m - row0);
    const int8_t* xt = xq + (a.x_f32 ? 0 : i % S) * xqbytes;
    if (a.x_f32) {
      quantise_x(a, xf + (i % S) * xffloats, xq, rows);
      __syncthreads();
    }

    int acc[QF][4];
#pragma unroll
    for (int f = 0; f < QF; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[f][c] = 0;
    const int8_t* arow = xt + (strip * 16 + g) * a.rb + 4 * t;
    const int8_t* brow = ws + (quarter * QF * 8 + g) * a.rb + 4 * t;
    for (int k0 = 0; k0 < a.kpad; k0 += 32) {
      unsigned af[4];
      af[0] = *reinterpret_cast<const unsigned*>(arow + k0);
      af[1] = *reinterpret_cast<const unsigned*>(arow + 8 * a.rb + k0);
      af[2] = *reinterpret_cast<const unsigned*>(arow + k0 + 16);
      af[3] = *reinterpret_cast<const unsigned*>(arow + 8 * a.rb + k0 + 16);
#pragma unroll
      for (int f = 0; f < QF; ++f) {
        const int8_t* bp = brow + f * 8 * a.rb + k0;
        mma_s8(acc[f], af, *reinterpret_cast<const unsigned*>(bp),
               *reinterpret_cast<const unsigned*>(bp + 16));
      }
    }

    // epilogue in registers, staged as 32-bit words (float bits or int32)
    int* ow = ost + warp * 16 * wpitch;
#pragma unroll
    for (int f = 0; f < QF; ++f) {
      const int col = (quarter * QF + f) * 8 + 2 * t;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int v = acc[f][c];
        if (a.shift > 0) v >>= a.shift;
        else if (a.shift < 0) v = (int)((unsigned)v << (-a.shift));
        if (a.clip16) v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
        if (a.out_mode == 0) {
          float fv = __fmul_rn(__int2float_rn(v), a.scale);
          if (a.axis != nullptr) fv = __fmul_rn(fv, cs[col + (c & 1)]);
          v = __float_as_int(fv);
        }
        acc[f][c] = v;
      }
      const int lc = f * 8 + 2 * t;                 // the warp's column
      *reinterpret_cast<int2*>(ow + g * wpitch + lc) = make_int2(acc[f][0], acc[f][1]);
      *reinterpret_cast<int2*>(ow + (g + 8) * wpitch + lc) =
          make_int2(acc[f][2], acc[f][3]);
    }
    __syncwarp();

    // the warp's piece out: its rows, its columns; no block barrier
    const int wr0 = strip * 16, wc0 = quarter * QF * 8;
    const int wrows = min(16, rows - wr0);
    const int wcols = min(QF * 8, cols - wc0);
    if (wrows > 0 && wcols > 0) {
      const long long obase = (row0 + wr0) * a.n + n0 + wc0;
      if (a.out_mode == 2) {
        short* o = static_cast<short*>(a.out) + obase;
        for (int e = lane; e < wrows * wcols; e += 32) {
          const int r = e / wcols, c = e - r * wcols;
          o[(long long)r * a.n + c] = (short)ow[r * wpitch + c];
        }
      } else if (a.ovec) {         // 16 bytes a store, whole rows of it
        int* o = static_cast<int*>(a.out) + obase;
        const int cpr = wcols >> 2;
        for (int e = lane; e < wrows * cpr; e += 32) {
          const int r = e / cpr, c = (e - r * cpr) << 2;
          *reinterpret_cast<int4*>(o + (long long)r * a.n + c) =
              *reinterpret_cast<const int4*>(ow + r * wpitch + c);
        }
      } else {
        int* o = static_cast<int*>(a.out) + obase;
        for (int e = lane; e < wrows * wcols; e += 32) {
          const int r = e / wcols, c = e - r * wcols;
          o[(long long)r * a.n + c] = ow[r * wpitch + c];
        }
      }
    }
    __syncwarp();          // the piece is read before the next tile writes it
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

template <int QF>
int blocks_per_sm(long long bytes) {
  static bool opted = false;
  static long long last_bytes = -1;
  static int last_result = 0;
  if (!opted) {
    if (cudaFuncSetAttribute(int8_matmul_kernel<QF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem) != cudaSuccess)
      return 0;
    opted = true;
  }
  if (bytes != last_bytes) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, int8_matmul_kernel<QF>, kThreads, (size_t)bytes) != cudaSuccess)
      return 0;
    last_bytes = bytes;
    last_result = n;
  }
  return last_result;
}

int pow2_qf(int nb) {       // the n fragments a warp is built for
  const int qf = (nb / 8 + WN - 1) / WN;
  return qf <= 1 ? 1 : qf <= 2 ? 2 : qf <= 4 ? 4 : qf <= 8 ? 8 : 16;
}

long long smem_bytes(int nb, int rb, int kf, int x_f32) {
  const int qf = pow2_qf(nb), nbp = WN * 8 * qf;
  const int wpitch = qf % 2 ? qf * 8 : qf * 8 + 8;
  return 8LL * 16 * wpitch * 4 + nbp * 4 + (long long)nbp * rb
         + (long long)(x_f32 ? 1 : kStages) * BM * rb
         + (x_f32 ? (long long)kStages * BM * kf * 4 : 0);
}

template <int QF>
int launch(Args& a, cudaStream_t stream) {
  const long long bytes = smem_bytes(a.nb, a.rb, a.kf, a.x_f32);
  const int bps = bytes <= kMaxSmem ? blocks_per_sm<QF>(bytes) : 0;
  if (bps <= 0) return (int)cudaErrorInvalidValue;
  // every column block gets the same number of blocks, which walk its
  // row tiles; as many blocks as fit the card, or as there are tiles
  const long long cap = (long long)bps * sm_count() / a.col_blocks;
  const long long per_cb = a.tiles < cap ? a.tiles : (cap > 0 ? cap : 1);
  const long long grid = per_cb * a.col_blocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int8_matmul_kernel<QF><<<(unsigned)grid, kThreads, (size_t)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_qf(Args& a, cudaStream_t stream) {
  switch (pow2_qf(a.nb)) {
    case 1: return launch<1>(a, stream);
    case 2: return launch<2>(a, stream);
    case 4: return launch<4>(a, stream);
    case 8: return launch<8>(a, stream);
    default: return launch<16>(a, stream);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x: int8 [m, k], or float32 [m, k] quantised in the kernel by eq 9 with
// its exponent x_exp; w: int8 [k, n], or the nibble-packed int4 payload of
// a [k, n] grid; axis: int8 [n] or null; the output scaled by 2^-out_exp.
// mode packs the flags (a launch costs the host less with fewer ctypes
// arguments): bit 0 the INT16 clip, bits 1-2 the out_mode, bit 3 a float32
// x, bit 4 an int4 w, bits 8-11 the activation's bits.
// Refused (cudaErrorInvalidValue): a K whose tiles do not fit in shared
// memory (K above about 1600 for int8 x, 600 for float32 x).
extern "C" int int8_matmul_launch(const void* x, const void* w, void* out,
                                  const int8_t* axis, int m, int k, int n,
                                  int shift, int mode, int out_exp, int x_exp,
                                  cudaStream_t stream) {
  const int clip16 = mode & 1, out_mode = (mode >> 1) & 3;
  const int x_f32 = (mode >> 3) & 1, w_int4 = (mode >> 4) & 1;
  const int x_bits = (mode >> 8) & 15;
  if (m <= 0 || n <= 0 || k <= 0) return 0;
  if (x_f32 && (x_bits < 1 || x_bits > 8)) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.w = w; a.out = out; a.axis = axis;
  a.m = m; a.k = k; a.n = n;
  a.shift = shift; a.clip16 = clip16; a.out_mode = out_mode;
  a.scale = ldexpf(1.0f, -out_exp);            // powers of two: exact
  a.x_f32 = x_f32; a.x_scale = ldexpf(1.0f, x_exp); a.x_bits = x_bits;
  a.w_int4 = w_int4;
  a.kpad = (k + 31) / 32 * 32;
  a.rb = a.kpad + 16;               // 16 * odd bytes: conflict-free fragments
  a.kf = (k + 3) / 4 * 4;           // floats a staged float32 x row
  a.tiles = (m + BM - 1) / BM;
  // columns a block: all of N up to 256, halved until the stages fit
  int nb = n < kMaxNb ? (n + 7) / 8 * 8 : kMaxNb;
  while (nb > 8 && smem_bytes(nb, a.rb, a.kf, x_f32) > kMaxSmem)
    nb = (nb / 2 + 7) / 8 * 8;
  // few row tiles (small batches): fewer columns a block, so more blocks
  // share the work and each stages less of the weight, while a block's
  // weight bytes still outweigh its x tile's (each column block reads x)
  while (nb > BM * (x_f32 ? 4 : 1)
         && (long long)a.tiles * ((n + nb - 1) / nb) < 2LL * sm_count())
    nb = (nb / 2 + 7) / 8 * 8;
  a.nb = nb;
  a.col_blocks = (n + nb - 1) / nb;
  // the widest copy every x row allows
  a.xvec = 0;
  if (x_f32) {
    a.xvec = k % 4 == 0 && aligned(x, 16);
  } else {
    for (int v : {16, 8, 4})
      if (!a.xvec && k % v == 0 && aligned(x, v)) a.xvec = v;
  }
  a.ovec = out_mode != 2 && n % 4 == 0 && aligned(out, 16);
  return launch_qf(a, stream);
}
