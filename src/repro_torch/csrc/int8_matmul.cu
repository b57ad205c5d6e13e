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
//   out_mode 0: float32(acc) * scale * col_scale[n]   (scale = 2^-(x_exp+w_exp),
//               col_scale = 2^-axis_exponents or absent; powers of two, so
//               the float32 result is exact)
//   out_mode 1 / 2: the raw int32 / int16 accumulator of `int8_matmul_raw`.
//
// What bounds it here: bytes, and at small batch the launch.  The main path
// has K <= 256 and N <= 256, so each output needs few operations per byte
// moved (the float32 output alone is 4 bytes per K multiply-adds) and the
// tensor cores would idle; the kernel therefore uses `__dp4a` (four int8
// products per instruction) on a shared-memory tile and leaves `mma`/`wgmma`
// to a later change.  Design: a 64 x 64 output tile per block of 256
// threads, each thread a 4 x 4 micro-tile; the K loop runs INSIDE the block
// in steps of 32 (the TPU kernel's sequential K grid axis with its
// accumulator scratch has no counterpart: blocks run in no order here).
// Both operands are packed four-along-K into int32 words in shared memory,
// the weight tile being transposed on the way in, so one `__dp4a` consumes
// one word of each.  Ragged M, K and N are masked in the loads (zero fill is
// exact for an integer sum) and in the stores; nothing is padded to a tile
// multiple in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;  // BK counts int8 elements
constexpr int KW = BK / 4;                // packed words along K
constexpr int kThreads = 256;             // 16 x 16, 4 x 4 outputs each

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xFF) | ((b1 & 0xFF) << 8) | ((b2 & 0xFF) << 16) |
         ((b3 & 0xFF) << 24);
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   void* __restrict__ out, const float* __restrict__ col_scale,
                   int M, int K, int N, int shift, int clip16, int out_mode,
                   float scale) {
  __shared__ int xs[BM][KW + 1];  // +1: rows fall on different banks
  __shared__ int ws[BN][KW + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // x rows start on a 4-byte boundary when K % 4 == 0 and the base does:
  // then a word of four int8 along K is one aligned 32-bit load.
  const bool x_words = (K % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 3) == 0);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  // loader roles: x tile = 64 rows x 4 chunks of 8 bytes;
  //               w tile = 64 columns x 4 groups of 8 k
  const int xr = tid >> 2, xc = tid & 3;
  const int wn = tid & 63, wg = tid >> 6;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const long long row = m0 + xr;
      const int kb = k0 + xc * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kb + h * 4;
        int word = 0;
        if (row < M && k < K) {
          const int8_t* p = x + row * K + k;
          if (x_words) {
            word = *reinterpret_cast<const int*>(p);
          } else {
            word = pack4(p[0], k + 1 < K ? p[1] : 0, k + 2 < K ? p[2] : 0,
                         k + 3 < K ? p[3] : 0);
          }
        }
        xs[xr][xc * 2 + h] = word;
      }
    }
    {
      const int n = n0 + wn;
      const int kb = k0 + wg * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb + h * 4 + j;
          b[j] = (n < N && k < K) ? (int)w[(long long)k * N + n] : 0;
        }
        ws[wn][wg * 2 + h] = pack4(b[0], b[1], b[2], b[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      int v = acc[i][j];
      if (shift > 0) {
        v >>= shift;
      } else if (shift < 0) {
        v = (int)((unsigned)v << (-shift));
      }
      if (clip16) v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
      const long long o = row * N + n;
      if (out_mode == 0) {
        float f = __fmul_rn(__int2float_rn(v), scale);
        if (col_scale != nullptr) f = __fmul_rn(f, col_scale[n]);
        reinterpret_cast<float*>(out)[o] = f;
      } else if (out_mode == 1) {
        reinterpret_cast<int*>(out)[o] = v;
      } else {
        reinterpret_cast<short*>(out)[o] = (short)v;
      }
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const int8_t* x, const int8_t* w, void* out,
                                  const float* col_scale, int m, int k, int n,
                                  int shift, int clip16, int out_mode,
                                  float scale, cudaStream_t stream) {
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
  int8_matmul_kernel<<<grid, kThreads, 0, stream>>>(
      x, w, out, col_scale, m, k, n, shift, clip16, out_mode, scale);
  return (int)cudaGetLastError();
}
