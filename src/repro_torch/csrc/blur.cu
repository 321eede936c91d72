// 3x3 median / gaussian blur over a run of halo'd row blocks, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `blur_rows_pallas` in
// src/repro/kernels/blur/kernel.py (bodies `_median_kernel` and
// `_gaussian_kernel`): the row-block stencil that every chunk of the
// paper's blur task set runs.
//
// Interface (plain C, loaded with ctypes; see kernels/blur/kernel.py):
//   blur_rows(src, src_stride, dst, dst_stride, rows, width, kind,
//             rows_per_thread, vec, stream)
//   reads  src[0 .. rows+1][0 .. width+1]   (the rows with their 1-pixel halo)
//   writes dst[0 .. rows-1][0 .. width-1]   (the blurred interior)
// Strides are in floats.  The task layer points `src` at padded row r*32 and
// `dst` at padded element (r*32+1, 1) of the other ping/pong image, with
// `rows` = 32 x (the row blocks of one run), so the run lands in place in the
// destination; the functional form points `dst` at a fresh [rows, width]
// tensor.  `rows_per_thread` is 1, 2, 4 or 8 (the wrapper's plan); `vec` = 1
// when `src` and its row stride allow 8-byte loads.  The launch goes on the
// caller's stream and the function returns cudaGetLastError().
//
// Bound: memory.  A run of R rows of width W moves ((R+2)*(W+2) + R*W)*4
// bytes: 8.42 MB for the 256 rows of a budget-8 chunk at W = 4096, 2.51 us at
// 3.35 TB/s.  A single 32-row block (1.08 MB, 0.32 us) is bound by the launch
// itself, so the task layer launches one run of consecutive row blocks.
//
// Design:
// - A thread owns 2 adjacent output columns over `rows_per_thread` rows.  It
//   loads the 4 columns of every input row of its strip as two float2 (8
//   bytes; the images' row stride of 4098 floats rules out 16-byte loads and
//   TMA), all rows issued before any is used.  R + 2 input rows serve R
//   output rows, and a pixel is requested by 2 threads, the second time from
//   L1, not 9 times.  Taking the neighbour's columns by `__shfl_down_sync`
//   instead (lane 31 loading its own) measured slower on the H100.
// - 128 threads a block cover 256 columns.  The plan gives a thread the most
//   rows that still leave 512 blocks (about 4 a SM): 8 rows for a 256-row
//   run, 1 for a single block; on the H100 those won (chip_smoke.py phase 5
//   times every choice).
// - Stores are 4-byte (the in-place destination starts at column 1, an odd
//   float offset); a warp's two stores fill whole sectors between them.
//   Rearranging them by shuffles into one contiguous store each did not
//   pay.
//
// Numerics:
// - median: each vertical triple is sorted once (3 min/max exchanges) and
//   shared by the two outputs of the thread; the median of the 3x3 window is
//   med3(max of the 3 minima, med3 of the 3 middles, min of the 3 maxima), an
//   exact selection of the 5th smallest of the 9 values, so it is bitwise the
//   value the reference's odd-even network (`median9`) returns on finite
//   images without negative zeros (which one of +0 and -0 a min/max keeps
//   is not fixed).  fminf/fmaxf return the other operand when one is NaN,
//   where jnp.minimum propagates NaN; inputs are finite images, so this
//   never shows.
// - gaussian sums s0..s8 in the reference's order with each weight divided
//   by 16 first, every pixel on its own (no partial sums shared between rows,
//   which would round differently).  The weights are powers of two, so every
//   product is exact; the explicit _rn intrinsics keep the compiler from
//   contracting into FMAs.  Expected bitwise; stated tolerance 1e-6.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void sort3(float a, float b, float c, float& lo, float& mid,
                                      float& hi) {
  const float l1 = fminf(a, b), h1 = fmaxf(a, b);
  lo = fminf(l1, c);
  const float m1 = fmaxf(l1, c);
  mid = fminf(h1, m1);
  hi = fmaxf(h1, m1);
}

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

// col[0..2][k]: 3 input rows of the 4 columns k a thread sees; output 0 is
// the window of columns 0..2, output 1 of columns 1..3.  Each vertical
// triple is sorted once and shared by the outputs that see it.
__device__ __forceinline__ void median2(const float (&col)[3][4], float& o0, float& o1) {
  float lo[4], mid[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) sort3(col[0][k], col[1][k], col[2][k], lo[k], mid[k], hi[k]);
  o0 = med3(fmaxf(fmaxf(lo[0], lo[1]), lo[2]), med3(mid[0], mid[1], mid[2]),
            fminf(fminf(hi[0], hi[1]), hi[2]));
  o1 = med3(fmaxf(fmaxf(lo[1], lo[2]), lo[3]), med3(mid[1], mid[2], mid[3]),
            fminf(fminf(hi[1], hi[2]), hi[3]));
}

__device__ __forceinline__ float gaussian9(const float (&col)[3][4], int j) {
  const float w[9] = {1.f / 16, 2.f / 16, 1.f / 16, 2.f / 16, 4.f / 16,
                      2.f / 16, 1.f / 16, 2.f / 16, 1.f / 16};
  float acc = __fmul_rn(col[0][j], w[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) acc = __fadd_rn(acc, __fmul_rn(col[i / 3][j + i % 3], w[i]));
  return acc;
}

// Columns c, c + 1 of one source row, zero past the row's end.
template <bool kVec>
__device__ __forceinline__ float2 load2(const float* __restrict__ row, int c, int n) {
  if (kVec && c + 1 < n) return __ldg(reinterpret_cast<const float2*>(row + c));
  float2 v = make_float2(0.f, 0.f);
  if (c < n) v.x = __ldg(row + c);
  if (c + 1 < n) v.y = __ldg(row + c + 1);
  return v;
}

template <int R, bool kVec, bool kMedian>
__global__ void __launch_bounds__(kThreads)
blur_rows_kernel(const float* __restrict__ src, long long src_stride, float* __restrict__ dst,
                 long long dst_stride, int rows, int width) {
  const int j0 = 2 * (blockIdx.x * kThreads + threadIdx.x);  // first output column
  const int r0 = blockIdx.y * R;                             // first output row
  const int src_width = width + 2;

  // the 4 columns of every input row of the strip, loaded before any is used
  float c[R + 2][4];
#pragma unroll
  for (int i = 0; i < R + 2; ++i) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (r0 + i < rows + 2) {
      const float* s = src + (long long)(r0 + i) * src_stride;
      lo = load2<kVec>(s, j0, src_width);
      hi = load2<kVec>(s, j0 + 2, src_width);
    }
    c[i][0] = lo.x;
    c[i][1] = lo.y;
    c[i][2] = hi.x;
    c[i][3] = hi.y;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    float win[3][4];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int k = 0; k < 4; ++k) win[di][k] = c[i + di][k];
    }
    float o0, o1;
    if (kMedian) {
      median2(win, o0, o1);
    } else {
      o0 = gaussian9(win, 0);
      o1 = gaussian9(win, 1);
    }
    if (r0 + i < rows) {
      float* d = dst + (long long)(r0 + i) * dst_stride;
      if (j0 < width) d[j0] = o0;
      if (j0 + 1 < width) d[j0 + 1] = o1;
    }
  }
}

template <int R, bool kVec>
void launch(const float* src, long long src_stride, float* dst, long long dst_stride, int rows,
            int width, int kind, cudaStream_t s) {
  const int pairs = (width + 1) / 2;
  const dim3 grid((pairs + kThreads - 1) / kThreads, (rows + R - 1) / R);
  if (kind == 0) {
    blur_rows_kernel<R, kVec, true><<<grid, kThreads, 0, s>>>(src, src_stride, dst, dst_stride,
                                                              rows, width);
  } else {
    blur_rows_kernel<R, kVec, false><<<grid, kThreads, 0, s>>>(src, src_stride, dst, dst_stride,
                                                               rows, width);
  }
}

template <int R>
void launch_rows(const float* src, long long src_stride, float* dst, long long dst_stride,
                 int rows, int width, int kind, int vec, cudaStream_t s) {
  if (vec) {
    launch<R, true>(src, src_stride, dst, dst_stride, rows, width, kind, s);
  } else {
    launch<R, false>(src, src_stride, dst, dst_stride, rows, width, kind, s);
  }
}

}  // namespace

extern "C" int blur_rows(const float* src, long long src_stride, float* dst,
                         long long dst_stride, int rows, int width, int kind,
                         int rows_per_thread, int vec, void* stream) {
  if (rows <= 0 || width <= 0 || (kind != 0 && kind != 1)) return (int)cudaErrorInvalidValue;
  if (rows_per_thread <= 0 || (rows + rows_per_thread - 1) / rows_per_thread > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread) {
    case 1: launch_rows<1>(src, src_stride, dst, dst_stride, rows, width, kind, vec, s); break;
    case 2: launch_rows<2>(src, src_stride, dst, dst_stride, rows, width, kind, vec, s); break;
    case 4: launch_rows<4>(src, src_stride, dst, dst_stride, rows, width, kind, vec, s); break;
    case 8: launch_rows<8>(src, src_stride, dst, dst_stride, rows, width, kind, vec, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
