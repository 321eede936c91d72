// RWKV-6 time-mix recurrence, for Hopper (sm_90a).  Per (batch row, head):
//     o_t = r_t . (S + (u * k_t) v_t^T)
//     S   = diag(w_t) S + k_t v_t^T,      w_t = exp(logw_t)
//
// Replaces the Pallas TPU kernel `_rwkv_kernel` in
// src/repro/kernels/rwkv6/kernel.py (launched by `rwkv6_pallas`).  It computes
// what that kernel computes; the reference wrapper's transposes to [B,H,T,hd]
// are TPU layout and are not carried over: the inputs are read in place by
// their strides.
//
// Interface (plain C, loaded with ctypes; see kernels/rwkv6/kernel.py):
//   rwkv6_fwd(r, k, v, logw, each with strides (b, t, h), u, u stride (h),
//             s0, s0 strides (b, h, i), o, s_last, B, T, H, hd, stream)
//     r, k, v, logw f32 [B, T, H, hd] with unit stride on hd; u f32 [H, hd]
//     with unit stride on hd; s0 f32 [B, H, hd, hd] with unit stride on the
//     last dim, or null for zeros; o a fresh contiguous f32 [B, T, H, hd],
//     s_last a fresh contiguous f32 [B, H, hd, hd].  hd <= 64.
//
// Bound: memory at the serving shapes.  Prefill [4, 128, 32, 64]: r, k, v,
// logw read once and o written once (21 MB), s_last written (2.1 MB): 6.9 us
// at 3.35 TB/s, against 5 FLOP per state element per step (readout FMA,
// decay-and-add), 5.0 us at 67 TFLOP/s f32.  Decode (T = 1) reads and writes
// the 2.1 MB state: 1.3 us.
//
// Design.  Column j of the state is independent of the others: o_t[j] and the
// update of S[:, j] need only that column and the whole r_t, k_t, w_t, u k_t.
// So the work splits three ways:
//   - columns across blocks: a grid of (hd / JC, H, B) with JC = 16 value
//     columns per block, 512 blocks of two warps at [4, T, 32, 64] (one
//     block of hd threads per (head, row) before: 128 blocks of 64);
//   - rows across lanes and warps: warp w takes rows [w hd/2, (w+1) hd/2),
//     and its lane (g, q) rows g, g + 8, ... of those (R = 8 row groups)
//     for the 4 columns 4q .. 4q + 3: a register tile of 4 x 4 state floats
//     at hd = 64.  Each (r, k, w, u k) row a lane reads from shared memory
//     serves 4 columns and each v 4 rows: 5 16-byte shared loads a step.
//     The lane's readout of column j is sum_i r_i S_ij + v_j sum_i r_i u_i
//     k_i over its rows: 3 FP ops per state element a step (fma, mul, fma)
//     and one per row and per column.  Within a warp the readout is summed
//     over the 8 row groups by a transposing butterfly of __shfl_xor_sync
//     (xor 4, 2, 1: 4 shuffles for the lane's 4 columns); the two warps'
//     sums meet in shared memory and leave once per chunk as coalesced rows
//     of o;
//   - time in chunks staged asynchronously: TC = 16 steps of r, k, logw (all
//     rows) and v (the block's columns) are copied to shared memory with
//     cp.async (16 bytes a copy where the pointers and strides allow, else
//     4), double-buffered, so chunk c + 1 is in flight while chunk c
//     computes and the memory latency is paid once per chunk.  Each thread's
//     copies are fixed at entry, so the staging loop does no division.  Once
//     a chunk has landed, each thread converts one row for all 16 steps at
//     once: w = exp(logw) and u k, into a float4 (r, k, w, u k) per (step,
//     row).  Two barriers per chunk, none per step; 45 KB of shared memory
//     at hd = 64, so 5 blocks fit on an SM.  A whole chunk's 16 steps are
//     unrolled and their butterflies run after the last of them, so the
//     shuffle chain of one step does not hold up the next.
// What the earlier versions of this redesign taught (chip runs, H100; the
// numbers are in PERF.md): with one warp a block (one warp a scheduler)
// nothing hides the latency of serial code, and those versions ran slower
// than the one-block-per-(head, row) kernel they replaced; four warps a
// block, a thread block cluster sharing the converted rows through
// distributed shared memory, r, k, w read as single floats, and a producer
// warp converting the next chunk behind mbarriers while two warps compute
// were each slower than this version.  Launching one of the four column blocks of
// each (head, row) alone took nearly as long as all four: the time is one
// block's critical path through its 8 chunks, not the card's throughput.
// The state comes in and goes out as one 16-byte vector per (lane, row),
// the 4 lanes of a row on its 16 neighbouring columns.  Decode (T = 1) is
// the same kernel with one chunk of one step: 1024 warps, each moving 2 KB
// of state.  Head dims up to 64 use caps of 16, 32 or 64 rows; rows and
// columns past hd are held at 0.
//
// No tensor cores, on purpose: the parity is f32 to 1e-4 against the
// step-by-step recurrence, which TF32 (about 1e-3 relative) cannot hold; the
// chunked matrix form factors the decay as r exp(cum) and k exp(-cum)
// (src/repro/models/rwkv.py), which overflows f32 once a chunk's cumulative
// log-decay passes about -88, and logw = -exp(d) is unbounded below; and at 5
// FLOP per state element per step the f32 bound (5.0 us) lies under the
// bytes bound (6.9 us), within reach of the CUDA cores.
//
// Each lane sums its rows in order, the butterfly adds a warp's row groups
// as ((g0 + g4) + (g2 + g6)) + ((g1 + g5) + (g3 + g7)), and the two warps'
// sums are added last: the readout's order differs from the reference's,
// which the 1e-4 tolerance allows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kJC = 16;                  // value columns per block
constexpr int kCT = 4;                   // columns per lane
constexpr int kR = 8;                    // row groups (lanes per column group)
constexpr int kWarps = 2;                // the rows split over warps
constexpr int kTC = 16;                  // steps per staged chunk
constexpr int kThreads = 32 * kWarps;    // 64
static_assert(kR * kJC / kCT == 32, "a warp is 8 row groups x 4 column groups");

struct Seq {  // one [B, T, H, hd] input read in place
  const float* p;
  long long sb, st, sh;
};

template <int HD>
struct Smem {
  float raw[2][3][kTC][HD];   // r, k, logw of a chunk, double-buffered
  float v[2][kTC][kJC];       // v of the block's columns
  float4 pk[kTC][HD];         // (r, k, w, u k) of the chunk being computed
  float red[kTC][kWarps][kJC];  // each warp's readout of the chunk's steps
};

__device__ __forceinline__ void cp_async(void* dst, const float* src, bool vec) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Which copies a thread issues: `units` per row (float4s, or floats when
// not `vec`); thread tid copies unit tid % units of steps tid / units,
// + every, + 2 every, ...  Fixed per thread, so the staging loop does no
// division.
struct Lane {
  int f, t, every;  // unit (in floats), first step, step stride; every = 0: idle
};

__device__ __forceinline__ Lane lane_of(int units, int w) {
  const int every = kThreads / units;
  const int tid = threadIdx.x;
  if (tid >= every * units) return {0, 0, 0};
  return {(tid % units) * w, tid / units, every};
}

// Issue the copies of steps [t0, t0 + n) into raw/v buffer `buf`.  r, k, lw
// point at (b, t = 0, h, row 0) and v at column j0.
template <int HD>
__device__ __forceinline__ void stage(Smem<HD>& sm, int buf, const Seq& r, const Seq& k,
                                      const Seq& lw, const Seq& v, const Lane& row,
                                      const Lane& col, int t0, int n, bool vec) {
  if (row.every) {
    for (int t = row.t; t < n; t += row.every) {
      const long long tt = t0 + t;
      cp_async(&sm.raw[buf][0][t][row.f], r.p + tt * r.st + row.f, vec);
      cp_async(&sm.raw[buf][1][t][row.f], k.p + tt * k.st + row.f, vec);
      cp_async(&sm.raw[buf][2][t][row.f], lw.p + tt * lw.st + row.f, vec);
    }
  }
  if (col.every) {
    for (int t = col.t; t < n; t += col.every)
      cp_async(&sm.v[buf][t][col.f], v.p + (t0 + t) * v.st + col.f, vec);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(Seq r, Seq k, Seq v, Seq lw, const float* __restrict__ u, long long ush,
             const float* __restrict__ s0, long long s0b, long long s0h, long long s0i,
             float* __restrict__ o, float* __restrict__ s_last, int T, int H, int hd,
             bool vec_in, bool vec_s0) {
  constexpr int kRows = HD / (kR * kWarps);  // state rows per lane
  __shared__ Smem<HD> sm;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane % kR;       // row group
  const int q = lane / kR;       // column group: columns jc .. jc + 3
  const int row0 = warp * (HD / kWarps) + g;  // rows row0 + 8 m
  const int j0 = blockIdx.x * kJC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int jc = j0 + q * kCT;
  const int ncol = min(kJC, hd - j0);

  // point each input at (b, t = 0, h); v at column j0
  r.p += b * r.sb + h * r.sh;
  k.p += b * k.sb + h * k.sh;
  lw.p += b * lw.sb + h * lw.sh;
  v.p += b * v.sb + h * v.sh + j0;
  const int w = vec_in ? 4 : 1;
  const Lane row_lane = lane_of(hd / w, w), col_lane = lane_of(ncol / w, w);
  const int nchunks = (T + kTC - 1) / kTC;
  stage(sm, 0, r, k, lw, v, row_lane, col_lane, 0, min(kTC, T), vec_in);
  cp_async_commit();

  // the lane's state tile, one float4 (or 4 floats) per row
  float s[kRows][kCT];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = row0 + kR * m;
    const float* src = s0 ? s0 + b * s0b + h * s0h + i * s0i + jc : nullptr;
    if (src && vec_s0 && i < hd && jc < hd) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      s[m][0] = x.x, s[m][1] = x.y, s[m][2] = x.z, s[m][3] = x.w;
    } else {
#pragma unroll
      for (int c = 0; c < kCT; ++c) s[m][c] = (src && i < hd && jc + c < hd) ? src[c] : 0.f;
    }
  }

  const float ui = tid < hd ? u[h * ush + tid] : 0.f;  // this thread converts row tid
  const long long o_step = (long long)H * hd;
  float* ob = o + ((long long)b * T * H + h) * hd + j0;
  // after the butterfly, lane g holds column 2 (g >> 2 & 1) + (g >> 1 & 1)
  const int cout = ((g >> 2) & 1) * 2 + ((g >> 1) & 1);
  const bool writer = (g & 1) == 0;

  // o of a computed chunk: the two warps' sums, one row of columns a step
  auto flush = [&](int t0, int n) {
    for (int e = tid; e < n * kJC; e += kThreads) {
      const int t = e / kJC, c = e % kJC;
      if (c < ncol) ob[(t0 + t) * o_step + c] = sm.red[t][0][c] + sm.red[t][1][c];
    }
  };

  // one step on the lane's tile: its partial readouts of its 4 columns,
  // sum_i r_i S_ij + v_j sum_i r_i u_i k_i over the lane's rows i
  auto step = [&](int buf, int t, float(&acc)[kCT]) {
    const float4 vv = *reinterpret_cast<const float4*>(&sm.v[buf][t][q * kCT]);
    float vc[kCT] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
      if (q * kCT + c >= ncol) vc[c] = 0.f;
      acc[c] = 0.f;
    }
    float ruk = 0.f;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float4 x = sm.pk[t][row0 + kR * m];  // (r_i, k_i, w_i, u_i k_i)
      ruk = fmaf(x.x, x.w, ruk);
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        acc[c] = fmaf(x.x, s[m][c], acc[c]);
        s[m][c] = fmaf(x.z, s[m][c], x.y * vc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCT; ++c) acc[c] = fmaf(vc[c], ruk, acc[c]);
  };
  // transposing butterfly over the row groups: xor 4 splits the 4 columns
  // in halves, xor 2 in quarters, xor 1 adds the last pair
  const bool hi4 = g & 4, hi2 = g & 2;
  auto reduce = [&](int t, const float(&acc)[kCT]) {
    float k0 = hi4 ? acc[2] : acc[0], k1 = hi4 ? acc[3] : acc[1];
    k0 += __shfl_xor_sync(0xffffffffu, hi4 ? acc[0] : acc[2], 4);
    k1 += __shfl_xor_sync(0xffffffffu, hi4 ? acc[1] : acc[3], 4);
    float sum = hi2 ? k1 : k0;
    sum += __shfl_xor_sync(0xffffffffu, hi2 ? k0 : k1, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (writer) sm.red[t][warp][q * kCT + cout] = sum;
  };

  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1, t0 = ch * kTC, n = min(kTC, T - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk ch landed; chunk ch - 1 is computed
    if (ch + 1 < nchunks)
      stage(sm, buf ^ 1, r, k, lw, v, row_lane, col_lane, t0 + kTC, min(kTC, T - t0 - kTC),
            vec_in);
    cp_async_commit();
    if (ch > 0) flush(t0 - kTC, kTC);
    if (tid < HD) {
#pragma unroll
      for (int t = 0; t < kTC; ++t) {
        if (t < n) {
          float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
          if (tid < hd) {
            const float kk = sm.raw[buf][1][t][tid];
            y = make_float4(sm.raw[buf][0][t][tid], kk, expf(sm.raw[buf][2][t][tid]), ui * kk);
          }
          sm.pk[t][tid] = y;
        }
      }
    }
    __syncthreads();
    if (n == kTC) {  // a whole chunk: 16 steps unrolled, the butterflies after
      float acc[kTC][kCT];
#pragma unroll
      for (int t = 0; t < kTC; ++t) step(buf, t, acc[t]);
#pragma unroll
      for (int t = 0; t < kTC; ++t) reduce(t, acc[t]);
    } else {
      for (int t = 0; t < n; ++t) {
        float acc[kCT];
        step(buf, t, acc);
        reduce(t, acc);
      }
    }
  }
  __syncthreads();
  flush((nchunks - 1) * kTC, T - (nchunks - 1) * kTC);

  float* sp = s_last + ((long long)b * H + h) * hd * hd + jc;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = row0 + kR * m;
    if (i >= hd || jc >= hd) continue;
    if (hd % 4 == 0) {
      *reinterpret_cast<float4*>(sp + i * hd) = make_float4(s[m][0], s[m][1], s[m][2], s[m][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        if (jc + c < hd) sp[i * hd + c] = s[m][c];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool whole_float4s(const Seq& x) {
  return aligned16(x.p) && x.sb % 4 == 0 && x.st % 4 == 0 && x.sh % 4 == 0;
}

template <int HD>
int launch(const Seq& r, const Seq& k, const Seq& v, const Seq& lw, const float* u, long long ush,
           const float* s0, long long s0b, long long s0h, long long s0i, float* o,
           float* s_last, int B, int T, int H, int hd, cudaStream_t stream) {
  const bool vec_in = hd % 4 == 0 && whole_float4s(r) && whole_float4s(k) &&
                      whole_float4s(v) && whole_float4s(lw);
  const bool vec_s0 = s0 && hd % 4 == 0 && aligned16(s0) && s0b % 4 == 0 && s0h % 4 == 0 &&
                      s0i % 4 == 0;
  const dim3 grid((hd + kJC - 1) / kJC, H, B);
  rwkv6_kernel<HD><<<grid, kThreads, 0, stream>>>(r, k, v, lw, u, ush, s0, s0b, s0h, s0i, o,
                                                  s_last, T, H, hd, vec_in, vec_s0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_fwd(const float* r, long long rsb, long long rst, long long rsh,
                         const float* k, long long ksb, long long kst, long long ksh,
                         const float* v, long long vsb, long long vst, long long vsh,
                         const float* lw, long long wsb, long long wst, long long wsh,
                         const float* u, long long ush, const float* s0, long long s0b,
                         long long s0h, long long s0i, float* o, float* s_last, int B, int T,
                         int H, int hd, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || hd <= 0 || hd > 64 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Seq rs{r, rsb, rst, rsh}, ks{k, ksb, kst, ksh}, vs{v, vsb, vst, vsh},
      ws{lw, wsb, wst, wsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 16) return launch<16>(rs, ks, vs, ws, u, ush, s0, s0b, s0h, s0i, o, s_last, B, T, H, hd, st);
  if (hd <= 32) return launch<32>(rs, ks, vs, ws, u, ush, s0, s0b, s0h, s0i, o, s_last, B, T, H, hd, st);
  return launch<64>(rs, ks, vs, ws, u, ush, s0, s0b, s0h, s0i, o, s_last, B, T, H, hd, st);
}
