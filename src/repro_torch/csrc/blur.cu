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
//
// M1, the persistent blur megakernel (`blur_mega`, below).  Counterpart of
// the reference's `make_megakernel` (src/repro/core/preemption.py:174) over
// the blur task, a jitted `lax.while_loop` that runs on its CPU backend
// only; not a `pallas_call`.  One cooperative launch runs the task's whole
// remaining chunk loop.  Every thread of every block runs the for_save
// control flow of kernels/blur/tasks.py over its own copy of the 36 context
// words (registers), the same scalar code on the same inputs, so all take
// the same branches; the compute blocks share the row blocks of each pass's
// run in a grid-stride loop over B1's tiles (8 rows a thread), with plain
// loads (not the read-only path: a pass reads what other blocks wrote
// earlier in the same launch, visible once the pass's wait has acquired
// their release).  The last block is the watcher:
// its thread 0 runs the same control flow without the runs and alone
// touches the host's words.
//
// Waits.  Pass k reads one image and writes the other, so within a pass
// consecutive chunks write disjoint row blocks and read a source nothing
// writes: blocks may be a chunk apart there.  Only a run that starts a new
// pass inside the launch must wait for every block to have finished the
// last one (it reads the halo rows other blocks wrote, and overwrites the
// image they read): one grid-wide wait a pass, where the pass ends, inside
// the chunk when a chunk crosses it.  Each compute block reports a pass end
// on a device counter (`red.release.gpu` after a block barrier) and waits,
// before the next pass's run, until the counter holds every block's report
// (`ld.acquire.gpu`, then a block barrier).  kernels/blur/kernel.py's
// `mega_plan` gives the waits a launch takes; the kernel reports them.
//
// Boundary.  The stop rule is the reference's: at least one chunk unless
// the context is already done, then an exit at the first boundary n >=
// flag when flag != 0; the progress word ends equal to the chunks run.  For
// each chunk n the watcher publishes decision n (a device word tagged with
// n, so no slot is reset and a stale boundary's word never reads as this
// one's), waits until every compute block has reported chunk n (a device
// counter), stores n to the host's progress word (`st.relaxed.sys`) and
// then issues the flag read that decides boundary n + 1 (`ld.relaxed.sys`).
// The read for boundary 1 is issued at launch, so a flag armed before the
// launch stops it at boundary 1; no read is issued for a boundary the task
// cannot reach (its chunk completes it).  A compute block starts chunk
// n + 1 once it sees decision n, whose read was issued a chunk earlier, so
// the read normally hides under chunk n's run.  A flag written into a
// running launch stops it at most 2 chunks past the progress the host read
// after its write: the store of that progress + 1 and the read issued after
// it reach host memory after the write (they leave the SM in that order
// and PCIe keeps a read behind the writes before it; a `fence.sc.sys`
// between them costs more than the read, as `seq_latency_probe` in
// seq_lm.cu times it), and that read decides the boundary after.  The
// earlier design, a grid sync after each run and one thread's read of the
// host's word between two more, is what `blur_latency_probe` (below)
// times part by part.
//
// Block 0 writes back the context words, the chunk count, the row blocks
// and the grid-wide waits it took; every block adds the tiles it ran, so
// the host checks that the grid covered each row block once; the first
// block's start and the last block's end are stamped from %globaltimer.
//   blur_mega(ctx, ping, pong, stride, n_rb, width, iters, budget,
//             max_chunks, blocks, kind, vec, flag, progress, out, device,
//             info, stream)
// `blocks` (the plan's grid, one tile a block in the largest run) is capped
// so that the launch, the watcher included, takes at most half the blocks
// the card holds at once (`kRegionsSharing`): a cooperative launch starts
// only when all its blocks fit, so two uncapped regions would run one after
// the other.  `max_chunks` bounds the loop: a launch that reaches it undone
// reports status 1 and the wrapper raises, so a broken control flow cannot
// hold the card.  Asking the L2 for the next run's source rows
// (`cp.async.bulk.prefetch.L2`, each block its tile's rows after its run)
// did not pay on the H100 and is not done.
// Bound: B1's bytes per chunk (2.51 us for an 8-block chunk at width 4096);
// the waits come on top.  Numerics are B1's, bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"

namespace cg = cooperative_groups;

namespace {

using mega::Ctx;
using mega::kCtxWords;
using mega::issue_flag_read;
using mega::load_flag;
using mega::store_progress;

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

// One float (or float2) of a source row.  kNc: through the read-only data
// cache (`__ldg`), for a source nothing writes while the kernel runs (B1);
// otherwise a plain load, cached in L1, for the persistent kernel: its
// passes read what other blocks wrote earlier in the same launch, which a
// load sees once its block has waited for the pass's end with an acquire
// (the non-coherent read-only path would not).  On the H100 they took M1's
// median chunk at budget 8 from 4.78 to 4.43 us against `__ldcg`'s L2
// loads (chip_smoke.py --ab-mega before and after).
template <bool kNc, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kNc) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Columns c, c + 1 of one source row, zero past the row's end.
template <bool kVec, bool kNc = true>
__device__ __forceinline__ float2 load2(const float* row, int c, int n) {
  if (kVec && c + 1 < n) return load<kNc>(reinterpret_cast<const float2*>(row + c));
  float2 v = make_float2(0.f, 0.f);
  if (c < n) v.x = load<kNc>(row + c);
  if (c + 1 < n) v.y = load<kNc>(row + c + 1);
  return v;
}

// The work of one B1 block: columns 2 x (bx * 128 + thread) and the next,
// output rows by * R .. by * R + R - 1.
template <int R, bool kVec, bool kMedian, bool kNc>
__device__ __forceinline__ void blur_tile(const float* src, long long src_stride, float* dst,
                                          long long dst_stride, int rows, int width, int bx,
                                          int by) {
  const int j0 = 2 * (bx * kThreads + threadIdx.x);  // first output column
  const int r0 = by * R;                             // first output row
  const int src_width = width + 2;

  // the 4 columns of every input row of the strip, loaded before any is used
  float c[R + 2][4];
#pragma unroll
  for (int i = 0; i < R + 2; ++i) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (r0 + i < rows + 2) {
      const float* s = src + (long long)(r0 + i) * src_stride;
      lo = load2<kVec, kNc>(s, j0, src_width);
      hi = load2<kVec, kNc>(s, j0 + 2, src_width);
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

template <int R, bool kVec, bool kMedian>
__global__ void __launch_bounds__(kThreads)
blur_rows_kernel(const float* __restrict__ src, long long src_stride, float* __restrict__ dst,
                 long long dst_stride, int rows, int width) {
  blur_tile<R, kVec, kMedian, true>(src, src_stride, dst, dst_stride, rows, width, blockIdx.x,
                                    blockIdx.y);
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

// ---------------------------------------------------------------------------
// M1: the persistent blur megakernel (one cooperative launch per task).

constexpr int kSlotK = 0, kSlotRow = 1;     // kernels/blur/tasks.py
constexpr int kRowBlock = 32;               // the preemption unit: one budget unit
constexpr int kMegaRows = 8;                // output rows a thread per tile
// out[] (int32 words, zeroed by the caller): the context words, then these
constexpr int kOutChunks = kCtxWords;         // chunks this launch ran
constexpr int kOutRowBlocks = kCtxWords + 1;  // row blocks its control issued
constexpr int kOutTiles = kCtxWords + 2;      // tiles the blocks ran (atomic sum)
constexpr int kOutStatus = kCtxWords + 3;     // 0, or 1: hit max_chunks undone
constexpr int kOutWaits = kCtxWords + 4;      // grid-wide waits block 0 took
// two u64: ~%globaltimer at the first block's start (the largest
// complement), %globaltimer at the last block's end
constexpr int kOutStart = kCtxWords + 6;
constexpr int kOutEnd = kCtxWords + 8;
// the words the blocks hand each other, a 128-byte line each
constexpr int kOutChunkReports = 64;  // compute blocks' chunk ends
constexpr int kOutPassReports = 96;   // compute blocks' pass ends
constexpr int kOutDecision = 128;     // (boundary << 1) | stop, from the watcher
constexpr int kOutWords = 160;  // kernels/blur/kernel.py OUT_WORDS
static_assert(kOutStart % 2 == 0 && kOutEnd % 2 == 0 && kOutDecision < kOutWords,
              "u64 stamps, every word inside out[]");
// a region's launch takes at most 1 / kRegionsSharing of the blocks the
// card can hold at once, so another region's cooperative launch still fits
constexpr int kRegionsSharing = 2;

struct MegaArgs {
  Ctx ctx;         // the record at launch, by value
  float* ping;     // padded [H+2, W+2] images, row stride `stride` floats
  float* pong;
  long long stride;
  int n_rb, width, iters, budget, max_chunks;
  const int* flag;  // the mapped host preempt word
  int* progress;    // the mapped host word of the chunks completed
  int* out;         // kOutWords device words, zeroed by the caller
};

// Hand-offs between blocks through device memory.
__device__ __forceinline__ void red_release(int* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
}
__device__ __forceinline__ void red_relaxed(int* p) {
  asm volatile("red.relaxed.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
// spin until the counter at p holds at least `target` reports
__device__ __forceinline__ void wait_reports(const int* p, int target) {
  while (ld_acquire(p) < target) {
  }
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp_start(int* out) {
  atomicMax(reinterpret_cast<unsigned long long*>(out + kOutStart), ~global_ns());
}
__device__ __forceinline__ void stamp_end(int* out) {
  atomicMax(reinterpret_cast<unsigned long long*>(out + kOutEnd), global_ns());
}

// Blur row blocks [first, first + n_blocks) of `src` into `dst` in place,
// the tiles shared over the `blocks` compute blocks.  Returns the tiles
// this block ran.
template <bool kVec, bool kMedian>
__device__ __forceinline__ int mega_run(const float* src, float* dst, long long stride, int first,
                                        int n_blocks, int width, int blocks) {
  const int rows = n_blocks * kRowBlock;
  const int col_blocks = ((width + 1) / 2 + kThreads - 1) / kThreads;
  const int n_tiles = col_blocks * (rows / kMegaRows);
  const float* s = src + (long long)first * kRowBlock * stride;
  float* d = dst + ((long long)first * kRowBlock + 1) * stride + 1;
  int mine = 0;
  for (int t = blockIdx.x; t < n_tiles; t += blocks, ++mine) {
    blur_tile<kMegaRows, kVec, kMedian, false>(s, stride, d, stride, rows, width,
                                               t % col_blocks, t / col_blocks);
  }
  return mine;
}

// One chunk of the task's control flow from `c`: kernels/blur/tasks.py's
// _blur_task under core/preemption.py's for_save, word for word:
//   for_save(K, 0, iters): checkpoint(K, k);
//     for_save(ROW, 0, n_rb): checkpoint(ROW, r + 1)   -- a row block each
//     run the pass's row blocks; if not intr: checkpoint(K, k + 1)
//   if not intr: done
// with dec_budget on both loop levels and intr telling the outer loop that
// the inner one was cut.  `run(k, first, n_blocks, ends_pass)` is called
// for each pass's run.
template <typename Run>
__device__ __forceinline__ void chunk_control(Ctx& c, int n_rb, int iters, int budget, Run&& run) {
  c.budget = budget;  // ctx.with_budget(budget)
  c.intr = 0;
  // for_save(ctx, SLOT_K, 0, iters, 1, body_k)
  c.init_var[kSlotK] = 0;  // declare
  c.incr_var[kSlotK] = 1;
  int k = c.saved[kSlotK] == 1 ? c.var[kSlotK] : 0;  // resume_value
  c.saved[kSlotK] = 0;                                 // unsave
  while (k < iters && c.budget > 0 && c.intr == 0) {
    c.intr = 0;
    c.var[kSlotK] = k;  // body_k: checkpoint(SLOT_K, k)
    c.saved[kSlotK] = 1;
    // for_save(ctx, SLOT_ROW, 0, n_rb, 1, body_row)
    c.init_var[kSlotRow] = 0;
    c.incr_var[kSlotRow] = 1;
    int r = c.saved[kSlotRow] == 1 ? c.var[kSlotRow] : 0;
    c.saved[kSlotRow] = 0;
    const int first = r;
    while (r < n_rb && c.budget > 0 && c.intr == 0) {
      c.intr = 0;
      c.var[kSlotRow] = r + 1;  // body_row: checkpoint(SLOT_ROW, r + 1)
      c.saved[kSlotRow] = 1;
      c.budget -= 1;  // body_row holds no loop: the iteration always counts
      r += 1;
    }
    const bool rows_done = r >= n_rb;
    if (rows_done) {  // clear(SLOT_ROW)
      c.var[kSlotRow] = 0;
      c.saved[kSlotRow] = 0;
    }
    c.intr = rows_done ? 0 : 1;
    run(k, first, r - first, rows_done);
    if (c.intr == 0) {  // checkpoint(SLOT_K, k + 1)
      c.var[kSlotK] = k + 1;
      c.saved[kSlotK] = 1;
    }
    const bool ok = c.intr == 0;
    c.budget -= 1;
    if (ok) k += 1;
  }
  const bool iters_done = k >= iters;
  if (iters_done) {  // clear(SLOT_K)
    c.var[kSlotK] = 0;
    c.saved[kSlotK] = 0;
  }
  c.intr = iters_done ? 0 : 1;
  if (c.intr == 0) c.done = 1;  // ctx.finish()
}

// The watcher (thread 0 of the last block): the boundary protocol above,
// the compute blocks' control flow without the runs.
__device__ void watch(const MegaArgs& a, int blocks) {
  const auto no_run = [](int, int, int, bool) {};
  Ctx c = a.ctx;
  if (c.done != 0) return;
  Ctx next = c;
  chunk_control(next, a.n_rb, a.iters, a.budget, no_run);
  int f = next.done == 0 ? issue_flag_read(a.flag) : 0;  // decides boundary 1
  for (int n = 1;; ++n) {
    c = next;  // the context after chunk n
    int stop = 0;
    if (c.done == 0) {
      stop = f != 0 && n >= f;
      st_relaxed(a.out + kOutDecision, (n << 1) | stop);
    }
    wait_reports(a.out + kOutChunkReports, n * blocks);
    store_progress(a.progress, n);
    if (c.done != 0 || stop || n == a.max_chunks) return;
    chunk_control(next, a.n_rb, a.iters, a.budget, no_run);
    if (next.done == 0) f = issue_flag_read(a.flag);  // decides boundary n + 1
  }
}

template <bool kVec, bool kMedian>
__global__ void __launch_bounds__(kThreads) blur_mega_kernel(const MegaArgs a) {
  const int blocks = gridDim.x - 1;  // the compute blocks; the last one watches
  if (threadIdx.x == 0) stamp_start(a.out);
  if (blockIdx.x == blocks) {
    if (threadIdx.x == 0) {
      watch(a, blocks);
      stamp_end(a.out);
    }
    return;
  }
  __shared__ int stop_word;
  Ctx c = a.ctx;
  int n_chunks = 0, row_blocks = 0, status = 0, stop = 0, tiles = 0, waits = 0;
  int pass_ends = 0;
  bool first_run = true;
  while (c.done == 0 && stop == 0) {
    if (n_chunks == a.max_chunks) {  // never on a right control flow
      status = 1;
      break;
    }
    chunk_control(c, a.n_rb, a.iters, a.budget, [&](int k, int first, int n, bool ends_pass) {
      if (first == 0 && !first_run) {  // a new pass: every block done with the last
        if (threadIdx.x == 0) wait_reports(a.out + kOutPassReports, pass_ends * blocks);
        __syncthreads();
        ++waits;
      }
      first_run = false;
      // iteration k reads ping when k is even
      const float* src = k % 2 == 0 ? a.ping : a.pong;
      tiles += mega_run<kVec, kMedian>(src, k % 2 == 0 ? a.pong : a.ping, a.stride, first, n,
                                       a.width, blocks);
      row_blocks += n;
      if (ends_pass) {
        ++pass_ends;
        __syncthreads();
        if (threadIdx.x == 0) red_release(a.out + kOutPassReports);
      }
    });
    ++n_chunks;
    __syncthreads();
    if (threadIdx.x == 0) {
      red_relaxed(a.out + kOutChunkReports);
      if (c.done == 0) {  // decision n_chunks; a later boundary's means it ran on
        int d;
        while ((d = ld_relaxed(a.out + kOutDecision)) >> 1 < n_chunks) {
        }
        stop_word = d >> 1 == n_chunks ? d & 1 : 0;
      }
    }
    __syncthreads();
    if (c.done == 0) stop = stop_word;
  }
  if (threadIdx.x == 0) {
    if (tiles) atomicAdd(a.out + kOutTiles, tiles);
    if (blockIdx.x == 0) {
      mega::write_ctx(a.out, c);
      a.out[kOutChunks] = n_chunks;
      a.out[kOutRowBlocks] = row_blocks;
      a.out[kOutStatus] = status;
      a.out[kOutWaits] = waits;
    }
    stamp_end(a.out);
  }
}

// The launch's blocks: the compute blocks asked for (at least 1) and the
// watcher, within 1 / `sharing` of the blocks the card holds at once.
// info[] gets the grid, its cap and the co-resident blocks.
template <typename Kernel>
cudaError_t mega_grid(Kernel kernel, int blocks, int sharing, int device, int* info, int& grid) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int coresident = per_sm * sms;
  const int cap = coresident / sharing;
  if (cap < 2) return cudaErrorCooperativeLaunchTooLarge;
  grid = (blocks < 1 ? 1 : blocks < cap - 1 ? blocks : cap - 1) + 1;
  info[0] = grid;
  info[1] = cap;
  info[2] = coresident;
  return cudaSuccess;
}

template <bool kVec, bool kMedian>
int launch_mega(const MegaArgs& a, int blocks, int device, int* info, cudaStream_t s) {
  int grid = 0;
  cudaError_t err =
      mega_grid(blur_mega_kernel<kVec, kMedian>, blocks, kRegionsSharing, device, info, grid);
  if (err != cudaSuccess) return (int)err;
  MegaArgs arg = a;
  void* params[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(blur_mega_kernel<kVec, kMedian>),
                                    dim3(grid), dim3(kThreads), params, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A probe of what an M1 chunk is made of (not a kernel of any path:
// chip_smoke.py's [mega] launches it), at M1's geometry: the same
// cooperative grid of compute blocks and the watcher block.  Thread 0 of
// block 0 (terms 0-2) or of the watcher (3-4) stamps %globaltimer around
// `reps` repetitions and writes the nanoseconds of all of them to out[k]:
//   0 one pass's run of `run_blocks` row blocks (mega_run, ping into pong,
//     the runs walking down the image), no sync between runs; one grid
//     sync after the last
//   1 a grid sync (cooperative_groups), every block
//   2 the earlier design's chunk boundary: a grid sync, then block 0's
//     thread 0 stores the progress word (volatile) and reads the flag
//     (ld.acquire.sys) and stores the decision, a grid sync, every thread
//     reads the decision
//   3 the watcher's flag read (ld.relaxed.sys), each read's address
//     hanging on the last value
//   4 a hand-off round: every compute block's thread 0, after a block
//     barrier, adds one to a device counter (red.release.gpu); the watcher
//     spins on it (ld.acquire.gpu) until every block has, then publishes
//     the round's tag, on which the blocks spin before the next round
// `scratch` holds 64 zeroed ints; `out` the 5 terms (kernel.py PROBE_PARTS).

struct ProbeArgs {
  float* ping;
  float* pong;
  long long stride;
  int n_rb, width, run_blocks, reps;
  int zero;  // 0, opaque to the compiler: a read's address hangs on a value
  const int* flag;
  int* progress;
  int* scratch;
  long long* out;
};

template <bool kVec, bool kMedian>
__global__ void __launch_bounds__(kThreads) blur_probe_kernel(const ProbeArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int blocks = gridDim.x - 1;
  const bool watcher = blockIdx.x == blocks, timer = blockIdx.x == 0 && threadIdx.x == 0;
  int* counter = a.scratch;
  int* tag = a.scratch + 32;
  int* decision = a.scratch + 16;
  int sink = 0;
  // 0: runs
  const int runs = a.n_rb / a.run_blocks;
  grid.sync();
  unsigned long long t0 = global_ns();
  for (int i = 0; i < a.reps && !watcher; ++i) {
    const int first = (i % runs) * a.run_blocks;
    sink += mega_run<kVec, kMedian>(a.ping, a.pong, a.stride, first, a.run_blocks, a.width,
                                    blocks);
  }
  grid.sync();
  if (timer) a.out[0] = (long long)(global_ns() - t0);
  // 1: grid syncs
  t0 = global_ns();
  for (int i = 0; i < a.reps; ++i) grid.sync();
  if (timer) a.out[1] = (long long)(global_ns() - t0);
  // 2: the earlier boundary
  t0 = global_ns();
  for (int i = 0; i < a.reps; ++i) {
    grid.sync();
    if (timer) {
      *reinterpret_cast<volatile int*>(a.progress) = i + 1;
      const int f = load_flag(a.flag);
      *reinterpret_cast<volatile int*>(decision) = f + i;
    }
    grid.sync();
    sink += *reinterpret_cast<volatile int*>(decision);
  }
  if (timer) a.out[2] = (long long)(global_ns() - t0);
  // 3: the watcher's relaxed read
  if (watcher && threadIdx.x == 0) {
    int f = 0;
    t0 = global_ns();
    for (int i = 0; i < a.reps; ++i) f += issue_flag_read(a.flag + (f & a.zero));
    a.out[3] = (long long)(global_ns() - t0);
    sink += f;
  }
  grid.sync();
  // 4: hand-off rounds
  if (watcher) {
    if (threadIdx.x == 0) {
      t0 = global_ns();
      for (int i = 1; i <= a.reps; ++i) {
        wait_reports(counter, i * blocks);
        st_relaxed(tag, i);
      }
      a.out[4] = (long long)(global_ns() - t0);
    }
  } else {
    for (int i = 1; i <= a.reps; ++i) {
      __syncthreads();
      if (threadIdx.x == 0) {
        red_release(counter);
        while (ld_relaxed(tag) < i) {
        }
      }
    }
  }
  if (sink == 0x7fffffff) a.scratch[63] = sink;  // keeps the chains live
}

template <bool kVec, bool kMedian>
int launch_probe(const ProbeArgs& a, int blocks, int device, int* info, cudaStream_t s) {
  int grid = 0;
  // alone on the card: its blocks at M1's count need not leave room
  cudaError_t err = mega_grid(blur_probe_kernel<kVec, kMedian>, blocks, 1, device, info, grid);
  if (err != cudaSuccess) return (int)err;
  ProbeArgs arg = a;
  void* params[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(blur_probe_kernel<kVec, kMedian>),
                                    dim3(grid), dim3(kThreads), params, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// M1: the task's remaining chunk loop in one cooperative launch.  `ctx` is
// the 36 host context words (ContextRecord.to_words), passed by value;
// `flag` and `progress` are the mapped host words of csrc/preempt_flag.cu;
// `blocks` the compute blocks asked for (kernels/blur/kernel.py mega_plan);
// `out` receives kOutWords words (zeroed by the caller); `info` receives
// the grid (the watcher included), its cap and the co-resident blocks of
// the card.  Returns cudaError_t.
extern "C" int blur_mega(const int* ctx, float* ping, float* pong, long long stride, int n_rb,
                         int width, int iters, int budget, int max_chunks, int blocks, int kind,
                         int vec, const int* flag, int* progress, int* out,
                         int device, int* info, void* stream) {
  if (n_rb <= 0 || width <= 0 || iters < 0 || budget <= 0 || max_chunks <= 0 || blocks <= 0 ||
      (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  MegaArgs a;
  a.ctx = mega::read_ctx(ctx);
  a.ping = ping;
  a.pong = pong;
  a.stride = stride;
  a.n_rb = n_rb;
  a.width = width;
  a.iters = iters;
  a.budget = budget;
  a.max_chunks = max_chunks;
  a.flag = flag;
  a.progress = progress;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return kind == 0 ? launch_mega<true, true>(a, blocks, device, info, s)
                     : launch_mega<true, false>(a, blocks, device, info, s);
  }
  return kind == 0 ? launch_mega<false, true>(a, blocks, device, info, s)
                   : launch_mega<false, false>(a, blocks, device, info, s);
}


// The probe above over `run_blocks`-block runs of the padded images (ping
// read, pong written; n_rb a multiple of run_blocks), on `blocks` compute
// blocks and the watcher; `scratch` 64 zeroed ints; `out` 5 int64
// nanoseconds; `info` as blur_mega's.  Returns cudaError_t.
extern "C" int blur_latency_probe(float* ping, float* pong, long long stride, int n_rb, int width,
                                  int run_blocks, int blocks, int kind, int vec, int reps,
                                  const int* flag, int* progress, int* scratch, long long* out,
                                  int device, int* info, void* stream) {
  if (n_rb <= 0 || width <= 0 || run_blocks <= 0 || n_rb % run_blocks || blocks <= 0 ||
      reps <= 0 || (kind != 0 && kind != 1) || !vec)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ProbeArgs a = {ping, pong, stride, n_rb, width, run_blocks, reps, 0,
                       flag, progress, scratch, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind == 0 ? launch_probe<true, true>(a, blocks, device, info, s)
                   : launch_probe<true, false>(a, blocks, device, info, s);
}
