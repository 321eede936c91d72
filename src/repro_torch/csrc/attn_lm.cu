// M4 and M5, the persistent attention-LM serving kernels, for Hopper
// (sm_90a).
//
// Counterparts of the reference's `make_megakernel`
// (src/repro/core/preemption.py:174, a jitted `lax.while_loop` over a
// kernel's chunk body that runs on its CPU backend only; not a
// `pallas_call`) applied to `attn_prefill` and `attn_decode`
// (src/repro/serving/attention.py:146-205 and :207-265).  One cooperative
// launch runs an attention-LM task's whole remaining chunk loop with the
// context on the card and polls the region's mapped preempt flag at every
// chunk boundary, as M1 (csrc/blur.cu) and M2/M3 (csrc/seq_lm.cu) do.  B2's
// and B3's device code (flash_attention.cuh, decode_attention.cuh) runs
// inside it; the projections and the readout, plain matrix products outside
// any kernel on the chunk path, run inside it too.
//
// Interface (plain C, loaded with ctypes; see kernels/attn_lm/kernel.py):
//   attn_prefill_mega(ctx, out, out_stride, k_new, v_new, prompt,
//                     prompt_stride, meta, meta_stride, w, ws, ws_floats,
//                     PB, P, D, vocab, H, KV, hd, C, max_ctx, hpb, scale,
//                     budget, max_chunks, flag, progress, words, device,
//                     stream)
//     M4: AttnPrefill's for_save(SLOT_POS, 0, P / C, 1), one C-wide
//     segment of every row's prompt per budget unit; out i32[PB, *],
//     k_new/v_new f32[PB, P, KV, hd] contiguous, prompt i32[PB, P], meta
//     i32[PB, *] (prompt_len in col 0).
//   attn_decode_mega(ctx, out, out_stride, k_pool, v_pool, NB, BS, table,
//                    table_stride, T_blk, w, ws, ws_floats, S, R, D, vocab,
//                    H, KV, hd, max_ctx, gt, warps, scale, budget,
//                    max_chunks, flag, progress, words, device, stream)
//     M5: one decode round, AttnDecode's for_save(SLOT_POS, 0, R, 1) over S
//     slot rows; out i32[S, R], pools f32[NB, BS, KV, hd] contiguous, table
//     i32[S, 4 + T_blk] (active, n_emit, last token, write position, the
//     block table), updated in place.
// `ctx` is the 36 host context words (ContextRecord.to_words), passed by
// value; `w` the flat weights f32[rows, D] (E, pos_emb, Wq^T, Wk^T, Wv^T,
// Wo; serving/attention.py); `ws` a workspace of at least
// attn_lm_workspace(...) floats; `flag` and `progress` the mapped host words
// of csrc/preempt_flag.cu; `words` receives kOutWords device words: the
// context words, the chunks run, the steps run and the status (0, or 1 when
// the launch reached `max_chunks` undone).  hpb (B2's heads a block) and
// gt/warps (B3's) are the chunk path's plans.  attn_lm_workspace and
// attn_lm_grid report a launch's workspace and grid.  Strides are in int32 elements.  The
// launch goes on the caller's stream; the functions return a cudaError_t.
//
// Control flow, as M2/M3: every thread of every block runs the for_save
// loop of core/preemption.py over its own copy of the context words, word
// for word (with_budget; declare, resume_value, unsave; per iteration
// clear_intr, checkpoint(SLOT_POS, i + 1), dec_budget; clear on completion;
// mark_intr; finish), so all take the same branches and meet every grid sync
// together.  At least one chunk runs unless the context is already done; the
// launch exits at the first boundary k >= flag when flag != 0.  At a
// boundary the grid syncs; block 0's thread 0 writes the chunks done to the
// progress word, reads the flag with `ld.acquire.sys` and publishes the
// decision in device memory (two slots, as M1); after a second grid sync
// every thread reads it.
//
// A chunk (M4) or a step (M5) is a run of phases, each spread over the
// grid, separated by grid syncs:
//   M4, a chunk of n = min(budget, segments left) segments: x = E[tok] +
//       pe[pos] for all n PB C rows of the chunk (0 past a row's prompt: x
//       comes from the prompt alone, never from an earlier segment's output);
//       x Wq^T, x Wk^T, x Wv^T in one pass over the weights (proj_tc; k, v
//       straight into k_new/v_new at the segments' positions); then for each
//       segment in order B2's causal flash body over keys [0, start + C) at
//       q_offset = start; then, at the chunk's end, for the rows whose
//       prompt_len - 1 falls in the chunk only: o Wo, the readout E^T and
//       its argmax into out[row, 0].  The for_save loop's body never
//       interrupts, so a chunk runs exactly n segments, and its outputs are
//       whole at the boundary that reads the flag.
//   M5: live, posc and x from the table; the projections, k and v scattered
//       straight into the pools at (table[4 + posc / BS], posc % BS) (dead
//       rows write zeros to null page 0, offset 0, as the chunk path does);
//       B3's paged body over posc + 1 keys; then, for live rows only: o Wo,
//       the readout and its argmax into out[:, t], table's last token and
//       write position.
// Deliberate difference from the chunk path (ROADMAP §C): the chunk body
// computes every row's logits and keeps the emitting rows' (M4: at most PB a
// segment, none in most; M5: the live rows); M4/M5 compute o Wo and the
// readout for those rows only.  The tokens kept are the same.
//
// Products, at f32 accuracy (never plain TF32: the K/V written must match
// the chunk path's f32 products within 2e-5):
// - M4's projections (proj_tc), on the tensor cores in three TF32 products
//   a term (hi hi + hi lo + lo hi, B2's split and mma.sync m16n8k8): a pass
//   holds kPM = 128 rows of x; a block owns a band of kPN = 96 of Wq/Wk/Wv's
//   rows (output columns) and streams it once a pass through a kPStages-deep
//   cp.async pipeline of kPK-column slices of x and the band; 8 warps of 32
//   x 48 outputs.  A chunk of `rows` rows takes ceil(rows / 128) passes.
// - A B^T (M5's projections, the readouts), in f32 FMAs on the SIMT cores
//   with the weights read through the read-only path: a block stages 8 rows of A (up to
//   4096 columns) in shared memory; a warp takes 4 rows of B, a lane 4
//   columns of every 128, 32 partial sums a lane, summed across the warp by
//   B3's transposing butterfly.  The blocks stride over B's 32-row tiles.
// - o Wo (Wo is [H hd, D]): a warp takes 128 output columns over a slice
//   of Wo's rows (the split of the sum over the rows is fixed by the
//   shapes), partial sums in the workspace, added in slice order after a
//   grid sync: deterministic.
// - argmax: each lane keeps the best (value, index) of its row over the
//   tiles it saw, ties to the lower index, as torch.argmax and jnp.argmax;
//   the warp, then the block combine them; block 0 combines the blocks'
//   after a grid sync, in block order.
// Data a launch writes and then reads (x, q, o, the K/V, the table) is read
// with plain loads after a grid sync, never through the read-only path.
//
// Grid: the co-resident blocks of the card (cudaOccupancy...), capped at
// half (kRegionsSharing) as M1 is, so the prefill region's M4 and the decode
// region's M5 run side by side; 256 threads a block (B2's block, B3's 8
// warps).
//
// Bound, at Qwen3-8B's attention widths (d_model 4096, vocab 151936, 32
// heads, 8 KV heads, hd 128):
// - M5: every step reads E (151936 x 4096 f32, 2.489 GB) and Wq/Wk/Wv/Wo
//   (10240 rows x 4096, 167.8 MB): 0.793 ms at 3.35 TB/s; a round of 8
//   steps 6.35 ms, bytes-bound (its FLOPs, 0.16 ms a step at 67 TFLOP/s
//   f32).
// - M4, counted a chunk of `budget` segments (chip_smoke.py _attn_bounds):
//   the flag is read at chunk boundaries only, so a chunk's outputs must be
//   whole at its end and no pass over a weight can serve two chunks; within
//   a chunk the segments' x come from the prompt alone and their readouts
//   can wait to its end, so a chunk needs one pass over Wq/Wk/Wv (100.7 MB,
//   30 us) and, when a row emits in it, one over Wo and E (2.556 GB, 0.763
//   ms).  The projections of a segment (PB 4 x 16 rows) are 3.22 GFLOP, 48
//   us at 67 TFLOP/s f32.  At budget 2, a 4-row prefill of 8 segments whose
//   emitting rows fall in 2 of its 4 chunks: 1.648 ms, bytes-bound.
//   What this kernel reads: Wq/Wk/Wv ceil(n PB C / 128) times a chunk (once
//   at budgets 1 and 2 at PB 4, C 16; 4 times for budget 8's one chunk of
//   512 rows, where the bound counts once), and Wo and E ceil(e / 8) times a
//   chunk with e emitting rows (once while PB <= 8), as the bound counts;
//   x (rows x D) once a band from the L2.  What keeps it off that bound
//   (PERF.md §6): the kernel shares its 255 registers with B2's body, so
//   the readout's loop keeps 4 B loads a lane in flight where M5's copy of
//   the same loop keeps 8, and the projection pass spills.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention.cuh"
#include "flash_attention.cuh"
#include "mega.cuh"

namespace cg = cooperative_groups;

namespace {

using mega::Ctx;
using mega::kCtxWords;
using mega::load_flag;

constexpr int kSlotPos = 0;                 // serving/kernels.py SLOT_POS
constexpr int kOutChunks = kCtxWords;       // chunks this launch ran
constexpr int kOutSteps = kCtxWords + 1;    // for_save iterations it ran
constexpr int kOutStatus = kCtxWords + 2;   // 0, or 1: hit max_chunks undone
// kOutWords = kCtxWords + 3 (kernels/seq_lm/kernel.py OUT_WORDS, for M2-M5)
// the decode table's columns: serving's COL_* and TABLE_META
// (serving/kernels.py, serving/attention.py; tests/test_torch_attn_mega.py
// holds them equal)
constexpr int kColActive = 0, kColNEmit = 1, kColLastTok = 2, kColSeqLen = 3, kTableMeta = 4;

constexpr int kThreads = flash_attn::kThreads;  // 256
static_assert(kThreads == decode_attn::kMaxWarps * 32, "B3's warps fill the block");
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 8;        // rows of A a product pass holds
constexpr int kNR = 4;        // rows of B a warp takes (A B^T)
static_assert(kMT * kNR == 32, "one partial sum a lane after the butterfly");
constexpr int kKC = 4096;     // columns of A staged at once
// M4's projections on the tensor cores (proj_tc)
constexpr int kPM = 128;      // rows of x a pass holds
constexpr int kPN = 96;       // Wq/Wk/Wv rows (output columns) a block owns
constexpr int kPK = 32;       // columns of a pipeline stage
constexpr int kPStages = 4;
constexpr int kPPitch = kPK + 4;  // floats: fragment loads hit 32 banks
constexpr int kWM = 32, kWN = 48;  // a warp's outputs: 4 x 2 warps
static_assert((kPM / kWM) * (kPN / kWN) == kWarps, "the warps tile the block's outputs");
constexpr int kMaxRows = 128;             // PB and S
constexpr int kMaxGrid = 1024;            // the argmax partials' rows
constexpr int kRegionsSharing = 2;        // as csrc/blur.cu
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -__builtin_huge_valf();

__host__ __device__ constexpr long long up4(long long n) { return (n + 3) & ~3ll; }

// o Wo's split of the sum over Wo's rows: slices of `slice` rows (a
// multiple of 4), `ks` of them, about 1024 warp items in all
struct WoSplit {
  int ks, slice;
  __host__ __device__ WoSplit(int D, int HQ) {
    const int groups = (D + 127) / 128;
    const int target = 1024 / groups > 1 ? 1024 / groups : 1;
    slice = (int)up4((HQ + target - 1) / target);
    ks = (HQ + slice - 1) / slice;
  }
};

// The workspace, in floats: x, q, o ([rows, *]: M4's rows are a whole
// chunk's, min(budget, P / C) PB C; M5's the S slots), o Wo's partial sums and
// their total ([emit rows, D]), the argmax partials, then ints: the count
// of emitting rows, the two decision slots, the emitting rows (their rows
// of x), their out rows, and M5's positions, pages and offsets a slot row.
struct Layout {
  long long x, q, o, part, y, aval, aidx, ints, total;
  __host__ __device__ Layout(int rows, int emit, int D, int HQ) {
    const WoSplit sp(D, HQ);
    x = 0;
    q = x + up4((long long)rows * D);
    o = q + up4((long long)rows * HQ);
    part = o + up4((long long)rows * HQ);
    y = part + up4((long long)sp.ks * emit * D);
    aval = y + up4((long long)emit * D);
    aidx = aval + up4((long long)kMaxGrid * emit);
    ints = aidx + up4((long long)kMaxGrid * emit);
    total = ints + up4(4 + 2 * emit + 3 * rows);
  }
};
constexpr int kICount = 0, kIDecision = 1, kIList = 4;

struct LmArgs {
  Ctx ctx;                    // the record at launch, by value
  const float* w;             // weights [rows, D]
  long long pe0, q0, o0;      // rows of pos_emb, Wq^T (then Wk^T, Wv^T), Wo; E at 0
  int D, vocab, H, KV, hd, HQ, KVD, max_ctx;
  float scale;
  int* out;
  long long out_stride;
  // M4
  float* k_new;
  float* v_new;
  const int* prompt;
  long long prompt_stride;
  const int* meta;
  long long meta_stride;
  int PB, P, C, hpb, kv_vec, q_vec;
  // M5
  float* k_pool;
  float* v_pool;
  int* table;
  long long table_stride;
  int NB, BS, T_blk, S, R, gt, nw;
  // both
  int budget, max_chunks;
  const int* flag;            // the mapped host preempt word
  int* progress;              // the mapped host word of the chunks completed
  int* words;                 // kOutWords device words
  float* ws;                  // the workspace
  int rows, emit;             // its Layout's
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}
// y + a x, a lane of four
__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(__fmaf_rn(a, x.x, y.x), __fmaf_rn(a, x.y, y.y), __fmaf_rn(a, x.z, y.z),
                     __fmaf_rn(a, x.w, y.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// (value, index) a is better than b: larger, or equal at a lower index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// A rows m0 .. m0 + mt - 1 (row m at A + rows[m] * lda, or A + m * lda)
// times B^T (B [N, K] row-major): epi(m, n, value) for every m < m0 + mt,
// n < N, each pair once, by one lane.  Lane l of a warp always holds row
// m0 + l % kMT.  K and lda, ldb are multiples of 4.  All threads of all
// blocks call it; `As` is kMT * kKC floats of shared memory.
template <class Epi>
__device__ void gemm_nt(const float* A, long long lda, const int* rows, int m0, int mt,
                        const float* B, long long ldb, int N, int K, float* As, Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kTileRows = kWarps * kNR;
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int n_chunks = (K + kKC - 1) / kKC;
  auto stage = [&](int k0) {
    const int kc4 = min(kKC, K - k0) / 4;
    __syncthreads();  // the last user of As is done
    for (int i = threadIdx.x; i < kMT * kc4; i += kThreads) {
      const int m = i / kc4, k = (i % kc4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < mt) {
        const long long r = rows ? rows[m0 + m] : m0 + m;
        v = ld4(A + r * lda + k0 + k);
      }
      st4(As + m * kKC + k, v);
    }
    __syncthreads();
  };
  if (n_chunks == 1) stage(0);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int nb = tile * kTileRows + warp * kNR;
    float acc[kNR * kMT];
#pragma unroll
    for (int i = 0; i < kNR * kMT; ++i) acc[i] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * kKC;
      if (n_chunks > 1) stage(k0);
      const int kc = min(kKC, K - k0);
      const float* brow[kNR];
#pragma unroll
      for (int r = 0; r < kNR; ++r) brow[r] = B + (long long)min(nb + r, N - 1) * ldb + k0;
#pragma unroll 2
      for (int k = lane * 4; k < kc; k += 128) {
        float4 b[kNR];
#pragma unroll
        for (int r = 0; r < kNR; ++r) b[r] = ldg4(brow[r] + k);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const float4 a = ld4(As + m * kKC + k);
#pragma unroll
          for (int r = 0; r < kNR; ++r) acc[r * kMT + m] = dot4(a, b[r], acc[r * kMT + m]);
        }
      }
    }
    // lane l: the sum of acc[l] over the warp, row m0 + l % kMT, B row nb + l / kMT
    const float s = decode_attn::reduce_scatter<32, 5>(acc, lane);
    const int r = lane / kMT, m = lane % kMT;
    if (nb + r < N && m < mt) epi(m0 + m, nb + r, s);
  }
}

// A rows (row m at A + rows[m] * lda) times W (W [K, N] row-major) for m <
// M: partial sums over slice s of W's rows into part[s][m][n]; M <= kMT
// a call (m0 offsets the rows and the partials' rows).
__device__ void gemm_nn_part(const float* A, long long lda, const int* rows, int m0, int mt,
                             int M, const float* W, int N, int K, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WoSplit sp(N, K);
  const int groups = (N + 127) / 128;
  const int items = groups * sp.ks;
  for (int it = blockIdx.x * kWarps + warp; it < items; it += gridDim.x * kWarps) {
    const int g = it % groups, s = it / groups;
    const int n = g * 128 + lane * 4;
    const int j1 = min(K, (s + 1) * sp.slice);
    float4 acc[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N) {
      const float* arow[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        arow[m] = A + (long long)(rows ? rows[m0 + min(m, mt - 1)] : m0 + min(m, mt - 1)) * lda;
#pragma unroll 2
      for (int j = s * sp.slice; j < j1; j += 4) {
        const float4 w0 = ldg4(W + (long long)j * N + n);
        const float4 w1 = ldg4(W + (long long)(j + 1) * N + n);
        const float4 w2 = ldg4(W + (long long)(j + 2) * N + n);
        const float4 w3 = ldg4(W + (long long)(j + 3) * N + n);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          if (m < mt) {  // warp-uniform
            const float4 a = ld4(arow[m] + j);
            acc[m] = axpy4(a.w, w3, axpy4(a.z, w2, axpy4(a.y, w1, axpy4(a.x, w0, acc[m]))));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        if (m < mt) st4(part + ((long long)s * M + m0 + m) * N + n, acc[m]);
    }
  }
}

// y[m][n] = the partial sums over the slices, in slice order
__device__ void reduce_parts(const float* part, int ks, int M, int N, float* y) {
  const long long n4 = (long long)M * N / 4;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    float4 s = ld4(part + i * 4);
    for (int k = 1; k < ks; ++k) s = add4(s, ld4(part + ((long long)k * M * N) + i * 4));
    st4(y + i * 4, s);
  }
}

struct ArgmaxEpi {
  float best = kNegInf;
  int idx = 0x7fffffff;
  __device__ void operator()(int, int n, float v) {
    if (better(v, n, best, idx)) {
      best = v;
      idx = n;
    }
  }
};

// The readout of y's rows 0 .. M - 1: argmax over n < vocab of y[m] . E[n];
// block 0's thread m gets row m's token in tok[m] (shared memory), after
// the grid sync this function ends with
__device__ void readout_argmax(const LmArgs& a, const Layout& L, int M, float* As, int* tok,
                               cg::grid_group& grid) {
  __shared__ float rv[kWarps][kMT];
  __shared__ int ri[kWarps][kMT];
  float* aval = a.ws + L.aval;
  int* aidx = reinterpret_cast<int*>(a.ws + L.aidx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m0 = 0; m0 < M; m0 += kMT) {
    const int mt = min(kMT, M - m0);
    ArgmaxEpi e;
    gemm_nt(a.ws + L.y, a.D, nullptr, m0, mt, a.w, a.D, a.vocab, a.D, As, e);
    // lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same row
#pragma unroll
    for (int off = kMT; off < 32; off <<= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, e.best, off);
      const int i = __shfl_xor_sync(0xffffffffu, e.idx, off);
      if (better(v, i, e.best, e.idx)) {
        e.best = v;
        e.idx = i;
      }
    }
    if (lane < kMT) {
      rv[warp][lane] = e.best;
      ri[warp][lane] = e.idx;
    }
    __syncthreads();
    if (threadIdx.x < mt) {
      float v = rv[0][threadIdx.x];
      int i = ri[0][threadIdx.x];
      for (int w = 1; w < kWarps; ++w)
        if (better(rv[w][threadIdx.x], ri[w][threadIdx.x], v, i)) {
          v = rv[w][threadIdx.x];
          i = ri[w][threadIdx.x];
        }
      aval[blockIdx.x * a.emit + m0 + threadIdx.x] = v;
      aidx[blockIdx.x * a.emit + m0 + threadIdx.x] = i;
    }
    __syncthreads();
  }
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x < M) {
    float v = kNegInf;
    int i = 0x7fffffff;
    for (int b = 0; b < (int)gridDim.x; ++b) {
      const float vb = aval[b * a.emit + threadIdx.x];
      const int ib = aidx[b * a.emit + threadIdx.x];
      if (better(vb, ib, v, i)) {
        v = vb;
        i = ib;
      }
    }
    tok[threadIdx.x] = i;
  }
}

// o Wo for the `n` rows listed at list (rows of o), then the readout: block
// 0's thread j gets the token of list[j] in tok[j]
__device__ void emit_tokens(const LmArgs& a, const Layout& L, const int* list, int n, float* As,
                            int* tok, cg::grid_group& grid) {
  const WoSplit sp(a.D, a.HQ);
  const float* wo = a.w + a.o0 * a.D;
  for (int m0 = 0; m0 < n; m0 += kMT)
    gemm_nn_part(a.ws + L.o, a.HQ, list, m0, min(kMT, n - m0), n, wo, a.D, a.HQ, a.ws + L.part);
  grid.sync();
  reduce_parts(a.ws + L.part, sp.ks, n, a.D, a.ws + L.y);
  grid.sync();
  readout_argmax(a, L, n, As, tok, grid);
}

// A rows 0 .. M - 1 times B^T (A [M, K], B [N, K], both row-major, K and
// their rows 16-byte aligned), at f32 accuracy on the tensor cores:
// epi(m, n, d[m][n], d[m][n + 1]) for every m < M and even n < N (N even),
// each pair once.  A work item is a pass's kPM rows by a band's kPN
// columns; the blocks stride over the items, band-minor.  All threads of
// all blocks call it; `smem` holds kPStages * (kPM + kPN) * kPPitch floats.
template <class Epi>
__device__ void proj_tc(const float* A, int M, const float* B, int N, int K, float* smem,
                        Epi& epi) {
  using flash_attn::Split;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // the fragments' row group and column
  const int wm = warp % (kPM / kWM), wn = warp / (kPM / kWM);
  constexpr int kMi = kWM / 16, kNi = kWN / 8;  // m16 and n8 tiles a warp
  constexpr int kUnits = kPK / 4;               // 16-byte units of a staged row
  const int bands = (N + kPN - 1) / kPN, items = (M + kPM - 1) / kPM * bands;
  const int n_k = (K + kPK - 1) / kPK;
  float* As = smem;
  float* Bs = smem + kPStages * kPM * kPPitch;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int m0 = item / bands * kPM, n0 = item % bands * kPN;
    const int mt = min(kPM, M - m0);
    // stage s <- columns [kt kPK, (kt + 1) kPK) of A's pass rows and B's
    // band (rows past M are left as they are: their outputs are never
    // stored; rows past N read row N - 1; columns past K are zeros)
    auto load = [&](int s, int kt) {
      if (kt < n_k) {
        float* as = As + s * kPM * kPPitch;
        float* bs = Bs + s * kPN * kPPitch;
        for (int i = tid; i < (kPM + kPN) * kUnits; i += kThreads) {
          const int r = i / kUnits, k = kt * kPK + i % kUnits * 4;
          float* dst;
          const float* src;
          if (r < kPM) {
            if (r >= mt) continue;
            dst = as + r * kPPitch + i % kUnits * 4;
            src = A + (long long)(m0 + r) * K + k;
          } else {
            dst = bs + (r - kPM) * kPPitch + i % kUnits * 4;
            src = B + (long long)min(n0 + r - kPM, N - 1) * K + k;
          }
          if (k < K)
            flash_attn::cp_async16(dst, src);
          else
            st4(dst, make_float4(0.f, 0.f, 0.f, 0.f));
        }
      }
      flash_attn::cp_async_commit();  // an empty group past K keeps the count
    };
    float acc[kMi][kNi][4];
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int j = 0; j < kNi; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const bool active = wm * kWM < mt;  // warp-uniform: the warp has rows
    __syncthreads();                    // the last user of the stages is done
#pragma unroll
    for (int s = 0; s < kPStages - 1; ++s) load(s, s);
    for (int kt = 0; kt < n_k; ++kt) {
      flash_attn::cp_async_wait<kPStages - 2>();
      __syncthreads();  // stage kt is in; stage kt - 1 is consumed by all
      load((kt + kPStages - 1) % kPStages, kt + kPStages - 1);
      if (!active) continue;
      const float* as = As + (kt % kPStages) * kPM * kPPitch + wm * kWM * kPPitch;
      const float* bs = Bs + (kt % kPStages) * kPN * kPPitch + wn * kWN * kPPitch;
      // the stage's sums start from 0 and are added to acc in f32: the
      // tensor cores' accumulate truncates, and 3 K/8 accumulates in a row
      // (1536 at K 4096) drift by 2e-4 of the sum where 12 stay near 1e-6
      float part[kMi][kNi][4];
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNi; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      // one k-step of 8 at a time (unrolled, the steps' fragments would all
      // be live at once beside the 96 sums and spill); the three products
      // term by term over the 12 tiles, so that no product waits on the
      // one before it
#pragma unroll 1
      for (int kk = 0; kk < kPK; kk += 8) {
        Split af[kMi][4], bf[kNi][2];
#pragma unroll
        for (int i = 0; i < kMi; ++i) {
          const float* p = as + (i * 16 + g) * kPPitch + kk + c;
          af[i][0] = flash_attn::split(p[0]);
          af[i][1] = flash_attn::split(p[8 * kPPitch]);
          af[i][2] = flash_attn::split(p[4]);
          af[i][3] = flash_attn::split(p[8 * kPPitch + 4]);
        }
#pragma unroll
        for (int j = 0; j < kNi; ++j) {
          const float* p = bs + (j * 8 + g) * kPPitch + kk + c;
          bf[j][0] = flash_attn::split(p[0]);
          bf[j][1] = flash_attn::split(p[4]);
        }
#pragma unroll
        for (int i = 0; i < kMi; ++i)  // small terms first, as mma3
#pragma unroll
          for (int j = 0; j < kNi; ++j)
            flash_attn::mma(part[i][j], af[i][0].lo, af[i][1].lo, af[i][2].lo, af[i][3].lo,
                            bf[j][0].hi, bf[j][1].hi);
#pragma unroll
        for (int i = 0; i < kMi; ++i)
#pragma unroll
          for (int j = 0; j < kNi; ++j)
            flash_attn::mma(part[i][j], af[i][0].hi, af[i][1].hi, af[i][2].hi, af[i][3].hi,
                            bf[j][0].lo, bf[j][1].lo);
#pragma unroll
        for (int i = 0; i < kMi; ++i)
#pragma unroll
          for (int j = 0; j < kNi; ++j)
            flash_attn::mma(part[i][j], af[i][0].hi, af[i][1].hi, af[i][2].hi, af[i][3].hi,
                            bf[j][0].hi, bf[j][1].hi);
      }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNi; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    flash_attn::cp_async_wait<0>();  // only empty groups remain
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const int m = m0 + wm * kWM + i * 16 + g, n = n0 + wn * kWN + j * 8 + 2 * c;
        if (n >= N) continue;
        if (m < M) epi(m, n, acc[i][j][0], acc[i][j][1]);
        if (m + 8 < M) epi(m + 8, n, acc[i][j][2], acc[i][j][3]);
      }
  }
}

// the projections' stores.  M4's chunk: q to the workspace (row m of the
// chunk: segment m / (PB C), batch row (m / C) % PB, position m % C of the
// segment); k and v into k_new / v_new at the segments' positions, two
// neighbouring columns at a time (HQ and KVD are even)
struct ChunkQkv {
  const LmArgs* a;
  float* q;
  int start;  // the chunk's first position
  __device__ void operator()(int m, int n, float v0, float v1) {
    const float2 v = make_float2(v0, v1);
    if (n < a->HQ) {
      *reinterpret_cast<float2*>(q + (long long)m * a->HQ + n) = v;
      return;
    }
    const int seg_rows = a->PB * a->C, r = m % seg_rows;
    const int pos = start + m / seg_rows * a->C + r % a->C;
    const long long row = ((long long)(r / a->C) * a->P + pos) * a->KVD;
    if (n < a->HQ + a->KVD)
      *reinterpret_cast<float2*>(a->k_new + row + n - a->HQ) = v;
    else
      *reinterpret_cast<float2*>(a->v_new + row + n - a->HQ - a->KVD) = v;
  }
};

// M5's: q to the workspace, k and v into the pools at each row's page
struct DecodeQkv {
  const LmArgs* a;
  float* q;
  const int* bid;
  const int* off;
  __device__ void operator()(int m, int n, float v) {
    if (n < a->HQ) {
      q[(long long)m * a->HQ + n] = v;
      return;
    }
    const long long row = ((long long)bid[m] * a->BS + off[m]) * a->KVD;
    if (n < a->HQ + a->KVD)
      a->k_pool[row + n - a->HQ] = v;
    else
      a->v_pool[row + n - a->HQ - a->KVD] = v;
  }
};

// M4's chunk of segments c0 .. c0 + n - 1, first phases: x for every row
// of the chunk, the chunk's emitting rows, then the projections of all its
// rows in one pass over Wq/Wk/Wv (ceil(rows / kPM) when rows > kPM)
__device__ void prefill_chunk_begin(const LmArgs& a, const Layout& L, int c0, int n, char* smem,
                                    cg::grid_group& grid) {
  const int start = c0 * a.C, seg_rows = a.PB * a.C, M = n * seg_rows;
  const int D4 = a.D / 4;
  float* x = a.ws + L.x;
  int* ints = reinterpret_cast<int*>(a.ws + L.ints);
  const long long gtid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gthreads = (long long)gridDim.x * kThreads;
  // x = E[tok] + pe[pos], 0 past the row's prompt
  for (long long i = gtid; i < (long long)M * D4; i += gthreads) {
    const int m = (int)(i / D4), d = (int)(i % D4) * 4;
    const int r = m % seg_rows, b = r / a.C, pos = start + m / seg_rows * a.C + r % a.C;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < a.meta[b * a.meta_stride]) {
      const int t = a.prompt[b * a.prompt_stride + pos];
      v = add4(ldg4(a.w + (long long)t * a.D + d), ldg4(a.w + (a.pe0 + pos) * a.D + d));
    }
    st4(x + (long long)m * a.D + d, v);
  }
  // the rows that emit in the chunk: prompt_len - 1 in [start, start + n C),
  // as rows of the chunk's o, and their out rows
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int k = 0;
    for (int b = 0; b < a.PB; ++b) {
      const int e = a.meta[b * a.meta_stride] - 1 - start;
      if (e >= 0 && e < n * a.C) {
        ints[kIList + k] = e / a.C * seg_rows + b * a.C + e % a.C;
        ints[kIList + a.emit + k] = b;
        ++k;
      }
    }
    ints[kICount] = k;
  }
  grid.sync();
  ChunkQkv epi{&a, a.ws + L.q, start};
  proj_tc(x, M, a.w + a.q0 * a.D, a.HQ + 2 * a.KVD, a.D, reinterpret_cast<float*>(smem), epi);
  grid.sync();
}

// M4's segment c, the j-th of its chunk: B2's causal flash body over keys
// [0, start + C) at q_offset start, on the segment's rows of q and o
__device__ void prefill_attend(const LmArgs& a, const Layout& L, int c, int j, char* smem,
                               cg::grid_group& grid) {
  const int start = c * a.C;
  const long long at = (long long)j * a.PB * a.C * a.HQ;
  const long long qs = a.C * (long long)a.HQ, ks = a.P * (long long)a.KVD;
  const flash_attn::Args<float> fa{a.ws + L.q + at, qs, a.hd, a.HQ, a.k_new, ks, a.hd, a.KVD,
                                   a.v_new, ks, a.hd, a.KVD, a.ws + L.o + at, qs, a.hd, a.HQ,
                                   a.H, a.H / a.KV, a.C, a.P, a.hd, start, 1, -1, a.hpb,
                                   a.scale, a.kv_vec != 0, a.q_vec != 0};
  const int gx = (a.C + flash_attn::kRows / a.hpb - 1) / (flash_attn::kRows / a.hpb);
  const int gy = a.KV * (a.H / a.KV / a.hpb);
  const int total = gx * gy * a.PB;
  for (int vb = blockIdx.x; vb < total; vb += gridDim.x) {
    if (vb != (int)blockIdx.x) __syncthreads();  // the last tile's smem is consumed
    flash_attn::flash_block<float>(fa, smem, vb % gx, (vb / gx) % gy, vb / (gx * gy));
  }
  grid.sync();
}

// M4's chunk, last phase: o Wo and the readout of the chunk's emitting
// rows, their tokens into out[row, 0]
__device__ void prefill_chunk_end(const LmArgs& a, const Layout& L, char* smem, int* tok,
                                  cg::grid_group& grid) {
  const int* ints = reinterpret_cast<const int*>(a.ws + L.ints);
  const int n = ints[kICount];  // written before the chunk's first sync
  if (n == 0) return;
  emit_tokens(a, L, ints + kIList, n, reinterpret_cast<float*>(smem), tok, grid);
  if (blockIdx.x == 0 && threadIdx.x < n)
    a.out[ints[kIList + a.emit + threadIdx.x] * a.out_stride] = tok[threadIdx.x];
  grid.sync();  // the emit list is read before the next chunk writes it
}

template <int GT>
__device__ void decode_tile(const LmArgs& a, const Layout& L, const decode_attn::PagedRows& pr,
                            const int* posa, int bx, int b, float* smem) {
  decode_attn::decode_block<GT, true, false>(a.ws + L.q, a.HQ, a.hd, pr, posa, a.ws + L.o, a.H,
                                             a.H / a.KV, a.T_blk * a.BS, a.hd, -1, a.scale, bx,
                                             b, a.nw, smem);
}

// M5's step t
__device__ void decode_step(const LmArgs& a, const Layout& L, int t, char* smem, int* tok,
                            cg::grid_group& grid) {
  const int D4 = a.D / 4;
  float* x = a.ws + L.x;
  int* ints = reinterpret_cast<int*>(a.ws + L.ints);
  int* posa = ints + kIList + 2 * a.emit;  // keys a row attends: posc + 1, 0 when dead
  int* bid = posa + a.rows;                // the page and offset this step writes
  int* off = bid + a.rows;
  const long long gtid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gthreads = (long long)gridDim.x * kThreads;
  auto live_row = [&](int s, int& pos) {
    const int* row = a.table + s * a.table_stride;
    pos = row[kColSeqLen];
    return row[kColActive] == 1 && t < row[kColNEmit];
  };
  for (long long i = gtid; i < (long long)a.S * D4; i += gthreads) {
    const int s = (int)(i / D4), d = (int)(i % D4) * 4;
    int pos;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live_row(s, pos)) {
      const int posc = min(max(pos, 0), a.max_ctx - 1);
      const int tk = a.table[s * a.table_stride + kColLastTok];
      v = add4(ldg4(a.w + (long long)tk * a.D + d), ldg4(a.w + (a.pe0 + posc) * a.D + d));
    }
    st4(x + (long long)s * a.D + d, v);
  }
  for (long long s = gtid; s < a.S; s += gthreads) {
    int pos;
    const bool live = live_row((int)s, pos);
    const int posc = min(max(pos, 0), a.max_ctx - 1);
    posa[s] = live ? posc + 1 : 0;
    bid[s] = live ? a.table[s * a.table_stride + kTableMeta + posc / a.BS] : 0;
    off[s] = live ? posc % a.BS : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int n = 0;
    for (int s = 0; s < a.S; ++s) {
      int pos;
      if (live_row(s, pos)) ints[kIList + n++] = s;
    }
    ints[kICount] = n;
  }
  grid.sync();
  const int n = ints[kICount];  // read here: the next step writes it after 2 syncs
  // the projections: q to the workspace, k and v into the pools
  {
    DecodeQkv epi{&a, a.ws + L.q, bid, off};
    for (int m0 = 0; m0 < a.S; m0 += kMT)
      gemm_nt(x, a.D, nullptr, m0, min(kMT, a.S - m0), a.w + a.q0 * a.D, a.D,
              a.HQ + 2 * a.KVD, a.D, reinterpret_cast<float*>(smem), epi);
  }
  grid.sync();
  if (n == 0) return;
  // B3's paged body over the live rows' posc + 1 keys
  {
    const decode_attn::PagedRows pr{a.k_pool, a.v_pool, a.table + kTableMeta, a.table_stride,
                                    a.NB, a.BS, a.KV, a.hd};
    const int gx = a.KV * (a.H / a.KV / a.gt) * ((a.hd + decode_attn::kTile - 1) /
                                                 decode_attn::kTile);
    float* fs = reinterpret_cast<float*>(smem);
    bool first = true;
    for (int vb = blockIdx.x; vb < gx * a.S; vb += gridDim.x) {
      const int b = vb / gx;
      if (posa[b] == 0) continue;  // a dead row: its output is never read
      if (!first) __syncthreads();  // the last tile's smem is consumed
      first = false;
      switch (a.gt) {
        case 1: decode_tile<1>(a, L, pr, posa, vb % gx, b, fs); break;
        case 2: decode_tile<2>(a, L, pr, posa, vb % gx, b, fs); break;
        case 4: decode_tile<4>(a, L, pr, posa, vb % gx, b, fs); break;
        default: decode_tile<8>(a, L, pr, posa, vb % gx, b, fs); break;
      }
    }
  }
  grid.sync();
  emit_tokens(a, L, ints + kIList, n, reinterpret_cast<float*>(smem), tok, grid);
  if (blockIdx.x == 0 && threadIdx.x < n) {
    const int s = ints[kIList + threadIdx.x];
    int* row = a.table + s * a.table_stride;
    a.out[s * a.out_stride + t] = tok[threadIdx.x];
    row[kColLastTok] = tok[threadIdx.x];
    row[kColSeqLen] = row[kColSeqLen] + 1;
  }
  grid.sync();  // the table is read by the next step
}

// kDecode = false: M4 (AttnPrefill); true: M5 (AttnDecode)
template <bool kDecode>
__global__ void __launch_bounds__(kThreads, 1) attn_mega_kernel(const LmArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int tok[kMaxRows];
  cg::grid_group grid = cg::this_grid();
  const Layout L(a.rows, a.emit, a.D, a.HQ);
  int* ints = reinterpret_cast<int*>(a.ws + L.ints);
  const int n_steps = kDecode ? a.R : a.P / a.C;
  Ctx c = a.ctx;
  int n_chunks = 0, steps = 0, status = 0, stop = 0;
  while (c.done == 0 && stop == 0) {
    if (n_chunks == a.max_chunks) {  // never on a right control flow
      status = 1;
      break;
    }
    c.budget = a.budget;  // ctx.with_budget(budget)
    c.intr = 0;
    // for_save(ctx, SLOT_POS, 0, n_steps, 1, body)
    c.init_var[kSlotPos] = 0;  // declare
    c.incr_var[kSlotPos] = 1;
    int i = c.saved[kSlotPos] == 1 ? c.var[kSlotPos] : 0;  // resume_value
    c.saved[kSlotPos] = 0;                                  // unsave
    // M4: the loop below runs min(budget, n_steps - i) segments (its body
    // never interrupts), so their x and projections come first and their
    // readouts after it
    const int i0 = i;
    if (!kDecode && i < n_steps) prefill_chunk_begin(a, L, i, min(c.budget, n_steps - i), smem, grid);
    while (i < n_steps && c.budget > 0 && c.intr == 0) {
      c.intr = 0;  // clear_intr
      if (kDecode)
        decode_step(a, L, i, smem, tok, grid);  // body_t
      else
        prefill_attend(a, L, i, i - i0, smem, grid);  // body_c
      c.var[kSlotPos] = i + 1;  // checkpoint(SLOT_POS, i + 1)
      c.saved[kSlotPos] = 1;
      const bool ok = c.intr == 0;  // the body holds no loop: always
      c.budget -= 1;                // dec_budget
      if (ok) i += 1;
      ++steps;
    }
    if (!kDecode && i > i0) prefill_chunk_end(a, L, smem, tok, grid);
    const bool completed = i >= n_steps;
    if (completed) {  // clear(SLOT_POS)
      c.var[kSlotPos] = 0;
      c.saved[kSlotPos] = 0;
    }
    c.intr = completed ? 0 : 1;  // mark_intr
    if (c.intr == 0) c.done = 1;  // ctx.finish()
    ++n_chunks;
    // the chunk boundary: once every block has finished the chunk, one
    // thread tells the host how far the launch got, reads the host's word
    // and publishes the decision, so a host write landing meanwhile cannot
    // split the grid.  Two slots: a block still reading the last boundary's
    // never sees this one's write
    grid.sync();
    int* decision = ints + kIDecision + (n_chunks & 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *reinterpret_cast<volatile int*>(a.progress) = n_chunks;
      const int f = load_flag(a.flag);
      *reinterpret_cast<volatile int*>(decision) = (f != 0 && n_chunks >= f) ? 1 : 0;
    }
    grid.sync();
    stop = *reinterpret_cast<volatile int*>(decision);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    mega::write_ctx(a.words, c);
    a.words[kOutChunks] = n_chunks;
    a.words[kOutSteps] = steps;
    a.words[kOutStatus] = status;
  }
}

// the geometry every entry checks; 0 when it is one the kernels take
bool bad_geometry(int D, int vocab, int H, int KV, int hd) {
  return D <= 0 || D % 4 || vocab <= 0 || H <= 0 || KV <= 0 || H % KV || hd <= 0 ||
         hd > flash_attn::kMaxHd || hd % 4;
}

void fill_common(LmArgs& a, const int* ctx, const float* w, int D, int vocab, int H, int KV,
                 int hd, int max_ctx, float scale, int* out, long long out_stride, float* ws,
                 int budget, int max_chunks, const int* flag, int* progress, int* words) {
  a.ctx = mega::read_ctx(ctx);
  a.w = w;
  a.pe0 = vocab;
  a.q0 = vocab + max_ctx;
  a.o0 = a.q0 + (long long)H * hd + 2LL * KV * hd;
  a.D = D;
  a.vocab = vocab;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.HQ = H * hd;
  a.KVD = KV * hd;
  a.max_ctx = max_ctx;
  a.scale = scale;
  a.out = out;
  a.out_stride = out_stride;
  a.ws = ws;
  a.budget = budget;
  a.max_chunks = max_chunks;
  a.flag = flag;
  a.progress = progress;
  a.words = words;
}

size_t gemm_smem() { return (size_t)kMT * kKC * sizeof(float); }
size_t proj_smem() { return (size_t)kPStages * (kPM + kPN) * kPPitch * sizeof(float); }

// the dynamic shared memory of a launch: the largest of the staged A rows,
// M4's projection stages and B2's block (M4), or of the A rows and B3's
// block (M5)
size_t smem_of(bool decode, int hd, int gt, int warps, int keys) {
  size_t own = decode ? decode_attn::smem_bytes(gt, warps, hd, keys)
                      : flash_attn::smem_bytes(hd, 4);
  if (!decode && proj_smem() > own) own = proj_smem();
  return own > gemm_smem() ? own : gemm_smem();
}

// The grid: the co-resident blocks over kRegionsSharing (at least 1, at most
// kMaxGrid); info gets it, the cap and the co-resident blocks
template <bool kDecode>
int grid_of(size_t smem, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = attn_mega_kernel<kDecode>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int coresident = per_sm * sms;
  if (coresident < 1) return (int)cudaErrorInvalidConfiguration;
  const int cap = coresident / kRegionsSharing > 0 ? coresident / kRegionsSharing : 1;
  info[0] = cap < kMaxGrid ? cap : kMaxGrid;
  info[1] = cap;
  info[2] = coresident;
  return 0;
}

template <bool kDecode>
int launch(const LmArgs& a, size_t smem, int device, void* stream) {
  int info[3];
  const int err = grid_of<kDecode>(smem, device, info);
  if (err != 0) return err;
  LmArgs arg = a;
  void* params[] = {&arg};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(attn_mega_kernel<kDecode>), dim3(info[0]), dim3(kThreads),
      params, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The workspace floats a launch needs: M4 with rows = min(budget, P / C) *
// PB * C (a chunk's) and emit = PB, M5 with rows = emit = S.
extern "C" long long attn_lm_workspace(int rows, int emit, int D, int H, int hd) {
  if (rows <= 0 || emit <= 0 || D <= 0 || H <= 0 || hd <= 0) return -1;
  return Layout(rows, emit, D, H * hd).total;
}

// The grid a launch takes, its cap and the co-resident blocks, into info:
// M4 (decode 0) at head dim hd, M5 (decode 1) with B3's plan gt/warps over
// `keys` paged keys a row.  Returns a cudaError_t.
extern "C" int attn_lm_grid(int decode, int hd, int gt, int warps, int keys, int device,
                            int* info) {
  if (hd <= 0 || hd > flash_attn::kMaxHd) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_of(decode != 0, hd, gt, warps, keys);
  return decode ? grid_of<true>(smem, device, info) : grid_of<false>(smem, device, info);
}

extern "C" int attn_prefill_mega(const int* ctx, int* out, long long out_stride, float* k_new,
                                 float* v_new, const int* prompt, long long prompt_stride,
                                 const int* meta, long long meta_stride, const float* w,
                                 float* ws, long long ws_floats, int PB, int P, int D, int vocab,
                                 int H, int KV, int hd, int C, int max_ctx, int hpb, float scale,
                                 int budget, int max_chunks, const int* flag, int* progress,
                                 int* words, int device, void* stream) {
  if (bad_geometry(D, vocab, H, KV, hd) || PB <= 0 || PB > kMaxRows || C <= 0 || P <= 0 ||
      P % C || max_ctx <= 0 || hpb < 1 || flash_attn::kRows % hpb || (H / KV) % hpb ||
      budget <= 0 || max_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = (budget < P / C ? budget : P / C) * PB * C;  // a chunk's
  const Layout L(rows, PB, D, H * hd);
  if (ws_floats < L.total) return (int)cudaErrorInvalidValue;
  LmArgs a = {};
  fill_common(a, ctx, w, D, vocab, H, KV, hd, max_ctx, scale, out, out_stride, ws, budget,
              max_chunks, flag, progress, words);
  a.k_new = k_new;
  a.v_new = v_new;
  a.prompt = prompt;
  a.prompt_stride = prompt_stride;
  a.meta = meta;
  a.meta_stride = meta_stride;
  a.PB = PB;
  a.P = P;
  a.C = C;
  a.hpb = hpb;
  const long long qs = (long long)C * H * hd, ks = (long long)P * KV * hd;
  a.q_vec = flash_attn::aligned(ws + L.q, qs, hd, (long long)H * hd, 16, 4);
  a.kv_vec = flash_attn::aligned(k_new, ks, hd, (long long)KV * hd, 16, 4) &&
             flash_attn::aligned(v_new, ks, hd, (long long)KV * hd, 16, 4);
  a.rows = rows;
  a.emit = PB;
  return launch<false>(a, smem_of(false, hd, 0, 0, 0), device, stream);
}

extern "C" int attn_decode_mega(const int* ctx, int* out, long long out_stride, float* k_pool,
                                float* v_pool, int NB, int BS, int* table,
                                long long table_stride, int T_blk, const float* w, float* ws,
                                long long ws_floats, int S, int R, int D, int vocab, int H,
                                int KV, int hd, int max_ctx, int gt, int warps, float scale,
                                int budget, int max_chunks, const int* flag, int* progress,
                                int* words, int device, void* stream) {
  if (bad_geometry(D, vocab, H, KV, hd) || S <= 0 || S > kMaxRows || R < 0 || NB <= 0 ||
      BS <= 0 || T_blk <= 0 || max_ctx <= 0 || max_ctx > T_blk * BS ||
      (gt != 1 && gt != 2 && gt != 4 && gt != 8) || (H / KV) % gt || warps < 1 ||
      warps > decode_attn::kMaxWarps || budget <= 0 || max_chunks <= 0 ||
      (long long)NB * BS * KV >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Layout L(S, S, D, H * hd);
  if (ws_floats < L.total) return (int)cudaErrorInvalidValue;
  LmArgs a = {};
  fill_common(a, ctx, w, D, vocab, H, KV, hd, max_ctx, scale, out, out_stride, ws, budget,
              max_chunks, flag, progress, words);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.NB = NB;
  a.BS = BS;
  a.table = table;
  a.table_stride = table_stride;
  a.T_blk = T_blk;
  a.S = S;
  a.R = R;
  a.gt = gt;
  a.nw = warps;
  a.rows = S;
  a.emit = S;
  return launch<true>(a, smem_of(true, hd, gt, warps, T_blk * BS), device, stream);
}
