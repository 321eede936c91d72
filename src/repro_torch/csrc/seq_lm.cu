// M2 and M3, the persistent surrogate-LM serving kernels, for Hopper
// (sm_90a).
//
// Counterparts of the reference's `make_megakernel`
// (src/repro/core/preemption.py:174, a jitted `lax.while_loop` over a
// kernel's chunk body that runs on its CPU backend only; not a
// `pallas_call`) applied to `seq_prefill` and `seq_decode`
// (src/repro/serving/kernels.py:106,133).  One launch runs the task's whole
// remaining chunk loop with the context on the card and polls the region's
// mapped preempt flag at every chunk boundary, as M1 (csrc/blur.cu) does for
// the blur tasks.
//
// The model is the deterministic integer surrogate LM of
// serving/kernels.py, wrapping int32 throughout:
//   state' = state * MIX_A + tok * (2*pos + 1) + pos * PHI + MIX_C
//   token  = ((sum(state') * MIX_A + MIX_C) & 0x7fffffff) % vocab
// Signed overflow is undefined in C++, so every product and sum is taken in
// uint32_t and cast back: the same bits mod 2^32 as the reference's wrap.
// The row sum is a warp's lanes' partial sums added by `__shfl_xor_sync`;
// addition mod 2^32 is associative and commutative, so any order gives the
// bits of `torch.sum(..., dtype=torch.int32)`.
//
// Interface (plain C, loaded with ctypes; see kernels/seq_lm/kernel.py):
//   seq_prefill_mega(ctx, out, state, prompt, d, prompt_len, vocab, budget,
//                    max_chunks, resident, flag, progress, words, device,
//                    stream)
//     M2: SeqPrefill's for_save(SLOT_POS, 0, prompt_len, 1), a prompt
//     position folded into state i32[1, d] per budget unit; on completion
//     the token of state goes to out[0] and the context is finished.
//   seq_decode_mega(ctx, out, out_stride, state, state_stride, slots,
//                   slots_stride, s, d, r, vocab, budget, max_chunks,
//                   resident, flag, progress, words, device, stream)
//     M3: one decode round, SeqDecode's for_save(SLOT_POS, 0, r, 1) over s
//     slot rows.  Row i takes part in step t iff slots[i][0] == 1 (active)
//     and t < slots[i][1] (n_emit); a live row updates state[i],
//     out[i][t] and slots[i][2] (the last token) in place, the other rows
//     are left untouched.
// `ctx` is the 36 host context words (ContextRecord.to_words), passed by
// value; `resident` (0 or 1) whether the rows are held in shared memory
// (kernel.py's `plan` decides); `flag` and `progress` the mapped host words
// of csrc/preempt_flag.cu; `words` receives kOutWords device words: the
// context words, the chunks run, the steps run and the status (0, or 1 when
// the launch reached `max_chunks` undone).  Strides are in int32 elements;
// the last dim of every buffer is contiguous.  The launch goes on the
// caller's stream; the functions return a cudaError_t.
//
// Geometry: one block of compute warps and one watcher warp.  A compute
// warp walks `rows_per_warp` slot rows (rows w, w + C, ... for C compute
// warps), the lanes looping over d: a row a warp up to 31 rows, else the
// fewest rows a warp that fit in 31 warps (2 at s = 32, 5 at s = 128), so
// the watcher has the 32nd warp of the 1024 threads (kernel.py `plan`).
// M2 is one compute warp and the watcher.  The kernel is compiled for each
// row count a warp can walk (1 to 5), so a step walks exactly its warp's
// rows with no run-time guard.  Rows are independent, so no
// grid sync is needed, and one block leaves room for every other region's
// launch.  Why a warp of its own for the flag: a warp that computes with a
// read of the host's word in flight was measured to wait for that read, at
// a barrier (which waits for the reads of the warps it holds: the probe's
// `bar_after_read` is a whole flag read) and, as the compiler scheduled
// it, inside M3's step on shared memory (`m3_chunk_under_read` is the read
// and the step end to end), so the read held back the step it was meant
// to hide under; the watcher computes nothing and waits only for the read.
//
// Where the state lives: each compute warp loads its rows from global
// memory into shared memory once, at launch, and writes back once, at exit
// (preempted or done), the rows the launch stepped, when the s*d*4 bytes
// fit (`resident`: up to 224 KiB, so every s <= 128 at d = 384); else the
// rows stay in global memory and the steps read and write them there.
// Each warp touches only its own rows, so the state needs no barrier.  M3
// reads the active and n_emit columns once, keeps each row's last token in
// a register, writes out[row][t] at every step it takes and slots[row][2]
// once at exit; a warp's rows' sums are added across the lanes together,
// their shuffles interleaved, and the token's modulo uses a reciprocal
// taken once.  M2's prompt is read 32 tokens ahead: each lane holds one
// token of the current 32-token block and one of the next, loaded a block
// ahead, and a step takes its token from a shuffle, so no step waits on a
// global load.
//
// Control: the for_save loop of core/preemption.py is kept in closed form.
// A chunk from position i runs min(budget, n - i) steps (none if i >= n);
// the 36 context words after a launch follow from the resume value, the
// steps of its last chunk and whether the task completed (with_budget,
// declare, resume_value/unsave, checkpoint, dec_budget, clear, mark_intr,
// finish: `exit_ctx`), so a chunk carries two integers, not the record.
//
// Boundary: the stop rule is the reference's: at least one chunk unless the
// context is already done, then an exit at the first boundary k >= flag when
// flag != 0; the progress word ends equal to the chunks run.  The watcher
// reads the flag once the launch has started; that read decides boundary
// 1, so a flag armed before the launch stops it at boundary 1 exactly.
// After chunk k, compute warp 0 stores k to the progress word and reports
// k to the watcher in shared memory; the watcher then reads the flag again
// (`ld.relaxed.sys`: the word carries no data the kernel reads afterwards,
// so the read needs freshness, not acquire order) and publishes the value,
// which decides boundary k + 1.  Every compute warp waits at boundary k for
// the value that decides it and applies the stop rule itself (a later
// boundary's value means k ran on), so all stop at the same boundary with
// no barrier in the loop.  The next chunk's steps run while the watcher's
// read is in flight: a chunk takes one flag read, however few steps it has.
// A flag written into a running launch stops it at most 2 boundaries past
// the progress the host read after its write: the host read k, so the store
// of k + 1, and the read issued after it, reach host memory after the
// write; that read decides boundary k + 2.  That needs the progress store
// and the read after it to reach the host in order.  They leave the SM in
// that order (the read is issued after the watcher sees the report that
// follows the store) and PCIe keeps a read behind the writes before it;
// nothing is fenced between them, since a `fence.sc.sys` after the store
// costs 1.5-1.7 us, more than a whole flag read (`seq_latency_probe`
// times it).  chip_smoke.py's [decode] and tests/test_torch_cuda.py check
// the 2 boundaries on M2 and M3.
//
// Bound: latency.  A step moves s*d*4*2 bytes (the state read and written):
// 98 KB at s = 32, d = 384, 29 ns at 3.35 TB/s; a launch must move each row
// once each way.  Its floor is one flag read a chunk (about 1.0-1.3 us over
// PCIe, measured by `seq_latency_probe`): at budget 1 a chunk is one step,
// whose dependent chain (M2: a multiply-add on its row; M3: the
// multiply-add, a lane's d/32 adds, 5 shuffle-adds, the token's modulo)
// runs under that read.  With the rows in shared memory a step's 98 KB
// pass through the SM's shared memory at 128 bytes a cycle (about 0.39 us
// at 32 slots), so M3's chunk outlasts the read from budget 2 on.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mega.cuh"

namespace {

using mega::Ctx;
using mega::kCtxWords;
using mega::issue_flag_read;
using mega::load_flag;
using mega::store_progress;

constexpr int kSlotPos = 0;                 // serving/kernels.py SLOT_POS
constexpr int kOutChunks = kCtxWords;       // chunks this launch ran
constexpr int kOutSteps = kCtxWords + 1;    // for_save iterations it ran
constexpr int kOutStatus = kCtxWords + 2;   // 0, or 1: hit max_chunks undone
// kOutWords = kCtxWords + 3 (kernels/seq_lm/kernel.py OUT_WORDS)
constexpr int kColActive = 0, kColNEmit = 1, kColLastTok = 2;  // slots table
constexpr int kMaxWarps = 32;               // a block's 1024 threads
constexpr int kMaxRowsPerWarp = 5;          // 128 slot rows over 26 warps
// the most dynamic shared memory a resident launch may ask for: the SM's
// 227 KiB a block less 1 KiB for the static words
constexpr int kMaxResidentBytes = 232448 - 1024;

constexpr uint32_t kMixA = 1103515245u;
constexpr uint32_t kMixC = 12345u;
constexpr uint32_t kPhi = 2654435761u;      // PHI = -1640531535 as int32

struct SeqArgs {
  Ctx ctx;                   // the record at launch, by value
  int* out;                  // prefill: out[0]; decode: [s, r]
  int* state;                // [s, d]
  const int* prompt;         // prefill: [1, P]
  int* slots;                // decode: [s, 8]
  long long out_stride, state_stride, slots_stride;
  int s, d, n_steps, vocab, budget, max_chunks;
  int rows_per_warp;         // M3: rows a compute warp walks (kernel.py plan)
  const int* flag;           // the mapped host preempt word
  int* progress;             // the mapped host word of the chunks completed
  int* words;                // kOutWords device words
};

// The step's injected term for the element at `pos`, tok * (2*pos + 1) +
// pos * PHI + MIX_C, is tok + MIX_C + pos * (2*tok + PHI) mod 2^32: a lane
// starts it at its first element and adds 32 * (2*tok + PHI) per element.
struct Term {
  uint32_t at, stride;
  __device__ __forceinline__ Term(uint32_t tok, int lane) {
    const uint32_t m = 2u * tok + kPhi;
    at = tok + kMixC + (uint32_t)lane * m;
    stride = 32u * m;
  }
};

// One token folded into row `row` (a warp's lanes over d); returns this
// lane's part of the wrapped row sum of the new state.
__device__ __forceinline__ uint32_t fold_row_sum(uint32_t* row, int d, uint32_t tok, int lane) {
  Term term(tok, lane);
  uint32_t sum = 0;
#pragma unroll 4
  for (int j = lane; j < d; j += 32, term.at += term.stride) {
    const uint32_t v = row[j] * kMixA + term.at;
    row[j] = v;
    sum += v;
  }
  return sum;
}

// a warp's parts of a row sum added up, the same on every lane
__device__ __forceinline__ uint32_t warp_sum(uint32_t sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// One token folded into row `row`; returns the wrapped row sum of the new
// state, the same on every lane.
__device__ __forceinline__ uint32_t step_row(uint32_t* row, int d, uint32_t tok, int lane) {
  return warp_sum(fold_row_sum(row, d, tok, lane));
}

// the wrapped row sum of row `row`, the same on every lane
__device__ __forceinline__ uint32_t row_sum(const uint32_t* row, int d, int lane) {
  uint32_t sum = 0;
  for (int j = lane; j < d; j += 32) sum += row[j];
  return warp_sum(sum);
}

// x % vocab by a reciprocal taken once: q = umulhi(x, m) with
// m = floor((2^32 - 1) / vocab) is floor(x / vocab) or up to 2 below it, so
// x - q * vocab needs at most two corrections.
struct Modulo {
  uint32_t d, m;
  __device__ __forceinline__ explicit Modulo(int vocab)
      : d((uint32_t)vocab), m(0xffffffffu / (uint32_t)vocab) {}
  __device__ __forceinline__ uint32_t of(uint32_t x) const {
    uint32_t r = x - __umulhi(x, m) * d;
    if (r >= d) r -= d;
    if (r >= d) r -= d;
    return r;
  }
};

__device__ __forceinline__ int token_of(uint32_t sum, const Modulo& vocab) {
  return (int)vocab.of((sum * kMixA + kMixC) & 0x7fffffffu);
}

__device__ __forceinline__ void copy_row(uint32_t* dst, const uint32_t* src, int d, int lane) {
  for (int j = lane; j < d; j += 32) dst[j] = src[j];
}

// The context words after a launch that ran `n_chunks` chunks of for_save
// (SLOT_POS, 0, n, 1) from `c` at `budget`, its last chunk `last_steps`
// steps, ending at position `i` (completed: i >= n), word for word what
// the per-chunk control leaves: with_budget, declare, resume_value and
// unsave; per step checkpoint(SLOT_POS, i + 1) and dec_budget; clear on
// completion; mark_intr; finish.  A chunk that does not complete runs at
// least one step (budget >= 1), so it leaves the position saved.
__device__ __forceinline__ Ctx exit_ctx(Ctx c, int n_chunks, int budget, int last_steps, int i,
                                        bool completed) {
  if (n_chunks == 0) return c;
  c.budget = budget - last_steps;
  c.init_var[kSlotPos] = 0;
  c.incr_var[kSlotPos] = 1;
  c.var[kSlotPos] = completed ? 0 : i;
  c.saved[kSlotPos] = completed ? 0 : 1;
  c.intr = completed ? 0 : 1;
  if (completed) c.done = 1;
  return c;
}

__device__ __forceinline__ void store_shared_u64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.volatile.shared.u64 [%0], %1;" ::"r"((unsigned)__cvta_generic_to_shared(p)),
               "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_shared_u64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.volatile.shared.u64 %0, [%1];"
               : "=l"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// the stop rule at boundary k for the flag value f
__device__ __forceinline__ bool stops(int k, int f) { return f != 0 && k >= f; }

// The watcher: the block's last warp, which computes nothing.  It reads the
// flag (the read that decides boundary 1), then, each time compute warp 0
// reports boundary k (having stored k to the progress word first), reads it
// again unless the launch ends at k: the value that decides boundary k + 1.
// It reads nothing for a boundary the task cannot reach (the chunk before
// it completes the task), so the launch need not wait for that read.
// `done` holds the last boundary warp 0 reported (-k: the launch ends at
// k); `seen` the flag value that decides boundary k, with k in its high
// word.  Every lane reads (one request for the word); lane 0 writes.
__device__ __forceinline__ void watch(const SeqArgs& a, int i0, volatile int* done,
                                      unsigned long long* seen, int lane) {
  // the boundaries the task can reach: all but the chunk that completes it
  const long long left = (long long)a.n_steps - i0;
  const long long last = left <= 0 ? 0 : (left + a.budget - 1) / a.budget - 1;
  if (last < 1) return;
  int f = issue_flag_read(a.flag);
  if (lane == 0) store_shared_u64(seen, (1ull << 32) | (unsigned)f);
  for (int k = 1;; ++k) {
    int w;
    do {
      w = *done;
    } while (w >= 0 && w < k);
    if (w < 0 || stops(k, f) || k >= last) return;
    f = issue_flag_read(a.flag);
    if (lane == 0) store_shared_u64(seen, ((unsigned long long)(k + 1) << 32) | (unsigned)f);
  }
}

// kDecode = false: M2 (SeqPrefill); true: M3 (SeqDecode).  kResident: the
// rows live in shared memory for the launch.  The block is `compute` warps
// of kRows rows each (M2: one warp, one row) and the watcher.  kRows is a
// template argument so that a step walks exactly the warp's rows: guards
// on a run-time row count around every shuffle cost M3's step more than
// the rows' own arithmetic.
template <bool kDecode, bool kResident, int kRows>
__global__ void __launch_bounds__(kMaxWarps * 32) seq_mega_kernel(const SeqArgs a) {
  extern __shared__ uint32_t resident[];  // [s][d] when kResident
  __shared__ int done;                    // the watcher's words (`watch`)
  __shared__ unsigned long long seen;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int compute = (blockDim.x >> 5) - 1;  // the watcher is warp `compute`
  const int n = a.n_steps, d = a.d, budget = a.budget;
  if (a.ctx.done != 0) {  // no chunk: the record goes back as it came
    if (threadIdx.x == 0) {
      mega::write_ctx(a.words, a.ctx);
      a.words[kOutChunks] = 0;
      a.words[kOutSteps] = 0;
      a.words[kOutStatus] = 0;
    }
    return;
  }
  if (threadIdx.x == 0) {
    done = 0;
    seen = 0ull;
  }
  __syncthreads();  // the only barrier: the watcher's words are set
  const int i0 = a.ctx.saved[kSlotPos] == 1 ? a.ctx.var[kSlotPos] : 0;  // resume_value
  if (warp == compute) {
    watch(a, i0, &done, &seen, lane);
    return;
  }
  const Modulo vocab(a.vocab);

  // this warp's rows (M2: row 0), where their state lives, which of them
  // the launch steps, and M3's columns: a row takes step t iff t < until.
  // The slots reads and the rows' loads are all issued before any is used
  uint32_t* rows[kRows];
  int until[kRows];
  uint32_t last[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = warp + k * compute;
    const bool in = kDecode ? row < a.s : true;
    int active = 1;
    until[k] = INT_MAX;
    last[k] = 0u;
    if (kDecode && in) {
      const int* sl = a.slots + row * a.slots_stride;
      active = sl[kColActive];
      until[k] = sl[kColNEmit];
      last[k] = (uint32_t)sl[kColLastTok];
    }
    uint32_t* global_row = reinterpret_cast<uint32_t*>(a.state + row * a.state_stride);
    rows[k] = kResident ? resident + row * d : global_row;
    // every row in range, live or not, so the load waits on no slots read
    if (kResident && in) copy_row(rows[k], global_row, d, lane);
    if (!in || active != 1) until[k] = INT_MIN;
  }
  __syncwarp();

  // M2's prompt, a 32-token block a register: lane j holds token blk*32 + j
  // of the current block (cur) and of the next (nxt)
  int blk = i0 >> 5;
  uint32_t cur = 0u, nxt = 0u;
  if (!kDecode) {
    const int p0 = blk * 32 + lane, p1 = p0 + 32;
    if (p0 >= 0 && p0 < n) cur = (uint32_t)a.prompt[p0];
    if (p1 >= 0 && p1 < n) nxt = (uint32_t)a.prompt[p1];
  }

  int i = i0, n_chunks = 0, steps = 0, status = 0, last_steps = 0;
  bool completed = false;
  for (;;) {
    if (n_chunks == a.max_chunks) {  // never on a right control flow
      status = 1;
      break;
    }
    int kc = n - i;  // the chunk's steps: min(budget, n - i), none past n
    kc = kc < 0 ? 0 : (kc > budget ? budget : kc);
    for (int t = 0; t < kc; ++t, ++i) {
      if (!kDecode) {
        // body_pos: state = lm_step(state, prompt[:, i])
        if ((i >> 5) != blk) {  // the next block: prefetch the one after it
          ++blk;
          cur = nxt;
          const int p = (blk + 1) * 32 + lane;
          nxt = p < n ? (uint32_t)a.prompt[p] : 0u;
        }
        fold_row_sum(rows[0], d, __shfl_sync(0xffffffffu, cur, i & 31), lane);  // no sum kept
      } else {
        // body_t: every live row takes one token; the warp's rows' sums are
        // added across the lanes together, their shuffles interleaved
        uint32_t sum[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          sum[k] = i < until[k] ? fold_row_sum(rows[k], d, last[k], lane) : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int k = 0; k < kRows; ++k) sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (i < until[k]) {
            const int row = warp + k * compute;
            const int t2 = token_of(sum[k], vocab);
            if (lane == 0) a.out[row * a.out_stride + i] = t2;
            last[k] = (uint32_t)t2;
          }
        }
      }
    }
    steps += kc;
    last_steps = kc;
    completed = i >= n;
    ++n_chunks;
    if (completed) break;
    // boundary n_chunks: warp 0 stores it to the progress word and reports
    // it to the watcher; every warp decides it from the flag read the
    // watcher issued at the last boundary (a later boundary's value in
    // `seen` means this one ran on)
    if (warp == 0 && lane == 0) {
      store_progress(a.progress, n_chunks);
      *reinterpret_cast<volatile int*>(&done) = n_chunks;
    }
    unsigned long long w;
    do {
      w = load_shared_u64(&seen);
    } while ((int)(w >> 32) < n_chunks);
    if ((int)(w >> 32) == n_chunks && stops(n_chunks, (int)(unsigned)w)) break;
  }
  // the launch ends at n_chunks: the progress word says so, the watcher
  // leaves
  if (warp == 0 && lane == 0) {
    store_progress(a.progress, n_chunks);
    *reinterpret_cast<volatile int*>(&done) = -n_chunks;
  }

  if (completed && !kDecode) {  // out[0, 0] = lm_token(state)
    const int t = token_of(row_sum(rows[0], d, lane), vocab);
    if (lane == 0) a.out[0] = t;
  }
  // the rows back to global memory once; M3's last tokens to the table
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = warp + k * compute;
    if (!(steps > 0 && i0 < until[k])) continue;  // a row the launch stepped
    if (kResident)
      copy_row(reinterpret_cast<uint32_t*>(a.state + row * a.state_stride), rows[k], d, lane);
    if (kDecode && lane == 0) a.slots[row * a.slots_stride + kColLastTok] = (int)last[k];
  }
  if (threadIdx.x == 0) {
    mega::write_ctx(a.words, exit_ctx(a.ctx, n_chunks, budget, last_steps, i, completed));
    a.words[kOutChunks] = n_chunks;
    a.words[kOutSteps] = steps;
    a.words[kOutStatus] = status;
  }
}

// A probe of what an M2/M3 chunk is made of, for the bound of its serial
// chain (not a kernel of the serving path: chip_smoke.py's [decode]
// launches it beside M2 and M3).  One block of `warps` warps; thread 0
// stamps clock64 around `reps` repetitions of each dependent step and
// writes the cycles of all of them to out[k]:
//   0 a dependent IMAD (mad.lo.u32)      1 a dependent IADD (add.u32)
//   2 a SHFL_XOR and the IADD it feeds   3 __syncthreads, the block's warps
//   4 the read of the mapped host flag (ld.acquire.sys, thread 0 alone)
//   5 a chunk boundary of the earlier design (barrier, progress store,
//     ld.acquire.sys flag read, barrier)
//   6 M2's step with the row in global memory (warp 0)
//   7 M3's step (step_row, then token_of feeding the next step's token)
//   8 token_of alone, each token feeding the next
//   9 the earlier design's control of a budget-1 chunk, the for_save loop
//     over the 36 words (with_budget ... finish), no step, flag or barrier
//  10 the earlier design's prompt read: prompt[i] loaded where the step
//     needs it, feeding a multiply-add, a compiler barrier between reads
//  11 the earlier design's budget-1 M2 chunk without its boundary: 9's
//     control, 10's read and 6's step
//  12 the earlier design's whole budget-1 M2 chunk: 11 and 5
//  13 this design's control of a chunk (its steps, the completion test)
//  14 M2's step with the row in shared memory (warp 0)
//  15 the flag read as this design issues it (ld.relaxed.sys, warp 0's
//     lanes), each read's address hanging on the last value
//  16 15's read issued before 14's step and its value used after it
//  17 a progress store followed by `fence.sc.sys`
//  18 a volatile read of a device-memory word, each hanging on the last
//  19 15's read issued by warp 0, then __syncthreads, then its value used
//     (a barrier waits for the reads its warps have in flight)
//  20 15's read, M3's resident step and token (each warp its row), then its
//     value used by warp 0, the other warps waiting for it in shared memory
// then out[21] the clock64 cycles and out[22] the globaltimer nanoseconds
// of the whole probe (their ratio converts cycles to time), out[23] a sink
// that keeps every chain live.
constexpr int kProbeTerms = 21;
constexpr int kProbeWords = kProbeTerms + 3;

struct ProbeArgs {
  const int* flag;
  int* progress;
  int* row;  // d ints of scratch state; its first words are also the prompt
  long long* out;
  int d, vocab, reps;
  int zero;  // 0, opaque to the compiler: a read's address hangs on a value
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_volatile(const int* p) {
  int v;
  asm volatile("ld.volatile.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One budget-1 chunk of the earlier design's for_save control over the
// record (body left to the caller, `step` it); returns whether it completed.
template <typename Step>
__device__ __forceinline__ bool parent_chunk_control(Ctx& c, int n, int& steps, Step step) {
  c.budget = 1;
  c.intr = 0;
  c.init_var[kSlotPos] = 0;
  c.incr_var[kSlotPos] = 1;
  int i = c.saved[kSlotPos] == 1 ? c.var[kSlotPos] : 0;
  c.saved[kSlotPos] = 0;
  while (i < n && c.budget > 0 && c.intr == 0) {
    c.intr = 0;
    step(i);
    c.var[kSlotPos] = i + 1;
    c.saved[kSlotPos] = 1;
    const bool ok = c.intr == 0;
    c.budget -= 1;
    if (ok) i += 1;
    ++steps;
  }
  const bool completed = i >= n;
  if (completed) {
    c.var[kSlotPos] = 0;
    c.saved[kSlotPos] = 0;
  }
  c.intr = completed ? 0 : 1;
  if (c.intr == 0) c.done = 1;
  return completed;
}

__global__ void __launch_bounds__(kMaxWarps * 32) seq_probe_kernel(const ProbeArgs a) {
  extern __shared__ uint32_t srow[];  // a resident row of d ints a warp
  __shared__ int decision;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ns0 = global_ns(), c0 = clock64();
  const Modulo vocab(a.vocab);
  long long t[kProbeTerms];
  uint32_t x = (uint32_t)a.vocab + (uint32_t)tid, y = (uint32_t)a.d | 1u;
  long long s = clock64();
#pragma unroll 16
  for (int i = 0; i < a.reps; ++i) asm volatile("mad.lo.u32 %0, %0, %1, %1;" : "+r"(x) : "r"(y));
  t[0] = clock64() - s;
  s = clock64();
#pragma unroll 16
  for (int i = 0; i < a.reps; ++i) asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  t[1] = clock64() - s;
  s = clock64();
#pragma unroll 16
  for (int i = 0; i < a.reps; ++i) x += __shfl_xor_sync(0xffffffffu, x, 1);
  t[2] = clock64() - s;
  __syncthreads();
  s = clock64();
  for (int i = 0; i < a.reps; ++i) __syncthreads();
  t[3] = clock64() - s;
  // 4 and 5 in alternating runs of 32, so that a drift of the host's read
  // latency during the probe falls on both alike
  int f = 0;
  t[4] = t[5] = 0;
  for (int b = 0; b < a.reps; b += 32) {
    const int nb = a.reps - b < 32 ? a.reps - b : 32;
    __syncthreads();
    s = clock64();
    if (tid == 0)
      for (int i = 0; i < nb; ++i) f += load_flag(a.flag);
    t[4] += clock64() - s;
    __syncthreads();
    s = clock64();
    for (int i = b; i < b + nb; ++i) {
      __syncthreads();
      if (tid == 0) {
        *reinterpret_cast<volatile int*>(a.progress) = i + 1;
        const int g = load_flag(a.flag);
        decision = (g != 0 && i + 1 >= g) ? 1 : 0;
      }
      __syncthreads();
      f += decision;
    }
    t[5] += clock64() - s;
  }
  uint32_t* row = reinterpret_cast<uint32_t*>(a.row);
  const int* prompt = a.row;
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) fold_row_sum(row, a.d, (uint32_t)i, lane);
  t[6] = clock64() - s;
  uint32_t tok = 1u;
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) tok = (uint32_t)token_of(step_row(row, a.d, tok, lane), vocab);
  t[7] = clock64() - s;
  s = clock64();
  for (int i = 0; i < a.reps; ++i) tok = (uint32_t)token_of(tok, vocab);
  t[8] = clock64() - s;
  // the earlier design's chunk, part by part (n = reps + 1: never done)
  Ctx c = {};
  int steps = 0;
  s = clock64();
  for (int i = 0; i < a.reps; ++i) {
    parent_chunk_control(c, a.reps + 1, steps, [](int) {});
    asm volatile("" ::: "memory");  // the boundary's flag read sat here
  }
  t[9] = clock64() - s;
  s = clock64();
  for (int i = 0; i < a.reps; ++i) {
    x = x * (uint32_t)prompt[(i + (x & a.zero)) & 31] + y;
    asm volatile("" ::: "memory");
  }
  t[10] = clock64() - s;
  c = Ctx{};
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) {
      parent_chunk_control(c, a.reps + 1, steps, [&](int k) {
        fold_row_sum(row, a.d, (uint32_t)prompt[k & 31], lane);
      });
      asm volatile("" ::: "memory");
    }
  t[11] = clock64() - s;
  c = Ctx{};
  __syncthreads();
  s = clock64();
  for (int i = 0; i < a.reps; ++i) {
    parent_chunk_control(c, a.reps + 1, steps, [&](int k) {
      if (warp == 0) fold_row_sum(row, a.d, (uint32_t)prompt[k & 31], lane);
    });
    __syncthreads();
    if (tid == 0) {
      *reinterpret_cast<volatile int*>(a.progress) = i + 1;
      const int g = load_flag(a.flag);
      decision = (g != 0 && i + 1 >= g) ? 1 : 0;
    }
    __syncthreads();
    f += decision;
  }
  t[12] = clock64() - s;
  // this design's chunk control: min(budget, n - i) steps, the end test
  int pos = 0, done = 0;
  s = clock64();
  for (int i = 0; i < a.reps; ++i) {
    int kc = a.reps + 1 - pos;
    kc = kc < 0 ? 0 : (kc > 1 ? 1 : kc);
    pos += kc;
    steps += kc;
    done += pos >= a.reps + 1;
    asm volatile("" ::: "memory");
  }
  t[13] = clock64() - s;
  if (warp == 0) copy_row(srow, row, a.d, lane);
  __syncwarp();
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) fold_row_sum(srow, a.d, (uint32_t)i, lane);
  t[14] = clock64() - s;
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) f += issue_flag_read(a.flag + (f & a.zero));
  t[15] = clock64() - s;
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) {
      const int g = issue_flag_read(a.flag + (f & a.zero));
      fold_row_sum(srow, a.d, (uint32_t)i, lane);
      f += g;
    }
  t[16] = clock64() - s;
  s = clock64();
  if (tid == 0)
    for (int i = 0; i < a.reps; ++i) {
      store_progress(a.progress, i + 1);
      asm volatile("fence.sc.sys;" ::: "memory");
    }
  t[17] = clock64() - s;
  s = clock64();
  if (tid == 0)
    for (int i = 0; i < a.reps; ++i) f += load_volatile(a.row + (f & a.zero));
  t[18] = clock64() - s;
  __syncthreads();
  s = clock64();
  for (int i = 0; i < a.reps; ++i) {
    const int g = warp == 0 ? issue_flag_read(a.flag + (f & a.zero)) : 0;
    __syncthreads();
    f += g;
  }
  t[19] = clock64() - s;
  __syncthreads();
  if (tid == 0) decision = 0;
  __syncthreads();
  s = clock64();
  for (int i = 1; i <= a.reps; ++i) {
    const int g = warp == 0 ? issue_flag_read(a.flag + (f & a.zero)) : 0;
    tok = (uint32_t)token_of(step_row(srow + warp * a.d, a.d, tok, lane), vocab);
    if (warp == 0) {
      f += g;
      if (lane == 0) *reinterpret_cast<volatile int*>(&decision) = i;
    } else {
      while (*reinterpret_cast<volatile int*>(&decision) < i) {
      }
    }
  }
  t[20] = clock64() - s;
  __syncthreads();
  const long long c1 = clock64(), ns1 = global_ns();
  if (tid == 0) {
    for (int k = 0; k < kProbeTerms; ++k) a.out[k] = t[k];
    a.out[kProbeTerms] = c1 - c0;
    a.out[kProbeTerms + 1] = ns1 - ns0;
    a.out[kProbeTerms + 2] = (long long)(x + tok + srow[lane % a.d]) + f + steps + done +
                             c.var[kSlotPos] + pos;
  }
}

// cudaFuncSetAttribute once a device for `Kernel`: a launch of it may take
// more than 48 KiB of shared memory
template <auto Kernel>
cudaError_t allow_shared(int device) {
  static std::atomic<unsigned long long> allowed{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (allowed.load() & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxResidentBytes);
  if (err == cudaSuccess) allowed.fetch_or(bit);
  return err;
}

template <bool kDecode, bool kResident, int kRows>
cudaError_t start(const SeqArgs& a, int warps, size_t bytes, cudaStream_t stream, int device) {
  if constexpr (kResident) {
    const cudaError_t err = allow_shared<seq_mega_kernel<kDecode, true, kRows>>(device);
    if (err != cudaSuccess) return err;
  }
  seq_mega_kernel<kDecode, kResident, kRows><<<1, warps * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool kDecode, bool kResident>
cudaError_t start_rows(const SeqArgs& a, int warps, size_t bytes, cudaStream_t stream,
                       int device) {
  if constexpr (!kDecode) {
    return start<false, kResident, 1>(a, warps, bytes, stream, device);
  } else {
    switch (a.rows_per_warp) {
      case 1: return start<true, kResident, 1>(a, warps, bytes, stream, device);
      case 2: return start<true, kResident, 2>(a, warps, bytes, stream, device);
      case 3: return start<true, kResident, 3>(a, warps, bytes, stream, device);
      case 4: return start<true, kResident, 4>(a, warps, bytes, stream, device);
      case 5: return start<true, kResident, 5>(a, warps, bytes, stream, device);
    }
    return cudaErrorInvalidValue;
  }
}

template <bool kDecode>
int launch(const SeqArgs& a, int resident, int device, void* stream) {
  // the compute warps and the watcher
  const int warps = (a.s + a.rows_per_warp - 1) / a.rows_per_warp + 1;
  const long long bytes = resident ? (long long)a.s * a.d * 4 : 0;
  if (a.rows_per_warp < 1 || a.rows_per_warp > kMaxRowsPerWarp || warps > kMaxWarps ||
      bytes > kMaxResidentBytes)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(resident ? start_rows<kDecode, true>(a, warps, (size_t)bytes, st, device)
                        : start_rows<kDecode, false>(a, warps, 0, st, device));
}

}  // namespace

extern "C" int seq_prefill_mega(const int* ctx, int* out, int* state, const int* prompt, int d,
                                int prompt_len, int vocab, int budget, int max_chunks,
                                int resident, const int* flag, int* progress, int* words,
                                int device, void* stream) {
  if (d <= 0 || prompt_len < 0 || vocab <= 0 || budget <= 0 || max_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  SeqArgs a = {};
  a.ctx = mega::read_ctx(ctx);
  a.out = out;
  a.state = state;
  a.prompt = prompt;
  a.s = 1;
  a.d = d;
  a.n_steps = prompt_len;
  a.vocab = vocab;
  a.budget = budget;
  a.max_chunks = max_chunks;
  a.flag = flag;
  a.progress = progress;
  a.words = words;
  a.rows_per_warp = 1;
  return launch<false>(a, resident, device, stream);
}

extern "C" int seq_decode_mega(const int* ctx, int* out, long long out_stride, int* state,
                               long long state_stride, int* slots, long long slots_stride, int s,
                               int d, int r, int vocab, int budget, int max_chunks,
                               int rows_per_warp, int resident, const int* flag, int* progress,
                               int* words, int device, void* stream) {
  if (s <= 0 || d <= 0 || r < 0 || vocab <= 0 || budget <= 0 || max_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  SeqArgs a = {};
  a.ctx = mega::read_ctx(ctx);
  a.out = out;
  a.out_stride = out_stride;
  a.state = state;
  a.state_stride = state_stride;
  a.slots = slots;
  a.slots_stride = slots_stride;
  a.s = s;
  a.d = d;
  a.n_steps = r;
  a.vocab = vocab;
  a.budget = budget;
  a.max_chunks = max_chunks;
  a.flag = flag;
  a.progress = progress;
  a.words = words;
  a.rows_per_warp = rows_per_warp;
  return launch<true>(a, resident, device, stream);
}

// The probe above: out receives kProbeWords device int64s; `row` holds d
// ints; a row of d ints a warp in shared memory (warps * d * 4 bytes, at
// most kMaxResidentBytes).  Returns a cudaError_t.
extern "C" int seq_latency_probe(const int* flag, int* progress, int* row, long long* out, int d,
                                 int vocab, int warps, int reps, int device, void* stream) {
  if (d <= 0 || vocab <= 0 || warps <= 0 || warps > kMaxWarps || reps <= 0 ||
      (long long)warps * d * 4 > kMaxResidentBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_shared<seq_probe_kernel>(device)) != cudaSuccess) return (int)err;
  const ProbeArgs a = {flag, progress, row, out, d, vocab, reps, 0};
  seq_probe_kernel<<<1, warps * 32, (size_t)warps * d * 4, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
