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
//                    max_chunks, flag, progress, words, device, stream)
//     M2: SeqPrefill's for_save(SLOT_POS, 0, prompt_len, 1), a prompt
//     position folded into state i32[1, d] per budget unit; on completion
//     the token of state goes to out[0] and the context is finished.
//   seq_decode_mega(ctx, out, out_stride, state, state_stride, slots,
//                   slots_stride, s, d, r, vocab, budget, max_chunks, flag,
//                   progress, words, device, stream)
//     M3: one decode round, SeqDecode's for_save(SLOT_POS, 0, r, 1) over s
//     slot rows.  Row i takes part in step t iff slots[i][0] == 1 (active)
//     and t < slots[i][1] (n_emit); a live row updates state[i],
//     out[i][t] and slots[i][2] (the last token) in place, the other rows
//     are left untouched.
// `ctx` is the 36 host context words (ContextRecord.to_words), passed by
// value; `flag` and `progress` the mapped host words of
// csrc/preempt_flag.cu; `words` receives kOutWords device words: the
// context words, the chunks run, the steps run and the status (0, or 1 when
// the launch reached `max_chunks` undone).  Strides are in int32 elements;
// the last dim of every buffer is contiguous.  The launch goes on the
// caller's stream; the functions return a cudaError_t.
//
// Control flow: every thread runs the for_save loop of core/preemption.py
// over its own copy of the context words, word for word, chunk after chunk
// (with_budget; declare, resume_value, unsave; per iteration clear_intr,
// checkpoint(SLOT_POS, i + 1), dec_budget; clear on completion; mark_intr;
// finish), so all threads take the same branches.  The stop rule is the
// reference's: at least one chunk unless the context is already done, and
// an exit at the first boundary k >= flag when flag != 0.  At a boundary the
// block meets at a barrier; thread 0 writes the chunks done to the progress
// word, reads the flag with `ld.acquire.sys` and puts the decision in
// shared memory; after a second barrier every thread reads it, so all stop
// at the same boundary.
//
// Geometry: one block, one warp a slot row (a warp walks rows w, w + 32, ...
// when there are more than 32, at most 4 of them: s <= 128), the lanes
// looping over d.  Rows are independent, so no grid sync is needed, and one
// block leaves room for every other region's launch.  A lane keeps nothing
// of the state between
// steps: it reads and writes its elements of the row in global memory
// (L1/L2 hits after the first step); a row's last token stays in a register
// and is stored to the slots table at every step it takes.
//
// Bound: latency.  A step moves s*d*4*2 bytes (the state read and written):
// 98 KB at s = 32, d = 384, 29 ns at 3.35 TB/s, where a step's dependent
// chain (loads, the multiply-adds, 5 shuffles, the modulo, the token
// broadcast) takes about a microsecond.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mega.cuh"

namespace {

using mega::Ctx;
using mega::kCtxWords;
using mega::load_flag;

constexpr int kSlotPos = 0;                 // serving/kernels.py SLOT_POS
constexpr int kOutChunks = kCtxWords;       // chunks this launch ran
constexpr int kOutSteps = kCtxWords + 1;    // for_save iterations it ran
constexpr int kOutStatus = kCtxWords + 2;   // 0, or 1: hit max_chunks undone
// kOutWords = kCtxWords + 3 (kernels/seq_lm/kernel.py OUT_WORDS)
constexpr int kColActive = 0, kColNEmit = 1, kColLastTok = 2;  // slots table
constexpr int kMaxWarps = 32;               // a block's 1024 threads
constexpr int kMaxRowsPerWarp = 4;          // so at most 128 slot rows

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
  const int* flag;           // the mapped host preempt word
  int* progress;             // the mapped host word of the chunks completed
  int* words;                // kOutWords device words
};

// One token folded into row `row` (a warp's lanes over d); returns the
// wrapped row sum of the new state, the same on every lane.
__device__ __forceinline__ uint32_t step_row(uint32_t* row, int d, uint32_t tok, int lane) {
  uint32_t sum = 0;
  for (int j = lane; j < d; j += 32) {
    const uint32_t pos = (uint32_t)j;
    const uint32_t v = row[j] * kMixA + tok * (2u * pos + 1u) + pos * kPhi + kMixC;
    row[j] = v;
    sum += v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// the wrapped row sum of row `row`, the same on every lane
__device__ __forceinline__ uint32_t row_sum(const uint32_t* row, int d, int lane) {
  uint32_t sum = 0;
  for (int j = lane; j < d; j += 32) sum += row[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

__device__ __forceinline__ int token_of(uint32_t sum, int vocab) {
  return (int)(((sum * kMixA + kMixC) & 0x7fffffffu) % (uint32_t)vocab);
}

// kDecode = false: M2 (SeqPrefill); true: M3 (SeqDecode)
template <bool kDecode>
__global__ void __launch_bounds__(kMaxWarps * 32) seq_mega_kernel(const SeqArgs a) {
  __shared__ int decision;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // the last token of each of this warp's decode rows, in registers
  uint32_t last[kMaxRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kMaxRowsPerWarp; ++k) {
    const int row = warp + k * n_warps;
    last[k] = kDecode && row < a.s ? (uint32_t)a.slots[row * a.slots_stride + kColLastTok] : 0u;
  }
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
    while (i < a.n_steps && c.budget > 0 && c.intr == 0) {
      c.intr = 0;  // clear_intr
      if (!kDecode) {
        // body_pos: state = lm_step(state, prompt[:, i])
        if (warp == 0)
          step_row(reinterpret_cast<uint32_t*>(a.state), a.d, (uint32_t)a.prompt[i], lane);
      } else {
        // body_t: every live row takes one token
        // (no break or continue in the unrolled loop: last[] stays in
        // registers)
#pragma unroll
        for (int k = 0; k < kMaxRowsPerWarp; ++k) {
          const int row = warp + k * n_warps;
          const int* sl = a.slots + row * a.slots_stride;
          if (row < a.s && sl[kColActive] == 1 && i < sl[kColNEmit]) {
            const uint32_t sum = step_row(
                reinterpret_cast<uint32_t*>(a.state + row * a.state_stride), a.d, last[k], lane);
            const int t2 = token_of(sum, a.vocab);
            if (lane == 0) {
              a.out[row * a.out_stride + i] = t2;
              a.slots[row * a.slots_stride + kColLastTok] = t2;
            }
            last[k] = (uint32_t)t2;
          }
        }
      }
      c.var[kSlotPos] = i + 1;  // checkpoint(SLOT_POS, i + 1)
      c.saved[kSlotPos] = 1;
      const bool ok = c.intr == 0;  // the body holds no loop: always
      c.budget -= 1;                // dec_budget
      if (ok) i += 1;
      ++steps;
    }
    const bool completed = i >= a.n_steps;
    if (completed) {  // clear(SLOT_POS)
      c.var[kSlotPos] = 0;
      c.saved[kSlotPos] = 0;
    }
    c.intr = completed ? 0 : 1;  // mark_intr
    if (c.intr == 0) {
      if (!kDecode && warp == 0) {  // out[0, 0] = lm_token(state)
        const uint32_t sum = row_sum(reinterpret_cast<const uint32_t*>(a.state), a.d, lane);
        if (lane == 0) a.out[0] = token_of(sum, a.vocab);
      }
      c.done = 1;  // ctx.finish()
    }
    ++n_chunks;
    // the chunk boundary: once every warp has finished the chunk, one thread
    // tells the host how far the launch got, reads the host's word and
    // publishes the decision, so a host write landing meanwhile cannot split
    // the block
    __syncthreads();
    if (threadIdx.x == 0) {
      *reinterpret_cast<volatile int*>(a.progress) = n_chunks;
      const int f = load_flag(a.flag);
      decision = (f != 0 && n_chunks >= f) ? 1 : 0;
    }
    __syncthreads();
    stop = decision;
  }
  if (threadIdx.x == 0) {
    mega::write_ctx(a.words, c);
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
//   5 a chunk boundary as seq_mega_kernel runs it (barrier, progress store,
//     flag read, barrier)
//   6 M2's step (warp 0's step_row, its sum unused, as M2 leaves it)
//   7 M3's step (step_row, then token_of feeding the next step's token)
//   8 token_of alone, each token feeding the next
// then out[9] the clock64 cycles and out[10] the globaltimer nanoseconds
// of the whole probe (their ratio converts cycles to time), out[11] a sink
// that keeps every chain live.
constexpr int kProbeWords = 12;

struct ProbeArgs {
  const int* flag;
  int* progress;
  int* row;  // d ints of scratch state
  long long* out;
  int d, vocab, reps;
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(kMaxWarps * 32) seq_probe_kernel(const ProbeArgs a) {
  __shared__ int decision;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ns0 = global_ns(), c0 = clock64();
  long long t[9];
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
  int f = 0;
  s = clock64();
  if (tid == 0)
    for (int i = 0; i < a.reps; ++i) f += load_flag(a.flag);
  t[4] = clock64() - s;
  __syncthreads();
  s = clock64();
  for (int i = 0; i < a.reps; ++i) {
    __syncthreads();
    if (tid == 0) {
      *reinterpret_cast<volatile int*>(a.progress) = i + 1;
      const int g = load_flag(a.flag);
      decision = (g != 0 && i + 1 >= g) ? 1 : 0;
    }
    __syncthreads();
    f += decision;
  }
  t[5] = clock64() - s;
  uint32_t* row = reinterpret_cast<uint32_t*>(a.row);
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) step_row(row, a.d, (uint32_t)i, lane);
  t[6] = clock64() - s;
  uint32_t tok = 1u;
  s = clock64();
  if (warp == 0)
    for (int i = 0; i < a.reps; ++i) tok = (uint32_t)token_of(step_row(row, a.d, tok, lane), a.vocab);
  t[7] = clock64() - s;
  s = clock64();
  for (int i = 0; i < a.reps; ++i) tok = (uint32_t)token_of(tok, a.vocab);
  t[8] = clock64() - s;
  __syncthreads();
  const long long c1 = clock64(), ns1 = global_ns();
  if (tid == 0) {
    for (int k = 0; k < 9; ++k) a.out[k] = t[k];
    a.out[9] = c1 - c0;
    a.out[10] = ns1 - ns0;
    a.out[11] = (long long)(x + tok) + f;
  }
}

template <bool kDecode>
int launch(const SeqArgs& a, int rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int warps = rows < kMaxWarps ? rows : kMaxWarps;
  seq_mega_kernel<kDecode><<<1, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seq_prefill_mega(const int* ctx, int* out, int* state, const int* prompt, int d,
                                int prompt_len, int vocab, int budget, int max_chunks,
                                const int* flag, int* progress, int* words, int device,
                                void* stream) {
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
  return launch<false>(a, 1, device, stream);
}

extern "C" int seq_decode_mega(const int* ctx, int* out, long long out_stride, int* state,
                               long long state_stride, int* slots, long long slots_stride, int s,
                               int d, int r, int vocab, int budget, int max_chunks,
                               const int* flag, int* progress, int* words, int device,
                               void* stream) {
  if (s <= 0 || s > kMaxRowsPerWarp * kMaxWarps || d <= 0 || r < 0 || vocab <= 0 || budget <= 0 ||
      max_chunks <= 0)
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
  return launch<true>(a, s, device, stream);
}

// The probe above: out receives kProbeWords device int64s.  Returns a
// cudaError_t.
extern "C" int seq_latency_probe(const int* flag, int* progress, int* row, long long* out, int d,
                                 int vocab, int warps, int reps, int device, void* stream) {
  if (d <= 0 || vocab <= 0 || warps <= 0 || warps > kMaxWarps || reps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ProbeArgs a = {flag, progress, row, out, d, vocab, reps};
  seq_probe_kernel<<<1, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
