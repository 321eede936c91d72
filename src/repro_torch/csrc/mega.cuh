// The context record and the host-word accesses the persistent kernels
// share: M1 (blur.cu), M2/M3 (seq_lm.cu) and M4/M5 (attn_lm.cu).

#pragma once

#include <cuda_runtime.h>

namespace mega {

constexpr int kCtxN = 8;                    // the context record's N (core/context.py)
constexpr int kCtxWords = 4 * kCtxN + 4;    // ContextRecord.to_words

// struct context (Listing 1.3) plus done/budget/intr, in ContextRecord's
// field order (ContextRecord.to_words)
struct Ctx {
  int var[kCtxN];
  int init_var[kCtxN];
  int incr_var[kCtxN];
  int saved[kCtxN];
  int valid, done, budget, intr;
};
static_assert(sizeof(Ctx) == kCtxWords * sizeof(int), "Ctx must be the 36 context words");

// the record from the host's 36 context words
inline Ctx read_ctx(const int* words) {
  Ctx c;
  int* w = reinterpret_cast<int*>(&c);
  for (int k = 0; k < kCtxWords; ++k) w[k] = words[k];
  return c;
}

// the record back as the 36 context words, in ContextRecord.to_words order
__device__ __forceinline__ void write_ctx(int* words, const Ctx& c) {
#pragma unroll
  for (int k = 0; k < kCtxN; ++k) {
    words[k] = c.var[k];
    words[kCtxN + k] = c.init_var[k];
    words[2 * kCtxN + k] = c.incr_var[k];
    words[3 * kCtxN + k] = c.saved[k];
  }
  words[4 * kCtxN] = c.valid;
  words[4 * kCtxN + 1] = c.done;
  words[4 * kCtxN + 2] = c.budget;
  words[4 * kCtxN + 3] = c.intr;
}

// the host's flag word: a system-scope acquire load, never a cached one
__device__ __forceinline__ int load_flag(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A read of the host's flag word that goes to host memory every time and
// stalls the issuing warp only where its value is used (M1, M2/M3).
__device__ __forceinline__ int issue_flag_read(const int* p) {
  int v;
  asm volatile("ld.relaxed.sys.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The chunks completed, to the host's progress word (M1, M2/M3).
__device__ __forceinline__ void store_progress(int* p, int v) {
  asm volatile("st.relaxed.sys.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

}  // namespace mega
