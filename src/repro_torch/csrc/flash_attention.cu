// Causal / windowed GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention/kernel.py (launched by
// `flash_attention_pallas`): the prefill attention of the attention-LM
// serving path, one C-wide query segment against the K/V cache filled so far.
//
// Interface (plain C, loaded with ctypes; see kernels/flash_attention/kernel.py):
//   flash_attention_fwd(q, q strides (b, h, t), k, k strides (b, kvh, s),
//                       v, v strides (b, kvh, s), o, B, H, KV, T, S, hd,
//                       q_offset, causal, window, scale, bf16,
//                       heads_per_block, stream)
//   q [B, H, T, hd], k/v [B, KV, S, hd] with any element strides on the first
//   three dims and unit stride on hd; o is a fresh contiguous [B, H, T, hd].
//   q_offset is the absolute position of query row 0 (a runtime int, never a
//   compile-time constant); window < 0 means no sliding window.
//   heads_per_block (1, 2, 4, 8 or 16, dividing H / KV) comes from the
//   wrapper's plan.  The launch goes on the caller's stream and the function
//   returns cudaGetLastError().
//
// Bound: at the serving prefill shape (q [4, 32, 16, 128], k/v [4, 8, 128,
// 128], f32, q_offset 0, 16, ..., 112) a launch must read q, write o and read
// the K/V rows up to the causal limit once: 1.05 MB (q_offset 0) to 4.19 MB
// (112), 1.331 us a launch on average at 3.35 TB/s; its 4 FLOP per kept
// (query, key, dim) take 1.009 us on average at 67 TFLOP/s f32.  What holds
// a launch back on the card is latency, not either bound: each block has
// one short chain of steps (stage, score, softmax, P.V), and 4 blocks of a
// (batch, KV head) each read its K/V rows from L2.
//
// Design:
// - A block serves 16 query rows of one (batch, KV head): heads_per_block
//   heads of the GQA group times 16 / heads_per_block consecutive positions
//   (4 x 4 at the serving shape: 128 blocks of 256 threads), so every K/V
//   row a block stages serves all of the group's heads it holds, and the
//   16 rows are one m16 tile of the tensor cores.
// - The keys any of its rows can see (the causal limit of its last
//   position, the window of its first) are taken in passes of 128 keys, one
//   pass at the serving shape.  A pass stages its visible K rows, then its
//   V rows, with 16-byte `cp.async.cg` as two copy groups (q's rows, a
//   group of their own, go first), so the scores start when K has landed
//   while V is still on its way.  Keys outside the visible range are never
//   loaded: they are masked for every row, so they add exactly 0; the V
//   rows that share a key step of 8 with a visible key are zeroed.  Where
//   a pointer, stride or head dim is not 16-byte aligned, the threads stage
//   element by element instead (same layout).
// - Both products run on the tensor cores (`mma.sync.m16n8k8` TF32, f32
//   accumulators) split three ways, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi,
//   a_hi the TF32 part of a (sign, exponent, top 10 mantissa bits, a mask)
//   and a_lo = a - a_hi: each product keeps about 21 bits, where plain TF32
//   keeps 10 and would not hold the f32 path's 2e-5.  Scores: warp w takes
//   keys 16 w..16 w + 15 of a pass for all 16 rows over the whole head dim,
//   q's fragments split once into registers.  P.V: warp w takes output dims
//   16 w..16 w + 15 over the pass's key steps of 8 that a row sees.  Two
//   accumulator sets an n-tile keep independent chains of tensor-core ops
//   in flight.
// - One online softmax per block and pass, 16 threads a row, with the
//   Pallas constants (masked scores -1e30, the running max clamped at
//   -0.5e30, the denominator floored at 1e-30, so a fully masked row
//   outputs exactly 0).
// - Staged K rows lie 4 words past a multiple of 32 apart and V rows 8, so
//   the fragments' loads (8 rows x 4 columns, 4 rows x 8 columns) fall in
//   distinct banks.  The inner loops have no branches on the head dim
//   (columns past it read a column in range and weigh 0), so the compiler
//   can issue their loads early.
// bf16 inputs are staged as bf16 and widened on reading (bf16 is exact in
// TF32); the output is rounded to nearest.

#include <atomic>

#include "flash_attention.cuh"

namespace {

using namespace flash_attn;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) char smem[];
  flash_block<T>(a, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T>
int launch(const void* q, long long qsb, long long qsh, long long qst, const void* k,
           long long ksb, long long ksh, long long kss, const void* v, long long vsb,
           long long vsh, long long vss, void* o, int B, int H, int KV, int T_len, int S, int hd,
           int q_offset, int causal, int window, float scale, int hpb, cudaStream_t stream) {
  const int es = sizeof(T);
  Args<T> a{static_cast<const T*>(q), qsb, qsh, qst, static_cast<const T*>(k), ksb, ksh, kss,
            static_cast<const T*>(v), vsb, vsh, vss, static_cast<T*>(o),
            (long long)H * T_len * hd, (long long)T_len * hd, hd, H, H / KV, T_len, S,
            hd, q_offset, causal, window, hpb, scale, false, false};
  a.kv_vec = (hd * es) % 16 == 0 && aligned(k, ksb, ksh, kss, 16, es) &&
             aligned(v, vsb, vsh, vss, 16, es);
  a.q_vec = (hd * es) % 16 == 0 && aligned(q, qsb, qsh, qst, 16, es);
  auto kernel = flash_fwd_kernel<T>;
  // The shared-memory ceiling is an attribute of the kernel on a device:
  // raised once a device, to the most any head dim takes, not each launch.
  static std::atomic<unsigned long long> raised{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(raised.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit, std::memory_order_release);
  }
  const size_t smem = smem_bytes(hd, es);
  const int rows_t = kRows / hpb;
  const dim3 grid((T_len + rows_t - 1) / rows_t, KV * (H / KV / hpb), B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, long long qsb, long long qsh, long long qst,
                                   const void* k, long long ksb, long long ksh, long long kss,
                                   const void* v, long long vsb, long long vsh, long long vss,
                                   void* o, int B, int H, int KV, int T, int S, int hd,
                                   int q_offset, int causal, int window, float scale, int bf16,
                                   int heads_per_block, void* stream) {
  const int hpb = heads_per_block;
  if (B <= 0 || H <= 0 || KV <= 0 || T <= 0 || S <= 0 || hd <= 0 || hd > kMaxHd || H % KV ||
      hpb < 1 || hpb > kRows || kRows % hpb || (H / KV) % hpb)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || (long long)KV * (H / KV / hpb) > 65535 ||
      smem_bytes(hd, bf16 ? 2 : 4) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, qsb, qsh, qst, k, ksb, ksh, kss, v, vsb, vsh, vss, o, B, H,
                                 KV, T, S, hd, q_offset, causal, window, scale, hpb, s);
  return launch<float>(q, qsb, qsh, qst, k, ksb, ksh, kss, v, vsb, vsh, vss, o, B, H, KV, T, S,
                       hd, q_offset, causal, window, scale, hpb, s);
}
