// One-token GQA decode attention over a ring / linear cache or a paged KV
// pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dec_kernel` in
// src/repro/kernels/decode_attention/kernel.py (launched by
// `decode_attention_pallas`), and fuses the XLA page gather of
// `paged_decode_attention` (src/repro/kernels/decode_attention/ops.py) into
// the kernel: the paged entry walks the block table itself.
//
// Interface (plain C, loaded with ctypes; see kernels/decode_attention/kernel.py):
//   decode_attention_fwd(q, q strides (b, h), k, k strides (b, kvh, s), v, v strides,
//                        pos, o, B, H, KV, S, hd, window, scale,
//                        heads_per_block, warps, vec, stream)
//     caches [B, KV, S, hd] (ring buffers: slot i holds absolute position
//     last - ((last - i) mod S), last = pos[b] - 1);
//   paged_decode_attention_fwd(q, q strides (b, h), k_pool, v_pool, tables,
//                              table row stride, T_blk, NB, BS, pos, o,
//                              B, H, KV, hd, window, scale,
//                              heads_per_block, warps, vec, stream)
//     pools [NB, BS, KV, hd] contiguous; tables i32[B, T_blk] of page ids
//     (page 0 is the null page); row b's linear slot i lives at page
//     tables[b][i / BS], offset i % BS.  Out-of-range page ids are clamped,
//     as XLA's gather clamps them.
//   q [B, H, 1, hd] f32 with unit stride on hd, pos i32[B] (tokens written,
//   current one included), o a fresh contiguous [B, H, 1, hd] f32.  A key is
//   valid when 0 <= k_pos <= pos - 1 (and pos - 1 - k_pos < window when
//   window >= 0); a row with no valid key (pos = 0) outputs exactly 0.
//   heads_per_block (1, 2, 4 or 8, dividing H / KV) and warps (1..8) come
//   from the wrapper's plan; vec = 1 when hd % 4 == 0 and every row starts
//   16-byte aligned.  Pools hold
//   fewer than 2^31 rows (NB x BS x KV).
//
// Bound: memory.  At the serving decode shape (q [8, 32, 1, 128], pools
// [65, 16, 8, 128], 8 pages per row) a launch reads the valid keys' K/V rows
// once (at most 8.4 MB, 2.5 us at 3.35 TB/s) and does 4 FLOP per (head, key,
// dim), far below the compute roof.
//
// Design:
// - A block serves one (batch row, KV head, tile of heads_per_block query
//   heads of its group, 128-dim tile of the output): the group shares every
//   K/V row it loads.  The valid keys, a contiguous run of ring slots, are
//   counted once: n = min(pos, S, window) keys ending at slot last mod S.
//   Paged, the block first writes each slot's pool row (page id from the
//   table, clamped as XLA's gather clamps it) to shared memory, all threads
//   at once, so no division by BS lies on the way to a load.
// - The valid keys are cut into contiguous slices, one per warp.  A warp takes KC keys at a time
//   (KC x heads = 32 scores): a lane loads dims [4 lane, 4 lane + 4) of each
//   key's K and V row as one float4 (2 KC loads in flight), multiplies K by
//   the pre-scaled queries held in shared memory, and the 32 partial dots
//   are summed across the warp by a transposing butterfly (31 shuffles for
//   32 sums instead of 5 each).  Each head's step max is a butterfly over
//   the lanes holding it; the probabilities go through shared memory.
// - Each warp keeps an online softmax per head with the reference's
//   constants: the running max starts at -0.5e30 (the reference's clamp),
//   accumulators are rescaled once per KC keys, and the denominator is
//   floored at 1e-30 at the end.  So a row with pos = 0 outputs exactly 0.
// - Warps are combined in warp order in shared memory.  One block serves a
//   whole row: at the serving shape (S = 128, 16 keys a warp) splitting a
//   row's keys over a cluster of blocks was slower on the H100, so no
//   split is built until a workload brings longer contexts.
// - The contiguous and the paged entries share this one device function
//   and differ only in how a key row is addressed; vec changes how a lane's
//   4 dims are loaded, not the arithmetic.  Every product-sum is an explicit
//   fmaf, so paged equals gather-plus-contiguous bitwise on the card.

#include "decode_attention.cuh"

namespace {

using namespace decode_attn;

template <int GT, bool kVec, typename Rows>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_kernel(const float* __restrict__ q, long long qsb, long long qsh, Rows rows,
              const int* __restrict__ pos, float* __restrict__ o, int H, int group, int S,
              int hd, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  decode_block<GT, kVec, true>(q, qsb, qsh, rows, pos, o, H, group, S, hd, window, scale,
                               blockIdx.x, blockIdx.y, blockDim.x / 32, smem);
}

template <int GT, bool kVec, typename Rows>
int launch(const float* q, long long qsb, long long qsh, const Rows& rows, const int* pos,
           float* o, int B, int H, int KV, int S, int hd, int window, float scale, int warps,
           int slots, cudaStream_t stream) {
  auto kernel = decode_kernel<GT, kVec, Rows>;
  const size_t smem = smem_bytes(GT, warps, hd, slots);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int group = H / KV;
  const dim3 grid(KV * (group / GT) * ((hd + kTile - 1) / kTile), B);
  kernel<<<grid, warps * 32, smem, stream>>>(q, qsb, qsh, rows, pos, o, H, group, S, hd,
                                             window, scale);
  return (int)cudaGetLastError();
}

template <typename Rows>
int dispatch(const float* q, long long qsb, long long qsh, const Rows& rows, const int* pos,
             float* o, int B, int H, int KV, int S, int hd, int window, float scale, int gt,
             int warps, int vec, int slots, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || hd <= 0 || H % KV || B > 65535 ||
      warps < 1 || warps > kMaxWarps || (H / KV) % gt ||
      smem_bytes(gt, warps, hd, slots) > kMaxSmem || (vec && hd % 4))
    return (int)cudaErrorInvalidValue;
#define DECODE_LAUNCH(G)                                                                    \
  return vec ? launch<G, true>(q, qsb, qsh, rows, pos, o, B, H, KV, S, hd, window, scale,   \
                               warps, slots, stream)                                        \
             : launch<G, false>(q, qsb, qsh, rows, pos, o, B, H, KV, S, hd, window, scale,  \
                                warps, slots, stream)
  switch (gt) {
    case 1: DECODE_LAUNCH(1);
    case 2: DECODE_LAUNCH(2);
    case 4: DECODE_LAUNCH(4);
    case 8: DECODE_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
}

}  // namespace

extern "C" int decode_attention_fwd(const float* q, long long qsb, long long qsh, const float* k,
                                    long long ksb, long long ksh, long long kss, const float* v,
                                    long long vsb, long long vsh, long long vss, const int* pos,
                                    float* o, int B, int H, int KV, int S, int hd, int window,
                                    float scale, int heads_per_block, int warps, int vec,
                                    void* stream) {
  const DenseRows rows{k, v, ksb, ksh, kss, vsb, vsh, vss};
  return dispatch(q, qsb, qsh, rows, pos, o, B, H, KV, S, hd, window, scale, heads_per_block,
                  warps, vec, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_attention_fwd(const float* q, long long qsb, long long qsh,
                                          const float* k_pool, const float* v_pool,
                                          const int* tables, long long tsb, int T_blk, int NB,
                                          int BS, const int* pos, float* o, int B, int H, int KV,
                                          int hd, int window, float scale, int heads_per_block,
                                          int warps, int vec, void* stream) {
  if (T_blk <= 0 || NB <= 0 || BS <= 0) return (int)cudaErrorInvalidValue;
  const PagedRows rows{k_pool, v_pool, tables, tsb, NB, BS, KV, hd};
  return dispatch(q, qsb, qsh, rows, pos, o, B, H, KV, T_blk * BS, hd, window, scale,
                  heads_per_block, warps, vec, T_blk * BS,
                  static_cast<cudaStream_t>(stream));
}
