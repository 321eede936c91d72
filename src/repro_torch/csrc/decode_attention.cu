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

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kTile = 128;  // output dims a block covers: 4 a lane
constexpr int kStat = kTile + 4;  // per head: max, denominator, weight, block max, 128 dims
constexpr float kMaxFloor = -0.5e30f;
constexpr float kDenomFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;

template <int GT>
struct Shape {
  static constexpr int KC = GT >= 8 ? 4 : 8;  // keys a warp takes at once
  static constexpr int N = KC * GT;           // scores per step, <= 32
  static constexpr int L = N >= 32 ? 5 : N >= 16 ? 4 : 3;    // log2 N
  static constexpr int LG = GT >= 8 ? 3 : GT >= 4 ? 2 : GT >= 2 ? 1 : 0;  // log2 GT
};

struct DenseRows {
  static constexpr bool kPaged = false;
  const float* k;
  const float* v;
  long long ksb, ksh, kss, vsb, vsh, vss;
  __device__ const float* krow(const int*, int b, int kvh, int i) const {
    return k + b * ksb + kvh * ksh + i * kss;
  }
  __device__ const float* vrow(const int*, int b, int kvh, int i) const {
    return v + b * vsb + kvh * vsh + i * vss;
  }
};

struct PagedRows {
  static constexpr bool kPaged = true;
  const float* k;
  const float* v;
  const int* tables;
  long long tsb;
  int NB, BS, KV, hd;
  __device__ int pool_row(int b, int kvh, int i) const {
    const int page = min(max(tables[b * tsb + i / BS], 0), NB - 1);
    return (page * BS + i % BS) * KV + kvh;
  }
  __device__ const float* krow(const int* prow, int, int, int i) const {
    return k + (long long)prow[i] * hd;
  }
  __device__ const float* vrow(const int* prow, int, int, int i) const {
    return v + (long long)prow[i] * hd;
  }
};

// dims d .. d+3 of a row, zero past hd
template <bool kVec, bool kGlobal>
__device__ __forceinline__ float4 load4(const float* p, int d, int hd) {
  if (kVec) {
    if (d >= hd) return make_float4(0.f, 0.f, 0.f, 0.f);
    return kGlobal ? __ldg(reinterpret_cast<const float4*>(p + d))
                   : *reinterpret_cast<const float4*>(p + d);
  }
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = d + e < hd ? (kGlobal ? __ldg(p + d + e) : p[d + e]) : 0.f;
  return make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// Sum v[0..N) over the warp.  Each butterfly step K halves the values a
// lane keeps (template recursion, so every index is a constant and v stays
// in registers); afterwards lane l holds the sum of index l >> (5 - log2 N).
template <int N, int K, int L>
struct ReduceScatter {
  __device__ __forceinline__ static void step(float (&v)[N], int lane) {
    constexpr int half = N >> (K + 1), off = 16 >> K;
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
    ReduceScatter<N, K + 1, L>::step(v, lane);
  }
};

template <int N, int L>
struct ReduceScatter<N, L, L> {
  __device__ __forceinline__ static void step(float (&)[N], int) {}
};

template <int N, int L>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  ReduceScatter<N, 0, L>::step(v, lane);
  float s = v[0];
#pragma unroll
  for (int off = 16 >> L; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

template <int GT, bool kVec, typename Rows>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_kernel(const float* __restrict__ q, long long qsb, long long qsh, Rows rows,
              const int* __restrict__ pos, float* __restrict__ o, int H, int group, int S,
              int hd, int window, float scale) {
  constexpr int KC = Shape<GT>::KC, N = Shape<GT>::N, L = Shape<GT>::L, LG = Shape<GT>::LG;
  extern __shared__ __align__(16) float smem[];
  const int NW = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int DT = (hd + kTile - 1) / kTile;
  int y = blockIdx.x;
  const int dt = y % DT;
  y /= DT;
  const int tiles = group / GT;
  const int kvh = y / tiles;
  const int h0 = kvh * group + (y % tiles) * GT;  // the block's first query head
  const int b = blockIdx.y;

  float* sq = smem;                          // [GT][hd] queries, pre-scaled
  float* sw = sq + ((GT * hd + 3) & ~3);     // [NW][GT][kStat] per-warp softmax state
  float* ssc = sw + NW * GT * kStat;         // [NW][N] a warp's scores, then probabilities
  int* prow = reinterpret_cast<int*>(ssc + NW * N);  // [S] each slot's pool row (paged)

  // the valid keys: n ring slots ending at slot last mod S, ascending positions
  const int last = pos[b] - 1;
  int n = last < 0 ? 0 : min(last + 1, S);
  if (window >= 0) n = min(n, window);
  int start = (last - n + 1) % S;
  if (start < 0) start += S;

  for (int i = threadIdx.x; i < GT * hd; i += blockDim.x) {
    sq[i] = q[b * qsb + (h0 + i / hd) * qsh + i % hd] * scale;
  }
  if constexpr (Rows::kPaged) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) prow[i] = rows.pool_row(b, kvh, i);
  }
  __syncthreads();

  const int t_end = (int)((long long)n * (warp + 1) / NW);

  const int od = dt * kTile + lane * 4;  // the lane's output dims
  float m[GT], l[GT];
  float4 acc[GT];
#pragma unroll
  for (int hh = 0; hh < GT; ++hh) {
    m[hh] = kMaxFloor;
    l[hh] = 0.f;
    acc[hh] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float* sc = ssc + warp * N;

  for (int t0 = (int)((long long)n * warp / NW); t0 < t_end; t0 += KC) {
    const int nk = min(KC, t_end - t0);
    int slot[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      slot[c] = start + t0 + min(c, nk - 1);
      if (slot[c] >= S) slot[c] -= S;
    }
    float4 vv[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      vv[c] = c < nk ? load4<kVec, true>(rows.vrow(prow, b, kvh, slot[c]), od, hd)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float part[N];
#pragma unroll
    for (int i = 0; i < N; ++i) part[i] = 0.f;
    for (int d0 = lane * 4; d0 < DT * kTile; d0 += kTile) {
      float4 kk[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        kk[c] = c < nk ? load4<kVec, true>(rows.krow(prow, b, kvh, slot[c]), d0, hd)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int hh = 0; hh < GT; ++hh) {
        const float4 qv = load4<kVec, false>(sq + hh * hd, d0, hd);
#pragma unroll
        for (int c = 0; c < KC; ++c) part[c * GT + hh] = dot4(qv, kk[c], part[c * GT + hh]);
      }
    }
    // lane l now holds score idx = c * GT + hh; the lanes of one head take
    // its running max over the step by a butterfly across the c bits, and
    // the lane holding c = 0 hands it to every lane
    const int idx = lane >> (5 - L), hh_mine = idx % GT, c_mine = idx / GT;
    const float s = reduce_scatter<N, L>(part, lane);
    float mine = m[0];
#pragma unroll
    for (int hh = 1; hh < GT; ++hh) mine = hh_mine == hh ? m[hh] : mine;
    if (c_mine < nk) mine = fmaxf(mine, s);
#pragma unroll
    for (int off = 1 << (5 - L + LG); off < 32; off <<= 1)
      mine = fmaxf(mine, __shfl_xor_sync(kFull, mine, off));
    float mx[GT];
#pragma unroll
    for (int hh = 0; hh < GT; ++hh) mx[hh] = __shfl_sync(kFull, mine, hh << (5 - L));
    if ((lane & ((1 << (5 - L)) - 1)) == 0) sc[idx] = c_mine < nk ? expf(s - mine) : 0.f;
    __syncwarp();
#pragma unroll
    for (int hh = 0; hh < GT; ++hh) {
      const float alpha = expf(m[hh] - mx[hh]);
      float psum = 0.f;
      float4 a = make_float4(acc[hh].x * alpha, acc[hh].y * alpha, acc[hh].z * alpha,
                             acc[hh].w * alpha);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float p = sc[c * GT + hh];
        psum += p;
        a.x = __fmaf_rn(p, vv[c].x, a.x);
        a.y = __fmaf_rn(p, vv[c].y, a.y);
        a.z = __fmaf_rn(p, vv[c].z, a.z);
        a.w = __fmaf_rn(p, vv[c].w, a.w);
      }
      acc[hh] = a;
      l[hh] = __fmaf_rn(l[hh], alpha, psum);
      m[hh] = mx[hh];
    }
    __syncwarp();
  }

  // the warps' states, combined in warp order
#pragma unroll
  for (int hh = 0; hh < GT; ++hh) {
    float* st = sw + (warp * GT + hh) * kStat;
    if (lane == 0) {
      st[0] = m[hh];
      st[1] = l[hh];
    }
    *reinterpret_cast<float4*>(st + 4 + lane * 4) = acc[hh];
  }
  __syncthreads();
  // each warp's weight exp(m_w - M) per head, once: into its spare slot
  if (threadIdx.x < NW * GT) {
    const int hh = threadIdx.x % GT;
    float M = kMaxFloor;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sw[(w * GT + hh) * kStat]);
    float* st = sw + threadIdx.x * kStat;
    st[2] = expf(st[0] - M);
    st[3] = M;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GT * kTile; i += blockDim.x) {
    const int hh = i / kTile, d = i % kTile;
    const float M = sw[hh * kStat + 3];
    float Ls = 0.f, O = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* st = sw + (w * GT + hh) * kStat;
      Ls = __fmaf_rn(st[2], st[1], Ls);
      O = __fmaf_rn(st[2], st[4 + d], O);
    }
    if (dt * kTile + d < hd) o[((long long)b * H + h0 + hh) * hd + dt * kTile + d] =
        O / fmaxf(Ls, kDenomFloor);
  }
}

size_t smem_bytes(int gt, int warps, int hd, int slots) {
  const int kc = gt >= 8 ? 4 : 8;
  return ((((size_t)gt * hd + 3) & ~(size_t)3) + (size_t)warps * gt * kStat +
          (size_t)warps * kc * gt + slots) * sizeof(float);
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
