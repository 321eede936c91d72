// B3's device code, shared by the decode-attention kernel
// (decode_attention.cu) and M5, the persistent attention-LM decode
// (attn_lm.cu).  decode_attention.cu carries the design note.

#pragma once

#include <cuda_runtime.h>

namespace decode_attn {

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

// One block's work: batch row b, tile bx of (KV head, head tile, output
// dims), NW warps of the block's keys (warps past NW idle), in `smem`
// (smem_bytes(GT, NW, hd, paged ? S : 0) floats' bytes).  K/V rows are read
// through the read-only path when kLdg, else through L1/L2: M5 (attn_lm.cu)
// reads pools that its own launch writes.  The kernel calls it once with its
// block index; M5 calls it for each tile its block takes, with a barrier
// between two calls.
template <int GT, bool kVec, bool kLdg, typename Rows>
__device__ __forceinline__ void decode_block(const float* q, long long qsb, long long qsh,
                                             const Rows& rows, const int* pos, float* o, int H,
                                             int group, int S, int hd, int window, float scale,
                                             int bx, int b, int NW, float* smem) {
  constexpr int KC = Shape<GT>::KC, N = Shape<GT>::N, L = Shape<GT>::L, LG = Shape<GT>::LG;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int DT = (hd + kTile - 1) / kTile;
  int y = bx;
  const int dt = y % DT;
  y /= DT;
  const int tiles = group / GT;
  const int kvh = y / tiles;
  const int h0 = kvh * group + (y % tiles) * GT;  // the block's first query head

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

  const bool busy = warp < NW;
  const int t_end = busy ? (int)((long long)n * (warp + 1) / NW) : 0;

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

  for (int t0 = busy ? (int)((long long)n * warp / NW) : 0; t0 < t_end; t0 += KC) {
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
      vv[c] = c < nk ? load4<kVec, kLdg>(rows.vrow(prow, b, kvh, slot[c]), od, hd)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float part[N];
#pragma unroll
    for (int i = 0; i < N; ++i) part[i] = 0.f;
    for (int d0 = lane * 4; d0 < DT * kTile; d0 += kTile) {
      float4 kk[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        kk[c] = c < nk ? load4<kVec, kLdg>(rows.krow(prow, b, kvh, slot[c]), d0, hd)
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
    if (busy && lane == 0) {
      st[0] = m[hh];
      st[1] = l[hh];
    }
    if (busy) *reinterpret_cast<float4*>(st + 4 + lane * 4) = acc[hh];
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

inline size_t smem_bytes(int gt, int warps, int hd, int slots) {
  const int kc = gt >= 8 ? 4 : 8;
  return ((((size_t)gt * hd + 3) & ~(size_t)3) + (size_t)warps * gt * kStat +
          (size_t)warps * kc * gt + slots) * sizeof(float);
}

}  // namespace decode_attn
