// Split-K decode core of the port's paged decode kernels: paged_fwd.cu
// (the direct tier), ragged_fwd.cu (the unified tier) and ragged_q8_fwd.cu
// (the unified tier over int8 pools), in every dtype.
//
// A block owns up to ROWS score rows that attend to one KV head of one
// page table (G query heads of one decode query, or tq queries x G heads
// of a ragged chunk block) and ONE SHARE of their keys: the grid is
// (blocks, KV, S), and block s takes the s-th of S equal shares of the
// rows' visible range [lo, hi), in whole 64-key tiles (KEY_TILE). S comes
// from the host (paged_attention.split_count: about four blocks per SM,
// from the grid alone; the host never reads kv_len). Each share writes
// its online-softmax partial (acc unnormalized, m, l) to an fp32
// workspace, and combine_kernel, the second launch of the same entry
// point, merges the S partials of each row in a fixed order. With S = 1
// the share writes the final output itself and no combine runs.
//
//   * Loads in flight: K/V stream in the page's own dtype (fp32, bf16 or
//     int8 plus the stage's scales) through a 2-stage ring of BN-key
//     stages filled by 16-byte cp.async.cg copies; stage i + 1 is in
//     flight while stage i computes. Keys outside [lo, hi) are zero-filled
//     by the copy's src-size (and an int8 key's scale is taken as 0), so
//     no stale NaN meets a zero probability. Elements turn into fp32 when
//     read; an int8 element is the fp32 product int8 x scale, the very
//     value of the plain twin's k.float() * scale, so every
//     instantiation keeps the scalar core's 1e-5 bars. No tensor cores.
//   * Decode-shaped inner loop (ROWS 4 or 8: tq = 1, G <= 8): each warp
//     owns a quarter of every stage's keys and ALL rows, copies its own
//     keys and keeps its own softmax state, so the tile loop needs no
//     block barrier, only __syncwarp; the four warps' states merge once,
//     at the end of the share, through shared memory.
//   * Chunk blocks (ROWS 32: tq = 8, G = 4): each warp owns 8 rows and
//     all keys of a stage; one __syncthreads a stage.
//   * In both, lanes split a key's dot product (q read from shared memory
//     as broadcasts, scores summed with xor shuffles), the softmax runs in
//     registers (NEG_INF is finite: probabilities of invisible keys are
//     re-masked to exact zeros), each warp stages its probabilities in a
//     small shared buffer, and for P.V each lane owns HD / 32 output
//     columns of every row.
//   * Every row's visible keys are one interval [row_lo, row_hi) inside
//     the block's [lo, hi); the mask is two compares.
//   * The combine is launched with Hopper's programmatic dependent launch
//     (cudaLaunchKernelEx, programmatic stream serialization): the split
//     pass signals griddepcontrol.launch_dependents as it starts, the
//     combine's blocks are scheduled early and wait in griddepcontrol.wait
//     for the split pass to end, which hides the second launch's ramp
//     (~1 us of ~25, PERF.md).
//   * The combine masks a partial with l == 0 explicitly: exp(NEG_INF -
//     NEG_INF) = 1 would otherwise weigh an empty share's slot into a row
//     that saw no key. Rows that saw no key end as (0, NEG_INF, 0)
//     (partials) or 0 (normalized output).
//
// Shared memory: ring 2 x (K and V: BN rows of HD elements + 16 bytes of
// pad, int8: + 2 x BN scales), q [ROWS][HD + 4] fp32, probabilities
// [4 warps][WR][WK + 4]; the end-of-share merge reuses the ring. bf16 hd
// 128: 73 KB; int8 hd 128: 39 KB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tc_attention.cuh"

namespace qtt {
namespace skv {

constexpr int WARPS = THREADS / 32;
constexpr int KEY_TILE = 64;      // keys a share unit (page % 64 == 0)
constexpr unsigned FULL = 0xffffffffu;

template <typename P, int HD, int ROWS>
struct Cfg {
  static_assert(HD == 128 || HD == 256, "head_dim 128 or 256");
  static_assert(ROWS == 4 || ROWS == 8 || ROWS == 32, "4, 8 or 32 rows");
  static constexpr bool SCALED = std::is_same<P, int8_t>::value;
  static constexpr int ROW_BYTES = HD * (int)sizeof(P);
  static constexpr int BN = ROW_BYTES <= 256 ? 64 : 32;   // keys a stage
  static constexpr int RS = ROW_BYTES + 16;     // odd count of 16-byte units
  static constexpr int CH = ROW_BYTES / 16;     // 16-byte chunks a row
  static constexpr int VEC = 16 / (int)sizeof(P);
  static constexpr bool KEY_SPLIT = ROWS <= 8;
  static constexpr int WR = KEY_SPLIT ? ROWS : ROWS / WARPS;  // rows a warp
  static constexpr int WK = KEY_SPLIT ? BN / WARPS : BN;     // keys a warp
  static constexpr int KL = WK < 32 ? WK : 32;  // lanes holding distinct keys
  static constexpr int SPLIT = 32 / KL;         // lanes sharing one key
  static constexpr int KPL = WK / KL;           // keys a lane
  static constexpr int DPL = HD / SPLIT;        // score dims a lane
  static constexpr int VPL = HD / 32;           // output columns a lane
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = BN * RS;
  static constexpr int KS_OFF = 2 * BN * RS;
  static constexpr int VS_OFF = KS_OFF + BN * 4;
  static constexpr int STAGE = 2 * BN * RS + (SCALED ? 2 * BN * 4 : 0);
  static constexpr int RING = 2 * STAGE;
  static constexpr int QS = HD + 4;
  static constexpr int Q_OFF = RING;
  static constexpr int PS = WK + 4;
  static constexpr int P_OFF = Q_OFF + ROWS * QS * 4;
  static constexpr int BYTES = P_OFF + WARPS * WR * PS * 4;
  static constexpr int RED = KEY_SPLIT ? WARPS * ROWS * (HD + 2) * 4 : 0;
  static_assert(RED <= RING, "the merge buffer must fit in the ring");
  static_assert(DPL % VEC == 0 && WK % 4 == 0, "bad lane split");
  static_assert((WK * CH) % 32 == 0 && (BN * CH) % THREADS == 0,
                "bad copy split");
};

// N elements of type P at src (16-byte aligned runs, or one 8- or 4-byte
// run) as fp32, each times s when P is int8.
template <typename P, int N>
__device__ __forceinline__ void load_vals(const unsigned char* src,
                                          float (&out)[N], float s) {
  constexpr int BYTES = N * (int)sizeof(P);
  constexpr bool SCALED = std::is_same<P, int8_t>::value;
  if constexpr (BYTES >= 16) {
    constexpr int E = 16 / (int)sizeof(P);
#pragma unroll
    for (int u = 0; u < BYTES / 16; ++u) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + 16 * u);
      const P* v = reinterpret_cast<const P*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e)
        out[u * E + e] = SCALED ? to_float(v[e]) * s : to_float(v[e]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const P* v = reinterpret_cast<const P*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e)
      out[e] = SCALED ? to_float(v[e]) * s : to_float(v[e]);
  } else {
    static_assert(BYTES == 4, "4, 8 or a multiple of 16 bytes");
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(src);
    const P* v = reinterpret_cast<const P*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e)
      out[e] = SCALED ? to_float(v[e]) * s : to_float(v[e]);
  }
}

// Where a block's rows go. Final outputs: acc [n_out, HD] (normalized
// output when NORMALIZE, else the unnormalized acc) and, for partials, m
// and l [n_out]. ws: the S > 1 workspace, acc [n_out][S][HD], then m and
// l [n_out][S].
struct Out {
  float* acc;
  float* m;
  float* l;
  float* ws;
  int n_out;
};

// Masked merge of n partials (m_i, l_i, acc_i): a partial with l == 0 is
// skipped outright, never weighed by its exponent.
template <typename Get>
__device__ __forceinline__ void merge(int n, Get get, float& m, float& l,
                                      float& a) {
  m = NEG_INF;
  for (int i = 0; i < n; ++i) {
    float mi, li, ai;
    get(i, mi, li, ai, false);
    if (li > 0.f) m = fmaxf(m, mi);
  }
  l = 0.f;
  a = 0.f;
  for (int i = 0; i < n; ++i) {
    float mi, li, ai;
    get(i, mi, li, ai, false);
    if (li > 0.f) {
      get(i, mi, li, ai, true);
      const float c = expf(mi - m);
      l = fmaf(li, c, l);
      a = fmaf(ai, c, a);
    }
  }
}

template <int HD, bool NORMALIZE>
__device__ __forceinline__ void write_final(const Out& out, size_t o, int d,
                                            float a, float m, float l) {
  const bool seen = l > 0.f;
  if constexpr (NORMALIZE) {
    out.acc[o * HD + d] = seen ? a / l : 0.f;
  } else {
    out.acc[o * HD + d] = seen ? a : 0.f;
    if (d == 0) {
      out.m[o] = seen ? m : NEG_INF;
      out.l[o] = seen ? l : 0.f;
    }
  }
}

// Row r, column d of this share's result: the final output when S == 1,
// else its slot in the workspace (an empty partial as (0, NEG_INF, 0)).
template <int HD, bool NORMALIZE>
__device__ __forceinline__ void emit(const Out& out, size_t o, int d,
                                     float a, float m, float l) {
  const int S = gridDim.z;
  if (S == 1) {
    write_final<HD, NORMALIZE>(out, o, d, a, m, l);
    return;
  }
  const size_t slot = o * S + blockIdx.z;
  const bool seen = l > 0.f;
  out.ws[slot * HD + d] = seen ? a : 0.f;
  if (d == 0) {
    float* wm = out.ws + (size_t)out.n_out * S * HD;
    wm[slot] = seen ? m : NEG_INF;
    wm[(size_t)out.n_out * S + slot] = seen ? l : 0.f;
  }
}

// One block's share. The caller has read its meta: R live score rows,
// the union [lo, hi) of their visible keys (hi <= maxp * page),
// row_range(r) -> int2 (row_lo, row_hi) inside it, q_row(r) -> the global
// q row of T, out_row(r) -> its output row index. table: the rows' page
// table; pages [n_pages, page, n_kv, HD] of P; scales (int8 only)
// [n_pages, n_kv, page] fp32. Must be called by every thread of the block.
template <typename T, typename P, int HD, int ROWS, bool NORMALIZE,
          typename RowRange, typename QRow, typename ORow>
__device__ __forceinline__ void run_share(
    unsigned char* sm, const int* __restrict__ table, int R, int lo, int hi,
    RowRange row_range, QRow q_row, ORow out_row,
    const P* __restrict__ k_pages, const P* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int n_kv, int kvh, int page, float scale, const Out& out) {
  using C = Cfg<P, HD, ROWS>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int S = gridDim.z;
  const int s = blockIdx.z;
  // the combine may start its launch now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // this share: tiles [s * tiles / S, (s + 1) * tiles / S) of the range
  const int tlo = (lo / KEY_TILE) * KEY_TILE;
  const int tiles = hi > lo ? (hi - tlo + KEY_TILE - 1) / KEY_TILE : 0;
  const int k_begin = tlo + (int)((long long)s * tiles / S) * KEY_TILE;
  const int k_end =
      min(tlo + (int)((long long)(s + 1) * tiles / S) * KEY_TILE, hi);
  const int stages = k_end > k_begin ? (k_end - k_begin + C::BN - 1) / C::BN
                                     : 0;
  if (stages == 0) {                   // nothing visible: empty partials
    for (int idx = threadIdx.x; idx < R * HD; idx += THREADS)
      emit<HD, NORMALIZE>(out, out_row(idx / HD), idx % HD, 0.f, NEG_INF,
                          0.f);
    return;
  }

  // this thread's copies of one stage (keys key0 .. key0 + BN, one page):
  // a warp's own keys in the decode layout, a share of all in the chunk
  // layout
  const size_t kv_row = (size_t)n_kv * HD;
  const int r_lo = C::KEY_SPLIT ? warp * C::WK : 0;
  auto issue = [&](int st, int key0) {
    constexpr int NR = C::KEY_SPLIT ? C::WK : C::BN;
    constexpr int NT = C::KEY_SPLIT ? 32 : THREADS;
    const int tid = C::KEY_SPLIT ? lane : (int)threadIdx.x;
    unsigned char* base = sm + st * C::STAGE;
    const size_t pid = (size_t)table[key0 / page];
    const int in_page = key0 % page;
    const size_t row0 = (pid * page + in_page) * kv_row + (size_t)kvh * HD;
#pragma unroll
    for (int u = 0; u < NR * C::CH / NT; ++u) {
      const int idx = tid + u * NT;
      const int r = r_lo + idx / C::CH;
      const int c = idx % C::CH;
      const bool ok = key0 + r >= lo && key0 + r < hi;
      const size_t off = row0 + (size_t)r * kv_row + (size_t)c * C::VEC;
      const uint32_t d = tc::smem_addr(base + r * C::RS + c * 16);
      tc::cp_async16(d + C::K_OFF, k_pages + off, ok);
      tc::cp_async16(d + C::V_OFF, v_pages + off, ok);
    }
    if constexpr (C::SCALED) {
      constexpr int NC = NR / 4;       // 16-byte runs of scales a tensor
      if (tid < 2 * NC) {
        const int kind = tid / NC;
        const int j = r_lo + 4 * (tid % NC);
        const float* src = (kind ? v_scale : k_scale) +
                           (pid * n_kv + kvh) * page + in_page + j;
        tc::cp_async16(
            tc::smem_addr(base + (kind ? C::VS_OFF : C::KS_OFF) + j * 4),
            src, true);
      }
    }
  };
  issue(0, k_begin);
  tc::cp_async_commit();

  // q rows, pre-scaled by hd^-0.5 in fp32 (while stage 0 is in flight)
  float* qs = reinterpret_cast<float*>(sm + C::Q_OFF);
  {
    constexpr int QV = 16 / (int)sizeof(T);
    constexpr int QCH = HD / QV;
    for (int idx = threadIdx.x; idx < ROWS * QCH; idx += THREADS) {
      const int r = idx / QCH;
      const int c = idx % QCH;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < R) raw = *reinterpret_cast<const uint4*>(q_row(r) + c * QV);
      const T* v = reinterpret_cast<const T*>(&raw);
      float4* dst = reinterpret_cast<float4*>(qs + r * C::QS + c * QV);
#pragma unroll
      for (int e = 0; e < QV / 4; ++e)
        dst[e] = make_float4(to_float(v[4 * e]) * scale,
                             to_float(v[4 * e + 1]) * scale,
                             to_float(v[4 * e + 2]) * scale,
                             to_float(v[4 * e + 3]) * scale);
    }
  }

  const int rb = C::KEY_SPLIT ? 0 : warp * C::WR;    // first row of warp
  const int kb = C::KEY_SPLIT ? warp * C::WK : 0;    // first key of warp
  const int nr = min(max(R - rb, 0), C::WR);         // live rows of warp
  const int kl = lane % C::KL;
  const int part = lane / C::KL;
  int rlo[C::WR], rhi[C::WR];
  float m[C::WR], l[C::WR], acc[C::WR][C::VPL];
#pragma unroll
  for (int r = 0; r < C::WR; ++r) {
    const int2 rr = r < nr ? row_range(rb + r) : make_int2(0, 0);
    rlo[r] = rr.x;
    rhi[r] = rr.y;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < C::VPL; ++j) acc[r][j] = 0.f;
  }
  float* pb = reinterpret_cast<float*>(sm + C::P_OFF) + warp * C::WR * C::PS;
  __syncthreads();                     // q is in shared memory

  for (int it = 0; it < stages; ++it) {
    // stage it has landed for every thread that reads it, and every
    // reader is done with the stage the next copy overwrites
    tc::cp_async_wait<0>();
    if constexpr (C::KEY_SPLIT) __syncwarp(); else __syncthreads();
    if (it + 1 < stages) issue((it + 1) & 1, k_begin + (it + 1) * C::BN);
    tc::cp_async_commit();
    const unsigned char* st = sm + (it & 1) * C::STAGE;
    const float* kss = reinterpret_cast<const float*>(st + C::KS_OFF);
    const float* vss = reinterpret_cast<const float*>(st + C::VS_OFF);
    const int key0 = k_begin + it * C::BN;

    // scores: lane (kl, part) takes dims [part * DPL, +DPL) of keys
    // kb + kl + 32 i, summed over the parts with xor shuffles
    float dots[C::KPL][C::WR];
#pragma unroll
    for (int i = 0; i < C::KPL; ++i)
#pragma unroll
      for (int r = 0; r < C::WR; ++r) dots[i][r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < C::DPL / C::VEC; ++c) {
      const int d = part * C::DPL + c * C::VEC;
      float kf[C::KPL][C::VEC];
#pragma unroll
      for (int i = 0; i < C::KPL; ++i) {
        const int kr = kb + kl + 32 * i;
        load_vals<P, C::VEC>(st + C::K_OFF + kr * C::RS + d * sizeof(P),
                             kf[i], C::SCALED ? kss[kr] : 1.f);
      }
#pragma unroll
      for (int r = 0; r < C::WR; ++r) {
        if (r < nr) {
#pragma unroll
          for (int e = 0; e < C::VEC / 4; ++e) {
            const float4 q4 = *reinterpret_cast<const float4*>(
                qs + (rb + r) * C::QS + d + 4 * e);
#pragma unroll
            for (int i = 0; i < C::KPL; ++i)
              dots[i][r] = dot4(q4, make_float4(kf[i][4 * e], kf[i][4 * e + 1],
                                                kf[i][4 * e + 2],
                                                kf[i][4 * e + 3]),
                                dots[i][r]);
          }
        }
      }
    }
#pragma unroll
    for (int o = C::KL; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < C::KPL; ++i)
#pragma unroll
        for (int r = 0; r < C::WR; ++r)
          dots[i][r] += __shfl_xor_sync(FULL, dots[i][r], o);

    // online softmax of each row over the warp's keys (nr is uniform
    // across the warp, so the shuffles below are too)
#pragma unroll
    for (int r = 0; r < C::WR; ++r) {
      if (r < nr) {
        bool vis[C::KPL];
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < C::KPL; ++i) {
          const int key = key0 + kb + kl + 32 * i;
          vis[i] = key >= rlo[r] && key < rhi[r];
          if (vis[i]) mx = fmaxf(mx, dots[i][r]);
        }
#pragma unroll
        for (int o = 1; o < C::KL; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_new = fmaxf(m[r], mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < C::KPL; ++i) {
          const float p = vis[i] ? expf(dots[i][r] - m_new) : 0.f;
          sum += p;
          if (part == 0) pb[r * C::PS + kl + 32 * i] = p;
        }
#pragma unroll
        for (int o = 1; o < C::KL; o <<= 1)
          sum += __shfl_xor_sync(FULL, sum, o);
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + sum;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < C::VPL; ++j) acc[r][j] *= corr;
      }
    }
    __syncwarp();

    // acc += P V: lane owns columns lane * VPL .. + VPL of every row
#pragma unroll 2
    for (int k = 0; k < C::WK; k += 4) {
      float4 p4[C::WR];
#pragma unroll
      for (int r = 0; r < C::WR; ++r)
        p4[r] = r < nr ? *reinterpret_cast<const float4*>(pb + r * C::PS + k)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int kr = kb + k + kk;
        float vs = 1.f;
        if constexpr (C::SCALED) {
          const int key = key0 + kr;
          vs = key >= lo && key < hi ? vss[kr] : 0.f;
        }
        float vf[C::VPL];
        load_vals<P, C::VPL>(
            st + C::V_OFF + kr * C::RS + lane * C::VPL * sizeof(P), vf, vs);
#pragma unroll
        for (int r = 0; r < C::WR; ++r) {
          const float pk = kk == 0 ? p4[r].x : kk == 1 ? p4[r].y
                           : kk == 2 ? p4[r].z : p4[r].w;
#pragma unroll
          for (int j = 0; j < C::VPL; ++j)
            acc[r][j] = fmaf(pk, vf[j], acc[r][j]);
        }
      }
    }
  }

  if constexpr (C::KEY_SPLIT) {
    // the four warps' states of each row, merged through shared memory
    __syncthreads();                   // every warp is done with the ring
    float* red = reinterpret_cast<float*>(sm);
    float* red_m = red + WARPS * ROWS * HD;
    float* red_l = red_m + WARPS * ROWS;
#pragma unroll
    for (int r = 0; r < C::WR; ++r) {
#pragma unroll
      for (int j = 0; j < C::VPL; ++j)
        red[(warp * ROWS + r) * HD + lane * C::VPL + j] = acc[r][j];
      if (lane == 0) {
        red_m[warp * ROWS + r] = m[r];
        red_l[warp * ROWS + r] = l[r];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * HD; idx += THREADS) {
      const int r = idx / HD;
      const int d = idx % HD;
      float mm, ll, aa;
      merge(WARPS, [&](int w, float& mi, float& li, float& ai, bool full) {
        mi = red_m[w * ROWS + r];
        li = red_l[w * ROWS + r];
        if (full) ai = red[(w * ROWS + r) * HD + d];
      }, mm, ll, aa);
      emit<HD, NORMALIZE>(out, out_row(r), d, aa, mm, ll);
    }
  } else {
#pragma unroll
    for (int r = 0; r < C::WR; ++r)
      if (r < nr)
#pragma unroll
        for (int j = 0; j < C::VPL; ++j)
          emit<HD, NORMALIZE>(out, out_row(rb + r), lane * C::VPL + j,
                              acc[r][j], m[r], l[r]);
  }
}

// One block of a ragged kernel's flat tick (ragged_fwd.cu, and
// ragged_q8_fwd.cu with int8 pages and their scales): block blockIdx.x of
// tq query tokens, meta (kv_len, qpos0, nq), its rows' page table, and
// the tq * G score rows of KV head blockIdx.y, row r = query r / G, head
// kvh * G + r % G. Row r sees keys [max(qpos + 1 - window, 0),
// min(kv_len, qpos + 1, maxp * page)) when t < nq, nothing otherwise;
// the block's range is the first query's start to the last live query's
// end (inert blocks: empty, so they read no page). Output normalized.
template <typename T, typename P, int HD, int ROWS>
__device__ __forceinline__ void ragged_block(
    unsigned char* sm, const T* __restrict__ q,
    const P* __restrict__ k_pages, const P* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ tables, const int* __restrict__ meta, int tq,
    int n_h, int n_kv, int page, int maxp, int window, float scale,
    const Out& out) {
  const int i = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = n_h / n_kv;
  const int kv_len = meta[i * 3 + 0];
  const int qpos0 = meta[i * 3 + 1];
  const int nq = meta[i * 3 + 2];
  const int cap = maxp * page;

  auto row_range = [=](int r) {
    const int t = r / G;
    if (t >= nq) return make_int2(0, 0);
    const int qpos = qpos0 + t;
    const int rhi = max(min(min(kv_len, qpos + 1), cap), 0);
    const int rlo = window >= 0 ? max(qpos + 1 - window, 0) : 0;
    return make_int2(min(rlo, rhi), rhi);
  };
  int lo = 0, hi = 0;
  if (nq > 0) {
    lo = row_range(0).x;
    hi = row_range((nq - 1) * G).y;
    lo = min(lo, hi);
  }
  auto out_row = [=](int r) {
    const int t = r / G;
    return (size_t)(i * tq + t) * n_h + kvh * G + (r - t * G);
  };
  run_share<T, P, HD, ROWS, true>(
      sm, tables + (size_t)i * maxp, tq * G, lo, hi, row_range,
      [=](int r) { return q + out_row(r) * HD; }, out_row, k_pages, v_pages,
      k_scale, v_scale, n_kv, kvh, page, scale, out);
}

// The second launch when S > 1: one block per output row merges its S
// partials in share order (masked by l == 0) and writes the final output.
template <int HD, bool NORMALIZE>
__global__ void __launch_bounds__(THREADS)
combine_kernel(Out out, int S) {
  // programmatic dependent launch: wait until the split pass has ended
  // and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t o = blockIdx.x;
  const float* wa = out.ws + o * S * HD;
  const float* wm = out.ws + (size_t)out.n_out * S * HD + o * S;
  const float* wl = wm + (size_t)out.n_out * S;
#pragma unroll
  for (int c = 0; c < HD / THREADS; ++c) {
    const int d = threadIdx.x + c * THREADS;
    float mm, ll, aa;
    merge(S, [&](int i, float& mi, float& li, float& ai, bool full) {
      mi = wm[i];
      li = wl[i];
      if (full) ai = wa[(size_t)i * HD + d];
    }, mm, ll, aa);
    write_final<HD, NORMALIZE>(out, o, d, aa, mm, ll);
  }
}

// Launch the split pass on grid (blocks, n_kv, splits) and, when splits >
// 1, the combine over n_out rows as its programmatic dependent. Returns a
// cudaError_t.
template <typename P, int HD, int ROWS, bool NORMALIZE, typename Kern,
          typename... Args>
int launch(Kern kern, int blocks, int n_kv, int splits, const Out& out,
           cudaStream_t stream, Args... args) {
  using C = Cfg<P, HD, ROWS>;
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(blocks, n_kv, splits), THREADS, C::BYTES, stream>>>(args...,
                                                                   out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(out.n_out);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, combine_kernel<HD, NORMALIZE>, out,
                                 splits);
}

}  // namespace skv
}  // namespace qtt
