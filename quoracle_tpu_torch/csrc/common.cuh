// Scalar fp32 attention core of the port's fp32 prefill kernels:
// flash_fwd.cu and paged_prefill_fwd.cu in fp32, 32 query rows a block
// (their bf16 paths run on the tensor cores, tc_attention.cuh; the decode
// kernels paged_fwd.cu, ragged_fwd.cu and ragged_q8_fwd.cu run on the
// split-K core, split_kv.cuh, which takes NEG_INF, THREADS, to_float and
// dot4 from here).
//
// One block owns up to ROWS query rows that attend to the same key head.
// Keys stream through shared memory in tiles of BK rows; each tile runs
// the online softmax of the Pallas kernels it replaces: scores in fp32,
// masked entries set to NEG_INF (finite), probabilities re-masked to exact
// zeros so a fully masked row keeps l == 0 and writes 0, not NaN.
// Everything is held in fp32 in shared memory, so the kernels can be held
// tightly (1e-5) against the plain PyTorch version.
//
// A block has few warps (4) and, at 93-175 KB of shared memory, few
// neighbours on its SM, so little latency hiding: the inner loops read
// shared memory as 16-byte vectors (four FMAs per load instead of one).
//
// Layout of the dynamic shared memory (floats; every row 16-byte aligned):
//   q [ROWS][HD + 4]   query rows, pre-scaled by hd^-0.5
//   k [BK][HD + 4]     key tile (the pad of 4 floats keeps 16-byte rows and
//                      spreads 8 consecutive keys over all 32 banks)
//   v [BK][HD]         value tile (read along columns: no pad needed)
//   s [ROWS][BK + 4]   scores, then probabilities, of the tile
//   m, l, corr [ROWS]  running max, running denominator, rescale
// At ROWS 32, HD = 128 needs 93 KB and HD = 256 175 KB, below the 227 KB
// a block may opt into.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtt {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;       // four warps
constexpr int BK = 64;             // keys per shared-memory tile
constexpr int ROW_GROUPS = THREADS / BK;   // 2: score rows per key thread

template <int HD, int ROWS>
struct Smem {
  static_assert(HD % 128 == 0, "head_dim must be a multiple of 128");
  static_assert(ROWS % ROW_GROUPS == 0 && ROWS <= 32, "bad row count");
  static constexpr int QS = HD + 4;
  static constexpr int KS = HD + 4;
  static constexpr int SS = BK + 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + ROWS * QS;
  static constexpr int V = K + BK * KS;
  static constexpr int S = V + BK * HD;
  static constexpr int M = S + ROWS * SS;
  static constexpr int L = M + ROWS;
  static constexpr int C = L + ROWS;
  static constexpr int FLOATS = C + ROWS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// Copy `rows` rows of HD elements into shared fp32 rows of `stride`
// floats, each element multiplied by `scale`. row_ptr(r) gives the global
// address of row r, or nullptr for a row that is filled with zeros (past
// the valid keys: a zero value row times a zero probability stays 0,
// where stale memory could hold a NaN). Each thread first issues a batch
// of 8 independent 16-byte global reads, then converts and stores them as
// 16-byte shared writes, so the batch's memory latency is paid once, not
// once per read. Rows must start 16-byte aligned (the wrappers check
// contiguity, and HD * sizeof(T) is a multiple of 16).
template <typename T, int HD, typename RowPtr>
__device__ __forceinline__ void load_rows(float* dst, int stride, int rows,
                                          RowPtr row_ptr, float scale) {
  constexpr int VEC = 16 / sizeof(T);      // 8 bf16 or 4 fp32
  constexpr int CHUNKS = HD / VEC;
  constexpr int BATCH = 8;
  const int total = rows * CHUNKS;
  for (int base = 0; base < total; base += THREADS * BATCH) {
    uint4 raw[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + threadIdx.x + u * THREADS;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);  // all-zero bits: 0 in every T
      if (i < total) {
        const int r = i / CHUNKS;
        const T* src = row_ptr(r);
        if (src != nullptr)
          raw[u] = *reinterpret_cast<const uint4*>(src + (i - r * CHUNKS) * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + threadIdx.x + u * THREADS;
      if (i < total) {
        const int r = i / CHUNKS;
        float4* d = reinterpret_cast<float4*>(dst + r * stride +
                                              (i - r * CHUNKS) * VEC);
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e)
          d[e] = make_float4(to_float(vals[4 * e]) * scale,
                             to_float(vals[4 * e + 1]) * scale,
                             to_float(vals[4 * e + 2]) * scale,
                             to_float(vals[4 * e + 3]) * scale);
      }
    }
  }
}

template <int HD, int ROWS>
__device__ __forceinline__ void init_stats(float* sm) {
  using L = Smem<HD, ROWS>;
  if (threadIdx.x < ROWS) {
    sm[L::M + threadIdx.x] = NEG_INF;
    sm[L::L + threadIdx.x] = 0.f;
    sm[L::C + threadIdx.x] = 1.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One key tile (already in shared k/v) against the block's R <= ROWS
// query rows. visible(r, s) is the mask of query row r against absolute
// key index s (the tile's key j is key0 + j). acc[c][r] holds output
// column threadIdx.x + 128 c of row r. Ends with a barrier, so the caller
// may overwrite k/v right after.
template <int HD, int ROWS, typename Visible>
__device__ __forceinline__ void tile_update(float* sm, int R, int key0,
                                            Visible visible,
                                            float (&acc)[HD / 128][ROWS]) {
  using L = Smem<HD, ROWS>;
  constexpr int RPT = ROWS / ROW_GROUPS;    // score rows per thread
  const float* q = sm + L::Q;
  const float* k = sm + L::K;
  const float* v = sm + L::V;
  float* s = sm + L::S;
  float* m = sm + L::M;
  float* l = sm + L::L;
  float* corr = sm + L::C;

  // 1. scores: thread owns key j and rows r0, r0 + 2, ...; each 16-byte
  //    read of k feeds 4 FMAs per row, q reads are warp broadcasts
  {
    const int j = threadIdx.x % BK;
    const int r0 = threadIdx.x / BK;
    float dots[RPT];
#pragma unroll
    for (int t = 0; t < RPT; ++t) dots[t] = 0.f;
    const float* kr = k + j * L::KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        const int r = r0 + t * ROW_GROUPS;
        if (r < R)
          dots[t] = dot4(*reinterpret_cast<const float4*>(q + r * L::QS + d),
                         kd, dots[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      const int r = r0 + t * ROW_GROUPS;
      if (r < R) s[r * L::SS + j] = visible(r, key0 + j) ? dots[t] : NEG_INF;
    }
  }
  __syncthreads();

  // 2. online softmax, one warp per row, two keys per lane
  {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int r = warp; r < R; r += THREADS / 32) {
      float* sr = s + r * L::SS;
      const float s0 = sr[lane];
      const float s1 = sr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      // NEG_INF is finite: a fully masked tile gives exp(0) = 1 here, so
      // the probabilities are re-masked rather than taken from the score
      const float p0 = visible(r, key0 + lane) ? expf(s0 - m_new) : 0.f;
      const float p1 = visible(r, key0 + lane + 32) ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        l[r] = l[r] * c + sum;
        m[r] = m_new;
        corr[r] = c;
      }
    }
  }
  __syncthreads();

  // 3. acc = acc * corr + P V: thread owns output columns, all rows; four
  //    keys per step (one 16-byte broadcast read of p per row)
#pragma unroll
  for (int c = 0; c < HD / 128; ++c) {
    const int d = threadIdx.x + c * 128;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < R) acc[c][r] *= corr[r];
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      const float4 vj = make_float4(v[j * HD + d], v[(j + 1) * HD + d],
                                    v[(j + 2) * HD + d], v[(j + 3) * HD + d]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < R)
          acc[c][r] = dot4(*reinterpret_cast<const float4*>(s + r * L::SS + j),
                           vj, acc[c][r]);
    }
  }
  __syncthreads();
}

// Normalized output of the block: row r, column d goes to out_row(r) + d;
// rows whose denominator stayed 0 (nothing visible) write 0.
template <int HD, int ROWS, typename OutRow>
__device__ __forceinline__ void write_rows(const float* sm, int R,
                                           OutRow out_row,
                                           const float (&acc)[HD / 128][ROWS]) {
  using L = Smem<HD, ROWS>;
  const float* l = sm + L::L;
#pragma unroll
  for (int c = 0; c < HD / 128; ++c) {
    const int d = threadIdx.x + c * 128;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < R) {
        const float den = l[r];
        out_row(r)[d] = den > 0.f ? acc[c][r] / den : 0.f;
      }
    }
  }
}

// Unnormalized partials of the block (the direct tier's kernels): row r
// writes acc to acc_row(r) + d and its running max and denominator to
// *m_ptr(r), *l_ptr(r). A row that saw no key writes exactly
// (0, NEG_INF, 0), which the merge with the dense piece relies on.
template <int HD, int ROWS, typename AccRow, typename MPtr, typename LPtr>
__device__ __forceinline__ void write_partials(
    const float* sm, int R, AccRow acc_row, MPtr m_ptr, LPtr l_ptr,
    const float (&acc)[HD / 128][ROWS]) {
  using L = Smem<HD, ROWS>;
  const float* m = sm + L::M;
  const float* l = sm + L::L;
#pragma unroll
  for (int c = 0; c < HD / 128; ++c) {
    const int d = threadIdx.x + c * 128;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < R) acc_row(r)[d] = l[r] > 0.f ? acc[c][r] : 0.f;
  }
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const bool seen = l[r] > 0.f;
    *m_ptr(r) = seen ? m[r] : NEG_INF;
    *l_ptr(r) = seen ? l[r] : 0.f;
  }
}

}  // namespace qtt
