// Tensor-core attention core of the port's bf16 prefill kernels
// (flash_fwd.cu and paged_prefill_fwd.cu; their fp32 instantiations keep
// common.cuh's scalar path, the reference dtype's 1e-5 bar).
//
// A block of 4 warps owns ROWS = 64 score rows: TQ = 64 / G queries times
// the G query heads of one KV head, row r being query r / G and head
// kvh·G + r % G. Warp w owns rows 16w..16w+15, as the A operand of
// mma.sync m16n8k16 (bf16 in, fp32 sums). Rows past the block's queries
// (the last block of a chunk, or the 64 % G rows no query fills) are
// computed on zero q and never written.
//
//   * Q is copied once into shared memory in bf16 and, at hd 128, held in
//     registers as A fragments (ldmatrix); at hd 256 the fragments are
//     re-read from shared memory per tile, which keeps the 16 x 256 fp32
//     accumulator (128 registers a thread) from spilling.
//   * K and V stream in bf16, never widened, through a ring of 2 stages of
//     BN-key tiles (64 keys at hd 128, 32 at hd 256) filled by 16-byte
//     cp.async.cg copies: tile i + 1 is in flight while tile i is
//     computed. Each thread copies one fixed 16-byte chunk of every
//     (128 / chunks)-th row, an unrolled run of copies with one swizzle.
//     Keys past the valid range are zero-filled by the copy itself
//     (src-size 0), so no stale NaN meets a zero probability.
//   * Every row of a tile is HD bf16 = HD / 8 chunks of 16 bytes, chunk c
//     of row r stored at chunk c ^ (r & 7): the 8 rows an ldmatrix phase
//     reads land in 8 distinct 16-byte bank groups.
//   * S = Q·K^T on the tensor cores (K stored [key][hd] is the col-major
//     B operand as it stands), scaled by hd^-0.5 in fp32, so q stays
//     exact. Each row's visible keys are one interval [lo, hi), so a mask
//     is two compares and a select, no branch, and only tiles that
//     straddle an edge (causal diagonal, kv_len, window, rows without a
//     query) are masked at all.
//   * Online softmax in registers: each thread holds two rows (lane / 4
//     and lane / 4 + 8 of its warp's 16), row max and sum across the quad
//     with __shfl_xor_sync, exp(x) as ex2.approx(x·log2 e), one MUFU op;
//     NEG_INF stays finite and p is re-masked to 0; l sums the fp32 p,
//     and P goes to bf16 in registers as the A operand of P·V (the C
//     fragment of S is laid out as that A fragment), V through
//     ldmatrix.trans.
//
// What bounds it on the card (PERF.md): not the tensor cores but the
// instructions issued around them. The first version of this core spent
// most of a tile on a runtime copy loop, masks compiled to branch
// ladders and exp's slow paths, hence the unrolled copies, interval
// masks and ex2 above. Two m-tiles per warp, a third stage and 32-key
// tiles at hd 128 measured no faster.
//
// Shared memory: Q 64·HD·2 bytes + 2 stages · 2 · BN·HD·2 bytes = 80 KB
// at hd 128 (2 blocks per SM), 96 KB at hd 256.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;      // four warps
constexpr int ROWS = 64;          // score rows per block, 16 per warp
constexpr int STAGES = 2;

template <int HD>
struct Cfg {
  static_assert(HD == 128 || HD == 256, "head_dim 128 or 256");
  static constexpr int BN = HD == 128 ? 64 : 32;   // keys per tile
  static constexpr bool Q_IN_REGS = HD == 128;
  static constexpr int CHUNKS = HD / 8;            // 16-byte chunks a row
  static constexpr int ROW_BYTES = HD * 2;
  static constexpr int Q_BYTES = ROWS * ROW_BYTES;
  static constexpr int TILE_BYTES = BN * ROW_BYTES;
  static constexpr int BYTES = Q_BYTES + STAGES * 2 * TILE_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of chunk c of row r in a swizzled tile of HD-wide rows
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * Cfg<HD>::ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// 16-byte async copy; valid == false writes 16 zero bytes (src unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a · b, one m16n8k16 product with fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy the block's ROWS q rows into a swizzled shared tile (once a
// block): row r from q_row(r), or zero-filled where that is nullptr.
// `any` is a valid global address handed to the zero-filling copies.
template <int HD, typename QRow>
__device__ __forceinline__ void load_q(uint32_t dst, QRow q_row,
                                       const bf16* any) {
  constexpr int CH = Cfg<HD>::CHUNKS;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bf16* src = q_row(r);
    cp_async16(dst + swz<HD>(r, c), src ? src + c * 8 : any, src != nullptr);
  }
}

// Copy a BN-key tile, rows at base + r·stride (r < n; the rest zero-
// filled), into a swizzled shared tile: each thread copies one fixed
// 16-byte chunk of rows r0, r0 + 128/CH, ..., an unrolled run of copies.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          size_t stride, int n) {
  constexpr int CH = Cfg<HD>::CHUNKS;
  constexpr int RPP = THREADS / CH;                // rows per pass
  static_assert(Cfg<HD>::BN % RPP == 0, "whole passes");
  const int c = threadIdx.x % CH;
  const int r0 = threadIdx.x / CH;
#pragma unroll
  for (int u = 0; u < Cfg<HD>::BN / RPP; ++u) {
    const int r = r0 + u * RPP;
    const bool ok = r < n;
    cp_async16(dst + swz<HD>(r, c), base + (ok ? r * stride : 0) + c * 8, ok);
  }
}

// What one thread holds of its warp's 16 rows: rows lane/4 (slot 0) and
// lane/4 + 8 (slot 1); acc[d][e] is column 8d + 2(lane%4) + e%2 of slot
// e/2; m is the running max, l the thread's share of the running sum
// (the quad's four shares add up in finish()).
template <int HD>
struct State {
  float acc[HD / 8][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // sum l over the quad: every lane of it then holds its rows' full sums
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
};

// The block's row of slot i of this thread (0..63)
__device__ __forceinline__ int my_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * i;
}

// Attend the block's 64 rows to keys [lo, hi) (lo a multiple of BN).
//   q_row(r)        global address of score row r's q, nullptr = zeros
//   tile_base(key0) global address of key key0's K row (its V row at the
//                   same offset from v); rows follow at stride kv_row
//   vis_lo, vis_hi  the keys this thread's slot-i row sees: [vis_lo[i],
//                   vis_hi[i]), empty for a row with no query (every mask
//                   of the two kernels is one interval)
//   full(key0)      every row with a query sees the whole tile
template <int HD, typename QRow, typename TileBase, typename Full>
__device__ __forceinline__ void attend(unsigned char* smem, QRow q_row,
                                       const bf16* k, const bf16* v,
                                       size_t kv_row, int lo, int hi,
                                       TileBase tile_base,
                                       const int (&vis_lo)[2],
                                       const int (&vis_hi)[2], Full full,
                                       float scale, State<HD>& st) {
  using C = Cfg<HD>;
  constexpr int BN = C::BN;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int quad = lane % 4;
  const uint32_t q_s = smem_addr(smem);
  const uint32_t kv_s = q_s + C::Q_BYTES;   // stage s: K at +2s, V at +2s+1
  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;
  if (n_tiles == 0) return;

  auto issue = [&](int it) {
    const int key0 = lo + it * BN;
    const size_t off = tile_base(key0) - k;
    const uint32_t dst = kv_s + (uint32_t)((it % STAGES) * 2 * C::TILE_BYTES);
    load_tile<HD>(dst, k + off, kv_row, hi - key0);
    load_tile<HD>(dst + C::TILE_BYTES, v + off, kv_row, hi - key0);
  };

  load_q<HD>(q_s, q_row, k);
  issue(0);
  cp_async_commit();

  // ldmatrix rows of this lane: A of Q (16w + lane%8 + 8·bit3), B of K
  // (lane%8 + 8·bit4), B of V via .trans (lane%8 + 8·bit3); the column
  // chunk is 2·kk + one lane bit, stored at (2·kk) ^ (bit ^ (row & 7)):
  // the lane's XOR term is fixed, only the even part varies
  const int a_row = 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_x = (lane / 16) ^ (a_row & 7);
  const int k_row = (lane % 8) + 8 * (lane / 16);
  const int k_x = ((lane / 8) % 2) ^ (k_row & 7);
  const int v_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int v_x = (lane / 16) ^ (v_row & 7);
  auto at = [](uint32_t base, int row, int even, int x) {
    return base + (uint32_t)(row * C::ROW_BYTES + ((even ^ x) << 4));
  };

  uint32_t qf[C::Q_IN_REGS ? HD / 16 : 1][4];

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // tile it (and Q) have landed
    __syncthreads();
    if constexpr (C::Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          ldsm_x4(qf[kk], at(q_s, a_row, 2 * kk, a_x));
      }
    }
    const int key0 = lo + it * BN;
    const uint32_t k_s = kv_s + (uint32_t)((it % STAGES) * 2 * C::TILE_BYTES);
    const uint32_t v_s = k_s + C::TILE_BYTES;

    // 1. S = Q K^T (fp32)
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, at(q_s, a_row, 2 * kk, a_x));
      }
#pragma unroll
      for (int j2 = 0; j2 < BN / 16; ++j2) {
        uint32_t b[4];
        ldsm_x4(b, at(k_s, 16 * j2 + k_row, 2 * kk, k_x));
        mma(s[2 * j2], a, b[0], b[1]);
        mma(s[2 * j2 + 1], a, b[2], b[3]);
      }
    }

    // 2. scale, mask (edge tiles only), online softmax in registers
    const bool whole = full(key0);
    auto seen = [&](int j, int e) {
      const int key = key0 + 8 * j + 2 * quad + (e % 2);
      return whole | ((key >= vis_lo[e / 2]) & (key < vis_hi[e / 2]));
    };
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = seen(j, e) ? s[j][e] * scale : NEG_INF;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(st.m[i], mx[i]);
      corr[i] = ex2((st.m[i] - m_new) * LOG2E);
      st.m[i] = m_new;
      st.l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // NEG_INF is finite: a masked score would give exp(0) = 1 in a
        // fully masked row, so the probability is re-masked to 0
        const float p =
            seen(j, e) ? ex2((s[j][e] - st.m[e / 2]) * LOG2E) : 0.f;
        s[j][e] = p;
        st.l[e / 2] += p;
      }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[d][e] *= corr[e / 2];

    // 3. acc += P V: the C fragments of S, in bf16, are P's A fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t b[4];
        ldsm_x4_t(b, at(v_s, 16 * kk + v_row, 2 * d2, v_x));
        mma(st.acc[2 * d2], a, b[0], b[1]);
        mma(st.acc[2 * d2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // the next issue() overwrites this stage
  }
}

}  // namespace tc
}  // namespace qtt
