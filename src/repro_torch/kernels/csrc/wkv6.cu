// RWKV-6 ("Finch") WKV recurrence, for Hopper.
//
// Replaces the Pallas TPU kernel _wkv_kernel of src/repro/kernels/wkv6.py
// (launched by wkv6_pallas).  Per (batch b, head h), with an n x n state S
// that starts at s0[b, h]:
//
//   o_t[m] = sum_i r_t[i] * S[i][m]  +  v_t[m] * sum_i r_t[i] * u[i] * k_t[i]
//   S[i][m] <- w_t[i] * S[i][m] + k_t[i] * v_t[m]
//
// and S_T is written once at the end.  r, k, v, w are (B, T, H, n), each
// float32 or bfloat16 (the model gives r, k, v in its own type and w in
// float32); every value is upcast to float32 on load.  u is (H, n) and s0
// (B, H, n, n), both float32; o (B, T, H, n) and S_T (B, H, n, n) are
// float32.  Any T >= 1 and any n <= 64.
//
// --- wkv6_launch: the chunked form, in two kernels ------------------------
//
// Algorithm.  Over a chunk of C = 16 steps starting at t0, with the state
// S_in entering it and D(x, y) = prod_{x <= j < y} w_j (per channel i; the
// empty product is 1):
//
//   o_t   = (r_t * D(t0, t)) . S_in                          inter-chunk
//         + sum_{s < t} A[t][s] v_s,  A[t][s] = sum_i r_t[i] k_s[i] D(s+1, t)[i]
//         + (sum_i r_t[i] u[i] k_t[i]) v_t                    bonus
//   S_out = D(t0, t0+C) *rows S_in + sum_s (k_s * D(s+1, t0+C))^T v_s
//
// D(x, y) is e^{sum of log w_j over [x, y)}; the kernels form it as the
// product of those w_j and never take a log, an exp or a difference of
// cumulative sums.  That answers both numerical traps of the chunked form:
//  * Overflow and -inf - -inf.  D(s+1, t) is never split as
//    D(t0, t) / D(t0, s+1), whose second factor overflows when a decay is
//    near 0 (RWKV-6's w = exp(-exp(x)) reaches exactly 0).  It is split at a
//    reference point R with s < R <= t into D(R, t) * D(s+1, R): both
//    factors are products of numbers in [0, 1], so at worst they underflow
//    towards 0, where the true value is below 1e-38 too.  w = 0 and w = 1
//    are exact.
//  * Cancellation.  With no differences of cumulative log sums there is
//    nothing to cancel; each factor is a product of at most C - 1 floats,
//    so its relative error is below C * 2^-24 ~ 1e-6 whatever the decays.
// The reference point is hierarchical.  For s < t inside the chunk, let
// level L = the highest bit of (t - t0) xor (s - t0): s lies in the lower
// and t in the upper half of one aligned block of 2^(L+1) steps, and R is
// the start of that upper half.  So per level the chunk's r and k are
// scaled once, r_t * D(R, t) and k_s * D(s+1, R), by products restarted
// every 2^L steps (forward for r, backward for k), and the level-L entries
// of A are the level-L entries of one product of two scaled 16 x n
// matrices.  Level log2(C) (R = t0 for r, R = t0 + C for k) gives the
// inter-chunk and state-update factors.  Level 0 needs no scaling
// (t = s + 1, D is empty).  The mirror of this algorithm in plain torch is
// kernels/ref.py::wkv6_chunked_ref.
//
// Precision.  Every matrix product runs on the tensor cores as 3xTF32
// (mma.sync m16n8k8: each operand split into a TF32 high part and a TF32
// rest, hi*hi + hi*lo + lo*hi accumulated in float32), which keeps about
// float32's accuracy: f32 streams are held to 1e-5, and plain TF32 keeps
// three digits.  The decay products are float32 multiplies.
//
// Layout.  Only the state recurrence is serial, so the work is split where
// the serial part starts:
//  * wkv6_chunk_local_kernel, one block of 256 threads per (b, h, chunk):
//    B*H*ceil(T/16) blocks (1,280 at the serve shape (1, 512, 40, 64)),
//    four resident per SM.  It stages the chunk's r, k, w, v in shared
//    memory (16- or 8-byte vector loads when n % 4 == 0 and the streams are
//    aligned; masked past T and n, so the ragged last chunk needs no host
//    padding: r = k = v = 0, w = 1), forms the decay products per level,
//    A (five 16 x 16 products over n: levels 0-3 and the bonus), the
//    intra-chunk outputs A v into o, and leaves in scratch what the scan
//    needs: r_t * D(t0, t), (k_s * D(s+1, t0+C))^T and D(t0, t0+C), 8.4 KB a
//    chunk at n = 64 (10.8 MB at the serve shape).
//  * wkv6_chunk_scan_kernel, one block of 512 threads per (b, h) and 32
//    state columns (80 blocks at the serve shape).  Column m of S evolves
//    on its own and reads only v[:, m], so a head's state splits by
//    columns.  Each warp keeps one 16 x 8 tile of the block's state in its
//    accumulator registers across chunks (mirrored into shared memory for
//    the inter-chunk product; written to S_T once).  Per chunk: S_out, and
//    o += (r * D(t0, t)) . S_in, two barriers.  The chunk's inputs are
//    loaded as raw bits two chunks ahead, so their latency hides behind the
//    chunks in between.
//
// Bound on this card.  The bytes bound at the serve shape is ~8 us
// (27.5 MB: each input read once, each output written once) and the
// operations take ~5 us at the float32 rate.  What bounds the pair is
// latency, not bytes or operations: the scan's serial chain of T / 16
// chunk steps (issuing the next loads, two barriers and a chain of
// dependent mma.sync each step) and the local kernel's per-block chain
// (stage, products, A, outputs).  chip_smoke.py's wkv-time phase times the
// pair against its bound, splits its device time between the two kernels,
// and times one head alone against forty.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;

// ---------------------------------------------------------------------------
// Chunked kernels.

constexpr int kChunk = 16;     // C, a power of two: one m16 tile of rows
constexpr int kLevels = 4;     // log2(C)
constexpr int kThreads = 512;  // the scan's block: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLocalThreads = 256;  // the local kernel's block: 8 warps
constexpr int kLocalWarps = kLocalThreads / 32;
constexpr int kAS = kChunk + 4;  // row stride of A and of kb_L transposed
constexpr int kAhead = 2;      // chunks the scan's loads run ahead

// Raw bits of elements c4 .. c4 + 3 of the row at `row` of a float32 or
// bfloat16 stream.  With kVec (n % 4 == 0 and the stream aligned) one
// 16-byte (f32) or 8-byte (bf16) load, else four loads, each element's
// channel clamped to n - 1.  Nothing reads the registers until the values
// are used, a chunk later, so the loads' latency hides behind a chunk of
// work; decode4 turns them into floats there.
template <bool kVec>
__device__ __forceinline__ uint4 load4(const void* __restrict__ p,
                                       int64_t row, int c4, int n,
                                       bool bf16) {
  if (kVec) {
    const int64_t i = row + (c4 < n ? c4 : n - 4);
    if (bf16) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const unsigned short*>(p) + i));
      return make_uint4(x.x, x.y, 0u, 0u);
    }
    return __ldg(reinterpret_cast<const uint4*>(
        static_cast<const float*>(p) + i));
  }
  uint32_t e[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = row + (c4 + j < n ? c4 + j : n - 1);
    e[j] = bf16 ? static_cast<uint32_t>(
                      __ldg(static_cast<const unsigned short*>(p) + i))
                : __ldg(static_cast<const unsigned int*>(p) + i);
  }
  return make_uint4(e[0], e[1], e[2], e[3]);
}

template <bool kVec>
__device__ __forceinline__ float decode4(const uint4& raw, int j, bool bf16) {
  const uint32_t word = j == 0 ? raw.x : j == 1 ? raw.y : j == 2 ? raw.z
                                                                  : raw.w;
  if (!bf16) return __uint_as_float(word);
  if (!kVec) return __uint_as_float(word << 16);
  const uint32_t pair = j < 2 ? raw.x : raw.y;  // two bf16, low one first
  return __uint_as_float((j & 1) ? pair & 0xffff0000u : pair << 16);
}

// x = hi + lo, both TF32 (hi the rounded value, lo the rounded rest).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b for one m16n8k8 step to about float32 accuracy (3xTF32: the
// lo * lo term, below 2^-22 of the product, is dropped), small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4],
                                     const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) split_tf32(a[j], ah[j], al[j]);
#pragma unroll
  for (int j = 0; j < 2; ++j) split_tf32(b[j], bh[j], bl[j]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Fragments of m16n8k8 (g = lane / 4, q = lane % 4).  A: the 16 x 8 slice
// of a row-major matrix at p: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3
// (g + 8, q + 4).  B: the 8 (k) x 8 (n) slice, b0 (q, g), b1 (q + 4, g),
// stored k-major (p[k * ld + n]) or n-major (p[n * ld + k]).  C and D: c0
// (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1).
__device__ __forceinline__ void frag_a(float (&a)[4], const float* p, int ld,
                                       int g, int q) {
  a[0] = p[g * ld + q];
  a[1] = p[(g + 8) * ld + q];
  a[2] = p[g * ld + q + 4];
  a[3] = p[(g + 8) * ld + q + 4];
}

__device__ __forceinline__ void frag_b_kn(float (&b)[2], const float* p,
                                          int ld, int g, int q) {
  b[0] = p[q * ld + g];
  b[1] = p[(q + 4) * ld + g];
}

__device__ __forceinline__ void frag_b_nk(float (&b)[2], const float* p,
                                          int ld, int g, int q) {
  b[0] = p[g * ld + q];
  b[1] = p[g * ld + q + 4];
}

// Per (b, h, chunk) the local kernel leaves in scratch what the scan needs,
// in this order: r_t * D(t0, t) (C x N, row t), (k_s * D(s+1, t0+C))^T
// (N x C, row i) and D(t0, t0+C) (N).
template <int N>
struct Scratch {
  static constexpr int kPerChunk = 2 * kChunk * N + N;
};

// N is the head size rounded up to 16, 32 or 64.  Channels i >= n and
// columns m >= n are padded inside the kernels (r = k = v = 0, w = 1).
template <int N>
struct LocalCfg {
  static_assert(N % 16 == 0 && N <= kMaxN, "head size");
  static constexpr int RS = N + 4;  // row stride of r, k, w, each level
  static constexpr int VS = N + 8;  // row stride of v
  static constexpr int kRow = kChunk * RS;
  static constexpr int kGTiles = 2 * (kLevels + 1);  // A: levels, bonus
  static constexpr int kQuadsRKW = 3 * kChunk * (N / 4);
  static constexpr int kQuads = kQuadsRKW + kChunk * (N / 4);
  // Shared memory, in floats.
  static constexpr int off_rf = 0;                      // levels 0..L
  static constexpr int off_kb = (kLevels + 1) * kRow;   // levels 0..L
  static constexpr int off_w = 2 * (kLevels + 1) * kRow;
  static constexpr int off_v = off_w + kRow;            // C x VS
  static constexpr int off_A = off_v + kChunk * VS;     // C x kAS
  static constexpr int off_u = off_A + kChunk * kAS;    // N
  static constexpr int off_wt = off_u + N;              // N
  static constexpr int floats = off_wt + N;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Everything of chunk blockIdx.y of head blockIdx.x that does not depend
// on the state: the decay products per level, A, the intra-chunk outputs
// A v (written to o, where the scan adds the rest) and the scan's inputs
// (into scratch).
template <int N, bool kVec>
__global__ void __launch_bounds__(kLocalThreads, 4)
wkv6_chunk_local_kernel(const void* __restrict__ r,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const void* __restrict__ w,
                        const float* __restrict__ u, float* __restrict__ o,
                        float* __restrict__ scratch, int64_t T, int H, int n,
                        int bf16_mask) {
  using Cfg = LocalCfg<N>;
  constexpr int RS = Cfg::RS, VS = Cfg::VS, kRow = Cfg::kRow;
  extern __shared__ __align__(16) float smem[];
  float* const s_rf = smem + Cfg::off_rf;
  float* const s_kb = smem + Cfg::off_kb;
  float* const s_w = smem + Cfg::off_w;
  float* const s_v = smem + Cfg::off_v;
  float* const s_A = smem + Cfg::off_A;
  float* const s_u = smem + Cfg::off_u;
  float* const s_wt = smem + Cfg::off_wt;

  const int64_t bh = blockIdx.x, c = blockIdx.y;
  const int64_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int64_t t0 = c * kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const bool r16 = bf16_mask & 1, k16 = bf16_mask & 2, v16 = bf16_mask & 4,
             w16 = bf16_mask & 8;
  const int64_t stride_t = static_cast<int64_t>(H) * n;
  const int64_t base = (b * T * H + h) * n;  // element (b, t = 0, h, 0)

  for (int i = tid; i < N; i += kLocalThreads) s_u[i] = i < n ? u[h * n + i] : 0.0f;

  // The chunk's rows, masked past T and n (r = k = v = 0, w = 1): quad e
  // is 4 channels of row t of r, k, w (e < kQuadsRKW) or of v.
  for (int e = tid; e < Cfg::kQuads; e += kLocalThreads) {
    const int sm = e / (kChunk * (N / 4)), t = e / (N / 4) % kChunk;
    const int c4 = 4 * (e % (N / 4));
    const void* src = sm == 0 ? r : sm == 1 ? k : sm == 2 ? w : v;
    const bool src16 = sm == 0 ? r16 : sm == 1 ? k16 : sm == 2 ? w16 : v16;
    const int64_t row = base + (t0 + t < T ? t0 + t : T - 1) * stride_t;
    const uint4 raw = load4<kVec>(src, row, c4, n, src16);
    const float pad = sm == 2 ? 1.0f : 0.0f;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = t0 + t < T && c4 + j < n ? decode4<kVec>(raw, j, src16) : pad;
    float* dst = sm == 0 ? s_rf + t * RS : sm == 1 ? s_kb + t * RS
               : sm == 2 ? s_w + t * RS : s_v + t * VS;
    *reinterpret_cast<float4*>(dst + c4) = make_float4(f[0], f[1], f[2], f[3]);
  }
  __syncthreads();

  // Decay products, one (side, level, channel) a thread.  Forward for r,
  // restarted at every multiple of 2^level; backward for k, restarted after
  // every multiple of 2^level minus one.  Level 0 is the raw row.
  for (int task = tid; task < 2 * kLevels * N; task += kLocalThreads) {
    const int ci = task % N, lvl = 1 + task / N % kLevels;
    const int span_mask = (1 << lvl) - 1;
    float p = 1.0f;
    if (task < kLevels * N) {
      float* dst = s_rf + lvl * kRow + ci;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if ((t & span_mask) == 0) p = 1.0f;
        dst[t * RS] = s_rf[t * RS + ci] * p;
        p *= s_w[t * RS + ci];
      }
      if (lvl == kLevels) s_wt[ci] = p;
    } else {
      float* dst = s_kb + lvl * kRow + ci;
#pragma unroll
      for (int t = kChunk - 1; t >= 0; --t) {
        if (((t + 1) & span_mask) == 0) p = 1.0f;
        dst[t * RS] = s_kb[t * RS + ci] * p;
        p *= s_w[t * RS + ci];
      }
    }
  }
  __syncthreads();

  // A, the chunk's 16 x 16 matrix.  Tile 2 lvl + ns computes
  // G = (r * D(R, t)) (k * D(s+1, R))^T at level lvl for columns s in
  // [8 ns, 8 ns + 8), and keeps the entries whose level is lvl (0 where
  // s > t); lvl = kLevels is the bonus (r * u) k^T, whose diagonal it keeps.
  for (int tile = warp; tile < Cfg::kGTiles; tile += kLocalWarps) {
    const int lvl = tile / 2, ns = tile % 2;
    const bool bonus = lvl == kLevels;
    const float* pa = s_rf + (bonus ? 0 : lvl) * kRow;
    const float* pb = s_kb + (bonus ? 0 : lvl) * kRow + 8 * ns * RS;
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      float a[4], bb[2];
      frag_a(a, pa + k0, RS, g, q);
      if (bonus) {
        a[0] *= s_u[k0 + q];
        a[1] *= s_u[k0 + q];
        a[2] *= s_u[k0 + q + 4];
        a[3] *= s_u[k0 + q + 4];
      }
      frag_b_nk(bb, pb + k0, RS, g, q);
      mma3(d0, a, bb);
      frag_a(a, pa + k0 + 8, RS, g, q);
      if (bonus) {
        a[0] *= s_u[k0 + 8 + q];
        a[1] *= s_u[k0 + 8 + q];
        a[2] *= s_u[k0 + 12 + q];
        a[3] *= s_u[k0 + 12 + q];
      }
      frag_b_nk(bb, pb + k0 + 8, RS, g, q);
      mma3(d1, a, bb);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = g + (j >= 2 ? 8 : 0), s = 8 * ns + 2 * q + (j & 1);
      const float val = d0[j] + d1[j];
      if (bonus) {
        if (t == s) s_A[t * kAS + s] = val;
      } else if (t != s && 31 - __clz(t ^ s) == lvl) {
        s_A[t * kAS + s] = s < t ? val : 0.0f;
      }
    }
  }

  // The scan's inputs, from the last level: r * D(t0, t) row by row,
  // (k * D(s+1, t0+C))^T channel by channel, and D(t0, t0+C).
  float* scr = scratch + (bh * gridDim.y + c) * Scratch<N>::kPerChunk;
  const float* rf_last = s_rf + kLevels * kRow;
  const float* kb_last = s_kb + kLevels * kRow;
  for (int e = tid; e < 2 * kChunk * (N / 4) + N / 4; e += kLocalThreads) {
    float4 val;
    if (e < kChunk * (N / 4)) {            // rf: row t, channels 4 i4 ..
      const int t = e / (N / 4), i4 = e % (N / 4);
      val = *reinterpret_cast<const float4*>(rf_last + t * RS + 4 * i4);
    } else if (e < 2 * kChunk * (N / 4)) {  // kb^T: row i, steps 4 s4 ..
      const int f = e - kChunk * (N / 4), i = f / (kChunk / 4);
      const int s4 = f % (kChunk / 4);
      val = make_float4(kb_last[(4 * s4) * RS + i], kb_last[(4 * s4 + 1) * RS + i],
                        kb_last[(4 * s4 + 2) * RS + i],
                        kb_last[(4 * s4 + 3) * RS + i]);
    } else {
      val = *reinterpret_cast<const float4*>(
          s_wt + 4 * (e - 2 * kChunk * (N / 4)));
    }
    *reinterpret_cast<float4*>(scr + 4 * e) = val;
  }
  __syncthreads();

  // Intra-chunk outputs A v (A is 0 above the diagonal), one 16 x 8 tile
  // of columns a warp, into o.
  for (int nt = warp; nt < N / 8; nt += kLocalWarps) {
    float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 8) {
      float a[4], bb[2];
      frag_a(a, s_A + k0, kAS, g, q);
      frag_b_kn(bb, s_v + k0 * VS + 8 * nt, VS, g, q);
      mma3(out, a, bb);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = g + (j >= 2 ? 8 : 0), m = 8 * nt + 2 * q + (j & 1);
      if (t0 + t < T && m < n) o[base + (t0 + t) * stride_t + m] = out[j];
    }
  }
}

template <int N, int MC>
struct ScanCfg {
  static_assert(N % 16 == 0 && MC % 8 == 0 && MC <= N, "tile shape");
  static constexpr int RS = N + 4;   // row stride of r * D(t0, t)
  static constexpr int VS = MC + 8;  // row stride of v and of A v
  static constexpr int SS = MC + 8;  // row stride of S
  static constexpr int NT = MC / 8;  // n-tiles of the columns
  static constexpr int MT = N / 16;  // m-tiles of the state rows
  static constexpr int kStateWarps = MT * NT;  // one state tile a warp
  static_assert(kStateWarps <= kWarps && NT <= kWarps, "warps");
  // Prefetched quads: r * D (C x N), kb^T (N x C), D(t0, t0+C) (N), the v
  // slice and the slice of A v (C x MC each).
  static constexpr int kQRf = kChunk * (N / 4);
  static constexpr int kQKbT = kQRf + N * (kChunk / 4);
  static constexpr int kQWt = kQKbT + N / 4;
  static constexpr int kQV = kQWt + kChunk * (MC / 4);
  static constexpr int kQuads = kQV + kChunk * (MC / 4);
  static constexpr int IPT = (kQuads + kThreads - 1) / kThreads;
  // Shared memory, in floats.
  static constexpr int off_rf = 0;                        // C x RS
  static constexpr int off_kbT = kChunk * RS;             // N x kAS
  static constexpr int off_wt = off_kbT + N * kAS;        // N
  static constexpr int off_v = off_wt + N;                // C x VS
  static constexpr int off_oi = off_v + kChunk * VS;      // 2 x (C x VS)
  static constexpr int off_S = off_oi + 2 * kChunk * VS;  // N x SS
  static constexpr int floats = off_S + N * SS;
  static constexpr size_t bytes = floats * sizeof(float);
};

// The serial part: for each chunk in turn, S_out = D(t0, t0+C) *rows S_in
// + (k * D(s+1, t0+C))^T v and o_t += (r_t * D(t0, t)) . S_in, for the MC
// state columns of block (blockIdx.x = b * H + h, blockIdx.y).  The state
// stays in registers, one m16n8 accumulator tile a warp.
template <int N, int MC, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_chunk_scan_kernel(const void* __restrict__ v,
                       const float* __restrict__ s0, float* __restrict__ o,
                       float* __restrict__ sT,
                       const float* __restrict__ scratch, int64_t T, int H,
                       int n, int bf16_mask) {
  using Cfg = ScanCfg<N, MC>;
  constexpr int RS = Cfg::RS, VS = Cfg::VS, SS = Cfg::SS;
  extern __shared__ __align__(16) float smem[];
  float* const s_rf = smem + Cfg::off_rf;
  float* const s_kbT = smem + Cfg::off_kbT;
  float* const s_wt = smem + Cfg::off_wt;
  float* const s_v = smem + Cfg::off_v;
  float* const s_oi = smem + Cfg::off_oi;
  float* const s_S = smem + Cfg::off_S;

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int m0 = blockIdx.y * MC;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const bool v16 = bf16_mask & 4;
  const int64_t stride_t = static_cast<int64_t>(H) * n;
  const int64_t base = (b * T * H + h) * n;  // element (b, t = 0, h, 0)
  const int64_t n_chunks = (T + kChunk - 1) / kChunk;
  const float* scr_bh = scratch + bh * n_chunks * Scratch<N>::kPerChunk;

  // This warp's tile of the state, in accumulator layout: rows 16 mt + g
  // and 16 mt + g + 8, columns 8 nt + 2q and 8 nt + 2q + 1 of the slice.
  const bool state_warp = warp < Cfg::kStateWarps;
  const bool out_warp = warp < Cfg::NT;
  const int mt = warp / Cfg::NT, nt = warp % Cfg::NT;
  float S[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* s0_bh = s0 + bh * n * n;
  if (state_warp) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 16 * mt + g + (j >= 2 ? 8 : 0);
      const int col = 8 * nt + 2 * q + (j & 1);
      S[j] = row < n && m0 + col < n ? s0_bh[row * n + m0 + col] : 0.0f;
      s_S[row * SS + col] = S[j];
    }
  }

  // A chunk's inputs, loaded kAhead chunks ahead as raw bits into one of
  // kAhead register sets (nothing reads them until the chunk starts).
  uint4 raws[kAhead][Cfg::IPT];
  auto fetch = [&](int64_t c, uint4 (&raw)[Cfg::IPT]) {
    const float* scr = scr_bh + c * Scratch<N>::kPerChunk;
    const int64_t t0 = c * kChunk;
#pragma unroll
    for (int j = 0; j < Cfg::IPT; ++j) {
      const int e = tid + j * kThreads;
      if (e < Cfg::kQWt) {
        raw[j] = __ldg(reinterpret_cast<const uint4*>(scr) + e);
      } else if (e < Cfg::kQuads) {
        const bool is_v = e < Cfg::kQV;
        const int f = e - (is_v ? Cfg::kQWt : Cfg::kQV), t = f / (MC / 4);
        const int64_t row = base + (t0 + t < T ? t0 + t : T - 1) * stride_t;
        raw[j] = is_v ? load4<kVec>(v, row, m0 + 4 * (f % (MC / 4)), n, v16)
                      : load4<kVec>(o, row, m0 + 4 * (f % (MC / 4)), n,
                                    false);
      }
    }
  };

  auto step = [&](int64_t c, uint4 (&raw)[Cfg::IPT]) {
    const int64_t t0 = c * kChunk;
    float* const oi_c = s_oi + (c & 1) * (kChunk * VS);
#pragma unroll
    for (int j = 0; j < Cfg::IPT; ++j) {
      const int e = tid + j * kThreads;
      float4 f = make_float4(__uint_as_float(raw[j].x),
                             __uint_as_float(raw[j].y),
                             __uint_as_float(raw[j].z),
                             __uint_as_float(raw[j].w));
      if (e < Cfg::kQRf) {
        *reinterpret_cast<float4*>(s_rf + e / (N / 4) * RS + 4 * (e % (N / 4))) = f;
      } else if (e < Cfg::kQKbT) {
        const int e2 = e - Cfg::kQRf;
        *reinterpret_cast<float4*>(s_kbT + e2 / (kChunk / 4) * kAS +
                                   4 * (e2 % (kChunk / 4))) = f;
      } else if (e < Cfg::kQWt) {
        *reinterpret_cast<float4*>(s_wt + 4 * (e - Cfg::kQKbT)) = f;
      } else if (e < Cfg::kQuads) {
        const bool is_v = e < Cfg::kQV;
        const int fq = e - (is_v ? Cfg::kQWt : Cfg::kQV), t = fq / (MC / 4);
        const int c4 = 4 * (fq % (MC / 4));
        float x[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          x[jj] = t0 + t < T && m0 + c4 + jj < n
                      ? decode4<kVec>(raw[j], jj, is_v && v16) : 0.0f;
        *reinterpret_cast<float4*>((is_v ? s_v : oi_c) + t * VS + c4) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    }
    __syncthreads();
    if (c + kAhead < n_chunks) fetch(c + kAhead, raw);

    // The new state, in registers until every output has read S_in.
    float S_new[4];
    if (state_warp) {
      const float w_lo = s_wt[16 * mt + g], w_hi = s_wt[16 * mt + g + 8];
      S_new[0] = w_lo * S[0];
      S_new[1] = w_lo * S[1];
      S_new[2] = w_hi * S[2];
      S_new[3] = w_hi * S[3];
#pragma unroll
      for (int k0 = 0; k0 < kChunk; k0 += 8) {
        float a[4], bb[2];
        frag_a(a, s_kbT + 16 * mt * kAS + k0, kAS, g, q);
        frag_b_kn(bb, s_v + k0 * VS + 8 * nt, VS, g, q);
        mma3(S_new, a, bb);
      }
    }
    // Inter-chunk outputs (r * D(t0, t)) . S_in, one 16 x 8 tile a warp.
    float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (out_warp) {
      float d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        float a[4], bb[2];
        frag_a(a, s_rf + k0, RS, g, q);
        frag_b_kn(bb, s_S + k0 * SS + 8 * nt, SS, g, q);
        mma3(out, a, bb);
        frag_a(a, s_rf + k0 + 8, RS, g, q);
        frag_b_kn(bb, s_S + (k0 + 8) * SS + 8 * nt, SS, g, q);
        mma3(d1, a, bb);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] += d1[j];
    }
    __syncthreads();

    // o = A v + the inter-chunk part; then S_out replaces S_in.
    if (out_warp) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = g + (j >= 2 ? 8 : 0);
        const int col = 8 * nt + 2 * q + (j & 1);
        if (t0 + t < T && m0 + col < n)
          o[base + (t0 + t) * stride_t + m0 + col] = oi_c[t * VS + col] + out[j];
      }
    }
    if (state_warp) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        S[j] = S_new[j];
        const int row = 16 * mt + g + (j >= 2 ? 8 : 0);
        s_S[row * SS + 8 * nt + 2 * q + (j & 1)] = S[j];
      }
    }
  };

#pragma unroll
  for (int d = 0; d < kAhead; ++d)
    if (d < n_chunks) fetch(d, raws[d]);
  for (int64_t c = 0; c < n_chunks; c += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (c + d < n_chunks) step(c + d, raws[d]);
  }

  if (state_warp) {
    float* sT_bh = sT + bh * n * n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 16 * mt + g + (j >= 2 ? 8 : 0);
      const int m = m0 + 8 * nt + 2 * q + (j & 1);
      if (row < n && m < n) sT_bh[row * n + m] = S[j];
    }
  }
}

constexpr int kMaxDevices = 64;

// Above 48 KB a block's shared memory must be asked for: once per kernel
// and device (`done` is that kernel's record).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The local kernel over every chunk, then the scan; a scan block owns 32
// columns of a head's state (n = 64: two blocks a head).
template <int N>
int launch_chunk(int64_t BH, cudaStream_t stream, const void* r,
                 const void* k, const void* v, const void* w, const float* u,
                 const float* s0, float* o, float* sT, float* scratch,
                 int64_t T, int H, int n, int bf16_mask) {
  constexpr int MC = N < 32 ? N : 32;
  const int64_t n_chunks = (T + kChunk - 1) / kChunk;
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // Vector loads need n % 4 == 0 and each stream aligned to 4 elements.
  bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const void* streams[4] = {r, k, v, w};
  for (int i = 0; i < 4; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(streams[i]) %
                         ((bf16_mask >> i & 1) ? 8 : 16) == 0;
  const auto local = vec ? wkv6_chunk_local_kernel<N, true>
                         : wkv6_chunk_local_kernel<N, false>;
  const auto scan = vec ? wkv6_chunk_scan_kernel<N, MC, true>
                        : wkv6_chunk_scan_kernel<N, MC, false>;
  static bool local_done[2][kMaxDevices], scan_done[2][kMaxDevices];
  cudaError_t err = allow_smem(local, LocalCfg<N>::bytes, local_done[vec]);
  if (err == cudaSuccess)
    err = allow_smem(scan, ScanCfg<N, MC>::bytes, scan_done[vec]);
  if (err != cudaSuccess) return static_cast<int>(err);
  local<<<dim3(static_cast<unsigned>(BH), static_cast<unsigned>(n_chunks)),
          kLocalThreads, LocalCfg<N>::bytes, stream>>>(r, k, v, w, u, o, scratch,
                                                  T, H, n, bf16_mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan<<<dim3(static_cast<unsigned>(BH),
              static_cast<unsigned>((n + MC - 1) / MC)),
         kThreads, ScanCfg<N, MC>::bytes, stream>>>(v, s0, o, sT, scratch, T,
                                                    H, n, bf16_mask);
  return static_cast<int>(cudaGetLastError());
}

// Head size n rounded up to the chunked kernels' tile (16, 32 or 64).
int padded_head(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : 64; }

}  // namespace

// Floats of scratch that wkv6_launch needs for these sizes.
extern "C" int64_t wkv6_scratch_floats(int64_t B, int64_t T, int32_t H,
                                       int32_t n) {
  const int N = padded_head(n);
  const int per_chunk = N == 16 ? Scratch<16>::kPerChunk
                      : N == 32 ? Scratch<32>::kPerChunk
                                : Scratch<64>::kPerChunk;
  return B * H * ((T + kChunk - 1) / kChunk) * per_chunk;
}

// bf16_mask: bit 0 r, bit 1 k, bit 2 v, bit 3 w is bfloat16 (else float32).
// It returns the CUDA error of the launch (0 on success); it launches
// nothing and returns cudaErrorInvalidValue on arguments the kernel does
// not take.  scratch: wkv6_scratch_floats(B, T, H, n) floats, 16-byte
// aligned.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* sT, void* scratch, int64_t B,
                           int64_t T, int32_t H, int32_t n, int32_t bf16_mask,
                           void* stream) {
  const int64_t BH = B * H;
  if (B <= 0 || H <= 0 || T < 1 || n < 1 || n > kMaxN || BH > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int N = padded_head(n);
  const auto launch = N == 16   ? launch_chunk<16>
                      : N == 32 ? launch_chunk<32>
                                : launch_chunk<64>;
  return launch(BH, static_cast<cudaStream_t>(stream), r, k, v, w,
                static_cast<const float*>(u), static_cast<const float*>(s0),
                static_cast<float*>(o), static_cast<float*>(sT),
                static_cast<float*>(scratch), T, H, n, bf16_mask);
}
