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
// float32.  Any T >= 0 and any n <= 64.
//
// Design: the TPU kernel's sequential time-block grid axis and its VMEM
// scratch state become a loop over T inside one block.  One block per
// (b, h), n threads; thread m owns column m of S and keeps its n float32
// values in registers for the whole loop, so the state never leaves the
// SM.  At each step r_t, k_t, w_t and u*k_t go through shared memory
// (double-buffered, so one __syncthreads a step), v_t[m] stays in the
// thread's register, and the next step's inputs are loaded while this
// step computes.  The two sums over i run on four partial accumulators
// each, which shortens the dependent chain of fused multiply-adds; the
// result differs from a left-to-right sum only by float32 rounding.
//
// Bound on this card: not bytes and not operations, but latency.  At the
// serve shape (B, T, H, n) = (1, 512, 40, 64) the work is a serial chain
// of T steps on only B*H = 40 blocks against 132 SMs, and each step costs
// a barrier, a shared-memory round trip and a chain of multiply-adds, so
// the kernel runs far above its bytes bound (about 8 us for 27.5 MB).
// The later redesign is the chunked formulation: within a chunk of C
// steps the outputs are a masked (C x C) product plus a product with the
// chunk's starting state, both on the tensor cores, and only the chunk
// boundaries stay serial.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;

__device__ __forceinline__ float load_f32(const void* __restrict__ p,
                                          int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// N is the head size rounded up to 8, 16, 32 or 64: it sizes the register
// array, and the loops over it are unrolled so S stays in registers.  The
// block has exactly n threads.
template <int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const void* __restrict__ r, const void* __restrict__ k,
            const void* __restrict__ v, const void* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ sT, int64_t T, int H,
            int n, int bf16_mask) {
  __shared__ __align__(16) float s_r[2][N];
  __shared__ __align__(16) float s_k[2][N];
  __shared__ __align__(16) float s_w[2][N];
  __shared__ __align__(16) float s_uk[2][N];

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int m = threadIdx.x;
  const bool r16 = bf16_mask & 1, k16 = bf16_mask & 2, v16 = bf16_mask & 4,
             w16 = bf16_mask & 8;

  const float u_m = u[h * n + m];
  const float* s0_bh = s0 + bh * n * n;
  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = i < n ? s0_bh[i * n + m] : 0.0f;

  const int64_t stride_t = static_cast<int64_t>(H) * n;
  int64_t idx = (b * T * H + h) * n + m;  // element (b, t = 0, h, m)
  float cr = 0.0f, ck = 0.0f, cv = 0.0f, cw = 0.0f;
  if (T > 0) {
    cr = load_f32(r, idx, r16);
    ck = load_f32(k, idx, k16);
    cv = load_f32(v, idx, v16);
    cw = load_f32(w, idx, w16);
  }
  for (int64_t t = 0; t < T; ++t) {
    const int buf = static_cast<int>(t & 1);
    s_r[buf][m] = cr;
    s_k[buf][m] = ck;
    s_w[buf][m] = cw;
    s_uk[buf][m] = u_m * ck;
    const float v_m = cv;
    const int64_t here = idx;
    if (t + 1 < T) {  // prefetch step t + 1 while step t computes
      idx += stride_t;
      cr = load_f32(r, idx, r16);
      ck = load_f32(k, idx, k16);
      cv = load_f32(v, idx, v16);
      cw = load_f32(w, idx, w16);
    }
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const float ri = s_r[buf][i];
        acc[i & 3] = fmaf(ri, S[i], acc[i & 3]);
        y[i & 3] = fmaf(ri, s_uk[buf][i], y[i & 3]);
        S[i] = fmaf(s_w[buf][i], S[i], s_k[buf][i] * v_m);
      }
    }
    o[here] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
              v_m * ((y[0] + y[1]) + (y[2] + y[3]));
  }

  float* sT_bh = sT + bh * n * n;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) sT_bh[i * n + m] = S[i];
}

template <int N>
void launch(int64_t BH, cudaStream_t stream, const void* r, const void* k,
            const void* v, const void* w, const float* u, const float* s0,
            float* o, float* sT, int64_t T, int H, int n, int bf16_mask) {
  wkv6_kernel<N><<<static_cast<unsigned>(BH), n, 0, stream>>>(
      r, k, v, w, u, s0, o, sT, T, H, n, bf16_mask);
}

}  // namespace

// bf16_mask: bit 0 r, bit 1 k, bit 2 v, bit 3 w is bfloat16 (else float32).
// Returns the CUDA error of the launch (0 on success); launches nothing and
// returns cudaErrorInvalidValue on arguments the kernel does not take.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* sT, int64_t B, int64_t T, int32_t H,
                           int32_t n, int32_t bf16_mask, void* stream) {
  const int64_t BH = B * H;
  if (B <= 0 || H <= 0 || T < 0 || n < 1 || n > kMaxN ||
      BH > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto uf = static_cast<const float*>(u);
  const auto s0f = static_cast<const float*>(s0);
  const auto of = static_cast<float*>(o);
  const auto sTf = static_cast<float*>(sT);
  if (n <= 8)
    launch<8>(BH, st, r, k, v, w, uf, s0f, of, sTf, T, H, n, bf16_mask);
  else if (n <= 16)
    launch<16>(BH, st, r, k, v, w, uf, s0f, of, sTf, T, H, n, bf16_mask);
  else if (n <= 32)
    launch<32>(BH, st, r, k, v, w, uf, s0f, of, sTf, T, H, n, bf16_mask);
  else
    launch<64>(BH, st, r, k, v, w, uf, s0f, of, sTf, T, H, n, bf16_mask);
  return static_cast<int>(cudaGetLastError());
}
