// Fused node filter+score pass of RSCH's Level-2 placement, for Hopper.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/node_score.py:
//   _score_kernel        (launched by node_scores_pallas)       -> node_scores_launch
//   _score_slots_kernel  (launched by node_scores_slots_pallas) -> node_scores_slots_launch
// Both share one __device__ body, as the TPU kernels share one formula.
//
// Per node i:
//   valid    = mask[i] && free[i] >= request
//   score[i] = valid ? ((w_used*(used/g) + w_fit*[free==request])
//                       + w_group*gload[i]) + w_topo*topo[i]
//                    : NEG_INF (float32 min, not -inf)
//   slots[i] = valid ? free[i] / request : 0          (score+slots only)
//
// Numerics: scores must equal the host numpy path bit for bit, because
// E-Binpack scores tie often and placements are compared byte for byte.
// So every step is an explicitly rounded f32 op in numpy's order
// (__fdiv_rn, __fmul_rn, __fadd_rn), the build passes -fmad=false and no
// fast-math, and the division is a true division by g (the TPU kernel
// multiplies by 1/g, which agrees only when g is a power of two).  The
// weights arrive as float, rounded once on the host, as numpy rounds a
// Python float scalar against an f32 array.
//
// Bound: memory bandwidth.  Per node the pass reads 17 bytes (int32 free
// and used, a 1-byte bool mask, f32 group load and topo preference) and
// writes 4 (scores) or 8 (scores + int32 slots), against ~10 flops.  The
// design is the simple one that suffices for that: a 1-D grid over the
// flat node axis with a grid-stride loop, neighbouring threads on
// neighbouring nodes so every load and store coalesces, and the ragged
// tail masked by the loop bound; no padding to tiles.  Wider (vector)
// loads and keeping the node table resident on the device are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -3.40282346638528859812e+38f;  // float32 min
constexpr int kThreads = 256;

struct Params {
  int64_t n;
  int32_t request;
  float g;
  float w_used, w_fit, w_group, w_topo;
};

__device__ __forceinline__ float score_one(int32_t free_i, int32_t used_i,
                                           bool in_pool, float gload,
                                           float topo, const Params& p,
                                           bool* valid) {
  const float free_f = static_cast<float>(free_i);
  const float used_f = static_cast<float>(used_i);
  const float req_f = static_cast<float>(p.request);
  *valid = in_pool && free_f >= req_f;
  const float exact = free_f == req_f ? 1.0f : 0.0f;
  float s = __fmul_rn(p.w_used, __fdiv_rn(used_f, p.g));
  s = __fadd_rn(s, __fmul_rn(p.w_fit, exact));
  s = __fadd_rn(s, __fmul_rn(p.w_group, gload));
  s = __fadd_rn(s, __fmul_rn(p.w_topo, topo));
  return *valid ? s : kNegInf;
}

template <bool kSlots>
__global__ void __launch_bounds__(kThreads)
node_score_kernel(const int32_t* __restrict__ free_gpus,
                  const int32_t* __restrict__ used_gpus,
                  const bool* __restrict__ mask,
                  const float* __restrict__ gload,
                  const float* __restrict__ topo,
                  float* __restrict__ score, int32_t* __restrict__ slots,
                  Params p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.n; i += stride) {
    const int32_t f = free_gpus[i];
    bool valid;
    score[i] = score_one(f, used_gpus[i], mask[i], gload[i], topo[i], p,
                         &valid);
    if (kSlots) slots[i] = valid ? f / p.request : 0;
  }
}

int grid_for(int64_t n) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = sms * 16;  // enough resident warps to cover HBM latency
  }
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < max_blocks ? want : max_blocks);
}

template <bool kSlots>
int launch(const void* free_gpus, const void* used_gpus, const void* mask,
           const void* gload, const void* topo, void* score, void* slots,
           int64_t n, int32_t request, float g, float w_used, float w_fit,
           float w_group, float w_topo, void* stream) {
  if (n <= 0 || request <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{n, request, g, w_used, w_fit, w_group, w_topo};
  node_score_kernel<kSlots><<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(free_gpus),
      static_cast<const int32_t*>(used_gpus),
      static_cast<const bool*>(mask), static_cast<const float*>(gload),
      static_cast<const float*>(topo), static_cast<float*>(score),
      static_cast<int32_t*>(slots), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int node_scores_launch(const void* free_gpus, const void* used_gpus,
                                  const void* mask, const void* gload,
                                  const void* topo, void* score, int64_t n,
                                  int32_t request, float g, float w_used,
                                  float w_fit, float w_group, float w_topo,
                                  void* stream) {
  return launch<false>(free_gpus, used_gpus, mask, gload, topo, score,
                       nullptr, n, request, g, w_used, w_fit, w_group,
                       w_topo, stream);
}

extern "C" int node_scores_slots_launch(const void* free_gpus,
                                        const void* used_gpus,
                                        const void* mask, const void* gload,
                                        const void* topo, void* score,
                                        void* slots, int64_t n,
                                        int32_t request, float g,
                                        float w_used, float w_fit,
                                        float w_group, float w_topo,
                                        void* stream) {
  return launch<true>(free_gpus, used_gpus, mask, gload, topo, score, slots,
                      n, request, g, w_used, w_fit, w_group, w_topo, stream);
}
