// Fused node filter+score pass of RSCH's Level-2 placement, for Hopper.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/node_score.py:
//   _score_kernel        (launched by node_scores_pallas)       -> node_scores_launch
//   _score_slots_kernel  (launched by node_scores_slots_pallas) -> node_scores_slots_launch
// Both share one __device__ body, as the TPU kernels share one formula.
// node_scores_staged_launch runs either one between the packed seam's
// copy up and copy down, in one call from the host.
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
// What bounds it, by size.  Per node the pass reads 17 bytes (int32 free
// and used, a 1-byte bool mask, f32 group load and topo preference) and
// writes 4 (scores) or 8 (scores + int32 slots), against ~10 flops.
//   * The 33-160 nodes of subset scoring (the paper's main path): the
//     launch.  node_score_noop_launch is an empty kernel on the same
//     launch path, whose time is that floor; the pass sits about 2 us
//     above it.
//   * A full-width pass (1M nodes, 25 MB): memory bandwidth, 7.5 us at
//     3.35 TB/s, plus the launch and the ramp of a one-wave grid.
//
// Design.  Vector path: each thread owns one group of 4 consecutive
// nodes and starts all its loads before any math: 16-byte loads of free,
// used, gload and topo and one 4-byte load of the mask, with streaming
// cache hints (the data is touched once), then 16-byte streaming stores
// of scores and slots.  Neighbouring threads own neighbouring groups, so
// a warp's every load and store is one contiguous 512-byte (128-byte for
// the mask) access.  The grid is one group a thread over ceil(n/1024)
// blocks of 256, 68 bytes in flight a thread: at 1M nodes, 977 blocks,
// of which 792 are resident at once (6 an SM at ~40 registers), each SM
// holding ~100 KB of loads in flight, several times what hides the
// latency of HBM.  The ragged tail (n % 4 nodes) is scored by the first
// thread past the last group, in the same kernel.
// Scalar path: taken when any column's pointer is not 16-byte aligned
// (a view at an odd offset): one node a thread a trip of a grid-stride
// loop over at most SMs x 16 blocks.  n = 0 launches nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -3.40282346638528859812e+38f;  // float32 min
constexpr int kThreads = 256;
constexpr int kGroup = 4;  // nodes a thread owns on the vector path

struct Params {
  int64_t n;
  int32_t request;
  float g;
  float w_used, w_fit, w_group, w_topo;
};

struct Cols {
  const int32_t* free;
  const int32_t* used;
  const uint8_t* mask;
  const float* gload;
  const float* topo;
  float* score;
  int32_t* slots;  // null for the score-only pass
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

// One node, scalar loads and stores.
template <bool kSlots>
__device__ __forceinline__ void score_node(const Cols& c, int64_t i,
                                           const Params& p) {
  const int32_t f = c.free[i];
  bool valid;
  c.score[i] = score_one(f, c.used[i], c.mask[i] != 0, c.gload[i],
                         c.topo[i], p, &valid);
  if (kSlots) c.slots[i] = valid ? f / p.request : 0;
}

// Four nodes already in registers -> 16-byte stores to group `grp`.
template <bool kSlots>
__device__ __forceinline__ void score_group(const Cols& c, int64_t grp,
                                            int4 f, int4 u, uint32_t m,
                                            float4 gl, float4 tp,
                                            const Params& p) {
  bool v0, v1, v2, v3;
  float4 s;
  s.x = score_one(f.x, u.x, (m & 0x000000ffu) != 0, gl.x, tp.x, p, &v0);
  s.y = score_one(f.y, u.y, (m & 0x0000ff00u) != 0, gl.y, tp.y, p, &v1);
  s.z = score_one(f.z, u.z, (m & 0x00ff0000u) != 0, gl.z, tp.z, p, &v2);
  s.w = score_one(f.w, u.w, (m & 0xff000000u) != 0, gl.w, tp.w, p, &v3);
  __stcs(reinterpret_cast<float4*>(c.score) + grp, s);
  if (kSlots) {
    const int4 sl = make_int4(v0 ? f.x / p.request : 0,
                              v1 ? f.y / p.request : 0,
                              v2 ? f.z / p.request : 0,
                              v3 ? f.w / p.request : 0);
    __stcs(reinterpret_cast<int4*>(c.slots) + grp, sl);
  }
}

template <bool kSlots, bool kVec>
__global__ void __launch_bounds__(kThreads)
node_score_kernel(Cols c, Params p) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (kVec) {
    const int64_t groups = p.n / kGroup;
    if (t < groups) {
      const int4 f = __ldcs(reinterpret_cast<const int4*>(c.free) + t);
      const int4 u = __ldcs(reinterpret_cast<const int4*>(c.used) + t);
      const uint32_t m =
          __ldcs(reinterpret_cast<const unsigned int*>(c.mask) + t);
      const float4 gl = __ldcs(reinterpret_cast<const float4*>(c.gload) + t);
      const float4 tp = __ldcs(reinterpret_cast<const float4*>(c.topo) + t);
      score_group<kSlots>(c, t, f, u, m, gl, tp, p);
    } else if (t == groups) {
      for (int64_t i = groups * kGroup; i < p.n; ++i) score_node<kSlots>(c, i, p);
    }
  } else {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = t; i < p.n; i += stride) score_node<kSlots>(c, i, p);
  }
}

__global__ void noop_kernel() {}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v;
  }
  return sms;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

bool all_aligned(const Cols& c) {
  return aligned16(c.free) && aligned16(c.used) && aligned16(c.mask) &&
         aligned16(c.gload) && aligned16(c.topo) && aligned16(c.score) &&
         (c.slots == nullptr || aligned16(c.slots));
}

template <bool kSlots>
cudaError_t launch_aligned(const Cols& c, const Params& p,
                           cudaStream_t stream) {
  // One group a thread, plus one thread for the ragged tail.
  const int64_t threads = p.n / kGroup + (p.n % kGroup != 0);
  const int64_t grid = (threads + kThreads - 1) / kThreads;
  node_score_kernel<kSlots, true><<<static_cast<unsigned>(grid), kThreads,
                                    0, stream>>>(c, p);
  return cudaGetLastError();
}

template <bool kSlots>
int launch(const void* free_gpus, const void* used_gpus, const void* mask,
           const void* gload, const void* topo, void* score, void* slots,
           int64_t n, int32_t request, float g, float w_used, float w_fit,
           float w_group, float w_topo, void* stream) {
  if (n <= 0 || request <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{n, request, g, w_used, w_fit, w_group, w_topo};
  const Cols c{static_cast<const int32_t*>(free_gpus),
               static_cast<const int32_t*>(used_gpus),
               static_cast<const uint8_t*>(mask),
               static_cast<const float*>(gload),
               static_cast<const float*>(topo), static_cast<float*>(score),
               static_cast<int32_t*>(slots)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (all_aligned(c)) return static_cast<int>(launch_aligned<kSlots>(c, p, s));
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  node_score_kernel<kSlots, false><<<static_cast<unsigned>(
      want < cap ? want : cap), kThreads, 0, s>>>(c, p);
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

// The addresses and byte counts of one staging layout of the packed seam
// (core/scoring.py::_Staging), as kernels/node_score.py::StagedPlan lays
// them out: checked once, when the layout is built, and read by every
// pass over it.
struct StagedPlan {
  const void* host_in;   // pinned host input, copied up from
  void* dev_in;          // device input, copied up to
  int64_t in_bytes;
  const void* cols[5];   // free, used, mask, gload, topo: inside dev_in
  void* score;           // inside dev_out
  void* slots;           // inside dev_out; null for the score-only pass
  const void* dev_out;   // device output, copied down from
  void* host_out;        // pinned host output, copied down to
  int64_t out_bytes;
  int64_t n;             // nodes of the pass (the padded count)
  int64_t device;        // the card every address lies on
};

// One pass of the packed seam in one call: the packed columns up, the
// pass over them (launch<kSlots>, as the two entries above), the packed
// outputs down, all enqueued on `stream` in that order.  Returns the
// first CUDA error; the caller waits on the stream.  The card of the plan
// is made current for the call and the caller's restored after it.
extern "C" int node_scores_staged_launch(const StagedPlan* plan,
                                         int32_t request, float g,
                                         float w_used, float w_fit,
                                         float w_group, float w_topo,
                                         void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dev = static_cast<int>(plan->device);
  if (prev != dev && (err = cudaSetDevice(dev)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemcpyAsync(plan->dev_in, plan->host_in,
                        static_cast<size_t>(plan->in_bytes),
                        cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess && plan->n > 0) {
    const void* const* c = plan->cols;
    err = static_cast<cudaError_t>(
        plan->slots != nullptr
            ? launch<true>(c[0], c[1], c[2], c[3], c[4], plan->score,
                           plan->slots, plan->n, request, g, w_used, w_fit,
                           w_group, w_topo, stream)
            : launch<false>(c[0], c[1], c[2], c[3], c[4], plan->score,
                            nullptr, plan->n, request, g, w_used, w_fit,
                            w_group, w_topo, stream));
  }
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(plan->host_out, plan->dev_out,
                          static_cast<size_t>(plan->out_bytes),
                          cudaMemcpyDeviceToHost, s);
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}

// An empty kernel on the same launch path: the time of a launch that
// does no work, the floor of a pass at subset-scoring sizes.
extern "C" int node_score_noop_launch(void* stream) {
  noop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
