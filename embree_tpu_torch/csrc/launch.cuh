// The kernel entries and their launch dispatch over the template flags,
// shared by traverse.cu (B1-B6 and the C entry point), traverse_curves.cu
// (B7) and traverse_round.cu (B8 beside B7), which nvcc compiles in
// parallel into objects of one library.
//
// One kernel. Every variant (72 instantiations: the static triangles B1,
// robust triangles B2 and mixed classes B3-B5, 6 + 6 + 8; the moving
// variants B6, 20; the curve variants B7 and B8, static or moving, 16
// each) runs persistent warps (persistent_kernel, the scheduler in
// traverse.cuh): as many blocks as stay resident, lanes refilled from a
// global ray counter as their rays finish, leaves postponed until enough
// lanes wait at one, and each lane's stack in a column of shared memory
// instead of local memory. Moving rays are U[0,1) in time, which the
// coherence sort does not see, so their step counts spread far (p99.9 657
// steps against a mean of 19 on the 2-step sphere): one ray per thread
// left 85-91% of lane-steps idle there, and 70.5% on the static triangle
// sphere. A curve leaf visit costs about 14,000 operations against a
// node's 100, so one ray per thread left the lanes at nodes idle behind
// those at leaves; the curve variants' leaf pass deals its (ray, slot)
// items across the warp (curve_pass), with the knot weights and each
// warp's scratch in shared memory beside the stacks; the static variants'
// leaf pass (static_pass) keeps its scratch there too.
#pragma once

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace trav {

constexpr int kBlock = 128;

// The scheduler's lane bookkeeping on the card (run_warp's WARP): a thread
// is one lane; its stack is column threadIdx.x of the block's shared
// memory, kStack rows of kBlock entries.
struct CudaWarp {
  static constexpr int kLanes = 1;
  int32_t* column;
  int lane;

  TRAV_HD Stack<kBlock> stack(int) const { return Stack<kBlock>{column}; }

  template <class F>
  TRAV_HD void each(F f) const {
    f(0, lane);
  }

  template <class F>
  TRAV_HD uint32_t ballot(F pred) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xFFFFFFFFu, pred(0));
#else
    return 0;
#endif
  }

  TRAV_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }

  TRAV_HD void atomic_min(int32_t* word, int32_t v) const {
#ifdef __CUDA_ARCH__
    atomicMin(word, v);
#endif
  }

  // one fetch-add for the warp, by its lowest idle lane, broadcast
  TRAV_HD int take(int32_t* next_ray, uint32_t idle) const {
#ifdef __CUDA_ARCH__
    const int leader = __ffs(idle) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(next_ray, __popc(idle));
    return __shfl_sync(0xFFFFFFFFu, base, leader);
#else
    return 0;
#endif
  }

  TRAV_HD void overflow(int32_t* out_overflow) const {
#ifdef __CUDA_ARCH__
    atomicAdd(out_overflow, 1);
#endif
  }

  TRAV_HD void add_counts(unsigned long long* counts, uint32_t passes,
                          uint32_t steps, const uint32_t* finished) const {
#ifdef __CUDA_ARCH__
    const unsigned n = __reduce_add_sync(0xFFFFFFFFu, finished[0]);
    if (lane == 0) {
      atomicAdd(counts, 32ull * passes);
      atomicAdd(counts + 1, static_cast<unsigned long long>(steps));
      atomicAdd(counts + 2, static_cast<unsigned long long>(n));
    }
#endif
  }

  TRAV_HD void add_leaf_counts(unsigned long long* counts, uint32_t passes,
                               uint32_t steps, uint32_t rounds) const {
#ifdef __CUDA_ARCH__
    if (lane == 0) {
      atomicAdd(counts + 4, 32ull * passes);
      atomicAdd(counts + 5, static_cast<unsigned long long>(steps));
      atomicAdd(counts + 6, 32ull * rounds);
    }
#endif
  }
};

// Leaf passes that deal items (curve_pass, static_pass): CudaWarp and the
// warp's scratch words, after the stacks (and the knot weights). A type of
// its own: a third member in CudaWarp renamed registers in 16 of B6's
// kernels, which moved ptxas's schedule (one ran 2% slower on an H100).
struct CudaScratchWarp : CudaWarp {
  int32_t* scr;
  TRAV_HD int32_t* scratch() const { return scr; }
};

// counts: see run_warp; [3] gets the warps resident per SM. At least
// kMinBlocks resident blocks (16 warps per SM, 128 KB of stacks): ptxas
// then allocates up to 128 registers. Without the bound its occupancy
// heuristic stopped at 96 and spilled in some variants
// (perf/sched_sweep.py times both); the curve variants took 3 (12 warps
// per SM) no faster. Static B1-B5 use 78-83 registers and 39 KB of shared
// memory a block, so 5 blocks stay resident (20 warps per SM) at 3 or 4.
constexpr int kMinBlocks = 4;
// B6's 8 mixed-class variants (moving, kind tags, no curves) fill all 128
// registers at kMinBlocks, and there ptxas left out a wait (fault C.2): in
// the two masked closest-hit ones (robust or not) the pop's shared-memory
// load of the next record (LDS) sets a dependency barrier that the loop's
// next reads of that register never wait on. A load slower than the 19
// instructions in between left the value set just before it, 0, the root,
// so the ray walked the tree again (the same hit, twice the steps); a
// bounds check that read the old value and an index that read the new one
// could fetch a node outside the table (the illegal addresses).
// perf/sass_hazards.py finds these 10 reads in each of the two at 4
// blocks, and no hazard in any of the 72 instantiations at 3 (room for 168
// registers), where ptxas places the waits. TRAV_MOTION_KINDS_MIN_BLOCKS
// sets another bound, for that check.
#ifndef TRAV_MOTION_KINDS_MIN_BLOCKS
#define TRAV_MOTION_KINDS_MIN_BLOCKS 3
#endif
constexpr int kMotionKindsMinBlocks = TRAV_MOTION_KINDS_MIN_BLOCKS;

template <bool KINDS, bool MOTION, bool CURVES>
constexpr int min_blocks() {
  return KINDS && MOTION && !CURVES ? kMotionKindsMinBlocks : kMinBlocks;
}

// Dynamic shared memory of a persistent block: the stacks, in curve scenes
// the knot weights, and in curve scenes and static B1-B5 each warp's
// scratch (traverse.cuh; a scene without curves: the ray rows and the key
// rows).
template <bool MOTION, bool CURVES>
size_t persistent_smem(const Params& p) {
  size_t words = static_cast<size_t>(kStack) * kBlock;
  if (CURVES) words += curve_weight_words(p.curve_rate);
  if (CURVES || !MOTION) {
    words += (kBlock / 32) * curve_scratch_words(p.kind_classes);
  }
  return words * sizeof(int32_t);
}

template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION, bool CURVES, bool ROUND>
__global__ void __launch_bounds__(kBlock,
                                  min_blocks<KINDS, MOTION, CURVES>())
    persistent_kernel(Params p, int32_t* out_overflow, int32_t* next_ray,
                      unsigned long long* counts, int warps_per_sm) {
  // the stacks (kStack x kBlock, column-major), then in curve scenes the
  // knot weights and each warp's scratch, in static B1-B5 each warp's
  // scratch
  extern __shared__ int32_t smem[];
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[3] = warps_per_sm;
  if constexpr (CURVES) {
    float* wt = reinterpret_cast<float*>(smem + kStack * kBlock);
    const int n_w = curve_weight_words(p.curve_rate);
    for (int k = threadIdx.x; k < n_w; k += kBlock) {
      wt[k] = load1f(p.curve_w + k);
    }
    __syncthreads();
    const CudaScratchWarp w{{smem + threadIdx.x,
                             static_cast<int>(threadIdx.x & 31)},
                            smem + kStack * kBlock + n_w + (threadIdx.x >> 5) *
                                curve_scratch_words(p.kind_classes)};
    run_warp<CudaScratchWarp, OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS,
             MOTION, CURVES, ROUND>(p, w, next_ray, out_overflow, counts, wt);
  } else if constexpr (!MOTION) {
    const CudaScratchWarp w{
        {smem + threadIdx.x, static_cast<int>(threadIdx.x & 31)},
        smem + kStack * kBlock +
            (threadIdx.x >> 5) * curve_scratch_words(p.kind_classes)};
    run_warp<CudaScratchWarp, OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS,
             MOTION, CURVES, ROUND>(p, w, next_ray, out_overflow, counts,
                                    nullptr);
  } else {
    const CudaWarp w{smem + threadIdx.x, static_cast<int>(threadIdx.x & 31)};
    run_warp<CudaWarp, OCCLUSION, WANT_ATTRS, HAS_MASK, ROBUST, KINDS, MOTION,
             CURVES, ROUND>(p, w, next_ray, out_overflow, counts, nullptr);
  }
}

// The launch's outputs beside the per-ray ones: the stack overflow count,
// the ray counter (zeroed) and the work counts.
struct Counters {
  int32_t* overflow;
  int32_t* next_ray;
  unsigned long long* counts;
};

// Resident blocks per SM x SMs, or fewer when the rays fill fewer. A failed
// attribute or occupancy query leaves its error for traverse_launch to
// return.
template <bool OCCLUSION, bool WANT_ATTRS, bool HAS_MASK, bool ROBUST,
          bool KINDS, bool MOTION, bool CURVES, bool ROUND>
void launch(const Params& p, Counters c, cudaStream_t s) {
  const auto kernel = persistent_kernel<OCCLUSION, WANT_ATTRS, HAS_MASK,
                                        ROBUST, KINDS, MOTION, CURVES, ROUND>;
  const size_t smem = persistent_smem<MOTION, CURVES>(p);
  int per_sm = 0, dev = 0, sms = 0;
  if ((smem > 48 * 1024 &&
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem)) != cudaSuccess) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                    smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return;
  }
  const int need = (p.n_rays + kBlock - 1) / kBlock;
  const int grid = per_sm * sms < need ? per_sm * sms : need;
  kernel<<<grid, kBlock, smem, s>>>(p, c.overflow, c.next_ray, c.counts,
                                    per_sm * (kBlock / 32));
}

// {mask chunk or not} x {robust or not}; time windows are a uniform
// runtime branch of the moving variants (Params::has_win).
template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool MOTION,
          bool CURVES, bool ROUND>
void launch_flags(const Params& p, int has_mask, int robust, Counters c,
                  cudaStream_t s) {
  constexpr bool O = OCCLUSION, A = WANT_ATTRS, K = KINDS, M = MOTION,
                 C = CURVES, R = ROUND;
  if (has_mask) {
    if (robust) launch<O, A, true, true, K, M, C, R>(p, c, s);
    else launch<O, A, true, false, K, M, C, R>(p, c, s);
  } else {
    if (robust) launch<O, A, false, true, K, M, C, R>(p, c, s);
    else launch<O, A, false, false, K, M, C, R>(p, c, s);
  }
}

template <bool OCCLUSION, bool WANT_ATTRS, bool KINDS, bool CURVES,
          bool ROUND = false>
void launch_motion(const Params& p, int has_mask, int robust, int has_motion,
                   Counters c, cudaStream_t s) {
  if (has_motion) {
    launch_flags<OCCLUSION, WANT_ATTRS, KINDS, true, CURVES, ROUND>(
        p, has_mask, robust, c, s);
  } else {
    launch_flags<OCCLUSION, WANT_ATTRS, KINDS, false, CURVES, ROUND>(
        p, has_mask, robust, c, s);
  }
}

// The 16 flat curve variants (traverse_curves.cu) and the 16 round ones
// (traverse_round.cu, scenes with round slots): {closest, occluded} x {mask
// chunk or not} x {robust or not} x {static or moving}.
void launch_curves(const Params& p, int occlusion, int has_mask, int robust,
                   int has_motion, Counters c, cudaStream_t s);
void launch_round(const Params& p, int occlusion, int has_mask, int robust,
                  int has_motion, Counters c, cudaStream_t s);

}  // namespace trav
