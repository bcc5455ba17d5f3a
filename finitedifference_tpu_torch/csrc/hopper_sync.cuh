// mbarrier, bulk-copy and shared-memory address helpers of the Hopper
// kernels (wavefront.cu, gn_full.cu, gn_traj.cu): inline PTX for sm_90.
#pragma once

namespace fdsync {

// the 32-bit shared-window address of a pointer into this CTA's shared memory
__device__ __forceinline__ unsigned local_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// makes the barriers a thread has initialised known to the cluster and to
// the copy engine
__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's one arrival of the barrier's current phase, which also
// announces `bytes` of asynchronous stores or copies the phase waits for
__device__ __forceinline__ void barrier_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// spins until the barrier's phase of that parity has completed
__device__ __forceinline__ void barrier_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One contiguous run of bytes (a multiple of 16, 16-byte aligned at both
// ends) from global to shared memory by the copy engine: one instruction
// of one thread whatever the length. It counts its bytes on the mbarrier.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(local_address(smem)), "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace fdsync
