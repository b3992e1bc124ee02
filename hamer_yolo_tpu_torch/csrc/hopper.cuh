// Hopper (sm_90a) building blocks shared by attn_block.cu, int8_gemm.cu,
// nms.cu and short_attention.cu: mbarriers, TMA tile loads and stores and
// tensor maps, contiguous bulk copies, named barriers, the wgmma fences, the 128-byte-swizzle
// shared-memory descriptor, thread-block clusters (rank, cluster barrier,
// another CTA's shared memory as a generic pointer, distributed shared
// memory stores, asynchronous ones included, and mbarrier arrivals), and the
// device's SM count.
// cuTensorMapEncodeTiled is looked up through the runtime
// (cudaGetDriverEntryPoint), so the libraries link against nothing but the
// CUDA runtime.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The producer's arrival on a full barrier: the stage's copies bring bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// Orders this thread's generic-proxy view of shared memory (its stores, the
// copies it has waited for) before wgmma's reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of a 2-D tensor (coordinates: inner element, row) into shared memory,
// laid out (and swizzled) as its map says; elements past the tensor's edges
// arrive as zeros. Completes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// ``bytes`` (a multiple of 16) from device memory at src to shared memory at
// dst, both 16-byte aligned, by the TMA unit's bulk copy (no tensor map: the
// range is contiguous); completes on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A box of a 2-D tensor from shared memory (laid out as its map says) to
// device memory at (inner element, row), clipped at the tensor's edges, in
// this thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups are still reading their
// shared memory (READ) or still in flight at all.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier among ``threads`` threads of the CTA (a multiple of 32), by id
// 1-15 (0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The shared-memory descriptor of a K-major operand under the 128-byte
// swizzle, as TMA writes it: rows of 128 bytes, 8-row atoms 1024 bytes apart
// (the stride byte offset, in 16-byte units), layout type 1 in bits 62-63;
// the leading byte offset is unused for this layout. The tile bases are
// 1024-byte aligned, so stepping K by 32 bytes inside the swizzle row adds 2
// to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// ------------------------------------------------ thread-block clusters
// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster-wide barrier of every thread of every CTA, split in two: the
// arrival releases this thread's writes (shared memory of any CTA of the
// cluster included), the wait acquires the others'. Each warp executes both
// converged.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of the variable at this CTA's shared address
// ``addr`` in the CTA of rank ``rank`` (distributed shared memory).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// p, a variable in this CTA's shared memory, in the CTA of rank ``rank``:
// a generic pointer whose plain loads, stores and atomics reach that CTA's
// shared memory (distributed shared memory).
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, uint32_t rank) {
  return static_cast<T*>(__cluster_map_shared_rank((void*)p, rank));
}

// 16 bytes to a shared::cluster address (any CTA of the cluster).
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 16 bytes to a shared::cluster address, asynchronously: they count as 16
// bytes of transaction on the mbarrier at the shared::cluster address bar, in
// the same CTA, whose phase completes once they (and the bytes its
// expect_tx announced) have landed.
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// One arrival on the mbarrier at a shared::cluster address (any CTA of the
// cluster), releasing this thread's earlier writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait acquiring at cluster scope: what other CTAs wrote before their
// (release.cluster) arrivals is visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// fence_proxy_async for writes to the shared memory of any CTA of the
// cluster (st.shared::cluster) that another CTA's wgmma will read.
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

constexpr int MAX_DEVICES = 64;

// The current device and its SM count, read from the runtime once per device.
inline int current_sms(int* dev, int* sms) {
  static int cached[MAX_DEVICES] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!cached[*dev]) {
    err = cudaDeviceGetAttribute(&cached[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = cached[*dev];
  return 0;
}

// cuTensorMapEncodeTiled, looked up through the runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)f;
  }
  return fn;
}

// The TMA map of a row-major (rows, cols) matrix of ``type`` (elem bytes an
// element) at base: boxes of box_rows x box_cols, swizzled as ``swizzle``
// says, zeros past the edges. Returns a cudaError_t.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                     int rows, int cols, int box_rows, int box_cols,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
