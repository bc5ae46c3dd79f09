// Hopper's way of feeding the tensor cores, as building blocks: tiles copied
// by the Tensor Memory Accelerator (TMA) into 128-byte-swizzled shared
// memory behind one mbarrier, warpgroup products (wgmma.mma_async m64n64k16,
// bf16 -> fp32) on shared-memory descriptors of those tiles, and TMA stores
// back. probes.cu (the regression tier's two probes) is built on it.
//
// The 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout 1):
// a tile is rows of 128 bytes, 1024-byte aligned; the 16-byte chunk c of
// row r lies at chunk c ^ (r % 8) of that row. Eight rows are one swizzle
// atom (1024 bytes). sw128() below is the address of a byte in that layout;
// a thread that writes a tile for wgmma or a TMA store writes it there.
//
// The operands as wgmma reads them (PTX ISA, "Matrix Descriptor Format"):
//   A, K-major (a row of A is 64 bf16 k values, 128 bytes): a panel of 64
//     rows x 64 k is 8 atoms along M, the stride byte offset (SBO) 1024;
//     the leading byte offset (LBO) is unused with a swizzle. The k16 step
//     j of a panel starts 32 j bytes into it: the hardware swizzles the
//     address it computes, so an offset inside the atom's row is added to
//     the start address as it is.
//   B, MN-major (w [K, N] as it lies in memory, n contiguous; the
//     instruction's transpose-B immediate set): a k row of 64 n values is
//     128 bytes, eight k rows one atom; the next eight k rows are SBO =
//     1024 bytes on. LBO would step to the next 64 n, which an n64 product
//     never needs: it is given 1024 too.
// A descriptor's start address must keep the atom's phase: every tile and
// panel here begins on a 1024-byte boundary, so the base offset is 0.
//
// Host side: the tensor maps are encoded by cuTensorMapEncodeTiled, taken
// from the driver through cudaGetDriverEntryPoint (the library links the
// runtime only, no -lcuda), and passed to a kernel as
// `const __grid_constant__ CUtensorMap`. TMA needs every global row stride
// and the base address to be multiples of 16 bytes; it fills what lies
// outside the tensor with zeros on a load and drops it on a store.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "mma.cuh"

namespace {

// ---- shared memory ---------------------------------------------------------

// The address of byte `byte` (0..127) of row `row` of a 128-byte-swizzled
// tile, from the tile's start.
__host__ __device__ constexpr uint32_t sw128(int row, int byte) {
  return static_cast<uint32_t>(row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15));
}

// `raw` moved up to the next 1024-byte boundary of the shared window (a
// kernel asks for 1024 bytes more than its tiles).
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// The generic-proxy stores of this thread (ordinary st.shared), seen by the
// async proxy (wgmma's operand reads, TMA stores). Then a block barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more of TMA traffic in this phase
// (0: the arrival alone completes it).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `phase` has completed. A phase that never
// completes (a TMA that was refused) ends the kernel with a trap, an error
// at the next synchronization, rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// ---- TMA ---------------------------------------------------------------------

// A 2-D box at coordinates (c0 along the contiguous dimension, c1 along the
// rows) into shared memory at `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 2-D box from shared memory at `src` to the tensor at (c0, c1).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}

// The stores issued so far by this thread, read out of shared memory (the
// block may then end: the writes to global memory complete on their own).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- wgmma -------------------------------------------------------------------

// A shared-memory matrix descriptor for the 128-byte swizzle: start address
// >> 4 (bits 0-13), LBO >> 4 (16-29), SBO >> 4 (32-45), base offset 0
// (49-51), layout 1 = 128-byte swizzle (62-63).
__device__ __forceinline__ uint64_t sw128_descriptor(const void* start, uint32_t lbo,
                                                     uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((smem_addr(start) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// K-major A (rows of 64 k) and MN-major B (rows of 64 n), as above.
__device__ __forceinline__ uint64_t desc_a(const void* start) {
  return sw128_descriptor(start, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_b_mn(const void* start) {
  return sw128_descriptor(start, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// The accumulators pinned in place: written before the fence that precedes
// their first product, read only after the wait that covers their last
// (without it the compiler may move their stores past the fence, and ptxas
// then fences and waits before every product).
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VADC_WGMMA_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define VADC_WGMMA_D32_OUT(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d += A @ B over one k16 step, 64 x 64: A and B in shared memory (A
// K-major, B MN-major: transpose-B 1).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VADC_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : VADC_WGMMA_D32_OUT(d)
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// The same with A from registers: warp w of the warpgroup holds rows 16 w
// .. 16 w + 15 as mma.sync m16n8k16's A fragment (g = lane / 4, t = lane %
// 4: a[0] row g, k 2t and 2t + 1; a[1] row g + 8; a[2], a[3] the same at k
// + 8; the lower k in a register's lower half).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VADC_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : VADC_WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

#undef VADC_WGMMA_D32
#undef VADC_WGMMA_D32_OUT

// ---- host: tensor maps, shared-memory limits ----------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] tensor (row stride `stride_bytes`) as a TMA map
// of boxes [box_rows, box_cols], 128-byte swizzle, zero fill.
inline bool tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          uint64_t rows, uint64_t cols, uint64_t stride_bytes, uint32_t box_rows,
                          uint32_t box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per process and
// device for a kernel: `done` holds a bit per device it was set on.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
