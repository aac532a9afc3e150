// Asynchronous copies from device memory into shared memory (`cp.async`,
// sm_80+ PTX, built for sm_90a), shared by the kernels that stage their
// operands through a ring in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hapm {

// V bytes (4, 8 or 16) from src to dst, through L1
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(V));
}

// 16 bytes from src to dst past L1; the first `src_bytes` (0 or 16) are
// read, the rest of the 16 are written as zeros
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// V bytes (4, 8 or 16) from src to dst through L1; the first `src_bytes`
// (0 or V) are read, the rest of the V are written as zeros
template <int V>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(V),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// The copy unit of a staging path: 16 bytes through cp.async, or one element.
template <typename T, bool kVec>
struct CopyUnit {
  using type = uint4;
  static constexpr int elems = 16 / sizeof(T);
};
template <>
struct CopyUnit<float, false> {
  using type = uint32_t;
  static constexpr int elems = 1;
};
template <>
struct CopyUnit<__nv_bfloat16, false> {
  using type = uint16_t;
  static constexpr int elems = 1;
};

// One unit from src to dst, or zeros where !ok (src is then not read):
// cp.async for 16-byte units, a plain load and store for an element.
template <typename T, bool kVec>
__device__ __forceinline__ void copy_unit(T* dst, const T* src, bool ok) {
  using Unit = typename CopyUnit<T, kVec>::type;
  if constexpr (kVec) {
    cp_async16_zfill(dst, src, ok ? 16 : 0);
  } else {
    *reinterpret_cast<Unit*>(dst) = ok ? *reinterpret_cast<const Unit*>(src) : Unit(0);
  }
}

}  // namespace hapm
