// Float atomic max for the port's scatter-max kernels (segreduce.cu,
// sketch.cu).  CUDA has a native atomicMax for int32 but none for float.
//
// The sign-split trick works on the float's own storage, with no CAS loop:
//   * a value with its sign bit clear (+0.0 .. +inf) orders like its bits
//     read as a signed int, and every negative float reads as a negative
//     int, so atomicMax on the int view is the float max;
//   * a value with its sign bit set (-0.0 .. -inf) orders in reverse of its
//     bits read as an unsigned int, and every non-negative float reads as a
//     smaller unsigned int, so atomicMin on the unsigned view is the float
//     max.
// Both are atomic read-modify-writes of the same 32-bit word, so they may
// race with each other freely.  Correct for +-inf and for -0.0 against +0.0
// (+0.0 wins, as the ordering of the bits says); NaN is not supported.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {  // sign bit clear
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_any(float* addr, float v) {
  atomic_max_float(addr, v);
}

__device__ __forceinline__ void atomic_max_any(int32_t* addr, int32_t v) {
  atomicMax(addr, v);
}
