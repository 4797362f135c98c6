// Per-device host state of the kernels: a process may launch on any of its
// cards, and a function attribute or a queried property belongs to the
// device that was current when it was set or read, so each is kept once a
// device. Shared by flash_attention_fwd.cu, flash_attention_bwd.cu,
// lowbit_gemm.cuh and ln_residual.cu.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace device_once {

// devices a process may launch on (the per-device tables)
constexpr int kMaxDevices = 64;

// The current device (-1 where it cannot be read or lies past the tables).
inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

// Above 48 KB a block's dynamic shared memory has to be opted into: KERN's
// opt-in to SMEM bytes on the current device, set once a device (SMEM is a
// constant of the instantiation).
template <auto KERN>
cudaError_t opt_in_smem(int smem) {
  static cudaError_t attr[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev, smem] {
    attr[dev] = cudaFuncSetAttribute(
        KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  return attr[dev];
}

}  // namespace device_once
