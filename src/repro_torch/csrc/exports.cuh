// The C entry points every kernel library exports besides its kernels:
// kernels/common.py reads them through ctypes.  Include once per .cu file
// (each source is its own shared library).
#pragma once

#include <cuda_runtime.h>

// Message for a status a C entry point returned (cudaGetLastError()).
extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Shared memory one block may opt into on `device` (227 KB on sm_90), or
// -1 if the card cannot be asked.
extern "C" int repro_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}
