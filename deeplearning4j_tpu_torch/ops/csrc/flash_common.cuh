// What every attention source shares beyond the tensor-core cores: the C
// entry point that names a cudaError_t for the Python wrappers
// (ops/cuda_kernels.py `_raise_on`). Included once per shared library by
// flash_attention_fwd.cu, flash_attention_bwd.cu and (through
// splash_common.cuh) the two splash sources.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
