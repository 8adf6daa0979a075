// Elementwise activations of the port's kernels, by code. The codes are the
// order of ops/cuda_kernels.py `ACT_CODES`; each function computes what the
// same name computes in ops/activations.py, in f32.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace dl4j {

enum Act : int {
  kIdentity = 0,
  kRelu = 1,
  kTanh = 2,
  kSigmoid = 3,
  kLeakyRelu = 4,
  kElu = 5,
  kSelu = 6,
  kSoftplus = 7,
  kSoftsign = 8,
  kHardTanh = 9,
  kHardSigmoid = 10,
  kCube = 11,
  kRationalTanh = 12,
  kRectifiedTanh = 13,
  kGelu = 14,
  kSwish = 15,
  kNumActs = 16,
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float activate(int act, float v) {
  switch (act) {
    case kRelu: return v > 0.f ? v : 0.f;
    case kTanh: return tanhf(v);
    case kSigmoid: return sigmoid(v);
    case kLeakyRelu: return v > 0.f ? v : 0.01f * v;
    case kElu: return v > 0.f ? v : expm1f(v);
    case kSelu:
      return 1.0507009873554805f * (v > 0.f ? v : 1.6732632423543772f * expm1f(v));
    case kSoftplus: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    case kSoftsign: return v / (1.f + fabsf(v));
    case kHardTanh: return fminf(fmaxf(v, -1.f), 1.f);
    case kHardSigmoid: return fminf(fmaxf(0.2f * v + 0.5f, 0.f), 1.f);
    case kCube: return v * v * v;
    case kRationalTanh: {
      const float a = fabsf(2.f * v / 3.f);
      const float approx =
          copysignf(1.f - 1.f / (1.f + a + a * a + 1.41645f * a * a * a * a), v);
      return v == 0.f ? 0.f : 1.7159f * approx;
    }
    case kRectifiedTanh: return fmaxf(tanhf(v), 0.f);
    case kGelu:
      return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case kSwish: return v * sigmoid(v);
    default: return v;  // kIdentity
  }
}

// d act / dz for the activations the fused BN+act+pool backward recomputes
// (JAX pallas_kernels.py `_BNAP_ACTS` :239: identity, relu, tanh, sigmoid).
__device__ __forceinline__ float activate_grad(int act, float z) {
  switch (act) {
    case kRelu: return z > 0.f ? 1.f : 0.f;
    case kTanh: {
      const float t = tanhf(z);
      return 1.f - t * t;
    }
    case kSigmoid: {
      const float s = sigmoid(z);
      return s * (1.f - s);
    }
    default: return 1.f;  // kIdentity
  }
}

}  // namespace dl4j

extern "C" const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
