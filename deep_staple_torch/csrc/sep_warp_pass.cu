// One scanline pass of the separable augmentation warp, for NVIDIA Hopper
// (sm_90a).
//
// Replaces deep_staple_tpu/ops/sep_warp.py::_sep_pass_pallas (the Mosaic
// lane-gather kernel, body :339-345, pallas_call :347) with the element math
// of _pass_index_math / _pass_elem_math (:283-307). Rows of L lanes; for
// element (r, i), with cc = cc[r, i]:
//
//   i0   = clamp(floor(clamp(cc, 0, L-1)), 0, max(L-2, 0))
//   word = words[r, i0]                 (a gather inside the same row)
//   img  = v0 * (1 - w) + v1 * w,  w = clamp(cc, 0, L-1) - i0, where v0, v1
//          are the sign-extended int12 quanta in bits 0..11 and 12..23
//   code = 2-bit code in bits 24..25 (i0) or 26..27 (i0 + 1), whichever
//          rint(cc) (half to even) picks; 0 unless -0.5 <= cc < L - 0.5.
//
// The lerp is written with __fmul_rn / __fadd_rn so that nvcc does not
// contract it into FMAs: the result is then the same float32 arithmetic as
// the plain version's.
//
// What bounds it: bytes, 16 per element (word and cc read, img and code
// written), with 6 integer and 6 float operations per element. At the
// production size (6.6M elements a pass) that is 31 us of memory traffic, so
// in practice the launch and the transposes around the pass bound it.
// What the design does about it: one thread per element, consecutive
// threads on consecutive lanes so that every read and write is coalesced;
// the gathered word comes from the same row, which the row's other threads
// have just brought into L1. There is no padding of L to a multiple of 64
// (that was a Mosaic constraint of the TPU kernel).
//
// Plain C interface, loaded with ctypes: sw_pass launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

__global__ void sep_warp_pass_kernel(const int32_t* __restrict__ words,
                                     const float* __restrict__ cc, float* __restrict__ img,
                                     int32_t* __restrict__ code, int64_t n, int L) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int64_t row = e / L;
  const float c = cc[e];
  const float hi = static_cast<float>(L - 1);
  const float cimg = fminf(fmaxf(c, 0.f), hi);
  int i0 = static_cast<int>(floorf(cimg));
  i0 = min(max(i0, 0), max(L - 2, 0));
  const float w = __fsub_rn(cimg, static_cast<float>(i0));
  const int32_t g = words[row * L + i0];
  const float v0 = static_cast<float>(((g & 0xFFF) ^ 0x800) - 0x800);
  const float v1 = static_cast<float>((((g >> 12) & 0xFFF) ^ 0x800) - 0x800);
  img[e] = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, w)), __fmul_rn(v1, w));
  // clamp(rint(c) - i0, 0, 1), compared in float so that no cast overflows.
  const bool sel = rintf(c) >= static_cast<float>(i0 + 1);
  const int32_t cd = (g >> (sel ? 26 : 24)) & 0x3;
  const bool valid = c >= -0.5f && c < static_cast<float>(L) - 0.5f;
  code[e] = valid ? cd : 0;
}

}  // namespace

// words: (n / L, L) int32 packed words; cc: (n / L, L) f32 coordinates in
// voxel units of the row; img: f32 and code: int32 of the same shape.
extern "C" int sw_pass(const void* words, const void* cc, void* img, void* code, long long n,
                       int L, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (L < 1 || n % L) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  sep_warp_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<const float*>(cc),
      static_cast<float*>(img), static_cast<int32_t*>(code), n, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
