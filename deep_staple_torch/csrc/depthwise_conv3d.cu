// Depthwise 3x3x3 convolution, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces deep_staple_tpu/ops/conv3d_pallas.py::_fwd_kernel (the Pallas TPU
// stencil, :90-108, launched by _dw_pallas_fwd_impl :149-170) and, for the
// model's one stride-2 depthwise conv (block 6), the shifted-FMA form of
// deep_staple_tpu/ops/conv3d.py:63-70.
//
//   y[b, zo, yo, xo, c] = sum_{dz,dy,dx} w[dz*9 + dy*3 + dx, c]
//                         * x[b, s*zo + dz - 1, s*yo + dy - 1, s*xo + dx - 1, c]
//
// NDHWC layout, zero padding of 1 at every border, stride s in {1, 2}, output
// extent ceil(n / s) per axis, f32 weights (27, C), the 27 taps accumulated in
// f32 in the order of the tap index, output in the input dtype (f32 or bf16).
//
// What bounds it: bytes. An output element costs 27 FMAs (54 flop) against
// one input element read and one output element written, 54 / 8 = 6.75
// flop/byte in f32 and 13.5 in bf16. The H100's ridge for f32 outside the
// tensor cores is 67 TFLOP/s over 3.35 TB/s = 20 flop/byte, so the least time
// is the bytes of x and y over the memory rate.
//
// What the design does about it: every input element should come from device
// memory about once, and the arithmetic must not stall the loads.
//  * A thread owns VEC adjacent channels (4 x f32 = 16 B, or 2 x bf16) of one
//    (yo, xo) output column and walks a segment of kZSeg output planes along
//    z. It reads each input plane once, for its 9 (dy, dx) taps, and adds the
//    plane into the rolling accumulators of every output that plane feeds:
//    three for stride 1 (taps dz = 0, 1, 2 of outputs z+1, z, z-1), two for
//    stride 2. The three-fold reuse along z costs no loads.
//  * The (dy, dx) reuse comes from L1: a block covers a TY x TX tile of
//    (yo, xo) for one channel tile, so its threads load overlapping lines;
//    adjacent threads run along C, so a warp's loads are contiguous.
//  * The channel tile's (27, ct) weights are staged in shared memory, then
//    held in registers for the whole z segment.
// Not done yet: TMA or cp.async staging of a shared-memory halo ring, which
// would make the (dy, dx) reuse explicit instead of leaving it to L1 and L2.
//
// Plain C interface, loaded with ctypes: dw3d_fwd launches on the given
// stream, does not synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // target threads per block
constexpr int kZSeg = 16;      // output planes a thread walks along z

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}

struct Geometry {
  int D, H, W, C;      // input extents
  int Do, Ho, Wo;      // output extents
  int n_ct, n_xt, n_yt, n_zt;  // tiles along C, W, H, and z segments
};

// Where the 9 (dy, dx) taps of one thread lie inside an input plane.
struct Taps {
  int64_t sH, sW;
  bool yok[3], xok[3];  // false: the tap falls in the zero padding
};

// Loads tap t = dy*3 + dx of the plane starting at offset `plane`; false
// (and no load) where the tap lies in the zero padding.
template <typename T, int VEC>
__device__ __forceinline__ bool load_tap(const T* __restrict__ x, int64_t plane, int t,
                                         const Taps& tp, float (&v)[VEC]) {
  const int dy = t / 3, dx = t % 3;
  if (!(tp.yok[dy] && tp.xok[dx])) return false;
  load(x + (plane + dy * tp.sH + dx * tp.sW), v);
  return true;
}

template <int VEC>
__device__ __forceinline__ void fma_taps(float (&acc)[VEC], const float (&v)[VEC],
                                         const float (&w)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = fmaf(v[k], w[k], acc[k]);
}

template <typename T, int VEC, int STRIDE>
__global__ void __launch_bounds__(kThreads)
dw3d_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w27, T* __restrict__ y,
                Geometry g) {
  extern __shared__ float w_s[];  // (27, blockDim.x * VEC)
  const int ctw = blockDim.x * VEC;  // channels in a full channel tile

  int64_t bid = blockIdx.x;
  const int ct = static_cast<int>(bid % g.n_ct); bid /= g.n_ct;
  const int xt = static_cast<int>(bid % g.n_xt); bid /= g.n_xt;
  const int yt = static_cast<int>(bid % g.n_yt); bid /= g.n_yt;
  const int zt = static_cast<int>(bid % g.n_zt); bid /= g.n_zt;
  const int64_t b = bid;

  const int c0 = ct * ctw;
  const int nc = min(ctw, g.C - c0);
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const int nthr = blockDim.x * blockDim.y * blockDim.z;
  for (int i = tid; i < 27 * nc; i += nthr) {
    const int t = i / nc, c = i - t * nc;
    w_s[t * ctw + c] = w27[static_cast<int64_t>(t) * g.C + c0 + c];
  }
  __syncthreads();

  const int c = c0 + threadIdx.x * VEC;
  const int xo = xt * blockDim.y + threadIdx.y;
  const int yo = yt * blockDim.z + threadIdx.z;
  if (c >= g.C || xo >= g.Wo || yo >= g.Ho) return;

  float wr[27][VEC];
#pragma unroll
  for (int t = 0; t < 27; ++t)
#pragma unroll
    for (int k = 0; k < VEC; ++k) wr[t][k] = w_s[t * ctw + threadIdx.x * VEC + k];

  Taps tp;
  tp.sW = g.C;
  tp.sH = static_cast<int64_t>(g.W) * g.C;
  const int64_t sD = static_cast<int64_t>(g.H) * tp.sH;
  const int yi = yo * STRIDE - 1, xi = xo * STRIDE - 1;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    tp.yok[d] = yi + d >= 0 && yi + d < g.H;
    tp.xok[d] = xi + d >= 0 && xi + d < g.W;
  }
  // Offset of tap (dy, dx) = (0, 0) in plane 0 of batch b; may be negative,
  // but only offsets of taps inside the volume are ever dereferenced.
  const int64_t base = b * g.D * sD + yi * tp.sH + xi * tp.sW + c;
  const int64_t soD = static_cast<int64_t>(g.Ho) * g.Wo * g.C;
  T* yb = y + b * g.Do * soD + (static_cast<int64_t>(yo) * g.Wo + xo) * g.C + c;

  const int zo0 = zt * kZSeg;
  const int zo1 = min(zo0 + kZSeg, g.Do);

  if constexpr (STRIDE == 1) {
    // At input plane zi: a0 is output zi-1 (its taps dz=2), a1 is output zi
    // (dz=1), a2 is output zi+1 (dz=0). Output zi-1 is then complete.
    float a0[VEC] = {}, a1[VEC] = {}, a2[VEC] = {};
    for (int zi = zo0 - 1; zi <= zo1; ++zi) {
      if (zi >= 0 && zi < g.D) {
        const int64_t plane = base + zi * sD;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float v[VEC];
          if (load_tap(x, plane, t, tp, v)) {
            fma_taps(a2, v, wr[t]);
            fma_taps(a1, v, wr[9 + t]);
            fma_taps(a0, v, wr[18 + t]);
          }
        }
      }
      if (zi - 1 >= zo0) store(yb + (zi - 1) * soD, a0);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        a0[k] = a1[k];
        a1[k] = a2[k];
        a2[k] = 0.f;
      }
    }
  } else {
    // Output zo reads planes 2zo-1 (dz=0), 2zo (dz=1), 2zo+1 (dz=2); plane
    // 2zo+1 is also dz=0 of output zo+1, carried over in `carry`.
    float carry[VEC] = {};
    const int zfirst = 2 * zo0 - 1;
    if (zfirst >= 0) {
      const int64_t plane = base + zfirst * sD;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        float v[VEC];
        if (load_tap(x, plane, t, tp, v)) fma_taps(carry, v, wr[t]);
      }
    }
    for (int zo = zo0; zo < zo1; ++zo) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc[k] = carry[k];
        carry[k] = 0.f;
      }
      const int64_t mid = base + (2 * zo) * sD;  // 2zo < D since zo < ceil(D/2)
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        float v[VEC];
        if (load_tap(x, mid, t, tp, v)) fma_taps(acc, v, wr[9 + t]);
      }
      if (2 * zo + 1 < g.D) {
        const int64_t hi = mid + sD;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          float v[VEC];
          if (load_tap(x, hi, t, tp, v)) {
            fma_taps(acc, v, wr[18 + t]);
            fma_taps(carry, v, wr[t]);
          }
        }
      }
      store(yb + zo * soD, acc);
    }
  }
}

template <typename T, int VEC, int STRIDE>
cudaError_t launch(const void* x, const float* w27, void* y, int B, int D, int H, int W,
                   int C, cudaStream_t stream) {
  Geometry g;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.Do = (D + STRIDE - 1) / STRIDE;
  g.Ho = (H + STRIDE - 1) / STRIDE;
  g.Wo = (W + STRIDE - 1) / STRIDE;
  // Channel tiles of at most 64 vectors, split evenly.
  const int cv = C / VEC;
  g.n_ct = (cv + 63) / 64;
  const int cvt = (cv + g.n_ct - 1) / g.n_ct;
  // The rest of the block covers a near-square TY x TX tile of (yo, xo).
  const int sp = kThreads / cvt > 1 ? kThreads / cvt : 1;
  int ty = static_cast<int>(std::sqrt(static_cast<double>(sp)));
  ty = ty < 1 ? 1 : (ty > g.Ho ? g.Ho : ty);
  int tx = sp / ty;
  tx = tx < 1 ? 1 : (tx > g.Wo ? g.Wo : tx);
  g.n_xt = (g.Wo + tx - 1) / tx;
  g.n_yt = (g.Ho + ty - 1) / ty;
  g.n_zt = (g.Do + kZSeg - 1) / kZSeg;
  const int64_t blocks = static_cast<int64_t>(B) * g.n_zt * g.n_yt * g.n_xt * g.n_ct;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 block(cvt, tx, ty);
  const size_t smem = 27 * static_cast<size_t>(cvt) * VEC * sizeof(float);
  dw3d_fwd_kernel<T, VEC, STRIDE><<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      static_cast<const T*>(x), w27, static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_stride(const void* x, const float* w27, void* y, int stride, int B, int D,
                          int H, int W, int C, cudaStream_t stream) {
  if (stride == 1) return launch<T, VEC, 1>(x, w27, y, B, D, H, W, C, stream);
  if (stride == 2) return launch<T, VEC, 2>(x, w27, y, B, D, H, W, C, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, D, H, W, C) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// w27: (27, C) f32 contiguous; y: (B, ceil(D/s), ceil(H/s), ceil(W/s), C) in
// x's dtype. Vectors of 4 x f32 or 2 x bf16 where C and the pointers allow
// them (every shape of the model), else one channel per thread.
extern "C" int dw3d_fwd(const void* x, const void* w27, void* y, int is_bf16, int stride,
                        int B, int D, int H, int W, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w27);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  cudaError_t err;
  if (is_bf16) {
    if (C % 2 == 0 && align % 4 == 0)
      err = launch_stride<__nv_bfloat16, 2>(x, w, y, stride, B, D, H, W, C, s);
    else
      err = launch_stride<__nv_bfloat16, 1>(x, w, y, stride, B, D, H, W, C, s);
  } else {
    if (C % 4 == 0 && align % 16 == 0)
      err = launch_stride<float, 4>(x, w, y, stride, B, D, H, W, C, s);
    else
      err = launch_stride<float, 1>(x, w, y, stride, B, D, H, W, C, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* dw3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
