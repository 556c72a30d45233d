// Depthwise 3x3x3 convolution, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Forward: replaces deep_staple_tpu/ops/conv3d_pallas.py::_fwd_kernel (the
// Pallas TPU stencil, :90-108, launched by _dw_pallas_fwd_impl :149-170) and,
// for the model's one stride-2 depthwise conv (block 6), the shifted-FMA form
// of deep_staple_tpu/ops/conv3d.py:63-70. The backward kernels are described
// at dw3d_grad_x and dw3d_grad_w below.
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
// Plain C interface, loaded with ctypes (at the end of the file).

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

// FLIP reads tap 26 - t where the forward reads tap t: the stride-1 input
// gradient (conv3d_pallas.py:264-269).
template <typename T, int VEC, int STRIDE, bool FLIP>
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
    w_s[t * ctw + c] = w27[static_cast<int64_t>(FLIP ? 26 - t : t) * g.C + c0 + c];
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

// Channel tiles of at most 64 vectors, split evenly, and a near-square
// TY x TX tile of (yo, xo) for the rest of the block's threads.
template <int VEC>
void tile_block(Geometry& g, int& cvt, int& tx, int& ty, int Ho, int Wo) {
  const int cv = g.C / VEC;
  g.n_ct = (cv + 63) / 64;
  cvt = (cv + g.n_ct - 1) / g.n_ct;
  const int sp = kThreads / cvt > 1 ? kThreads / cvt : 1;
  ty = static_cast<int>(std::sqrt(static_cast<double>(sp)));
  ty = ty < 1 ? 1 : (ty > Ho ? Ho : ty);
  tx = sp / ty;
  tx = tx < 1 ? 1 : (tx > Wo ? Wo : tx);
}

template <typename T, int VEC, int STRIDE, bool FLIP>
cudaError_t launch(const void* x, const float* w27, void* y, int B, int D, int H, int W,
                   int C, cudaStream_t stream) {
  Geometry g;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.Do = (D + STRIDE - 1) / STRIDE;
  g.Ho = (H + STRIDE - 1) / STRIDE;
  g.Wo = (W + STRIDE - 1) / STRIDE;
  int cvt, tx, ty;
  tile_block<VEC>(g, cvt, tx, ty, g.Ho, g.Wo);
  g.n_xt = (g.Wo + tx - 1) / tx;
  g.n_yt = (g.Ho + ty - 1) / ty;
  g.n_zt = (g.Do + kZSeg - 1) / kZSeg;
  const int64_t blocks = static_cast<int64_t>(B) * g.n_zt * g.n_yt * g.n_xt * g.n_ct;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 block(cvt, tx, ty);
  const size_t smem = 27 * static_cast<size_t>(cvt) * VEC * sizeof(float);
  dw3d_fwd_kernel<T, VEC, STRIDE, FLIP><<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      static_cast<const T*>(x), w27, static_cast<T*>(y), g);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ backward
//
// Input gradient, stride 2, in the transposed form of the forward: input
// voxel i of an axis receives output o = (i + 1 - d) / 2 through tap d
// wherever i + 1 - d is even and 0 <= o < ceil(n / 2): tap d = 1 at even i,
// taps d = 0 and d = 2 at odd i, so 1 to 8 of the 27 taps per voxel. Nothing
// of the 8x larger dilated cotangent that conv3d.py:83-86 builds exists here.
// A thread owns VEC channels of one (yi, xi) input column and walks kZSeg
// input planes; the cotangent, 1/8 the size of the result, is re-read from
// L1/L2. Bound: the bytes of the result written.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dw3d_gx2_kernel(const T* __restrict__ gy, const float* __restrict__ w27, T* __restrict__ gx,
                Geometry g) {
  extern __shared__ float w_s[];
  const int ctw = blockDim.x * VEC;

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
  const int xi = xt * blockDim.y + threadIdx.y;
  const int yi = yt * blockDim.z + threadIdx.z;
  if (c >= g.C || xi >= g.W || yi >= g.H) return;

  float wr[27][VEC];
#pragma unroll
  for (int t = 0; t < 27; ++t)
#pragma unroll
    for (int k = 0; k < VEC; ++k) wr[t][k] = w_s[t * ctw + threadIdx.x * VEC + k];

  const int64_t soH = static_cast<int64_t>(g.Wo) * g.C;
  const int64_t soD = static_cast<int64_t>(g.Ho) * soH;
  int64_t off[3][3];  // offset of output (yo, xo) of taps (dy, dx); -1: no output
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int vy = yi + 1 - dy;
    const bool yok = (vy & 1) == 0 && vy >= 0 && (vy >> 1) < g.Ho;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int vx = xi + 1 - dx;
      const bool xok = (vx & 1) == 0 && vx >= 0 && (vx >> 1) < g.Wo;
      off[dy][dx] = yok && xok ? (vy >> 1) * soH + static_cast<int64_t>(vx >> 1) * g.C : -1;
    }
  }
  const T* gb = gy + b * g.Do * soD + c;
  const int64_t sD = static_cast<int64_t>(g.H) * g.W * g.C;
  T* out = gx + b * g.D * sD + (static_cast<int64_t>(yi) * g.W + xi) * g.C + c;

  const int z0 = zt * kZSeg;
  const int z1 = min(z0 + kZSeg, g.D);
  for (int zi = z0; zi < z1; ++zi) {
    float acc[VEC] = {};
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int vz = zi + 1 - dz;
      if ((vz & 1) || vz < 0 || (vz >> 1) >= g.Do) continue;
      const T* plane = gb + (vz >> 1) * soD;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int64_t o = off[t / 3][t % 3];
        if (o < 0) continue;
        float v[VEC];
        load(plane + o, v);
        fma_taps(acc, v, wr[dz * 9 + t]);
      }
    }
    store(out + zi * sD, acc);
  }
}

// Weight gradient: gw[t, c] = sum over (b, o) of x[b, s*o + tap t - 1, c] *
// gy[b, o, c], the 27 reductions of conv3d.py:92-105 (replaces
// conv3d_pallas.py::_gw_kernel, :173-202, launched by _dw_pallas_gw_impl
// :205-241). The TPU kernel keeps one (27, ct) block resident across a grid
// that runs in order; here blocks run in parallel, so the sum is taken in
// two passes and never with atomics, whose order would change from run to
// run:
//  1. dw3d_gw_kernel: block (ct, j) covers one channel tile and the output
//     columns (b, yo, xo) = j * nsp + ty + k * gridDim.y * nsp. A thread owns
//     VEC channels of a column and walks it along z with 27 x VEC float32
//     accumulators in registers. At stride 1 it reads each input plane once
//     for its 9 (dy, dx) taps and pairs it with the three cotangent planes it
//     feeds (zo = zi + 1, zi, zi - 1), held in a rolling window. The block's
//     threads are then summed over ty in a fixed order into partial[j].
//  2. dw3d_gw_reduce_kernel: gw = sum over j of partial[j], in order.
// float32 accumulation in both dtypes (conv3d.py:100-104: about 3M bf16
// products per channel would cancel the mantissa in bf16). Bound: the bytes
// of x and gy read.
struct GwGeometry {
  int D, H, W, C;
  int Do, Ho, Wo;
  int64_t cols;  // B * Ho * Wo
};

template <typename T, int VEC, int STRIDE>
__global__ void __launch_bounds__(kThreads)
dw3d_gw_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ partial,
               GwGeometry g) {
  extern __shared__ float red[];  // (blockDim.y, blockDim.x * VEC)
  const int ctw = blockDim.x * VEC;
  const int c = blockIdx.x * ctw + threadIdx.x * VEC;
  const bool active = c < g.C;

  float acc[27][VEC];
#pragma unroll
  for (int t = 0; t < 27; ++t)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[t][k] = 0.f;

  if (active) {
    Taps tp;
    tp.sW = g.C;
    tp.sH = static_cast<int64_t>(g.W) * g.C;
    const int64_t sD = static_cast<int64_t>(g.H) * tp.sH;
    const int64_t soD = static_cast<int64_t>(g.Ho) * g.Wo * g.C;
    const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.y;
    for (int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; col < g.cols;
         col += step) {
      const int xo = static_cast<int>(col % g.Wo);
      const int yo = static_cast<int>((col / g.Wo) % g.Ho);
      const int64_t b = col / (static_cast<int64_t>(g.Wo) * g.Ho);
      const int yi = yo * STRIDE - 1, xi = xo * STRIDE - 1;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        tp.yok[d] = yi + d >= 0 && yi + d < g.H;
        tp.xok[d] = xi + d >= 0 && xi + d < g.W;
      }
      const int64_t base = b * g.D * sD + yi * tp.sH + xi * tp.sW + c;
      const T* gcol = gy + b * g.Do * soD + (static_cast<int64_t>(yo) * g.Wo + xo) * g.C + c;
      if constexpr (STRIDE == 1) {
        float gp[VEC] = {}, gc[VEC], gn[VEC] = {};
        load(gcol, gc);
        if (g.D > 1) load(gcol + soD, gn);
        for (int zi = 0; zi < g.D; ++zi) {
          const int64_t plane = base + zi * sD;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            float v[VEC];
            if (load_tap(x, plane, t, tp, v)) {
              fma_taps(acc[t], v, gn);       // dz = 0 feeds output zi + 1
              fma_taps(acc[9 + t], v, gc);   // dz = 1 feeds output zi
              fma_taps(acc[18 + t], v, gp);  // dz = 2 feeds output zi - 1
            }
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            gp[k] = gc[k];
            gc[k] = gn[k];
            gn[k] = 0.f;
          }
          if (zi + 2 < g.D) load(gcol + (zi + 2) * soD, gn);
        }
      } else {
        for (int zo = 0; zo < g.Do; ++zo) {
          float gv[VEC];
          load(gcol + zo * soD, gv);
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const int zi = 2 * zo + dz - 1;
            if (zi < 0 || zi >= g.D) continue;
            const int64_t plane = base + zi * sD;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              float v[VEC];
              if (load_tap(x, plane, t, tp, v)) fma_taps(acc[dz * 9 + t], v, gv);
            }
          }
        }
      }
    }
  }

  const int slot = threadIdx.y * ctw + threadIdx.x * VEC;
#pragma unroll
  for (int t = 0; t < 27; ++t) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[slot + k] = acc[t][k];
    __syncthreads();
    if (threadIdx.y == 0 && active) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float s = 0.f;
        for (int j = 0; j < static_cast<int>(blockDim.y); ++j) s += red[j * ctw + threadIdx.x * VEC + k];
        partial[(static_cast<int64_t>(blockIdx.y) * 27 + t) * g.C + c + k] = s;
      }
    }
    __syncthreads();
  }
}

__global__ void dw3d_gw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ gw,
                                      int n_part, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < n_part; ++j) s += partial[static_cast<int64_t>(j) * n + i];
  gw[i] = s;
}

template <typename T, int VEC>
cudaError_t launch_gx2(const void* gy, const float* w27, void* gx, int B, int D, int H, int W,
                       int C, cudaStream_t stream) {
  Geometry g;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.Do = (D + 1) / 2;
  g.Ho = (H + 1) / 2;
  g.Wo = (W + 1) / 2;
  int cvt, tx, ty;
  tile_block<VEC>(g, cvt, tx, ty, H, W);
  g.n_xt = (W + tx - 1) / tx;
  g.n_yt = (H + ty - 1) / ty;
  g.n_zt = (D + kZSeg - 1) / kZSeg;
  const int64_t blocks = static_cast<int64_t>(B) * g.n_zt * g.n_yt * g.n_xt * g.n_ct;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 block(cvt, tx, ty);
  const size_t smem = 27 * static_cast<size_t>(cvt) * VEC * sizeof(float);
  dw3d_gx2_kernel<T, VEC><<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      static_cast<const T*>(gy), w27, static_cast<T*>(gx), g);
  return cudaGetLastError();
}

template <typename T, int VEC, int STRIDE>
cudaError_t launch_gw(const void* x, const void* gy, float* partial, float* gw, int n_part,
                      int B, int D, int H, int W, int C, cudaStream_t stream) {
  Geometry tg;
  tg.C = C;
  int cvt, tx, ty;
  tile_block<VEC>(tg, cvt, tx, ty, 1, 1);
  const int nsp = kThreads / cvt > 1 ? kThreads / cvt : 1;
  GwGeometry g;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.Do = (D + STRIDE - 1) / STRIDE;
  g.Ho = (H + STRIDE - 1) / STRIDE;
  g.Wo = (W + STRIDE - 1) / STRIDE;
  g.cols = static_cast<int64_t>(B) * g.Ho * g.Wo;
  if (n_part < 1 || n_part > 65535) return cudaErrorInvalidValue;
  const dim3 grid(tg.n_ct, n_part);
  const dim3 block(cvt, nsp);
  const size_t smem = static_cast<size_t>(nsp) * cvt * VEC * sizeof(float);
  dw3d_gw_kernel<T, VEC, STRIDE><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), partial, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 27 * C;
  dw3d_gw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, gw, n_part, n);
  return cudaGetLastError();
}

template <typename T_, int VEC_>
struct TypeVec {
  using T = T_;
  static constexpr int VEC = VEC_;
};

// Calls f(TypeVec<T, VEC>{}): 4 x f32 or 2 x bf16 where C and the pointers'
// alignment allow them (every shape of the model), else one channel a thread.
template <typename F>
cudaError_t by_type(int is_bf16, int C, uintptr_t align, F&& f) {
  if (is_bf16) {
    if (C % 2 == 0 && align % 4 == 0) return f(TypeVec<__nv_bfloat16, 2>{});
    return f(TypeVec<__nv_bfloat16, 1>{});
  }
  if (C % 4 == 0 && align % 16 == 0) return f(TypeVec<float, 4>{});
  return f(TypeVec<float, 1>{});
}

uintptr_t alignment(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of its launches.
// Activations are contiguous NDHWC, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// weights and weight gradients are contiguous f32 (27, C), tap dz*9+dy*3+dx.

// x: (B, D, H, W, C); y: (B, ceil(D/s), ceil(H/s), ceil(W/s), C).
extern "C" int dw3d_fwd(const void* x, const void* w27, void* y, int is_bf16, int stride,
                        int B, int D, int H, int W, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w27);
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  return static_cast<int>(by_type(is_bf16, C, alignment(x, y), [&](auto tv) {
    using TV = decltype(tv);
    if (stride == 1) return launch<typename TV::T, TV::VEC, 1, false>(x, w, y, B, D, H, W, C, s);
    if (stride == 2) return launch<typename TV::T, TV::VEC, 2, false>(x, w, y, B, D, H, W, C, s);
    return cudaErrorInvalidValue;
  }));
}

// The input gradient of dw3d_fwd. gy: the cotangent of y; gx: (B, D, H, W,
// C), the forward input's shape. Stride 1 is the forward kernel with the
// taps reversed; stride 2 is dw3d_gx2_kernel.
extern "C" int dw3d_grad_x(const void* gy, const void* w27, void* gx, int is_bf16, int stride,
                           int B, int D, int H, int W, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w27);
  (void)cudaGetLastError();
  return static_cast<int>(by_type(is_bf16, C, alignment(gy, gx), [&](auto tv) {
    using TV = decltype(tv);
    if (stride == 1) return launch<typename TV::T, TV::VEC, 1, true>(gy, w, gx, B, D, H, W, C, s);
    if (stride == 2) return launch_gx2<typename TV::T, TV::VEC>(gy, w, gx, B, D, H, W, C, s);
    return cudaErrorInvalidValue;
  }));
}

// The weight gradient of dw3d_fwd into gw (27, C) f32. x: the forward input
// (B, D, H, W, C); gy: the cotangent of y. partial: f32 scratch of
// n_part * 27 * C floats (1 <= n_part <= 65535), overwritten.
extern "C" int dw3d_grad_w(const void* x, const void* gy, void* partial, void* gw, int n_part,
                           int is_bf16, int stride, int B, int D, int H, int W, int C,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* out = static_cast<float*>(gw);
  (void)cudaGetLastError();
  return static_cast<int>(by_type(is_bf16, C, alignment(x, gy), [&](auto tv) {
    using TV = decltype(tv);
    if (stride == 1)
      return launch_gw<typename TV::T, TV::VEC, 1>(x, gy, p, out, n_part, B, D, H, W, C, s);
    if (stride == 2)
      return launch_gw<typename TV::T, TV::VEC, 2>(x, gy, p, out, n_part, B, D, H, W, C, s);
    return cudaErrorInvalidValue;
  }));
}

extern "C" const char* dw3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
