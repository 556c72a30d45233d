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
// What the design does about it (dw3d_fwd_kernel): every input byte comes
// from device memory about once, enough bytes are in flight, and the FMAs
// run while the next planes load.
//  * A block owns a channel tile of 64 bytes a voxel (16 f32 or 32 bf16
//    channels), a TY x TX tile of (yo, xo) and a segment of at most kZSeg
//    output planes, which it walks along z. Each input plane's slab of
//    ((TY-1)s+3) x (TX s+2) voxels x 64 bytes is copied into a ring of
//    kStages slabs in shared memory with cp.async (16-byte copies; src-size
//    0 writes the zero padding, so the FMA loop has no branch). The copies
//    of the next kStages-1 planes are in flight while a plane is summed; one
//    barrier a plane.
//  * A thread owns 4 bytes of channels (1 f32 or 2 bf16) x NX adjacent
//    outputs along x (8 f32, 4 bf16). For each (dy) row of a plane it reads
//    NX+2 (stride 1) or 2 NX+1 (stride 2) values from shared memory once
//    and uses each for up to 3 dx taps, into the rolling z accumulators:
//    three (outputs zi+1, zi, zi-1) at stride 1, two at stride 2. Its 27
//    weights stay in registers; 108-128 registers a thread, no spills.
//  * Shared memory is read without bank conflicts: 16 lanes of 4 bytes
//    read one voxel, and the two voxels of a warp's read lie one output row
//    apart; the slab's voxel slots are swizzled (x ^ row bit) so that those
//    two fall into different halves of the banks.
// Channel counts whose voxel is not a multiple of 16 bytes, or unaligned
// tensors, take the same kernel with element copies and scalar stores.
//
// What it reached (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's times
// phase): 12.8 ms per f32 serving forward against a 7.29 ms bound, 12.1 ms
// in bf16 against 3.65 (the previous design: 62 / 42 ms). The tile sizes
// (TY x TX = 8 x 16 at stride 1, 8 x 8 at stride 2, TY = 4 in bf16, 4 / 3
// stages) came from an A/B of variants (taller or shorter tiles, 3 to 6
// stages, 2 f32 channels or 4 outputs a thread): each was slower or within
// 3%. f32 and bf16 take about the same time, so what bounds it now is not
// the bytes (f32 moves 57% of the HBM rate) but the SM's instruction rate:
// the FMAs, the shared-memory loads and the copies' index arithmetic, at 16
// warps an SM.
//
// Plain C interface, loaded with ctypes (at the end of the file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // target threads per block of dw3d_gx2_kernel
constexpr int kZSeg = 16;      // most planes a forward or dw3d_gx2_kernel block walks along z

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

template <int VEC>
__device__ __forceinline__ void fma_taps(float (&acc)[VEC], const float (&v)[VEC],
                                         const float (&w)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = fmaf(v[k], w[k], acc[k]);
}

// ------------------------------------------------------------------ forward

// 16-byte asynchronous copy into shared memory; n = 0 writes 16 zero bytes
// and reads nothing (the address must still be a valid one).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The forward's tiling: TY x TX outputs of (yo, xo) a block, NX along x a
// thread, a voxel of CT channels = 64 bytes read by 16 lanes of 4 bytes,
// kStages slabs in the ring.
template <typename T, int STRIDE>
struct FwdTile {
  static constexpr int VEC = 4 / sizeof(T);          // channels a thread
  static constexpr int CT = 64 / sizeof(T);          // channels a block
  static constexpr int CL = CT / VEC;                // lanes along C
  static constexpr int TY = sizeof(T) == 4 ? 8 : 4;
  static constexpr int TX = STRIDE == 1 ? 16 : 8;
  static constexpr int NX = sizeof(T) == 4 ? 8 : 4;  // outputs a thread along x
  static constexpr int kStages = STRIDE == 1 ? 4 : 3;
  static constexpr int THREADS = CL * TY * (TX / NX);
  static constexpr int ROWS = (TY - 1) * STRIDE + 3;  // input rows of a slab
  static constexpr int RS = TX * STRIDE + 2;          // voxel slots a slab row (even)
  static constexpr int SLAB = ROWS * RS * CT;         // elements of a slab
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // at most 128 registers a thread
  static_assert(NX % 2 == 0 && RS % 2 == 0, "the swizzle pairs voxel slots 2k, 2k+1");
};

struct TileGeometry {
  int D, H, W, C;              // input extents
  int Do, Ho, Wo;              // output extents
  int n_ct, n_xt, n_yt, n_zt;  // tiles along C, W, H, and z segments
  int zseg;                    // output planes a z segment
};

// Slot of voxel x of slab row r: pairs (2k, 2k+1) swap on bit STRIDE-1 of r,
// so that rows r and r + STRIDE (one output row apart) use opposite halves
// of the banks.
template <int STRIDE>
__device__ __forceinline__ int slot_flip(int r) {
  return (r >> (STRIDE - 1)) & 1;
}

// Copies the ROWS x RS voxels from (y0, x0) of plane z of the (B, D, H, W, C)
// tensor src, CT channels from c0, into `slab`, by THREADS threads. VECIO:
// 16-byte cp.async copies (C * sizeof(T) a multiple of 16 and src 16-byte
// aligned); else one element a copy, through registers. Voxels outside the
// tensor and channels past C are written as zeros. Slab row r holds its
// voxel slots swizzled by slot_flip<FLIP>(r).
// ROLLED keeps the loop rolled, so that the compiler does not hold every
// copy's address across the caller's loop.
template <typename T, int ROWS, int RS, int CT, int THREADS, int FLIP, bool VECIO,
          bool ROLLED = false>
__device__ __forceinline__ void copy_slab(const T* __restrict__ src, T* slab, int D, int H, int W,
                                          int C, int64_t b, int z, int y0, int x0, int c0,
                                          int tid) {
  constexpr int EPC = VECIO ? 16 / sizeof(T) : 1;  // elements a copy
  constexpr int QV = CT / EPC;                     // copies a voxel
  constexpr int N = ROWS * RS * QV;
  const int64_t plane = (b * D + z) * static_cast<int64_t>(H);
  auto copy = [&](int i) {
    const int q = i % QV;
    const int v = i / QV;
    const int xs = v % RS, r = v / RS;
    const int yi = y0 + r, xi = x0 + xs, c = c0 + q * EPC;
    const bool ok = yi >= 0 && yi < H && xi >= 0 && xi < W && c < C;
    const int64_t off = ok ? ((plane + yi) * W + xi) * C + c : 0;
    T* dst = slab + (r * RS + (xs ^ slot_flip<FLIP>(r))) * CT + q * EPC;
    if constexpr (VECIO) {
      cp_async16(dst, src + off, ok ? 16 : 0);
    } else {
      using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
      *reinterpret_cast<Bits*>(dst) = ok ? reinterpret_cast<const Bits*>(src)[off] : Bits(0);
    }
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = tid; i < N; i += THREADS) copy(i);
  } else {
    for (int i = tid; i < N; i += THREADS) copy(i);
  }
}

// Stores one output voxel's VEC channels: a vector store where C allows it,
// else each channel below C.
template <typename T, int VEC, bool VECIO>
__device__ __forceinline__ void store_out(T* p, const float (&v)[VEC], int c, int C) {
  if constexpr (VECIO) {
    store(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (c + k < C) {
        const float e[1] = {v[k]};
        store(p + k, e);
      }
    }
  }
}

// FLIP reads tap 26 - t where the forward reads tap t: the stride-1 input
// gradient (conv3d_pallas.py:264-269).
template <typename T, int STRIDE, bool FLIP, bool VECIO>
__global__ void __launch_bounds__(FwdTile<T, STRIDE>::THREADS, FwdTile<T, STRIDE>::MIN_BLOCKS)
dw3d_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w27, T* __restrict__ y,
                TileGeometry g) {
  using F = FwdTile<T, STRIDE>;
  constexpr int VEC = F::VEC, NX = F::NX;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* ring = reinterpret_cast<T*>(fwd_smem);                           // kStages slabs
  float* w_s = reinterpret_cast<float*>(ring + F::kStages * F::SLAB);  // (27, CT)

  int64_t bid = blockIdx.x;
  const int ct = static_cast<int>(bid % g.n_ct); bid /= g.n_ct;
  const int xt = static_cast<int>(bid % g.n_xt); bid /= g.n_xt;
  const int yt = static_cast<int>(bid % g.n_yt); bid /= g.n_yt;
  const int zt = static_cast<int>(bid % g.n_zt); bid /= g.n_zt;
  const int64_t b = bid;

  const int tid = threadIdx.x;
  const int cl = tid % F::CL;               // lane along C
  const int ty = (tid / F::CL) % F::TY;     // output row in the tile
  const int xg = tid / (F::CL * F::TY);     // group of NX outputs along x
  const int c0 = ct * F::CT;
  const int c = c0 + cl * VEC;
  const int yo = yt * F::TY + ty;
  const int xo0 = xt * F::TX + xg * NX;
  const int yi0 = yt * F::TY * STRIDE - 1, xi0 = xt * F::TX * STRIDE - 1;
  const int zo0 = zt * g.zseg;
  const int zo1 = min(zo0 + g.zseg, g.Do);
  // Input planes zi0, zi0 + 1, ... feed outputs zo0 .. zo1 - 1.
  const int zi0 = zo0 * STRIDE - 1;
  const int np = STRIDE == 1 ? zo1 - zo0 + 2 : 2 * (zo1 - zo0) + 1;

  auto fetch = [&](int i) {  // plane i of the walk into its ring slot, one group
    const int zi = zi0 + i;
    if (i < np && zi >= 0 && zi < g.D)
      copy_slab<T, F::ROWS, F::RS, F::CT, F::THREADS, STRIDE, VECIO>(
          x, ring + (i % F::kStages) * F::SLAB, g.D, g.H, g.W, g.C, b, zi, yi0, xi0, c0, tid);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < F::kStages - 1; ++i) fetch(i);

  for (int i = tid; i < 27 * F::CT; i += F::THREADS) {
    const int t = i / F::CT, cc = c0 + i % F::CT;
    w_s[i] = cc < g.C ? w27[static_cast<int64_t>(FLIP ? 26 - t : t) * g.C + cc] : 0.f;
  }
  __syncthreads();
  float wr[27][VEC];
#pragma unroll
  for (int t = 0; t < 27; ++t)
#pragma unroll
    for (int k = 0; k < VEC; ++k) wr[t][k] = w_s[t * F::CT + cl * VEC + k];

  const bool active = c < g.C && yo < g.Ho;
  const int64_t soD = static_cast<int64_t>(g.Ho) * g.Wo * g.C;
  T* yb = y + b * g.Do * soD + (static_cast<int64_t>(yo) * g.Wo + xo0) * g.C + c;
  auto store_plane = [&](int zo, const float (&a)[NX][VEC]) {
    if (!active) return;
#pragma unroll
    for (int k = 0; k < NX; ++k)
      if (xo0 + k < g.Wo) store_out<T, VEC, VECIO>(yb + zo * soD + k * g.C, a[k], c, g.C);
  };

  // Stride 1: at input plane zi, a0 is output zi-1 (its taps dz=2), a1 is
  // output zi (dz=1), a2 output zi+1 (dz=0); output zi-1 is then complete.
  // Stride 2: plane 2zo is dz=1 of output zo (acc); plane 2zo+1 is dz=2 of
  // zo, after which zo is complete, and dz=0 of zo+1 (carry).
  float a0[NX][VEC] = {}, a1[NX][VEC] = {}, a2[NX][VEC] = {};
  for (int i = 0; i < np; ++i) {
    cp_async_wait<F::kStages - 2>();
    __syncthreads();  // plane i has landed, and every thread is done with plane i-1
    fetch(i + F::kStages - 1);
    const int zi = zi0 + i;
    const T* slab = ring + (i % F::kStages) * F::SLAB + cl * VEC;
    if (zi >= 0 && zi < g.D) {
      if constexpr (STRIDE == 1) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = ty + dy;
          const int f = slot_flip<1>(r);
          const T* row = slab + (r * F::RS + xg * NX) * F::CT;
          float v[NX + 2][VEC];
#pragma unroll
          for (int j = 0; j < NX + 2; ++j) load(row + (j + ((j & 1) ? -f : f)) * F::CT, v[j]);
#pragma unroll
          for (int k = 0; k < NX; ++k)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int t = dy * 3 + dx;
              fma_taps(a2[k], v[k + dx], wr[t]);
              fma_taps(a1[k], v[k + dx], wr[9 + t]);
              fma_taps(a0[k], v[k + dx], wr[18 + t]);
            }
        }
      } else {
        const bool mid_plane = (i & 1) != 0;  // zi = 2zo: dz=1 of zo
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = 2 * ty + dy;
          const int f = slot_flip<2>(r);
          const T* row = slab + (r * F::RS + 2 * xg * NX) * F::CT;
          float v[2 * NX + 1][VEC];
#pragma unroll
          for (int j = 0; j < 2 * NX + 1; ++j) load(row + (j + ((j & 1) ? -f : f)) * F::CT, v[j]);
          if (mid_plane) {
#pragma unroll
            for (int k = 0; k < NX; ++k)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) fma_taps(a1[k], v[2 * k + dx], wr[9 + dy * 3 + dx]);
          } else {
#pragma unroll
            for (int k = 0; k < NX; ++k)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const int t = dy * 3 + dx;
                fma_taps(a1[k], v[2 * k + dx], wr[18 + t]);
                fma_taps(a2[k], v[2 * k + dx], wr[t]);
              }
          }
        }
      }
    }
    if constexpr (STRIDE == 1) {
      if (i >= 2) store_plane(zi - 1, a0);
#pragma unroll
      for (int k = 0; k < NX; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          a0[k][e] = a1[k][e];
          a1[k][e] = a2[k][e];
          a2[k][e] = 0.f;
        }
    } else if ((i & 1) == 0) {
      if (i > 0) store_plane(zo0 - 1 + i / 2, a1);
#pragma unroll
      for (int k = 0; k < NX; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          a1[k][e] = a2[k][e];
          a2[k][e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T, int STRIDE, bool FLIP, bool VECIO>
cudaError_t launch_fwd(const void* x, const float* w27, void* y, int B, int D, int H, int W,
                       int C, cudaStream_t stream) {
  using F = FwdTile<T, STRIDE>;
  TileGeometry g;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.Do = (D + STRIDE - 1) / STRIDE;
  g.Ho = (H + STRIDE - 1) / STRIDE;
  g.Wo = (W + STRIDE - 1) / STRIDE;
  g.n_ct = (C + F::CT - 1) / F::CT;
  g.n_xt = (g.Wo + F::TX - 1) / F::TX;
  g.n_yt = (g.Ho + F::TY - 1) / F::TY;
  g.n_zt = (g.Do + kZSeg - 1) / kZSeg;
  g.zseg = g.n_zt > 0 ? (g.Do + g.n_zt - 1) / g.n_zt : 1;  // even segments
  const int64_t blocks = static_cast<int64_t>(B) * g.n_zt * g.n_yt * g.n_xt * g.n_ct;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = F::kStages * F::SLAB * sizeof(T) + 27 * F::CT * sizeof(float);
  auto kernel = dw3d_fwd_kernel<T, STRIDE, FLIP, VECIO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), F::THREADS, smem, stream>>>(
      static_cast<const T*>(x), w27, static_cast<T*>(y), g);
  return cudaGetLastError();
}

// x, y 16-byte aligned with a whole number of 16-byte pieces a voxel: the
// 16-byte copies and vector stores; else element copies.
template <typename T>
bool use_vecio(const void* x, const void* y, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  return a % 16 == 0 && (static_cast<size_t>(C) * sizeof(T)) % 16 == 0;
}

template <typename T, int STRIDE, bool FLIP>
cudaError_t launch_fwd_io(const void* x, const float* w27, void* y, int B, int D, int H, int W,
                          int C, cudaStream_t stream) {
  if (use_vecio<T>(x, y, C))
    return launch_fwd<T, STRIDE, FLIP, true>(x, w27, y, B, D, H, W, C, stream);
  return launch_fwd<T, STRIDE, FLIP, false>(x, w27, y, B, D, H, W, C, stream);
}

// ------------------------------------------------------------------ backward

struct Geometry {
  int D, H, W, C;      // input extents
  int Do, Ho, Wo;      // output extents
  int n_ct, n_xt, n_yt, n_zt;  // tiles along C, W, H, and z segments
};

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

// Weight gradient: gw[t, c] = sum over (b, zo, yo, xo) of
// x[b, s*zo + dz - 1, s*yo + dy - 1, s*xo + dx - 1, c] * gy[b, zo, yo, xo, c],
// t = dz*9 + dy*3 + dx, the 27 reductions of conv3d.py:92-105 (replaces
// conv3d_pallas.py::_gw_kernel, :173-202, launched by _dw_pallas_gw_impl
// :205-241). float32 accumulation in both dtypes (conv3d.py:100-104: about
// 3M bf16 products per channel would cancel the mantissa in bf16).
//
// What bounds it: bytes. An output voxel of gy costs 27 FMAs against one
// voxel of x and one of gy read, 6.75 flop/byte in f32 (13.5 in bf16), under
// the 20 flop/byte ridge; the tensor cores offer nothing, as each channel is
// its own 27-long dot product. The least time is x and gy read once.
//
// What the design does about it (dw3d_gw_kernel, the forward's staging):
//  * A block owns a 64-byte channel tile (16 f32 or 32 bf16 channels), a
//    TY x TX tile of (yo, xo) and a segment of at most kGwZSeg output
//    planes, and walks the input planes that feed them along z. Each step
//    copies an input plane's slab of ((TY-1)s+3) x (TX s+2) voxels and the
//    TY x TX cotangent voxels of the output plane that enters there into
//    one stage of a kStages ring in shared memory (16-byte cp.async, src-size
//    0 for the zero padding, swizzled voxel slots as in the forward); the
//    next kStages-1 steps' copies are in flight while one is summed.
//  * A thread owns 4 bytes of channels (1 f32 or 2 bf16) x NX = 4 adjacent
//    outputs along x and keeps the cotangent rows of the outputs that the
//    current input plane feeds in registers: at stride 1 three rows (zi+1,
//    zi, zi-1 through dz = 0, 1, 2), loading one new row a plane; at stride
//    2 two. For each dy it reads NX+2 (stride 1) or 2 NX+1 (stride 2)
//    values of x once and uses each for up to 3 dx taps into every dz; 27
//    float32 accumulators a channel, in registers (54 a thread in bf16,
//    whose copy loops stay rolled so that nothing spills).
//  * The sum has a fixed order, never atomics, so the result repeats bit
//    for bit: in a block, the two half-warps of a channel lane pair by one
//    shuffle, then the warps sum in order through shared memory (one
//    barrier) into one (27, CT) partial a block; dw3d_gw_reduce_kernel then
//    sums the partials of each output in a fixed tree (32 rows of lanes over
//    the partials, then the rows in order), reading them from L2.
// Channel counts whose voxel is not a multiple of 16 bytes, or unaligned
// tensors, take the same kernel with element copies.
//
// What it reached (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's times
// phase): 11.3 ms per f32 training step (batch 8, ten calls) against a 6.24
// ms bound, 11.2 ms in bf16 against 3.12 (the previous design, one thread a
// column with 27 x 4 accumulators and nine global loads a plane: 62 / 52
// ms). The sizes came from an A/B of variants: z segments of 64 planes
// rather than 32 (-1% f32, -3% bf16) or 16 (+6 to 9%); 4 outputs a thread
// rather than 8 in f32 (the same time, and no spills); 3 stages rather than
// 4 and TY 8 in bf16 within 1%. As with the forward, f32 and bf16 take about
// the same time, so the SM's instruction issue bounds it, not the bytes.
constexpr int kGwZSeg = 64;  // most output planes a weight-gradient block walks

template <typename T, int STRIDE>
struct GwTile {
  static constexpr int VEC = 4 / sizeof(T);          // channels a thread
  static constexpr int CT = 64 / sizeof(T);          // channels a block
  static constexpr int CL = CT / VEC;                // lanes along C
  static constexpr int TY = sizeof(T) == 4 ? 8 : 4;
  static constexpr int TX = STRIDE == 1 && sizeof(T) == 2 ? 16 : 8;
  static constexpr int NX = 4;                        // outputs a thread along x
  static constexpr int kStages = STRIDE == 1 ? 4 : 3;
  // bf16 keeps its copy loops rolled: beside its 54 accumulators, the
  // hoisted addresses of unrolled copies would spill.
  static constexpr bool ROLLED = sizeof(T) == 2;
  static constexpr int THREADS = CL * TY * (TX / NX);
  static constexpr int WARPS = THREADS / 32;
  static constexpr int ROWS = (TY - 1) * STRIDE + 3;  // input rows of a slab
  static constexpr int RS = TX * STRIDE + 2;          // voxel slots a slab row (even)
  static constexpr int SLAB = ROWS * RS * CT;         // elements of an input slab
  static constexpr int STAGE = SLAB + TY * TX * CT;   // and of the cotangent tile
  static constexpr size_t RING_BYTES = static_cast<size_t>(kStages) * STAGE * sizeof(T);
  static constexpr size_t SUM_BYTES = static_cast<size_t>(WARPS) * 27 * CT * sizeof(float);
  static constexpr size_t SMEM = RING_BYTES > SUM_BYTES ? RING_BYTES : SUM_BYTES;
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // at most 128 registers a thread
  static_assert(CL == 16 && TY % 2 == 0, "a warp is two tile rows of 16 channel lanes");
  static_assert(NX % 2 == 0 && TX % 2 == 0 && RS % 2 == 0, "the swizzle pairs slots 2k, 2k+1");
};

template <typename T, int STRIDE>
TileGeometry gw_geometry(int D, int H, int W, int C) {
  using G = GwTile<T, STRIDE>;
  TileGeometry g;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.Do = (D + STRIDE - 1) / STRIDE;
  g.Ho = (H + STRIDE - 1) / STRIDE;
  g.Wo = (W + STRIDE - 1) / STRIDE;
  g.n_ct = (C + G::CT - 1) / G::CT;
  g.n_xt = (g.Wo + G::TX - 1) / G::TX;
  g.n_yt = (g.Ho + G::TY - 1) / G::TY;
  g.n_zt = (g.Do + kGwZSeg - 1) / kGwZSeg;
  g.zseg = g.n_zt > 0 ? (g.Do + g.n_zt - 1) / g.n_zt : 1;  // even segments
  return g;
}

// Block (ct, part) writes partial[part][t][c] for its CT channels, part =
// ((b * n_zt + zt) * n_yt + yt) * n_xt + xt.
template <typename T, int STRIDE, bool VECIO>
__global__ void __launch_bounds__(GwTile<T, STRIDE>::THREADS, GwTile<T, STRIDE>::MIN_BLOCKS)
dw3d_gw_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ partial,
               TileGeometry g) {
  using G = GwTile<T, STRIDE>;
  constexpr int VEC = G::VEC, NX = G::NX;
  extern __shared__ __align__(16) unsigned char gw_smem[];
  T* ring = reinterpret_cast<T*>(gw_smem);  // kStages x (input slab, cotangent tile)

  const int ct = static_cast<int>(blockIdx.x % g.n_ct);
  const int64_t part = blockIdx.x / g.n_ct;
  int64_t bid = part;
  const int xt = static_cast<int>(bid % g.n_xt); bid /= g.n_xt;
  const int yt = static_cast<int>(bid % g.n_yt); bid /= g.n_yt;
  const int zt = static_cast<int>(bid % g.n_zt); bid /= g.n_zt;
  const int64_t b = bid;

  const int tid = threadIdx.x;
  const int cl = tid % G::CL;             // lane along C
  const int ty = (tid / G::CL) % G::TY;   // output row in the tile
  const int xg = tid / (G::CL * G::TY);   // group of NX outputs along x
  const int c0 = ct * G::CT;
  const int yo0 = yt * G::TY, xo0 = xt * G::TX;
  const int yi0 = yo0 * STRIDE - 1, xi0 = xo0 * STRIDE - 1;
  const int zo0 = zt * g.zseg;
  const int zo1 = min(zo0 + g.zseg, g.Do);
  // Input planes zi0, zi0 + 1, ... feed outputs zo0 .. zo1 - 1; step i
  // brings in output zo0 + i (stride 1) or, at even i, zo0 + i / 2 (stride
  // 2), whose rows the thread keeps; -1 where no output of the segment enters.
  const int zi0 = zo0 * STRIDE - 1;
  const int np = STRIDE == 1 ? zo1 - zo0 + 2 : 2 * (zo1 - zo0) + 1;
  auto entering = [&](int i) {
    const int zo = STRIDE == 1 ? zo0 + i : ((i & 1) ? zo1 : zo0 + i / 2);
    return zo < zo1 ? zo : -1;
  };

  auto fetch = [&](int i) {  // step i's input plane and cotangent tile into its stage, one group
    if (i < np) {
      T* stage = ring + (i % G::kStages) * G::STAGE;
      const int zi = zi0 + i;
      if (zi >= 0 && zi < g.D)
        copy_slab<T, G::ROWS, G::RS, G::CT, G::THREADS, STRIDE, VECIO, G::ROLLED>(
            x, stage, g.D, g.H, g.W, g.C, b, zi, yi0, xi0, c0, tid);
      const int zo = entering(i);
      if (zo >= 0)
        copy_slab<T, G::TY, G::TX, G::CT, G::THREADS, 1, VECIO, G::ROLLED>(
            gy, stage + G::SLAB, g.Do, g.Ho, g.Wo, g.C, b, zo, yo0, xo0, c0, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < G::kStages - 1; ++i) fetch(i);

  float acc[27][VEC] = {};
  // Cotangent rows (NX outputs of this thread) of the outputs the current
  // input plane feeds. Stride 1: gn = zi + 1 (dz 0), gc = zi (dz 1), gp =
  // zi - 1 (dz 2). Stride 2: gn = (zi + 1) / 2 (dz 0 at odd zi), gc = the
  // output whose dz 1 (even zi) or dz 2 (odd zi) plane zi is.
  float gp[NX][VEC] = {}, gc[NX][VEC] = {}, gn[NX][VEC] = {};
  const int gf = slot_flip<1>(ty);
  for (int i = 0; i < np; ++i) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // step i has landed, and every thread is done with step i-1
    fetch(i + G::kStages - 1);
    const T* stage = ring + (i % G::kStages) * G::STAGE + cl * VEC;
    if (STRIDE == 1 || (i & 1) == 0) {
      if (entering(i) >= 0) {
        const T* row = stage + G::SLAB + (ty * G::TX + xg * NX) * G::CT;
#pragma unroll
        for (int k = 0; k < NX; ++k) load(row + (k + ((k & 1) ? -gf : gf)) * G::CT, gn[k]);
      } else {
#pragma unroll
        for (int k = 0; k < NX; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e) gn[k][e] = 0.f;
      }
    }
    const int zi = zi0 + i;
    if (zi >= 0 && zi < g.D) {
      if constexpr (STRIDE == 1) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = ty + dy;
          const int f = slot_flip<1>(r);
          const T* row = stage + (r * G::RS + xg * NX) * G::CT;
          float v[NX + 2][VEC];
#pragma unroll
          for (int j = 0; j < NX + 2; ++j) load(row + (j + ((j & 1) ? -f : f)) * G::CT, v[j]);
#pragma unroll
          for (int k = 0; k < NX; ++k)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int t = dy * 3 + dx;
              fma_taps(acc[t], v[k + dx], gn[k]);
              fma_taps(acc[9 + t], v[k + dx], gc[k]);
              fma_taps(acc[18 + t], v[k + dx], gp[k]);
            }
        }
      } else {
        const bool mid_plane = (i & 1) != 0;  // zi = 2 zo: dz 1 of gc
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = 2 * ty + dy;
          const int f = slot_flip<2>(r);
          const T* row = stage + (r * G::RS + 2 * xg * NX) * G::CT;
          float v[2 * NX + 1][VEC];
#pragma unroll
          for (int j = 0; j < 2 * NX + 1; ++j) load(row + (j + ((j & 1) ? -f : f)) * G::CT, v[j]);
          if (mid_plane) {
#pragma unroll
            for (int k = 0; k < NX; ++k)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) fma_taps(acc[9 + dy * 3 + dx], v[2 * k + dx], gc[k]);
          } else {
#pragma unroll
            for (int k = 0; k < NX; ++k)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const int t = dy * 3 + dx;
                fma_taps(acc[t], v[2 * k + dx], gn[k]);
                fma_taps(acc[18 + t], v[2 * k + dx], gc[k]);
              }
          }
        }
      }
    }
    if (STRIDE == 1 || (i & 1) == 0) {
#pragma unroll
      for (int k = 0; k < NX; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          gp[k][e] = gc[k][e];
          gc[k][e] = gn[k][e];
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' sums now

  // Lanes l and l + 16 of a warp share a channel lane (tile rows ty, ty + 1).
  float* sums = reinterpret_cast<float*>(gw_smem);  // (WARPS, 27, CT)
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int t = 0; t < 27; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float s = acc[t][e] + __shfl_xor_sync(0xffffffffu, acc[t][e], 16);
      if (lane < 16) sums[(warp * 27 + t) * G::CT + cl * VEC + e] = s;
    }
  __syncthreads();
  float* out = partial + part * 27 * g.C + c0;
  for (int i = tid; i < 27 * G::CT; i += G::THREADS) {
    const int t = i / G::CT, cc = i % G::CT;
    if (c0 + cc >= g.C) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < G::WARPS; ++w) s += sums[(w * 27 + t) * G::CT + cc];
    out[t * g.C + cc] = s;
  }
}

// gw[i] = sum over p of partial[p][i], i < n = 27 C: a block owns 32
// outputs; row y of its 32 rows of lanes sums p = y, y + 32, ... in order,
// then row 0 sums the rows in order.
constexpr int kGwSumRows = 32;

__global__ void __launch_bounds__(32 * kGwSumRows)
dw3d_gw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ gw, int64_t n_part,
                      int n) {
  __shared__ float rows[kGwSumRows][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int64_t p = threadIdx.y; p < n_part; p += kGwSumRows) s += partial[p * n + i];
  }
  rows[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.f;
    for (int r = 0; r < kGwSumRows; ++r) t += rows[r][threadIdx.x];
    gw[i] = t;
  }
}

// Floats of partial sums a weight-gradient call needs.
template <typename T, int STRIDE>
int64_t gw_workspace(int B, int D, int H, int W, int C) {
  const TileGeometry g = gw_geometry<T, STRIDE>(D, H, W, C);
  return static_cast<int64_t>(B) * g.n_zt * g.n_yt * g.n_xt * 27 * C;
}

template <typename T, int STRIDE, bool VECIO>
cudaError_t launch_gw(const void* x, const void* gy, float* work, int64_t work_floats, float* gw,
                      int B, int D, int H, int W, int C, cudaStream_t stream) {
  using G = GwTile<T, STRIDE>;
  const TileGeometry g = gw_geometry<T, STRIDE>(D, H, W, C);
  const int64_t n_part = static_cast<int64_t>(B) * g.n_zt * g.n_yt * g.n_xt;
  const int64_t n = 27 * static_cast<int64_t>(C);
  if (n == 0) return cudaSuccess;
  if (n_part == 0) return cudaMemsetAsync(gw, 0, n * sizeof(float), stream);
  if (n_part * n > work_floats || n > INT_MAX) return cudaErrorInvalidValue;
  const int64_t blocks = n_part * g.n_ct;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = dw3d_gw_kernel<T, STRIDE, VECIO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), G::THREADS, G::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), work, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw3d_gw_reduce_kernel<<<static_cast<unsigned>((n + 31) / 32), dim3(32, kGwSumRows), 0, stream>>>(
      work, gw, n_part, static_cast<int>(n));
  return cudaGetLastError();
}

template <typename T, int STRIDE>
cudaError_t launch_gw_io(const void* x, const void* gy, float* work, int64_t work_floats,
                         float* gw, int B, int D, int H, int W, int C, cudaStream_t stream) {
  if (use_vecio<T>(x, gy, C))
    return launch_gw<T, STRIDE, true>(x, gy, work, work_floats, gw, B, D, H, W, C, stream);
  return launch_gw<T, STRIDE, false>(x, gy, work, work_floats, gw, B, D, H, W, C, stream);
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
  cudaError_t err = cudaErrorInvalidValue;
  if (stride == 1)
    err = is_bf16 ? launch_fwd_io<__nv_bfloat16, 1, false>(x, w, y, B, D, H, W, C, s)
                  : launch_fwd_io<float, 1, false>(x, w, y, B, D, H, W, C, s);
  else if (stride == 2)
    err = is_bf16 ? launch_fwd_io<__nv_bfloat16, 2, false>(x, w, y, B, D, H, W, C, s)
                  : launch_fwd_io<float, 2, false>(x, w, y, B, D, H, W, C, s);
  return static_cast<int>(err);
}

// The input gradient of dw3d_fwd. gy: the cotangent of y; gx: (B, D, H, W,
// C), the forward input's shape. Stride 1 is the forward kernel with the
// taps reversed; stride 2 is dw3d_gx2_kernel.
extern "C" int dw3d_grad_x(const void* gy, const void* w27, void* gx, int is_bf16, int stride,
                           int B, int D, int H, int W, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w27);
  (void)cudaGetLastError();
  if (stride == 1)
    return static_cast<int>(
        is_bf16 ? launch_fwd_io<__nv_bfloat16, 1, true>(gy, w, gx, B, D, H, W, C, s)
                : launch_fwd_io<float, 1, true>(gy, w, gx, B, D, H, W, C, s));
  return static_cast<int>(by_type(is_bf16, C, alignment(gy, gx), [&](auto tv) {
    using TV = decltype(tv);
    if (stride == 2) return launch_gx2<typename TV::T, TV::VEC>(gy, w, gx, B, D, H, W, C, s);
    return cudaErrorInvalidValue;
  }));
}

// Floats of scratch a dw3d_grad_w call with these arguments needs; -1 for
// an unsupported stride.
extern "C" long long dw3d_grad_w_workspace(int is_bf16, int stride, int B, int D, int H, int W,
                                           int C) {
  if (stride == 1)
    return is_bf16 ? gw_workspace<__nv_bfloat16, 1>(B, D, H, W, C)
                   : gw_workspace<float, 1>(B, D, H, W, C);
  if (stride == 2)
    return is_bf16 ? gw_workspace<__nv_bfloat16, 2>(B, D, H, W, C)
                   : gw_workspace<float, 2>(B, D, H, W, C);
  return -1;
}

// The weight gradient of dw3d_fwd into gw (27, C) f32. x: the forward input
// (B, D, H, W, C); gy: the cotangent of y. work: f32 scratch of work_floats
// >= dw3d_grad_w_workspace(...) floats, overwritten.
extern "C" int dw3d_grad_w(const void* x, const void* gy, void* work, long long work_floats,
                           void* gw, int is_bf16, int stride, int B, int D, int H, int W, int C,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(work);
  float* out = static_cast<float*>(gw);
  (void)cudaGetLastError();
  cudaError_t err = cudaErrorInvalidValue;
  if (stride == 1)
    err = is_bf16 ? launch_gw_io<__nv_bfloat16, 1>(x, gy, p, work_floats, out, B, D, H, W, C, s)
                  : launch_gw_io<float, 1>(x, gy, p, work_floats, out, B, D, H, W, C, s);
  else if (stride == 2)
    err = is_bf16 ? launch_gw_io<__nv_bfloat16, 2>(x, gy, p, work_floats, out, B, D, H, W, C, s)
                  : launch_gw_io<float, 2>(x, gy, p, work_floats, out, B, D, H, W, C, s);
  return static_cast<int>(err);
}

extern "C" const char* dw3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
