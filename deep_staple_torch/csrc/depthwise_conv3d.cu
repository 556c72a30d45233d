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
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kZSeg = 16;  // most output planes a forward block walks along z

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load(const float* p, float (&v)[8]) {
  load(p, reinterpret_cast<float (&)[4]>(v[0]));
  load(p + 4, reinterpret_cast<float (&)[4]>(v[4]));
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // channel 2k in the low half
    v[2 * k] = __uint_as_float(h[k] << 16);
    v[2 * k + 1] = __uint_as_float(h[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
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

  int64_t blocks(int B) const { return static_cast<int64_t>(B) * n_zt * n_yt * n_xt * n_ct; }
};

// The grid of a tiled kernel at stride s: tiles of ct channels and ty x tx
// outputs of (yo, xo), and z segments of at most zseg_max output planes,
// split evenly.
TileGeometry tile_geometry(int s, int D, int H, int W, int C, int ct, int ty, int tx,
                           int zseg_max) {
  TileGeometry g;
  g.D = D; g.H = H; g.W = W; g.C = C;
  g.Do = (D + s - 1) / s;
  g.Ho = (H + s - 1) / s;
  g.Wo = (W + s - 1) / s;
  g.n_ct = (C + ct - 1) / ct;
  g.n_xt = (g.Wo + tx - 1) / tx;
  g.n_yt = (g.Ho + ty - 1) / ty;
  g.n_zt = (g.Do + zseg_max - 1) / zseg_max;
  g.zseg = g.n_zt > 0 ? (g.Do + g.n_zt - 1) / g.n_zt : 1;
  return g;
}

// Slot of voxel x of slab row r: pairs (2k, 2k+1) swap on bit STRIDE-1 of r,
// so that rows r and r + STRIDE (one output row apart) use opposite halves
// of the banks. STRIDE 0: no swizzle.
template <int STRIDE>
__device__ __forceinline__ int slot_flip(int r) {
  if constexpr (STRIDE == 0) return 0;
  else return (r >> (STRIDE - 1)) & 1;
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
  const TileGeometry g = tile_geometry(STRIDE, D, H, W, C, F::CT, F::TY, F::TX, kZSeg);
  const int64_t blocks = g.blocks(B);
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

// Input gradient, stride 2: the VJP of the model's one stride-2 depthwise
// conv (block 6), deep_staple_tpu/ops/conv3d.py:77-90, which dilates the
// cotangent to the input lattice and applies the flipped taps (the Pallas
// VJP, conv3d_pallas.py:264-269, takes stride 1 only). Along each axis the
// even input 2o takes cotangent o through tap 1, and the odd input 2o + 1
// takes o through tap 2 and o + 1 through tap 0 (zero past the cotangent's
// extent). Nothing of the 8x larger dilated cotangent exists here.
//
// What bounds it: bytes, and mostly those written. A cotangent voxel feeds
// 2 x 2 x 2 input voxels through 27 FMAs a channel: 54 flop against 8
// elements written and one read, 1.5 flop/byte in f32, far under the 20
// flop/byte ridge. gx is 8x the cotangent, so the least time is gx written
// once (and gy read once) at the memory rate.
//
// What the design does about it (dw3d_gx2_kernel): every input voxel is
// written once, by 16-byte streaming stores, and no lane of a warp takes
// other taps than its neighbours.
//  * A thread owns one cotangent column (yo, xo) and 16 bytes of channels
//    (4 f32 or 8 bf16), and writes the 2 x 2 input voxels (2yo + py,
//    2xo + px) of two input planes per cotangent plane. The taps of each of
//    those voxels follow from (py, px) alone, so every lane runs the same 27
//    FMAs a channel, with no parity test and no branch.
//  * A block owns a channel tile (CT), TY x TX cotangent columns and a
//    segment of at most ZSEG cotangent planes [zo0, zo1), and walks it along
//    z with a carry: at plane zo, input plane 2zo is complete (tap dz = 1),
//    and input plane 2zo - 1 is completed by tap dz = 0 on top of the dz = 2
//    partials carried from plane zo - 1 (4 voxels x VEC floats). The walk
//    reads plane zo1 (zero past Do) as its halo, so input planes 2 zo0 ..
//    2 zo1 - 1 are written by one block each.
//  * Each cotangent plane's (TY + 1) x (TX + 1) tile (the extra row and
//    column are the o + 1 that odd inputs take) is copied into a ring of
//    kStages tiles in shared memory with cp.async, src-size 0 past Ho and Wo,
//    the next planes' copies in flight while one is summed; one barrier a
//    plane. A warp reads 512 contiguous bytes of a tile row, so the tile
//    needs no swizzle.
//  * The weights are read from shared memory as each voxel needs them, with
//    a __syncwarp() after each voxel's store: without it ptxas loads the
//    weights of all the plane's voxels at once (27 x VEC floats), which
//    takes 132 registers in f32 and 196 in bf16, and spills at the
//    launch bound.
//  * Stores past H, W and D (the odd input 2o + 1 = n at an odd extent) are
//    masked.
// Channel counts whose voxel is not a multiple of 16 bytes, or unaligned
// tensors, take the same kernel with element copies and scalar stores.
//
// What it reached (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's times
// phase): 0.87 ms in f32 at the training call (8, 96, 96, 38, 192) against
// a 0.723 ms bound, 83% of the HBM rate, and 0.55 ms in bf16 against 0.361,
// 66% (the previous design, one thread an input column with 1 to 8
// scattered taps a voxel: 3.74 / 3.59 ms). The sizes (f32: 64 channels,
// 1 x 8 columns, z segments of 4; bf16: 32 channels, 4 x 8, 8; 3 stages,
// 128 threads) came from an A/B of variants: 8 x 8 columns of 64 bytes at
// 128 registers spilled and ran 1.23 / 0.58 ms; 4 bf16 channels a thread
// with lane pairs trading halves for 16-byte stores (no spills) 0.63 ms;
// plain stores rather than streaming ones 1-7% slower; segments of 16 or
// 32 planes, 4 stages, other channel tiles: each slower or within 2%.
// bf16 stays further from its bound: for the same 16 bytes stored, a
// thread issues twice the FMAs and weight loads of f32.
template <typename T>
struct Gx2Tile {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int VEC = 16 / sizeof(T);        // channels a thread: 16 bytes
  static constexpr int CT = F32 ? 64 : 32;          // channels a block
  static constexpr int CL = CT / VEC;               // lanes along C
  static constexpr int TY = F32 ? 1 : 4, TX = 8;    // cotangent columns (yo, xo) a block
  static constexpr int ZSEG = F32 ? 4 : 8;          // most cotangent planes a block walks
  static constexpr int kStages = 3;                 // tiles in the ring
  static constexpr int THREADS = CL * TY * TX;
  static constexpr int ROWS = TY + 1, RS = TX + 1;  // a tile and its high-side halo
  static constexpr int SLAB = ROWS * RS * CT;       // elements of a tile
  static constexpr size_t RING_BYTES = static_cast<size_t>(kStages) * SLAB * sizeof(T);
  static constexpr size_t SMEM = RING_BYTES + 27 * CT * sizeof(float);
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 170);  // at most 170 registers a thread
  static_assert(RING_BYTES % 16 == 0 && SMEM <= 48 * 1024, "16-byte weight loads, static smem");
};

// Adds the taps of depth dz to a, the input voxel (2yo + py, 2xo + px) of a
// plane: along y, py = 0 takes cotangent row yo through dy = 1, and py = 1
// takes yo through dy = 2 and yo + 1 through dy = 0; along x likewise.
// gv[oy][ox] is the cotangent at (yo + oy, xo + ox); tap t of this thread's
// channels is at w + t * CT.
template <int CT, int VEC>
__device__ __forceinline__ void gx2_taps(float (&a)[VEC], int dz, int py, int px,
                                         const float (&gv)[2][2][VEC], const float* w) {
#pragma unroll
  for (int oy = 0; oy <= py; ++oy)
#pragma unroll
    for (int ox = 0; ox <= px; ++ox) {
      float wv[VEC];
      load(w + (dz * 9 + (py ? 2 - 2 * oy : 1) * 3 + (px ? 2 - 2 * ox : 1)) * CT, wv);
      fma_taps(a, gv[oy][ox], wv);
    }
}

// One voxel's 16 bytes of channels from c (4 f32 or 8 bf16) as a streaming
// store (gx is not read again here); without VECIO each channel below C on
// its own.
template <bool VECIO>
__device__ __forceinline__ void put16(float* p, const float (&v)[4], int c, int C) {
  if constexpr (VECIO) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < C) p[k] = v[k];
  }
}
template <bool VECIO>
__device__ __forceinline__ void put16(__nv_bfloat16* p, const float (&v)[8], int c, int C) {
  if constexpr (VECIO) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                                                   bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7])));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c + k < C) p[k] = __float2bfloat16(v[k]);
  }
}

template <typename T, bool VECIO>
__global__ void __launch_bounds__(Gx2Tile<T>::THREADS, Gx2Tile<T>::MIN_BLOCKS)
dw3d_gx2_kernel(const T* __restrict__ gy, const float* __restrict__ w27, T* __restrict__ gx,
                TileGeometry g) {
  using G = Gx2Tile<T>;
  constexpr int VEC = G::VEC;
  extern __shared__ __align__(16) unsigned char gx2_smem[];
  T* ring = reinterpret_cast<T*>(gx2_smem);                           // kStages tiles
  float* w_s = reinterpret_cast<float*>(ring + G::kStages * G::SLAB);  // (27, CT)

  int64_t bid = blockIdx.x;
  const int ct = static_cast<int>(bid % g.n_ct); bid /= g.n_ct;
  const int xt = static_cast<int>(bid % g.n_xt); bid /= g.n_xt;
  const int yt = static_cast<int>(bid % g.n_yt); bid /= g.n_yt;
  const int zt = static_cast<int>(bid % g.n_zt); bid /= g.n_zt;
  const int64_t b = bid;

  const int tid = threadIdx.x;
  const int cl = tid % G::CL;            // lane along C
  const int tx = (tid / G::CL) % G::TX;  // cotangent column in the tile
  const int ty = tid / (G::CL * G::TX);  // cotangent row in the tile
  const int c0 = ct * G::CT;
  const int c = c0 + cl * VEC;
  const int yo0 = yt * G::TY, xo0 = xt * G::TX;
  const int yo = yo0 + ty, xo = xo0 + tx;
  const int zo0 = zt * g.zseg;
  const int zo1 = min(zo0 + g.zseg, g.Do);
  const int np = zo1 - zo0 + 1;  // the segment's planes, then plane zo1 as its halo

  auto fetch = [&](int i) {  // cotangent plane zo0 + i into its ring slot, one group
    const int zo = zo0 + i;
    if (i < np && zo < g.Do)
      copy_slab<T, G::ROWS, G::RS, G::CT, G::THREADS, 0, VECIO>(
          gy, ring + (i % G::kStages) * G::SLAB, g.Do, g.Ho, g.Wo, g.C, b, zo, yo0, xo0, c0, tid);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < G::kStages - 1; ++i) fetch(i);
  for (int i = tid; i < 27 * G::CT; i += G::THREADS) {  // read after the walk's first barrier
    const int t = i / G::CT, cc = c0 + i % G::CT;
    w_s[i] = cc < g.C ? w27[static_cast<int64_t>(t) * g.C + cc] : 0.f;
  }

  const bool active = c < g.C && yo < g.Ho && xo < g.Wo;
  const bool y_odd = 2 * yo + 1 < g.H, x_odd = 2 * xo + 1 < g.W;  // odd inputs inside
  const int64_t sH = static_cast<int64_t>(g.W) * g.C, sD = g.H * sH;
  T* out = gx + b * g.D * sD + 2 * yo * sH + static_cast<int64_t>(2 * xo) * g.C + c;
  const float* w = w_s + cl * VEC;
  auto put = [&](int zi, int py, int px, const float (&a)[VEC]) {
    if (active && (py == 0 || y_odd) && (px == 0 || x_odd))
      put16<VECIO>(out + zi * sD + py * sH + px * g.C, a, c, g.C);
    __syncwarp();  // keeps ptxas from loading later voxels' weights early
  };

  float carry[2][2][VEC] = {};  // taps dz = 2 of plane zo - 1, for input plane 2zo - 1
  for (int i = 0; i < np; ++i) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // plane i has landed, and every thread is done with plane i-1
    fetch(i + G::kStages - 1);
    const int zo = zo0 + i;
    float gv[2][2][VEC] = {};
    if (zo < g.Do) {
      const T* tile = ring + (i % G::kStages) * G::SLAB + cl * VEC;
#pragma unroll
      for (int oy = 0; oy < 2; ++oy)
#pragma unroll
        for (int ox = 0; ox < 2; ++ox) load(tile + ((ty + oy) * G::RS + tx + ox) * G::CT, gv[oy][ox]);
    }
    if (i > 0 && 2 * zo - 1 < g.D) {  // input plane 2zo - 1: dz = 0 on the carry
#pragma unroll
      for (int py = 0; py < 2; ++py)
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          gx2_taps<G::CT>(carry[py][px], 0, py, px, gv, w);
          put(2 * zo - 1, py, px, carry[py][px]);
        }
    }
    if (i < np - 1) {  // input plane 2zo (dz = 1), and the carry for 2zo + 1 (dz = 2)
#pragma unroll
      for (int py = 0; py < 2; ++py)
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          float a[VEC] = {};
          gx2_taps<G::CT>(a, 1, py, px, gv, w);
          put(2 * zo, py, px, a);
#pragma unroll
          for (int k = 0; k < VEC; ++k) carry[py][px][k] = 0.f;
          gx2_taps<G::CT>(carry[py][px], 2, py, px, gv, w);
        }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T>
cudaError_t launch_gx2(const void* gy, const float* w27, void* gx, int B, int D, int H, int W,
                       int C, cudaStream_t stream) {
  using G = Gx2Tile<T>;
  const TileGeometry g = tile_geometry(2, D, H, W, C, G::CT, G::TY, G::TX, G::ZSEG);
  const int64_t blocks = g.blocks(B);
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  auto kernel = use_vecio<T>(gy, gx, C) ? &dw3d_gx2_kernel<T, true>
                                        : &dw3d_gx2_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), G::THREADS, G::SMEM, stream>>>(
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
  return tile_geometry(STRIDE, D, H, W, C, G::CT, G::TY, G::TX, kGwZSeg);
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
  if (stride == 2)
    return static_cast<int>(is_bf16 ? launch_gx2<__nv_bfloat16>(gy, w, gx, B, D, H, W, C, s)
                                    : launch_gx2<float>(gy, w, gx, B, D, H, W, C, s));
  return static_cast<int>(cudaErrorInvalidValue);
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
