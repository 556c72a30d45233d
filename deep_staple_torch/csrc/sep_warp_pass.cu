// The separable augmentation warp's three scanline passes, fused with their
// packing and transposes, for NVIDIA Hopper (sm_90a).
//
// Replaces deep_staple_tpu/ops/sep_warp.py::_sep_pass_pallas (the Mosaic
// lane-gather kernel K1, body :339-345, pallas_call :347) and, around it,
// the packing (_pack_pass :274-280) and the transposes of sep_warp_apply
// (:378-453). The element math is that of _pass_index_math / _pass_elem_math
// (:283-307). The warp resamples a (B, D, H, W) volume along W (pass X),
// then H (pass Y), then D (pass Z). For the element at position i of a row
// of L voxels along the pass axis, with cc = unnormalize(f, L) of the pass's
// coordinate field f at that element:
//
//   i0   = clamp(floor(clamp(cc, 0, L-1)), 0, max(L-2, 0)),  i1 = min(i0+1, L-1)
//   img  = q[i0] * (1 - w) + q[i1] * w,   w = clamp(cc, 0, L-1) - i0
//   code = code[i1] if rint(cc) >= i0 + 1 else code[i0];
//          0 unless -0.5 <= cc < L - 0.5
//
// q is the row's int12 quantum, clamp(rint(x), +/-2047), of the image over
// the sample's scale (absmax / 2047) before pass X and of the previous pass's
// float result after it; code is the 2-bit label | modified << 1. Every
// float op is written with a _rn intrinsic (no FMA contraction), so each
// result is the same float32 arithmetic as torch's separate ops in the plain
// version (ops/sep_warp.py::sep_warp_apply_plain).
//
// What bounds it: bytes. Pass X reads the image, both labels and fx (16 B an
// element) and writes one 16-bit intermediate (q * 4 + code); pass Y reads
// it and fy and writes it back in place (6 + 2 B); pass Z reads it and fz
// and writes the image times the scale and the two labels (6 + 12 B): 44 B
// an element, 0.086 ms at 3.35 TB/s for the production batch (8, 128, 128,
// 50), against about 100 integer and float operations an element. (The
// warp's own inputs and outputs are 36 B, 0.070 ms: the intermediate's 8 B
// are the price of three passes.)
// What the design does about it: each pass works in the batch's own (B, D,
// H, W) layout, so nothing is transposed or packed between passes, and the
// intermediate is 2 bytes where the unfused passes moved a 4-byte word and
// a 4-byte float. A block holds whole rows along its pass axis in shared
// memory, since i0 may fall anywhere in the row: pass X up to 1,024
// elements of whole W-rows, pass Y whole H-columns of up to 32 consecutive
// W positions, pass Z whole D-columns of up to 32 consecutive (h, w)
// positions (`tile_plan` in ops/sep_warp.py; small tiles give each SM many
// short blocks, so one block's loads overlap another's gathers and the last
// wave is short). Each block first loads its tile, every global read of the
// pass at once: the quanta and, beside them, each position's coordinate
// (unnormalized), so that the second loop reads only shared memory and
// writes. Pass X loads 16 bytes a thread where its tile is aligned. Threads
// walk the tile's positions in order, so every global access is coalesced,
// and step their (row, column) without a division. A tile above 48 KB
// takes the opt-in to Hopper's 227 KB.
//
// Plain C interface, loaded with ctypes: sw_apply launches the three passes
// on the given stream, does not synchronise, and returns the first CUDA
// error (cudaErrorInvalidValue for a plan that does not fit).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;     // shared memory a block may use on sm_90 (227 KB)
constexpr int kDefaultSmem = 49152;  // above this a kernel needs the opt-in

// unnormalize() of ops/sep_warp.py as torch computes it: four rounded ops.
__device__ __forceinline__ float unnormalize(float f, int L) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(f, 1.f), static_cast<float>(L)), 1.f), 0.5f);
}

// The 16-bit intermediate: the int12 quantum clamp(rint(x), +/-2047) times 4
// plus the 2-bit code. `>> 2` gives the quantum back, `& 3` the code.
__device__ __forceinline__ int16_t encode(float x, int code) {
  const float q = fminf(fmaxf(rintf(x), -2047.f), 2047.f);
  return static_cast<int16_t>(static_cast<int>(q) * 4 + code);
}

// One element of a pass: `row` is the tile's row along the pass axis, its
// voxels `pitch` int16 apart; cc in voxel units of the row.
__device__ __forceinline__ void resample(const int16_t* row, int pitch, int L, float cc,
                                         float& img, int& code) {
  const float cimg = fminf(fmaxf(cc, 0.f), static_cast<float>(L - 1));
  const int i0 = min(max(static_cast<int>(floorf(cimg)), 0), max(L - 2, 0));
  const int i1 = min(i0 + 1, L - 1);  // the border replication of a row of one voxel
  const float w = __fsub_rn(cimg, static_cast<float>(i0));
  const int g0 = row[i0 * pitch];
  const int g1 = row[i1 * pitch];
  img = __fadd_rn(__fmul_rn(static_cast<float>(g0 >> 2), __fsub_rn(1.f, w)),
                  __fmul_rn(static_cast<float>(g1 >> 2), w));
  // clamp(rint(cc) - i0, 0, 1), compared in float so that no cast overflows.
  const bool sel = rintf(cc) >= static_cast<float>(i0 + 1);
  const bool valid = cc >= -0.5f && cc < static_cast<float>(L) - 0.5f;
  code = valid ? ((sel ? g1 : g0) & 3) : 0;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c,
                                          const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) & 15) == 0;
}

// Advance (row, col) of a tile `cols` wide by kThreads positions.
__device__ __forceinline__ void step(int& row, int& col, int cols, int drow, int dcol) {
  col += dcol;
  row += drow;
  if (col >= cols) {
    col -= cols;
    ++row;
  }
}

// Pass X, along W: a block takes `rows` whole W-rows of sample blockIdx.y.
// It quantizes them into shared memory beside the rows' coordinates, then
// writes the intermediate.
__global__ void __launch_bounds__(kThreads)
    sep_warp_x_kernel(const float* __restrict__ img, const int32_t* __restrict__ lbl,
                      const int32_t* __restrict__ mod, const float* __restrict__ fx,
                      long long fx_bstride, const float* __restrict__ scale,
                      int16_t* __restrict__ out, int DH, int W, int rows) {
  extern __shared__ float c[];  // rows * W coordinates, then rows * W quanta
  int16_t* s = reinterpret_cast<int16_t*>(c + rows * W);
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int n = min(rows, DH - r0) * W;
  const long long base = (static_cast<long long>(b) * DH + r0) * W;
  const float* f = fx + b * fx_bstride + static_cast<long long>(r0) * W;
  const float sc = fmaxf(scale[b], 1e-12f);  // clamp(min=1e-12) of the plain version
  if (aligned16(img + base, lbl + base, mod + base, f) && n % 4 == 0) {
    // 16-byte loads: four elements a thread an iteration.
#pragma unroll 2
    for (int q = threadIdx.x; q < n / 4; q += kThreads) {
      const float4 a = reinterpret_cast<const float4*>(img + base)[q];
      const int4 l = reinterpret_cast<const int4*>(lbl + base)[q];
      const int4 m = reinterpret_cast<const int4*>(mod + base)[q];
      const float4 g = reinterpret_cast<const float4*>(f)[q];
      s[4 * q] = encode(__fdiv_rn(a.x, sc), (l.x + 2 * m.x) & 3);
      s[4 * q + 1] = encode(__fdiv_rn(a.y, sc), (l.y + 2 * m.y) & 3);
      s[4 * q + 2] = encode(__fdiv_rn(a.z, sc), (l.z + 2 * m.z) & 3);
      s[4 * q + 3] = encode(__fdiv_rn(a.w, sc), (l.w + 2 * m.w) & 3);
      reinterpret_cast<float4*>(c)[q] = make_float4(unnormalize(g.x, W), unnormalize(g.y, W),
                                                    unnormalize(g.z, W), unnormalize(g.w, W));
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s[i] = encode(__fdiv_rn(img[base + i], sc), (lbl[base + i] + 2 * mod[base + i]) & 3);
      c[i] = unnormalize(f[i], W);
    }
  }
  __syncthreads();
  int r = threadIdx.x / W, x = threadIdx.x - r * W;
  const int dr = kThreads / W, dx = kThreads - dr * W;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v;
    int code;
    resample(s + r * W, 1, W, c[i], v, code);
    out[base + i] = encode(v, code);
    step(r, x, W, dr, dx);
  }
}

// Pass Y, along H, in place: a block takes whole H-columns of `cols`
// consecutive W positions of plane (blockIdx.y, d).
__global__ void __launch_bounds__(kThreads)
    sep_warp_y_kernel(int16_t* t, const float* __restrict__ fy, long long fy_bstride, int D,
                      int H, int W, int cols) {
  extern __shared__ float c[];  // H x cols coordinates, then H x cols quanta
  int16_t* s = reinterpret_cast<int16_t*>(c + H * cols);
  const int tiles = (W + cols - 1) / cols;
  const int d = blockIdx.x / tiles;
  const int w0 = (blockIdx.x - d * tiles) * cols;
  const int nc = min(cols, W - w0);
  const int b = blockIdx.y;
  const long long HW = static_cast<long long>(H) * W;
  int16_t* plane = t + (static_cast<long long>(b) * D + d) * HW + w0;
  const float* f = fy + b * fy_bstride + d * HW + w0;
  const int n = H * nc;
  const int dh = kThreads / nc, dj = kThreads - dh * nc;
  int h = threadIdx.x / nc, j = threadIdx.x - h * nc;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s[h * cols + j] = plane[h * W + j];
    c[h * cols + j] = unnormalize(f[h * W + j], H);
    step(h, j, nc, dh, dj);
  }
  __syncthreads();
  h = threadIdx.x / nc;
  j = threadIdx.x - h * nc;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v;
    int code;
    resample(s + j, cols, H, c[h * cols + j], v, code);
    plane[h * W + j] = encode(v, code);
    step(h, j, nc, dh, dj);
  }
}

// Pass Z, along D: a block takes whole D-columns of `cols` consecutive
// positions of the (H, W) plane of sample blockIdx.y, and writes the image
// times the scale and the two labels.
__global__ void __launch_bounds__(kThreads)
    sep_warp_z_kernel(const int16_t* __restrict__ t, const float* __restrict__ fz,
                      long long fz_bstride, const float* __restrict__ scale,
                      float* __restrict__ img, int32_t* __restrict__ lbl,
                      int32_t* __restrict__ mod, int D, int HW, int cols) {
  extern __shared__ float c[];  // D x cols coordinates, then D x cols quanta
  int16_t* s = reinterpret_cast<int16_t*>(c + D * cols);
  const int p0 = blockIdx.x * cols;
  const int nc = min(cols, HW - p0);
  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * D * HW + p0;
  const float* f = fz + b * fz_bstride + p0;
  const float sc = fmaxf(scale[b], 1e-12f);  // clamp(min=1e-12) of the plain version
  const int n = D * nc;
  const int dd = kThreads / nc, dj = kThreads - dd * nc;
  int d = threadIdx.x / nc, j = threadIdx.x - d * nc;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long o = static_cast<long long>(d) * HW + j;
    s[d * cols + j] = t[base + o];
    c[d * cols + j] = unnormalize(f[o], D);
    step(d, j, nc, dd, dj);
  }
  __syncthreads();
  d = threadIdx.x / nc;
  j = threadIdx.x - d * nc;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v;
    int code;
    resample(s + j, cols, D, c[d * cols + j], v, code);
    const long long o = base + static_cast<long long>(d) * HW + j;
    img[o] = __fmul_rn(v, sc);
    lbl[o] = code & 1;
    mod[o] = code >> 1;
    step(d, j, nc, dd, dj);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// img: (B, D, H, W) f32; lbl, mod: int32 binary labels; fx, fy, fz: f32
// normalized coordinate fields, each dense within a sample, samples
// *_bstride elements apart; scale: (B,) f32 absmax / 2047, floored at
// 1e-12 here; tmp: (B, D, H, W) int16
// scratch; out_img f32, out_lbl and out_mod int32, (B, D, H, W). The plan:
// pass X takes rows_x W-rows a block, pass Y cols_y W positions, pass Z
// cols_z plane positions.
extern "C" int sw_apply(const void* img, const void* lbl, const void* mod, const void* fx,
                        const void* fy, const void* fz, long long fx_bstride,
                        long long fy_bstride, long long fz_bstride, const void* scale,
                        void* tmp, void* out_img, void* out_lbl, void* out_mod, int B, int D,
                        int H, int W, int rows_x, int cols_y, int cols_z, void* stream) {
  (void)cudaGetLastError();  // report this call's error, not an earlier one
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const long long DH = static_cast<long long>(D) * H, HW = static_cast<long long>(H) * W;
  // A tile holds a float coordinate and an int16 quantum a position.
  const long long smem_x = 6LL * rows_x * W;
  const long long smem_y = 6LL * H * cols_y;
  const long long smem_z = 6LL * D * cols_z;
  if (DH * W > INT_MAX || B > 65535 || rows_x < 1 || rows_x > DH || cols_y < 1 ||
      cols_y > W || cols_z < 1 || cols_z > HW || smem_x > kMaxSmem || smem_y > kMaxSmem ||
      smem_z > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = allow_smem(sep_warp_x_kernel, smem_x)) != cudaSuccess ||
      (err = allow_smem(sep_warp_y_kernel, smem_y)) != cudaSuccess ||
      (err = allow_smem(sep_warp_z_kernel, smem_z)) != cudaSuccess)
    return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<int16_t*>(tmp);
  const auto* sc = static_cast<const float*>(scale);

  const dim3 grid_x(static_cast<unsigned>((DH + rows_x - 1) / rows_x), B);
  sep_warp_x_kernel<<<grid_x, kThreads, smem_x, st>>>(
      static_cast<const float*>(img), static_cast<const int32_t*>(lbl),
      static_cast<const int32_t*>(mod), static_cast<const float*>(fx), fx_bstride, sc, t,
      static_cast<int>(DH), W, rows_x);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_y(static_cast<unsigned>(D * ((W + cols_y - 1) / cols_y)), B);
  sep_warp_y_kernel<<<grid_y, kThreads, smem_y, st>>>(t, static_cast<const float*>(fy),
                                                       fy_bstride, D, H, W, cols_y);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_z(static_cast<unsigned>((HW + cols_z - 1) / cols_z), B);
  sep_warp_z_kernel<<<grid_z, kThreads, smem_z, st>>>(
      t, static_cast<const float*>(fz), fz_bstride, sc, static_cast<float*>(out_img),
      static_cast<int32_t*>(out_lbl), static_cast<int32_t*>(out_mod), D, static_cast<int>(HW),
      cols_z);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
