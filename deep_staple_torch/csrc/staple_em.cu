// The fused STAPLE EM iteration (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces deep_staple_tpu/consensus/staple_pallas.py::_em_iter_kernel (body
// :44-73, pallas_call :90). For every case c of a batch, at fixed coef[c, r]
// and base[c], over the case's decisions d[c] (R raters x V voxels, uint8,
// rater-major, contiguous):
//
//   t_j  = base + sum_r coef_r * d_rj
//   w_j  = sigmoid(t_j)
//   wd_r = sum_j d_rj * w_j,   ws = sum_j w_j        (all float32)
//
// What bounds it: bytes. One pass reads R * V bytes of decisions and does
// about 4 * R * V operations: at R = 30 and V = 256 * 256 * 100 that is
// 196.6 MB, 0.059 ms at 3.35 TB/s, against 0.012 ms of float32 operations.
//
// What the design does about it: D is read once a pass, as bytes (0/1 is
// exact in uint8: a quarter of float32, half of the TPU kernel's bfloat16),
// with no padding and no copy. The grid is (blocks, C); block b takes the
// tiles b, b + blocks, ... of kTile voxels, so the blocks running at one time
// read one contiguous run of each rater row. Per tile the block stages R x
// kTile bytes of D in shared memory (32 KB at R = 128), 16 bytes a thread
// where the rows are 16-byte aligned (V % 16 == 0, as at full size), else a
// byte a thread; every load of the tile is in flight at once. Then thread j
// sums coef_r * d_rj over the raters in order and takes w_j (the E-step).
// Then warp k takes the rows k, k + 8, ... (row R stands for the w sum) and
// adds d_rj * w_j of the tile into one register a row (the M-step). At the
// block's end each row's lanes are reduced by shuffles in a fixed order, and
// the block writes one float32 row of R + 1 partial sums. A second kernel
// sums each (c, r) over the blocks in a fixed order. There are no atomics:
// the same inputs give the same sums on every run, so the EM loop's stop
// test (delta > epsilon, sensitive at 1e-7) sees the same numbers.
//
// Cases whose flag in `active` is 0 are skipped (their EM has stopped); their
// sums are left as they were. The E-only form writes w (C, V) for the
// posterior from the final sensitivities and specificities.
//
// Plain C interface, loaded with ctypes; every size and offset is 64-bit
// (C * R * V reaches 786 M at 4 x 30 x 256 * 256 * 100). Each function
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 256;  // voxels of a tile = threads of a block
constexpr int kWarps = kTile / 32;
constexpr int kMaxR = 128;
constexpr int kRowsPerWarp = (kMaxR + 1 + kWarps - 1) / kWarps;  // rows 0..R over 8 warps
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float byte_at(uint32_t word, int i) {
  return static_cast<float>((word >> (8 * i)) & 0xFFu);
}

// Stage tile t of case c's rows in s_d (R rows of kTile bytes), zeros past V.
template <bool kAligned>
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ dc, uint8_t* s_d, int R,
                                           int64_t V, int64_t t) {
  const int64_t v0 = t * kTile;
  if (kAligned) {  // V % 16 == 0: a 16-byte piece lies wholly before V or after it
    constexpr int kPieces = kTile / 16;
#pragma unroll 4
    for (int k = threadIdx.x; k < R * kPieces; k += kTile) {
      const int r = k / kPieces;
      const int col = (k % kPieces) * 16;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (v0 + col < V) x = *reinterpret_cast<const uint4*>(dc + static_cast<int64_t>(r) * V + v0 + col);
      *reinterpret_cast<uint4*>(s_d + r * kTile + col) = x;
    }
  } else {
    const int64_t v = v0 + threadIdx.x;
#pragma unroll 8
    for (int r = 0; r < R; ++r)
      s_d[r * kTile + threadIdx.x] = v < V ? dc[static_cast<int64_t>(r) * V + v] : 0;
  }
}

// kPosterior: write w (C, V) and nothing else. Otherwise write partial
// (C, gridDim.x, R + 1): per block, wd_0 .. wd_{R-1} and ws.
template <bool kPosterior, bool kAligned>
__global__ void __launch_bounds__(kTile) staple_em_kernel(
    const uint8_t* __restrict__ d, const float* __restrict__ coef,
    const float* __restrict__ base, const uint8_t* __restrict__ active,
    float* __restrict__ out, int R, int64_t V) {
  const int c = blockIdx.y;
  if (!kPosterior && !active[c]) return;  // uniform over the block
  extern __shared__ __align__(16) uint8_t s_d[];  // R rows of kTile bytes
  __shared__ __align__(16) float s_w[kTile];
  __shared__ float s_coef[kMaxR];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r = tid; r < R; r += kTile) s_coef[r] = coef[static_cast<int64_t>(c) * R + r];
  const float b = base[c];
  const uint8_t* dc = d + static_cast<int64_t>(c) * R * V;
  const int64_t ntiles = (V + kTile - 1) / kTile;

  float acc[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) acc[k] = 0.f;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    stage_tile<kAligned>(dc, s_d, R, V, t);
    __syncthreads();
    // E-step: t_j = base + sum_r coef_r d_rj, the raters in order.
    const int64_t v = t * kTile + tid;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < R; ++r) s = fmaf(s_coef[r], static_cast<float>(s_d[r * kTile + tid]), s);
    const float w = v < V ? 1.f / (1.f + expf(-(b + s))) : 0.f;
    if (kPosterior) {
      if (v < V) out[static_cast<int64_t>(c) * V + v] = w;
      __syncthreads();  // s_d is refilled by the next tile
      continue;
    }
    s_w[tid] = w;
    __syncthreads();
    // M-step: lane l holds the tile's voxels 8l .. 8l + 7.
    const float4 wa = *reinterpret_cast<const float4*>(&s_w[lane * 8]);
    const float4 wb = *reinterpret_cast<const float4*>(&s_w[lane * 8 + 4]);
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int r = warp + k * kWarps;
      if (r < R) {
        const uint2 q = *reinterpret_cast<const uint2*>(&s_d[r * kTile + lane * 8]);
        float part = byte_at(q.x, 0) * wa.x;
        part = fmaf(byte_at(q.x, 1), wa.y, part);
        part = fmaf(byte_at(q.x, 2), wa.z, part);
        part = fmaf(byte_at(q.x, 3), wa.w, part);
        part = fmaf(byte_at(q.y, 0), wb.x, part);
        part = fmaf(byte_at(q.y, 1), wb.y, part);
        part = fmaf(byte_at(q.y, 2), wb.z, part);
        part = fmaf(byte_at(q.y, 3), wb.w, part);
        acc[k] += part;
      } else if (r == R) {
        acc[k] += ((wa.x + wa.y) + (wa.z + wa.w)) + ((wb.x + wb.y) + (wb.z + wb.w));
      }
    }
    __syncthreads();  // s_d and s_w are refilled by the next tile
  }
  if (kPosterior) return;
  float* row = out + (static_cast<int64_t>(c) * gridDim.x + blockIdx.x) * (R + 1);
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps;
    if (r <= R) {
      float v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) row[r] = v;
    }
  }
}

// sums[c, r] = sum over blocks of partial[c, block, r], in a fixed order:
// each thread its strided blocks in turn, then a tree over the threads.
__global__ void __launch_bounds__(kReduceThreads) staple_reduce_kernel(
    const float* __restrict__ partial, const uint8_t* __restrict__ active,
    float* __restrict__ sums, int R, int64_t nblk) {
  const int r = blockIdx.x;
  const int c = blockIdx.y;
  if (!active[c]) return;
  __shared__ float s[kReduceThreads];
  float v = 0.f;
  for (int64_t k = threadIdx.x; k < nblk; k += kReduceThreads)
    v += partial[(static_cast<int64_t>(c) * nblk + k) * (R + 1) + r];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[static_cast<int64_t>(c) * (R + 1) + r] = s[0];
}

int check_sizes(long long C, long long R, long long V, long long nblk) {
  if (C <= 0 || R <= 0 || V <= 0 || nblk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R > kMaxR || C > 65535 || nblk > INT_MAX || nblk > (V + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(cudaSuccess);
}

// One of the four forms of the kernel: posterior or not, aligned rows or not.
template <bool kPosterior>
void launch_em(const void* d, const void* coef, const void* base, const void* active, void* out,
               long long C, long long R, long long V, long long nblk, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(C));
  const size_t smem = static_cast<size_t>(R) * kTile;
  const bool aligned = V % 16 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  auto kernel = aligned ? &staple_em_kernel<kPosterior, true> : &staple_em_kernel<kPosterior, false>;
  kernel<<<grid, kTile, smem, s>>>(static_cast<const uint8_t*>(d), static_cast<const float*>(coef),
                                   static_cast<const float*>(base),
                                   static_cast<const uint8_t*>(active), static_cast<float*>(out),
                                   static_cast<int>(R), V);
}

}  // namespace

// One EM pass for every active case. d: (C, R, V) uint8; coef: (C, R) f32;
// base: (C,) f32; active: (C,) uint8; partial: (C, nblk, R + 1) f32 scratch;
// sums: (C, R + 1) f32, wd in columns 0..R-1 and ws in column R. nblk blocks
// a case share its tiles of 256 voxels.
extern "C" int staple_em_iter(const void* d, const void* coef, const void* base,
                              const void* active, void* partial, void* sums, long long C,
                              long long R, long long V, long long nblk, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  const int bad = check_sizes(C, R, V, nblk);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_em<false>(d, coef, base, active, partial, C, R, V, nblk, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  staple_reduce_kernel<<<dim3(static_cast<unsigned>(R + 1), static_cast<unsigned>(C)),
                         kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const uint8_t*>(active),
      static_cast<float*>(sums), static_cast<int>(R), nblk);
  return static_cast<int>(cudaGetLastError());
}

// The E-step alone: w (C, V) f32 = sigmoid(base + coef . d) for every case.
extern "C" int staple_posterior(const void* d, const void* coef, const void* base, void* w,
                                long long C, long long R, long long V, long long nblk,
                                void* stream) {
  (void)cudaGetLastError();
  const int bad = check_sizes(C, R, V, nblk);
  if (bad) return bad;
  launch_em<true>(d, coef, base, nullptr, w, C, R, V, nblk, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* staple_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
