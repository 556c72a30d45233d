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
// The bytes arrive only as fast as enough of them are in flight, and each
// byte costs the SM a few instructions twice (the E-step and the M-step), so
// the design keeps tens of KB of loads in flight on every SM and spends as
// few instructions a byte as it can.
//
// The design (`StapleTile` names every size; `tile_plan` in
// consensus/staple_fused.py mirrors it):
//   * A tile is `tile` voxels of every rater row: 1,024 at R <= 32 (at most
//     32 KB), 256 above. Block b of case c walks the tiles b, b + nblk, ...;
//     nblk is a function of (C, R) and V: one wave of the blocks an SM holds
//     over 132 SMs. Each of its 8 warps takes its own slice of each tile (128
//     voxels of every row; 32 at R > 32) through its own ring of `stages`
//     slices in shared memory, filled by 16-byte cp.async.cg where the rows
//     are 16-byte aligned (V % 16 == 0, as at full size; src-size 0 past V),
//     else by byte loads. A warp waits only for its own copies (cp.async
//     wait, then __syncwarp): no block barrier in the loop.
//   * At R <= 32 a thread owns 4 consecutive voxels of a slice and reads
//     one 32-bit word of each rater row (one shared load for 4 voxels). The
//     form is compiled for R rounded up to even (an odd R's last row is
//     zeros with coef 0): with the row count known, no branch splits the
//     rows, and the R + 1 sums stay in registers. A runtime row count cost
//     20-25% (one basic block a row). Up to 16 rows the words stay in
//     registers from the E-step to the M-step; above, they are read again.
//     At R > 32 a thread owns one voxel and keeps its R + 1 sums in its own
//     column of shared memory.
//   * A byte becomes a float without I2F: __byte_perm puts it into the
//     mantissa of 2^23 and one FADD takes 2^23 away, exact for 0..255. The
//     four sigmoids of a thread are computed without a branch and masked past
//     V by an exact 0 / 1 factor.
//   * At its end a block reduces each sum over its threads (shuffles in a
//     fixed tree, then its 8 warps in order) into one row of partials; the
//     last block of a case to finish (an integer ticket) sums the partials
//     of every block in the order of the block index and resets the ticket.
//     No float atomics: the same inputs give the same sums on every run, so
//     the EM loop's stop test (delta > epsilon, sensitive at 1e-7) sees the
//     same numbers.
//
// What still bounds it: the SM's issue. A decision byte costs about 6
// instructions (PRMT, FADD and FFMA in the E-step and again in the M-step),
// a voxel its sigmoid; the HBM rate is not reached.
//
// Cases whose flag in `active` is 0 are skipped (their EM has stopped); their
// sums are left as they were. The E-only form writes w (C, V) for the
// posterior from the final sensitivities and specificities.
//
// Above 128 raters (kChunk) the single-pass forms would need shared memory
// that grows with R (the R > 32 form keeps R + 1 sums a thread there), so a
// chunked form takes over; the Pallas original stops at 128. Its three
// kernels, each with shared memory of a fixed size:
//   * staple_logit_chunk_kernel: block (x, k, c) sums coef_r d_rj over chunk
//     k's rows (at most 128, in order) for 1,024 voxels, 4 a thread, into a
//     (C, chunks, V) float32 scratch;
//   * staple_sigmoid_chunk_kernel: w_j = sigmoid(base + the chunks' sums in
//     chunk order), into a (C, V) scratch, or into w for the E-only form;
//   * staple_mstep_chunk_kernel: block (b, k, c) walks the 128-voxel tiles
//     b, b + nblk, ...; each warp owns 16 of chunk k's rows (a lane 4
//     voxels of each, one 32-bit load a row) and the block writes a partial
//     of each row; the last block of a case (an integer ticket over its
//     nblk x chunks blocks) sums the partials in block order: a warp a row
//     as above, or a thread a row where nblk < 32 (at R in the thousands
//     a warp a row leaves that one block latency-bound, row after row).
// The sums keep a fixed order, so a pass repeats bit for bit. It reads the
// decisions twice (the E-step and the M-step), where the single-pass forms
// read them once: simple first, not yet made fast.
//
// Plain C interface, loaded with ctypes; every size and offset is 64-bit
// (C * R * V reaches 786 M at 4 x 30 x 256 * 256 * 100). Each function
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // the most raters of a single-pass form; the rows of a chunk above
constexpr int kSMs = 132;  // of an H100 SXM: the plan is a function of the shape, not of the card
// The chunked form (R > kChunk): a lane takes 4 voxels, a warp 16 rows of a chunk.
constexpr int kChunkTile = 128;          // voxels of an M-step tile: 32 lanes x 4
constexpr int kChunkBlocksPerSm = 4;     // the M-step's planned residency
constexpr int kRowsPerWarp = kChunk / kWarps;

// The tiling of one form of the kernel, chosen by R: `rows` rows of
// decisions a thread holds in registers, R rounded up to even (an odd R's
// last row is zeros with coef 0); 0 for the shared-memory accumulators of
// R > 32.
template <int kRows>
struct StapleTile {
  static constexpr int tile = kRows ? 1024 : 256;  // voxels of a row a stage holds
  static constexpr int vpt = tile / kThreads;      // voxels a thread owns in a tile
  // Measured on the card: up to 16 rows, 2 blocks an SM at 88 registers
  // beat 3 at 80; above, 3 blocks of 2 stages beat 2 of 3.
  static constexpr int stages = kRows == 0 ? 2 : kRows <= 16 ? 4 : 2;
  static constexpr int blocks_per_sm = kRows == 0 ? 1 : kRows <= 16 ? 2 : 3;
  static constexpr long long smem(long long R) {  // dynamic shared bytes a block
    return kRows ? stages * kRows * tile : stages * R * tile + (R + 1) * kThreads * 4;
  }
};

struct Plan {
  int rows, tile, stages, blocks_per_sm;
  long long ntiles, nblk, smem, chunks;  // chunks: rater chunks, 1 for a single-pass form
};

template <int kRows>
Plan plan_of(long long C, long long R, long long V) {
  using T = StapleTile<kRows>;
  Plan p{kRows, T::tile, T::stages, T::blocks_per_sm, (V + T::tile - 1) / T::tile, 0, T::smem(R), 1};
  const long long wave = (static_cast<long long>(kSMs) * T::blocks_per_sm + C - 1) / C;
  p.nblk = p.ntiles < wave ? p.ntiles : wave;
  return p;
}

// The chunked form's plan: M-step tiles of kChunkTile voxels, one wave of
// kChunkBlocksPerSm blocks an SM over every (case, chunk); no dynamic
// shared memory.
Plan plan_chunked(long long C, long long R, long long V) {
  const long long chunks = (R + kChunk - 1) / kChunk;
  Plan p{0, kChunkTile, 0, kChunkBlocksPerSm, (V + kChunkTile - 1) / kChunkTile, 0, 0, chunks};
  const long long wave = (static_cast<long long>(kSMs) * kChunkBlocksPerSm + C * chunks - 1) / (C * chunks);
  p.nblk = p.ntiles < wave ? p.ntiles : wave;
  return p;
}

// The forms of the kernel: one for each even row count up to 32, one above.
#define K4_FORMS(F) F(2) F(4) F(6) F(8) F(10) F(12) F(14) F(16) F(18) F(20) F(22) F(24) \
  F(26) F(28) F(30) F(32)

Plan plan(long long C, long long R, long long V) {
  if (R > kChunk) return plan_chunked(C, R, V);
  switch (R + (R & 1)) {
#define K4_PLAN(n) case n: return plan_of<n>(C, R, V);
    K4_FORMS(K4_PLAN)
#undef K4_PLAN
    default: return plan_of<0>(C, R, V);
  }
}

// Byte k of `word` as a float, exactly: 0x4B0000bb is the float 2^23 + bb.
__device__ __forceinline__ float byte_f(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7650u + k)) - 8388608.f;
}

__device__ __forceinline__ float sigmoid(float t) { return 1.f / (1.f + expf(-t)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start copying this warp's slice of tile t of case c (kRows rows of
// kSlice bytes from voxel v0; rows from R on and voxels from V on are
// zeros) into its stage st. The warp's lanes share the copies; a lane reads
// bytes another lane copied, hence the __syncwarp() after the wait. kRows =
// 0: R rows.
template <int kRows, int kSlice>
__device__ __forceinline__ void load_slice(const uint8_t* __restrict__ dc, uint8_t* st, int R,
                                           int64_t V, int64_t v0, int lane, bool aligned) {
  const int rows = kRows ? kRows : R;
  if (aligned) {  // V % 16 == 0: a 16-byte piece lies wholly before V or after it
    constexpr int kPieces = kSlice / 16;
#pragma unroll 1  // unrolled, ptxas keeps every piece's address live and the 30-row form spills
    for (int k = lane; k < rows * kPieces; k += 32) {
      const int r = k / kPieces;
      const int col = (k % kPieces) * 16;
      const int64_t v = v0 + col;
      const bool in = v < V && r < R;
      cp_async16(st + r * kSlice + col, in ? dc + static_cast<int64_t>(r) * V + v : dc, in ? 16 : 0);
    }
  } else {
    for (int k = lane; k < rows * kSlice; k += 32) {
      const int r = k / kSlice;
      const int64_t v = v0 + k % kSlice;
      st[k] = v < V && r < R ? dc[static_cast<int64_t>(r) * V + v] : 0;
    }
  }
}

// Sum v over the 32 lanes of a warp in a fixed tree; lane 0 holds the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// kPosterior: write w (C, V) and nothing else. Otherwise write partial
// (C, R + 1, nblk) (per block, wd_0 .. wd_{R-1} and ws) and, from the last
// block of each case, sums (C, R + 1).
template <int kRows, bool kPosterior>
__global__ void __launch_bounds__(kThreads, StapleTile<kRows>::blocks_per_sm) staple_em_kernel(
    const uint8_t* __restrict__ d, const float* __restrict__ coef,
    const float* __restrict__ base, const uint8_t* __restrict__ active, float* __restrict__ w_out,
    float* __restrict__ partial, unsigned* __restrict__ tickets, float* __restrict__ sums, int R,
    int64_t V, int64_t nblk, bool aligned) {
  using T = StapleTile<kRows>;
  constexpr int kTile = T::tile;
  constexpr int kStages = T::stages;
  const int c = blockIdx.y;
  if (!kPosterior && !active[c]) return;  // uniform over the case
  constexpr int kSlice = kTile / kWarps;  // voxels of a row a warp takes from each tile
  const int rows = kRows ? kRows : R;  // rows of a stage
  extern __shared__ __align__(16) uint8_t s_ring[];  // kWarps x kStages x rows x kSlice bytes
  float* s_acc = reinterpret_cast<float*>(s_ring + kStages * rows * kTile);  // R > 32: (R + 1) x kThreads
  __shared__ float s_coef[kChunk];
  __shared__ float s_red[kWarps][kChunk + 1];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint8_t* ring = s_ring + warp * kStages * rows * kSlice;  // this warp's own ring
  const uint8_t* dc = d + static_cast<int64_t>(c) * R * V;
  const int64_t ntiles = (V + kTile - 1) / kTile;
  const int64_t mine = (ntiles - blockIdx.x + nblk - 1) / nblk;  // >= 1: blockIdx.x < nblk <= ntiles
  // Voxel v of a tile's slice: (blockIdx.x + i * nblk) * kTile + warp * kSlice + ...
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile + warp * kSlice;
  const int64_t step = nblk * kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // the first copies go out before anything waits
    if (s < mine)
      load_slice<kRows, kSlice>(dc, ring + s * rows * kSlice, R, V, first + s * step, lane, aligned);
    cp_async_commit();  // a group a stage, empty or not, so the wait below counts stages
  }
  for (int r = tid; r < rows; r += kThreads) s_coef[r] = r < R ? coef[static_cast<int64_t>(c) * R + r] : 0.f;
  if (!kRows && !kPosterior)
    for (int k = tid; k < (R + 1) * kThreads; k += kThreads) s_acc[k] = 0.f;
  __syncthreads();  // s_coef and s_acc are set; from here each warp walks its tiles alone
  const float b = base[c];

  float acc[kRows ? kRows + 1 : 1];
#pragma unroll
  for (int r = 0; r < (kRows ? kRows + 1 : 1); ++r) acc[r] = 0.f;

  for (int64_t i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // slice i is in; every lane is done with slice i - 1, whose stage refills now
    const int64_t ahead = i + kStages - 1;
    if (ahead < mine)
      load_slice<kRows, kSlice>(dc, ring + (ahead % kStages) * rows * kSlice, R, V,
                                first + ahead * step, lane, aligned);
    cp_async_commit();
    const uint8_t* st = ring + (i % kStages) * rows * kSlice;
    const int64_t v = first + i * step + lane * T::vpt;  // this thread's first voxel

    if constexpr (kRows != 0) {
      // E-step: t_j = base + sum_r coef_r d_rj, the raters in order; 4 voxels
      // a word. The row count is known here: no branch splits the rows, so
      // ptxas interleaves them. A zero row adds exact zeros.
      const uint8_t* col = st + lane * 4;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(col + r * kSlice);
        const float cr = s_coef[r];
        s0 = fmaf(cr, byte_f(word, 0), s0);
        s1 = fmaf(cr, byte_f(word, 1), s1);
        s2 = fmaf(cr, byte_f(word, 2), s2);
        s3 = fmaf(cr, byte_f(word, 3), s3);
      }
      // The four sigmoids without a branch (zeros past V give a finite t);
      // voxels past V are masked by an exact 0 / 1 factor.
      const float w0 = sigmoid(b + s0) * (v < V ? 1.f : 0.f);
      const float w1 = sigmoid(b + s1) * (v + 1 < V ? 1.f : 0.f);
      const float w2 = sigmoid(b + s2) * (v + 2 < V ? 1.f : 0.f);
      const float w3 = sigmoid(b + s3) * (v + 3 < V ? 1.f : 0.f);
      if constexpr (kPosterior) {
        float* wc = w_out + static_cast<int64_t>(c) * V;
        if ((V & 3) == 0 && v + 3 < V) {
          *reinterpret_cast<float4*>(wc + v) = make_float4(w0, w1, w2, w3);
        } else {
          if (v < V) wc[v] = w0;
          if (v + 1 < V) wc[v + 1] = w1;
          if (v + 2 < V) wc[v + 2] = w2;
          if (v + 3 < V) wc[v + 3] = w3;
        }
      } else {
        // M-step: wd_r += sum of this thread's 4 voxels d_rj w_j. Up to 16
        // rows the compiler keeps the E-step's words in registers. Above, it
        // would too, and 30 words with 31 sums spill at 128 registers: there
        // the __syncwarp() orders shared memory, so each word is read again.
        if constexpr (kRows > 16) __syncwarp();
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(col + r * kSlice);
          float part = byte_f(word, 0) * w0;
          part = fmaf(byte_f(word, 1), w1, part);
          part = fmaf(byte_f(word, 2), w2, part);
          part = fmaf(byte_f(word, 3), w3, part);
          acc[r] += part;
        }
        acc[kRows] += (w0 + w1) + (w2 + w3);
      }
    } else {
      // R > 32: one voxel a thread, its accumulators in its column of s_acc.
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = fmaf(s_coef[r], byte_f(st[r * kSlice + lane], 0), s);
      const float w = sigmoid(b + s) * (v < V ? 1.f : 0.f);
      if constexpr (kPosterior) {
        if (v < V) w_out[static_cast<int64_t>(c) * V + v] = w;
      } else {
        for (int r = 0; r < R; ++r) s_acc[r * kThreads + tid] += byte_f(st[r * kSlice + lane], 0) * w;
        s_acc[R * kThreads + tid] += w;
      }
    }
  }
  if constexpr (kPosterior) return;

  // The block's sums: each row over the threads in a fixed order, into
  // partial[c, r, blockIdx.x].
  float* part_c = partial + static_cast<int64_t>(c) * (R + 1) * nblk;
  if constexpr (kRows != 0) {
#pragma unroll
    for (int r = 0; r <= kRows; ++r) {
      const int row = r == kRows ? R : r;  // the w sum is row R
      if (r < R || r == kRows) {
        const float x = warp_sum(acc[r]);
        if (lane == 0) s_red[warp][row] = x;
      }
    }
    __syncthreads();
    for (int r = tid; r <= R; r += kThreads) {
      float x = s_red[0][r];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) x += s_red[k][r];
      part_c[r * nblk + blockIdx.x] = x;
    }
  } else {
    __syncthreads();
    for (int r = warp; r <= R; r += kWarps) {
      float x = 0.f;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) x += s_acc[r * kThreads + k * 32 + lane];
      x = warp_sum(x);
      if (lane == 0) part_c[r * nblk + blockIdx.x] = x;
    }
  }

  // The last block of the case sums the partials over the blocks in order.
  __threadfence();  // this thread's partials are visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[c], 1u) == static_cast<unsigned>(nblk - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int r = warp; r <= R; r += kWarps) {
    const float* row = part_c + r * nblk;
    float x = 0.f;
#pragma unroll 8  // the loads go out together; the adds keep their order
    for (int64_t k = lane; k < nblk; k += 32) x += __ldcg(row + k);
    x = warp_sum(x);
    if (lane == 0) sums[static_cast<int64_t>(c) * (R + 1) + r] = x;
  }
  if (tid == 0) tickets[c] = 0u;  // ready for the next pass on this stream
}

// ---------------------------------------------------------------- R > kChunk

// Bytes v .. v + 3 of a rater row as one word, byte k = voxel v + k; zeros
// from V on. `aligned`: V % 4 == 0 and the row starts on 4 bytes.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ row, int64_t v, int64_t V,
                                              bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const uint32_t*>(row + v));  // v < V, so v + 3 < V
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (v + k < V) word |= static_cast<uint32_t>(__ldg(row + v + k)) << (8 * k);
  return word;
}

// Floats v .. v + 3 of a row (zeros from V on), and their store.
__device__ __forceinline__ float4 load_f4(const float* __restrict__ row, int64_t v, int64_t V,
                                          bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(row + v));
  float x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = v + k < V ? __ldg(row + v + k) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store_f4(float* __restrict__ row, int64_t v, int64_t V, float4 x,
                                         bool aligned) {
  if (aligned) {
    *reinterpret_cast<float4*>(row + v) = x;
  } else {
    if (v < V) row[v] = x.x;
    if (v + 1 < V) row[v + 1] = x.y;
    if (v + 2 < V) row[v + 2] = x.z;
    if (v + 3 < V) row[v + 3] = x.w;
  }
}

// tpart[c, k, j] = sum of coef_r d_rj over chunk k's rows, in row order.
// Grid (ceil(V / 1,024), chunks, C). active null: every case (E-only form).
__global__ void __launch_bounds__(kThreads) staple_logit_chunk_kernel(
    const uint8_t* __restrict__ d, const float* __restrict__ coef,
    const uint8_t* __restrict__ active, float* __restrict__ tpart, int R, int64_t V, bool aligned) {
  const int c = blockIdx.z;
  const int k = blockIdx.y;
  if (active != nullptr && !active[c]) return;  // uniform over the case
  __shared__ float s_coef[kChunk];
  const int r0 = k * kChunk;
  const int nr = min(kChunk, R - r0);
  for (int r = threadIdx.x; r < nr; r += kThreads) s_coef[r] = coef[static_cast<int64_t>(c) * R + r0 + r];
  __syncthreads();
  const int64_t v = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (v >= V) return;
  const uint8_t* row = d + (static_cast<int64_t>(c) * R + r0) * V;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
  for (int r = 0; r < nr; ++r) {
    const uint32_t word = load_word(row + static_cast<int64_t>(r) * V, v, V, aligned);
    const float cr = s_coef[r];
    s0 = fmaf(cr, byte_f(word, 0), s0);
    s1 = fmaf(cr, byte_f(word, 1), s1);
    s2 = fmaf(cr, byte_f(word, 2), s2);
    s3 = fmaf(cr, byte_f(word, 3), s3);
  }
  store_f4(tpart + (static_cast<int64_t>(c) * gridDim.y + k) * V, v, V, make_float4(s0, s1, s2, s3),
           aligned);
}

// w[c, j] = sigmoid(base_c + the chunks' sums in chunk order). Grid
// (ceil(V / 1,024), C).
__global__ void __launch_bounds__(kThreads) staple_sigmoid_chunk_kernel(
    const float* __restrict__ tpart, const float* __restrict__ base,
    const uint8_t* __restrict__ active, float* __restrict__ w, int chunks, int64_t V, bool aligned) {
  const int c = blockIdx.y;
  if (active != nullptr && !active[c]) return;
  const int64_t v = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (v >= V) return;
  const float* tp = tpart + static_cast<int64_t>(c) * chunks * V;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < chunks; ++k) {
    const float4 x = load_f4(tp + static_cast<int64_t>(k) * V, v, V, aligned);
    t.x += x.x;
    t.y += x.y;
    t.z += x.z;
    t.w += x.w;
  }
  const float b = base[c];
  store_f4(w + static_cast<int64_t>(c) * V, v, V,
           make_float4(sigmoid(b + t.x), sigmoid(b + t.y), sigmoid(b + t.z), sigmoid(b + t.w)),
           aligned);
}

// The M-step: partial[c, r, b] = block b's sum of d_rj w_j over its tiles,
// partial[c, R, b] its sum of w_j (chunk 0's blocks); the last block of a
// case sums each row of partials in block order into sums[c, r]. Grid
// (nblk, chunks, C).
__global__ void __launch_bounds__(kThreads, kChunkBlocksPerSm) staple_mstep_chunk_kernel(
    const uint8_t* __restrict__ d, const float* __restrict__ w, const uint8_t* __restrict__ active,
    float* __restrict__ partial, unsigned* __restrict__ tickets, float* __restrict__ sums, int R,
    int64_t V, int64_t nblk, bool aligned) {
  const int c = blockIdx.z;
  const int k = blockIdx.y;
  if (!active[c]) return;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = k * kChunk;
  const int nr = min(kChunk, R - r0);
  const uint8_t* dc = d + (static_cast<int64_t>(c) * R + r0) * V;
  const float* wc = w + static_cast<int64_t>(c) * V;
  const int64_t ntiles = (V + kChunkTile - 1) / kChunkTile;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) acc[j] = 0.f;
  float acc_w = 0.f;
  for (int64_t i = blockIdx.x; i < ntiles; i += nblk) {
    const int64_t v = i * kChunkTile + lane * 4;
    const float4 wv = v < V ? load_f4(wc, v, V, aligned) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc_w += (wv.x + wv.y) + (wv.z + wv.w);
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;  // uniform over the warp
      if (r < nr) {
        const uint32_t word = v < V ? load_word(dc + static_cast<int64_t>(r) * V, v, V, aligned) : 0u;
        float part = byte_f(word, 0) * wv.x;
        part = fmaf(byte_f(word, 1), wv.y, part);
        part = fmaf(byte_f(word, 2), wv.z, part);
        part = fmaf(byte_f(word, 3), wv.w, part);
        acc[j] += part;
      }
    }
  }
  float* part_c = partial + static_cast<int64_t>(c) * (R + 1) * nblk;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + j * kWarps;
    if (r < nr) {
      const float x = warp_sum(acc[j]);
      if (lane == 0) part_c[static_cast<int64_t>(r0 + r) * nblk + blockIdx.x] = x;
    }
  }
  if (k == 0 && warp == 0) {
    const float x = warp_sum(acc_w);
    if (lane == 0) part_c[static_cast<int64_t>(R) * nblk + blockIdx.x] = x;
  }

  __threadfence();  // this block's partials are visible device-wide before the ticket
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&tickets[c], 1u) == static_cast<unsigned>(nblk * gridDim.y - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (nblk >= 32) {  // a warp a row: its lanes stride the blocks, then a fixed tree
    for (int r = warp; r <= R; r += kWarps) {
      const float* row = part_c + static_cast<int64_t>(r) * nblk;
      float x = 0.f;
#pragma unroll 8
      for (int64_t b = lane; b < nblk; b += 32) x += __ldcg(row + b);
      x = warp_sum(x);
      if (lane == 0) sums[static_cast<int64_t>(c) * (R + 1) + r] = x;
    }
  } else {  // few blocks and many rows (R in the thousands): a thread a row, in block order
    for (int r = tid; r <= R; r += kThreads) {
      const float* row = part_c + static_cast<int64_t>(r) * nblk;
      float x = 0.f;
#pragma unroll 8
      for (int64_t b = 0; b < nblk; ++b) x += __ldcg(row + b);
      sums[static_cast<int64_t>(c) * (R + 1) + r] = x;
    }
  }
  if (tid == 0) tickets[c] = 0u;  // ready for the next pass on this stream
}

// The chunked pass: the E-step's two kernels, then (unless kPosterior) the
// M-step. tpart: (C, chunks, V) f32 scratch; w: (C, V) f32, scratch or the
// E-only form's output.
template <bool kPosterior>
cudaError_t launch_chunked(const void* d, const void* coef, const void* base, const void* active,
                           void* w, void* tpart, void* partial, void* tickets, void* sums,
                           long long C, long long R, long long V, long long nblk, cudaStream_t s) {
  const long long chunks = (R + kChunk - 1) / kChunk;
  const bool aligned = V % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(tpart) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const unsigned vblocks = static_cast<unsigned>((V + 4 * kThreads - 1) / (4 * kThreads));
  const uint8_t* act = kPosterior ? nullptr : static_cast<const uint8_t*>(active);
  staple_logit_chunk_kernel<<<dim3(vblocks, static_cast<unsigned>(chunks), static_cast<unsigned>(C)),
                              kThreads, 0, s>>>(
      static_cast<const uint8_t*>(d), static_cast<const float*>(coef), act,
      static_cast<float*>(tpart), static_cast<int>(R), V, aligned);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  staple_sigmoid_chunk_kernel<<<dim3(vblocks, static_cast<unsigned>(C)), kThreads, 0, s>>>(
      static_cast<const float*>(tpart), static_cast<const float*>(base), act, static_cast<float*>(w),
      static_cast<int>(chunks), V, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess || kPosterior) return err;
  staple_mstep_chunk_kernel<<<dim3(static_cast<unsigned>(nblk), static_cast<unsigned>(chunks),
                                   static_cast<unsigned>(C)),
                              kThreads, 0, s>>>(
      static_cast<const uint8_t*>(d), static_cast<const float*>(w), act,
      static_cast<float*>(partial), static_cast<unsigned*>(tickets), static_cast<float*>(sums),
      static_cast<int>(R), V, nblk, aligned);
  return cudaGetLastError();
}

int check_sizes(long long C, long long R, long long V, long long nblk) {
  if (C <= 0 || R <= 0 || V <= 0 || nblk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(C, R, V);
  if (R > 2147483647LL || C > 65535 || p.chunks > 65535 || nblk != p.nblk ||
      (V + 4 * kThreads - 1) / (4 * kThreads) > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return static_cast<int>(cudaSuccess);
}

template <int kRows, bool kPosterior>
cudaError_t launch_form(const void* d, const void* coef, const void* base, const void* active,
                        void* w, void* partial, void* tickets, void* sums, long long C,
                        long long R, long long V, long long nblk, cudaStream_t s) {
  auto kernel = &staple_em_kernel<kRows, kPosterior>;
  const size_t smem = static_cast<size_t>(StapleTile<kRows>::smem(R));
  // Set on every call: the attribute belongs to the current device.
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const bool aligned = V % 16 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  kernel<<<dim3(static_cast<unsigned>(nblk), static_cast<unsigned>(C)), kThreads, smem, s>>>(
      static_cast<const uint8_t*>(d), static_cast<const float*>(coef),
      static_cast<const float*>(base), static_cast<const uint8_t*>(active), static_cast<float*>(w),
      static_cast<float*>(partial), static_cast<unsigned*>(tickets), static_cast<float*>(sums),
      static_cast<int>(R), V, nblk, aligned);
  return cudaGetLastError();
}

template <bool kPosterior>
cudaError_t launch_em(const void* d, const void* coef, const void* base, const void* active,
                      void* w, void* partial, void* tickets, void* sums, long long C, long long R,
                      long long V, long long nblk, cudaStream_t s) {
  switch (R + (R & 1)) {
#define K4_LAUNCH(n)                                                                              \
  case n:                                                                                         \
    return launch_form<n, kPosterior>(d, coef, base, active, w, partial, tickets, sums, C, R, V, \
                                      nblk, s);
    K4_FORMS(K4_LAUNCH)
#undef K4_LAUNCH
    default:
      return launch_form<0, kPosterior>(d, coef, base, active, w, partial, tickets, sums, C, R, V,
                                        nblk, s);
  }
}

}  // namespace

// The plan of a pass over (C, R, V): out = [rows, tile, stages, blocks an
// SM, tiles a case, blocks a case, dynamic shared bytes a block, rater
// chunks]. chunks > 1: the chunked form (R > 128), which needs the scratch
// tpart (C, chunks, V) f32 and, for a pass, w (C, V) f32.
extern "C" void staple_tile_plan(long long C, long long R, long long V, long long* out) {
  const Plan p = plan(C, R, V);
  const long long v[8] = {p.rows, p.tile, p.stages, p.blocks_per_sm, p.ntiles, p.nblk, p.smem, p.chunks};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// One EM pass for every active case. d: (C, R, V) uint8; coef: (C, R) f32;
// base: (C,) f32; active: (C,) uint8; partial: (C, R + 1, nblk) f32 scratch;
// tickets: (C,) uint32 scratch, zero before the call and left zero after it;
// sums: (C, R + 1) f32, wd in columns 0..R-1 and ws in column R. nblk, the
// blocks a case `partial` was sized for, must be the plan's
// (`staple_tile_plan`); the call fails otherwise. tpart and wbuf: the
// chunked form's scratch (the plan's chunks > 1), else unused.
extern "C" int staple_em_iter(const void* d, const void* coef, const void* base,
                              const void* active, void* partial, void* tickets, void* sums,
                              void* tpart, void* wbuf, long long C, long long R, long long V,
                              long long nblk, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an earlier one
  const int bad = check_sizes(C, R, V, nblk);
  if (bad) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > kChunk) {
    if (tpart == nullptr || wbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_chunked<false>(d, coef, base, active, wbuf, tpart, partial,
                                                  tickets, sums, C, R, V, nblk, s));
  }
  return static_cast<int>(launch_em<false>(d, coef, base, active, nullptr, partial, tickets, sums,
                                           C, R, V, nblk, s));
}

// The E-step alone: w (C, V) f32 = sigmoid(base + coef . d) for every case.
// tpart: the chunked form's scratch, else unused.
extern "C" int staple_posterior(const void* d, const void* coef, const void* base, void* w,
                                void* tpart, long long C, long long R, long long V, long long nblk,
                                void* stream) {
  (void)cudaGetLastError();
  const int bad = check_sizes(C, R, V, nblk);
  if (bad) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > kChunk) {
    if (tpart == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_chunked<true>(d, coef, base, nullptr, w, tpart, nullptr,
                                                 nullptr, nullptr, C, R, V, nblk, s));
  }
  return static_cast<int>(launch_em<true>(d, coef, base, nullptr, w, nullptr, nullptr, nullptr, C,
                                           R, V, nblk, s));
}

extern "C" const char* staple_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
