// Masked per-month Gram contraction for a batch of specs: float, double, and
// bf16 operands accumulated in float.
//
// Replaces the Pallas TPU kernel
//   fm_returnprediction_tpu/ops/gram_pallas.py::gram_contract_pallas
//   (body _gram_kernel), every branch of it: the unweighted contraction, the
//   row-weighted one (has_rw) and bf16 operands with f32 accumulation.
//
// For every spec s and month t it forms
//   G_s[t] = sum_n w_s[t,n] * a[t,n,:] a[t,n,:]^T,  a = [1 | x - c_t | y]
// a (QE, QE) block with QE = P + 2, where the weight is
//   w_s[t,n] = rw[t,n] if valid[s,t,n] and finite(y[t,n]) and no SELECTED
//              column of x[t,n,:] is non-finite, else 0
// (rw = 1 without row weights, so n = sum w is then an exact count).
// Non-finite x entries of unselected columns and a non-finite y enter as 0.
// The caller splits the block into gram, moment, n, sum y and sum y^2.
//
// bf16 operands (x, y, center, rw) are widened to float on their way into
// shared memory's augmented rows. The centred value x - c is rounded back to
// bf16 there, because the reference's XLA route materialises it in bf16;
// the product w * a_i is formed in float (exact: two 8-bit significands) and
// every sum is a float sum, so counts stay exact past bf16's 256.
//
// What bounds it on an H100: at Table 2's shape (T=600, N=22,000, P=14,
// S=9) it reads ~0.9 GB (x, y and the uint8 mask) and does
// S*T*N*QE*(QE+1)/2 ~ 1.6e10 multiply-adds, so in plain FP32 the arithmetic
// (~0.5 ms at 67 TFLOP/s) outweighs the bytes (~0.27 ms at 3.35 TB/s). At
// the figure grid's shape (P=5, S=3) the bytes bound it (~0.1 ms). With bf16
// operands the same work is bound by its ~0.54 GB (~0.16 ms) against the
// tensor cores' rate; this CUDA-core kernel runs it at its FP32 speed.
//
// Design. One block per month t walks the firm axis in tiles; x is read in
// its native (T, N, P) layout, where a tile is tile*P contiguous values.
// - Register tiles of the output: the (QE x QE) upper triangle is padded to
//   a multiple of 4 and cut into 4x4 tiles (10 at P=14, 3 at P=5). A thread
//   owns one (spec, tile) pair and keeps its 16 sums in registers. Per firm
//   it reads 4 + 4 row values as two 16-byte shared-memory loads and the
//   spec's weight as one, forms w*a_i once and does 16 FMAs: 3 loads per 16
//   FMAs, where one thread per output entry would spend 3 loads per FMA.
//   The lanes of a warp read one firm's row, so those loads are broadcasts,
//   free of bank conflicts.
// - Firm groups: the (spec, tile) owners are replicated G times so that a
//   block has up to 192 threads; group g sums firms g, g+G, ... of each
//   tile. Blocks are kept small (float: <= 192 threads, <= 64 registers,
//   <= 44 KB of shared memory, the row weights' tile included) so that five
//   share an SM and all 600 months of the main path are resident at once: no
//   tail wave, and one block's barriers overlap the others' arithmetic. Each
//   thread adds a per-tile partial into a running
//   total (two-level sum), and at the end the groups' totals are added in
//   group order through shared memory: no atomics, so the result is the same
//   from run to run and the counts are exact.
// - Asynchronous double-buffered tiles: the next tile of x, y, the row
//   weights and the block's valid rows is copied with cp.async in 16-byte
//   chunks (a ragged first or last chunk byte by byte) while this tile is
//   summed.
// - The build is spread over the block: each thread keeps one column of
//   the centred augmented rows for a stride of firms (row stride QE rounded
//   up to 4, so a warp writes consecutive words: no bank conflict), and one
//   thread per firm finds the firm's non-finite columns once, as a bit mask,
//   then writes every spec's weight from the staged valid byte and row
//   weight: a (firm, spec) weight costs one byte load and one mask test.
// - When S * tiles exceeds one block's threads (large P or S, not on the
//   main path), the (spec, tile) pairs are split over gridDim.y blocks,
//   each staging only the valid rows of its own specs.
// - One launch takes at most 8192 block entries S * QE * (QE + 1) / 2 (60
//   specs at P = 14): the wrapper cuts a larger spec batch into consecutive
//   chunks, one launch each. P is at most 32 (the non-finite column mask is
//   one 32-bit word per spec); no ported path goes past P = 15.
// Tensor cores are not used: TF32 keeps ~10 mantissa bits and would break
// the 1e-5 (f32) parity with the plain version. A split-TF32 scheme (and,
// for bf16 operands, bf16 wgmma with f32 accumulation) is left for later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr long long kMaxEntries = 8192;  // S * QE * (QE + 1) / 2
constexpr int kMaxP = 32;
constexpr int kMaxTile = 1024;
constexpr int kMinTile = 16;
constexpr size_t kSmemMax = 227 * 1024;

// Threads a block has at most, blocks that must fit on one SM (registers:
// 64 a thread in float) and the shared memory each may take. In float five
// blocks of ~180 threads fit on an SM, so all 600 months of the main path
// are resident at once: no tail wave, and one block's barriers overlap the
// others' arithmetic.
template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr int kThreads = 192;
  static constexpr int kMinBlocks = 5;
  static constexpr size_t kSmemBudget = 44 * 1024;
};
template <>
struct Limits<double> {
  static constexpr int kThreads = 192;
  static constexpr int kMinBlocks = 2;
  static constexpr size_t kSmemBudget = 112 * 1024;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ size_t up16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Byte offsets of one block's dynamic shared memory: two stages of raw
// tiles (x, y, the row weights when there are any, one valid row per spec
// of the block), then the augmented rows and the weights. Raw tiles are in
// the operand type In, rows and weights in the accumulation type T.
struct Layout {
  int qp;              // row stride: QE rounded up to 4
  size_t x_bytes, y_bytes, rw_bytes, v_row, stage;
  size_t rows_off, w_off, total;
};

template <typename In, typename T>
__host__ __device__ Layout make_layout(int tile, int p, int nsb, bool has_rw) {
  Layout L;
  L.qp = ((p + 2 + 3) / 4) * 4;
  // each raw row keeps room for a 16-byte misalignment of its source
  L.x_bytes = up16((size_t)tile * p * sizeof(In) + 16);
  L.y_bytes = up16((size_t)tile * sizeof(In) + 16);
  L.rw_bytes = has_rw ? L.y_bytes : 0;
  L.v_row = up16((size_t)tile + 16);
  L.stage = L.x_bytes + L.y_bytes + L.rw_bytes + L.v_row * nsb;
  L.rows_off = 2 * L.stage;
  L.w_off = L.rows_off + up16((size_t)tile * L.qp * sizeof(T));
  L.total = L.w_off + up16((size_t)tile * nsb * sizeof(T));
  return L;
}

// Stage `nrows` rows of `row_bytes` global bytes each (row r starts at
// src + r * src_stride) into shared memory at dst + r * dst_stride. Row r's
// byte e lands at dst + r * dst_stride + (address of its first byte & 15) + e:
// whole 16-byte chunks go by cp.async, a ragged first or last chunk byte by
// byte with plain loads.
__device__ void stage_rows(unsigned char* dst, int dst_stride,
                           const unsigned char* src, long long src_stride,
                           int nrows, int row_bytes, int tid, int nthreads) {
  const int cpr = row_bytes / 16 + 2;  // chunks a row can touch
  for (int k = tid; k < nrows * cpr; k += nthreads) {
    const int r = nrows == 1 ? 0 : k / cpr;
    const int ch = k - r * cpr;
    const unsigned char* lo = src + r * src_stride;
    const unsigned char* hi = lo + row_bytes;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(lo) & ~uintptr_t(15);
    const unsigned char* c0 = reinterpret_cast<const unsigned char*>(a0) + ch * 16;
    if (c0 >= hi) continue;
    unsigned char* d = dst + r * dst_stride + ch * 16;
    if (c0 >= lo && c0 + 16 <= hi) {
      cp_async16(d, c0);
    } else {
      for (int b = 0; b < 16; ++b)
        if (c0 + b >= lo && c0 + b < hi) d[b] = c0[b];
    }
  }
}

__device__ __forceinline__ int misalign(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// An operand widened to the accumulation type, and a centred value rounded
// as the operand type holds it (only bf16 rounds).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename In, typename T>
__device__ __forceinline__ T as_operand(T v) {
  return v;
}
template <>
__device__ __forceinline__ float as_operand<__nv_bfloat16, float>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// (spec, 4x4 tile) of pair index `pr`: tiles of the upper triangle of an
// nt4 x nt4 tile grid, row by row.
__device__ __forceinline__ void decode_pair(int pr, int ntiles, int nt4,
                                            int& s, int& ti, int& tj) {
  s = pr / ntiles;
  int r = pr - s * ntiles;
  int i = 0;
  while (r >= nt4 - i) {
    r -= nt4 - i;
    ++i;
  }
  ti = i;
  tj = i + r;
}

// kRw: whether there are row weights, a template argument so that the
// unweighted kernel carries no register or instruction for them.
template <typename In, typename T, bool kRw>
__global__ void __launch_bounds__(Limits<T>::kThreads, Limits<T>::kMinBlocks)
gram_kernel(const In* __restrict__ x, const In* __restrict__ y,
            const In* __restrict__ rw, const unsigned char* __restrict__ valid,
            const unsigned int* __restrict__ sel_bits,
            const In* __restrict__ center, T* __restrict__ out, int t_len,
            long long n, int p, int s_specs, int tile, int pairs_per_block,
            int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool has_rw = kRw;
  const int qe = p + 2;
  const int nt4 = (qe + 3) / 4;
  const int ntiles = nt4 * (nt4 + 1) / 2;
  const int npairs = s_specs * ntiles;
  const int t = blockIdx.x;
  const int p0 = blockIdx.y * pairs_per_block;
  const int p1 = min(p0 + pairs_per_block, npairs);
  const int s_lo = p0 / ntiles;
  const int nsb = (p1 - 1) / ntiles - s_lo + 1;
  const Layout L = make_layout<In, T>(tile, p, nsb, has_rw);
  const int qp = L.qp;
  T* rows = reinterpret_cast<T*>(smem + L.rows_off);
  T* wts = reinterpret_cast<T*>(smem + L.w_off);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // this thread's (spec, tile) pair and firm group
  const int lp = tid % pairs_per_block;
  const int g = tid / pairs_per_block;
  const bool owner = p0 + lp < p1;
  int sl = 0, ti = 0, tj = 0;
  if (owner) {
    decode_pair(p0 + lp, ntiles, nt4, sl, ti, tj);
    sl -= s_lo;
  }
  // this thread's column of the augmented rows (firms rf0, rf0 + rstep, ...)
  const int rc = tid % qp;
  const int rf0 = tid / qp;
  const int rstep = nthreads / qp;
  const T shift = (rc >= 1 && rc <= p) ? widen(center[(size_t)t * p + rc - 1]) : T(0);

  const long long n_tiles = (n + tile - 1) / tile;
  const long long row_t = (long long)t * n;
  const unsigned char* v_first = valid + ((long long)s_lo * t_len + t) * n;
  const long long v_stride = (long long)t_len * n;
  // tiles start at multiples of 16 firms, so each source's misalignment is
  // the same for every tile of the month
  const int x_mis = misalign(x + row_t * p);
  const int y_mis = misalign(y + row_t);
  const int rw_mis = has_rw ? misalign(rw + row_t) : 0;
  const size_t rw_off = L.x_bytes + L.y_bytes;
  const size_t v_off = rw_off + L.rw_bytes;

  auto stage_tile = [&](long long n0, int buf) {
    const int cnt = (int)min((long long)tile, n - n0);
    unsigned char* st = smem + buf * L.stage;
    stage_rows(st, 0, reinterpret_cast<const unsigned char*>(x + (row_t + n0) * p), 0,
               1, cnt * p * (int)sizeof(In), tid, nthreads);
    stage_rows(st + L.x_bytes, 0,
               reinterpret_cast<const unsigned char*>(y + row_t + n0), 0, 1,
               cnt * (int)sizeof(In), tid, nthreads);
    if (has_rw)
      stage_rows(st + rw_off, 0,
                 reinterpret_cast<const unsigned char*>(rw + row_t + n0), 0, 1,
                 cnt * (int)sizeof(In), tid, nthreads);
    stage_rows(st + v_off, (int)L.v_row, v_first + n0, v_stride, nsb, cnt, tid,
               nthreads);
    cp_async_commit();
  };

  T acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = T(0);

  stage_tile(0, 0);
  for (long long k = 0; k < n_tiles; ++k) {
    const long long n0 = k * tile;
    const int cnt = (int)min((long long)tile, n - n0);
    const int buf = (int)(k & 1);
    cp_async_wait_all();
    __syncthreads();  // tile k staged; the previous tile's sums are done
    if (k + 1 < n_tiles) stage_tile(n0 + tile, buf ^ 1);

    const unsigned char* st = smem + buf * L.stage;
    const In* xr = reinterpret_cast<const In*>(st + x_mis);
    const In* yr = reinterpret_cast<const In*>(st + L.x_bytes + y_mis);
    const In* rwr = reinterpret_cast<const In*>(st + rw_off + rw_mis);
    const unsigned char* vr = st + v_off;
    // augmented rows [1 | x - c | y | 0 pad]: a fixed column per thread, so
    // a warp writes consecutive words
    if (rf0 < rstep) {
      for (int f = rf0; f < cnt; f += rstep) {
        T v = T(0);
        if (rc == 0) {
          v = T(1);
        } else if (rc <= p) {
          const T xv = widen(xr[f * p + rc - 1]);
          v = isfinite(xv) ? as_operand<In, T>(xv - shift) : T(0);
        } else if (rc == qe - 1) {
          const T yv = widen(yr[f]);
          v = isfinite(yv) ? yv : T(0);
        }
        rows[f * qp + rc] = v;
      }
    }
    // weights: one thread per firm finds its non-finite columns once (bit
    // 32: y) and writes every spec's weight from the staged valid bytes and
    // the firm's row weight
    for (int f = tid; f < cnt; f += nthreads) {
      unsigned long long bad = isfinite(widen(yr[f])) ? 0ull : (1ull << 32);
      const In* xf = xr + f * p;
      for (int c = 0; c < p; ++c)
        if (!isfinite(widen(xf[c]))) bad |= 1ull << c;
      const T wf = has_rw ? widen(rwr[f]) : T(1);
      for (int s = 0; s < nsb; ++s) {
        const unsigned char* vs = vr + s * L.v_row + misalign(v_first + s * v_stride);
        const unsigned long long need = (unsigned long long)__ldg(sel_bits + s_lo + s) |
                                        (1ull << 32);
        wts[f * nsb + s] = (vs[f] != 0 && (bad & need) == 0ull) ? wf : T(0);
      }
    }
    __syncthreads();

    if (owner) {
      T part[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = T(0);
#pragma unroll 2
      for (int f = g; f < cnt; f += groups) {
        const T* row = rows + f * qp;
        T ai[4], aj[4];
        load4(row + 4 * ti, ai);
        load4(row + 4 * tj, aj);
        const T w = wts[f * nsb + sl];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T wa = w * ai[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[4 * i + j] = fma(wa, aj[j], part[4 * i + j]);
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += part[e];
    }
  }

  // the groups' totals, added in group order
  __syncthreads();
  T* red = reinterpret_cast<T*>(smem);
  if (owner) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      red[((size_t)g * pairs_per_block + lp) * 16 + e] = acc[e];
  }
  __syncthreads();
  for (int idx = tid; idx < (p1 - p0) * 16; idx += nthreads) {
    const int lpi = idx / 16;
    const int e = idx - lpi * 16;
    T sum = T(0);
    for (int gg = 0; gg < groups; ++gg)
      sum += red[((size_t)gg * pairs_per_block + lpi) * 16 + e];
    int s, a, b;
    decode_pair(p0 + lpi, ntiles, nt4, s, a, b);
    const int i = e / 4, j = e % 4;
    const int r = 4 * a + i, c = 4 * b + j;
    if (r < qe && c < qe && (a < b || i <= j)) {
      T* blk = out + ((size_t)s * t_len + t) * qe * qe;
      blk[r * qe + c] = sum;
      blk[c * qe + r] = sum;
    }
  }
}

template <typename In, typename T, bool kRw>
int launch(const void* x, const void* y, const void* rw,
           const unsigned char* valid, const unsigned int* sel_bits,
           const void* center, void* out, int t_len, long long n, int p,
           int s_specs, cudaStream_t stream) {
  const int qe = p + 2;
  if ((long long)s_specs * qe * (qe + 1) / 2 > kMaxEntries) return -1;
  constexpr bool has_rw = kRw;
  const int nt4 = (qe + 3) / 4;
  const int ntiles = nt4 * (nt4 + 1) / 2;
  const int npairs = s_specs * ntiles;
  const int max_threads = Limits<T>::kThreads;
  const int n_blocks_y = (npairs + max_threads - 1) / max_threads;
  const int pb = (npairs + n_blocks_y - 1) / n_blocks_y;  // pairs a block
  const int groups = max_threads / pb > 1 ? max_threads / pb : 1;
  const int threads = groups * pb;
  int nsb_max = 0;  // the most specs one block covers
  for (int b = 0; b < n_blocks_y; ++b) {
    const int lo = b * pb;
    const int hi = std::min(lo + pb, npairs);
    nsb_max = std::max(nsb_max, (hi - 1) / ntiles - lo / ntiles + 1);
  }
  const size_t red = (size_t)threads * 16 * sizeof(T);
  int tile = kMaxTile;
  auto smem_for = [&](int tl) {
    const size_t s = make_layout<In, T>(tl, p, nsb_max, has_rw).total;
    return s > red ? s : red;
  };
  while (tile > kMinTile && smem_for(tile) > Limits<T>::kSmemBudget) tile /= 2;
  const size_t smem = smem_for(tile);
  if (smem > kSmemMax || n_blocks_y > 65535) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<In, T, kRw>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)t_len, (unsigned)n_blocks_y);
  gram_kernel<In, T, kRw><<<grid, threads, smem, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(y),
      static_cast<const In*>(rw), valid, sel_bits, static_cast<const In*>(center),
      static_cast<T*>(out), t_len, n, p, s_specs, tile, pb, groups);
  return (int)cudaGetLastError();
}

template <typename In, typename T>
int launch_any(const void* x, const void* y, const void* rw,
               const unsigned char* valid, const unsigned int* sel_bits,
               const void* center, void* out, int t_len, long long n, int p,
               int s_specs, cudaStream_t stream) {
  if (rw != nullptr)
    return launch<In, T, true>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                               s_specs, stream);
  return launch<In, T, false>(x, y, rw, valid, sel_bits, center, out, t_len, n, p,
                              s_specs, stream);
}

}  // namespace

// dtype_code: 0 float, 1 double, 2 bf16 operands with float sums. x (T, N,
// P), y (T, N), center (T, P) and rw (T, N; null for no row weights) in the
// operand type, out (S, T, P+2, P+2) in float for codes 0 and 2, double for
// 1; valid (S, T, N) uint8; sel_bits (S,) uint32 with bit c set when spec s
// selects column c. P must be <= 32 and S * (P+2)(P+3)/2 <= 8192. Returns 0
// on success, the cudaError_t of the launch otherwise, or -1 for arguments
// the kernel does not take.
extern "C" int gram_contract(int dtype_code, const void* x, const void* y,
                             const void* rw, const void* valid,
                             const void* sel_bits, const void* center,
                             void* out, int t_len, long long n, int p,
                             int s_specs, void* stream) {
  if (t_len <= 0 || n <= 0 || p < 0 || p > kMaxP || s_specs <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const unsigned int* b = static_cast<const unsigned int*>(sel_bits);
  if (dtype_code == 0)
    return launch_any<float, float>(x, y, rw, v, b, center, out, t_len, n, p, s_specs, s);
  if (dtype_code == 1)
    return launch_any<double, double>(x, y, rw, v, b, center, out, t_len, n, p, s_specs, s);
  if (dtype_code == 2)
    return launch_any<__nv_bfloat16, float>(x, y, rw, v, b, center, out, t_len, n, p,
                                            s_specs, s);
  return -1;
}

extern "C" const char* gram_error_string(int code) {
  if (code == -1) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
