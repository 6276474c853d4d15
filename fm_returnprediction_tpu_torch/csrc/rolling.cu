// Masked trailing-window sum / mean / sample std along axis 0 of a
// row-major (T, N) array, for float and double.
//
// Replaces the Pallas TPU kernel
//   fm_returnprediction_tpu/ops/pallas_kernels.py::_rolling_reduce_fused
//   (body _windowed_reduce_kernel; public rolling_{std,sum,mean}_fused).
//
// Semantics (pandas rolling(window, min_periods) on axis 0): NaN entries
// occupy window rows but are excluded from the reduction; the result is NaN
// until min_periods finite entries are in the window; std is ddof=1 and needs
// at least two finite entries. The finalization transcribes
// fm_returnprediction_tpu_torch/ops/rolling.py::finalize_{sum,mean,std}.
//
// What bounds it on an H100: nothing but memory. Each element is read once
// from device memory, re-read once `window` rows later, and written once;
// the arithmetic is a handful of adds, a divide and (std) a square root per
// element. The least time is the bytes of one read of x plus one write of
// the result over 3.35 TB/s.
//
// Design: the time axis is cut into chunks of `chunk` rows (chosen by the
// wrapper from the window alone: ops/rolling.py::rolling_chunk_rows), and
// the columns into groups of 32. One block of one warp covers one (column
// group, chunk): neighbouring lanes own neighbouring columns, so every row
// access of the warp is one coalesced 128-byte (float) or 256-byte (double)
// transaction. A daily strip 2,432 columns wide and 13,312 rows tall gives
// 76 x 26 = 1,976 warps for 132 SMs, where one thread per column over the
// whole height would give 76.
//
// Chunk anchoring, one launch, no carry pass and no scratch: the block for
// chunk k = [k*L, min((k+1)*L, T)) walks from the anchor a = max(k*L - w, 0)
// and keeps two running triples (sum x, sum x^2, count), both starting from
// zero at a: a lead triple fed by x[t], and a lag triple fed by re-reading
// x[t - w] once t - w >= a. It writes nothing before row k*L; from there
// on, lead - lag is exactly the window sum over (t - w, t]. Chunk 0
// (a = 0) is a plain walk from the column's first row. A later chunk
// differences sums anchored at a rather than at row 0, which is a smaller
// cancellation than the plain version's cumulative-sum difference: the two
// agree within the tolerance of chip_smoke.rolling_tolerance. The lag triple
// adds the same values in the same order as the lead did, so no window
// history is kept (the Pallas kernel's (window, 3*BN) VMEM scratch would be
// ~387 KB at w=252, more than an SM's shared memory); the re-read row was
// read `window` rows earlier and is usually still in L2. The walk loads the
// next kUnroll rows (lead and lag) before it does their arithmetic, so a
// thread keeps several loads in flight. Counts are kept in the data type, as
// in the Pallas kernel; float counts are exact to 2^24 rows.
//
// The same file holds the inclusive NaN-masked cumulative moments
// (sum x, sum x^2, count) along axis 0, which replace the Pallas TPU kernel
//   fm_returnprediction_tpu/ops/pallas_kernels.py:132 masked_cumulative_moments
//   (body _moments_kernel :110, tile helper _masked_block_cumsum :93).
// They are the rolling kernel's lead triple written out, so both kernels
// share one definition of the masked running triple (`accumulate`): NaN and
// +-inf add nothing, as jnp.isfinite masks them in the Pallas kernel.
//
// What bounds it: memory. One read of x and three writes, 16 B per element
// in float and 32 B in double; at (13312, 2432) float that is 518 MB, 0.155
// ms at 3.35 TB/s.
//
// Design, a chunked two-pass scan: the time axis is cut into chunks of
// `chunk` rows (ops/rolling.py::moments_chunk_rows, a function of T alone)
// and the columns into groups, one warp per (column group, chunk) as in the
// rolling kernel. A thread owns one 16-byte pack of neighbouring columns (4
// float, 2 double), loaded and stored whole, when N is a multiple of the pack
// and every array is 16-byte aligned; one column otherwise. Pass 1
// (moments_totals_kernel) walks every chunk but the last and writes its
// (sum x, sum x^2, count) per column into a (chunks - 1, 3, N) scratch the
// wrapper allocates. Pass 2 (moments_scan_kernel) first adds the totals of
// chunks 0 .. k-1, in chunk order, then re-walks chunk k from that carry and
// writes the three outputs. A single chunk skips pass 1. Both walks load a
// stretch of rows (128 bytes a thread; 64 for a float column) before they add
// them, so a thread keeps that many loads in flight. The cost of two passes
// is one extra read of x (4 B of 16 per element in float, 8 of 32 in
// double): 1.25x the one-pass bytes. On an H100, wider blocks, longer
// stretches, software-pipelined stretches and evict-first cache hints were
// each tried and moved nothing beyond the call-to-call spread (PERF.md).
//
// Deterministic: every output is the same sequence of additions on every run
// and every card (a chunk's total in row order, the carry in chunk order,
// then the chunk's rows in order); there are no atomics and no block waits
// on another. A one-pass chained look-back would save the re-read, but each
// chunk would wait on its predecessor's inclusive prefix, a serial chain of
// T / chunk hops, and hold its chunk on chip meanwhile; it is not used
// (PERF.md).
//
// Not carried over from the Pallas kernel: its triangular matmul per tile,
// which spends block_t/2 multiply-adds per element where a walk spends one
// add, on a kernel bound by bytes (and Hopper's tensor cores would round
// float32 through TF32); and its carry across a sequential grid axis, since
// CUDA blocks run in no order: the pass-1 totals take its place.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSum = 0;
constexpr int kMean = 1;
constexpr int kStd = 2;
constexpr int kWarp = 32;   // either kernel's block: one warp
constexpr int kUnroll = 8;  // rows whose loads start together

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T>
__device__ __forceinline__ void accumulate(T v, T& s1, T& s2, T& c) {
  if (isfinite(v)) {
    s1 = s1 + v;
    s2 = fma(v, v, s2);
    c = c + T(1);
  }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kWarp)
rolling_reduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                      long long t_len, long long n, long long window,
                      long long min_periods, long long chunk) {
  const long long col = (long long)blockIdx.x * kWarp + threadIdx.x;
  if (col >= n) return;
  const long long start = (long long)blockIdx.y * chunk;
  const long long stop = start + chunk < t_len ? start + chunk : t_len;
  const long long anchor = start > window ? start - window : 0;
  const T* xc = x + col;
  T* oc = out + col;
  const T mp = T(min_periods);
  const T nan = quiet_nan<T>();
  T s1 = T(0), s2 = T(0), c = T(0);   // lead triple: anchor through t
  T l1 = T(0), l2 = T(0), lc = T(0);  // lag triple: anchor through t - w
  for (long long t0 = anchor; t0 < stop; t0 += kUnroll) {
    // this stretch's loads first; a NaN stands for "nothing to add"
    T lead[kUnroll], lag[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + u;
      lead[u] = t < stop ? xc[t * n] : nan;
      lag[u] = (t < stop && t - window >= anchor) ? xc[(t - window) * n] : nan;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + u;
      accumulate(lead[u], s1, s2, c);
      accumulate(lag[u], l1, l2, lc);
      if (t < start || t >= stop) continue;
      const T w1 = s1 - l1;
      const T w2 = s2 - l2;
      const T wc = c - lc;
      T r;
      if (KIND == kSum) {
        r = w1;
      } else if (KIND == kMean) {
        r = w1 / fmax(wc, T(1));
      } else {
        const T denom = fmax(wc - T(1), T(1));
        const T var = fmax(w2 - w1 * w1 / fmax(wc, T(1)), T(0)) / denom;
        r = wc >= T(2) ? sqrt(var) : nan;
      }
      oc[t * n] = wc >= mp ? r : nan;
    }
  }
}

// VEC neighbouring columns of one row, moved as one 16-byte access when
// VEC > 1 (float4 / double2) and as one scalar when VEC == 1.
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  Pack<T, VEC> r;
  if constexpr (VEC == 1) {
    r.v[0] = *p;
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    r.v[0] = q.x; r.v[1] = q.y;
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
}

// the moments kernels' rows whose loads start together: 64 bytes a thread
// for one float column, 128 for one double column or a pack
template <int VEC>
constexpr int kScanRows = VEC == 1 ? 16 : 8;

// Pass 1: the masked (sum x, sum x^2, count) of chunk blockIdx.y for the VEC
// columns from `col`, into totals[(k * 3 + m) * n + col].
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarp)
moments_totals_kernel(const T* __restrict__ x, T* __restrict__ totals,
                      long long t_len, long long n, long long chunk) {
  constexpr int kRows = kScanRows<VEC>;
  const long long col = ((long long)blockIdx.x * kWarp + threadIdx.x) * VEC;
  if (col >= n) return;
  const long long start = (long long)blockIdx.y * chunk;
  const long long stop = start + chunk < t_len ? start + chunk : t_len;
  Pack<T, VEC> none;  // NaN stands for "nothing to add"
#pragma unroll
  for (int e = 0; e < VEC; ++e) none.v[e] = quiet_nan<T>();
  const T* p = x + start * n + col;
  T s1[VEC], s2[VEC], c[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = c[e] = T(0);
  for (long long t0 = start; t0 < stop; t0 += kRows) {
    // this stretch's loads first
    Pack<T, VEC> v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u, p += n) {
      v[u] = t0 + u < stop ? load_pack<T, VEC>(p) : none;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) accumulate(v[u].v[e], s1[e], s2[e], c[e]);
    }
  }
  T* out = totals + (long long)blockIdx.y * 3 * n + col;
  store_pack<T, VEC>(out, s1);
  store_pack<T, VEC>(out + n, s2);
  store_pack<T, VEC>(out + 2 * n, c);
}

// Pass 2: chunk k = blockIdx.y starts from the totals of chunks 0 .. k-1,
// added in chunk order, and writes its rows' inclusive running triple.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarp)
moments_scan_kernel(const T* __restrict__ x, const T* __restrict__ totals,
                    T* __restrict__ csum, T* __restrict__ csumsq,
                    T* __restrict__ ccnt, long long t_len, long long n,
                    long long chunk) {
  constexpr int kRows = kScanRows<VEC>;
  const long long col = ((long long)blockIdx.x * kWarp + threadIdx.x) * VEC;
  if (col >= n) return;
  const long long k = blockIdx.y;
  const long long start = k * chunk;
  const long long stop = start + chunk < t_len ? start + chunk : t_len;
  Pack<T, VEC> none;
#pragma unroll
  for (int e = 0; e < VEC; ++e) none.v[e] = quiet_nan<T>();
  T s1[VEC], s2[VEC], c[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = c[e] = T(0);
  const T* tot = totals + col;
#pragma unroll 4
  for (long long j = 0; j < k; ++j, tot += 3 * n) {
    const Pack<T, VEC> a = load_pack<T, VEC>(tot);
    const Pack<T, VEC> b = load_pack<T, VEC>(tot + n);
    const Pack<T, VEC> d = load_pack<T, VEC>(tot + 2 * n);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s1[e] = s1[e] + a.v[e];
      s2[e] = s2[e] + b.v[e];
      c[e] = c[e] + d.v[e];
    }
  }
  const long long at = start * n + col;
  const T* p = x + at;
  T* o1 = csum + at;
  T* o2 = csumsq + at;
  T* oc = ccnt + at;
  for (long long t0 = start; t0 < stop; t0 += kRows) {
    Pack<T, VEC> v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u, p += n) {
      v[u] = t0 + u < stop ? load_pack<T, VEC>(p) : none;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (t0 + u >= stop) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e) accumulate(v[u].v[e], s1[e], s2[e], c[e]);
      store_pack<T, VEC>(o1, s1);
      store_pack<T, VEC>(o2, s2);
      store_pack<T, VEC>(oc, c);
      o1 += n;
      o2 += n;
      oc += n;
    }
  }
}

template <typename T, int VEC>
int launch_moments_vec(const T* x, T* csum, T* csumsq, T* ccnt, T* totals,
                       long long t_len, long long n, long long chunks,
                       long long chunk, cudaStream_t stream) {
  const long long groups = (n / VEC + kWarp - 1) / kWarp;
  if (chunks > 1) {
    moments_totals_kernel<T, VEC>
        <<<dim3((unsigned)groups, (unsigned)(chunks - 1)), kWarp, 0, stream>>>(
            x, totals, t_len, n, chunk);
    const int status = (int)cudaGetLastError();
    if (status != 0) return status;
  }
  moments_scan_kernel<T, VEC>
      <<<dim3((unsigned)groups, (unsigned)chunks), kWarp, 0, stream>>>(
          x, totals, csum, csumsq, ccnt, t_len, n, chunk);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

// 16-byte packs where every row of every array starts 16-byte aligned (N a
// multiple of the pack, aligned bases), one column a thread otherwise.
template <typename T>
int launch_moments(const void* x, void* csum, void* csumsq, void* ccnt,
                   void* scratch, long long t_len, long long n,
                   long long chunk, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long chunks = (t_len + chunk - 1) / chunk;
  if (chunks > 65535 || (n + kWarp - 1) / kWarp > 0x7fffffffLL) return -1;
  if (chunks > 1 && scratch == nullptr) return -1;
  const T* xp = static_cast<const T*>(x);
  T* o1 = static_cast<T*>(csum);
  T* o2 = static_cast<T*>(csumsq);
  T* oc = static_cast<T*>(ccnt);
  T* totals = static_cast<T*>(scratch);
  const bool packed = n % kVec == 0 && aligned16(x) && aligned16(csum) &&
                      aligned16(csumsq) && aligned16(ccnt) &&
                      (chunks == 1 || aligned16(scratch));
  if (packed)
    return launch_moments_vec<T, kVec>(xp, o1, o2, oc, totals, t_len, n,
                                       chunks, chunk, stream);
  return launch_moments_vec<T, 1>(xp, o1, o2, oc, totals, t_len, n, chunks,
                                  chunk, stream);
}

template <typename T>
int launch(int kind, const void* x, void* out, long long t_len, long long n,
           long long window, long long min_periods, long long chunk,
           cudaStream_t stream) {
  const long long chunks = (t_len + chunk - 1) / chunk;
  const long long groups = (n + kWarp - 1) / kWarp;
  if (chunks > 65535 || groups > 0x7fffffffLL) return -1;
  const dim3 grid((unsigned)groups, (unsigned)chunks);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  switch (kind) {
    case kSum:
      rolling_reduce_kernel<T, kSum><<<grid, kWarp, 0, stream>>>(
          xp, op, t_len, n, window, min_periods, chunk);
      break;
    case kMean:
      rolling_reduce_kernel<T, kMean><<<grid, kWarp, 0, stream>>>(
          xp, op, t_len, n, window, min_periods, chunk);
      break;
    case kStd:
      rolling_reduce_kernel<T, kStd><<<grid, kWarp, 0, stream>>>(
          xp, op, t_len, n, window, min_periods, chunk);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 float, 1 double. kind: 0 sum, 1 mean, 2 std. chunk: rows
// of the time axis one block writes (at most 65,535 chunks).
// Returns 0 on success, the cudaError_t of the launch otherwise, or -1 for
// arguments the kernel does not take.
extern "C" int rolling_reduce(int dtype_code, int kind, const void* x,
                              void* out, long long t_len, long long n,
                              long long window, long long min_periods,
                              long long chunk, void* stream) {
  if (t_len <= 0 || n <= 0 || window < 1 || min_periods < 0 || chunk < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch<float>(kind, x, out, t_len, n, window, min_periods, chunk, s);
  if (dtype_code == 1)
    return launch<double>(kind, x, out, t_len, n, window, min_periods, chunk, s);
  return -1;
}

// Inclusive cumulative (sum x, sum x^2, count) of a row-major (T, N) array
// along axis 0; non-finite entries add nothing. The count is in x's type.
// dtype_code: 0 float, 1 double. chunk: rows of the time axis one block
// scans (at most 65,535 chunks). scratch: room for (chunks - 1) * 3 * n
// values of x's type (the chunk totals; unused, and may be null, when there
// is one chunk). Returns as rolling_reduce does.
extern "C" int masked_cumulative_moments(int dtype_code, const void* x,
                                         void* csum, void* csumsq, void* ccnt,
                                         void* scratch, long long t_len,
                                         long long n, long long chunk,
                                         void* stream) {
  if (t_len <= 0 || n <= 0 || chunk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_moments<float>(x, csum, csumsq, ccnt, scratch, t_len, n,
                                 chunk, s);
  if (dtype_code == 1)
    return launch_moments<double>(x, csum, csumsq, ccnt, scratch, t_len, n,
                                  chunk, s);
  return -1;
}

extern "C" const char* rolling_error_string(int code) {
  if (code == -1) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
