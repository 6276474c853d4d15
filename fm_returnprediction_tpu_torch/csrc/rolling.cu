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
//   fm_returnprediction_tpu/ops/pallas_kernels.py::masked_cumulative_moments
//   (body _moments_kernel, tile helper _masked_block_cumsum).
// They are exactly the rolling kernel's lead triple written out, so both
// kernels share one definition of the masked running triple (`accumulate`).
// What bounds it: memory. Each element is read once (4 B in float) and three
// results are written (12 B), 16 B per element (32 B in double); at
// (13312, 2432) float that is 518 MB, 0.155 ms at 3.35 TB/s. Design: one
// thread per column walks t in order, so a warp's row access is one
// coalesced load and three coalesced stores. The Pallas kernel's triangular
// matmul on the MXU is a TPU device and is not carried over: no tensor cores.
// It under-fills the card on a narrow strip (19 blocks of 128 threads at
// N = 2,432); it has no caller on the main path, and splitting its time
// axis as the rolling kernel does is queued for later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSum = 0;
constexpr int kMean = 1;
constexpr int kStd = 2;
constexpr int kThreads = 128;  // the moments kernel's block
constexpr int kWarp = 32;      // the rolling kernel's block: one warp
constexpr int kUnroll = 8;     // rows whose loads start together

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, T* __restrict__ csum,
               T* __restrict__ csumsq, T* __restrict__ ccnt, long long t_len,
               long long n) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  T s1 = T(0), s2 = T(0), c = T(0);
  for (long long t = 0; t < t_len; ++t) {
    const long long at = t * n + col;
    accumulate(x[at], s1, s2, c);
    csum[at] = s1;
    csumsq[at] = s2;
    ccnt[at] = c;
  }
}

template <typename T>
int launch_moments(const void* x, void* csum, void* csumsq, void* ccnt,
                   long long t_len, long long n, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  moments_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(csum),
      static_cast<T*>(csumsq), static_cast<T*>(ccnt), t_len, n);
  return (int)cudaGetLastError();
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
// dtype_code: 0 float, 1 double. Returns as rolling_reduce does.
extern "C" int masked_cumulative_moments(int dtype_code, const void* x,
                                         void* csum, void* csumsq, void* ccnt,
                                         long long t_len, long long n,
                                         void* stream) {
  if (t_len <= 0 || n <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_moments<float>(x, csum, csumsq, ccnt, t_len, n, s);
  if (dtype_code == 1)
    return launch_moments<double>(x, csum, csumsq, ccnt, t_len, n, s);
  return -1;
}

extern "C" const char* rolling_error_string(int code) {
  if (code == -1) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
