// Masked per-month Gram contraction for a batch of specs, float and double.
//
// Replaces the Pallas TPU kernel
//   fm_returnprediction_tpu/ops/gram_pallas.py::gram_contract_pallas
//   (body _gram_kernel).
//
// For every spec s and month t it forms
//   G_s[t] = sum_n w_s[t,n] * a[t,n,:] a[t,n,:]^T,  a = [1 | x - c_t | y]
// a (QE, QE) block with QE = P + 2, where the weight is
//   w_s[t,n] = valid[s,t,n] and finite(y[t,n]) and no SELECTED column of
//              x[t,n,:] is non-finite.
// Non-finite x entries of unselected columns and a non-finite y enter as 0.
// The caller splits the block into gram, moment, n, sum y and sum y^2.
//
// What bounds it on an H100: at Table 2's shape (T=600, N=22,000, P=14,
// S=9) it reads ~0.9 GB (x, y and the uint8 mask) and does
// S*T*N*QE*(QE+1)/2 ~ 1.6e10 multiply-adds, so in plain FP32 the
// arithmetic (~0.5 ms at 67 TFLOP/s) outweighs the bytes (~0.27 ms at
// 3.35 TB/s). Tensor cores are not used: TF32 would break the 1e-6 parity
// pin of the float route.
//
// Design: one block per month t walks the firm axis in tiles of BN firms.
// x is read in its native (T, N, P) layout, where a tile is BN*P contiguous
// values (one coalesced sweep). The block builds the augmented rows
// [1 | x - c_t | y] and every spec's 0/1 weight in shared memory, so the
// panel is read once for all S specs and no (S, T, N) float weight tensor
// exists in device memory. Each thread owns up to kMaxPerThread fixed
// (s, i, j) entries of the upper triangles and keeps them in registers; the
// block writes each block once, mirroring the triangle. Firms are summed in
// two levels, a per-tile partial and a running total, which keeps the float
// rounding near that of the chunked einsum. No atomics: the result is
// reproducible and the counts are exact.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPerThread = 8;
constexpr int kMaxTile = 128;
constexpr size_t kSmemLimit = 48 * 1024;

template <typename T>
__global__ void gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            const unsigned char* __restrict__ valid,
                            const unsigned int* __restrict__ sel_bits,
                            const T* __restrict__ center, T* __restrict__ out,
                            int t_len, long long n, int p, int s_specs,
                            int tile) {
  extern __shared__ unsigned char smem_raw[];
  const int qe = p + 2;
  T* rows = reinterpret_cast<T*>(smem_raw);  // tile x qe augmented rows
  T* wts = rows + (size_t)tile * qe;         // tile x s_specs weights
  const int t = blockIdx.x;
  const int tri = qe * (qe + 1) / 2;
  const int n_entries = s_specs * tri;

  // this thread's fixed (s, i, j) entries, i <= j
  int es[kMaxPerThread], ei[kMaxPerThread], ej[kMaxPerThread];
  T acc[kMaxPerThread];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    es[k] = 0;
    ei[k] = 0;
    ej[k] = 0;
    acc[k] = T(0);
    if (e < n_entries) {
      int r = e % tri;
      int i = 0;
      while (r >= qe - i) {
        r -= qe - i;
        ++i;
      }
      es[k] = e / tri;
      ei[k] = i;
      ej[k] = i + r;
      mine = k + 1;
    }
  }

  const T* ct = center + (size_t)t * p;
  for (long long n0 = 0; n0 < n; n0 += tile) {
    const int cnt = (n - n0 < tile) ? (int)(n - n0) : tile;
    // 1. raw x tile: cnt * p contiguous values, coalesced
    const T* xt = x + ((long long)t * n + n0) * p;
    for (int idx = threadIdx.x; idx < cnt * p; idx += blockDim.x) {
      const int f = idx / p;
      rows[f * qe + 1 + (idx - f * p)] = xt[idx];
    }
    __syncthreads();
    // 2. one thread per firm: validity bits, centering, y and the weights
    for (int f = threadIdx.x; f < tile; f += blockDim.x) {
      T* row = rows + f * qe;
      T* wf = wts + f * s_specs;
      if (f < cnt) {
        unsigned int bad = 0u;
        for (int c = 0; c < p; ++c) {
          const T v = row[1 + c];
          const bool fin = isfinite(v);
          if (!fin) bad |= 1u << c;
          row[1 + c] = fin ? v - ct[c] : T(0);
        }
        const long long tn = (long long)t * n + n0 + f;
        const T yv = y[tn];
        const bool finy = isfinite(yv);
        row[0] = T(1);
        row[qe - 1] = finy ? yv : T(0);
        for (int s = 0; s < s_specs; ++s) {
          const bool ok = finy && valid[(long long)s * t_len * n + tn] != 0 &&
                          (bad & sel_bits[s]) == 0u;
          wf[s] = ok ? T(1) : T(0);
        }
      } else {
        for (int c = 0; c < qe; ++c) row[c] = T(0);
        for (int s = 0; s < s_specs; ++s) wf[s] = T(0);
      }
    }
    __syncthreads();
    // 3. this tile's partial sums, then into the running totals
    T part[kMaxPerThread];
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) part[k] = T(0);
    for (int f = 0; f < cnt; ++f) {
      const T* row = rows + f * qe;
      const T* wf = wts + f * s_specs;
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) {
        if (k < mine) part[k] = fma(wf[es[k]] * row[ei[k]], row[ej[k]], part[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) acc[k] += part[k];
    __syncthreads();  // the next tile overwrites shared memory
  }

#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    if (k < mine) {
      T* blk = out + ((size_t)es[k] * t_len + t) * qe * qe;
      blk[ei[k] * qe + ej[k]] = acc[k];
      blk[ej[k] * qe + ei[k]] = acc[k];
    }
  }
}

int threads_for(int n_entries) {
  int threads = (n_entries + 3) / 4;  // aim for <= 4 entries a thread
  threads = ((threads + 31) / 32) * 32;
  if (threads < 64) threads = 64;
  if (threads > 1024) threads = 1024;
  return threads;
}

template <typename T>
int launch(const void* x, const void* y, const unsigned char* valid,
           const unsigned int* sel_bits, const void* center, void* out,
           int t_len, long long n, int p, int s_specs, cudaStream_t stream) {
  const int qe = p + 2;
  const int n_entries = s_specs * qe * (qe + 1) / 2;
  const int threads = threads_for(n_entries);
  if ((n_entries + threads - 1) / threads > kMaxPerThread) return -1;
  int tile = kMaxTile;
  while (tile > 1 && (size_t)tile * (qe + s_specs) * sizeof(T) > kSmemLimit)
    tile /= 2;
  const size_t smem = (size_t)tile * (qe + s_specs) * sizeof(T);
  if (smem > kSmemLimit) return -1;
  gram_kernel<T><<<t_len, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), valid, sel_bits,
      static_cast<const T*>(center), static_cast<T*>(out), t_len, n, p,
      s_specs, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 float, 1 double. x (T, N, P), y (T, N), center (T, P) and
// out (S, T, P+2, P+2) in that type; valid (S, T, N) uint8; sel_bits (S,)
// uint32 with bit c set when spec s selects column c. P must be <= 32.
// Returns 0 on success, the cudaError_t of the launch otherwise, or -1 for
// arguments the kernel does not take.
extern "C" int gram_contract(int dtype_code, const void* x, const void* y,
                             const void* valid, const void* sel_bits,
                             const void* center, void* out, int t_len,
                             long long n, int p, int s_specs, void* stream) {
  if (t_len <= 0 || n <= 0 || p < 0 || p > 32 || s_specs <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const unsigned int* b = static_cast<const unsigned int*>(sel_bits);
  if (dtype_code == 0)
    return launch<float>(x, y, v, b, center, out, t_len, n, p, s_specs, s);
  if (dtype_code == 1)
    return launch<double>(x, y, v, b, center, out, t_len, n, p, s_specs, s);
  return -1;
}

extern "C" const char* gram_error_string(int code) {
  if (code == -1) return "invalid arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
