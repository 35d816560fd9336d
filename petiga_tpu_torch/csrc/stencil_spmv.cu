// Stencil SpMV kernels for Hopper (sm_90a): the full-storage and the
// symmetric (upper-slot) product of a tensor-product IGA operator.
//
// Replaces the three Pallas kernels of petiga_tpu/sparse/pallas_spmv.py:
//   stencil_spmv_full <- _flat_spmv (x held on chip) and _flat_spmv_hbm
//                        (x streamed by DMA windows).  The TPU needed two
//                        variants only because x outgrew its on-chip
//                        memory; here x is read through L1/L2 and one
//                        kernel serves every size.
//   stencil_spmv_sym  <- _flat_spmv_sym (mirrored-slot symmetric storage).
//
// Layout (see petiga_tpu_torch/sparse/spmv.py):
//   DT  (P, next) slot-major planes, plane (s*DOF + a)*DOF + b, one column
//       per node of the extended grid (next nodes).
//   x   (DOF, G + next + G) packed vector; slot s reads x[G + n + c_s],
//       with |c_s| <= G, so no bounds check is needed.
//   y   same layout as x; the kernels write the interior [G, G + next)
//       and leave the guards to the caller (allocated zero).
//
// What bounds them: the planes are read exactly once per apply,
// P * next * sizeof(T) bytes (K*DOF^2 planes full, Ku*DOF^2 symmetric),
// against O(DOF * next) for x and y.  Both are memory-bound streams.  The
// design keeps the plane stream coalesced: one thread per row n (grid
// stride), so a warp reads 32 consecutive entries of each plane, and the
// K shifted x reads of neighbouring rows hit the same cache lines.  The
// slot shifts sit in shared memory; accumulation is in DOF registers.
// The symmetric kernel gathers its mirror term instead of scattering it:
// row n adds D_c[n-c]^T x[n-c], which re-reads each stored plane at a
// shift of -c.  Rows n and n-c are at most G apart, so that second read
// is meant to be served by L2 rather than device memory; no atomics and
// no ring buffer.
//
// dof 1-3 take kernels templated on the dof (accumulators in registers);
// any larger dof takes the *_any kernels, with the dof a runtime bound.
//
// Every flat offset is 64-bit: at 256^3 elements, p=2, plane offsets
// reach 124 * 17,173,512 + n, within 1e6 of 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 1024;
constexpr int kErrBadDof = 10001;
constexpr int kErrBadSlots = 10002;
constexpr int kErrBadSize = 10003;

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }

__device__ __forceinline__ void load_shifts(int* sh, const int* shifts,
                                            int nslots) {
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) sh[i] = shifts[i];
  __syncthreads();
}

// y[a][n] = sum_{s<K} sum_b DT[(s*DOF+a)*DOF+b][n] * x_b[n + c_s]
template <typename T, int DOF>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_full(const T* __restrict__ DT, const T* __restrict__ xb,
                  T* __restrict__ yb, const int* __restrict__ shifts, int K,
                  int64_t next, int64_t G) {
  __shared__ int sh[kMaxSlots];
  load_shifts(sh, shifts, K);
  const int64_t seg = next + 2 * G;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < next;
       n += step) {
    T acc[DOF];
#pragma unroll
    for (int a = 0; a < DOF; ++a) acc[a] = T(0);
    const T* xn = xb + G + n;
    const T* dn = DT + n;
#pragma unroll 5
    for (int s = 0; s < K; ++s) {
      const int64_t c = sh[s];
      const T* ds = dn + (int64_t)s * (DOF * DOF) * next;
#pragma unroll
      for (int b = 0; b < DOF; ++b) {
        const T xv = ld(xn + b * seg + c);
#pragma unroll
        for (int a = 0; a < DOF; ++a)
          acc[a] = fma(ld(ds + (int64_t)(a * DOF + b) * next), xv, acc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < DOF; ++a) yb[a * seg + G + n] = acc[a];
  }
}

// Upper slots ku = 0..Ku-1 with shifts c_0 = 0 <= c_ku:
//   direct  y_a[n] += sum_b D[(ku*DOF+a)*DOF+b][n]   * x_b[n + c]
//   mirror  y_b[n] += sum_a D[(ku*DOF+a)*DOF+b][n-c] * x_a[n - c]  (ku >= 1,
//           n >= c; rows n - c < 0 do not exist)
template <typename T, int DOF>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_sym(const T* __restrict__ DT, const T* __restrict__ xb,
                 T* __restrict__ yb, const int* __restrict__ shifts, int Ku,
                 int64_t next, int64_t G) {
  __shared__ int sh[kMaxSlots];
  load_shifts(sh, shifts, Ku);
  const int64_t seg = next + 2 * G;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < next;
       n += step) {
    T acc[DOF];
#pragma unroll
    for (int a = 0; a < DOF; ++a) acc[a] = T(0);
    const T* xn = xb + G + n;
    const T* dn = DT + n;
    for (int ku = 0; ku < Ku; ++ku) {
      const int64_t c = sh[ku];
      const T* ds = dn + (int64_t)ku * (DOF * DOF) * next;
#pragma unroll
      for (int b = 0; b < DOF; ++b) {
        const T xv = ld(xn + b * seg + c);
#pragma unroll
        for (int a = 0; a < DOF; ++a)
          acc[a] = fma(ld(ds + (int64_t)(a * DOF + b) * next), xv, acc[a]);
      }
      if (ku > 0 && n >= c) {
        const T* dm = ds - c;
#pragma unroll
        for (int a = 0; a < DOF; ++a) {
          const T xm = ld(xn + a * seg - c);
#pragma unroll
          for (int b = 0; b < DOF; ++b)
            acc[b] = fma(ld(dm + (int64_t)(a * DOF + b) * next), xm, acc[b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < DOF; ++a) yb[a * seg + G + n] = acc[a];
  }
}

// Any dof (the generic path, taken for dof >= 4): the dof is a runtime
// loop bound, so the accumulators cannot live in a fixed register array.
// Each thread walks its row's outputs one at a time: output a sums
// D[(s*dof+a)*dof+b][n] * x_b[n + c_s] over s, then b, in the order of
// the templated kernels, so every plane entry is still read exactly once
// per apply; x is re-read dof times per slot, from L1/L2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_full_any(const T* __restrict__ DT, const T* __restrict__ xb,
                      T* __restrict__ yb, const int* __restrict__ shifts, int K,
                      int dof, int64_t next, int64_t G) {
  __shared__ int sh[kMaxSlots];
  load_shifts(sh, shifts, K);
  const int64_t seg = next + 2 * G;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t dd = (int64_t)dof * dof;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < next;
       n += step) {
    const T* xn = xb + G + n;
    const T* dn = DT + n;
    for (int a = 0; a < dof; ++a) {
      T acc = T(0);
      for (int s = 0; s < K; ++s) {
        const int64_t c = sh[s];
        const T* ds = dn + ((int64_t)s * dd + (int64_t)a * dof) * next;
        for (int b = 0; b < dof; ++b)
          acc = fma(ld(ds + (int64_t)b * next), ld(xn + b * seg + c), acc);
      }
      yb[a * seg + G + n] = acc;
    }
  }
}

// The symmetric product for any dof: output o takes, slot by slot, the
// direct term sum_b D[(ku*dof+o)*dof+b][n] x_b[n + c], then the mirror
// term sum_a D[(ku*dof+a)*dof+o][n-c] x_a[n - c] (the block transposed).
template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_sym_any(const T* __restrict__ DT, const T* __restrict__ xb,
                     T* __restrict__ yb, const int* __restrict__ shifts, int Ku,
                     int dof, int64_t next, int64_t G) {
  __shared__ int sh[kMaxSlots];
  load_shifts(sh, shifts, Ku);
  const int64_t seg = next + 2 * G;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t dd = (int64_t)dof * dof;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < next;
       n += step) {
    const T* xn = xb + G + n;
    const T* dn = DT + n;
    for (int o = 0; o < dof; ++o) {
      T acc = T(0);
      for (int ku = 0; ku < Ku; ++ku) {
        const int64_t c = sh[ku];
        const T* ds = dn + (int64_t)ku * dd * next;
        for (int b = 0; b < dof; ++b)
          acc = fma(ld(ds + ((int64_t)o * dof + b) * next), ld(xn + b * seg + c),
                    acc);
        if (ku > 0 && n >= c) {
          const T* dm = ds - c;
          for (int a = 0; a < dof; ++a)
            acc = fma(ld(dm + ((int64_t)a * dof + o) * next),
                      ld(xn + a * seg - c), acc);
        }
      }
      yb[o * seg + G + n] = acc;
    }
  }
}

unsigned grid_for(int64_t next) {
  int64_t blocks = (next + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 30;
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename T>
int launch(bool sym, const T* DT, const T* xb, T* yb, const int* shifts,
           int nslots, int dof, long long next, long long G,
           cudaStream_t stream) {
  if (nslots < 1 || nslots > kMaxSlots) return kErrBadSlots;
  if (next < 1 || G < 0) return kErrBadSize;
  const unsigned grid = grid_for(next);
#define PTT_LAUNCH(D)                                                       \
  if (sym)                                                                  \
    stencil_spmv_sym<T, D><<<grid, kThreads, 0, stream>>>(                  \
        DT, xb, yb, shifts, nslots, (int64_t)next, (int64_t)G);             \
  else                                                                      \
    stencil_spmv_full<T, D><<<grid, kThreads, 0, stream>>>(                 \
        DT, xb, yb, shifts, nslots, (int64_t)next, (int64_t)G);
  switch (dof) {
    case 1: PTT_LAUNCH(1) break;
    case 2: PTT_LAUNCH(2) break;
    case 3: PTT_LAUNCH(3) break;
    default:
      if (dof < 1) return kErrBadDof;
      if (sym)
        stencil_spmv_sym_any<T><<<grid, kThreads, 0, stream>>>(
            DT, xb, yb, shifts, nslots, dof, (int64_t)next, (int64_t)G);
      else
        stencil_spmv_full_any<T><<<grid, kThreads, 0, stream>>>(
            DT, xb, yb, shifts, nslots, dof, (int64_t)next, (int64_t)G);
  }
#undef PTT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ptt_spmv_full_f32(const float* DT, const float* xb, float* yb,
                      const int* shifts, int K, int dof, long long next,
                      long long G, void* stream) {
  return launch<float>(false, DT, xb, yb, shifts, K, dof, next, G,
                       (cudaStream_t)stream);
}

int ptt_spmv_full_f64(const double* DT, const double* xb, double* yb,
                      const int* shifts, int K, int dof, long long next,
                      long long G, void* stream) {
  return launch<double>(false, DT, xb, yb, shifts, K, dof, next, G,
                        (cudaStream_t)stream);
}

int ptt_spmv_sym_f32(const float* DT, const float* xb, float* yb,
                     const int* shifts, int Ku, int dof, long long next,
                     long long G, void* stream) {
  return launch<float>(true, DT, xb, yb, shifts, Ku, dof, next, G,
                       (cudaStream_t)stream);
}

int ptt_spmv_sym_f64(const double* DT, const double* xb, double* yb,
                     const int* shifts, int Ku, int dof, long long next,
                     long long G, void* stream) {
  return launch<double>(true, DT, xb, yb, shifts, Ku, dof, next, G,
                        (cudaStream_t)stream);
}

const char* ptt_error_string(int code) {
  switch (code) {
    case kErrBadDof: return "stencil SpMV: dof must be at least 1";
    case kErrBadSlots: return "stencil SpMV: slot count out of range";
    case kErrBadSize: return "stencil SpMV: bad vector size or guard";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
