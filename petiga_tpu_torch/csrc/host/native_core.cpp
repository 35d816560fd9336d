// Native host-side setup kernels of petiga_tpu_torch (host C++, not GPU
// code): the port's own copy of the JAX package's petiga_tpu/native/core.cpp,
// with the same three extern "C" functions and the same algorithms; the
// closure map wraps negative periodic indices into range (see wrap()).
//
// The device path is PyTorch/CUDA; this library covers the setup-time hot
// paths around it that PetIGA implements in C/Fortran (Cox-de Boor
// tabulation petigabsb.f90.in, closure-map construction
// petigaelem.c:693-755, natural-ordering binary packing petigaio.c), which
// dominate start-up on large meshes (a 256^3 mesh has ~17M elements x 27
// closure entries).
//
// Built at first use by petiga_tpu_torch/native.py with the host C++
// compiler (-O3 -march=native -fPIC -shared -std=c++17) into
// build/petiga_tpu_torch/, and bound through ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Cox-de Boor basis functions + derivatives (Piegl & Tiller A2.3),
// batched over npts evaluation points.
//   U:      knot vector (m+1)
//   p:      degree (<= 10)
//   spans:  (npts) span index per point
//   u:      (npts) evaluation points
//   nder:   number of derivatives (0..nder)
//   out:    (npts, nder+1, p+1) row-major
void bspline_ders(const double* U, int64_t p, const int64_t* spans,
                  const double* u, int64_t npts, int64_t nder,
                  double* out) {
  const int64_t PMAX = 11;
  double ndu[PMAX + 1][PMAX + 1];
  double a[2][PMAX + 1];
  double left[PMAX + 1], right[PMAX + 1];
  const int64_t d = nder < p ? nder : p;

  for (int64_t b = 0; b < npts; ++b) {
    const int64_t i = spans[b];
    const double uu = u[b];
    ndu[0][0] = 1.0;
    for (int64_t j = 1; j <= p; ++j) {
      left[j] = uu - U[i + 1 - j];
      right[j] = U[i + j] - uu;
      double saved = 0.0;
      for (int64_t r = 0; r < j; ++r) {
        ndu[j][r] = right[r + 1] + left[j - r];
        const double temp = ndu[r][j - 1] / ndu[j][r];
        ndu[r][j] = saved + right[r + 1] * temp;
        saved = left[j - r] * temp;
      }
      ndu[j][j] = saved;
    }
    double* o = out + b * (nder + 1) * (p + 1);
    std::memset(o, 0, sizeof(double) * (nder + 1) * (p + 1));
    for (int64_t j = 0; j <= p; ++j) o[j] = ndu[j][p];

    for (int64_t r = 0; r <= p; ++r) {
      int64_t s1 = 0, s2 = 1;
      a[0][0] = 1.0;
      for (int64_t k = 1; k <= d; ++k) {
        double dv = 0.0;
        const int64_t rk = r - k, pk = p - k;
        if (r >= k) {
          a[s2][0] = a[s1][0] / ndu[pk + 1][rk];
          dv = a[s2][0] * ndu[rk][pk];
        }
        const int64_t j1 = rk >= -1 ? 1 : -rk;
        const int64_t j2 = (r - 1 <= pk) ? k - 1 : p - r;
        for (int64_t j = j1; j <= j2; ++j) {
          a[s2][j] = (a[s1][j] - a[s1][j - 1]) / ndu[pk + 1][rk + j];
          dv += a[s2][j] * ndu[rk + j][pk];
        }
        if (r <= pk) {
          a[s2][k] = -a[s1][k - 1] / ndu[pk + 1][r];
          dv += a[s2][k] * ndu[r][pk];
        }
        o[k * (p + 1) + r] = dv;
        const int64_t tmp = s1;
        s1 = s2;
        s2 = tmp;
      }
    }
    double fac = (double)p;
    for (int64_t k = 1; k <= d; ++k) {
      for (int64_t j = 0; j <= p; ++j) o[k * (p + 1) + j] *= fac;
      fac *= (double)(p - k);
    }
  }
}

// Non-negative i mod n: a periodic collocation axis has offsets of -1
// (the Greville shift), where C++'s % would give a negative index.
static inline int64_t wrap(int64_t i, int64_t n) {
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

// Element closure map (petigaelem.c:693-755): flat control-point index
// per (element, local basis) with periodic wrap, axis-0-fastest
// conventions.  dim <= 3; per-axis inputs are padded to 3.
void build_mapping(int64_t dim,
                   const int64_t* nel,      // (3,)
                   const int64_t* nen,      // (3,) = p+1
                   const int64_t* nnp,      // (3,)
                   const int64_t* const* offsets,  // per-axis (nel_d)
                   int32_t* out             // (prod nel, prod nen)
) {
  const int64_t ne0 = nel[0], ne1 = dim > 1 ? nel[1] : 1,
                ne2 = dim > 2 ? nel[2] : 1;
  const int64_t nn0 = nen[0], nn1 = dim > 1 ? nen[1] : 1,
                nn2 = dim > 2 ? nen[2] : 1;
  const int64_t N0 = nnp[0], N1 = dim > 1 ? nnp[1] : 1;
  const int64_t nenf = nn0 * nn1 * nn2;

  int64_t e = 0;
  for (int64_t e2 = 0; e2 < ne2; ++e2)
    for (int64_t e1 = 0; e1 < ne1; ++e1)
      for (int64_t e0 = 0; e0 < ne0; ++e0, ++e) {
        const int64_t o0 = offsets[0][e0];
        const int64_t o1 = dim > 1 ? offsets[1][e1] : 0;
        const int64_t o2 = dim > 2 ? offsets[2][e2] : 0;
        int32_t* row = out + e * nenf;
        int64_t a = 0;
        for (int64_t a2 = 0; a2 < nn2; ++a2)
          for (int64_t a1 = 0; a1 < nn1; ++a1)
            for (int64_t a0 = 0; a0 < nn0; ++a0, ++a) {
              const int64_t i0 = wrap(o0 + a0, nnp[0]);
              const int64_t i1 = dim > 1 ? wrap(o1 + a1, nnp[1]) : 0;
              const int64_t i2 = dim > 2 ? wrap(o2 + a2, nnp[2]) : 0;
              row[a] = (int32_t)(i0 + N0 * (i1 + N1 * i2));
            }
      }
}

// Big-endian <-> native float64 byte swap (PETSc binary packing,
// petigaio.c natural-order vectors).
void byteswap_f64(const double* in, int64_t n, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t v;
    std::memcpy(&v, in + i, 8);
    v = __builtin_bswap64(v);
    std::memcpy(out + i, &v, 8);
  }
}

}  // extern "C"
