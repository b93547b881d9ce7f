// Host helpers of the direct-solve paths, built with g++ at first use and
// loaded with ctypes (utils/native.py): the IC(0) factorization and its
// triangular solves, the preconditioner of 'eigen-pcg-IC' (the reference's
// Eigen::IncompleteCholesky in linear_solver_factory.cpp:115-130).
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

// Incomplete Cholesky IC(0) on the LOWER-triangular CSR of an SPD matrix.
// `indptr` (n+1) / `indices` (nnz, ascending per row, diagonal last in its
// row) give the pattern; `data` holds A's lower triangle on entry and L on
// exit (A ~= L L^T restricted to the pattern). Like Eigen's implementation,
// a diagonal shift sigma*max|diag| is applied and grown on pivot breakdown
// (1e-3, then x10, at most 12 attempts). Returns the shift used (>= 0), or
// -1.0 if the pattern is not lower-triangular with its diagonal last or
// the factorization keeps breaking.
double ichol0(long long n, const long long* indptr,
              const long long* indices, double* data) {
  std::vector<double> a0(data, data + indptr[n]);
  double dmax = 0.0;
  for (long long i = 0; i < n; ++i) {
    double d = std::fabs(a0[indptr[i + 1] - 1]);
    if (d > dmax) dmax = d;
  }
  double sigma = 0.0;
  for (int attempt = 0; attempt < 12; ++attempt) {
    std::memcpy(data, a0.data(), sizeof(double) * (size_t)indptr[n]);
    if (sigma > 0.0)
      for (long long i = 0; i < n; ++i) data[indptr[i + 1] - 1] += sigma * dmax;
    bool ok = true;
    for (long long i = 0; i < n && ok; ++i) {
      const long long ri0 = indptr[i], ri1 = indptr[i + 1];
      if (ri1 <= ri0 || indices[ri1 - 1] != i) return -1.0;  // bad pattern
      for (long long p = ri0; p < ri1 - 1; ++p) {
        const long long k = indices[p];
        // sparse dot of L-rows i and k over columns < k
        double s = 0.0;
        long long pi = ri0, pk = indptr[k];
        const long long ki1 = indptr[k + 1] - 1;  // k's diagonal position
        while (pi < p && pk < ki1) {
          const long long ci = indices[pi], ck = indices[pk];
          if (ci == ck) { s += data[pi++] * data[pk++]; }
          else if (ci < ck) ++pi;
          else ++pk;
        }
        data[p] = (data[p] - s) / data[ki1];
      }
      double s = 0.0;
      for (long long p = ri0; p < ri1 - 1; ++p) s += data[p] * data[p];
      const double piv = data[ri1 - 1] - s;
      if (piv <= 0.0 || !std::isfinite(piv)) { ok = false; break; }
      data[ri1 - 1] = std::sqrt(piv);
    }
    if (ok) return sigma;
    sigma = (sigma == 0.0) ? 1e-3 : sigma * 10.0;
  }
  return -1.0;
}

// Apply the IC(0) preconditioner: x <- (L L^T)^{-1} x, with L the
// lower-triangular CSR factor from ichol0. Forward substitution in row
// order, then the L^T backward solve as a column sweep over L's rows.
void ichol_solve(long long n, const long long* indptr,
                 const long long* indices, const double* data, double* x) {
  for (long long i = 0; i < n; ++i) {
    double s = x[i];
    const long long r1 = indptr[i + 1] - 1;
    for (long long p = indptr[i]; p < r1; ++p) s -= data[p] * x[indices[p]];
    x[i] = s / data[r1];
  }
  for (long long i = n - 1; i >= 0; --i) {
    const long long r1 = indptr[i + 1] - 1;
    const double xi = x[i] / data[r1];
    x[i] = xi;
    for (long long p = indptr[i]; p < r1; ++p) x[indices[p]] -= data[p] * xi;
  }
}

}  // extern "C"
