// Per-particle 2x2 / 3x3 algebra shared by the fused kernels: the Jacobi
// symmetric eigensolver, the SVD built on it, and the constitutive models'
// sigma-space derivatives. Everything is __host__ __device__ and works on
// fixed-size arrays, so a thread keeps a whole particle's chain in registers.
//
// The algorithm is the one of hot_tpu_torch/ops/svd.py (and of the TPU
// kernel hot_tpu/ops/pallas_linearize.py:_svd_tiles): cyclic Jacobi on F^T F
// (one rotation in 2D, `sweeps` sweeps in 3D), a descending sort with a
// parity fix so det(V) = +1, Givens QR of F V, and a sign fix that keeps
// det(U) = +1 and leaves sigma[d-1] < 0 iff det(F) < 0. The rotation angle
// is the algebraic form t = sign(tau) / (|tau| + sqrt(1 + tau^2)), which
// takes the same rotations as the atan2 form up to a permutation and paired
// column signs; results are compared through sign-invariant quantities.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace hot {

template <typename T> struct Eps;
template <> struct Eps<float> {
  static constexpr float jacobi = 1e-20f;  // |apq| below this: no rotation
  static constexpr float givens = 1e-30f;  // a^2 + b^2 below this: identity
  static constexpr float pair = 1e-6f;     // clamp of |s_i + s_j| in b+
};
template <> struct Eps<double> {
  static constexpr double jacobi = 1e-30;
  static constexpr double givens = 1e-38;
  static constexpr double pair = 1e-10;
};

HD float sqrt_(float x) { return sqrtf(x); }
HD double sqrt_(double x) { return sqrt(x); }
HD float floor_(float x) { return floorf(x); }
HD double floor_(double x) { return floor(x); }
HD float log_(float x) { return logf(x); }
HD double log_(double x) { return log(x); }
HD float log1p_(float x) { return log1pf(x); }
HD double log1p_(double x) { return log1p(x); }
template <typename T> HD T abs_(T x) { return x < T(0) ? -x : x; }
template <typename T> HD T max_(T a, T b) { return a > b ? a : b; }
template <typename T> HD T min_(T a, T b) { return a < b ? a : b; }

template <int D> struct Pairs;
template <> struct Pairs<2> {
  static constexpr int n = 1;
  HD static int i(int) { return 0; }
  HD static int j(int) { return 1; }
};
template <> struct Pairs<3> {
  static constexpr int n = 3;
  HD static int i(int k) { return k == 2 ? 1 : 0; }
  HD static int j(int k) { return k == 0 ? 1 : 2; }
};

// S <- G^T S G and V <- V G for G = I except G[p][p] = G[q][q] = c,
// G[p][q] = -s, G[q][p] = s.
template <typename T, int D>
HD void rotate_sym(T S[D][D], T V[D][D], int p, int q, T c, T s) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    T a = S[r][p], b = S[r][q];
    S[r][p] = a * c + b * s;
    S[r][q] = b * c - a * s;
  }
#pragma unroll
  for (int col = 0; col < D; ++col) {
    T a = S[p][col], b = S[q][col];
    S[p][col] = c * a + s * b;
    S[q][col] = c * b - s * a;
  }
#pragma unroll
  for (int r = 0; r < D; ++r) {
    T a = V[r][p], b = V[r][q];
    V[r][p] = a * c + b * s;
    V[r][q] = b * c - a * s;
  }
}

template <typename T>
HD void jacobi_cs(T app, T aqq, T apq, T& c, T& s) {
  bool small = abs_(apq) < Eps<T>::jacobi;
  T apq_s = small ? T(1) : apq;
  T tau = (app - aqq) / (T(2) * apq_s);
  T sign_tau = tau >= T(0) ? T(1) : T(-1);
  T t = sign_tau / (abs_(tau) + sqrt_(T(1) + tau * tau));
  T cc = T(1) / sqrt_(T(1) + t * t);
  c = small ? T(1) : cc;
  s = small ? T(0) : t * cc;
}

template <typename T, int D>
HD void swap_cols(T w[D], T V[D][D], T& parity, int i, int j) {
  if (w[i] < w[j]) {
    T tw = w[i]; w[i] = w[j]; w[j] = tw;
#pragma unroll
    for (int r = 0; r < D; ++r) { T t = V[r][i]; V[r][i] = V[r][j]; V[r][j] = t; }
    parity = -parity;
  }
}

// Symmetric S (destroyed) = Q diag(w) Q^T, w descending, det(Q) = +1.
template <typename T, int D>
HD void eigh_sym(T S[D][D], T w[D], T Q[D][D], int sweeps) {
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) Q[a][b] = a == b ? T(1) : T(0);
  const int n_sweeps = D == 2 ? 1 : sweeps;
  for (int sw = 0; sw < n_sweeps; ++sw) {
#pragma unroll
    for (int k = 0; k < Pairs<D>::n; ++k) {
      const int p = Pairs<D>::i(k), q = Pairs<D>::j(k);
      T c, s;
      jacobi_cs(S[p][p], S[q][q], S[p][q], c, s);
      rotate_sym<T, D>(S, Q, p, q, c, s);
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) w[a] = S[a][a];
  T parity = T(1);
  swap_cols<T, D>(w, Q, parity, 0, 1);
  if constexpr (D == 3) {
    swap_cols<T, D>(w, Q, parity, 0, 2);
    swap_cols<T, D>(w, Q, parity, 1, 2);
  }
#pragma unroll
  for (int r = 0; r < D; ++r) Q[r][D - 1] *= parity;
}

// Sylvester's criterion: every leading principal minor of symmetric S > 0.
template <typename T, int D>
HD bool positive_definite(const T S[D][D]) {
  if (!(S[0][0] > T(0))) return false;
  const T m2 = S[0][0] * S[1][1] - S[0][1] * S[1][0];
  if constexpr (D == 2) {
    return m2 > T(0);
  } else {
    const T det = S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1]) -
                  S[0][1] * (S[1][0] * S[2][2] - S[1][2] * S[2][0]) +
                  S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]);
    return m2 > T(0) && det > T(0);
  }
}

// F = U diag(sigma) V^T (see the header note for the conventions).
template <typename T, int D>
HD void svd(const T F[D][D], T U[D][D], T sigma[D], T V[D][D], int sweeps) {
  T S[D][D], w[D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T acc = F[0][a] * F[0][b];
#pragma unroll
      for (int c = 1; c < D; ++c) acc += F[c][a] * F[c][b];
      S[a][b] = acc;
    }
  eigh_sym<T, D>(S, w, V, sweeps);
  T R[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      T acc = F[a][0] * V[0][b];
#pragma unroll
      for (int c = 1; c < D; ++c) acc += F[a][c] * V[c][b];
      R[a][b] = acc;
      U[a][b] = a == b ? T(1) : T(0);
    }
  // Givens QR: zero R[i][j] below the diagonal by rotating rows (j, i)
#pragma unroll
  for (int k = 0; k < Pairs<D>::n; ++k) {
    const int i = D == 2 ? 1 : (k == 2 ? 2 : k + 1);
    const int j = D == 2 ? 0 : (k == 2 ? 1 : 0);
    T a = R[j][j], b = R[i][j];
    T r2 = a * a + b * b;
    bool small = r2 < Eps<T>::givens;
    T inv = small ? T(0) : T(1) / sqrt_(r2);
    T c = small ? T(1) : a * inv;
    T s = small ? T(0) : b * inv;
#pragma unroll
    for (int col = 0; col < D; ++col) {
      T rj = R[j][col], ri = R[i][col];
      R[j][col] = c * rj + s * ri;
      R[i][col] = c * ri - s * rj;
    }
#pragma unroll
    for (int r = 0; r < D; ++r) {
      T uj = U[r][j], ui = U[r][i];
      U[r][j] = uj * c + ui * s;
      U[r][i] = ui * c - uj * s;
    }
  }
  T signs[D], total = T(1);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    signs[a] = R[a][a] >= T(0) ? T(1) : T(-1);
    total *= signs[a];
  }
  signs[D - 1] *= total;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    sigma[a] = R[a][a] * signs[a];
#pragma unroll
    for (int r = 0; r < D; ++r) U[r][a] *= signs[a];
  }
}

// ---------------------------------------------------------------------------
// Constitutive models: g = dpsi/dsigma, A = d2psi/dsigma2 and the stable pair
// quotient bm = (g_i - g_j)/(s_i - s_j), as hot_tpu_torch/models/constitutive.py.
// ---------------------------------------------------------------------------

template <typename T, int D>
HD void others_product(const T s[D], T Jp[D], T d2J[3]) {
  if constexpr (D == 2) {
    Jp[0] = s[1]; Jp[1] = s[0];
    d2J[0] = T(1);
  } else {
    Jp[0] = s[1] * s[2]; Jp[1] = s[0] * s[2]; Jp[2] = s[0] * s[1];
    d2J[0] = s[2]; d2J[1] = s[1]; d2J[2] = s[0];  // pairs (0,1), (0,2), (1,2)
  }
}

struct FixedCorotated {
  template <typename T, int D>
  HD static void derivs(const T s[D], T mu, T lam, T g[D], T A[D][D], T bm[3]) {
    T J = s[0];
#pragma unroll
    for (int a = 1; a < D; ++a) J *= s[a];
    T Jp[D], d2J[3];
    others_product<T, D>(s, Jp, d2J);
#pragma unroll
    for (int a = 0; a < D; ++a) g[a] = T(2) * mu * (s[a] - T(1)) + lam * (J - T(1)) * Jp[a];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) A[a][b] = lam * Jp[a] * Jp[b] + (a == b ? T(2) * mu : T(0));
#pragma unroll
    for (int k = 0; k < Pairs<D>::n; ++k) {
      const int i = Pairs<D>::i(k), j = Pairs<D>::j(k);
      T off = lam * (J - T(1)) * d2J[k];
      A[i][j] += off;
      A[j][i] += off;
      // closed form: 2 mu - lam (J - 1) s_other (2D: s_other = 1)
      bm[k] = T(2) * mu - lam * (J - T(1)) * d2J[k];
    }
  }
};

struct StvkHencky {
  template <typename T, int D>
  HD static void derivs(const T sig[D], T mu, T lam, T g[D], T A[D][D], T bm[3]) {
    const T floor_ = T(1e-6);
    T s[D], eps[D], fr[D], tr = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      fr[a] = sig[a] > floor_ ? T(1) : T(0);
      s[a] = max_(sig[a], floor_);
      eps[a] = log_(s[a]);
      tr += eps[a];
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T t = T(2) * mu * eps[a] + lam * tr;
      g[a] = fr[a] * t / s[a];
#pragma unroll
      for (int b = 0; b < D; ++b)
        A[a][b] = a == b ? fr[a] * ((T(2) * mu + lam) - t) / (s[a] * s[a])
                         : lam * (fr[a] / s[a]) * (fr[b] / s[b]);
    }
#pragma unroll
    for (int k = 0; k < Pairs<D>::n; ++k) {
      const int i = Pairs<D>::i(k), j = Pairs<D>::j(k);
      T si = s[i], sj = s[j];
      T z = (si - sj) / (si + sj);
      bool small_z = abs_(z) < T(1e-4);
      T z_safe = small_z ? T(1) : z;
      T atz = small_z ? T(1) + z * z / T(3)
                      : (log1p_(z_safe) - log1p_(-z_safe)) / (T(2) * z_safe);
      T L = T(2) / (si + sj) * atz;
      T closed = (T(2) * mu * (sj * L - log_(sj)) - lam * tr) / (si * sj);
      // hybrid: direct quotient when well separated, closed form when nearly
      // repeated, 0 when nearly repeated below the clamp
      T delta = sig[i] - sig[j];
      T scale = abs_(sig[i]) + abs_(sig[j]) + T(1);
      bool well_sep = abs_(delta) > T(1e-3) * scale;
      T direct = (g[i] - g[j]) / (well_sep ? delta : T(1));
      bool smooth = min_(sig[i], sig[j]) > T(2e-6);
      bm[k] = well_sep ? direct : (smooth ? closed : T(0));
    }
  }
};

// Neo-Hookean: psi = mu/2 (sum s^2 - d) - mu log J + lam/2 log^2 J with sigma
// clamped at 1e-6; the clamp's derivative is 0 below it (fr).
struct NeoHookean {
  template <typename T, int D>
  HD static void derivs(const T sig[D], T mu, T lam, T g[D], T A[D][D], T bm[3]) {
    const T floor_ = T(1e-6);
    T s[D], fr[D], logJ = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      fr[a] = sig[a] > floor_ ? T(1) : T(0);
      s[a] = max_(sig[a], floor_);
      logJ += log_(s[a]);
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      g[a] = fr[a] * (mu * s[a] + (lam * logJ - mu) / s[a]);
#pragma unroll
      for (int b = 0; b < D; ++b)
        A[a][b] = a == b ? fr[a] * (mu + (mu + lam - lam * logJ) / (s[a] * s[a]))
                         : lam * (fr[a] / s[a]) * (fr[b] / s[b]);
    }
#pragma unroll
    for (int k = 0; k < Pairs<D>::n; ++k) {
      const int i = Pairs<D>::i(k), j = Pairs<D>::j(k);
      const T closed = mu + (mu - lam * logJ) / (s[i] * s[j]);
      // the hybrid of StvkHencky: the direct quotient where well separated
      const T delta = sig[i] - sig[j];
      const T scale = abs_(sig[i]) + abs_(sig[j]) + T(1);
      const bool well_sep = abs_(delta) > T(1e-3) * scale;
      const T direct = (g[i] - g[j]) / (well_sep ? delta : T(1));
      const bool smooth = min_(sig[i], sig[j]) > T(2e-6);
      bm[k] = well_sep ? direct : (smooth ? closed : T(0));
    }
  }
};

// Linear corotated: psi = mu ||S - I||^2 + lam/2 tr(S - I)^2; b- = 2 mu.
struct LinearCorotated {
  template <typename T, int D>
  HD static void derivs(const T sig[D], T mu, T lam, T g[D], T A[D][D], T bm[3]) {
    T tr = T(0);
#pragma unroll
    for (int a = 0; a < D; ++a) tr += sig[a] - T(1);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      g[a] = T(2) * mu * (sig[a] - T(1)) + lam * tr;
#pragma unroll
      for (int b = 0; b < D; ++b) A[a][b] = lam + (a == b ? T(2) * mu : T(0));
    }
#pragma unroll
    for (int k = 0; k < Pairs<D>::n; ++k) bm[k] = T(2) * mu;
  }
};

}  // namespace hot
