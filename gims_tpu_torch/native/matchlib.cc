// GIMS native support library (the port's own copy; host C++, no kernel).
//
// Native-code equivalent of the capability represented by the reference's
// CPPbridge/libDA binding (reference: utils/library.py:433-580): a
// brute-force L2 KNN descriptor matcher with query-node iteration, a
// RANSAC geometric filter (homography / fundamental), and the
// FastMatCombi incremental similarity-combination kernel. Exposed with
// the same C symbol surface so the Python bridge is a drop-in.
//
// Build: gims_tpu_torch/native/bridge.py compiles it at first use with
//   g++ -O3 -fPIC -std=c++17 -shared -o gims_tpu_torch/_build/libgims_native_<hash>.so matchlib.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

// ---------- small linear algebra ----------

// Solve A x = b for an n x n system via Gaussian elimination with
// partial pivoting. Returns false if singular.
bool solve(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(A[r * n + col]) > std::fabs(A[piv * n + col])) piv = r;
    if (std::fabs(A[piv * n + col]) < 1e-12) return false;
    if (piv != col) {
      for (int c = 0; c < n; ++c) std::swap(A[piv * n + c], A[col * n + c]);
      std::swap(b[piv], b[col]);
    }
    for (int r = col + 1; r < n; ++r) {
      double f = A[r * n + col] / A[col * n + col];
      for (int c = col; c < n; ++c) A[r * n + c] -= f * A[col * n + c];
      b[r] -= f * b[col];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    double s = b[r];
    for (int c = r + 1; c < n; ++c) s -= A[r * n + c] * b[c];
    b[r] = s / A[r * n + r];
  }
  return true;
}

// Homography from 4 point pairs (DLT, 8x8 linear system, h22 = 1).
bool homography4(const double* src, const double* dst, double H[9]) {
  std::vector<double> A(64, 0.0), b(8, 0.0);
  for (int i = 0; i < 4; ++i) {
    double x = src[2 * i], y = src[2 * i + 1];
    double u = dst[2 * i], v = dst[2 * i + 1];
    double* r1 = &A[(2 * i) * 8];
    double* r2 = &A[(2 * i + 1) * 8];
    r1[0] = x; r1[1] = y; r1[2] = 1; r1[6] = -u * x; r1[7] = -u * y;
    r2[3] = x; r2[4] = y; r2[5] = 1; r2[6] = -v * x; r2[7] = -v * y;
    b[2 * i] = u;
    b[2 * i + 1] = v;
  }
  if (!solve(A, b, 8)) return false;
  for (int i = 0; i < 8; ++i) H[i] = b[i];
  H[8] = 1.0;
  return true;
}

double reproj_err2(const double H[9], double x, double y, double u, double v) {
  double w = H[6] * x + H[7] * y + H[8];
  if (std::fabs(w) < 1e-12) return 1e18;
  double px = (H[0] * x + H[1] * y + H[2]) / w;
  double py = (H[3] * x + H[4] * y + H[5]) / w;
  double dx = px - u, dy = py - v;
  return dx * dx + dy * dy;
}

// Fundamental matrix from 8 pairs (normalized 8-point, least squares on
// the nullspace via normal equations + power iteration fallback).
bool fundamental8(const double* src, const double* dst, int n, double F[9]) {
  // normalize
  double cx0 = 0, cy0 = 0, cx1 = 0, cy1 = 0;
  for (int i = 0; i < n; ++i) {
    cx0 += src[2 * i]; cy0 += src[2 * i + 1];
    cx1 += dst[2 * i]; cy1 += dst[2 * i + 1];
  }
  cx0 /= n; cy0 /= n; cx1 /= n; cy1 /= n;
  double s0 = 0, s1 = 0;
  for (int i = 0; i < n; ++i) {
    s0 += std::hypot(src[2 * i] - cx0, src[2 * i + 1] - cy0);
    s1 += std::hypot(dst[2 * i] - cx1, dst[2 * i + 1] - cy1);
  }
  s0 = n * std::sqrt(2.0) / std::max(s0, 1e-12);
  s1 = n * std::sqrt(2.0) / std::max(s1, 1e-12);

  // build A^T A (9x9) of the epipolar constraints
  double AtA[81] = {0};
  for (int i = 0; i < n; ++i) {
    double x = (src[2 * i] - cx0) * s0, y = (src[2 * i + 1] - cy0) * s0;
    double u = (dst[2 * i] - cx1) * s1, v = (dst[2 * i + 1] - cy1) * s1;
    double row[9] = {u * x, u * y, u, v * x, v * y, v, x, y, 1.0};
    for (int a = 0; a < 9; ++a)
      for (int b = 0; b < 9; ++b) AtA[a * 9 + b] += row[a] * row[b];
  }
  // smallest eigenvector via inverse power iteration on (AtA + eps I)
  for (int a = 0; a < 9; ++a) AtA[a * 9 + a] += 1e-9;
  double f[9];
  for (int a = 0; a < 9; ++a) f[a] = 1.0 / 3.0;
  for (int it = 0; it < 60; ++it) {
    std::vector<double> M(AtA, AtA + 81), rhs(f, f + 9);
    if (!solve(M, rhs, 9)) return false;
    double norm = 0;
    for (int a = 0; a < 9; ++a) norm += rhs[a] * rhs[a];
    norm = std::sqrt(norm);
    for (int a = 0; a < 9; ++a) f[a] = rhs[a] / norm;
  }
  // denormalize: F = T1^T Fn T0
  double T0[9] = {s0, 0, -s0 * cx0, 0, s0, -s0 * cy0, 0, 0, 1};
  double T1[9] = {s1, 0, -s1 * cx1, 0, s1, -s1 * cy1, 0, 0, 1};
  double tmp[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      tmp[r * 3 + c] = 0;
      for (int k = 0; k < 3; ++k)
        tmp[r * 3 + c] += T1[k * 3 + r] * f[k * 3 + c];
    }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      F[r * 3 + c] = 0;
      for (int k = 0; k < 3; ++k)
        F[r * 3 + c] += tmp[r * 3 + k] * T0[k * 3 + c];
    }
  return true;
}

double sampson_err2(const double F[9], double x, double y, double u, double v) {
  double Fx0 = F[0] * x + F[1] * y + F[2];
  double Fx1 = F[3] * x + F[4] * y + F[5];
  double Fx2 = F[6] * x + F[7] * y + F[8];
  double Ftu0 = F[0] * u + F[3] * v + F[6];
  double Ftu1 = F[1] * u + F[4] * v + F[7];
  double num = u * Fx0 + v * Fx1 + Fx2;
  double den = Fx0 * Fx0 + Fx1 * Fx1 + Ftu0 * Ftu0 + Ftu1 * Ftu1;
  if (den < 1e-18) return 1e18;
  return num * num / den;
}

// ---------- KNN matcher state ----------

struct QueryNode {
  int query_idx;
  std::vector<int> target_idxs;
  std::vector<float> sims;
};

struct Matcher {
  int k = 1;
  int dim = 128;
  float sim_thres = 0.7f;
  std::vector<QueryNode> nodes;
  std::vector<float> qkps, tkps;  // (N, 2) flattened
  // filtered matches after GeometricFilterFromNodes: (q, t, sim_rank)
  std::vector<int> filtered;
};

}  // namespace

extern "C" {

void* newMatcher(int k, int desc_dim, float sim_thres) {
  auto* m = new Matcher();
  m->k = std::max(k, 1);
  m->dim = desc_dim;
  m->sim_thres = sim_thres;
  return m;
}

void deleteMatcher(void* ptr) { delete static_cast<Matcher*>(ptr); }

// Brute-force k-NN by L2 distance; keeps per-query nodes whose
// nearest/second-nearest ratio passes sim_thres (Lowe-style gate when
// k >= 2; plain nearest otherwise).
void KnnMatcher(void* ptr, float* qkps, float* qdesc, int nq,
                float* tkps, float* tdesc, int nt, int /*fast_code*/) {
  auto* m = static_cast<Matcher*>(ptr);
  m->nodes.clear();
  m->filtered.clear();
  m->qkps.assign(qkps, qkps + 2 * nq);
  m->tkps.assign(tkps, tkps + 2 * nt);
  const int d = m->dim;
  const int k = std::min(m->k, nt);
  std::vector<std::pair<float, int>> dists(nt);
  for (int q = 0; q < nq; ++q) {
    const float* qd = qdesc + (size_t)q * d;
    for (int t = 0; t < nt; ++t) {
      const float* td = tdesc + (size_t)t * d;
      float acc = 0.f;
      for (int c = 0; c < d; ++c) {
        float diff = qd[c] - td[c];
        acc += diff * diff;
      }
      dists[t] = {acc, t};
    }
    std::partial_sort(dists.begin(), dists.begin() + std::min(k + 1, nt),
                      dists.end());
    bool pass = true;
    if (nt > 1) {
      float first = std::sqrt(dists[0].first);
      float second = std::sqrt(dists[std::min(k, nt - 1)].first);
      pass = first <= m->sim_thres * second;
    }
    if (!pass) continue;
    QueryNode node;
    node.query_idx = q;
    for (int j = 0; j < k; ++j) {
      node.target_idxs.push_back(dists[j].second);
      node.sims.push_back(std::sqrt(dists[j].first));
    }
    m->nodes.push_back(std::move(node));
  }
}

void* FirstQueryNode(void* ptr) {
  auto* m = static_cast<Matcher*>(ptr);
  return m->nodes.empty() ? nullptr : &m->nodes.front();
}

void* LastQueryNode(void* ptr) {
  auto* m = static_cast<Matcher*>(ptr);
  return m->nodes.empty() ? nullptr : &m->nodes.back();
}

void* NextQueryNode(void* ptr, void* qn) {
  auto* m = static_cast<Matcher*>(ptr);
  auto* node = static_cast<QueryNode*>(qn);
  if (!node || m->nodes.empty() || node == &m->nodes.back()) return nullptr;
  return node + 1;
}

void* PrevQueryNode(void* ptr, void* qn) {
  auto* m = static_cast<Matcher*>(ptr);
  auto* node = static_cast<QueryNode*>(qn);
  if (!node || m->nodes.empty() || node == &m->nodes.front()) return nullptr;
  return node - 1;
}

int GetQueryNodeLength(void* qn) {
  auto* node = static_cast<QueryNode*>(qn);
  return node ? (int)node->target_idxs.size() : 0;
}

void GetData_from_QueryNode(void* qn, int* query_idx, int* target_idxs,
                            float* simis) {
  auto* node = static_cast<QueryNode*>(qn);
  if (!node) return;
  *query_idx = node->query_idx;
  for (size_t i = 0; i < node->target_idxs.size(); ++i) {
    target_idxs[i] = node->target_idxs[i];
    simis[i] = node->sims[i];
  }
}

// RANSAC geometric filter over explicit point arrays.
// filtercode 0 = homography (reprojection error), 1 = fundamental
// (Sampson error). Writes per-pair inlier mask and the 3x3 model into T.
void GeometricFilter(float* src_pts, float* dst_pts, bool* mask, float* T,
                     int N, int /*w1*/, int /*h1*/, int /*w2*/, int /*h2*/,
                     int filtercode, float precision, bool verb) {
  std::fill(mask, mask + N, false);
  std::fill(T, T + 9, 0.f);
  const int sample = filtercode == 0 ? 4 : 8;
  if (N < sample) return;
  std::mt19937 rng(42);
  std::uniform_int_distribution<int> pick(0, N - 1);
  const double thr2 = (double)precision * (double)precision;
  double bestH[9];
  int best_inliers = 0;
  int iters = 2000;
  for (int it = 0; it < iters; ++it) {
    double s[16], d[16];
    int idx[8];
    for (int j = 0; j < sample; ++j) {
      int cand;
      bool dup;
      do {
        cand = pick(rng);
        dup = false;
        for (int p = 0; p < j; ++p) dup |= (idx[p] == cand);
      } while (dup);
      idx[j] = cand;
      s[2 * j] = src_pts[2 * cand];
      s[2 * j + 1] = src_pts[2 * cand + 1];
      d[2 * j] = dst_pts[2 * cand];
      d[2 * j + 1] = dst_pts[2 * cand + 1];
    }
    double H[9];
    bool ok = filtercode == 0 ? homography4(s, d, H)
                              : fundamental8(s, d, sample, H);
    if (!ok) continue;
    int inl = 0;
    for (int i = 0; i < N; ++i) {
      double e = filtercode == 0
                     ? reproj_err2(H, src_pts[2 * i], src_pts[2 * i + 1],
                                   dst_pts[2 * i], dst_pts[2 * i + 1])
                     : sampson_err2(H, src_pts[2 * i], src_pts[2 * i + 1],
                                    dst_pts[2 * i], dst_pts[2 * i + 1]);
      if (e < thr2) ++inl;
    }
    if (inl > best_inliers) {
      best_inliers = inl;
      std::memcpy(bestH, H, sizeof(bestH));
      // adaptive iteration count (99% confidence)
      double w = (double)inl / N;
      double p_all = std::pow(w, sample);
      if (p_all > 1e-12) {
        int need = (int)(std::log(0.01) / std::log(1.0 - p_all)) + 1;
        iters = std::min(iters, std::max(it + 1, need));
      }
    }
  }
  if (best_inliers < sample) return;
  for (int i = 0; i < 9; ++i) T[i] = (float)bestH[i];
  for (int i = 0; i < N; ++i) {
    double e = filtercode == 0
                   ? reproj_err2(bestH, src_pts[2 * i], src_pts[2 * i + 1],
                                 dst_pts[2 * i], dst_pts[2 * i + 1])
                   : sampson_err2(bestH, src_pts[2 * i], src_pts[2 * i + 1],
                                  dst_pts[2 * i], dst_pts[2 * i + 1]);
    mask[i] = e < thr2;
  }
  if (verb) {
    // caller-controlled; keep quiet by default
  }
}

// Geometric filter over the matcher's stored KNN nodes; result exposed via
// NumberOfFilteredMatches / ArrayOfFilteredMatches (q, t, rank triplets).
void GeometricFilterFromNodes(void* ptr, float* T, int w1, int h1, int w2,
                              int h2, int filtercode, float precision,
                              bool verb) {
  auto* m = static_cast<Matcher*>(ptr);
  std::vector<float> src, dst;
  std::vector<std::pair<int, int>> pairs;
  for (auto& node : m->nodes) {
    for (size_t j = 0; j < node.target_idxs.size(); ++j) {
      int q = node.query_idx, t = node.target_idxs[j];
      src.push_back(m->qkps[2 * q]);
      src.push_back(m->qkps[2 * q + 1]);
      dst.push_back(m->tkps[2 * t]);
      dst.push_back(m->tkps[2 * t + 1]);
      pairs.push_back({q, t});
    }
  }
  int N = (int)pairs.size();
  std::vector<unsigned char> mask(N, 0);
  GeometricFilter(src.data(), dst.data(),
                  reinterpret_cast<bool*>(mask.data()), T, N, w1, h1, w2,
                  h2, filtercode, precision, verb);
  m->filtered.clear();
  for (int i = 0; i < N; ++i) {
    if (mask[i]) {
      m->filtered.push_back(pairs[i].first);
      m->filtered.push_back(pairs[i].second);
      m->filtered.push_back(0);
    }
  }
}

int NumberOfFilteredMatches(void* ptr) {
  return (int)(static_cast<Matcher*>(ptr)->filtered.size() / 3);
}

void ArrayOfFilteredMatches(void* ptr, int* out) {
  auto* m = static_cast<Matcher*>(ptr);
  std::memcpy(out, m->filtered.data(), m->filtered.size() * sizeof(int));
}

// Incremental patch-similarity combination: recompute only the rows /
// columns of the bP cross-similarity matrix whose patch indices changed
// since the previous call (the capability FastMatCombi represents in the
// IMAS lineage).
// bP: (n, n) row-major; ps1/ps2: (n, MemStepImg) flattened patch vectors.
void FastMatCombi(int n, float* bP, int* i1_list, int* i2_list, float* ps1,
                  float* ps2, int MemStepImg, int* last_i1_list,
                  int* last_i2_list) {
  for (int a = 0; a < n; ++a) {
    for (int b = 0; b < n; ++b) {
      if (i1_list[a] == last_i1_list[a] && i2_list[b] == last_i2_list[b] &&
          last_i1_list[a] >= 0 && last_i2_list[b] >= 0)
        continue;  // unchanged pair: keep cached value
      const float* p1 = ps1 + (size_t)a * MemStepImg;
      const float* p2 = ps2 + (size_t)b * MemStepImg;
      double acc = 0.0;
      for (int c = 0; c < MemStepImg; ++c) {
        double diff = (double)p1[c] - (double)p2[c];
        acc += diff * diff;
      }
      bP[(size_t)a * n + b] = (float)std::sqrt(acc);
    }
  }
}

}  // extern "C"
