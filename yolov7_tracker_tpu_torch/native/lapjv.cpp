// Jonker-Volgenant linear assignment with cost_limit gating: the PyTorch
// port's own copy of yolov7_tracker_tpu/native/lapjv.cpp, the same code.
//
// Host-side exact solver replacing the reference's `lap.lapjv` dependency
// (tracker/matching.py:34) for evaluation tooling. Implements the classic
// dense JV algorithm (column reduction, augmenting row reduction, shortest
// augmenting paths) on the
// cost_limit-extended square matrix, matching lap's construction:
// an (n+m)x(n+m) problem filled with cost_limit/2, dummy-dummy block 0.
//
// C ABI for ctypes:
//   int lapjv_cost_limit(int n, int m, const double* cost,
//                        double cost_limit, int* row_to_col,
//                        int* col_to_row);
// row_to_col[i] = matched column of row i or -1; same for col_to_row.
//
// Built by native/__init__.py: g++ -O3 -shared -fPIC, into _build/.

#include <cfloat>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Dense square JV. cost is size x size row-major. Returns assignment in
// rowsol/colsol. Complexity O(size^3) worst case.
void jv_square(int size, const std::vector<double>& cost,
               std::vector<int>& rowsol, std::vector<int>& colsol) {
  std::vector<double> u(size, 0.0), v(size, 0.0);
  rowsol.assign(size, -1);
  colsol.assign(size, -1);

  // --- column reduction
  for (int j = size - 1; j >= 0; --j) {
    double min_c = cost[j];
    int imin = 0;
    for (int i = 1; i < size; ++i) {
      double c = cost[i * size + j];
      if (c < min_c) {
        min_c = c;
        imin = i;
      }
    }
    v[j] = min_c;
    if (rowsol[imin] == -1) {
      rowsol[imin] = j;
      colsol[j] = imin;
    }
  }
  // after column reduction reduced costs are >= 0 with u = 0, so the
  // Dijkstra augmentation below is exact; the classic augmenting-row-
  // reduction pass is only a speedup and is omitted for clarity.
  std::vector<int> free_rows;
  for (int i = 0; i < size; ++i)
    if (rowsol[i] == -1) free_rows.push_back(i);

  // --- shortest augmenting paths for remaining free rows
  std::vector<double> d(size);
  std::vector<int> pred(size);
  std::vector<char> done(size);
  for (int f = 0; f < (int)free_rows.size(); ++f) {
    int freerow = free_rows[f];
    std::fill(done.begin(), done.end(), 0);
    for (int j = 0; j < size; ++j) {
      d[j] = cost[freerow * size + j] - v[j];
      pred[j] = freerow;
    }
    int endofpath = -1;
    double mind = 0.0;
    std::vector<int> scanned;
    while (true) {
      // find unscanned column with minimal d
      mind = DBL_MAX;
      int jmin = -1;
      for (int j = 0; j < size; ++j)
        if (!done[j] && d[j] < mind) {
          mind = d[j];
          jmin = j;
        }
      done[jmin] = 1;
      scanned.push_back(jmin);
      if (colsol[jmin] == -1) {
        endofpath = jmin;
        break;
      }
      int i = colsol[jmin];
      double base = cost[i * size + jmin] - v[jmin];
      for (int j = 0; j < size; ++j) {
        if (done[j]) continue;
        double h = mind + (cost[i * size + j] - v[j]) - base;
        if (h < d[j]) {
          d[j] = h;
          pred[j] = i;
        }
      }
    }
    // update duals for scanned columns
    for (int k = 0; k < (int)scanned.size(); ++k) {
      int j = scanned[k];
      v[j] += d[j] - mind;
    }
    // augment along path
    int j = endofpath;
    while (true) {
      int i = pred[j];
      colsol[j] = i;
      int jprev = rowsol[i];
      rowsol[i] = j;
      if (i == freerow) break;
      j = jprev;
    }
  }
}

}  // namespace

extern "C" {

int lapjv_cost_limit(int n, int m, const double* cost, double cost_limit,
                     int* row_to_col, int* col_to_row) {
  int size = n + m;
  std::vector<double> ext((size_t)size * size, cost_limit / 2.0);
  for (int i = n; i < size; ++i)
    for (int j = m; j < size; ++j) ext[(size_t)i * size + j] = 0.0;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) ext[(size_t)i * size + j] = cost[i * m + j];

  std::vector<int> rowsol, colsol;
  jv_square(size, ext, rowsol, colsol);

  for (int i = 0; i < n; ++i) {
    int j = rowsol[i];
    row_to_col[i] = (j >= 0 && j < m) ? j : -1;
  }
  for (int j = 0; j < m; ++j) {
    int i = colsol[j];
    col_to_row[j] = (i >= 0 && i < n) ? i : -1;
  }
  return 0;
}

// plain square solve (for motmetrics-style accumulation)
int lapjv_square(int size, const double* cost, int* row_to_col) {
  std::vector<double> c(cost, cost + (size_t)size * size);
  std::vector<int> rowsol, colsol;
  jv_square(size, c, rowsol, colsol);
  memcpy(row_to_col, rowsol.data(), sizeof(int) * size);
  return 0;
}
}
