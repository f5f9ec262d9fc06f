// Native host-side components: a numeric CSV parser and Kruskal's minimum
// spanning tree, behind a minimal C ABI loaded with ctypes.
//
// A copy of albatross_tpu/_native/native.cpp.  The reference leans on
// native C/C++ for its data loading and graph machinery (fast-cpp-csv-parser
// in its examples, the header-only Kruskal MST in
// graph/minimum_spanning_tree.hpp); the port keeps the same host-side
// capabilities.  Built at first use by albatross_tpu_torch/_native/__init__.py
// (g++ -O3 -std=c++17 -shared -fPIC) into build/native/.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSV parsing: numeric CSV -> column-major doubles.
// ---------------------------------------------------------------------------
struct CsvFile {
  std::vector<std::string> header;
  std::vector<std::vector<double>> columns;  // column-major
};

void *csv_open(const char *path) {
  std::ifstream in(path);
  if (!in.good()) return nullptr;
  auto *csv = new CsvFile();

  std::string line;
  if (!std::getline(in, line)) {
    delete csv;
    return nullptr;
  }
  // header
  {
    std::stringstream ss(line);
    std::string cell;
    while (std::getline(ss, cell, ',')) {
      // trim whitespace and quotes
      while (!cell.empty() && (cell.front() == ' ' || cell.front() == '"'))
        cell.erase(cell.begin());
      while (!cell.empty() &&
             (cell.back() == ' ' || cell.back() == '"' || cell.back() == '\r'))
        cell.pop_back();
      csv->header.push_back(cell);
    }
  }
  const size_t ncols = csv->header.size();
  csv->columns.resize(ncols);

  while (std::getline(in, line)) {
    if (line.empty()) continue;
    const char *p = line.c_str();
    for (size_t c = 0; c < ncols; ++c) {
      char *end = nullptr;
      double v = std::strtod(p, &end);
      if (end == p) {
        // non-numeric cell -> NaN, skip to next comma
        v = std::numeric_limits<double>::quiet_NaN();
        while (*p && *p != ',') ++p;
      } else {
        p = end;
      }
      csv->columns[c].push_back(v);
      if (*p == ',') ++p;
    }
  }
  return csv;
}

int64_t csv_num_cols(void *handle) {
  return static_cast<CsvFile *>(handle)->header.size();
}

int64_t csv_num_rows(void *handle) {
  auto *csv = static_cast<CsvFile *>(handle);
  return csv->columns.empty() ? 0 : csv->columns[0].size();
}

const char *csv_header(void *handle, int64_t i) {
  return static_cast<CsvFile *>(handle)->header[i].c_str();
}

void csv_copy_column(void *handle, int64_t i, double *out) {
  auto &col = static_cast<CsvFile *>(handle)->columns[i];
  std::memcpy(out, col.data(), col.size() * sizeof(double));
}

void csv_free(void *handle) { delete static_cast<CsvFile *>(handle); }

// ---------------------------------------------------------------------------
// Kruskal minimum spanning tree over an edge list.
// Returns the number of selected edges; out_mask[i] = 1 if edge i selected.
// ---------------------------------------------------------------------------
static int64_t uf_find(std::vector<int64_t> &parent, int64_t v) {
  int64_t root = v;
  while (parent[root] != root) root = parent[root];
  while (parent[v] != root) {
    int64_t next = parent[v];
    parent[v] = root;
    v = next;
  }
  return root;
}

int64_t mst_kruskal(int64_t n_edges, const int64_t *a, const int64_t *b,
                    const double *cost, uint8_t *out_mask) {
  int64_t n_vertices = 0;
  for (int64_t i = 0; i < n_edges; ++i)
    n_vertices = std::max({n_vertices, a[i] + 1, b[i] + 1});

  std::vector<int64_t> order(n_edges);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) { return cost[x] < cost[y]; });

  std::vector<int64_t> parent(n_vertices);
  std::iota(parent.begin(), parent.end(), 0);
  std::memset(out_mask, 0, n_edges);

  int64_t selected = 0;
  for (int64_t idx : order) {
    int64_t ra = uf_find(parent, a[idx]);
    int64_t rb = uf_find(parent, b[idx]);
    if (ra != rb) {
      parent[ra] = rb;
      out_mask[idx] = 1;
      ++selected;
    }
  }
  return selected;
}

}  // extern "C"
