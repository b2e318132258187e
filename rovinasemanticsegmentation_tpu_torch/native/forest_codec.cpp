// Native forest.dat codec: single-pass decode of the reference binary
// format into flat arrays.
//
// The port's copy of rovinasemanticsegmentation_tpu/native/forest_codec.cpp.
//
// The format (io.h:34-108 framing; classifier.cpp:134-235 field order) nests
// per-node variable-length histogram vectors; decoding it in Python costs a
// Python-loop iteration per node. This decoder walks the buffer once and
// emits:
//   per tree:  node count, split/threshold/left arrays (borrowed slices)
//   histograms: concatenated values + (node, layer, class_count) index
// The Python side assembles the dense SoA tensors with NumPy.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  int32_t i32() {
    if (p + 4 > end) { ok = false; return 0; }
    int32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  const uint8_t* bytes(size_t n) {
    if (p + n > end) { ok = false; return nullptr; }
    const uint8_t* r = p;
    p += n;
    return r;
  }
};

struct DecodedForest {
  std::vector<int32_t> tree_node_counts;
  std::vector<int32_t> split_features;   // concatenated over trees
  std::vector<float> thresholds;
  std::vector<int32_t> left_child;
  // Histogram payload: for every non-empty per-layer histogram, an index
  // row (tree, node, layer, class_count, value_offset). layer = -1 marks a
  // single-label histogram.
  std::vector<int32_t> hist_index;  // 5 ints per row
  std::vector<float> hist_values;
};

thread_local DecodedForest* g_forest = nullptr;

}  // namespace

extern "C" {

// Decode the buffer. Returns the tree count, or -1 on malformed input.
int rovina_forest_decode(const uint8_t* data, int64_t size) {
  delete g_forest;
  g_forest = new DecodedForest();
  Cursor c{data, data + size};

  const int32_t tree_count = c.i32();
  if (!c.ok || tree_count < 0 || tree_count > 1 << 20) return -1;

  for (int t = 0; t < tree_count; ++t) {
    const int32_t n_split = c.i32();
    const uint8_t* sf = c.bytes(static_cast<size_t>(n_split) * 4);
    const int32_t n_thr = c.i32();
    const uint8_t* th = c.bytes(static_cast<size_t>(n_thr) * 4);
    const int32_t n_left = c.i32();
    const uint8_t* lc = c.bytes(static_cast<size_t>(n_left) * 4);
    if (!c.ok || n_split != n_thr || n_split != n_left || n_split < 0)
      return -1;

    const size_t base = g_forest->split_features.size();
    g_forest->tree_node_counts.push_back(n_split);
    g_forest->split_features.resize(base + n_split);
    g_forest->thresholds.resize(base + n_split);
    g_forest->left_child.resize(base + n_split);
    std::memcpy(g_forest->split_features.data() + base, sf, n_split * 4);
    std::memcpy(g_forest->thresholds.data() + base, th, n_split * 4);
    std::memcpy(g_forest->left_child.data() + base, lc, n_split * 4);

    // Single-label histograms: vector<vector<float>>.
    const int32_t n_hist = c.i32();
    if (!c.ok || n_hist < 0) return -1;
    for (int v = 0; v < n_hist; ++v) {
      const int32_t len = c.i32();
      if (!c.ok || len < 0) return -1;
      if (len > 0) {
        const uint8_t* vals = c.bytes(static_cast<size_t>(len) * 4);
        if (!c.ok) return -1;
        const size_t off = g_forest->hist_values.size();
        g_forest->hist_values.resize(off + len);
        std::memcpy(g_forest->hist_values.data() + off, vals, len * 4);
        g_forest->hist_index.insert(
            g_forest->hist_index.end(),
            {t, v, -1, len, static_cast<int32_t>(off)});
      }
    }

    // Multi-label histograms: vector<vector<vector<float>>>.
    const int32_t n_multi = c.i32();
    if (!c.ok || n_multi < 0) return -1;
    for (int v = 0; v < n_multi; ++v) {
      const int32_t n_layers = c.i32();
      if (!c.ok || n_layers < 0) return -1;
      for (int l = 0; l < n_layers; ++l) {
        const int32_t len = c.i32();
        if (!c.ok || len < 0) return -1;
        const uint8_t* vals = c.bytes(static_cast<size_t>(len) * 4);
        if (!c.ok) return -1;
        const size_t off = g_forest->hist_values.size();
        g_forest->hist_values.resize(off + len);
        std::memcpy(g_forest->hist_values.data() + off, vals, len * 4);
        g_forest->hist_index.insert(
            g_forest->hist_index.end(),
            {t, v, l, len, static_cast<int32_t>(off)});
      }
    }
  }
  return tree_count;
}

// Sizes of the decoded arrays (call after rovina_forest_decode).
void rovina_forest_sizes(int64_t* total_nodes, int64_t* hist_rows,
                         int64_t* hist_values) {
  *total_nodes = g_forest ? static_cast<int64_t>(g_forest->split_features.size()) : 0;
  *hist_rows = g_forest ? static_cast<int64_t>(g_forest->hist_index.size() / 5) : 0;
  *hist_values = g_forest ? static_cast<int64_t>(g_forest->hist_values.size()) : 0;
}

// Copy out the decoded arrays and free the state.
void rovina_forest_fetch(int32_t* node_counts, int32_t* split_features,
                         float* thresholds, int32_t* left_child,
                         int32_t* hist_index, float* hist_values) {
  if (!g_forest) return;
  std::memcpy(node_counts, g_forest->tree_node_counts.data(),
              g_forest->tree_node_counts.size() * 4);
  std::memcpy(split_features, g_forest->split_features.data(),
              g_forest->split_features.size() * 4);
  std::memcpy(thresholds, g_forest->thresholds.data(),
              g_forest->thresholds.size() * 4);
  std::memcpy(left_child, g_forest->left_child.data(),
              g_forest->left_child.size() * 4);
  std::memcpy(hist_index, g_forest->hist_index.data(),
              g_forest->hist_index.size() * 4);
  std::memcpy(hist_values, g_forest->hist_values.data(),
              g_forest->hist_values.size() * 4);
  delete g_forest;
  g_forest = nullptr;
}

}  // extern "C"
