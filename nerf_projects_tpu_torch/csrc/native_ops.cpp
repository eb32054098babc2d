// Host ops of the port (copies of the JAX package's csrc/native_ops.cpp):
//   * octree_leaf_geometry: each cell's depth, corner and size, by one
//     walk of the octree (models/octree.py leaf_depths_and_corners);
//   * median_cut: palette vector quantization for PlenOctree compression
//     (pipeline/compression.py; svox _C.quantize_median_cut equivalent);
//     it picks the box to split from a heap, not a scan of every box, and
//     keeps each box as a range of one record array, not a vector of row
//     indices: the same boxes, palette and ids, read contiguously;
//   * build_neighbor_links: the +x/+y/+z neighbour rows for TV.
// Plain C interface for ctypes; compiled by g++ at first use
// (ops/kernels/_build.py::build_host).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// child: [n_nodes, 8] int32 relative child offsets (cell order
// i*4+j*2+k); outputs sized n_nodes*8 (per cell): depth int32,
// corner float64[3], size float64. Leaf cells only are meaningful;
// is_leaf output marks them.
void octree_leaf_geometry(const int32_t* child, int64_t n_nodes,
                          int32_t* depth_out, double* corner_out,
                          double* size_out, uint8_t* is_leaf_out) {
  std::vector<int32_t> node_depth(n_nodes, 0);
  std::vector<double> node_corner(n_nodes * 3, 0.0);
  std::vector<double> node_size(n_nodes, 1.0);
  // children always have a higher index than their parent (append-only
  // refine), so one forward pass settles every node.
  for (int64_t node = 0; node < n_nodes; ++node) {
    for (int cell = 0; cell < 8; ++cell) {
      int32_t rel = child[node * 8 + cell];
      int64_t flat = node * 8 + cell;
      int i = (cell >> 2) & 1, j = (cell >> 1) & 1, k = cell & 1;
      double half = node_size[node] * 0.5;
      double cx = node_corner[node * 3 + 0] + i * half;
      double cy = node_corner[node * 3 + 1] + j * half;
      double cz = node_corner[node * 3 + 2] + k * half;
      if (rel != 0) {
        int64_t tgt = node + rel;
        node_depth[tgt] = node_depth[node] + 1;
        node_corner[tgt * 3 + 0] = cx;
        node_corner[tgt * 3 + 1] = cy;
        node_corner[tgt * 3 + 2] = cz;
        node_size[tgt] = half;
        is_leaf_out[flat] = 0;
      } else {
        is_leaf_out[flat] = 1;
      }
      depth_out[flat] = node_depth[node] + 1;
      corner_out[flat * 3 + 0] = cx;
      corner_out[flat * 3 + 1] = cy;
      corner_out[flat * 3 + 2] = cz;
      size_out[flat] = half;
    }
  }
}

// Median-cut vector quantization.
// vectors: [n, c] float32, c <= 4; ids_out: [n] int32; palette_out:
// [n_colors, c] float32. Returns the number of palette entries used, or -1
// when c > 4.
//
// The JAX package's op keeps each box as a vector of row indices and reads
// the rows through them. Here every box is a range of one array of
// (row values, row index) records: a split partitions its range in place
// with std::nth_element, which performs the same comparisons and moves on
// records as it does on indices, so each box holds the same rows in the
// same order, and the palette (the means, summed in that order) and the ids
// come out the same, with contiguous reads instead of gathers.
int64_t median_cut(const float* vectors, int64_t n, int64_t c,
                   int64_t n_colors, int32_t* ids_out, float* palette_out) {
  if (n == 0) return 0;
  if (c > 4) return -1;
  struct Rec {
    float v[4];
    int64_t i;
  };
  struct Box {
    int64_t begin, end;
    double score;  // max-range * count
    int axis;
  };
  std::vector<Rec> recs(n);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t a = 0; a < c; ++a) recs[i].v[a] = vectors[i * c + a];
    recs[i].i = i;
  }
  auto eval_box = [&](Box& b) {
    int64_t size = b.end - b.begin;
    if (size < 2) {
      b.score = 0.0;
      b.axis = 0;
      return;
    }
    float lo[4], hi[4];
    for (int64_t a = 0; a < c; ++a) lo[a] = hi[a] = recs[b.begin].v[a];
    for (int64_t r = b.begin; r < b.end; ++r)
      for (int64_t a = 0; a < c; ++a) {
        lo[a] = std::min(lo[a], recs[r].v[a]);
        hi[a] = std::max(hi[a], recs[r].v[a]);
      }
    double best_range = -1.0;
    int best_axis = 0;
    for (int64_t a = 0; a < c; ++a) {
      double range = double(hi[a]) - double(lo[a]);
      if (range > best_range) {
        best_range = range;
        best_axis = int(a);
      }
    }
    b.score = best_range * double(size);
    b.axis = best_axis;
  };

  std::vector<Box> boxes;
  boxes.push_back(Box{0, n, 0.0, 0});
  eval_box(boxes[0]);

  // The box to split: the largest score, the lowest index among equal
  // scores, only scores above 0 (the JAX package's linear scan over the
  // boxes chooses the same one), kept in a heap: one entry per box that
  // can split, pushed again after each split.
  std::priority_queue<std::pair<double, int64_t>> heap;  // (score, -index)
  if (boxes[0].score > 0.0) heap.emplace(boxes[0].score, 0);
  while ((int64_t)boxes.size() < n_colors && !heap.empty()) {
    int64_t best = -heap.top().second;
    heap.pop();
    Box src = boxes[best];
    int axis = src.axis;
    int64_t mid = src.begin + (src.end - src.begin) / 2;
    std::nth_element(recs.begin() + src.begin, recs.begin() + mid, recs.begin() + src.end,
                     [axis](const Rec& a, const Rec& b) { return a.v[axis] < b.v[axis]; });
    Box lo_box{src.begin, mid, 0.0, 0}, hi_box{mid, src.end, 0.0, 0};
    eval_box(lo_box);
    eval_box(hi_box);
    boxes[best] = lo_box;
    int64_t hi_id = (int64_t)boxes.size();
    boxes.push_back(hi_box);
    if (lo_box.score > 0.0) heap.emplace(lo_box.score, -best);
    if (hi_box.score > 0.0) heap.emplace(hi_box.score, -hi_id);
  }

  int64_t k = (int64_t)boxes.size();
  for (int64_t b = 0; b < k; ++b) {
    double mean[4] = {0.0, 0.0, 0.0, 0.0};
    for (int64_t r = boxes[b].begin; r < boxes[b].end; ++r)
      for (int64_t a = 0; a < c; ++a) mean[a] += recs[r].v[a];
    int64_t size = boxes[b].end - boxes[b].begin;
    for (int64_t a = 0; a < c; ++a)
      palette_out[b * c + a] = size == 0 ? 0.0f : float(mean[a] / double(size));
    for (int64_t r = boxes[b].begin; r < boxes[b].end; ++r) ids_out[recs[r].i] = int32_t(b);
  }
  return k;
}

// The +x/+y/+z neighbours' compact rows of every active cell.
// links: [X*Y*Z] int32, row-major; nbr_out: [cap, 3] int32, -1 = none.
void build_neighbor_links(const int32_t* links, int64_t X, int64_t Y,
                          int64_t Z, int32_t* nbr_out, int64_t cap) {
  for (int64_t i = 0; i < cap * 3; ++i) nbr_out[i] = -1;
  for (int64_t x = 0; x < X; ++x)
    for (int64_t y = 0; y < Y; ++y)
      for (int64_t z = 0; z < Z; ++z) {
        int32_t row = links[(x * Y + y) * Z + z];
        if (row < 0) continue;
        if (x + 1 < X) nbr_out[row * 3 + 0] = links[((x + 1) * Y + y) * Z + z];
        if (y + 1 < Y) nbr_out[row * 3 + 1] = links[(x * Y + y + 1) * Z + z];
        if (z + 1 < Z) nbr_out[row * 3 + 2] = links[(x * Y + y) * Z + z + 1];
      }
}

}  // extern "C"
