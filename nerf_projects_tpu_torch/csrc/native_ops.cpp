// Host ops of the port (a copy of build_neighbor_links from the JAX
// package's csrc/native_ops.cpp). Plain C interface for ctypes; compiled
// by g++ at first use (ops/kernels/_build.py::build_host).

#include <cstdint>

extern "C" {

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
