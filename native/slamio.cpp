// slamio: native host-side runtime IO for lidar_slam.
//
// The reference delegates image IO to OpenCV's C++ imread behind Python
// (reference: modules/texture_mapping.py:118-132). This library is the
// first-party equivalent: libpng decode of the Kinect RGB (8-bit color) and
// disparity (16-bit gray) frames, plus a pthread-pool batch loader so frame
// decode overlaps with device compute. Exposed as a C ABI for ctypes
// (lidar_slam/utils/native.py).

#include <png.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PngImage {
  int width = 0;
  int height = 0;
  int channels = 0;
  int bit_depth = 0;
  std::vector<uint8_t> data;  // row-major, 16-bit stored big-endian by libpng
};

// rc: 0 ok, 1 open fail, 2 not png, 3 decode error
int read_png_file(const char* path, PngImage* out, bool header_only) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  uint8_t sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return 2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int color_type = png_get_color_type(png, info);
  out->bit_depth = png_get_bit_depth(png, info);
  out->width = png_get_image_width(png, info);
  out->height = png_get_image_height(png, info);

  // normalize: palette -> rgb, gray<8 -> 8
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && out->bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  out->channels = png_get_channels(png, info);
  out->bit_depth = png_get_bit_depth(png, info);

  if (header_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
  }

  size_t rowbytes = png_get_rowbytes(png, info);
  out->data.resize(rowbytes * out->height);
  std::vector<png_bytep> rows(out->height);
  for (int y = 0; y < out->height; ++y)
    rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// Exact KDTree — the host-side conformance oracle for the on-device
// brute-force NN (lidar_slam/ops/nn.py). The reference's correspondence
// search is scipy.spatial.KDTree (reference: modules/icp.py:40,161); this is
// the first-party equivalent, used to validate that the device argmin path
// returns the true nearest neighbor. Ties in squared distance resolve to the
// LOWEST point index, matching numpy argmin semantics (and ops/nn.py).
// ---------------------------------------------------------------------------

struct KdTree {
  int dims = 0;
  int n = 0;
  std::vector<float> pts;  // n * dims, row-major
  std::vector<int> order;  // permutation; subtree over order[lo, hi)

  float coord(int point, int axis) const {
    return pts[(size_t)point * dims + axis];
  }

  void build(int lo, int hi, int depth) {
    if (hi - lo <= 1) return;
    int axis = depth % dims;
    int mid = (lo + hi) / 2;
    std::nth_element(order.begin() + lo, order.begin() + mid,
                     order.begin() + hi, [&](int a, int b) {
                       float ca = coord(a, axis), cb = coord(b, axis);
                       if (ca != cb) return ca < cb;
                       return a < b;  // deterministic layout
                     });
    build(lo, mid, depth + 1);
    build(mid + 1, hi, depth + 1);
  }

  void query_range(const float* q, int lo, int hi, int depth, double* best_d2,
                   int* best_idx) const {
    if (hi <= lo) return;
    int mid = (lo + hi) / 2;
    int pivot = order[mid];
    double d2 = 0.0;
    for (int a = 0; a < dims; ++a) {
      double diff = (double)q[a] - (double)coord(pivot, a);
      d2 += diff * diff;
    }
    if (d2 < *best_d2 || (d2 == *best_d2 && pivot < *best_idx)) {
      *best_d2 = d2;
      *best_idx = pivot;
    }
    if (hi - lo == 1) return;
    int axis = depth % dims;
    double diff = (double)q[axis] - (double)coord(pivot, axis);
    int near_lo = diff < 0 ? lo : mid + 1, near_hi = diff < 0 ? mid : hi;
    int far_lo = diff < 0 ? mid + 1 : lo, far_hi = diff < 0 ? hi : mid;
    query_range(q, near_lo, near_hi, depth + 1, best_d2, best_idx);
    // prune the far side only when the splitting plane is STRICTLY farther
    // than the best: a point AT best_d2 there could have a lower index.
    if (diff * diff <= *best_d2)
      query_range(q, far_lo, far_hi, depth + 1, best_d2, best_idx);
  }
};

}  // namespace

extern "C" {

void* slamio_kdtree_build(const float* pts, int n, int dims) {
  if (n <= 0 || dims <= 0 || dims > 8) return nullptr;
  KdTree* tree = new KdTree;
  tree->dims = dims;
  tree->n = n;
  tree->pts.assign(pts, pts + (size_t)n * dims);
  tree->order.resize(n);
  for (int i = 0; i < n; ++i) tree->order[i] = i;
  tree->build(0, n, 0);
  return tree;
}

// Exact 1-NN for each query row; out_idx[i] = index into the build points,
// out_d2[i] = true squared distance (double-accumulated, rounded to f32).
void slamio_kdtree_query(void* handle, const float* queries, int nq,
                         int* out_idx, float* out_d2) {
  const KdTree* tree = static_cast<const KdTree*>(handle);
  for (int i = 0; i < nq; ++i) {
    double best_d2 = 1e300;
    int best_idx = -1;
    tree->query_range(queries + (size_t)i * tree->dims, 0, tree->n, 0,
                      &best_d2, &best_idx);
    out_idx[i] = best_idx;
    out_d2[i] = (float)best_d2;
  }
}

void slamio_kdtree_free(void* handle) {
  delete static_cast<KdTree*>(handle);
}

// ---------------------------------------------------------------------------
// Exact DBSCAN — the host-side conformance oracle for the on-device density
// filter (lidar_slam/ops/filters.py). The reference's scan filter is
// sklearn's DBSCAN (reference: modules/localization.py:216-217); this is the
// first-party equivalent: textbook index-order BFS over the <= eps
// neighborhood graph (self counted, like sklearn), O(n^2) — scans are ~1k
// points, and the oracle's job is exactness, not speed. labels[i] receives
// the cluster id (0..k-1) or -1 for noise. Returns the cluster count, or -1
// on bad arguments. Border points adopt the cluster of the first core point
// that reaches them in BFS order (sklearn semantics); noise and core-point
// partitions are algorithm-independent.
// ---------------------------------------------------------------------------

int slamio_dbscan(const float* pts, int n, int dims, float eps,
                  int min_samples, int* labels) {
  if (n < 0 || dims <= 0 || dims > 8 || eps < 0) return -1;
  const double eps2 = (double)eps * (double)eps;
  auto d2 = [&](int a, int b) {
    double s = 0.0;
    for (int k = 0; k < dims; ++k) {
      double diff = (double)pts[(size_t)a * dims + k] -
                    (double)pts[(size_t)b * dims + k];
      s += diff * diff;
    }
    return s;
  };
  std::vector<std::vector<int>> neigh(n);
  std::vector<bool> core(n, false);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j)
      if (d2(i, j) <= eps2) neigh[i].push_back(j);
    core[i] = (int)neigh[i].size() >= min_samples;
  }
  for (int i = 0; i < n; ++i) labels[i] = -1;
  int next_label = 0;
  std::vector<int> queue;
  for (int i = 0; i < n; ++i) {
    if (!core[i] || labels[i] != -1) continue;
    int lab = next_label++;
    labels[i] = lab;
    queue.assign(1, i);
    while (!queue.empty()) {
      int p = queue.back();
      queue.pop_back();
      for (int q : neigh[p]) {
        if (labels[q] != -1) continue;
        labels[q] = lab;          // border or core reached by this cluster
        if (core[q]) queue.push_back(q);
      }
    }
  }
  return next_label;
}

// ---------------------------------------------------------------------------
// RGB-D frame projection — the host-side paint-op compressor for the texture
// stage (lidar_slam/models/texture.py). The device path uploads raw
// sensor bytes (1.54 MB/frame) and runs the unproject chain on the device;
// over a thin host<->device link that upload dominates the stage. This
// projector runs the same chain
// (reference: modules/texture_mapping.py:134-224) on the host in double
// precision — algebraically collapsed (reciprocal multiplies for the
// grid/registration quotients, hoisted pose terms), so individual pixels
// can differ from the reference in the last ulp and flip a ceil at exact
// cell boundaries: measure-zero boundary divergence, none observed on the
// committed scenes — and emits only the per-frame LAST-WRITER-WINS (cell, color)
// paint ops — typically ~100x fewer bytes — which the device folds with the
// same scatter-max it uses for the raw path. Dtype flow mirrors the
// reference numpy code: disparity->depth in float32 (the reference casts
// disparity to f32, texture_mapping.py:130-141, and numpy keeps python-float
// scalar ops in the array dtype), everything downstream in float64.
// ---------------------------------------------------------------------------

// cam16: [fx, fy, cx, cy, pitch_deg, p_rc0, p_rc1, p_rc2, disp_a, disp_b,
//         depth_scale, reg_scale, reg_i_off, reg_dd, reg_j_off, reg_div]
// Emits, per frame f, counts[f] unique (cell, packed r|g<<8|b<<16) pairs in
// first-touch order (within a frame each cell appears once, so any order
// reproduces the frame's final writes); frames are emitted in order, so a
// device scatter-max of global sequence numbers reproduces the reference's
// cross-frame last-writer-wins exactly. Returns the total pair count, or -1
// when `cap` would overflow (caller sizes cap = B*H*W, the true upper bound).
int slamio_project_frames(const uint16_t* disp, const uint8_t* rgb,
                          const double* poses, int B, int H, int W,
                          const double* cam16, double min_x, double min_y,
                          double res, int grid_w, int grid_h,
                          int32_t* out_cells, int32_t* out_colors,
                          int32_t* out_counts, long long cap,
                          int n_threads) {
  const double fx = cam16[0], fy = cam16[1], cx = cam16[2], cy = cam16[3];
  const double pitch = cam16[4] * 3.141592653589793 / 180.0;
  const double prc0 = cam16[5], prc1 = cam16[6];  // p_rc z unused in 2-D grid
  const float disp_a = (float)cam16[8], disp_b = (float)cam16[9];
  const float depth_scale = (float)cam16[10];
  const double reg_scale = cam16[11], reg_i_off = cam16[12];
  const double reg_dd = cam16[13], reg_j_off = cam16[14], reg_div = cam16[15];
  const double inv_reg_div = 1.0 / reg_div;
  const double inv_res = 1.0 / res;
  // K^-1 analytic (K upper triangular): ray = ((j - cx)/fx, (i - cy)/fy, 1)
  const double ki00 = 1.0 / fx, ki02 = -cx / fx;
  const double ki11 = 1.0 / fy, ki12 = -cy / fy;
  const double cp = std::cos(pitch), sp = std::sin(pitch);

  // disparity-indexed tables: depth and the f32 reg_dd*depth product depend
  // only on the uint16 disparity value — 64K entries amortize the per-pixel
  // f32 divide away (reference dtype flow: disparity -> depth in float32,
  // texture_mapping.py:130-141)
  // interleaved {depth, reg_dd*depth} pairs: one index computation and one
  // cache line serve both per-pixel loads in the table pre-pass
  std::vector<double> tbl(2 * 65536);
  for (int d = 0; d < 65536; ++d) {
    float dd = disp_a * (float)d + disp_b;
    float depth_f = depth_scale / dd;
    tbl[2 * d] = (double)depth_f;
    tbl[2 * d + 1] = (double)((float)reg_dd * depth_f);
  }
  // column tables: registered-RGB column and the optical-x ray slope are
  // functions of j alone
  std::vector<double> u_col(W);
  std::vector<int32_t> vj_col(W);
  std::vector<uint8_t> colok(W);
  for (int j = 0; j < W; ++j) {
    u_col[j] = j * ki00 + ki02;
    double rgbj = (reg_scale * j + reg_j_off) / reg_div;
    colok[j] = (rgbj >= 0.0 && rgbj < W) ? 1 : 0;
    int vj = colok[j] ? (int)rgbj : 0;
    vj_col[j] = vj > W - 1 ? W - 1 : vj;
  }

  // per-frame dedupe slots, versioned by frame tag so they reset for free
  const long long ncells = (long long)grid_w * grid_h;

  std::vector<long long> frame_count(B, 0);
  std::vector<std::vector<int32_t>> frame_cells(B), frame_colors(B);

  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  std::mutex m;
  // SLAMIO_PROFILE=1: accumulate per-phase seconds across all workers and
  // print to stderr (perf instrumentation for tools/texture_host_profile)
  const bool profile = std::getenv("SLAMIO_PROFILE") != nullptr;
  double t_prepass = 0, t_vector = 0, t_dedupe = 0, t_color = 0;
  auto worker = [&]() {
    using clk = std::chrono::steady_clock;
    double w_prepass = 0, w_vector = 0, w_dedupe = 0, w_color = 0;
    clk::time_point tp;
    // local copies of the by-reference-captured scalars: a captured int
    // lives in the closure frame, so int32 stores through the row pointers
    // could alias it — which blocks the trip-count computation and keeps
    // the hot loop scalar. Locals without their address taken cannot alias.
    const int Wl = W, Hl = H, gw = grid_w, gh = grid_h;
    // first pass per frame writes colors into color_slot[cell]; `seen`
    // carries the frame tag of the last write so no O(ncells) clear is
    // needed per frame
    std::vector<int32_t> seen(ncells, -1), color_slot(ncells);
    std::vector<int32_t> touched;
    std::vector<int32_t> cell_row(W), vi_row(W);
    std::vector<double> Bu(W), Eu(W), depth_row(W), regdd_row(W);
    for (;;) {
      int f;
      {
        std::lock_guard<std::mutex> lk(m);
        if (next[0] >= B) break;  // break, not return: the profile
        f = next[0]++;            // accumulators flush after the loop
      }
      touched.clear();
      const uint16_t* dframe = disp + (size_t)f * Hl * Wl;
      const uint8_t* rframe = rgb + (size_t)f * Hl * Wl * 3;
      const double px = poses[3 * f], py = poses[3 * f + 1];
      const double yaw = poses[3 * f + 2];
      const double cyw = std::cos(yaw), syw = std::sin(yaw);
      // hoisted frame constants: the optical->camera->robot->world chain
      // collapses to  xw = depth*(A_i + Bu_j) + Cx,  yw = depth*(D_i + Eu_j)
      // + Cy  with A/D functions of the row and Bu/Eu of the column
      // (optical->camera is the fixed axis permutation R_oc^T; camera->robot
      // the pitch rotation + p_rc; robot->world the pose yaw + translation)
      const double Cx = cyw * prc0 - syw * prc1 + px;
      const double Cy = syw * prc0 + cyw * prc1 + py;
      for (int j = 0; j < Wl; ++j) {
        Bu[j] = syw * u_col[j];
        Eu[j] = -cyw * u_col[j];
      }
      for (int i = 0; i < Hl; ++i) {
        const double v_i = i * ki11 + ki12;      // optical-y ray slope
        const double rx_i = cp - sp * v_i;       // robot-x per unit depth
        const double A_i = cyw * rx_i, D_i = syw * rx_i;
        const double rowterm = reg_scale * i + reg_i_off;
        const uint16_t* drow = dframe + (size_t)i * Wl;
        if (profile) tp = clk::now();
        // scalar table pre-pass (data-dependent loads block the
        // autovectorizer; isolated here they are ~2 cycles each)
        for (int j = 0; j < Wl; ++j) {
          const double* e = &tbl[2 * (uint32_t)drow[j]];
          depth_row[j] = e[0];
          regdd_row[j] = e[1];
        }
        if (profile) {
          auto t2 = clk::now();
          w_prepass += std::chrono::duration<double>(t2 - tp).count();
          tp = t2;
        }
        // vector pass: pure per-pixel math, branchless, autovectorizable
        for (int j = 0; j < Wl; ++j) {
          double depth = depth_row[j];
          // registered RGB row (depth passed into the dd slot — reference
          // quirk, texture_mapping.py:198)
          double rgbi = (rowterm - regdd_row[j]) * inv_reg_div;
          double xw = depth * (A_i + Bu[j]) + Cx;
          double yw = depth * (D_i + Eu[j]) + Cy;
          double gi = std::ceil((xw - min_x) * inv_res) - 1.0;
          double gj = std::ceil((yw - min_y) * inv_res) - 1.0;
          // NaN/inf depth (dd <= 0) fails every comparison, like numpy
          bool ok = bool(colok[j]) & (rgbi >= 0.0) & (rgbi < Hl) &
                    (gi >= 0.0) & (gi < gw) & (gj >= 0.0) & (gj < gh);
          // select BEFORE the double->int32 casts: out-of-range/NaN
          // conversion is UB in the abstract machine, and the unspeculable
          // casts were also what kept this loop scalar (gcc cannot
          // if-convert a trapping conversion; with the selects the casts
          // are unconditionally in-range and the loop vectorizes)
          double gis = ok ? gi : 0.0, gjs = ok ? gj : 0.0;
          double ris = ok ? rgbi : 0.0;
          cell_row[j] = ok ? (int32_t)gis * gh + (int32_t)gjs : -1;
          // registered source pixel (trunc == astype(int); gated by ok)
          vi_row[j] = (int32_t)ris * Wl + vj_col[j];
        }
        if (profile) {
          auto t2 = clk::now();
          w_vector += std::chrono::duration<double>(t2 - tp).count();
          tp = t2;
        }
        // scalar pass: per-frame last-writer-wins dedupe; the winning
        // SOURCE PIXEL index is recorded and its color fetched once per
        // touched cell at frame end (~100x fewer gathers than per-pixel)
        for (int j = 0; j < Wl; ++j) {
          int32_t cell = cell_row[j];
          if (cell < 0) continue;
          if (seen[cell] != f) {
            seen[cell] = f;
            touched.push_back(cell);
          }
          color_slot[cell] = vi_row[j];  // later pixels overwrite
        }
        if (profile)
          w_dedupe += std::chrono::duration<double>(clk::now() - tp).count();
      }
      if (profile) tp = clk::now();
      frame_count[f] = (long long)touched.size();
      frame_cells[f].assign(touched.begin(), touched.end());
      frame_colors[f].resize(touched.size());
      for (size_t k = 0; k < touched.size(); ++k) {
        const uint8_t* c = rframe + (size_t)color_slot[touched[k]] * 3;
        frame_colors[f][k] = (int32_t)c[0] | ((int32_t)c[1] << 8) |
                             ((int32_t)c[2] << 16);
      }
      if (profile)
        w_color += std::chrono::duration<double>(clk::now() - tp).count();
    }
    if (profile) {
      std::lock_guard<std::mutex> lk(m);
      t_prepass += w_prepass;
      t_vector += w_vector;
      t_dedupe += w_dedupe;
      t_color += w_color;
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > B) nt = B;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (profile) {
    double px = (double)B * H * W;
    std::fprintf(stderr,
                 "slamio_project_frames profile (ns/px over %d frames): "
                 "prepass %.2f  vector %.2f  dedupe %.2f  color %.2f\n",
                 B, t_prepass / px * 1e9, t_vector / px * 1e9,
                 t_dedupe / px * 1e9, t_color / px * 1e9);
  }

  long long total = 0;
  for (int f = 0; f < B; ++f) total += frame_count[f];
  if (total > cap) return -1;
  long long off = 0;
  for (int f = 0; f < B; ++f) {
    out_counts[f] = (int32_t)frame_count[f];
    std::memcpy(out_cells + off, frame_cells[f].data(),
                frame_count[f] * sizeof(int32_t));
    std::memcpy(out_colors + off, frame_colors[f].data(),
                frame_count[f] * sizeof(int32_t));
    off += frame_count[f];
  }
  return (int)total;
}

int slamio_read_png_info(const char* path, int* width, int* height,
                         int* channels, int* bit_depth) {
  PngImage img;
  int rc = read_png_file(path, &img, /*header_only=*/true);
  if (rc) return rc;
  *width = img.width;
  *height = img.height;
  *channels = img.channels;
  *bit_depth = img.bit_depth;
  return 0;
}

int slamio_read_png_u8(const char* path, uint8_t* out) {
  PngImage img;
  int rc = read_png_file(path, &img, false);
  if (rc) return rc;
  if (img.bit_depth != 8) return 4;
  std::memcpy(out, img.data.data(),
              (size_t)img.width * img.height * img.channels);
  return 0;
}

int slamio_read_png_u16(const char* path, uint16_t* out) {
  PngImage img;
  int rc = read_png_file(path, &img, false);
  if (rc) return rc;
  if (img.bit_depth != 16) return 4;
  size_t n = (size_t)img.width * img.height * img.channels;
  // libpng delivers 16-bit samples big-endian
  const uint8_t* src = img.data.data();
  for (size_t i = 0; i < n; ++i)
    out[i] = (uint16_t)((src[2 * i] << 8) | src[2 * i + 1]);
  return 0;
}

// Batch decode: paths packed as NUL-separated; each image decoded into its
// slot of `out` (stride bytes apart) by a thread pool. All images must share
// (width, height, channels, bit_depth). rcs[i] receives per-file status.
int slamio_read_png_batch_u16(const char** paths, int n, uint16_t* out,
                              long long stride_elems, int* rcs, int n_threads) {
  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  std::mutex m;
  auto worker = [&]() {
    for (;;) {
      int i;
      {
        std::lock_guard<std::mutex> lk(m);
        if (next[0] >= n) return;
        i = next[0]++;
      }
      rcs[i] = slamio_read_png_u16(paths[i], out + (long long)i * stride_elems);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

int slamio_read_png_batch_u8(const char** paths, int n, uint8_t* out,
                             long long stride_elems, int* rcs, int n_threads) {
  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  std::mutex m;
  auto worker = [&]() {
    for (;;) {
      int i;
      {
        std::lock_guard<std::mutex> lk(m);
        if (next[0] >= n) return;
        i = next[0]++;
      }
      rcs[i] = slamio_read_png_u8(paths[i], out + (long long)i * stride_elems);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
