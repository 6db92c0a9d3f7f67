// Native BVH builder (C++17, no dependencies): the port's own copy of the
// binned-SAH builder of imbatracer_tpu/accel/cpp/bvh_builder.cpp (the
// spatial-split builder there is not used by the port and is not copied).
//
// Algorithm: top-down binned SAH. All three axes are binned (32 bins)
// per node, the cheapest split wins, SAH leaf termination against a
// traversal cost, median fallback for degenerate distributions. Output is
// an implicit-DFS binary layout (left child = i+1, right[i] explicit,
// leaves right[i] == -1), threaded by imbatracer_torch/accel/flatten.py.
//
// Built at first use by imbatracer_torch/accel/native.py with
//   g++ -O3 -march=native -std=c++17 -shared -fPIC
// into build/imbatracer_torch/ (the same flags as the JAX package's copy,
// so both build the same tree from the same boxes).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NUM_BINS = 32;

struct Vec3 {
    float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct BBox {
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};

    void extend(const BBox& b) {
        lo = vmin(lo, b.lo);
        hi = vmax(hi, b.hi);
    }
    void extend(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float half_area() const {
        const float dx = std::max(hi.x - lo.x, 0.f);
        const float dy = std::max(hi.y - lo.y, 0.f);
        const float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const BBox* boxes;
    const Vec3* centers;
    int leaf_size;
    float traversal_cost;

    std::vector<int> prim_ids;
    // node arrays (DFS order)
    std::vector<float> node_min, node_max;
    std::vector<int> right, start, count;

    int emit_node(const BBox& b) {
        node_min.insert(node_min.end(), {b.lo.x, b.lo.y, b.lo.z});
        node_max.insert(node_max.end(), {b.hi.x, b.hi.y, b.hi.z});
        right.push_back(-1);
        start.push_back(0);
        count.push_back(0);
        return static_cast<int>(right.size()) - 1;
    }

    // Build range [lo, hi) of prim_ids; returns node index.
    int build_range(int lo, int hi) {
        BBox bb;
        for (int i = lo; i < hi; ++i) bb.extend(boxes[prim_ids[i]]);
        const int node = emit_node(bb);
        const int n = hi - lo;

        if (n <= leaf_size) {
            make_leaf(node, lo, n);
            return node;
        }

        // Centroid bounds.
        BBox cb;
        for (int i = lo; i < hi; ++i) cb.extend(centers[prim_ids[i]]);

        int best_axis = -1, best_bin = -1;
        float best_cost = FLT_MAX;
        float best_origin = 0.f, best_scale = 0.f;

        for (int axis = 0; axis < 3; ++axis) {
            const float origin = (&cb.lo.x)[axis];
            const float extent = (&cb.hi.x)[axis] - origin;
            if (extent <= 1e-12f) continue;
            const float scale = NUM_BINS * (1.0f - 1e-6f) / extent;

            BBox bin_bb[NUM_BINS];
            int bin_n[NUM_BINS] = {0};
            for (int i = lo; i < hi; ++i) {
                const int id = prim_ids[i];
                int b = static_cast<int>(((&centers[id].x)[axis] - origin) * scale);
                b = std::min(std::max(b, 0), NUM_BINS - 1);
                bin_bb[b].extend(boxes[id]);
                bin_n[b]++;
            }

            // Right-to-left sweep.
            float right_area[NUM_BINS];
            BBox acc;
            int nr = 0;
            int right_n[NUM_BINS];
            for (int b = NUM_BINS - 1; b > 0; --b) {
                acc.extend(bin_bb[b]);
                nr += bin_n[b];
                right_area[b] = acc.half_area();
                right_n[b] = nr;
            }
            // Left-to-right sweep + cost.
            BBox accl;
            int nl = 0;
            for (int b = 0; b < NUM_BINS - 1; ++b) {
                accl.extend(bin_bb[b]);
                nl += bin_n[b];
                if (nl == 0 || right_n[b + 1] == 0) continue;
                const float cost =
                    accl.half_area() * nl + right_area[b + 1] * right_n[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                    best_origin = origin;
                    best_scale = scale;
                }
            }
        }

        int mid;
        if (best_axis < 0) {
            // Degenerate centroids: median split on an arbitrary order.
            mid = lo + n / 2;
        } else {
            // SAH leaf termination (same rule as the Python builder).
            const float parent_area = std::max(bb.half_area(), 1e-20f);
            if (n <= 2 * leaf_size &&
                best_cost / parent_area + traversal_cost >= static_cast<float>(n)) {
                // Splitting is not profitable but leaves must stay small:
                // only stop if it fits a leaf.
                if (n <= leaf_size) {
                    make_leaf(node, lo, n);
                    return node;
                }
            }
            auto pred = [&](int id) {
                int b = static_cast<int>(
                    ((&centers[id].x)[best_axis] - best_origin) * best_scale);
                b = std::min(std::max(b, 0), NUM_BINS - 1);
                return b <= best_bin;
            };
            int* first = prim_ids.data() + lo;
            int* last = prim_ids.data() + hi;
            int* pivot = std::partition(first, last, pred);
            mid = lo + static_cast<int>(pivot - first);
            if (mid == lo || mid == hi) mid = lo + n / 2;
        }

        build_range(lo, mid);            // left child = node + 1 (DFS)
        right[node] = build_range(mid, hi);
        return node;
    }

    void make_leaf(int node, int lo, int n) {
        right[node] = -1;
        start[node] = lo;
        count[node] = n;
    }
};


}  // namespace

extern "C" {

// Returns the number of nodes, or -1 on error. Output arrays must hold at
// least 2 * num_tris entries (node arrays) / num_tris (prim_ids).
int imba_build_bvh(const float* bbox_lo, const float* bbox_hi,
                   const float* centers, int num_tris, int leaf_size,
                   float traversal_cost, float* out_node_min,
                   float* out_node_max, int* out_right, int* out_start,
                   int* out_count, int* out_prim_ids) {
    if (num_tris <= 0) return -1;

    std::vector<BBox> boxes(num_tris);
    std::vector<Vec3> cents(num_tris);
    for (int i = 0; i < num_tris; ++i) {
        boxes[i].lo = {bbox_lo[3 * i], bbox_lo[3 * i + 1], bbox_lo[3 * i + 2]};
        boxes[i].hi = {bbox_hi[3 * i], bbox_hi[3 * i + 1], bbox_hi[3 * i + 2]};
        cents[i] = {centers[3 * i], centers[3 * i + 1], centers[3 * i + 2]};
    }

    Builder b;
    b.boxes = boxes.data();
    b.centers = cents.data();
    b.leaf_size = leaf_size;
    b.traversal_cost = traversal_cost;
    b.prim_ids.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) b.prim_ids[i] = i;
    const size_t cap = 2 * static_cast<size_t>(num_tris) + 2;
    b.node_min.reserve(cap * 3);
    b.node_max.reserve(cap * 3);
    b.right.reserve(cap);
    b.start.reserve(cap);
    b.count.reserve(cap);

    b.build_range(0, num_tris);

    const int n_nodes = static_cast<int>(b.right.size());
    if (static_cast<size_t>(n_nodes) > cap) return -1;
    std::memcpy(out_node_min, b.node_min.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_node_max, b.node_max.data(), sizeof(float) * 3 * n_nodes);
    std::memcpy(out_right, b.right.data(), sizeof(int) * n_nodes);
    std::memcpy(out_start, b.start.data(), sizeof(int) * n_nodes);
    std::memcpy(out_count, b.count.data(), sizeof(int) * n_nodes);
    std::memcpy(out_prim_ids, b.prim_ids.data(), sizeof(int) * num_tris);
    return n_nodes;
}

}  // extern "C"
