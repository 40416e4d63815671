// SBVH builder — binned SAH with spatial splits (Stich et al. 2009 style).
//
// Same output model as bvh_builder.cpp (binary arrays {bounds, left, right,
// first, count, prim_order}) except prim_order holds REFERENCES: a triangle
// straddling a chosen spatial split plane is duplicated into both children
// with its AABB clipped to each side, so prim_order can be longer than
// n_faces and may contain repeated face ids.  Closest-hit and any-hit
// traversal stay exact with duplicates (t_best dedups; every point of a
// triangle is covered by >=1 fragment box), and the wide collapse
// (scene/bvh8.py) packs slots, not faces, so it is unchanged.
//
// Where the reference leans on Embree/OptiX's internal builders for ray-
// tracing performance (scene.ray_intersect, /root/reference/path.py:238),
// this is the equivalent quality lever here: fewer overlapping nodes ->
// fewer rows visited per ray in the persistent stepper.
//
// ABI (ctypes, see scene/native.py):
//   int  m3t_build_sbvh(const float* verts, int64 n_verts,
//                       const int32* faces, int64 n_faces, int leaf_size,
//                       float alpha, float budget_factor,
//                       void** handle, int64* n_nodes, int64* n_refs)
//   void m3t_copy_sbvh(handle, float* lo, float* hi, int32* left,
//                      int32* right, int32* first, int32* count,
//                      int32* prim_order, int32* max_leaf)
//   void m3t_free_sbvh(handle)

#include <algorithm>
#include <array>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int N_BINS = 16;    // object-split centroid bins
constexpr int N_SBINS = 16;   // spatial-split bins
constexpr int MAX_DEPTH = 60;

struct V3 {
    float x, y, z;
    V3() : x(0), y(0), z(0) {}
    V3(float a, float b, float c) : x(a), y(b), z(c) {}
    float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct AABB {
    V3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    V3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const V3& p) {
        lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y);
        lo.z = std::min(lo.z, p.z);
        hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y);
        hi.z = std::max(hi.z, p.z);
    }
    void grow(const AABB& b) {
        lo.x = std::min(lo.x, b.lo.x); lo.y = std::min(lo.y, b.lo.y);
        lo.z = std::min(lo.z, b.lo.z);
        hi.x = std::max(hi.x, b.hi.x); hi.y = std::max(hi.y, b.hi.y);
        hi.z = std::max(hi.z, b.hi.z);
    }
    bool valid() const {
        return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z;
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
    AABB intersect(const AABB& b) const {
        AABB r;
        r.lo = V3(std::max(lo.x, b.lo.x), std::max(lo.y, b.lo.y),
                  std::max(lo.z, b.lo.z));
        r.hi = V3(std::min(hi.x, b.hi.x), std::min(hi.y, b.hi.y),
                  std::min(hi.z, b.hi.z));
        return r;
    }
    V3 center() const {
        return V3(0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y),
                  0.5f * (lo.z + hi.z));
    }
};

struct Node {
    AABB box;
    int32_t left = -1, right = -1, first = 0, count = 0;
};

struct Ref {
    int32_t prim;
    AABB box;
};

struct SBVHOut {
    std::vector<Node> nodes;
    std::vector<int32_t> order;
    int32_t max_leaf = 1;
};

// AABB of a triangle polygon clipped to the slab [a, b] on `axis`
// (Sutherland-Hodgman against the two axis planes, then box the result).
AABB clip_tri_slab(const V3 tri[3], int axis, float a, float b) {
    std::array<V3, 8> poly, tmp;
    int n = 3;
    poly[0] = tri[0]; poly[1] = tri[1]; poly[2] = tri[2];

    // clip against plane axis >= a, then axis <= b
    for (int pass = 0; pass < 2; ++pass) {
        const float plane = pass == 0 ? a : b;
        const float sign = pass == 0 ? 1.f : -1.f;
        int m = 0;
        for (int i = 0; i < n; ++i) {
            const V3& p = poly[i];
            const V3& q = poly[(i + 1) % n];
            float dp = sign * (p[axis] - plane);
            float dq = sign * (q[axis] - plane);
            if (dp >= 0.f) tmp[m++] = p;
            if ((dp < 0.f) != (dq < 0.f)) {
                float t = dp / (dp - dq);  // dp != dq when signs differ
                tmp[m++] = V3(p.x + t * (q.x - p.x), p.y + t * (q.y - p.y),
                              p.z + t * (q.z - p.z));
            }
            if (m >= (int)tmp.size() - 1) break;  // defensive cap
        }
        n = m;
        poly = tmp;
        if (n == 0) break;
    }
    AABB r;
    for (int i = 0; i < n; ++i) r.grow(poly[i]);
    return r;
}

struct Builder {
    const float* verts;
    const int32_t* faces;
    int leaf_size;
    float alpha;           // overlap/root_area threshold to try spatial
    int64_t ref_budget;    // max total leaf references
    int64_t refs_used = 0; // running count of refs committed to leaves +
                           // live duplicates
    float root_area = 1.f;
    SBVHOut* out;

    void tri_verts(int32_t prim, V3 v[3]) const {
        for (int k = 0; k < 3; ++k) {
            const float* p = verts + 3 * (int64_t)faces[3 * prim + k];
            v[k] = V3(p[0], p[1], p[2]);
        }
    }

    int32_t build(std::vector<Ref>& refs, int depth) {
        const int64_t cnt = (int64_t)refs.size();
        AABB gbox, cbox;
        for (const Ref& r : refs) {
            gbox.grow(r.box);
            cbox.grow(r.box.center());
        }
        int32_t ni = (int32_t)out->nodes.size();
        out->nodes.push_back(Node{});
        out->nodes[ni].box = gbox;

        if (cnt <= leaf_size || depth >= MAX_DEPTH) {
            make_leaf(ni, refs);
            return ni;
        }

        // ---- object split (binned SAH over ref-box centroids) ----
        float best_cost = FLT_MAX;
        int best_axis = -1, best_bin = -1;
        AABB best_lbox, best_rbox;
        float cmin[3] = {cbox.lo.x, cbox.lo.y, cbox.lo.z};
        float cmax[3] = {cbox.hi.x, cbox.hi.y, cbox.hi.z};
        for (int axis = 0; axis < 3; ++axis) {
            float ext = cmax[axis] - cmin[axis];
            if (ext <= 1e-12f) continue;
            float inv = N_BINS / ext;
            AABB bbox[N_BINS];
            int64_t bcnt[N_BINS] = {0};
            for (const Ref& r : refs) {
                float cv = r.box.center()[axis];
                int b = std::min((int)((cv - cmin[axis]) * inv), N_BINS - 1);
                if (b < 0) b = 0;
                bbox[b].grow(r.box);
                bcnt[b]++;
            }
            AABB lbox[N_BINS];
            int64_t lcnt[N_BINS];
            AABB acc;
            int64_t ac = 0;
            for (int b = 0; b < N_BINS; ++b) {
                acc.grow(bbox[b]); ac += bcnt[b];
                lbox[b] = acc; lcnt[b] = ac;
            }
            AABB racc;
            int64_t rc = 0;
            for (int b = N_BINS - 1; b >= 1; --b) {
                racc.grow(bbox[b]); rc += bcnt[b];
                int64_t nl = lcnt[b - 1];
                if (nl == 0 || rc == 0) continue;
                float cost = lbox[b - 1].area() * nl + racc.area() * rc;
                if (cost < best_cost) {
                    best_cost = cost; best_axis = axis; best_bin = b - 1;
                    best_lbox = lbox[b - 1]; best_rbox = racc;
                }
            }
        }

        // ---- spatial split: only when the object split's children
        //      overlap significantly (Stich et al. 2009, sec. 4.1) ----
        float s_cost = FLT_MAX;
        int s_axis = -1, s_bin = -1;
        float s_lo[3], s_w[3];
        bool try_spatial = false;
        if (best_axis >= 0) {
            AABB ov = best_lbox.intersect(best_rbox);
            // depth guard: spatial splits may shrink children slowly (a
            // straddler lands in both); past depth 32 fall back to object/
            // median splits, which provably terminate under MAX_DEPTH with
            // leaves <= leaf_size (same guarantee as bvh_builder.cpp)
            try_spatial = depth < 32 && ov.valid()
                          && ov.area() > alpha * root_area
                          && refs_used + cnt < ref_budget;
        }
        if (try_spatial) {
            for (int axis = 0; axis < 3; ++axis) {
                float lo = gbox.lo[axis];
                float hi = gbox.hi[axis];
                float ext = hi - lo;
                if (ext <= 1e-12f) continue;
                float w = ext / N_SBINS;
                float inv = 1.f / w;
                AABB bbox[N_SBINS];
                int64_t entry[N_SBINS] = {0}, exit_[N_SBINS] = {0};
                for (const Ref& r : refs) {
                    int b0 = (int)((r.box.lo[axis] - lo) * inv);
                    int b1 = (int)((r.box.hi[axis] - lo) * inv);
                    b0 = std::min(std::max(b0, 0), N_SBINS - 1);
                    b1 = std::min(std::max(b1, b0), N_SBINS - 1);
                    entry[b0]++;
                    exit_[b1]++;
                    if (b0 == b1) {
                        bbox[b0].grow(r.box);
                    } else {
                        V3 tv[3];
                        tri_verts(r.prim, tv);
                        for (int b = b0; b <= b1; ++b) {
                            AABB cb = clip_tri_slab(
                                tv, axis, lo + b * w, lo + (b + 1) * w);
                            cb = cb.intersect(r.box);
                            if (cb.valid()) bbox[b].grow(cb);
                        }
                    }
                }
                AABB lacc[N_SBINS];
                int64_t lc = 0;
                int64_t lcs[N_SBINS];
                AABB acc;
                for (int b = 0; b < N_SBINS; ++b) {
                    acc.grow(bbox[b]);
                    lc += entry[b];
                    lacc[b] = acc;
                    lcs[b] = lc;
                }
                AABB racc;
                int64_t rc = 0;
                for (int b = N_SBINS - 1; b >= 1; --b) {
                    racc.grow(bbox[b]); rc += exit_[b];
                    int64_t nl = lcs[b - 1];
                    if (nl == 0 || rc == 0) continue;
                    float cost = lacc[b - 1].area() * nl + racc.area() * rc;
                    if (cost < s_cost) {
                        s_cost = cost; s_axis = axis; s_bin = b - 1;
                    }
                }
            }
            if (s_axis >= 0) {
                s_lo[0] = gbox.lo.x; s_lo[1] = gbox.lo.y;
                s_lo[2] = gbox.lo.z;
                float he[3] = {gbox.hi.x, gbox.hi.y, gbox.hi.z};
                for (int a2 = 0; a2 < 3; ++a2)
                    s_w[a2] = (he[a2] - s_lo[a2]) / N_SBINS;
            }
        }

        std::vector<Ref> lrefs, rrefs;
        if (s_axis >= 0 && s_cost < best_cost) {
            // spatial partition with duplication of straddlers
            const float plane = s_lo[s_axis] + s_w[s_axis] * (s_bin + 1);
            const float inv = 1.f / s_w[s_axis];
            lrefs.reserve(refs.size());
            rrefs.reserve(refs.size());
            for (const Ref& r : refs) {
                int b0 = (int)((r.box.lo[s_axis] - s_lo[s_axis]) * inv);
                int b1 = (int)((r.box.hi[s_axis] - s_lo[s_axis]) * inv);
                b0 = std::min(std::max(b0, 0), N_SBINS - 1);
                b1 = std::min(std::max(b1, b0), N_SBINS - 1);
                if (b1 <= s_bin) {
                    lrefs.push_back(r);
                } else if (b0 > s_bin) {
                    rrefs.push_back(r);
                } else {
                    V3 tv[3];
                    tri_verts(r.prim, tv);
                    AABB bl = clip_tri_slab(
                        tv, s_axis, r.box.lo[s_axis], plane);
                    bl = bl.intersect(r.box);
                    AABB br = clip_tri_slab(
                        tv, s_axis, plane, r.box.hi[s_axis]);
                    br = br.intersect(r.box);
                    bool okl = bl.valid(), okr = br.valid();
                    if (okl && okr && refs_used + (int64_t)lrefs.size()
                                      + (int64_t)rrefs.size() + 2
                                      <= ref_budget) {
                        lrefs.push_back(Ref{r.prim, bl});
                        rrefs.push_back(Ref{r.prim, br});
                        refs_used++;  // one extra reference created
                    } else if (okl && (!okr || bl.area() >= br.area())) {
                        lrefs.push_back(Ref{r.prim, bl});
                    } else if (okr) {
                        rrefs.push_back(Ref{r.prim, br});
                    } else {
                        lrefs.push_back(r);  // numeric fallback: keep whole
                    }
                }
            }
            // a spatial split must strictly shrink BOTH children or
            // duplication could recurse forever; redo as object split
            if (lrefs.size() >= (size_t)cnt || rrefs.size() >= (size_t)cnt) {
                lrefs.clear();
                rrefs.clear();
            }
        }
        if (lrefs.empty() && rrefs.empty() && best_axis >= 0) {
            // object partition by centroid bin
            float inv = N_BINS / (cmax[best_axis] - cmin[best_axis]);
            lrefs.reserve(refs.size());
            rrefs.reserve(refs.size());
            for (const Ref& r : refs) {
                float cv = r.box.center()[best_axis];
                int b = std::min(
                    (int)((cv - cmin[best_axis]) * inv), N_BINS - 1);
                if (b < 0) b = 0;
                (b <= best_bin ? lrefs : rrefs).push_back(r);
            }
        }
        if (lrefs.empty() || rrefs.empty()) {
            // degenerate: median split by current order
            lrefs.clear(); rrefs.clear();
            lrefs.assign(refs.begin(), refs.begin() + cnt / 2);
            rrefs.assign(refs.begin() + cnt / 2, refs.end());
        }
        refs.clear();
        refs.shrink_to_fit();

        int32_t li = build(lrefs, depth + 1);
        {
            std::vector<Ref>().swap(lrefs);
        }
        int32_t ri = build(rrefs, depth + 1);
        out->nodes[ni].left = li;
        out->nodes[ni].right = ri;
        out->nodes[ni].count = 0;
        return ni;
    }

    void make_leaf(int32_t ni, std::vector<Ref>& refs) {
        // dedup within the leaf: both fragments of a straddler can land in
        // the same leaf after deeper splits
        std::sort(refs.begin(), refs.end(),
                  [](const Ref& a, const Ref& b) { return a.prim < b.prim; });
        Node& nd = out->nodes[ni];
        nd.first = (int32_t)out->order.size();
        int32_t c = 0;
        int32_t prev = -1;
        for (const Ref& r : refs) {
            if (r.prim == prev) continue;
            out->order.push_back(r.prim);
            prev = r.prim;
            c++;
        }
        nd.count = c;
        out->max_leaf = std::max(out->max_leaf, c);
    }
};

}  // namespace

extern "C" {

int m3t_build_sbvh(const float* verts, int64_t n_verts,
                   const int32_t* faces, int64_t n_faces, int leaf_size,
                   float alpha, float budget_factor, void** handle,
                   int64_t* n_nodes_out, int64_t* n_refs_out) {
    (void)n_verts;
    auto* out = new SBVHOut();
    Builder B;
    B.verts = verts;
    B.faces = faces;
    B.leaf_size = leaf_size;
    B.alpha = alpha;
    B.ref_budget = (int64_t)(budget_factor * (double)n_faces);
    B.out = out;

    std::vector<Ref> refs(n_faces);
    AABB root;
    for (int64_t i = 0; i < n_faces; ++i) {
        V3 tv[3];
        B.tri_verts((int32_t)i, tv);
        AABB b;
        b.grow(tv[0]); b.grow(tv[1]); b.grow(tv[2]);
        refs[i] = Ref{(int32_t)i, b};
        root.grow(b);
    }
    B.root_area = std::max(root.area(), 1e-30f);
    out->nodes.reserve((size_t)(2.5 * (double)n_faces / leaf_size) + 16);
    B.build(refs, 0);

    *handle = out;
    *n_nodes_out = (int64_t)out->nodes.size();
    *n_refs_out = (int64_t)out->order.size();
    return 0;
}

void m3t_copy_sbvh(void* handle, float* lo, float* hi, int32_t* left,
                   int32_t* right, int32_t* first, int32_t* count,
                   int32_t* prim_order, int32_t* max_leaf) {
    auto* out = (SBVHOut*)handle;
    const size_t n = out->nodes.size();
    for (size_t i = 0; i < n; ++i) {
        const Node& nd = out->nodes[i];
        lo[3 * i] = nd.box.lo.x; lo[3 * i + 1] = nd.box.lo.y;
        lo[3 * i + 2] = nd.box.lo.z;
        hi[3 * i] = nd.box.hi.x; hi[3 * i + 1] = nd.box.hi.y;
        hi[3 * i + 2] = nd.box.hi.z;
        left[i] = nd.left; right[i] = nd.right;
        first[i] = nd.first; count[i] = nd.count;
    }
    memcpy(prim_order, out->order.data(),
           out->order.size() * sizeof(int32_t));
    *max_leaf = out->max_leaf;
}

void m3t_free_sbvh(void* handle) { delete (SBVHOut*)handle; }

}  // extern "C"
