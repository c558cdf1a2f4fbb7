// Native data-loader core of the PyTorch port (a copy of
// streammos_tpu/native/loader.cpp; host code, not a kernel).
//
// The per-frame hot path of the input pipeline — scan IO, ego-motion
// transform, range crop, fixed-size resampling — as a small dependency-free
// C++ library with a C ABI, driven from Python via ctypes. ctypes releases
// the GIL during calls, so Python-side prefetch threads get true
// parallelism.
//
// Semantics mirror the numpy pipeline exactly:
//  * transform: xyz' = R xyz + t, intensity untouched
//  * crop: min-inclusive / max-exclusive per axis
//  * resample: n_out draws with replacement; the RNG is xoshiro256**
//    seeded per call — same distribution, not the same stream as numpy's
//    Generator.
//
// Build: python -m streammos_tpu_torch.native.build  (g++ -O3 -shared -fPIC,
// into build/native/ at the repository root)

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Read a KITTI .bin scan (float32 xyzi). Returns point count, -1 on error.
// Reads at most `cap` points.
int64_t smt_load_scan(const char* path, float* out, int64_t cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t n = (int64_t)fread(out, sizeof(float) * 4, (size_t)cap, f);
    fclose(f);
    return n;
}

// Read a KITTI .label file (uint32). Returns count, -1 on error.
int64_t smt_load_labels(const char* path, uint32_t* out, int64_t cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t n = (int64_t)fread(out, sizeof(uint32_t), (size_t)cap, f);
    fclose(f);
    return n;
}

// In-place rigid transform of xyz by a row-major 4x4 matrix.
void smt_transform(float* pts, int64_t n, const double* mat) {
    for (int64_t i = 0; i < n; ++i) {
        float* p = pts + i * 4;
        double x = p[0], y = p[1], z = p[2];
        p[0] = (float)(mat[0] * x + mat[1] * y + mat[2] * z + mat[3]);
        p[1] = (float)(mat[4] * x + mat[5] * y + mat[6] * z + mat[7]);
        p[2] = (float)(mat[8] * x + mat[9] * y + mat[10] * z + mat[11]);
    }
}

// Range crop: writes compacted points to out_pts (and a 0/1 mask over the
// input). lims = {xmin, xmax, ymin, ymax, zmin, zmax}. Returns valid count.
int64_t smt_filter(const float* pts, int64_t n, const float* lims,
                   float* out_pts, uint8_t* mask) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + i * 4;
        bool ok = p[0] >= lims[0] && p[0] < lims[1] && p[1] >= lims[2] &&
                  p[1] < lims[3] && p[2] >= lims[4] && p[2] < lims[5];
        mask[i] = ok ? 1 : 0;
        if (ok) {
            memcpy(out_pts + m * 4, p, sizeof(float) * 4);
            ++m;
        }
    }
    return m;
}

static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
}

// xoshiro256** — public-domain PRNG (Blackman & Vigna).
struct Xoshiro {
    uint64_t s[4];
    explicit Xoshiro(uint64_t seed) {
        // splitmix64 expansion of the seed
        uint64_t z = seed;
        for (int i = 0; i < 4; ++i) {
            z += 0x9e3779b97f4a7c15ULL;
            uint64_t t = z;
            t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
            t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
            s[i] = t ^ (t >> 31);
        }
    }
    uint64_t next() {
        uint64_t r = rotl(s[1] * 5, 7) * 9;
        uint64_t t = s[1] << 17;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 45);
        return r;
    }
};

// n_out uniform draws (with replacement) from [0, n).
void smt_resample_indices(int64_t n, int64_t n_out, uint64_t seed,
                          int32_t* idx_out) {
    Xoshiro rng(seed);
    for (int64_t i = 0; i < n_out; ++i) {
        // rejection-free Lemire reduction
        __uint128_t m = (__uint128_t)rng.next() * (__uint128_t)n;
        idx_out[i] = (int32_t)(uint64_t)(m >> 64);
    }
}

// Gather rows by indices: out[i] = pts[idx[i]] (4 floats) and
// lab_out[i] = labels[idx[i]].
void smt_gather(const float* pts, const int32_t* labels, const int32_t* idx,
                int64_t n_out, float* pts_out, int32_t* lab_out) {
    for (int64_t i = 0; i < n_out; ++i) {
        memcpy(pts_out + i * 4, pts + (int64_t)idx[i] * 4, sizeof(float) * 4);
        if (labels && lab_out) lab_out[i] = labels[idx[i]];
    }
}

// Fused eval-frame assembly: load scan, transform, crop, write the first
// n_valid rows of a fixed-size (n_out, 4) buffer pre-filled with the
// sentinel (-1000, -1000, -4000-ish) padding the reference uses
// (data_StreamMOS.py:565-574). Returns n_valid, -1 on IO error, -2 if
// n_valid > n_out.
int64_t smt_assemble_eval_frame(const char* path, const double* mat,
                                const float* lims, int64_t n_out,
                                float* out_pts, uint8_t* mask,
                                int64_t mask_cap, int64_t* n_raw_out) {
    const int64_t CAP = 1 << 21;
    static thread_local float* buf = nullptr;
    if (!buf) buf = new float[CAP * 4];
    int64_t n = smt_load_scan(path, buf, CAP);
    if (n < 0) return -1;
    if (n > mask_cap) return -3;
    *n_raw_out = n;
    smt_transform(buf, n, mat);
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = buf + i * 4;
        bool ok = p[0] >= lims[0] && p[0] < lims[1] && p[1] >= lims[2] &&
                  p[1] < lims[3] && p[2] >= lims[4] && p[2] < lims[5];
        mask[i] = ok ? 1 : 0;
        if (ok) {
            if (m >= n_out) return -2;
            memcpy(out_pts + m * 4, p, sizeof(float) * 4);
            ++m;
        }
    }
    for (int64_t i = m; i < n_out; ++i) {
        float* p = out_pts + i * 4;
        p[0] = -1000.0f;
        p[1] = -1000.0f;
        p[2] = -4000.0f;
        p[3] = -1000.0f;
    }
    return m;
}

}  // extern "C"
