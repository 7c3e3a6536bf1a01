// Native host-side BED genotype kernels for hydra_tpu.
//
// TPU-native equivalent of the reference's performance-critical host data
// path: the 256-entry LUT decode (src/dotp_lut.h generated by mk_lut.cpp),
// the two-pass sparse ingestion (data.cpp:671-739, 1166-1290) and the
// missing-phenotype correction (data.cpp:1112-1158). On TPU the *compute*
// decode happens in-kernel on device; these C++ kernels feed the host side:
// marker statistics at load time, NA-correction repacking, and the
// .bed <-> sparse converters, all OpenMP-parallel over markers.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC bedio.cpp -o libbedio.so
// ABI:   plain C functions, driven from Python via ctypes.

#include <cstdint>
#include <cstring>

namespace {

// code -> genotype value (missing -> 0) and validity, mirroring
// dotp_lut_a / dotp_lut_b (inverted PLINK coding, data.cpp:879-884):
//   00 -> 2, 01 -> missing, 10 -> 1, 11 -> 0
struct Lut {
    float geno[256][4];
    float mask[256][4];
    int8_t code[256][4];
    Lut() {
        static const float ga[4] = {2.f, 0.f, 1.f, 0.f};
        static const float gb[4] = {1.f, 0.f, 1.f, 1.f};
        for (int b = 0; b < 256; ++b) {
            for (int j = 0; j < 4; ++j) {
                int c = (b >> (2 * j)) & 3;
                geno[b][j] = ga[c];
                mask[b][j] = gb[c];
                code[b][j] = (int8_t)c;
            }
        }
    }
};

// Function-local static: guaranteed initialization under dlopen (a namespace-
// scope global's dynamic initializer was observed not to run via ctypes).
inline const Lut& lut() {
    static const Lut L;
    return L;
}
#define LUT lut()

// Per-byte crumb-count LUT: c1[b]/c2[b]/cm[b] = how many of b's four codes
// are genotype-1 / genotype-2 / missing. Turns bed_counts' inner loop from
// 12 compare+adds per byte into 3 LUT loads + 3 adds (~4x, memory-bound).
struct CountLut {
    uint8_t c1[256], c2[256], cm[256];
    CountLut() {
        for (int b = 0; b < 256; ++b) {
            uint8_t a1 = 0, a2 = 0, am = 0;
            for (int j = 0; j < 4; ++j) {
                int c = (b >> (2 * j)) & 3;
                a1 += (c == 2);
                a2 += (c == 0);
                am += (c == 1);
            }
            c1[b] = a1; c2[b] = a2; cm[b] = am;
        }
    }
};

inline const CountLut& clut() {
    static const CountLut L;
    return L;
}

// PLINK byte -> h-packed device byte (crumb stores h = 2 - geno, missing=3;
// see hydra_tpu/ops/decode.py). Same table the Python hpack builds.
struct HpackLut {
    uint8_t t[256];
    HpackLut() {
        static const uint8_t hp[4] = {0, 3, 1, 2};  // PLINK code -> hpack
        for (int b = 0; b < 256; ++b) {
            uint8_t o = 0;
            for (int j = 0; j < 4; ++j)
                o |= hp[(b >> (2 * j)) & 3] << (2 * j);
            t[b] = o;
        }
    }
};

inline const HpackLut& hlut() {
    static const HpackLut L;
    return L;
}

}  // namespace

extern "C" {

// Per-marker genotype counts (N1, N2, NM) from packed rows.
// Equivalent of sparse_data_get_sizes_from_raw (data.cpp:1166-1216).
void bed_counts(const uint8_t* packed, int64_t m, int64_t nbytes, int64_t n,
                int64_t* n1, int64_t* n2, int64_t* nm) {
    const int64_t fullb = n / 4;
    const int64_t rem = n - fullb * 4;
    const CountLut& C = clut();
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* row = packed + i * nbytes;
        int64_t c1 = 0, c2 = 0, cm = 0;
        // u16 sub-accumulators: each byte adds <= 4, so flush every 8192
        // bytes stays far from overflow while keeping the hot loop narrow
        int64_t b = 0;
        while (b < fullb) {
            const int64_t e = (fullb - b < 8192) ? fullb : b + 8192;
            uint32_t a1 = 0, a2 = 0, am = 0;
            for (; b < e; ++b) {
                const uint8_t v = row[b];
                a1 += C.c1[v];
                a2 += C.c2[v];
                am += C.cm[v];
            }
            c1 += a1; c2 += a2; cm += am;
        }
        if (rem) {
            const int8_t* cc = LUT.code[row[fullb]];
            for (int64_t j = 0; j < rem; ++j) {
                c1 += (cc[j] == 2);
                c2 += (cc[j] == 0);
                cm += (cc[j] == 1);
            }
        }
        n1[i] = c1;
        n2[i] = c2;
        nm[i] = cm;
    }
}

// PLINK-coded packed bytes -> h-packed device bytes (the load-time repack
// of ops/decode.py, moved to OpenMP C++: the NumPy fancy-index LUT ran at
// ~0.25 GB/s, a real bottleneck at UKB scale — 1.7 TB of packed bytes).
// The crumb map 0->0, 1->3, 2->1, 3->2 has a closed bitwise form: with
// L = low bit and H = high bit of each crumb, out = (L << 1) | (L ^ H) —
// 5 ops per 64-bit word, fully vectorizable (vs a per-byte LUT gather).
void bed_hpack(const uint8_t* in, int64_t total, uint8_t* out) {
    const int64_t words = total / 8;
    const uint64_t* iw = reinterpret_cast<const uint64_t*>(in);
    uint64_t* ow = reinterpret_cast<uint64_t*>(out);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < words; ++i) {
        const uint64_t b = iw[i];
        const uint64_t L = b & 0x5555555555555555ULL;
        const uint64_t H = (b >> 1) & 0x5555555555555555ULL;
        ow[i] = (L << 1) | (L ^ H);
    }
    const HpackLut& T = hlut();
    for (int64_t i = words * 8; i < total; ++i) out[i] = T.t[in[i]];
}

// Dense LUT decode: packed (m, nbytes) -> geno/mask (m, nbytes*4) float32.
void bed_decode(const uint8_t* packed, int64_t m, int64_t nbytes,
                float* geno, float* mask) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* row = packed + i * nbytes;
        float* g = geno + i * nbytes * 4;
        float* mk = mask + i * nbytes * 4;
        for (int64_t b = 0; b < nbytes; ++b) {
            memcpy(g + 4 * b, LUT.geno[row[b]], 4 * sizeof(float));
            memcpy(mk + 4 * b, LUT.mask[row[b]], 4 * sizeof(float));
        }
    }
}

// Flat-deinterleaved int8 genotype planes (the HBM plane cache of
// hydra_tpu/ops/planes.py): out[i, k*nbytes + b] = geno(code k of byte b),
// missing/pad -> 0. Column order matches the device kernels' plane-major
// residual layout; see ops/planes.py module docstring.
void bed_expand_planes(const uint8_t* packed, int64_t m, int64_t nbytes,
                       int8_t* out) {
    static const int8_t gv[4] = {2, 0, 1, 0};
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* row = packed + i * nbytes;
        int8_t* o = out + i * nbytes * 4;
        for (int64_t b = 0; b < nbytes; ++b) {
            const uint8_t v = row[b];
            o[b] = gv[v & 3];
            o[nbytes + b] = gv[(v >> 2) & 3];
            o[2 * nbytes + b] = gv[(v >> 4) & 3];
            o[3 * nbytes + b] = gv[(v >> 6) & 3];
        }
    }
}

// Remove individuals (keep[i] == 0 -> drop) and repack; pad tail with
// missing codes. Equivalent outcome to
// sparse_data_correct_for_missing_phenotype (data.cpp:1112-1158).
void bed_remove_individuals(const uint8_t* packed, int64_t m, int64_t nbytes,
                            int64_t n, const uint8_t* keep,
                            uint8_t* out, int64_t out_nbytes) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* row = packed + i * nbytes;
        uint8_t* orow = out + i * out_nbytes;
        memset(orow, 0b01010101, out_nbytes);  // missing padding
        int64_t w = 0;
        uint8_t acc = 0;
        for (int64_t j = 0; j < n; ++j) {
            if (!keep[j]) continue;
            uint8_t c = (row[j >> 2] >> (2 * (j & 3))) & 3;
            acc |= c << (2 * (w & 3));
            if ((w & 3) == 3) {
                orow[w >> 2] = acc;
                acc = 0;
            }
            ++w;
        }
        if (w & 3) {
            // fill remaining slots of the last byte with missing codes
            for (int64_t j = w & 3; j < 4; ++j) acc |= uint8_t(1) << (2 * j);
            orow[w >> 2] = acc;
        }
    }
}

// Sparse fill: write index lists for genotype 1 / 2 / missing given
// precomputed per-marker offsets (two-pass scheme of data.cpp:1224-1290).
// Per-byte position LUT for the sparse fill: for each byte value, the lane
// offsets (0..3) whose code is genotype-1 / genotype-2 / missing, plus
// counts. Turns the fill from 3 branches per INDIVIDUAL into `count` stores
// per BYTE (zero work for all-zero-genotype 0xFF bytes — the common case on
// real panels). Measured ~8x over the per-individual branch loop.
struct SparseLut {
    uint8_t p1[256][4], p2[256][4], pm[256][4];
    uint8_t n1[256], n2[256], nm[256];
    SparseLut() {
        for (int b = 0; b < 256; ++b) {
            uint8_t a1 = 0, a2 = 0, am = 0;
            for (int j = 0; j < 4; ++j) {
                int c = (b >> (2 * j)) & 3;
                if (c == 2) p1[b][a1++] = (uint8_t)j;
                else if (c == 0) p2[b][a2++] = (uint8_t)j;
                else if (c == 1) pm[b][am++] = (uint8_t)j;
            }
            n1[b] = a1; n2[b] = a2; nm[b] = am;
        }
    }
};

inline const SparseLut& slut() {
    static const SparseLut L;
    return L;
}

void bed_sparse_fill(const uint8_t* packed, int64_t m, int64_t nbytes,
                     int64_t n,
                     const int64_t* s1, const int64_t* s2, const int64_t* sm,
                     uint32_t* i1, uint32_t* i2, uint32_t* im) {
    const SparseLut& S = slut();
    const int64_t fullb = n / 4;
    const int64_t rem = n - fullb * 4;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* row = packed + i * nbytes;
        int64_t o1 = s1[i], o2 = s2[i], om = sm[i];
        int64_t b = 0;
        // u64 fast-skip: 0xFF bytes are all-genotype-0 (nothing to emit) —
        // the dominant case on real low-maf panels; 8 bytes per compare
        while (b + 8 <= fullb) {
            uint64_t w;
            memcpy(&w, row + b, 8);
            if (w == 0xFFFFFFFFFFFFFFFFULL) { b += 8; continue; }
            const int64_t e = b + 8;
            for (; b < e; ++b) {
                const uint8_t v = row[b];
                if (v == 0xFF) continue;
                const uint32_t base = (uint32_t)(4 * b);
                for (int k = 0; k < S.n1[v]; ++k) i1[o1++] = base + S.p1[v][k];
                for (int k = 0; k < S.n2[v]; ++k) i2[o2++] = base + S.p2[v][k];
                for (int k = 0; k < S.nm[v]; ++k) im[om++] = base + S.pm[v][k];
            }
        }
        for (; b < fullb; ++b) {
            const uint8_t v = row[b];
            const uint32_t base = (uint32_t)(4 * b);
            for (int k = 0; k < S.n1[v]; ++k) i1[o1++] = base + S.p1[v][k];
            for (int k = 0; k < S.n2[v]; ++k) i2[o2++] = base + S.p2[v][k];
            for (int k = 0; k < S.nm[v]; ++k) im[om++] = base + S.pm[v][k];
        }
        if (rem) {  // partial last byte: never read lanes >= n
            const uint8_t v = row[fullb];
            const uint32_t base = (uint32_t)(4 * fullb);
            for (int k = 0; k < S.n1[v]; ++k)
                if (S.p1[v][k] < rem) i1[o1++] = base + S.p1[v][k];
            for (int k = 0; k < S.n2[v]; ++k)
                if (S.p2[v][k] < rem) i2[o2++] = base + S.p2[v][k];
            for (int k = 0; k < S.nm[v]; ++k)
                if (S.pm[v][k] < rem) im[om++] = base + S.pm[v][k];
        }
    }
}

// Standardized dot products on the host (validation / CPU fallback path):
// num_j = mstd_j * (sum g*eps - mave_j * sum mask*eps) — the AVX LUT kernel
// (BayesRRm.cpp:1774-1808) in portable OpenMP form.
void bed_dot(const uint8_t* packed, int64_t m, int64_t nbytes, int64_t n,
             const double* eps, const double* mave, const double* mstd,
             double* num) {
    const int64_t fullb = n / 4;
    const int64_t rem = n - fullb * 4;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* row = packed + i * nbytes;
        double s1 = 0.0, s2 = 0.0;
        for (int64_t b = 0; b < fullb; ++b) {
            const float* g = LUT.geno[row[b]];
            const float* mk = LUT.mask[row[b]];
            const double* e = eps + 4 * b;
            for (int j = 0; j < 4; ++j) {
                s1 += g[j] * e[j];
                s2 += mk[j] * e[j];
            }
        }
        if (rem) {
            const float* g = LUT.geno[row[fullb]];
            const float* mk = LUT.mask[row[fullb]];
            const double* e = eps + 4 * fullb;
            for (int64_t j = 0; j < rem; ++j) {
                s1 += g[j] * e[j];
                s2 += mk[j] * e[j];
            }
        }
        num[i] = mstd[i] * (s1 - mave[i] * s2);
    }
}

// Pack integer genotypes {0,1,2} (missing = anything else) into BED bytes.
// Inverse of bed_decode; used by the synthetic-data generators.
void bed_pack(const uint8_t* geno, int64_t m, int64_t n,
              uint8_t* out, int64_t nbytes) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* row = geno + i * n;
        uint8_t* orow = out + i * nbytes;
        memset(orow, 0b01010101, nbytes);  // pad tail with missing
        for (int64_t j = 0; j < n; ++j) {
            uint8_t g = row[j];
            // 0 -> 0b11, 1 -> 0b10, 2 -> 0b00, other -> 0b01 (missing)
            uint8_t c = (g == 0) ? 3 : (g == 1) ? 2 : (g == 2) ? 0 : 1;
            if ((j & 3) == 0) orow[j >> 2] = 0;
            orow[j >> 2] |= c << (2 * (j & 3));
        }
    }
}

// Generate HWE genotypes from per-marker thresholds applied to random bytes
// and pack directly: g = (u < a) + (u < b) with a,b in [0,256).
void bed_generate(const uint8_t* rand_bytes, int64_t m, int64_t n,
                  const uint8_t* thr_a, const uint8_t* thr_b,
                  uint8_t* out, int64_t nbytes) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        const uint8_t* u = rand_bytes + i * n;
        const uint8_t a = thr_a[i];
        const uint8_t b = thr_b[i];
        uint8_t* orow = out + i * nbytes;
        memset(orow, 0b01010101, nbytes);
        for (int64_t j = 0; j < n; ++j) {
            uint8_t g = (uint8_t)((u[j] < a) + (u[j] < b));
            uint8_t c = (g == 0) ? 3 : (g == 1) ? 2 : 0;
            if ((j & 3) == 0) orow[j >> 2] = 0;
            orow[j >> 2] |= c << (2 * (j & 3));
        }
    }
}

}  // extern "C"
