// Native NIfTI-1 decoder: the framework's C++ data-loading layer.
//
// The reference loads volumes through nibabel/torchio in Python
// (reference src/datatype.py:30); at production scale (hundreds of
// 256^3 ReMIND cases per training epoch) decode becomes a host-side
// bottleneck.  This library does the heavy lifting natively: gzip
// inflate (zlib), header parse (both endiannesses), dtype conversion to
// float32, scl_slope/scl_inter application, and multithreaded batch
// decode — exposed through a minimal C ABI consumed via ctypes
// (diffus_tpu/io/native.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 nifti_native.cpp -o libnifti_native.so -lz -lpthread

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Buffer {
  std::vector<unsigned char> data;
};

// Read a whole file; transparently inflate if gzip (magic 1f 8b).
// min_size guards header reads (348: a bare two-file .hdr has no
// extension bytes); .img companions carry raw voxels, any size >= 1.
static bool read_file(const char* path, Buffer& out, size_t min_size = 348) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return false;
  std::fseek(fh, 0, SEEK_END);
  long size = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  if (size <= 0) { std::fclose(fh); return false; }
  std::vector<unsigned char> raw(static_cast<size_t>(size));
  size_t got = std::fread(raw.data(), 1, raw.size(), fh);
  std::fclose(fh);
  if (got != raw.size()) return false;

  if (raw.size() >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    // gzip: inflate with growing output buffer
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
    out.data.resize(raw.size() * 4 + (1u << 20));
    zs.next_in = raw.data();
    zs.avail_in = static_cast<uInt>(raw.size());
    size_t written = 0;
    int rc = Z_OK;
    while (rc != Z_STREAM_END) {
      if (written == out.data.size()) out.data.resize(out.data.size() * 2);
      zs.next_out = out.data.data() + written;
      zs.avail_out = static_cast<uInt>(out.data.size() - written);
      rc = inflate(&zs, Z_NO_FLUSH);
      if (rc != Z_OK && rc != Z_STREAM_END) { inflateEnd(&zs); return false; }
      written = out.data.size() - zs.avail_out;
    }
    inflateEnd(&zs);
    out.data.resize(written);
  } else {
    out.data = std::move(raw);
  }
  return out.data.size() >= min_size;
}

// Resolve the .img voxel companion of a two-file ("ni1" magic) NIfTI
// header: strip .gz / .hdr (or .nii), append .img, prefer the
// uncompressed file, fall back to .img.gz.
static bool companion_img(const char* path, std::string& out) {
  std::string p(path);
  if (p.size() > 3 && p.compare(p.size() - 3, 3, ".gz") == 0)
    p.resize(p.size() - 3);
  if (p.size() > 4 && (p.compare(p.size() - 4, 4, ".hdr") == 0 ||
                       p.compare(p.size() - 4, 4, ".nii") == 0))
    p.resize(p.size() - 4);
  p += ".img";
  for (const std::string& cand : {p, p + ".gz"}) {
    FILE* fh = std::fopen(cand.c_str(), "rb");
    if (fh) {
      std::fclose(fh);
      out = cand;
      return true;
    }
  }
  return false;
}

static uint16_t load_u16(const unsigned char* p, bool swap) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  if (swap) v = static_cast<uint16_t>((v >> 8) | (v << 8));
  return v;
}

static int16_t load_i16(const unsigned char* p, bool swap) {
  return static_cast<int16_t>(load_u16(p, swap));
}

static uint32_t load_u32(const unsigned char* p, bool swap) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  if (swap) v = __builtin_bswap32(v);
  return v;
}

static int32_t load_i32(const unsigned char* p, bool swap) {
  return static_cast<int32_t>(load_u32(p, swap));
}

static float load_f32(const unsigned char* p, bool swap) {
  uint32_t v = load_u32(p, swap);
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}

struct Header {
  int ndim = 0;
  int64_t shape[7] = {1, 1, 1, 1, 1, 1, 1};
  int datatype = 0;
  int64_t vox_offset = 352;
  float scl_slope = 1.0f, scl_inter = 0.0f;
  float pixdim[8] = {1, 1, 1, 1, 1, 1, 1, 1};
  float affine[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  bool swap = false;
  bool two_file = false;  // "ni1" magic: voxels live in a sibling .img
};

static bool parse_header(const Buffer& buf, Header& h) {
  const unsigned char* p = buf.data.data();
  int32_t sizeof_hdr = load_i32(p, false);
  if (sizeof_hdr == 348) {
    h.swap = false;
  } else {
    sizeof_hdr = load_i32(p, true);
    if (sizeof_hdr != 348) return false;
    h.swap = true;
  }
  const char* magic = reinterpret_cast<const char*>(p + 344);
  if (std::strncmp(magic, "n+1", 3) != 0 && std::strncmp(magic, "ni1", 3) != 0)
    return false;
  h.two_file = std::strncmp(magic, "ni1", 3) == 0;

  int ndim = load_i16(p + 40, h.swap);
  if (ndim < 1) ndim = 1;
  if (ndim > 7) ndim = 7;
  h.ndim = ndim;
  for (int i = 0; i < ndim; ++i) {
    int16_t d = load_i16(p + 40 + 2 * (i + 1), h.swap);
    h.shape[i] = d > 0 ? d : 1;
  }
  h.datatype = load_i16(p + 70, h.swap);
  for (int i = 0; i < 8; ++i) h.pixdim[i] = load_f32(p + 76 + 4 * i, h.swap);
  float vox = load_f32(p + 108, h.swap);
  // single-file: voxels follow the 348-byte header + extensions, so the
  // offset is at least 352.  Two-file ("ni1"): vox_offset indexes into
  // the separate .img and is commonly 0 — no floor applies.
  if (h.two_file)
    h.vox_offset = vox < 0.0f ? 0 : static_cast<int64_t>(vox);
  else
    h.vox_offset = vox < 352.0f ? 352 : static_cast<int64_t>(vox);
  h.scl_slope = load_f32(p + 112, h.swap);
  h.scl_inter = load_f32(p + 116, h.swap);

  int16_t qform = load_i16(p + 252, h.swap);
  int16_t sform = load_i16(p + 254, h.swap);
  if (sform > 0) {
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 4; ++c)
        h.affine[r * 4 + c] = load_f32(p + 280 + 16 * r + 4 * c, h.swap);
  } else if (qform > 0) {
    // quaternion method
    double b = load_f32(p + 256, h.swap);
    double c = load_f32(p + 260, h.swap);
    double d = load_f32(p + 264, h.swap);
    double qx = load_f32(p + 268, h.swap);
    double qy = load_f32(p + 272, h.swap);
    double qz = load_f32(p + 276, h.swap);
    double a2 = 1.0 - (b * b + c * c + d * d);
    double a = a2 > 0 ? std::sqrt(a2) : 0.0;
    double qfac = h.pixdim[0] < 0 ? -1.0 : 1.0;
    double R[9] = {
        a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
        2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c};
    double S[3] = {h.pixdim[1], h.pixdim[2], qfac * h.pixdim[3]};
    for (int r = 0; r < 3; ++r)
      for (int cc = 0; cc < 3; ++cc)
        h.affine[r * 4 + cc] = static_cast<float>(R[r * 3 + cc] * S[cc]);
    h.affine[3] = static_cast<float>(qx);
    h.affine[7] = static_cast<float>(qy);
    h.affine[11] = static_cast<float>(qz);
    // fix translation slots: affine is row-major 4x4; translations at col 3
    h.affine[0 * 4 + 3] = static_cast<float>(qx);
    h.affine[1 * 4 + 3] = static_cast<float>(qy);
    h.affine[2 * 4 + 3] = static_cast<float>(qz);
  } else {
    h.affine[0] = h.pixdim[1];
    h.affine[5] = h.pixdim[2];
    h.affine[10] = h.pixdim[3];
  }
  return true;
}

template <typename T>
static void convert(const unsigned char* src, float* dst, int64_t n, bool swap) {
  for (int64_t i = 0; i < n; ++i) {
    T v;
    std::memcpy(&v, src + i * sizeof(T), sizeof(T));
    if (swap) {
      if (sizeof(T) == 2) {
        uint16_t u;
        std::memcpy(&u, &v, 2);
        u = static_cast<uint16_t>((u >> 8) | (u << 8));
        std::memcpy(&v, &u, 2);
      } else if (sizeof(T) == 4) {
        uint32_t u;
        std::memcpy(&u, &v, 4);
        u = __builtin_bswap32(u);
        std::memcpy(&v, &u, 4);
      } else if (sizeof(T) == 8) {
        uint64_t u;
        std::memcpy(&u, &v, 8);
        u = __builtin_bswap64(u);
        std::memcpy(&v, &u, 8);
      }
    }
    dst[i] = static_cast<float>(v);
  }
}

static int dtype_size(int code) {
  switch (code) {
    case 2: case 256: return 1;
    case 4: case 512: return 2;
    case 8: case 768: case 16: return 4;
    case 64: case 1024: case 1280: return 8;
    default: return 0;
  }
}

static int decode_one(const char* path, float* out, int64_t capacity,
                      int64_t* shape_out, float* affine_out, float* spacing_out) {
  Buffer buf;
  if (!read_file(path, buf)) return -1;
  Header h;
  if (!parse_header(buf, h)) return -2;

  int64_t n = 1;
  for (int i = 0; i < h.ndim; ++i) n *= h.shape[i];
  if (shape_out) {
    shape_out[0] = h.ndim;
    for (int i = 0; i < 7; ++i) shape_out[i + 1] = h.shape[i];
  }
  if (affine_out) std::memcpy(affine_out, h.affine, 16 * sizeof(float));
  if (spacing_out)
    for (int i = 0; i < 3; ++i)
      spacing_out[i] = h.pixdim[i + 1] < 0 ? -h.pixdim[i + 1] : h.pixdim[i + 1];
  if (!out) return static_cast<int>(h.ndim);  // probe mode
  if (capacity < n) return -3;

  int esize = dtype_size(h.datatype);
  if (esize == 0) return -4;
  Buffer img;  // two-file voxels: must outlive `src`
  const Buffer* vox_buf = &buf;
  if (h.two_file) {
    std::string img_path;
    if (!companion_img(path, img_path)) return -8;  // missing .img sibling
    if (!read_file(img_path.c_str(), img, 1)) return -8;
    vox_buf = &img;
  }
  if (static_cast<int64_t>(vox_buf->data.size()) < h.vox_offset + n * esize)
    return -5;
  const unsigned char* src = vox_buf->data.data() + h.vox_offset;

  switch (h.datatype) {
    case 2: convert<uint8_t>(src, out, n, false); break;
    case 256: convert<int8_t>(src, out, n, false); break;
    case 4: convert<int16_t>(src, out, n, h.swap); break;
    case 512: convert<uint16_t>(src, out, n, h.swap); break;
    case 8: convert<int32_t>(src, out, n, h.swap); break;
    case 768: convert<uint32_t>(src, out, n, h.swap); break;
    case 16: convert<float>(src, out, n, h.swap); break;
    case 64: convert<double>(src, out, n, h.swap); break;
    case 1024: convert<int64_t>(src, out, n, h.swap); break;
    case 1280: convert<uint64_t>(src, out, n, h.swap); break;
    default: return -4;
  }
  bool has_scl = h.scl_slope != 0.0f && h.scl_slope == h.scl_slope;  // not NaN
  if (has_scl && (h.scl_slope != 1.0f || h.scl_inter != 0.0f)) {
    for (int64_t i = 0; i < n; ++i) out[i] = out[i] * h.scl_slope + h.scl_inter;
  }
  return static_cast<int>(h.ndim);
}

}  // namespace

extern "C" {

// ABI version of this library.  diffus_tpu/io/native.py checks it at
// load time and falls back to the pure-Python reader on mismatch — a
// stale .so that failed to rebuild (no toolchain) must never be called
// through a newer ctypes signature.  Bump on ANY exported-signature or
// semantic change.
int nifti_abi_version(void) { return 3; }

// Probe metadata without decoding voxels.
// shape_out: int64[8] = [ndim, d0..d6]; affine_out: float[16] row-major;
// spacing_out: float[3].  Returns ndim (>0) or negative error code.
int nifti_probe(const char* path, int64_t* shape_out, float* affine_out,
                float* spacing_out) {
  return decode_one(path, nullptr, 0, shape_out, affine_out, spacing_out);
}

// Full decode into caller buffer (file element order / Fortran layout).
int nifti_read_f32(const char* path, float* out, int64_t capacity,
                   int64_t* shape_out, float* affine_out, float* spacing_out) {
  return decode_one(path, out, capacity, shape_out, affine_out, spacing_out);
}

// Batch decode `count` equally-sized volumes with `threads` worker threads.
// out is count * per_volume floats; status[i] receives per-file result.
// expected_shape (int64[8] = [ndim, d0..d6], nullable) pins every file to
// one shape: a smaller file would otherwise decode "successfully" leaving
// the tail of its slot uninitialized, and a same-count/different-dims file
// would silently reshape wrong.  Mismatches get status -6.
void nifti_read_batch_f32(const char** paths, int count, float* out,
                          int64_t per_volume, const int64_t* expected_shape,
                          int threads, int* status) {
  if (threads < 1) threads = 1;
  std::vector<std::thread> pool;
  auto worker = [&](int tid) {
    for (int i = tid; i < count; i += threads) {
      int64_t shp[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      status[i] = decode_one(paths[i], out + static_cast<int64_t>(i) * per_volume,
                             per_volume, shp, nullptr, nullptr);
      if (status[i] > 0 && expected_shape) {
        bool ok = true;
        for (int k = 0; k < 8 && ok; ++k) ok = shp[k] == expected_shape[k];
        if (!ok) status[i] = -6;
      }
    }
  };
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
}

// Write a minimal single-file NIfTI-1 (.nii / gzipped) with an sform
// affine — float32 voxels, Fortran element order (mirrors the Python
// writer diffus_tpu/io/nifti.py save_nifti).  Returns 1, or a negative
// error code (-1 open/write failure, -2 bad args, -7 zlib failure).
int nifti_write_f32(const char* path, const float* data, int ndim,
                    const int64_t* shape, const float* affine, int compress) {
  if (!path || !data || ndim < 1 || ndim > 7 || !shape) return -2;
  int64_t n = 1;
  for (int i = 0; i < ndim; ++i) {
    // NIfTI-1 dims are int16: reject anything unrepresentable instead of
    // silently truncating into a corrupt header (the Python writer's
    // struct.pack '<8h' raises on the same input)
    if (shape[i] < 1 || shape[i] > 32767) return -2;
    n *= shape[i];
  }

  std::vector<unsigned char> hdr(352, 0);
  auto put_i32 = [&](size_t off, int32_t v) { std::memcpy(&hdr[off], &v, 4); };
  auto put_i16 = [&](size_t off, int16_t v) { std::memcpy(&hdr[off], &v, 2); };
  auto put_f32 = [&](size_t off, float v) { std::memcpy(&hdr[off], &v, 4); };

  put_i32(0, 348);
  put_i16(40, static_cast<int16_t>(ndim));
  for (int i = 0; i < 7; ++i)
    put_i16(42 + 2 * i, static_cast<int16_t>(i < ndim ? shape[i] : 1));
  put_i16(70, 16);  // DT_FLOAT32
  put_i16(72, 32);  // bitpix
  put_f32(76, 1.0f);
  for (int c = 0; c < 3; ++c) {
    // pixdim from the affine's column norms, like the Python writer
    float s = 0.0f;
    if (affine)
      for (int r = 0; r < 3; ++r) s += affine[r * 4 + c] * affine[r * 4 + c];
    put_f32(80 + 4 * c, affine ? std::sqrt(s) : 1.0f);
  }
  for (int i = 4; i < 8; ++i) put_f32(76 + 4 * i, 1.0f);
  put_f32(108, 352.0f);  // vox_offset
  put_f32(112, 1.0f);    // scl_slope
  put_f32(116, 0.0f);    // scl_inter
  put_i16(252, 0);       // qform_code
  put_i16(254, 1);       // sform_code
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c)
      put_f32(280 + 16 * r + 4 * c,
              affine ? affine[r * 4 + c] : (r == c ? 1.0f : 0.0f));
  hdr[344] = 'n'; hdr[345] = '+'; hdr[346] = '1'; hdr[347] = 0;

  const unsigned char* body = reinterpret_cast<const unsigned char*>(data);
  size_t body_bytes = static_cast<size_t>(n) * 4;

  if (compress) {
    gzFile gz = gzopen(path, "wb");
    if (!gz) return -1;
    if (gzwrite(gz, hdr.data(), 352) != 352) { gzclose(gz); return -7; }
    size_t written = 0;
    while (written < body_bytes) {
      unsigned chunk = static_cast<unsigned>(
          std::min<size_t>(body_bytes - written, 1u << 28));
      int rc = gzwrite(gz, body + written, chunk);
      if (rc <= 0) { gzclose(gz); return -7; }
      written += static_cast<size_t>(rc);
    }
    return gzclose(gz) == Z_OK ? 1 : -7;
  }

  FILE* fh = std::fopen(path, "wb");
  if (!fh) return -1;
  bool ok = std::fwrite(hdr.data(), 1, 352, fh) == 352 &&
            std::fwrite(body, 1, body_bytes, fh) == body_bytes;
  return std::fclose(fh) == 0 && ok ? 1 : -1;
}

}  // extern "C"
