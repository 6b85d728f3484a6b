// Native IO for opencl_ray_tracer_tpu_torch: OBJ parsing, Radiance HDR
// (RGBE) decoding, BMP encoding.
//
// The reference's asset-ingestion layer is native C++ (OBJ two-pass loader
// in src/cpp/utility.cpp:63-170, RGBE decoder in src/cpp/lib/hdrloader.cpp,
// BMP encoder in src/cpp/bitmap_io.cpp); this library is the port's copy of
// the JAX package's native/oclrt_native.cpp, built with g++ at first use and
// bound through ctypes (opencl_ray_tracer_tpu_torch/io/native.py).  Its
// results equal the pure-Python loaders' byte for byte
// (tests/test_torch_native.py).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

void oclrt_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// OBJ loader: 'v' and 'f' records, triangulated faces, plain and a/b/c
// forms, 1-indexed, scale+translate, AABB over transformed vertices.
// ---------------------------------------------------------------------------
int oclrt_load_obj(const char* path, const float* scale,
                   const float* translate, float** out_tris, int* out_n,
                   float* out_aabb /* minx..z, maxx..z */) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string text(size, '\0');
  if (std::fread(text.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  std::vector<float> verts;  // xyz triples, transformed
  std::vector<int64_t> faces;  // vertex-index triples (0-based)
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  float mx[3] = {-INFINITY, -INFINITY, -INFINITY};

  const char* p = text.c_str();
  const char* end = p + text.size();
  while (p < end) {
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    // skip leading whitespace
    const char* q = p;
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
    if (q + 1 < eol && q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char* next = nullptr;
      double x = std::strtod(q + 1, &next);
      double y = std::strtod(next, &next);
      double z = std::strtod(next, &next);
      float v[3] = {(float)x, (float)y, (float)z};
      for (int k = 0; k < 3; k++) {
        v[k] = v[k] * scale[k] + translate[k];
        mn[k] = std::min(mn[k], v[k]);
        mx[k] = std::max(mx[k], v[k]);
      }
      verts.insert(verts.end(), v, v + 3);
    } else if (q + 1 < eol && q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      // Tokenize like the reference (utility.cpp:134-157): whitespace-split
      // the vertex specs, join with '/', split on '/' KEEPING empty fields
      // ("1//2" -> ["1","","2"]), so "f v//n v//n v//n" yields 9 fields and
      // selects 0/3/6; plain "f a b c" yields 3 and selects 0/1/2.
      std::vector<std::string> fields;
      {
        std::string cur;
        bool in_field = false;
        for (const char* r = q + 1; r <= eol; r++) {
          char ch = (r < eol) ? *r : ' ';
          if (ch == ' ' || ch == '\t' || ch == '\r') {
            if (in_field) {
              fields.push_back(cur);
              cur.clear();
              in_field = false;
            }
          } else if (ch == '/') {
            fields.push_back(cur);  // may be empty
            cur.clear();
            in_field = true;  // stay inside the same spec
          } else {
            cur.push_back(ch);
            in_field = true;
          }
        }
      }
      long a, b, c;
      if (fields.size() == 9) {
        a = std::atol(fields[0].c_str());
        b = std::atol(fields[3].c_str());
        c = std::atol(fields[6].c_str());
      } else if (fields.size() >= 3) {
        a = std::atol(fields[0].c_str());
        b = std::atol(fields[1].c_str());
        c = std::atol(fields[2].c_str());
      } else {
        p = eol + 1;
        continue;
      }
      faces.push_back(a - 1);
      faces.push_back(b - 1);
      faces.push_back(c - 1);
    }
    p = eol + 1;
  }

  int n_tris = (int)(faces.size() / 3);
  float* tris =
      static_cast<float*>(std::malloc(sizeof(float) * 9 * std::max(n_tris, 1)));
  if (!tris) return 3;
  int64_t n_verts = (int64_t)(verts.size() / 3);
  for (int t = 0; t < n_tris; t++) {
    for (int corner = 0; corner < 3; corner++) {
      int64_t vi = faces[t * 3 + corner];
      if (vi < 0 || vi >= n_verts) {
        std::free(tris);
        return 4;
      }
      std::memcpy(&tris[(t * 3 + corner) * 3], &verts[vi * 3],
                  3 * sizeof(float));
    }
  }
  if (n_verts == 0) {
    for (int k = 0; k < 3; k++) mn[k] = mx[k] = 0.0f;
  }
  *out_tris = tris;
  *out_n = n_tris;
  std::memcpy(out_aabb, mn, 3 * sizeof(float));
  std::memcpy(out_aabb + 3, mx, 3 * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------------------
// Radiance HDR (RGBE) decoder: new-RLE and old-RLE scanlines, component
// conversion c * 2^(e-136).
// ---------------------------------------------------------------------------
namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok(size_t n) const { return p + n <= end; }
};

bool decode_new_rle(Cursor& c, uint8_t* scan /* W*4, planar-by-comp */,
                    int w) {
  for (int comp = 0; comp < 4; comp++) {
    int x = 0;
    while (x < w) {
      if (!c.ok(1)) return false;
      int code = *c.p++;
      if (code > 128) {  // run
        if (!c.ok(1)) return false;
        uint8_t val = *c.p++;
        int count = code - 128;
        if (x + count > w) return false;
        for (int i = 0; i < count; i++) scan[(x + i) * 4 + comp] = val;
        x += count;
      } else {  // dump
        if (!c.ok(code) || x + code > w) return false;
        for (int i = 0; i < code; i++) scan[(x + i) * 4 + comp] = *c.p++;
        x += code;
      }
    }
  }
  return true;
}

// seed: optional literal first pixel (mixed-mode, hdrloader.cpp:131-136);
// a repeat code as the very first record references the pixel before the
// scanline — UB in the reference; defined here as (0,0,0,0).
bool decode_old_rle(Cursor& c, const uint8_t* seed, uint8_t* scan, int w) {
  int x = 0;
  int rshift = 0;
  if (seed) {
    std::memcpy(scan, seed, 4);
    x = 1;
  }
  while (x < w) {
    if (!c.ok(4)) return false;
    const uint8_t* px = c.p;
    c.p += 4;
    if (px[0] == 1 && px[1] == 1 && px[2] == 1) {
      int count = ((int)px[3]) << rshift;
      if (x + count > w) return false;
      uint8_t prev[4] = {0, 0, 0, 0};
      if (x > 0) std::memcpy(prev, &scan[(x - 1) * 4], 4);
      for (int i = 0; i < count; i++)
        std::memcpy(&scan[(x + i) * 4], prev, 4);
      x += count;
      rshift += 8;
    } else {
      std::memcpy(&scan[x * 4], px, 4);
      x++;
      rshift = 0;
    }
  }
  return true;
}

void convert_scanline(const uint8_t* scan, float* out, int w) {
  for (int x = 0; x < w; x++) {
    int e = scan[x * 4 + 3];
    float s = std::ldexp(1.0f, e - 136);  // 2^(e-128-8)
    out[x * 3 + 0] = scan[x * 4 + 0] * s;
    out[x * 3 + 1] = scan[x * 4 + 1] * s;
    out[x * 3 + 2] = scan[x * 4 + 2] * s;
  }
}

}  // namespace

int oclrt_load_hdr(const char* path, float** out_img, int* out_w,
                   int* out_h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (std::fread(data.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  if (size < 2 || data[0] != '#' || data[1] != '?') return 3;
  // header: skip lines until blank, then parse the resolution line
  size_t pos = 0;
  auto next_line = [&](std::string& line) -> bool {
    line.clear();
    while (pos < data.size() && data[pos] != '\n')
      line.push_back((char)data[pos++]);
    if (pos >= data.size()) return false;
    pos++;  // consume '\n'
    return true;
  };
  std::string line;
  if (!next_line(line)) return 3;  // "#?RADIANCE"
  while (next_line(line)) {
    if (line.empty()) break;
  }
  if (!next_line(line)) return 3;  // "-Y H +X W"
  int w = 0, h = 0;
  if (std::sscanf(line.c_str(), "%*s %d %*s %d", &h, &w) != 2 || w <= 0 ||
      h <= 0)
    return 3;

  float* img = static_cast<float*>(std::malloc(sizeof(float) * 3 * w * h));
  if (!img) return 4;
  std::vector<uint8_t> scan(w * 4);
  Cursor c{data.data() + pos, data.data() + data.size()};
  for (int y = 0; y < h; y++) {
    // The reference's exact fallback ladder (hdrloader.cpp:122-139): see
    // io/hdr.py decode_hdr for the rules (byte-equal implementations).
    bool ok;
    if (w < 8 || w > 0x7fff) {
      ok = decode_old_rle(c, nullptr, scan.data(), w);
    } else if (!c.ok(1)) {
      ok = false;
    } else if (*c.p != 2) {
      ok = decode_old_rle(c, nullptr, scan.data(), w);
    } else {
      if (!c.ok(4)) {
        std::free(img);
        return 5;
      }
      const uint8_t* px = c.p;
      c.p += 4;
      if (px[1] != 2 || (px[2] & 128)) {
        uint8_t seed[4] = {2, px[1], px[2], px[3]};
        ok = decode_old_rle(c, seed, scan.data(), w);
      } else {
        ok = decode_new_rle(c, scan.data(), w);
      }
    }
    if (!ok) {
      std::free(img);
      return 5;
    }
    convert_scanline(scan.data(), img + (size_t)y * w * 3, w);
  }
  *out_img = img;
  *out_w = w;
  *out_h = h;
  return 0;
}

// ---------------------------------------------------------------------------
// BMP writer: 24-bit bottom-up, BGR, 4-byte row padding — bit-compatible
// with the reference encoder (bitmap_io.cpp:3-84).  img: (h, w, 3) RGB u8,
// row 0 = image bottom.
// ---------------------------------------------------------------------------
int oclrt_write_bmp(const char* path, const unsigned char* img, int w,
                    int h) {
  const int file_header = 14, info_header = 40;
  int row_bytes = w * 3;
  int pad = (4 - row_bytes % 4) % 4;
  int stride = row_bytes + pad;
  uint32_t file_size = file_header + info_header + stride * h;

  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  uint8_t fh[14] = {0};
  fh[0] = 'B';
  fh[1] = 'M';
  std::memcpy(&fh[2], &file_size, 4);
  uint32_t offset = file_header + info_header;
  std::memcpy(&fh[10], &offset, 4);
  std::fwrite(fh, 1, 14, f);

  uint8_t ih[40] = {0};
  uint32_t ihs = info_header;
  std::memcpy(&ih[0], &ihs, 4);
  std::memcpy(&ih[4], &w, 4);
  std::memcpy(&ih[8], &h, 4);
  ih[12] = 1;
  ih[14] = 24;
  std::fwrite(ih, 1, 40, f);

  std::vector<uint8_t> row(stride, 0);
  for (int y = 0; y < h; y++) {
    const unsigned char* src = img + (size_t)y * w * 3;
    for (int x = 0; x < w; x++) {
      row[x * 3 + 0] = src[x * 3 + 2];  // B
      row[x * 3 + 1] = src[x * 3 + 1];  // G
      row[x * 3 + 2] = src[x * 3 + 0];  // R
    }
    std::fwrite(row.data(), 1, stride, f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
