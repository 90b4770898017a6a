// Native .obj parser: the loader of mesh-scale .obj files, a copy of
// raytrace_tpu/native/objparse.cpp.
//
// Exact same semantics as the Python parser (scene/obj.py), which itself
// mirrors the reference (Geometry.hs:207-285):
//   * '#' comments stripped, only "v " / "vt " / "f " lines used,
//     no leading-whitespace trimming (a line "  v ..." is ignored);
//   * 'v' needs >=3 decimal numbers (extras ignored), 'vt' >=1
//     (a single number means v=0);
//   * 'f' entries are i, i/j or i//k (normals ignored); 1-based and
//     negative-from-end indices; >=3 entries, fan-triangulated;
//   * two-phase: all v/vt collected before faces are resolved, so a
//     face may reference vertices declared later in the file;
//   * errors carry the 1-based line number with the Python parser's
//     exact messages.
//
// C ABI for ctypes (see scene/obj.py:_obj_lib, built by
// ops/_build.py:native_library).  Buffers are malloc'd here and released
// by the caller via rt_obj_free.
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tok { const char* p; size_t n; };

// Python str.split(): runs of whitespace separate tokens.
static void split_ws(const char* s, size_t n, std::vector<Tok>& out) {
  out.clear();
  size_t i = 0;
  while (i < n) {
    while (i < n && isspace((unsigned char)s[i])) i++;
    size_t j = i;
    while (j < n && !isspace((unsigned char)s[j])) j++;
    if (j > i) out.push_back({s + i, j - i});
    i = j;
  }
}

// Python number grammar detail: '_' digit separators are legal but only
// BETWEEN digits (float('1_0') == 10.0; '_1', '1_', '1__0' all raise).
// Strip them under that rule; returns false on an illegal separator.
static bool strip_underscores(const char* p, size_t n, char* buf,
                              size_t cap) {
  size_t o = 0;
  for (size_t i = 0; i < n; i++) {
    if (p[i] == '_') {
      if (i == 0 || i + 1 >= n || !isdigit((unsigned char)p[i - 1]) ||
          !isdigit((unsigned char)p[i + 1]))
        return false;
      continue;
    }
    if (o + 1 >= cap) return false;
    buf[o++] = p[i];
  }
  if (o == 0) return false;
  buf[o] = 0;
  return true;
}

// Python float(tok): strtod with full consumption; reject hex floats
// (strtod accepts "0x1p3", Python float() does not).
static bool parse_double(const Tok& t, double* out) {
  char buf[64];
  if (t.n > 63 || !strip_underscores(t.p, t.n, buf, sizeof buf))
    return false;
  if (strchr(buf, 'x') || strchr(buf, 'X')) return false;
  char* end = nullptr;
  double v = strtod(buf, &end);
  if (*end != 0 || end == buf) return false;
  *out = v;
  return true;
}

// Python int(tok): optional sign + decimal digits (+ '_' separators).
static bool parse_long(const char* p, size_t n, long* out) {
  char buf[32];
  if (n > 31 || !strip_underscores(p, n, buf, sizeof buf)) return false;
  char* end = nullptr;
  long v = strtol(buf, &end, 10);
  if (*end != 0 || end == buf) return false;
  *out = v;
  return true;
}

struct Error {
  long line;
  std::string msg;
};

// 1-based / negative-from-end -> 0-based (Geometry.hs:269-272)
static bool process_index(long length, long i, long* out) {
  if (1 <= i && i <= length) { *out = i - 1; return true; }
  if (-length <= i && i <= -1) { *out = i + length; return true; }
  return false;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 on parse error (err holds the message body,
// e.g. "line 17: invalid 'v' statement").  All out-arrays are malloc'd.
int rt_parse_obj(const char* text, long len,
                 double** out_verts, long* n_verts,
                 double** out_uvs, long* n_uvs,
                 long** out_faces, long** out_uv_faces, long* n_faces,
                 char* err, long err_cap) {
  std::vector<std::pair<long, std::pair<const char*, size_t>>> vls, vtls, fls;
  // line splitting: \n, \r\n or bare \r
  long line_no = 0;
  size_t i = 0;
  while (i < (size_t)len) {
    size_t j = i;
    while (j < (size_t)len && text[j] != '\n' && text[j] != '\r') j++;
    line_no++;
    const char* line = text + i;
    size_t ln = j - i;
    const char* hash = (const char*)memchr(line, '#', ln);
    if (hash) ln = hash - line;
    if (ln >= 2 && line[0] == 'v' && line[1] == ' ')
      vls.push_back({line_no, {line + 2, ln - 2}});
    else if (ln >= 3 && line[0] == 'v' && line[1] == 't' && line[2] == ' ')
      vtls.push_back({line_no, {line + 3, ln - 3}});
    else if (ln >= 2 && line[0] == 'f' && line[1] == ' ')
      fls.push_back({line_no, {line + 2, ln - 2}});
    if (j < (size_t)len) {
      if (text[j] == '\r' && j + 1 < (size_t)len && text[j + 1] == '\n') j++;
      j++;
    }
    i = j;
  }

  std::vector<double> verts, uvs;
  std::vector<long> faces, uv_faces;
  std::vector<Tok> toks;
  char msg[128];

  for (auto& [no, body] : vls) {
    split_ws(body.first, body.second, toks);
    double x, y, z;
    if (toks.size() < 3 || !parse_double(toks[0], &x) ||
        !parse_double(toks[1], &y) || !parse_double(toks[2], &z)) {
      snprintf(msg, sizeof msg, "line %ld: invalid 'v' statement", no);
      snprintf(err, err_cap, "%s", msg);
      return 1;
    }
    verts.push_back(x); verts.push_back(y); verts.push_back(z);
  }
  for (auto& [no, body] : vtls) {
    split_ws(body.first, body.second, toks);
    double u, v = 0.0;
    bool ok = !toks.empty() && parse_double(toks[0], &u);
    if (ok && toks.size() > 1) ok = parse_double(toks[1], &v);
    if (!ok) {
      snprintf(msg, sizeof msg, "line %ld: invalid 'vt' statement", no);
      snprintf(err, err_cap, "%s", msg);
      return 1;
    }
    uvs.push_back(u); uvs.push_back(v);
  }

  long nv = (long)verts.size() / 3, nt = (long)uvs.size() / 2;
  std::vector<long> vi, ti;
  for (auto& [no, body] : fls) {
    split_ws(body.first, body.second, toks);
    if (toks.size() < 3) {
      snprintf(msg, sizeof msg,
               "line %ld: invalid 'f' statement (fewer than 3 vertices)", no);
      snprintf(err, err_cap, "%s", msg);
      return 1;
    }
    vi.clear(); ti.clear();
    for (auto& t : toks) {
      // split on '/': parts[0] = vertex, parts[1] = uv (may be empty)
      const char* s1 = (const char*)memchr(t.p, '/', t.n);
      size_t n0 = s1 ? (size_t)(s1 - t.p) : t.n;
      long raw, idx;
      if (!parse_long(t.p, n0, &raw)) {
        snprintf(msg, sizeof msg, "line %ld: expected number", no);
        snprintf(err, err_cap, "%s", msg);
        return 1;
      }
      if (!process_index(nv, raw, &idx)) {
        snprintf(msg, sizeof msg, "line %ld: index out of bounds: %ld", no,
                 raw);
        snprintf(err, err_cap, "%s", msg);
        return 1;
      }
      long uvidx = -1;
      if (s1) {
        const char* p1 = s1 + 1;
        size_t rem = t.n - n0 - 1;
        const char* s2 = (const char*)memchr(p1, '/', rem);
        size_t n1 = s2 ? (size_t)(s2 - p1) : rem;
        if (n1 > 0) {
          long rawt;
          if (!parse_long(p1, n1, &rawt)) {
            snprintf(msg, sizeof msg, "line %ld: expected number", no);
            snprintf(err, err_cap, "%s", msg);
            return 1;
          }
          if (!process_index(nt, rawt, &uvidx)) {
            snprintf(msg, sizeof msg, "line %ld: index out of bounds: %ld",
                     no, rawt);
            snprintf(err, err_cap, "%s", msg);
            return 1;
          }
        }
      }
      vi.push_back(idx); ti.push_back(uvidx);
    }
    for (size_t k = 1; k + 1 < vi.size(); k++) {  // fan triangulation
      faces.push_back(vi[0]); faces.push_back(vi[k]); faces.push_back(vi[k + 1]);
      uv_faces.push_back(ti[0]); uv_faces.push_back(ti[k]);
      uv_faces.push_back(ti[k + 1]);
    }
  }

  auto copy_d = [](const std::vector<double>& v) {
    double* p = (double*)malloc(v.size() * sizeof(double) + 1);
    memcpy(p, v.data(), v.size() * sizeof(double));
    return p;
  };
  auto copy_l = [](const std::vector<long>& v) {
    long* p = (long*)malloc(v.size() * sizeof(long) + 1);
    memcpy(p, v.data(), v.size() * sizeof(long));
    return p;
  };
  *out_verts = copy_d(verts); *n_verts = nv;
  *out_uvs = copy_d(uvs); *n_uvs = nt;
  *out_faces = copy_l(faces); *out_uv_faces = copy_l(uv_faces);
  *n_faces = (long)faces.size() / 3;
  return 0;
}

void rt_obj_free(void* p) { free(p); }

}  // extern "C"
