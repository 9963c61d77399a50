// Native MAT-file (v5) reader: the data-loader hot path in C++.
//
// The reference's data layer is scipy.io.loadmat called per video file in the
// inner batch loop (utils/datagen.py:5-64 gen_batch_from_file); this reader
// replaces that path with a small zero-dependency (libz only) parser exposed
// through a C ABI for ctypes.  Python drives it from a thread pool — ctypes
// releases the GIL for the duration of the call, so file parsing and zlib
// inflation of many corpus shards run truly in parallel.
//
// Deliberately STRICT: numeric, real, non-sparse, little-endian arrays only
// (the dataset schema and every checkpoint the ABI defines — SURVEY.md §1 —
// are exactly that).  Anything else sets an error and the Python wrapper
// falls back to scipy wholesale, so behavior never diverges.
//
// Format notes (MAT-File Format, v5):
//   128-byte header (116 text, 8 subsys, 2 version, 2 endian "IM"=LE).
//   Stream of 8-byte-aligned data elements: [uint32 type][uint32 nbytes].
//   "Small data element": upper 16 bits of the first word carry nbytes(<=4),
//   payload lives in the tag's second word.
//   miCOMPRESSED(15) wraps one zlib-deflated element (usually miMATRIX).
//   miMATRIX(14) subelements: array flags (miUINT32 x2: class byte,
//   complex/global/logical flag bits, nzmax), dimensions (miINT32),
//   name (miINT8), real-part numeric data (any mi* numeric type — possibly
//   narrower than the class dtype; we surface the STORED type, matching
//   scipy.io.loadmat's default mat_dtype=False).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Array {
  std::string name;
  int32_t mitype = 0;   // storage type of the data subelement
  int32_t mclass = 0;   // MATLAB array class from the flags
  std::vector<int64_t> dims;
  std::vector<uint8_t> data;
};

struct Handle {
  std::vector<Array> arrays;
  std::string error;
};

size_t mitype_size(uint32_t t) {
  switch (t) {
    case 1: case 2: return 1;              // miINT8 / miUINT8
    case 3: case 4: return 2;              // miINT16 / miUINT16
    case 5: case 6: return 4;              // miINT32 / miUINT32
    case 7: return 4;                      // miSINGLE
    case 9: return 8;                      // miDOUBLE
    case 12: case 13: return 8;            // miINT64 / miUINT64
    default: return 0;
  }
}

// classes: 6 double, 7 single, 8 int8, 9 uint8, 10 int16, 11 uint16,
// 12 int32, 13 uint32, 14 int64, 15 uint64
bool numeric_class(int32_t c) { return c >= 6 && c <= 15; }

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool tag(uint32_t* type, uint32_t* bytes, const uint8_t** data, size_t* adv) {
    if (off + 8 > n) return false;
    uint32_t word0;
    std::memcpy(&word0, p + off, 4);
    if (word0 >> 16) {  // small data element
      *type = word0 & 0xffff;
      *bytes = word0 >> 16;
      if (*bytes > 4) return false;
      *data = p + off + 4;
      *adv = 8;
    } else {
      *type = word0;
      std::memcpy(bytes, p + off + 4, 4);
      *data = p + off + 8;
      size_t padded = (static_cast<size_t>(*bytes) + 7) & ~static_cast<size_t>(7);
      if (off + 8 + static_cast<size_t>(*bytes) > n) return false;
      *adv = 8 + padded;
    }
    return true;
  }
};

bool parse_matrix(const uint8_t* p, size_t n, Handle* h) {
  Cursor c{p, n};
  Array arr;
  uint32_t type, bytes;
  const uint8_t* data;
  size_t adv;

  // array flags
  if (!c.tag(&type, &bytes, &data, &adv) || type != 6 || bytes < 8) {
    h->error = "bad array flags";
    return false;
  }
  uint32_t flags;
  std::memcpy(&flags, data, 4);
  arr.mclass = flags & 0xff;
  if (flags & 0x0800) { h->error = "complex arrays unsupported"; return false; }
  // logical arrays load as bool through scipy; defer to the fallback so
  // dtypes never diverge between the two readers
  if (flags & 0x0200) { h->error = "logical arrays unsupported"; return false; }
  if (!numeric_class(arr.mclass)) {
    h->error = "non-numeric array class " + std::to_string(arr.mclass);
    return false;
  }
  c.off += adv;

  // dimensions
  if (!c.tag(&type, &bytes, &data, &adv) || type != 5) {
    h->error = "bad dimensions element";
    return false;
  }
  size_t nd = bytes / 4;
  if (nd < 1 || nd > 8) { h->error = "bad ndim"; return false; }
  for (size_t i = 0; i < nd; i++) {
    int32_t d;
    std::memcpy(&d, data + 4 * i, 4);
    if (d < 0) { h->error = "negative dimension"; return false; }
    arr.dims.push_back(d);
  }
  c.off += adv;

  // name — returned to Python as a C string, so an embedded NUL would
  // silently truncate the key where scipy keeps the raw bytes (found by
  // scripts/fuzz_matread.py); such names never occur in real MAT files,
  // so defer them to the scipy fallback instead of diverging
  if (!c.tag(&type, &bytes, &data, &adv) || type != 1) {
    h->error = "bad name element";
    return false;
  }
  if (std::memchr(data, 0, bytes) != nullptr) {
    h->error = "NUL byte in array name";
    return false;
  }
  arr.name.assign(reinterpret_cast<const char*>(data), bytes);
  c.off += adv;

  // real-part data
  if (!c.tag(&type, &bytes, &data, &adv)) { h->error = "missing data element"; return false; }
  if (mitype_size(type) == 0) {
    h->error = "unsupported data storage type " + std::to_string(type);
    return false;
  }
  // element count, guarded against signed-overflow UB on adversarial dims:
  // every dim is non-negative (checked above) and the running product may
  // never exceed what the data payload could possibly hold
  const int64_t max_count =
      static_cast<int64_t>(bytes / mitype_size(type)) + 1;
  int64_t count = 1;
  for (int64_t d : arr.dims) {
    if (d != 0 && count > max_count / d) {
      h->error = "dimension product overflows data size";
      return false;
    }
    count *= d;
  }
  if (static_cast<int64_t>(bytes / mitype_size(type)) != count) {
    h->error = "data size does not match dims";
    return false;
  }
  arr.mitype = static_cast<int32_t>(type);
  arr.data.assign(data, data + bytes);
  h->arrays.push_back(std::move(arr));
  return true;
}

bool inflate_element(const uint8_t* src, size_t n, std::vector<uint8_t>* out) {
  out->resize(n * 4 + 1024);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  size_t written = 0;
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    if (written == out->size()) out->resize(out->size() * 2);
    zs.next_out = out->data() + written;
    zs.avail_out = static_cast<uInt>(out->size() - written);
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) { inflateEnd(&zs); return false; }
    written = out->size() - zs.avail_out;
  }
  inflateEnd(&zs);
  out->resize(written);
  return true;
}

bool parse_elements(const uint8_t* p, size_t n, Handle* h) {
  Cursor c{p, n};
  uint32_t type, bytes;
  const uint8_t* data;
  size_t adv;
  while (c.off + 8 <= c.n) {
    if (!c.tag(&type, &bytes, &data, &adv)) { h->error = "truncated element"; return false; }
    if (type == 0 && bytes == 0) {  // alignment filler
      c.off += 8;
      continue;
    }
    if (type == 14) {  // miMATRIX
      if (!parse_matrix(data, bytes, h)) return false;
    } else if (type == 15) {  // miCOMPRESSED
      // unlike every other element, compressed elements are NOT padded to
      // an 8-byte boundary — advance by the exact payload size
      adv = 8 + bytes;
      std::vector<uint8_t> buf;
      if (!inflate_element(data, bytes, &buf)) { h->error = "zlib inflate failed"; return false; }
      Cursor inner{buf.data(), buf.size()};
      uint32_t it, ib;
      const uint8_t* id;
      size_t ia;
      if (!inner.tag(&it, &ib, &id, &ia) || it != 14) {
        h->error = "compressed element is not a matrix";
        return false;
      }
      if (!parse_matrix(id, ib, h)) return false;
    } else {
      h->error = "unsupported top-level element type " + std::to_string(type);
      return false;
    }
    c.off += adv;
  }
  return true;
}

}  // namespace

extern "C" {

void* ipav_open(const char* path) {
  Handle* h = new Handle();
  FILE* f = std::fopen(path, "rb");
  if (!f) { h->error = "cannot open file"; return h; }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 128) { std::fclose(f); h->error = "not a MAT v5 file"; return h; }
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    h->error = "short read";
    return h;
  }
  std::fclose(f);
  // scipy.io.loadmat reads a file with a zero in its first 4 bytes as MAT
  // v4, and one whose version word is not 0x0100 as another format; defer
  // both so the two readers never parse one file two ways
  if (!buf[0] || !buf[1] || !buf[2] || !buf[3]) {
    h->error = "MAT v4 header (a zero in the first 4 bytes)";
    return h;
  }
  if (buf[124] != 0x00 || buf[125] != 0x01 || buf[126] != 'I' || buf[127] != 'M') {
    h->error = "not little-endian MAT v5";
    return h;
  }
  if (!parse_elements(buf.data() + 128, buf.size() - 128, h)) h->arrays.clear();
  return h;
}

const char* ipav_error(void* hp) { return static_cast<Handle*>(hp)->error.c_str(); }
int ipav_count(void* hp) { return static_cast<int>(static_cast<Handle*>(hp)->arrays.size()); }
const char* ipav_name(void* hp, int i) { return static_cast<Handle*>(hp)->arrays[i].name.c_str(); }
int ipav_mitype(void* hp, int i) { return static_cast<Handle*>(hp)->arrays[i].mitype; }
int ipav_class(void* hp, int i) { return static_cast<Handle*>(hp)->arrays[i].mclass; }
int ipav_ndim(void* hp, int i) {
  return static_cast<int>(static_cast<Handle*>(hp)->arrays[i].dims.size());
}
const int64_t* ipav_dims(void* hp, int i) { return static_cast<Handle*>(hp)->arrays[i].dims.data(); }
const void* ipav_data(void* hp, int i) { return static_cast<Handle*>(hp)->arrays[i].data.data(); }
int64_t ipav_nbytes(void* hp, int i) {
  return static_cast<int64_t>(static_cast<Handle*>(hp)->arrays[i].data.size());
}
void ipav_close(void* hp) { delete static_cast<Handle*>(hp); }

}  // extern "C"
