// gpdla_io: multithreaded bulk loader for SDSS speclite coadd FITS files.
//
// Native runtime component of gp_dla_detection (the reference's only
// native code is its Voigt MEX kernel, voigt.c — here XLA replaces
// that on the accelerator, and the native layer instead accelerates
// the host-side data plane: preload_qsos.m's sequential loop over
// ~162k FITS files, read_spec.m:6-39 semantics per file).
//
// Exposed C ABI (ctypes, see gp_dla_detection/io/native.py):
//
//   int gpdla_read_spec_batch(
//       const char** paths, int n_files, int max_pixels, int n_threads,
//       double* wavelengths,   // (n_files, max_pixels) row-major out
//       double* flux,
//       double* noise_variance,
//       uint8_t* pixel_mask,
//       int* lengths)          // per-file pixel count, or -errno-style <0
//
// Per read_spec.m: wavelengths = 10^LOGLAM, noise_variance = 1/IVAR
// (inf where IVAR == 0), pixel_mask = (IVAR == 0) | BRIGHTSKY bit 23 of
// AND_MASK.

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <fstream>
#include <limits>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kBlock = 2880;
constexpr int kBrightSkyBit = 23;

struct Column {
  std::string name;
  char code = 0;   // TFORM type code
  int repeat = 1;
  size_t offset = 0;  // byte offset within a row
  size_t size = 0;    // bytes
};

size_t type_size(char code) {
  switch (code) {
    case 'L': case 'B': case 'A': return 1;
    case 'I': return 2;
    case 'J': case 'E': return 4;
    case 'K': case 'D': return 8;
    default: return 0;
  }
}

// Parse one header starting at `off`; returns cards via callback-free
// simple storage. Advances off past the header blocks.
struct Header {
  std::vector<std::pair<std::string, std::string>> cards;
  const std::string* find(const char* key) const {
    for (const auto& kv : cards)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
  // NAXIS-class values are read into a fixed 64-bit type: on ILP32
  // targets a 32-bit long would both truncate the parse and make the
  // (1 << 32) overflow guard below undefined behavior
  int64_t get_long(const char* key, int64_t dflt = -1) const {
    const std::string* v = find(key);
    return v ? std::strtoll(v->c_str(), nullptr, 10) : dflt;
  }
  std::string get_str(const char* key) const {
    const std::string* v = find(key);
    if (!v) return "";
    std::string s = *v;
    // strip quotes and blanks
    size_t a = s.find('\'');
    if (a != std::string::npos) {
      size_t b = s.find('\'', a + 1);
      s = s.substr(a + 1, b == std::string::npos ? std::string::npos
                                                 : b - a - 1);
    }
    while (!s.empty() && s.back() == ' ') s.pop_back();
    while (!s.empty() && s.front() == ' ') s.erase(s.begin());
    return s;
  }
};

bool read_header(const std::vector<char>& buf, size_t* off, Header* hdr) {
  hdr->cards.clear();
  while (*off + kBlock <= buf.size()) {
    const char* block = buf.data() + *off;
    *off += kBlock;
    for (size_t i = 0; i < kBlock; i += 80) {
      std::string card(block + i, 80);
      std::string key = card.substr(0, 8);
      while (!key.empty() && key.back() == ' ') key.pop_back();
      if (key == "END") return true;
      if (key.empty() || card[8] != '=') continue;
      std::string value = card.substr(10);
      // drop trailing comment (keep quoted strings intact)
      size_t q = value.find('\'');
      size_t slash;
      if (q != std::string::npos) {
        size_t q2 = value.find('\'', q + 1);
        slash = value.find('/', q2 == std::string::npos ? q + 1 : q2);
      } else {
        slash = value.find('/');
      }
      if (slash != std::string::npos) value = value.substr(0, slash);
      hdr->cards.emplace_back(key, value);
    }
  }
  return false;
}

size_t data_size(const Header& hdr) {
  int64_t bitpix = hdr.get_long("BITPIX", 8);
  int64_t naxis = hdr.get_long("NAXIS", 0);
  if (naxis == 0) return 0;
  size_t size = static_cast<size_t>(std::llabs(bitpix)) / 8;
  for (int64_t i = 1; i <= naxis; i++) {
    char key[32];
    std::snprintf(key, sizeof key, "NAXIS%lld", static_cast<long long>(i));
    size *= static_cast<size_t>(hdr.get_long(key, 0));
  }
  size *= static_cast<size_t>(hdr.get_long("GCOUNT", 1));
  size += static_cast<size_t>(hdr.get_long("PCOUNT", 0)) *
          (static_cast<size_t>(std::llabs(bitpix)) / 8);
  return size;
}

inline uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline float bef32(const unsigned char* p) {
  uint32_t v = be32(p);
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}

// Load one speclite file. Returns pixel count, or <0 on error.
int read_one(const char* path, int max_pixels, double* wavelengths,
             double* flux, double* noise_variance, uint8_t* pixel_mask) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return -1;
  std::vector<char> buf((std::istreambuf_iterator<char>(in)),
                        std::istreambuf_iterator<char>());
  if (buf.size() < 2 * kBlock) return -2;

  size_t off = 0;
  Header hdr;
  if (!read_header(buf, &off, &hdr)) return -3;  // primary
  size_t dsize = data_size(hdr);
  off += (dsize + kBlock - 1) / kBlock * kBlock;

  // first extension must be the COADD BINTABLE
  if (!read_header(buf, &off, &hdr)) return -4;
  if (hdr.get_str("XTENSION") != "BINTABLE") return -5;
  int64_t row_bytes = hdr.get_long("NAXIS1", 0);
  int64_t nrows = hdr.get_long("NAXIS2", 0);
  int64_t tfields = hdr.get_long("TFIELDS", 0);
  // nrows == 0 is a VALID empty table (parity with the numpy reader,
  // which returns empty arrays and lets the preloader filter the
  // quasar gracefully); only malformed headers are parse failures
  if (row_bytes <= 0 || nrows < 0 || tfields <= 0) return -6;
  // reject sizes whose product could wrap size_t (crafted NAXIS cards
  // would otherwise bypass the bounds check below and read far past
  // the file buffer); generous caps, far above any real speclite file.
  // TFIELDS is capped too: an uncapped value sizes the column vector,
  // and a bad_alloc escaping a worker thread would std::terminate the
  // whole host process on a single corrupt file.
  if (row_bytes > (int64_t{1} << 24) || nrows > (int64_t{1} << 32) ||
      tfields > 4096)
    return -6;

  std::vector<Column> cols(static_cast<size_t>(tfields));
  size_t col_off = 0;
  for (long i = 0; i < tfields; i++) {
    char key[32];
    std::snprintf(key, sizeof key, "TTYPE%ld", i + 1);
    cols[i].name = hdr.get_str(key);
    std::snprintf(key, sizeof key, "TFORM%ld", i + 1);
    std::string tform = hdr.get_str(key);
    size_t j = 0;
    while (j < tform.size() &&
           std::isdigit(static_cast<unsigned char>(tform[j]))) j++;
    // strtoll, not atoi: atoi is undefined behavior on overflow, and
    // the repeat count comes straight from an untrusted header card.
    // Anything that can't be a real speclite repeat is a parse error
    // (the col_off == row_bytes check below would reject it anyway,
    // but only after well-defined arithmetic).
    int64_t repeat = j ? std::strtoll(tform.substr(0, j).c_str(), nullptr, 10)
                       : 1;
    if (repeat < 0 || repeat > (int64_t{1} << 24)) return -7;
    cols[i].repeat = static_cast<int>(repeat);
    cols[i].code = j < tform.size() ? tform[j] : 0;
    cols[i].offset = col_off;
    cols[i].size = type_size(cols[i].code) * cols[i].repeat;
    col_off += cols[i].size;
  }
  if (static_cast<long>(col_off) != row_bytes) return -7;

  const Column* c_flux = nullptr;
  const Column* c_loglam = nullptr;
  const Column* c_ivar = nullptr;
  const Column* c_andmask = nullptr;
  for (const auto& c : cols) {
    if (c.name == "FLUX" || c.name == "flux") c_flux = &c;
    else if (c.name == "LOGLAM" || c.name == "loglam") c_loglam = &c;
    else if (c.name == "IVAR" || c.name == "ivar") c_ivar = &c;
    else if (c.name == "AND_MASK" || c.name == "and_mask") c_andmask = &c;
  }
  if (!c_flux || !c_loglam || !c_ivar || !c_andmask) return -8;
  if (c_flux->code != 'E' || c_loglam->code != 'E' || c_ivar->code != 'E' ||
      c_andmask->code != 'J')
    return -9;

  int64_t n = std::min<int64_t>(nrows, max_pixels);
  // row_bytes <= 2^24 and nrows <= 2^32 (checked above), so the
  // product fits in 64 bits without wrapping
  if (off > buf.size() ||
      static_cast<size_t>(row_bytes) * static_cast<size_t>(nrows) >
          buf.size() - off)
    return -10;
  const unsigned char* data =
      reinterpret_cast<const unsigned char*>(buf.data()) + off;
  for (int64_t r = 0; r < n; r++) {
    const unsigned char* row = data + static_cast<size_t>(r) * row_bytes;
    float fl = bef32(row + c_flux->offset);
    float ll = bef32(row + c_loglam->offset);
    float iv = bef32(row + c_ivar->offset);
    int32_t am = static_cast<int32_t>(be32(row + c_andmask->offset));
    flux[r] = fl;
    wavelengths[r] = std::pow(10.0, static_cast<double>(ll));
    noise_variance[r] =
        iv == 0.0f ? std::numeric_limits<double>::infinity() : 1.0 / iv;
    pixel_mask[r] =
        (iv == 0.0f) || (((am >> kBrightSkyBit) & 1) != 0) ? 1 : 0;
  }
  return static_cast<int>(n);
}

}  // namespace

extern "C" {

int gpdla_read_spec_batch(const char** paths, int n_files, int max_pixels,
                          int n_threads, double* wavelengths, double* flux,
                          double* noise_variance, uint8_t* pixel_mask,
                          int* lengths) {
  if (n_threads <= 0)
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 4;

  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files) return;
      size_t row = static_cast<size_t>(i) * max_pixels;
      int n;
      try {
        n = read_one(paths[i], max_pixels, wavelengths + row, flux + row,
                     noise_variance + row, pixel_mask + row);
      } catch (const std::exception&) {
        // e.g. bad_alloc buffering a pathologically large file: an
        // exception escaping a worker thread would std::terminate the
        // host process — a corrupt input must only fail its own slot
        n = -11;
      }
      lengths[i] = n;
      if (n < 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  int nt = std::min(n_threads, n_files > 0 ? n_files : 1);
  pool.reserve(nt);
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

const char* gpdla_version() { return "gpdla_io 0.1.0"; }

}  // extern "C"
