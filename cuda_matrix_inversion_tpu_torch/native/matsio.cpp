// Native .mats text parser / writer / batch replication.
//
// TPU-native equivalent of the reference's C host I/O layer:
//   readMatricesFile  (reference src/helper.cu:15-52)  -> matsio_header + matsio_read
//   replicateMatrices (reference src/helper.cu:54-72)  -> matsio_replicate
// The reference parses with fscanf into a column-major block; we parse with
// a single mmap + strtod sweep into the caller's row-major (num*m*n) buffer
// (matrix rows are file lines, so row-major fill preserves the matrices).
//
// Exposed as a C ABI consumed from Python via ctypes (no pybind11 in image).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Whole-file read into a NUL-terminated buffer.  (An earlier mmap version
// was unsafe: strtod/strtoll are unbounded scanners, so a file ending in a
// digit at a page boundary would read past the mapping.  The explicit
// terminator bounds every strto* call.)
struct Mapped {
  std::vector<char> buf;
  const char *data = nullptr;
  size_t size = 0;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char *path) {
  Mapped m;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return m;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return m;
  }
  m.buf.resize(static_cast<size_t>(st.st_size) + 1);
  size_t got = 0;
  while (got < static_cast<size_t>(st.st_size)) {
    ssize_t r = read(fd, m.buf.data() + got, st.st_size - got);
    if (r <= 0) {
      close(fd);
      return m;
    }
    got += static_cast<size_t>(r);
  }
  close(fd);
  m.buf[got] = '\0';
  m.data = m.buf.data();
  m.size = got;
  return m;
}

void unmap(Mapped &m) {
  m.buf.clear();
  m.data = nullptr;
  m.size = 0;
}

// Parse the "num\tm\tn" header; returns offset just past the header line, or 0 on error.
size_t parse_header(const Mapped &m, int64_t *num, int64_t *rows, int64_t *cols) {
  const char *p = m.data;
  const char *end = m.data + m.size;
  char *next = nullptr;
  int64_t vals[3];
  for (int i = 0; i < 3; ++i) {
    errno = 0;
    vals[i] = strtoll(p, &next, 10);
    if (next == p || errno != 0) return 0;
    p = next;
  }
  while (p < end && *p != '\n') ++p;
  if (p >= end) return 0;
  *num = vals[0];
  *rows = vals[1];
  *cols = vals[2];
  return static_cast<size_t>(p - m.data) + 1;
}

}  // namespace

extern "C" {

// Read only the header. Returns 0 on success, -1 on error.
int matsio_header(const char *path, int64_t *num, int64_t *rows, int64_t *cols) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  size_t off = parse_header(m, num, rows, cols);
  unmap(m);
  return off ? 0 : -1;
}

// Parse the full file body into out[count]; count must equal num*rows*cols.
// Returns number of values parsed, or -1 on error.
int64_t matsio_read(const char *path, double *out, int64_t count) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  int64_t num, rows, cols;
  size_t off = parse_header(m, &num, &rows, &cols);
  if (!off || num * rows * cols != count) {
    unmap(m);
    return -1;
  }
  const char *p = m.data + off;
  const char *end = m.data + m.size;
  int64_t i = 0;
  while (i < count && p < end) {
    char *next = nullptr;
    double v = strtod(p, &next);
    if (next == p) {
      // strict parsing, matching the Python fallback's semantics: only
      // whitespace separators may be skipped; any other byte means a
      // malformed file and the caller gets a count mismatch error.
      if (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r') {
        ++p;
        continue;
      }
      break;
    }
    out[i++] = v;
    p = next;
  }
  unmap(m);
  return i;
}

// Write (num, rows, cols) batch as .mats text. precision = significant digits.
// Returns 0 on success.
int matsio_write(const char *path, const double *data, int64_t num, int64_t rows,
                 int64_t cols, int precision) {
  FILE *f = fopen(path, "w");
  if (!f) return -1;
  char fmt[16];
  snprintf(fmt, sizeof(fmt), "%%.%dg", precision);
  fprintf(f, "%lld\t%lld\t%lld\n", (long long)num, (long long)rows, (long long)cols);
  const double *p = data;
  for (int64_t k = 0; k < num * rows; ++k) {
    for (int64_t j = 0; j < cols; ++j) {
      if (j) fputc('\t', f);
      fprintf(f, fmt, p[j]);
    }
    fputc('\n', f);
    p += cols;
  }
  int rc = fclose(f);
  return rc == 0 ? 0 : -1;
}

// Tile src (count doubles) times× into dst (count*times doubles).
void matsio_replicate(const double *src, double *dst, int64_t count, int64_t times) {
  for (int64_t t = 0; t < times; ++t) {
    memcpy(dst + t * count, src, sizeof(double) * count);
  }
}

}  // extern "C"
