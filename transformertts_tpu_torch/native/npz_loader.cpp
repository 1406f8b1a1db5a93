// Threaded batch reader for preprocessed utterances: the .npz files that
// numpy's np.savez writes (a ZIP archive of STORED .npy members).
//
// Each row of a batch reads one file with a single fread, finds its
// `sequence.npy` and `melspec.npy` members in one pass over the ZIP central
// directory, and writes straight into the caller's buffers:
//   - `sequence` (1-D int32 or int64) into phoneme_out[row, :bp], clipped at
//     bp and zero-padded;
//   - `melspec` (float32 (n_mels, T), C order) transposed into
//     mel_out[row, :bm, :n_mels], clipped at bm and zero-padded;
//   - the clipped lengths into p_lens[row] and m_lens[row].
// Rows are strided over n_threads std::threads.  No Python object is
// touched: the bindings call through ctypes.CDLL, which releases the GIL.
//
// C ABI (native/bindings.py):
//   ds_open(paths, n)  -> handle
//   ds_close(handle)
//   ds_load_batch(handle, indices, n, bp, bm, n_mels, phoneme_out, mel_out,
//                 p_lens, m_lens, n_threads, errors)
// errors[row] is 0 or a ReadError code; a failed row is all zeros with
// lengths 0.  The codes and their reasons are listed again in
// bindings.py:ERRORS: change both together.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

enum ReadError : int32_t {
  kOk = 0,
  kOpen = 1,          // the file cannot be opened or read
  kNotZip = 2,        // no ZIP end record, or a damaged or zip64 directory
  kMissing = 3,       // no sequence.npy or melspec.npy member
  kDeflated = 4,      // a member is compressed (np.savez_compressed)
  kBadNpy = 5,        // a member's .npy header is damaged or its data overrun it
  kSequenceType = 6,  // sequence is not a 1-D little-endian int32 / int64 array
  kMelType = 7,       // melspec is not a C-order little-endian float32 (n_mels, T)
};

uint32_t rd16(const unsigned char* p) { return (uint32_t)p[0] | ((uint32_t)p[1] << 8); }

uint32_t rd32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// A member's stored bytes inside the file buffer.
struct Span {
  const unsigned char* data = nullptr;
  size_t size = 0;
};

bool read_file(const std::string& path, std::vector<unsigned char>* buf) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  bool ok = fseeko(f, 0, SEEK_END) == 0;
  off_t size = ok ? ftello(f) : -1;
  ok = ok && size >= 0 && fseeko(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize((size_t)size);
    ok = fread(buf->data(), 1, (size_t)size, f) == (size_t)size;
  }
  fclose(f);
  return ok;
}

// Finds both members in one pass over the central directory.  The data
// offset comes from each member's local header, whose extra field differs
// from the central one in numpy's files (a zip64 field there only).
int32_t find_members(const std::vector<unsigned char>& z, Span* seq, Span* mel) {
  const size_t n = z.size();
  if (n < 22) return kNotZip;
  // the end record is the last 22 bytes plus a comment of up to 65,535
  size_t lowest = n > 22 + 65535 ? n - 22 - 65535 : 0;
  size_t eocd = SIZE_MAX;
  for (size_t i = n - 22 + 1; i-- > lowest;) {
    if (rd32(&z[i]) == 0x06054b50u) {
      eocd = i;
      break;
    }
  }
  if (eocd == SIZE_MAX) return kNotZip;
  const uint32_t entries = rd16(&z[eocd + 10]);
  const uint64_t cd_size = rd32(&z[eocd + 12]), cd_off = rd32(&z[eocd + 16]);
  if (cd_off + cd_size > eocd) return kNotZip;

  Span* want[2] = {seq, mel};
  const char* names[2] = {"sequence.npy", "melspec.npy"};
  bool found[2] = {false, false};
  size_t p = (size_t)cd_off;
  const size_t end = (size_t)(cd_off + cd_size);
  for (uint32_t e = 0; e < entries; ++e) {
    if (p + 46 > end || rd32(&z[p]) != 0x02014b50u) return kNotZip;
    const unsigned char* h = &z[p];
    const uint32_t method = rd16(h + 10);
    const uint64_t csize = rd32(h + 20), usize = rd32(h + 24);
    const uint32_t name_len = rd16(h + 28), extra_len = rd16(h + 30), comment_len = rd16(h + 32);
    const uint64_t local = rd32(h + 42);
    if (p + 46 + name_len > end) return kNotZip;
    const std::string name(reinterpret_cast<const char*>(h + 46), name_len);
    p += 46 + (size_t)name_len + extra_len + comment_len;
    for (int k = 0; k < 2; ++k) {
      if (found[k] || name != names[k]) continue;
      if (method != 0) return kDeflated;
      if (csize == 0xffffffffu || local == 0xffffffffu || csize != usize) return kNotZip;
      if (local + 30 > n || rd32(&z[local]) != 0x04034b50u) return kNotZip;
      const uint64_t data = local + 30 + rd16(&z[local + 26]) + rd16(&z[local + 28]);
      if (data + csize > n) return kNotZip;
      want[k]->data = &z[data];
      want[k]->size = (size_t)csize;
      found[k] = true;
    }
  }
  return found[0] && found[1] ? kOk : kMissing;
}

struct Npy {
  char byte_order = 0;  // '<', '>', '|' or '='
  char kind = 0;        // 'i', 'f', ...
  int itemsize = 0;
  bool fortran = false;
  std::vector<uint64_t> shape;
  const unsigned char* data = nullptr;
};

// The value text after `'key':` in a .npy header dict, or nullptr.
const char* header_value(const std::string& header, const char* key) {
  size_t k = header.find(key);
  if (k == std::string::npos) return nullptr;
  size_t colon = header.find(':', k);
  if (colon == std::string::npos) return nullptr;
  const char* v = header.c_str() + colon + 1;
  while (*v == ' ') ++v;
  return v;
}

int32_t parse_npy(const Span& m, Npy* out) {
  if (m.size < 10 || memcmp(m.data, "\x93NUMPY", 6) != 0) return kBadNpy;
  const int major = m.data[6];
  size_t pre, header_len;
  if (major == 1) {
    pre = 10;
    header_len = rd16(m.data + 8);
  } else if (major == 2 || major == 3) {
    if (m.size < 12) return kBadNpy;
    pre = 12;
    header_len = rd32(m.data + 8);
  } else {
    return kBadNpy;
  }
  if (pre + header_len > m.size) return kBadNpy;
  const std::string header(reinterpret_cast<const char*>(m.data + pre), header_len);

  const char* descr = header_value(header, "'descr'");
  if (!descr || *descr != '\'') return kBadNpy;
  out->byte_order = descr[1];
  out->kind = descr[2];
  out->itemsize = atoi(descr + 3);
  const char* fortran = header_value(header, "'fortran_order'");
  if (!fortran) return kBadNpy;
  out->fortran = strncmp(fortran, "True", 4) == 0;
  const char* shape = header_value(header, "'shape'");
  if (!shape || *shape != '(') return kBadNpy;
  out->shape.clear();
  const char* s = shape + 1;
  while (true) {
    while (*s == ' ' || *s == ',') ++s;
    if (*s == ')') break;
    char* next;
    const unsigned long long d = strtoull(s, &next, 10);
    if (next == s) return kBadNpy;
    out->shape.push_back(d);
    s = next;
  }

  uint64_t count = 1;
  for (uint64_t d : out->shape) count *= d;
  if (out->itemsize <= 0 || count * (uint64_t)out->itemsize > m.size - pre - header_len)
    return kBadNpy;
  out->data = m.data + pre + header_len;
  return kOk;
}

bool little_endian(const Npy& a) { return a.byte_order == '<' || a.byte_order == '='; }

struct Dataset {
  std::vector<std::string> paths;
};

struct Batch {
  int bp, bm, n_mels;
  int32_t* phoneme;
  float* mel;
  int32_t* p_lens;
  int32_t* m_lens;
};

// Reads one utterance into row `row`; `buf` is the calling thread's file buffer.
int32_t load_one(const std::string& path, int row, const Batch& b,
                 std::vector<unsigned char>* buf) {
  int32_t* prow = b.phoneme + (size_t)row * b.bp;
  float* mrow = b.mel + (size_t)row * b.bm * b.n_mels;
  b.p_lens[row] = 0;
  b.m_lens[row] = 0;
  if (!read_file(path, buf)) return kOpen;
  Span seq_m, mel_m;
  Npy seq, mel;
  int32_t err = find_members(*buf, &seq_m, &mel_m);
  if (!err) err = parse_npy(seq_m, &seq);
  if (!err) err = parse_npy(mel_m, &mel);
  if (!err && !(seq.kind == 'i' && (seq.itemsize == 4 || seq.itemsize == 8) &&
                little_endian(seq) && seq.shape.size() == 1))
    err = kSequenceType;
  if (!err && !(mel.kind == 'f' && mel.itemsize == 4 && little_endian(mel) && !mel.fortran &&
                mel.shape.size() == 2 && mel.shape[0] == (uint64_t)b.n_mels))
    err = kMelType;
  if (err) return err;

  const size_t p_len = seq.shape[0] < (uint64_t)b.bp ? (size_t)seq.shape[0] : (size_t)b.bp;
  if (seq.itemsize == 4) {
    memcpy(prow, seq.data, 4 * p_len);
  } else {
    for (size_t i = 0; i < p_len; ++i) {
      int64_t v;
      memcpy(&v, seq.data + 8 * i, 8);
      prow[i] = (int32_t)v;
    }
  }
  memset(prow + p_len, 0, 4 * ((size_t)b.bp - p_len));

  // (n_mels, T) -> (T, n_mels); the member's data need not be 4-byte aligned
  const size_t t_len = (size_t)mel.shape[1], n_mels = (size_t)b.n_mels;
  const size_t t_clip = t_len < (size_t)b.bm ? t_len : (size_t)b.bm;
  for (size_t t = 0; t < t_clip; ++t)
    for (size_t m = 0; m < n_mels; ++m)
      memcpy(&mrow[t * n_mels + m], mel.data + 4 * (m * t_len + t), 4);
  memset(mrow + t_clip * n_mels, 0, 4 * ((size_t)b.bm - t_clip) * n_mels);

  b.p_lens[row] = (int32_t)p_len;
  b.m_lens[row] = (int32_t)t_clip;
  return kOk;
}

}  // namespace

extern "C" {

void* ds_open(const char** paths, int n_files) {
  Dataset* ds = new Dataset();
  ds->paths.reserve(n_files);
  for (int i = 0; i < n_files; ++i) ds->paths.emplace_back(paths[i]);
  return ds;
}

void ds_close(void* handle) { delete static_cast<Dataset*>(handle); }

void ds_load_batch(void* handle, const int32_t* indices, int n, int bp, int bm, int n_mels,
                   int32_t* phoneme_out, float* mel_out, int32_t* p_lens, int32_t* m_lens,
                   int n_threads, int32_t* errors) {
  const Dataset* ds = static_cast<const Dataset*>(handle);
  const Batch b{bp, bm, n_mels, phoneme_out, mel_out, p_lens, m_lens};
  auto rows = [&](int first, int stride) {
    std::vector<unsigned char> buf;
    for (int row = first; row < n; row += stride) {
      errors[row] = load_one(ds->paths[indices[row]], row, b, &buf);
      if (errors[row]) {  // a failed row reads as all zeros
        memset(phoneme_out + (size_t)row * bp, 0, 4 * (size_t)bp);
        memset(mel_out + (size_t)row * bm * n_mels, 0, 4 * (size_t)bm * n_mels);
      }
    }
  };
  if (n_threads > n) n_threads = n;
  if (n_threads <= 1) {
    rows(0, 1);
    return;
  }
  std::vector<std::thread> workers;
  for (int w = 0; w < n_threads; ++w) workers.emplace_back(rows, w, n_threads);
  for (auto& t : workers) t.join();
}

}  // extern "C"
