// Native FASTA/FASTQ reader for the TPU-native MIA framework.
//
// Byte-exact reimplementation of the reference's streaming parsers
// (read_fasta src/io.c:194-281, read_fastq src/io.c:46-167) including their
// quirks: 100-char id / 128-char desc truncation, 256 bp hard cap with
// record skip, uppercasing, qual_sum = sum(ascii-33), and the duplicated
// first description character in fasta records.  Records parse into arena
// blobs ('\0'-separated strings + flat int arrays) so the Python binding
// (mia_tpu.io.native) slurps a whole file with O(1) ctypes calls.
//
// Build: make -C native   (produces libmiaio.so)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMaxIdLen = 100;
constexpr int kMaxDescLen = 128;
constexpr int kMaxSeqLen = 256;

struct Reads {
  std::string ids;    // '\0'-separated
  std::string descs;  // '\0'-separated
  std::string seqs;   // '\0'-separated
  std::string quals;  // '\0'-separated
  std::vector<int64_t> seq_len;
  std::vector<int64_t> qual_sum;
  int64_t count = 0;
};

class Stream {
 public:
  Stream(const char* data, size_t n) : data_(data), n_(n) {}
  int getc() { return pos_ < n_ ? (unsigned char)data_[pos_++] : -1; }
  void ungetc() {
    if (pos_ > 0) --pos_;
  }
  bool eof() const { return pos_ >= n_; }

 private:
  const char* data_;
  size_t n_;
  size_t pos_ = 0;
};

inline bool is_space(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

// Shared id parsing: consume chars until whitespace, truncating at
// kMaxIdLen with the reference's one-extra-consumed-char behaviour.
// Returns the terminating char (whitespace or the 101st id char), or -1.
int parse_id(Stream& s, std::string& out) {
  int i = 0;
  for (;;) {
    int c = s.getc();
    if (c == -1) return -1;
    if (is_space(c)) return c;
    if (i >= kMaxIdLen) return c;
    out.push_back((char)c);
    ++i;
  }
}

bool read_fasta(Stream& s, Reads& r) {
  int c = s.getc();
  if (c == -1 || c != '>') return false;

  std::string id, desc, seq;
  c = parse_id(s, id);
  if (c == -1) return false;

  if (c != '\n') {
    while (c != '\n' && is_space(c)) c = s.getc();
    // reference quirk: ungetc + stale variable duplicates the first char
    int i = 0;
    s.ungetc();
    while (c != '\n' && c != -1 && i < kMaxDescLen) {
      desc.push_back((char)c);
      ++i;
      c = s.getc();
    }
  }

  int n = 0;
  c = s.getc();
  while (c != '>' && c != -1 && n < kMaxSeqLen) {
    if (!is_space(c)) {
      seq.push_back((char)toupper(c));
      ++n;
    }
    c = s.getc();
  }
  if (c == '>') {
    s.ungetc();
  } else if (n == kMaxSeqLen) {
    while (c != '>' && c != -1) c = s.getc();
    if (c == '>') s.ungetc();
    fprintf(stderr, "%s is longer than allowed length: %d\n", id.c_str(),
            kMaxSeqLen);
  }

  r.ids += id;
  r.ids.push_back('\0');
  r.descs += desc;
  r.descs.push_back('\0');
  r.seqs += seq;
  r.seqs.push_back('\0');
  r.quals.push_back('\0');
  r.seq_len.push_back(n);
  r.qual_sum.push_back(0);
  ++r.count;
  return true;
}

bool read_fastq(Stream& s, Reads& r) {
  int c = s.getc();
  if (c == -1) return false;
  if (c != '@') {
    fprintf(stderr,
            "While reading fastq file, saw record not beginning with @\n"
            "Maybe badly formed input? Continuing, anyway...\n");
    return false;
  }

  std::string id, desc, seq, qual;
  c = parse_id(s, id);
  if (c == -1) return false;

  if (c != '\n') {
    while (c != '\n' && is_space(c)) c = s.getc();
    int i = 0;
    while (c != '\n' && c != -1 && i < kMaxDescLen) {
      desc.push_back((char)c);
      ++i;
      c = s.getc();
    }
  }

  int n = 0;
  c = s.getc();
  while (c != '\n' && c != -1 && n < kMaxSeqLen) {
    if (!is_space(c)) {
      seq.push_back((char)toupper(c));
      ++n;
    }
    c = s.getc();
  }
  if (n == kMaxSeqLen) {
    while (c != '\n' && c != -1) c = s.getc();
  }

  int64_t qsum = 0;
  c = s.getc();
  if (c != '+') {
    // reference keeps the record with no quality data (src/io.c:120-124)
    fprintf(stderr, "Problem reading quality line for %s\n", id.c_str());
  } else {
    c = s.getc();
    while (c != '\n' && c != -1) c = s.getc();

    int q = 0;
    c = s.getc();
    while (c != '\n' && c != -1 && q < kMaxSeqLen) {
      if (!is_space(c)) {
        qual.push_back((char)c);
        qsum += c - 33;
        ++q;
      }
      c = s.getc();
    }
    if (q == kMaxSeqLen) {
      while (c != '\n' && c != -1) c = s.getc();
    }
    if (q != n) {
      // reference drops the record AND stops the stream (src/io.c:161-165)
      fprintf(stderr, "%s has unequal sequence and qual line lengths\n",
              id.c_str());
      return false;
    }
  }

  r.qual_sum.push_back(qsum);
  r.ids += id;
  r.ids.push_back('\0');
  r.descs += desc;
  r.descs.push_back('\0');
  r.seqs += seq;
  r.seqs.push_back('\0');
  r.quals += qual;
  r.quals.push_back('\0');
  r.seq_len.push_back(n);
  ++r.count;
  return true;
}

}  // namespace

extern "C" {

// Parse a whole file; returns an opaque handle (nullptr on I/O error).
// format: 0 = fasta, 1 = fastq, -1 = sniff by first byte.
void* mia_parse_reads(const char* path, int format) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(n, '\0');
  if (n > 0 && fread(&buf[0], 1, n, f) != (size_t)n) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  if (format < 0) format = (n > 0 && buf[0] == '@') ? 1 : 0;
  auto* r = new Reads();
  Stream s(buf.data(), buf.size());
  for (;;) {
    bool ok = format ? read_fastq(s, *r) : read_fasta(s, *r);
    if (!ok) break;
  }
  return r;
}

int64_t mia_reads_count(void* h) { return static_cast<Reads*>(h)->count; }

// Blob accessors: pointer + total length of the '\0'-separated arenas.
const char* mia_reads_ids(void* h, int64_t* len) {
  auto* r = static_cast<Reads*>(h);
  *len = (int64_t)r->ids.size();
  return r->ids.data();
}
const char* mia_reads_descs(void* h, int64_t* len) {
  auto* r = static_cast<Reads*>(h);
  *len = (int64_t)r->descs.size();
  return r->descs.data();
}
const char* mia_reads_seqs(void* h, int64_t* len) {
  auto* r = static_cast<Reads*>(h);
  *len = (int64_t)r->seqs.size();
  return r->seqs.data();
}
const char* mia_reads_quals(void* h, int64_t* len) {
  auto* r = static_cast<Reads*>(h);
  *len = (int64_t)r->quals.size();
  return r->quals.data();
}
const int64_t* mia_reads_seq_lens(void* h) {
  return static_cast<Reads*>(h)->seq_len.data();
}
const int64_t* mia_reads_qual_sums(void* h) {
  return static_cast<Reads*>(h)->qual_sum.data();
}
void mia_reads_free(void* h) { delete static_cast<Reads*>(h); }

}  // extern "C"
