// Native CLIP BPE tokenizer.
//
// The reference tokenizes captions with the Python HF tokenizer inside the
// forward pass (models/clip_backbone.py:288-303).  This framework moves
// tokenization to the host pipeline; this C++ implementation removes the
// Python BPE from the hot path (~45k captions per ORBench epoch).
//
// Exact algorithm parity with data/tokenizer.py
// (ClipBPETokenizer) for ASCII text: lowercase + whitespace-clean, the CLIP
// token pattern (contraction suffixes, letter runs, single digits, punct
// runs), GPT-2 byte->unicode mapping, greedy lowest-rank pair merging with
// the </w> end-of-word marker, and a per-word result cache.  Bytes >= 0x80
// are treated as letter-class (approximating \p{L}); the Python path remains
// the source of truth for non-ASCII.
//
// C ABI:
//   void* bpe_create(const char* vocab_tsv, const char* merges_txt);
//   void  bpe_destroy(void* h);
//   int   bpe_encode(void* h, const char* text, int* out, int max_len);
//
// vocab_tsv: lines "token\tid" (prepared by the Python side from vocab.json
// to keep JSON parsing out of C++).

#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <mutex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

// GPT-2/CLIP byte -> unicode mapping, as UTF-8 strings.
std::vector<std::string> ByteEncoder() {
  std::vector<int> bs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<int> cs(bs);
  int n = 0;
  std::vector<bool> present(256, false);
  for (int b : bs) present[b] = true;
  for (int b = 0; b < 256; ++b) {
    if (!present[b]) {
      bs.push_back(b);
      cs.push_back(256 + n);
      ++n;
    }
  }
  auto utf8 = [](int cp) {
    std::string s;
    if (cp < 0x80) {
      s += static_cast<char>(cp);
    } else if (cp < 0x800) {
      s += static_cast<char>(0xC0 | (cp >> 6));
      s += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      s += static_cast<char>(0xE0 | (cp >> 12));
      s += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      s += static_cast<char>(0x80 | (cp & 0x3F));
    }
    return s;
  };
  std::vector<std::string> table(256);
  for (size_t i = 0; i < bs.size(); ++i) table[bs[i]] = utf8(cs[i]);
  return table;
}

class BpeTokenizer {
 public:
  BpeTokenizer(const char* vocab_tsv, const char* merges_txt)
      : byte_enc_(ByteEncoder()) {
    std::ifstream vf(vocab_tsv);
    std::string line;
    while (std::getline(vf, line)) {
      auto tab = line.rfind('\t');
      if (tab == std::string::npos) continue;
      encoder_[line.substr(0, tab)] = std::stoi(line.substr(tab + 1));
    }
    std::ifstream mf(merges_txt);
    int rank = 0;
    while (std::getline(mf, line)) {
      if (line.empty() || line[0] == '#') continue;
      auto sp = line.find(' ');
      if (sp == std::string::npos) continue;
      std::string second = line.substr(sp + 1);
      if (!second.empty() && second.back() == '\r') second.pop_back();
      ranks_[{line.substr(0, sp), second}] = rank++;
    }
  }

  // CLIP regex approximation for raw (already lowercased) text.
  std::vector<std::string> Split(const std::string& text) const {
    std::vector<std::string> out;
    size_t i = 0;
    const size_t n = text.size();
    auto is_letter = [](unsigned char c) {
      return std::isalpha(c) || c >= 0x80;
    };
    while (i < n) {
      unsigned char c = text[i];
      if (std::isspace(c)) {
        ++i;
        continue;
      }
      // contraction suffixes 's 't 're 've 'm 'll 'd
      if (c == '\'' && i + 1 < n) {
        static const char* kSuf[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
        bool matched = false;
        for (const char* s : kSuf) {
          size_t len = std::strlen(s);
          if (text.compare(i, len, s) == 0) {
            out.emplace_back(text.substr(i, len));
            i += len;
            matched = true;
            break;
          }
        }
        if (matched) continue;
      }
      if (is_letter(c)) {
        size_t j = i;
        while (j < n && is_letter(static_cast<unsigned char>(text[j]))) ++j;
        out.emplace_back(text.substr(i, j - i));
        i = j;
      } else if (std::isdigit(c)) {
        out.emplace_back(1, static_cast<char>(c));
        ++i;
      } else {
        size_t j = i;
        while (j < n) {
          unsigned char cj = text[j];
          if (std::isspace(cj) || is_letter(cj) || std::isdigit(cj)) break;
          ++j;
        }
        out.emplace_back(text.substr(i, j - i));
        i = j;
      }
    }
    return out;
  }

  const std::vector<int>& Bpe(const std::string& token) {
    auto it = cache_.find(token);
    if (it != cache_.end()) return it->second;

    std::vector<std::string> word;
    for (unsigned char b : token) word.push_back(byte_enc_[b]);
    if (!word.empty()) word.back() += "</w>";

    while (word.size() > 1) {
      int best_rank = std::numeric_limits<int>::max();
      size_t best_i = 0;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        auto r = ranks_.find({word[i], word[i + 1]});
        if (r != ranks_.end() && r->second < best_rank) {
          best_rank = r->second;
          best_i = i;
        }
      }
      if (best_rank == std::numeric_limits<int>::max()) break;
      // merge ALL occurrences of the best pair, left to right
      const std::string first = word[best_i];
      const std::string second = word[best_i + 1];
      std::vector<std::string> merged;
      size_t i = 0;
      while (i < word.size()) {
        if (i + 1 < word.size() && word[i] == first && word[i + 1] == second) {
          merged.push_back(first + second);
          i += 2;
        } else {
          merged.push_back(word[i]);
          ++i;
        }
      }
      word.swap(merged);
    }

    std::vector<int> ids;
    for (const auto& piece : word) {
      auto e = encoder_.find(piece);
      if (e != encoder_.end()) ids.push_back(e->second);
    }
    auto res = cache_.emplace(token, std::move(ids));
    return res.first->second;
  }

  int Encode(const char* text, int* out, int max_len) {
    std::string lowered(text);
    for (auto& ch : lowered)
      ch = static_cast<char>(std::tolower(static_cast<unsigned char>(ch)));
    int count = 0;
    std::lock_guard<std::mutex> lock(mu_);
    for (const auto& tok : Split(lowered)) {
      for (int id : Bpe(tok)) {
        if (count >= max_len) return count;
        out[count++] = id;
      }
    }
    return count;
  }

 private:
  std::vector<std::string> byte_enc_;
  std::unordered_map<std::string, int> encoder_;
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks_;
  std::unordered_map<std::string, std::vector<int>> cache_;
  std::mutex mu_;
};

}  // namespace

extern "C" {

void* bpe_create(const char* vocab_tsv, const char* merges_txt) {
  try {
    return new BpeTokenizer(vocab_tsv, merges_txt);
  } catch (...) {
    return nullptr;
  }
}

void bpe_destroy(void* h) { delete static_cast<BpeTokenizer*>(h); }

int bpe_encode(void* h, const char* text, int* out, int max_len) {
  if (!h || !text || !out) return -1;
  try {
    return static_cast<BpeTokenizer*>(h)->Encode(text, out, max_len);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
