// Native host runtime for index building.
//
// The reference delegates its native compute to dependencies (hnswlib inside
// ChromaDB, llama.cpp inside Ollama; SURVEY.md §2.2) while its own Python
// tokenize/count loop is a hot spot per batch (streaming_index.py:118-148).
// This module is the framework's native equivalent: tokenization, vocabulary
// interning, and posting staging in C++ behind a C ABI (loaded via ctypes).
//
// Contract (matching rag_uq_tpu_torch.text.tokenize semantics, a copy of
// rag_uq_tpu/native/rag_native.cpp):
//   - input text must already be lowercased (Python str.lower handles full
//     Unicode; done on the Python side at C speed);
//   - tokens split on ASCII whitespace (space, \t, \n, \r, \f, \v). Python's
//     str.split() also splits on rare Unicode spaces; the Python fallback
//     path remains the authority for non-ASCII-whitespace corpora.
//   - ASCII punctuation is stripped from token EDGES (never the interior),
//     and all-punctuation tokens are dropped — the documented deviation from
//     the reference's bare split (text/tokenize.py docstring: a token
//     mentioned sentence-finally could never match its clean query form).
//     Multi-byte UTF-8 sequences contain no ASCII bytes, so the per-byte
//     edge test is safe on Unicode text.
//   - term ids are assigned in first-appearance order, mirroring the Python
//     Vocab, so both sides stay in lockstep.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rag_native.cpp -o librag_native.so

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Ctx {
  // Term storage: deque gives stable addresses so string_view keys into the
  // stored strings remain valid as the vocabulary grows.
  std::deque<std::string> terms;
  std::unordered_map<std::string_view, int32_t> vocab;

  // Staged output of the most recent rag_add_documents call.
  std::vector<int32_t> tids, docs, tfs, doc_lens;
  int32_t first_new_term = 0;

  int32_t intern(std::string_view tok) {
    auto it = vocab.find(tok);
    if (it != vocab.end()) return it->second;
    terms.emplace_back(tok);
    int32_t id = static_cast<int32_t>(terms.size()) - 1;
    vocab.emplace(std::string_view(terms.back()), id);
    return id;
  }
};

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// ASCII byte that is neither a letter nor a digit: stripped from token
// edges (mirrors Python's _EDGE_STRIP; text is pre-lowercased but A-Z is
// accepted anyway for safety).
inline bool is_edge_strip(unsigned char c) {
  return c < 128 && !((c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
                      (c >= 'A' && c <= 'Z'));
}

// Trim stripped bytes from both edges of [tok, end); returns the trimmed
// token (possibly empty).
inline std::string_view trim_token(const char* tok, const char* end) {
  while (tok < end && is_edge_strip(static_cast<unsigned char>(*tok))) ++tok;
  while (end > tok && is_edge_strip(static_cast<unsigned char>(*(end - 1))))
    --end;
  return std::string_view(tok, static_cast<size_t>(end - tok));
}

}  // namespace

extern "C" {

void* rag_ctx_new() { return new Ctx(); }

void rag_ctx_free(void* h) { delete static_cast<Ctx*>(h); }

int64_t rag_vocab_size(void* h) {
  return static_cast<int64_t>(static_cast<Ctx*>(h)->terms.size());
}

// Seed the vocabulary with pre-existing terms (index loaded from disk).
// buf holds concatenated UTF-8 terms; offsets has n+1 entries.
void rag_seed_terms(void* h, const char* buf, const int64_t* offsets,
                    int64_t n) {
  Ctx* ctx = static_cast<Ctx*>(h);
  for (int64_t i = 0; i < n; ++i) {
    ctx->intern(std::string_view(buf + offsets[i],
                                 static_cast<size_t>(offsets[i + 1] - offsets[i])));
  }
}

// Tokenize and count n_docs documents. buf holds concatenated lowercased
// UTF-8 texts; offsets has n_docs+1 entries. Documents get positions
// doc_pos_start, doc_pos_start+1, ... Returns the number of staged postings.
int64_t rag_add_documents(void* h, const char* buf, const int64_t* offsets,
                          int64_t n_docs, int32_t doc_pos_start) {
  Ctx* ctx = static_cast<Ctx*>(h);
  ctx->tids.clear();
  ctx->docs.clear();
  ctx->tfs.clear();
  ctx->doc_lens.clear();
  ctx->doc_lens.reserve(static_cast<size_t>(n_docs));
  ctx->first_new_term = static_cast<int32_t>(ctx->terms.size());

  // Per-doc term counting via (tid -> tf) map, reused across docs.
  std::unordered_map<int32_t, int32_t> counts;

  for (int64_t d = 0; d < n_docs; ++d) {
    const char* p = buf + offsets[d];
    const char* end = buf + offsets[d + 1];
    counts.clear();
    int32_t n_tokens = 0;
    while (p < end) {
      while (p < end && is_space(static_cast<unsigned char>(*p))) ++p;
      const char* tok = p;
      while (p < end && !is_space(static_cast<unsigned char>(*p))) ++p;
      std::string_view t = trim_token(tok, p);
      if (!t.empty()) {
        ++n_tokens;
        int32_t tid = ctx->intern(t);
        ++counts[tid];
      }
    }
    ctx->doc_lens.push_back(n_tokens);
    int32_t pos = doc_pos_start + static_cast<int32_t>(d);
    for (const auto& kv : counts) {
      ctx->tids.push_back(kv.first);
      ctx->docs.push_back(pos);
      ctx->tfs.push_back(kv.second);
    }
  }
  return static_cast<int64_t>(ctx->tids.size());
}

void rag_get_postings(void* h, int32_t* tids, int32_t* docs, int32_t* tfs) {
  Ctx* ctx = static_cast<Ctx*>(h);
  std::memcpy(tids, ctx->tids.data(), ctx->tids.size() * sizeof(int32_t));
  std::memcpy(docs, ctx->docs.data(), ctx->docs.size() * sizeof(int32_t));
  std::memcpy(tfs, ctx->tfs.data(), ctx->tfs.size() * sizeof(int32_t));
}

void rag_get_doc_lens(void* h, int32_t* lens) {
  Ctx* ctx = static_cast<Ctx*>(h);
  std::memcpy(lens, ctx->doc_lens.data(),
              ctx->doc_lens.size() * sizeof(int32_t));
}

// New terms introduced by the last rag_add_documents call, in id order.
int64_t rag_new_terms_count(void* h) {
  Ctx* ctx = static_cast<Ctx*>(h);
  return static_cast<int64_t>(ctx->terms.size()) - ctx->first_new_term;
}

int64_t rag_new_terms_bytes(void* h) {
  Ctx* ctx = static_cast<Ctx*>(h);
  int64_t total = 0;
  for (size_t i = ctx->first_new_term; i < ctx->terms.size(); ++i)
    total += static_cast<int64_t>(ctx->terms[i].size());
  return total;
}

void rag_get_new_terms(void* h, char* buf, int64_t* offsets) {
  Ctx* ctx = static_cast<Ctx*>(h);
  int64_t off = 0;
  int64_t j = 0;
  for (size_t i = ctx->first_new_term; i < ctx->terms.size(); ++i, ++j) {
    offsets[j] = off;
    std::memcpy(buf + off, ctx->terms[i].data(), ctx->terms[i].size());
    off += static_cast<int64_t>(ctx->terms[i].size());
  }
  offsets[j] = off;
}

// Tokenize-only: encode queries against the existing vocabulary (no
// interning). Unknown terms map to -1. Writes up to max_terms ids per doc
// into out (row-major [n_docs, max_terms], pre-filled by caller with -1).
void rag_encode_queries(void* h, const char* buf, const int64_t* offsets,
                        int64_t n_docs, int32_t* out, int32_t max_terms) {
  Ctx* ctx = static_cast<Ctx*>(h);
  for (int64_t d = 0; d < n_docs; ++d) {
    const char* p = buf + offsets[d];
    const char* end = buf + offsets[d + 1];
    int32_t k = 0;
    while (p < end && k < max_terms) {
      while (p < end && is_space(static_cast<unsigned char>(*p))) ++p;
      const char* tok = p;
      while (p < end && !is_space(static_cast<unsigned char>(*p))) ++p;
      std::string_view t = trim_token(tok, p);
      if (!t.empty()) {
        auto it = ctx->vocab.find(t);
        out[d * max_terms + k] = (it == ctx->vocab.end()) ? -1 : it->second;
        ++k;
      }
    }
  }
}

}  // extern "C"
