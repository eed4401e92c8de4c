// Native n-gram language-model scorer (KenLM-equivalent core).
//
// The reference scores CTC beams with KenLM, a C++ backoff n-gram engine,
// through pyctcdecode (reference ssak/infer/transformers_infer.py:272-289).
// This is our own C++ core with the same role: load an ARPA file (the
// interchange format KenLM binaries are compiled from) into id-keyed hash
// tables, answer backoff queries, and serve batched lookups so the Python
// beam loop pays one FFI crossing per step instead of one per candidate.
// Also reads/writes a flat binary image ("%SSAKLM1") for fast reload, the
// counterpart of KenLM's .klm binaries.
//
// C ABI only (used via ctypes from ssak_tpu_torch/decode/native_lm.py, which
// builds it with g++ at first use through ssak_tpu_torch/ops/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <unordered_map>

namespace {

struct Entry {
    float logp;
    float backoff;
};

// key: n-gram of word ids packed as bytes
using NgramKey = std::string;

static NgramKey make_key(const int32_t* ids, int n) {
    return NgramKey(reinterpret_cast<const char*>(ids), sizeof(int32_t) * n);
}

struct Model {
    int order = 0;
    std::unordered_map<std::string, int32_t> vocab;   // word -> id
    std::vector<std::string> words;                   // id -> word
    std::unordered_map<NgramKey, Entry> table;
    int32_t unk_id = -1;
    float unk_logp = -10.0f;

    int32_t word_id(const char* w) {
        auto it = vocab.find(w);
        return it == vocab.end() ? -1 : it->second;
    }

    int32_t intern(const std::string& w) {
        auto it = vocab.find(w);
        if (it != vocab.end()) return it->second;
        int32_t id = (int32_t)words.size();
        vocab.emplace(w, id);
        words.push_back(w);
        return id;
    }

    // log10 P(word | context), KenLM backoff semantics (matches the Python
    // ArpaLM in ssak_tpu_torch/decode/lm.py).
    float score(const int32_t* ctx, int ctx_len, int32_t word) const {
        if (order > 1 && ctx_len > order - 1) {
            ctx += ctx_len - (order - 1);
            ctx_len = order - 1;
        }
        return score_rec(ctx, ctx_len, word);
    }

    float score_rec(const int32_t* ctx, int ctx_len, int32_t word) const {
        if (word >= 0) {
            std::vector<int32_t> ng(ctx, ctx + ctx_len);
            ng.push_back(word);
            auto it = table.find(make_key(ng.data(), (int)ng.size()));
            if (it != table.end()) return it->second.logp;
        }
        if (ctx_len == 0) {
            if (word >= 0) {
                int32_t w1[1] = {word};
                auto it = table.find(make_key(w1, 1));
                if (it != table.end()) return it->second.logp;
            }
            return unk_logp;
        }
        float backoff = 0.0f;
        auto it = table.find(make_key(ctx, ctx_len));
        if (it != table.end()) backoff = it->second.backoff;
        return backoff + score_rec(ctx + 1, ctx_len - 1, word);
    }
};

static char* dup_line(std::string& s) {
    // strip trailing whitespace/CR
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r' || s.back() == ' ' || s.back() == '\t'))
        s.pop_back();
    return s.empty() ? nullptr : &s[0];
}

static bool read_line(FILE* f, std::string& out) {
    out.clear();
    char buf[65536];
    while (fgets(buf, sizeof buf, f)) {
        out += buf;
        if (!out.empty() && out.back() == '\n') return true;
    }
    return !out.empty();
}

static Model* load_arpa(FILE* f) {
    auto* m = new Model();
    std::string line;
    int section = 0;  // 0 = none/data, n = n-grams
    while (read_line(f, line)) {
        dup_line(line);
        if (line.empty()) continue;
        if (line[0] == '\\') {
            if (line == "\\end\\") break;
            if (line == "\\data\\") { section = 0; continue; }
            size_t dash = line.find("-grams:");
            if (dash != std::string::npos) {
                section = atoi(line.c_str() + 1);
                if (section > m->order) m->order = section;
            }
            continue;
        }
        if (section <= 0) continue;
        // logp <tab|space> w1 .. wn [<tab|space> backoff]
        char* save = nullptr;
        char* tok = strtok_r(&line[0], " \t", &save);
        if (!tok) continue;
        char* endp = nullptr;
        float logp = strtof(tok, &endp);
        if (endp == tok) continue;
        std::vector<int32_t> ids;
        ids.reserve(section);
        bool ok = true;
        for (int i = 0; i < section; i++) {
            tok = strtok_r(nullptr, " \t", &save);
            if (!tok) { ok = false; break; }
            ids.push_back(m->intern(tok));
        }
        if (!ok) continue;
        float backoff = 0.0f;
        tok = strtok_r(nullptr, " \t", &save);
        if (tok) backoff = strtof(tok, nullptr);
        m->table[make_key(ids.data(), (int)ids.size())] = Entry{logp, backoff};
    }
    auto it = m->vocab.find("<unk>");
    if (it != m->vocab.end()) {
        m->unk_id = it->second;
        int32_t w1[1] = {m->unk_id};
        auto e = m->table.find(make_key(w1, 1));
        if (e != m->table.end()) m->unk_logp = e->second.logp;
    }
    return m;
}

static const char MAGIC[8] = {'%', 'S', 'S', 'A', 'K', 'L', 'M', '1'};

static bool save_binary(const Model* m, const char* path) {
    FILE* f = fopen(path, "wb");
    if (!f) return false;
    fwrite(MAGIC, 1, 8, f);
    int32_t order = m->order, nwords = (int32_t)m->words.size();
    int64_t nentries = (int64_t)m->table.size();
    fwrite(&order, 4, 1, f);
    fwrite(&nwords, 4, 1, f);
    fwrite(&nentries, 8, 1, f);
    fwrite(&m->unk_logp, 4, 1, f);
    for (const auto& w : m->words) {
        int32_t len = (int32_t)w.size();
        fwrite(&len, 4, 1, f);
        fwrite(w.data(), 1, len, f);
    }
    for (const auto& kv : m->table) {
        int32_t n = (int32_t)(kv.first.size() / sizeof(int32_t));
        fwrite(&n, 4, 1, f);
        fwrite(kv.first.data(), 1, kv.first.size(), f);
        fwrite(&kv.second.logp, 4, 1, f);
        fwrite(&kv.second.backoff, 4, 1, f);
    }
    fclose(f);
    return true;
}

static Model* load_binary(FILE* f) {
    auto* m = new Model();
    int32_t order = 0, nwords = 0;
    int64_t nentries = 0;
    if (fread(&order, 4, 1, f) != 1) { delete m; return nullptr; }
    fread(&nwords, 4, 1, f);
    fread(&nentries, 8, 1, f);
    fread(&m->unk_logp, 4, 1, f);
    m->order = order;
    m->words.reserve(nwords);
    std::vector<char> buf;
    for (int32_t i = 0; i < nwords; i++) {
        int32_t len = 0;
        if (fread(&len, 4, 1, f) != 1 || len < 0 || len > 1 << 20) { delete m; return nullptr; }
        buf.resize(len);
        if (len && fread(buf.data(), 1, len, f) != (size_t)len) { delete m; return nullptr; }
        std::string w(buf.data(), len);
        m->vocab.emplace(w, i);
        m->words.push_back(std::move(w));
    }
    m->table.reserve((size_t)nentries * 2);
    std::vector<int32_t> ids;
    for (int64_t i = 0; i < nentries; i++) {
        int32_t n = 0;
        if (fread(&n, 4, 1, f) != 1 || n <= 0 || n > order) { delete m; return nullptr; }
        ids.resize(n);
        if (fread(ids.data(), 4, n, f) != (size_t)n) { delete m; return nullptr; }
        Entry e;
        if (fread(&e.logp, 4, 1, f) != 1) { delete m; return nullptr; }
        if (fread(&e.backoff, 4, 1, f) != 1) { delete m; return nullptr; }
        m->table[make_key(ids.data(), n)] = e;
    }
    auto it = m->vocab.find("<unk>");
    if (it != m->vocab.end()) m->unk_id = it->second;
    return m;
}

}  // namespace

extern "C" {

void* ngram_load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    char head[8] = {0};
    size_t got = fread(head, 1, 8, f);
    Model* m = nullptr;
    if (got == 8 && memcmp(head, MAGIC, 8) == 0) {
        m = load_binary(f);
    } else {
        rewind(f);
        m = load_arpa(f);
    }
    fclose(f);
    return m;
}

int ngram_save(void* h, const char* path) {
    return save_binary(static_cast<Model*>(h), path) ? 0 : -1;
}

void ngram_free(void* h) { delete static_cast<Model*>(h); }

int ngram_order(void* h) { return static_cast<Model*>(h)->order; }

int64_t ngram_size(void* h) { return (int64_t)static_cast<Model*>(h)->table.size(); }

int ngram_vocab_size(void* h) { return (int)static_cast<Model*>(h)->words.size(); }

// word -> id (-1 if OOV); id -> word via ngram_word (valid until free)
int32_t ngram_word_id(void* h, const char* word) {
    return static_cast<Model*>(h)->word_id(word);
}

const char* ngram_word(void* h, int32_t id) {
    auto* m = static_cast<Model*>(h);
    if (id < 0 || id >= (int32_t)m->words.size()) return nullptr;
    return m->words[id].c_str();
}

// log10 P(word | ctx); word/ctx are ids (-1 = OOV -> <unk>/floor).
float ngram_score_ids(void* h, const int32_t* ctx, int32_t ctx_len, int32_t word) {
    return static_cast<Model*>(h)->score(ctx, ctx_len, word);
}

// Batched: n queries, contexts padded to ctx_width with -1 (leading pads).
// ctxs: (n, ctx_width) row-major; words: (n,); out: (n,).
void ngram_score_batch(void* h, const int32_t* ctxs, int32_t ctx_width,
                       const int32_t* words, int32_t n, float* out) {
    auto* m = static_cast<Model*>(h);
    for (int32_t i = 0; i < n; i++) {
        const int32_t* row = ctxs + (int64_t)i * ctx_width;
        int32_t start = 0;
        while (start < ctx_width && row[start] < 0) start++;
        out[i] = m->score(row + start, ctx_width - start, words[i]);
    }
}

}  // extern "C"
