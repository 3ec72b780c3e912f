// Native tweet ingest for crypto_rec_tpu_torch.
//
// Re-implements, from scratch, the ingest semantics documented in
// crypto_rec_tpu_torch/io/ingest.py (which in turn follows the reference's
// lib/data_structures/tweet.cpp:11-42 and lib/utils.cpp:73-147): tokenize delimiter-separated tweet rows, sum
// lexicon sentiment scores, detect coin mentions among non-lexicon words,
// and emit the flat arrays (tweet->user, tweet score, (tweet, coin) pairs)
// that feed the device-side user-matrix builders.
//
// Exposed to Python through a C ABI consumed with ctypes (io/native.py).
// The Python implementation remains the source of truth; a test asserts
// array-for-array equality between the two.  Lexicon scores are parsed as
// doubles (Python's float()), so the summed totals and the f32 scores are
// bit-identical to the Python path's.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kAlpha = 15.0;  // sentiment normalizer (tweet.cpp:40)

struct IngestResult {
  std::vector<std::string> user_ids;
  std::vector<std::string> tweet_ids;
  std::vector<int32_t> tweet_user;
  std::vector<float> scores;
  std::vector<int32_t> pair_tweet;
  std::vector<int32_t> pair_coin;
  int32_t n_coins = 0;
};

std::vector<std::string> split(const std::string& line, char delim) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t pos = line.find(delim, start);
    if (pos == std::string::npos) {
      out.emplace_back(line.substr(start));
      break;
    }
    out.emplace_back(line.substr(start, pos - start));
    start = pos + 1;
  }
  return out;
}

void strip_cr(std::string* line) {
  if (!line->empty() && line->back() == '\r') line->pop_back();
}

bool load_lexicon(const std::string& path, char delim,
                  std::unordered_map<std::string, double>* lex) {
  std::ifstream f(path);
  if (!f.is_open()) return false;
  std::string line;
  while (std::getline(f, line)) {
    strip_cr(&line);
    auto toks = split(line, delim);
    if (toks.size() < 2) continue;
    try {
      double score = std::stod(toks[1]);
      lex->emplace(toks[0], score);  // first-wins, like unordered_map emplace
    } catch (...) {
      continue;
    }
  }
  return true;
}

bool load_coins(const std::string& path, char delim,
                std::unordered_map<std::string, int32_t>* variation_to_coin,
                int32_t* n_coins) {
  std::ifstream f(path);
  if (!f.is_open()) return false;
  std::string line;
  int32_t coin = 0;
  while (std::getline(f, line)) {
    strip_cr(&line);
    if (line.empty()) continue;
    for (const auto& tok : split(line, delim)) {
      if (tok.empty()) continue;
      variation_to_coin->emplace(tok, coin);  // first coin wins
    }
    ++coin;
  }
  *n_coins = coin;
  return true;
}

}  // namespace

extern "C" {

// Returns an opaque handle (nullptr on I/O failure).  has_header skips the
// "P <value>" metadata line of the tweets file.
void* crt_ingest_run(const char* tweets_path, const char* lexicon_path,
                     const char* coins_path, char delim, int has_header) {
  std::unordered_map<std::string, double> lexicon;
  std::unordered_map<std::string, int32_t> coin_of;
  int32_t n_coins = 0;
  if (!load_lexicon(lexicon_path, delim, &lexicon)) return nullptr;
  if (!load_coins(coins_path, delim, &coin_of, &n_coins)) return nullptr;

  std::ifstream f(tweets_path);
  if (!f.is_open()) return nullptr;

  auto* res = new IngestResult();
  res->n_coins = n_coins;
  std::unordered_map<std::string, int32_t> user_index;
  std::unordered_map<std::string, int32_t> seen_tweets;

  std::string line;
  if (has_header) std::getline(f, line);
  std::vector<char> coin_seen(static_cast<size_t>(n_coins), 0);
  while (std::getline(f, line)) {
    strip_cr(&line);
    if (line.empty()) continue;
    auto toks = split(line, delim);
    if (toks.size() < 2) continue;
    const std::string& uid = toks[0];
    const std::string& tid = toks[1];
    if (seen_tweets.count(tid)) continue;  // duplicate ids: first wins
    int32_t t = static_cast<int32_t>(res->tweet_ids.size());
    seen_tweets.emplace(tid, t);
    res->tweet_ids.push_back(tid);
    auto it = user_index.find(uid);
    int32_t u;
    if (it == user_index.end()) {
      u = static_cast<int32_t>(res->user_ids.size());
      user_index.emplace(uid, u);
      res->user_ids.push_back(uid);
    } else {
      u = it->second;
    }
    res->tweet_user.push_back(u);

    double total = 0.0;
    std::fill(coin_seen.begin(), coin_seen.end(), 0);
    for (size_t i = 2; i < toks.size(); ++i) {
      auto lit = lexicon.find(toks[i]);
      if (lit != lexicon.end()) {
        total += lit->second;  // lexicon words never coin-checked
      } else {
        auto cit = coin_of.find(toks[i]);
        if (cit != coin_of.end()) coin_seen[cit->second] = 1;
      }
    }
    res->scores.push_back(
        static_cast<float>(total / std::sqrt(total * total + kAlpha)));
    for (int32_t c = 0; c < n_coins; ++c) {
      if (coin_seen[c]) {  // ascending coin order, like sorted(set)
        res->pair_tweet.push_back(t);
        res->pair_coin.push_back(c);
      }
    }
  }
  return res;
}

int64_t crt_n_tweets(void* h) { return static_cast<IngestResult*>(h)->tweet_ids.size(); }
int64_t crt_n_users(void* h) { return static_cast<IngestResult*>(h)->user_ids.size(); }
int64_t crt_n_pairs(void* h) { return static_cast<IngestResult*>(h)->pair_tweet.size(); }
int32_t crt_n_coins(void* h) { return static_cast<IngestResult*>(h)->n_coins; }

void crt_fill(void* h, int32_t* tweet_user, float* scores, int32_t* pair_tweet,
              int32_t* pair_coin) {
  auto* r = static_cast<IngestResult*>(h);
  std::memcpy(tweet_user, r->tweet_user.data(), r->tweet_user.size() * 4);
  std::memcpy(scores, r->scores.data(), r->scores.size() * 4);
  std::memcpy(pair_tweet, r->pair_tweet.data(), r->pair_tweet.size() * 4);
  std::memcpy(pair_coin, r->pair_coin.data(), r->pair_coin.size() * 4);
}

// The user (which == 0) or tweet (which == 1) ids joined by '\n', in one
// buffer: ids are tokens of one line, so none holds a newline.  One call
// moves all of them (a call per id cost ~1 us each through ctypes).
static const std::vector<std::string>& ids_of(void* h, int which) {
  auto* r = static_cast<IngestResult*>(h);
  return which == 0 ? r->user_ids : r->tweet_ids;
}
int64_t crt_ids_nbytes(void* h, int which) {
  const auto& ids = ids_of(h, which);
  int64_t n = ids.empty() ? 0 : static_cast<int64_t>(ids.size()) - 1;
  for (const auto& s : ids) n += static_cast<int64_t>(s.size());
  return n;
}
void crt_ids_fill(void* h, int which, char* out) {
  const auto& ids = ids_of(h, which);
  for (size_t i = 0; i < ids.size(); ++i) {
    if (i) *out++ = '\n';
    std::memcpy(out, ids[i].data(), ids[i].size());
    out += ids[i].size();
  }
}
void crt_free(void* h) { delete static_cast<IngestResult*>(h); }

}  // extern "C"
