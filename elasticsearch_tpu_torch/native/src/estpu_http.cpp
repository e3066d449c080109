// Native HTTP serving front of the PyTorch/CUDA port: the port's own copy
// of the reference package's native/src/estpu_http.cpp, changed only where
// the port needs a hook:
//
//   - es_fast_wake (new): ends a waiting es_fast_poll at once, so the drain
//     thread, which also serves requests queued from Python
//     (search/fastpath.py FastPathServer.submit), never waits out the
//     poll's timeout while such a request is queued;
//   - es_loadgen takes one more out-parameter, the count of responses
//     whose status was not 2xx, so a load run can tell answers from
//     errors.
//
// Everything else is as the reference has it. The netty-style serving
// front (ref: Netty4HttpServerTransport.java, an epoll event loop off the
// application threads) re-homes the per-request serving work in C++:
//
//   - an epoll event loop owns accept/read/parse/write (no GIL),
//   - hot _search bodies (match / bool+filter shapes) are parsed, their
//     query text tokenized (estpu_tokenize.h, the same tokens as the
//     port's standard analyzer on ASCII text) and term ids resolved in
//     C++; Python only ever sees per-COHORT batches of term-id arrays via
//     es_fast_poll,
//   - responses for the hot path are serialized in C++ from (docid, score)
//     arrays (es_fast_respond); Python never builds per-hit dicts,
//   - everything else falls back to Python threads via
//     es_fallback_next/es_respond.
//
// A C++ load generator (es_loadgen) lives here too: a Python client pool
// competes with the server for the GIL and measures itself, not the
// server.
//
// MAX_TERMS and MAX_FILTERS below must equal search/fastpath.py's.
//
// Build: g++ -O2 -shared -fPIC -pthread -std=c++17 (rest/native_http.py
// does it at first use).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "estpu_tokenize.h"

namespace {

// ---------------------------------------------------------------- limits
constexpr int MAX_TERMS = 16;       // per fast-path query
constexpr int MAX_FILTERS = 8;      // per fast-path query
constexpr size_t MAX_BODY = 100u << 20;
constexpr size_t MAX_HEADER = 64u << 10;
constexpr size_t FAST_BODY_MAX = 8192;  // bigger hot bodies -> fallback

// ---------------------------------------------------------------- helpers
int set_nonblock(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    return fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

bool ieq(const char* a, const char* b, size_t n) {
    for (size_t i = 0; i < n; i++) {
        char x = a[i], y = b[i];
        if (x >= 'A' && x <= 'Z') x += 32;
        if (y >= 'A' && y <= 'Z') y += 32;
        if (x != y) return false;
    }
    return true;
}

// ------------------------------------------------------------- mini JSON
// Fixed-arena JSON parser for hot-path bodies. Small and strict: arrays/
// objects index into a node pool; anything exceeding the pool (or any
// parse error) rejects the fast path and the body goes to Python intact.
struct JNode {
    enum Type { NUL, BOOL, NUM, STR, ARR, OBJ } type = NUL;
    bool bval = false;
    double num = 0;
    const char* s = nullptr;   // STR: unescaped? (we reject escapes)
    int slen = 0;
    int child = -1;            // ARR/OBJ: first child index
    int nchild = 0;
    const char* key = nullptr; // when a member of an OBJ
    int klen = 0;
    int next = -1;             // sibling link
};

struct JParser {
    const char* p;
    const char* end;
    JNode pool[96];
    int used = 0;

    explicit JParser(const char* s, size_t n) : p(s), end(s + n) {}

    int alloc() { return used < 96 ? used++ : -1; }
    void ws() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++; }

    // returns node index or -1
    int value() {
        ws();
        if (p >= end) return -1;
        char c = *p;
        if (c == '{') return object();
        if (c == '[') return array();
        if (c == '"') return string_node();
        if (c == 't' || c == 'f') return boolean();
        if (c == 'n') {
            if (end - p >= 4 && !memcmp(p, "null", 4)) {
                int id = alloc(); if (id < 0) return -1;
                pool[id].type = JNode::NUL; p += 4; return id;
            }
            return -1;
        }
        return number();
    }

    int boolean() {
        int id = alloc(); if (id < 0) return -1;
        pool[id].type = JNode::BOOL;
        if (end - p >= 4 && !memcmp(p, "true", 4)) { pool[id].bval = true; p += 4; return id; }
        if (end - p >= 5 && !memcmp(p, "false", 5)) { pool[id].bval = false; p += 5; return id; }
        return -1;
    }

    int number() {
        const char* s = p;
        if (p < end && (*p == '-' || *p == '+')) p++;
        bool any = false;
        while (p < end && ((*p >= '0' && *p <= '9') || *p == '.' ||
                           *p == 'e' || *p == 'E' || *p == '-' || *p == '+')) {
            any = true; p++;
        }
        if (!any) return -1;
        int id = alloc(); if (id < 0) return -1;
        pool[id].type = JNode::NUM;
        pool[id].num = strtod(std::string(s, p - s).c_str(), nullptr);
        return id;
    }

    // strings with escapes are rejected (fast-path bodies don't need them;
    // Python handles the rest)
    int string_node() {
        p++;  // opening quote
        const char* s = p;
        while (p < end && *p != '"') {
            if (*p == '\\') return -1;
            p++;
        }
        if (p >= end) return -1;
        int id = alloc(); if (id < 0) return -1;
        pool[id].type = JNode::STR;
        pool[id].s = s;
        pool[id].slen = (int)(p - s);
        p++;  // closing quote
        return id;
    }

    int array() {
        p++;  // [
        int id = alloc(); if (id < 0) return -1;
        pool[id].type = JNode::ARR;
        ws();
        if (p < end && *p == ']') { p++; return id; }
        int prev = -1;
        for (;;) {
            int v = value();
            if (v < 0) return -1;
            if (prev < 0) pool[id].child = v; else pool[prev].next = v;
            prev = v;
            pool[id].nchild++;
            ws();
            if (p >= end) return -1;
            if (*p == ',') { p++; continue; }
            if (*p == ']') { p++; return id; }
            return -1;
        }
    }

    int object() {
        p++;  // {
        int id = alloc(); if (id < 0) return -1;
        pool[id].type = JNode::OBJ;
        ws();
        if (p < end && *p == '}') { p++; return id; }
        int prev = -1;
        for (;;) {
            ws();
            if (p >= end || *p != '"') return -1;
            p++;
            const char* ks = p;
            while (p < end && *p != '"') {
                if (*p == '\\') return -1;
                p++;
            }
            if (p >= end) return -1;
            int klen = (int)(p - ks);
            p++;
            ws();
            if (p >= end || *p != ':') return -1;
            p++;
            int v = value();
            if (v < 0) return -1;
            pool[v].key = ks;
            pool[v].klen = klen;
            if (prev < 0) pool[id].child = v; else pool[prev].next = v;
            prev = v;
            pool[id].nchild++;
            ws();
            if (p >= end) return -1;
            if (*p == ',') { p++; continue; }
            if (*p == '}') { p++; return id; }
            return -1;
        }
    }

    const JNode* get(int id) const { return id >= 0 ? &pool[id] : nullptr; }
    const JNode* member(const JNode* obj, const char* key) const {
        if (!obj || obj->type != JNode::OBJ) return nullptr;
        size_t kl = strlen(key);
        for (int c = obj->child; c >= 0; c = pool[c].next)
            if ((size_t)pool[c].klen == kl && !memcmp(pool[c].key, key, kl))
                return &pool[c];
        return nullptr;
    }
};

// ------------------------------------------------------------ fast state
struct FastIndex {
    int32_t gen = 0;   // registration generation: the Python drain must
                       // drop/bounce requests parsed under an older
                       // term dictionary (segment changed under them)
    std::string index;
    std::string field;
    std::unordered_map<std::string, int32_t> term_ids;
    std::vector<int64_t> id_offs;   // ndocs+1 offsets into ids_blob
    std::string ids_blob;
    int32_t max_k = 1000;
    int32_t default_k = 10;
};

struct FastReq {
    uint64_t token;
    int32_t gen;
    int32_t k;
    int32_t from;
    int32_t n_terms;
    int32_t term_ids[MAX_TERMS];
    int32_t n_filters;
    int32_t filter_tids[MAX_FILTERS];
};

// -------------------------------------------------------------- requests
struct Pending {
    uint64_t conn_id;
    std::string method;
    std::string path;     // includes query string
    std::string headers;  // raw header block (after the request line)
    std::string body;
    bool fast = false;
};

struct Conn {
    int fd = -1;
    uint64_t id = 0;
    std::string rbuf;
    std::string wbuf;
    size_t woff = 0;
    bool want_close = false;
    bool in_flight = false;   // one request at a time per conn
    // parse state
    size_t header_end = 0;
    size_t content_len = 0;
    bool headers_done = false;
    size_t body_start = 0;
};

struct Server {
    int listen_fd = -1;
    int epfd = -1;
    int wake_fd = -1;
    int port = 0;
    std::thread io_thread;
    std::atomic<bool> stop{false};

    std::mutex conn_mu;
    std::unordered_map<uint64_t, Conn*> conns;  // by conn id
    uint64_t next_conn = 1;
    uint64_t next_token = 1;

    std::mutex pending_mu;
    std::unordered_map<uint64_t, Pending> pending;

    // queues
    std::mutex fast_mu;
    std::condition_variable fast_cv;
    std::deque<FastReq> fast_q;
    bool fast_kick = false;   // es_fast_wake: end the current poll now

    std::mutex fb_mu;
    std::condition_variable fb_cv;
    std::deque<uint64_t> fb_q;    // tokens into `pending`

    std::mutex out_mu;
    std::deque<std::pair<uint64_t, std::string>> out_q;  // token -> raw resp

    // fast config (swapped under mutex; reads take shared snapshot ptr)
    std::mutex fast_cfg_mu;
    std::shared_ptr<FastIndex> fast_cfg;

    // ip filter: allow/deny CIDR lists (v4). checked at accept.
    std::mutex ip_mu;
    std::vector<std::pair<uint32_t, uint32_t>> ip_allow;  // (addr, mask)
    std::vector<std::pair<uint32_t, uint32_t>> ip_deny;

    // stats
    std::atomic<long long> n_requests{0};
    std::atomic<long long> n_fast{0};
    std::atomic<long long> n_fallback{0};
    std::atomic<long long> n_rejected_ip{0};
    std::atomic<long long> open_conns{0};
};


void wake(Server* s) {
    uint64_t one = 1;
    ssize_t r = write(s->wake_fd, &one, 8);
    (void)r;
}

// --------------------------------------------------------- http response
void queue_response(Server* s, uint64_t token, std::string raw) {
    {
        std::lock_guard<std::mutex> lk(s->out_mu);
        s->out_q.emplace_back(token, std::move(raw));
    }
    wake(s);
}

std::string make_http(int status, const char* ctype, const char* body,
                      size_t blen, bool keep_alive) {
    const char* reason = "OK";
    switch (status) {
        case 200: reason = "OK"; break;
        case 201: reason = "Created"; break;
        case 400: reason = "Bad Request"; break;
        case 401: reason = "Unauthorized"; break;
        case 403: reason = "Forbidden"; break;
        case 404: reason = "Not Found"; break;
        case 405: reason = "Method Not Allowed"; break;
        case 409: reason = "Conflict"; break;
        case 411: reason = "Length Required"; break;
        case 413: reason = "Payload Too Large"; break;
        case 429: reason = "Too Many Requests"; break;
        case 500: reason = "Internal Server Error"; break;
        case 503: reason = "Service Unavailable"; break;
        default: reason = "Status"; break;
    }
    char head[256];
    int hl = snprintf(head, sizeof head,
                      "HTTP/1.1 %d %s\r\n"
                      "Content-Type: %s\r\n"
                      "Content-Length: %zu\r\n"
                      "X-elastic-product: Elasticsearch\r\n"
                      "Connection: %s\r\n\r\n",
                      status, reason, ctype, blen,
                      keep_alive ? "keep-alive" : "close");
    std::string out;
    out.reserve(hl + blen);
    out.append(head, hl);
    out.append(body, blen);
    return out;
}

// ------------------------------------------------------ fast-path parse
// Recognized shapes (anything else -> Python):
//   {"query": {"match": {FIELD: "text" | {"query": "text"}}},
//    "size"?: N, "from"?: 0, "_source"?: false, "track_total_hits"?: true}
//   {"query": {"bool": {"must": [match...] | match,
//                       "filter": [{match one-term}...]}}, ...}
bool tokenize_terms(const FastIndex& cfg, const char* text, int tlen,
                    int32_t* out_tids, int32_t* n_out, int max_out) {
    if (tlen > 2048) return false;
    for (int i = 0; i < tlen; i++)
        if ((unsigned char)text[i] >= 128) return false;  // non-ASCII
    int offsets[2 * (MAX_TERMS + MAX_FILTERS + 8)];
    char lowered[2048];
    int n = estpu_tokenize_ascii(text, tlen, 255, offsets,
                                 MAX_TERMS + MAX_FILTERS + 8, lowered);
    if (n < 0 || n > max_out) return false;
    for (int i = 0; i < n; i++) {
        std::string tok(lowered + offsets[2 * i],
                        offsets[2 * i + 1] - offsets[2 * i]);
        auto it = cfg.term_ids.find(tok);
        out_tids[i] = it == cfg.term_ids.end() ? -1 : it->second;
    }
    *n_out = n;
    return true;
}

// extract the analyzed text of a match clause against `field`; nullptr if
// the clause doesn't fit
const JNode* match_text(JParser& jp, const JNode* match_obj,
                        const std::string& field) {
    if (!match_obj || match_obj->type != JNode::OBJ ||
        match_obj->nchild != 1)
        return nullptr;
    const JNode* fv = jp.get(match_obj->child);
    if ((size_t)fv->klen != field.size() ||
        memcmp(fv->key, field.data(), fv->klen))
        return nullptr;
    if (fv->type == JNode::STR) return fv;
    if (fv->type == JNode::OBJ) {
        const JNode* q = jp.member(fv, "query");
        if (q && q->type == JNode::STR && fv->nchild == 1) return q;
    }
    return nullptr;
}

bool parse_fast(Server* s, const std::string& body, FastReq* out) {
    auto cfg_ptr = [&]() {
        std::lock_guard<std::mutex> lk(s->fast_cfg_mu);
        return s->fast_cfg;
    }();
    if (!cfg_ptr || body.size() > FAST_BODY_MAX || body.empty())
        return false;
    const FastIndex& cfg = *cfg_ptr;
    JParser jp(body.data(), body.size());
    int root_id = jp.value();
    jp.ws();
    if (root_id < 0 || jp.p != jp.end) return false;
    const JNode* root = jp.get(root_id);
    if (root->type != JNode::OBJ) return false;

    int k = cfg.default_k, from = 0;
    bool source_off = false;   // default _source:true needs the fetch
                               // phase -> Python path
    const JNode* query = nullptr;
    for (int c = root->child; c >= 0; c = jp.pool[c].next) {
        const JNode* m = &jp.pool[c];
        std::string key(m->key, m->klen);
        if (key == "query") {
            query = m;
        } else if (key == "size") {
            if (m->type != JNode::NUM) return false;
            k = (int)m->num;
            if (k != m->num || k < 1 || k > cfg.max_k) return false;
        } else if (key == "from") {
            if (m->type != JNode::NUM || m->num != 0) return false;
        } else if (key == "_source") {
            if (m->type != JNode::BOOL || m->bval) return false;
            source_off = true;
        } else if (key == "track_total_hits") {
            if (m->type != JNode::BOOL || !m->bval) return false;
        } else {
            return false;
        }
    }
    if (!source_off) return false;
    if (!query || query->type != JNode::OBJ || query->nchild != 1)
        return false;

    const JNode* inner = jp.get(query->child);
    std::string qkind(inner->key, inner->klen);
    out->gen = cfg.gen;
    out->k = k;
    out->from = from;
    out->n_filters = 0;

    if (qkind == "match") {
        const JNode* text = match_text(jp, inner, cfg.field);
        if (!text) return false;
        return tokenize_terms(cfg, text->s, text->slen, out->term_ids,
                              &out->n_terms, MAX_TERMS);
    }
    if (qkind == "bool") {
        if (inner->type != JNode::OBJ) return false;
        const JNode* must = nullptr;
        const JNode* filter = nullptr;
        for (int c = inner->child; c >= 0; c = jp.pool[c].next) {
            const JNode* m = &jp.pool[c];
            std::string key(m->key, m->klen);
            if (key == "must") must = m;
            else if (key == "filter") filter = m;
            else return false;
        }
        // must: one match clause (array-of-one or direct object)
        const JNode* mq = must;
        if (mq && mq->type == JNode::ARR) {
            if (mq->nchild != 1) return false;
            mq = jp.get(mq->child);
        }
        if (!mq || mq->type != JNode::OBJ || mq->nchild != 1) return false;
        const JNode* mi = jp.get(mq->child);
        if (std::string(mi->key, mi->klen) != "match") return false;
        const JNode* text = match_text(jp, mi, cfg.field);
        if (!text) return false;
        if (!tokenize_terms(cfg, text->s, text->slen, out->term_ids,
                            &out->n_terms, MAX_TERMS))
            return false;
        // filters: each a single-term match on the same field
        if (filter) {
            const JNode* farr = filter;
            if (farr->type == JNode::OBJ) {
                // single clause without array wrapper
                int32_t tid1[2]; int32_t n1;
                if (farr->nchild != 1) return false;
                const JNode* fi = jp.get(farr->child);
                if (std::string(fi->key, fi->klen) != "match") return false;
                const JNode* ft = match_text(jp, fi, cfg.field);
                if (!ft) return false;
                if (!tokenize_terms(cfg, ft->s, ft->slen, tid1, &n1, 1))
                    return false;
                if (n1 != 1) return false;
                out->filter_tids[out->n_filters++] = tid1[0];
            } else if (farr->type == JNode::ARR) {
                if (farr->nchild > MAX_FILTERS) return false;
                for (int c = farr->child; c >= 0; c = jp.pool[c].next) {
                    const JNode* fc = &jp.pool[c];
                    if (fc->type != JNode::OBJ || fc->nchild != 1)
                        return false;
                    const JNode* fi = jp.get(fc->child);
                    if (std::string(fi->key, fi->klen) != "match")
                        return false;
                    const JNode* ft = match_text(jp, fi, cfg.field);
                    if (!ft) return false;
                    int32_t tid1[2]; int32_t n1;
                    if (!tokenize_terms(cfg, ft->s, ft->slen, tid1, &n1, 1))
                        return false;
                    if (n1 != 1) return false;
                    out->filter_tids[out->n_filters++] = tid1[0];
                }
            } else {
                return false;
            }
        }
        return true;
    }
    return false;
}

// does `path` look like /{index}/_search for the registered fast index?
bool fast_route(Server* s, const std::string& method,
                const std::string& path, std::string* index_out) {
    if (method != "POST" && method != "GET") return false;
    if (path.find('?') != std::string::npos) return false;
    if (path.size() < 9 || path[0] != '/') return false;
    size_t slash = path.find('/', 1);
    if (slash == std::string::npos) return false;
    if (path.compare(slash, std::string::npos, "/_search") != 0)
        return false;
    std::string index = path.substr(1, slash - 1);
    std::lock_guard<std::mutex> lk(s->fast_cfg_mu);
    if (!s->fast_cfg || s->fast_cfg->index != index) return false;
    *index_out = index;
    return true;
}

// ---------------------------------------------------------- ip filtering
bool parse_cidr(const char* spec, uint32_t* addr, uint32_t* mask) {
    char buf[64];
    strncpy(buf, spec, sizeof buf - 1);
    buf[sizeof buf - 1] = 0;
    int bits = 32;
    char* slash = strchr(buf, '/');
    if (slash) { *slash = 0; bits = atoi(slash + 1); }
    if (bits < 0 || bits > 32) return false;
    struct in_addr a;
    if (inet_pton(AF_INET, buf, &a) != 1) return false;
    *addr = ntohl(a.s_addr);
    *mask = bits == 0 ? 0 : (0xFFFFFFFFu << (32 - bits));
    return true;
}

bool ip_allowed(Server* s, uint32_t addr) {
    std::lock_guard<std::mutex> lk(s->ip_mu);
    // ref: x-pack IPFilter — allow rules win over deny rules; an
    // allow-list by itself implies everything else is DENIED; with no
    // rules everything is permitted
    for (auto& r : s->ip_allow)
        if ((addr & r.second) == (r.first & r.second)) return true;
    for (auto& r : s->ip_deny)
        if ((addr & r.second) == (r.first & r.second)) return false;
    return s->ip_allow.empty();
}

// -------------------------------------------------------------- io loop
void close_conn(Server* s, Conn* c) {
    epoll_ctl(s->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    {
        std::lock_guard<std::mutex> lk(s->conn_mu);
        s->conns.erase(c->id);
    }
    s->open_conns--;
    delete c;
}

void arm(Server* s, Conn* c, bool want_write) {
    epoll_event ev{};
    ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
    ev.data.ptr = c;
    epoll_ctl(s->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// dispatch one complete request sitting in c->rbuf[0:body_start+content_len]
void dispatch_request(Server* s, Conn* c) {
    s->n_requests++;
    // request line
    const char* buf = c->rbuf.data();
    const char* line_end = (const char*)memchr(buf, '\r', c->header_end);
    std::string method, path;
    if (line_end) {
        const char* sp1 = (const char*)memchr(buf, ' ', line_end - buf);
        if (sp1) {
            const char* sp2 = (const char*)memchr(
                sp1 + 1, ' ', line_end - sp1 - 1);
            if (sp2) {
                method.assign(buf, sp1 - buf);
                path.assign(sp1 + 1, sp2 - sp1 - 1);
            }
        }
    }
    uint64_t token;
    {
        std::lock_guard<std::mutex> lk(s->conn_mu);
        token = s->next_token++;
    }
    c->in_flight = true;

    Pending p;
    p.conn_id = c->id;
    p.method = method;
    p.path = path;
    if (line_end) {
        size_t hs = (line_end - buf) + 2;
        if (c->header_end > hs)
            p.headers.assign(c->rbuf, hs, c->header_end - hs);
    }
    p.body.assign(c->rbuf, c->body_start, c->content_len);

    // consume the request bytes (keep any pipelined remainder)
    c->rbuf.erase(0, c->body_start + c->content_len);
    c->headers_done = false;
    c->header_end = 0;
    c->content_len = 0;
    c->body_start = 0;

    std::string index;
    FastReq fr{};
    if (fast_route(s, method, path, &index) &&
        parse_fast(s, p.body, &fr)) {
        fr.token = token;
        p.fast = true;
        {
            std::lock_guard<std::mutex> lk(s->pending_mu);
            s->pending.emplace(token, std::move(p));
        }
        {
            std::lock_guard<std::mutex> lk(s->fast_mu);
            s->fast_q.push_back(fr);
        }
        s->n_fast++;
        s->fast_cv.notify_one();
        return;
    }
    {
        std::lock_guard<std::mutex> lk(s->pending_mu);
        s->pending.emplace(token, std::move(p));
    }
    {
        std::lock_guard<std::mutex> lk(s->fb_mu);
        s->fb_q.push_back(token);
    }
    s->n_fallback++;
    s->fb_cv.notify_one();
}

void handle_readable(Server* s, Conn* c) {
    char tmp[65536];
    for (;;) {
        ssize_t n = read(c->fd, tmp, sizeof tmp);
        if (n > 0) {
            c->rbuf.append(tmp, n);
            if (c->rbuf.size() > MAX_BODY + MAX_HEADER) {
                close_conn(s, c);
                return;
            }
            continue;
        }
        if (n == 0) { close_conn(s, c); return; }
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        close_conn(s, c);
        return;
    }
    // parse as many complete requests as are buffered (one in flight at a
    // time; the next parses after the response goes out)
    while (!c->in_flight) {
        if (!c->headers_done) {
            size_t he = c->rbuf.find("\r\n\r\n");
            if (he == std::string::npos) {
                if (c->rbuf.size() > MAX_HEADER) { close_conn(s, c); }
                return;
            }
            c->header_end = he;
            c->body_start = he + 4;
            c->headers_done = true;
            // scan headers
            c->content_len = 0;
            c->want_close = false;
            size_t pos = c->rbuf.find("\r\n");
            while (pos < he) {
                size_t eol = c->rbuf.find("\r\n", pos + 2);
                if (eol == std::string::npos || eol > he) eol = he;
                const char* h = c->rbuf.data() + pos + 2;
                size_t hl = eol - pos - 2;
                if (hl > 15 && ieq(h, "content-length:", 15)) {
                    c->content_len = strtoull(h + 15, nullptr, 10);
                } else if (hl > 11 && ieq(h, "connection:", 11)) {
                    std::string v(h + 11, hl - 11);
                    for (auto& ch : v) ch = (char)tolower(ch);
                    if (v.find("close") != std::string::npos)
                        c->want_close = true;
                } else if (hl > 18 && ieq(h, "transfer-encoding:", 18)) {
                    // chunked uploads unsupported on the native front
                    static const char kChunkedErr[] =
                        "{\"error\":\"chunked transfer-encoding not "
                        "supported\"}";
                    std::string resp = make_http(
                        411, "application/json", kChunkedErr,
                        sizeof kChunkedErr - 1, false);
                    c->wbuf += resp;
                    c->want_close = true;
                    arm(s, c, true);
                    return;
                } else if (hl > 7 && ieq(h, "expect:", 7)) {
                    const char cont[] = "HTTP/1.1 100 Continue\r\n\r\n";
                    c->wbuf += cont;
                    arm(s, c, true);
                }
                pos = eol;
            }
            if (c->content_len > MAX_BODY) {
                static const char kTooLarge[] =
                    "{\"error\":\"body too large\"}";
                std::string resp = make_http(413, "application/json",
                                             kTooLarge,
                                             sizeof kTooLarge - 1, false);
                c->wbuf += resp;
                c->want_close = true;
                arm(s, c, true);
                return;
            }
        }
        if (c->rbuf.size() < c->body_start + c->content_len) return;
        dispatch_request(s, c);
    }
}

void handle_writable(Server* s, Conn* c) {
    while (c->woff < c->wbuf.size()) {
        ssize_t n = write(c->fd, c->wbuf.data() + c->woff,
                          c->wbuf.size() - c->woff);
        if (n > 0) { c->woff += n; continue; }
        if (errno == EAGAIN || errno == EWOULDBLOCK) { arm(s, c, true); return; }
        close_conn(s, c);
        return;
    }
    c->wbuf.clear();
    c->woff = 0;
    if (c->want_close) { close_conn(s, c); return; }
    arm(s, c, false);
    // a pipelined request may be fully buffered already
    if (!c->in_flight && c->rbuf.size() > 0) handle_readable(s, c);
}

void drain_out(Server* s) {
    std::deque<std::pair<uint64_t, std::string>> q;
    {
        std::lock_guard<std::mutex> lk(s->out_mu);
        q.swap(s->out_q);
    }
    for (auto& item : q) {
        uint64_t conn_id = 0;
        {
            std::lock_guard<std::mutex> lk(s->pending_mu);
            auto it = s->pending.find(item.first);
            if (it == s->pending.end()) continue;
            conn_id = it->second.conn_id;
            s->pending.erase(it);
        }
        Conn* c = nullptr;
        {
            std::lock_guard<std::mutex> lk(s->conn_mu);
            auto it = s->conns.find(conn_id);
            if (it != s->conns.end()) c = it->second;
        }
        if (!c) continue;  // client went away
        c->wbuf += item.second;
        c->in_flight = false;
        handle_writable(s, c);
    }
}

void io_loop(Server* s) {
    epoll_event evs[128];
    while (!s->stop.load()) {
        int n = epoll_wait(s->epfd, evs, 128, 100);
        for (int i = 0; i < n; i++) {
            if (evs[i].data.ptr == nullptr) {
                uint64_t junk;
                ssize_t r = read(s->wake_fd, &junk, 8);
                (void)r;
                drain_out(s);
                continue;
            }
            if (evs[i].data.ptr == (void*)1) {
                // listener
                for (;;) {
                    sockaddr_in addr{};
                    socklen_t alen = sizeof addr;
                    int fd = accept4(s->listen_fd, (sockaddr*)&addr, &alen,
                                     SOCK_NONBLOCK);
                    if (fd < 0) break;
                    if (!ip_allowed(s, ntohl(addr.sin_addr.s_addr))) {
                        // ref: IPFilter rejects at accept time — no HTTP
                        // response, the connection just closes
                        s->n_rejected_ip++;
                        close(fd);
                        continue;
                    }
                    int one = 1;
                    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one,
                               sizeof one);
                    Conn* c = new Conn();
                    c->fd = fd;
                    {
                        std::lock_guard<std::mutex> lk(s->conn_mu);
                        c->id = s->next_conn++;
                        s->conns[c->id] = c;
                    }
                    s->open_conns++;
                    epoll_event ev{};
                    ev.events = EPOLLIN;
                    ev.data.ptr = c;
                    epoll_ctl(s->epfd, EPOLL_CTL_ADD, fd, &ev);
                }
                continue;
            }
            Conn* c = (Conn*)evs[i].data.ptr;
            if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
                close_conn(s, c);
                continue;
            }
            if (evs[i].events & EPOLLOUT) handle_writable(s, c);
            else if (evs[i].events & EPOLLIN) handle_readable(s, c);
        }
        if (n == 0) drain_out(s);  // safety sweep
    }
}

}  // namespace

// =========================================================== public ABI
extern "C" {

// Start a server instance; returns the bound port or -1 and writes an
// opaque handle every other call takes (multiple nodes per process each
// own their front — no singleton).
int es_http_start(int port, int64_t* out_handle) {
    Server* s = new Server();
    s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (s->listen_fd < 0) { delete s; return -1; }
    int one = 1;
    setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(port);
    if (bind(s->listen_fd, (sockaddr*)&addr, sizeof addr) < 0 ||
        listen(s->listen_fd, 1024) < 0) {
        close(s->listen_fd);
        delete s;
        return -1;
    }
    socklen_t alen = sizeof addr;
    getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
    s->port = ntohs(addr.sin_port);
    s->epfd = epoll_create1(0);
    s->wake_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = (void*)1;
    epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->listen_fd, &ev);
    epoll_event wev{};
    wev.events = EPOLLIN;
    wev.data.ptr = nullptr;
    epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->wake_fd, &wev);
    s->io_thread = std::thread(io_loop, s);
    *out_handle = (int64_t)s;
    return s->port;
}

void es_http_stop(int64_t h) {
    Server* s = (Server*)h;
    if (!s) return;
    s->stop.store(true);
    s->fast_cv.notify_all();
    s->fb_cv.notify_all();
    wake(s);
    s->io_thread.join();
    close(s->listen_fd);
    close(s->epfd);
    close(s->wake_fd);
    {
        std::lock_guard<std::mutex> lk(s->conn_mu);
        for (auto& kv : s->conns) {
            close(kv.second->fd);
            delete kv.second;
        }
        s->conns.clear();
    }
    delete s;
}

// Register the fast index: term dictionary + external doc ids.
// terms_blob/term_offs: nterms+1 offsets; ids_blob/id_offs: ndocs+1.
int es_fast_register(int64_t h, int32_t gen, const char* index,
                     const char* field,
                     const char* terms_blob, const int64_t* term_offs,
                     int32_t nterms, const char* ids_blob,
                     const int64_t* id_offs, int32_t ndocs,
                     int32_t default_k, int32_t max_k) {
    Server* s = (Server*)h;
    if (!s) return -1;
    auto cfg = std::make_shared<FastIndex>();
    cfg->gen = gen;
    cfg->index = index;
    cfg->field = field;
    cfg->default_k = default_k;
    cfg->max_k = max_k;
    cfg->term_ids.reserve(nterms * 2);
    for (int32_t i = 0; i < nterms; i++) {
        cfg->term_ids.emplace(
            std::string(terms_blob + term_offs[i],
                        term_offs[i + 1] - term_offs[i]),
            i);
    }
    cfg->ids_blob.assign(ids_blob, id_offs[ndocs]);
    cfg->id_offs.assign(id_offs, id_offs + ndocs + 1);
    {
        std::lock_guard<std::mutex> lk2(s->fast_cfg_mu);
        s->fast_cfg = cfg;
    }
    return 0;
}

void es_fast_unregister(int64_t h) {
    Server* s = (Server*)h;
    if (!s) return;
    std::lock_guard<std::mutex> lk2(s->fast_cfg_mu);
    s->fast_cfg = nullptr;
}

// Drain up to max_n parsed fast requests. Returns count (0 on timeout).
int es_fast_poll(int64_t h, uint64_t* tokens, int32_t* gens,
                 int32_t* ks, int32_t* ntermss,
                 int32_t* term_ids, int32_t* nfilterss,
                 int32_t* filter_tids, int max_n, int timeout_ms) {
    Server* s = (Server*)h;
    if (!s) return 0;
    std::unique_lock<std::mutex> lk(s->fast_mu);
    if (s->fast_q.empty() && !s->fast_kick) {
        s->fast_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                            [s] { return !s->fast_q.empty() || s->fast_kick; });
    }
    s->fast_kick = false;
    int n = 0;
    while (n < max_n && !s->fast_q.empty()) {
        FastReq& fr = s->fast_q.front();
        tokens[n] = fr.token;
        gens[n] = fr.gen;
        ks[n] = fr.k;
        ntermss[n] = fr.n_terms;
        memcpy(term_ids + n * MAX_TERMS, fr.term_ids,
               sizeof(int32_t) * MAX_TERMS);
        nfilterss[n] = fr.n_filters;
        memcpy(filter_tids + n * MAX_FILTERS, fr.filter_tids,
               sizeof(int32_t) * MAX_FILTERS);
        s->fast_q.pop_front();
        n++;
    }
    return n;
}

// Wake the drain thread: a waiting es_fast_poll returns now (with what the
// queue holds, maybe nothing); if none waits, the next one returns at once.
void es_fast_wake(int64_t h) {
    Server* s = (Server*)h;
    if (!s) return;
    {
        std::lock_guard<std::mutex> lk(s->fast_mu);
        s->fast_kick = true;
    }
    s->fast_cv.notify_all();
}

// How many fast requests are waiting (for adaptive cohort waits).
int es_fast_pending(int64_t h) {
    Server* s = (Server*)h;
    if (!s) return 0;
    std::lock_guard<std::mutex> lk(s->fast_mu);
    return (int)s->fast_q.size();
}

// JSON-escape arbitrary bytes into out (doc _ids and index names may
// contain quotes, backslashes, or control characters; the Python
// fallback escapes via json.dumps and the fast path must match it).
static void json_escape_append(std::string& out, const char* s, size_t n) {
    for (size_t i = 0; i < n; i++) {
        unsigned char c = (unsigned char)s[i];
        switch (c) {
            case '"':  out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\b': out += "\\b"; break;
            case '\f': out += "\\f"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if (c < 0x20) {
                    char u[8];
                    snprintf(u, sizeof u, "\\u%04x", c);
                    out += u;
                } else {
                    out += (char)c;
                }
        }
    }
}

// Serialize + send the hot-path response entirely in C++.
int es_fast_respond(int64_t h, uint64_t token, const char* index_name,
                    const int32_t* doc_ids, const float* scores, int n,
                    long long total, const char* total_rel, int took_ms) {
    Server* s = (Server*)h;
    if (!s) return -1;
    auto cfg = [&]() {
        std::lock_guard<std::mutex> lk(s->fast_cfg_mu);
        return s->fast_cfg;
    }();
    std::string body;
    body.reserve(64 + (size_t)n * 48);
    char tmp[256];
    snprintf(tmp, sizeof tmp,
             "{\"took\":%d,\"timed_out\":false,\"_shards\":{\"total\":1,"
             "\"successful\":1,\"skipped\":0,\"failed\":0},\"hits\":{"
             "\"total\":{\"value\":%lld,\"relation\":\"%s\"},",
             took_ms, total, total_rel);
    body += tmp;
    if (n > 0) {
        snprintf(tmp, sizeof tmp, "\"max_score\":%.6g,\"hits\":[",
                 (double)scores[0]);
    } else {
        snprintf(tmp, sizeof tmp, "\"max_score\":null,\"hits\":[");
    }
    body += tmp;
    int64_t ndocs = cfg ? (int64_t)cfg->id_offs.size() - 1 : 0;
    std::string esc_index;
    json_escape_append(esc_index, index_name, strlen(index_name));
    for (int i = 0; i < n; i++) {
        int32_t d = doc_ids[i];
        body += i ? ",{\"_index\":\"" : "{\"_index\":\"";
        body += esc_index;
        body += "\",\"_id\":\"";
        if (cfg && d >= 0 && d < ndocs) {
            json_escape_append(
                body, cfg->ids_blob.data() + cfg->id_offs[d],
                (size_t)(cfg->id_offs[d + 1] - cfg->id_offs[d]));
        } else {
            snprintf(tmp, sizeof tmp, "%d", d);
            body += tmp;
        }
        snprintf(tmp, sizeof tmp, "\",\"_score\":%.6g}",
                 (double)scores[i]);
        body += tmp;
    }
    body += "]}}";
    queue_response(s, token,
                   make_http(200, "application/json", body.data(),
                             body.size(), true));
    return 0;
}

// Bounce a fast-path request to the Python fallback queue (the drain
// decided it can't serve it: selection too big, shapes cold, ...).
int es_fast_bounce(int64_t h, uint64_t token) {
    Server* s = (Server*)h;
    if (!s) return -1;
    {
        std::lock_guard<std::mutex> lk(s->pending_mu);
        if (s->pending.find(token) == s->pending.end()) return -1;
    }
    {
        std::lock_guard<std::mutex> lk(s->fb_mu);
        s->fb_q.push_back(token);
    }
    s->fb_cv.notify_one();
    return 0;
}

// Pull the next fallback request. Buffers must hold method(16) and the
// returned pointers stay valid until es_respond(token). Returns 1, or 0
// on timeout.
int es_fallback_next(int64_t h, uint64_t* token, char* method, const char** path,
                     int64_t* path_len, const char** headers,
                     int64_t* headers_len, const char** body,
                     int64_t* body_len, int timeout_ms) {
    Server* s = (Server*)h;
    if (!s) return 0;
    uint64_t tok;
    {
        std::unique_lock<std::mutex> lk(s->fb_mu);
        if (s->fb_q.empty()) {
            s->fb_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms));
            if (s->fb_q.empty()) return 0;
        }
        tok = s->fb_q.front();
        s->fb_q.pop_front();
    }
    std::lock_guard<std::mutex> lk(s->pending_mu);
    auto it = s->pending.find(tok);
    if (it == s->pending.end()) return 0;
    *token = tok;
    strncpy(method, it->second.method.c_str(), 15);
    method[15] = 0;
    *path = it->second.path.data();
    *path_len = (int64_t)it->second.path.size();
    *headers = it->second.headers.data();
    *headers_len = (int64_t)it->second.headers.size();
    *body = it->second.body.data();
    *body_len = (int64_t)it->second.body.size();
    return 1;
}

// extra_headers: raw "Name: value\r\n" lines (may be empty/null).
int es_respond(int64_t h, uint64_t token, int status, const char* content_type,
               const char* body, int64_t body_len, int head_only,
               const char* extra_headers) {
    Server* s = (Server*)h;
    if (!s) return -1;
    std::string raw = make_http(status, content_type, body,
                                (size_t)body_len, true);
    size_t he = raw.find("\r\n\r\n");
    if (extra_headers && *extra_headers && he != std::string::npos)
        raw.insert(he + 2, extra_headers);
    if (head_only) {
        // HEAD: full headers (Content-Length of the would-be body), no body
        he = raw.find("\r\n\r\n");
        if (he != std::string::npos) raw.resize(he + 4);
    }
    queue_response(s, token, std::move(raw));
    return 0;
}

// IP filter rules: comma-separated CIDRs ("10.0.0.0/8,127.0.0.1").
// Returns the number of rules parsed, or -1.
int es_http_set_ipfilter(int64_t h, const char* allow_csv, const char* deny_csv) {
    Server* s = (Server*)h;
    if (!s) return -1;
    std::vector<std::pair<uint32_t, uint32_t>> allow, deny;
    auto parse_list = [](const char* csv,
                         std::vector<std::pair<uint32_t, uint32_t>>* out) {
        if (!csv || !*csv) return 0;
        int n = 0;
        std::string cur;
        for (const char* p = csv;; p++) {
            if (*p == ',' || *p == 0) {
                if (!cur.empty()) {
                    uint32_t a, m;
                    if (!parse_cidr(cur.c_str(), &a, &m)) return -1;
                    out->emplace_back(a, m);
                    n++;
                    cur.clear();
                }
                if (*p == 0) break;
            } else if (*p != ' ') {
                cur += *p;
            }
        }
        return n;
    };
    int na = parse_list(allow_csv, &allow);
    int nd = parse_list(deny_csv, &deny);
    if (na < 0 || nd < 0) return -1;
    std::lock_guard<std::mutex> lk(s->ip_mu);
    s->ip_allow.swap(allow);
    s->ip_deny.swap(deny);
    return na + nd;
}

void es_http_stats(int64_t h, long long* out) {
    Server* s = (Server*)h;
    if (!s) { memset(out, 0, 8 * sizeof(long long)); return; }
    out[0] = s->n_requests.load();
    out[1] = s->n_fast.load();
    out[2] = s->n_fallback.load();
    out[3] = s->open_conns.load();
    out[4] = s->n_rejected_ip.load();
    out[5] = out[6] = out[7] = 0;
}

// ------------------------------------------------------------- load gen
// A C++ HTTP client pool: n_conns keep-alive connections to 127.0.0.1,
// round-robin over the given bodies, total_reqs requests. Per-request
// latencies (µs) land in out_lat_us. Returns completed count; wall-clock
// seconds in *out_wall_s, responses with a status outside 2xx in
// *out_non2xx. Runs entirely off the GIL.
long long es_loadgen(int port, const char* path, const char* bodies_blob,
                     const int64_t* body_offs, int n_bodies, int n_conns,
                     long long total_reqs, int timeout_ms,
                     double* out_lat_us, double* out_wall_s,
                     long long* out_non2xx) {
    struct CConn {
        int fd = -1;
        std::string wbuf;
        size_t woff = 0;
        std::string rbuf;
        int body_idx = 0;
        std::chrono::steady_clock::time_point t0;
        bool inflight = false;
    };
    std::vector<std::string> reqs(n_bodies);
    for (int i = 0; i < n_bodies; i++) {
        const char* b = bodies_blob + body_offs[i];
        size_t bl = (size_t)(body_offs[i + 1] - body_offs[i]);
        char head[256];
        int hl = snprintf(head, sizeof head,
                          "POST %s HTTP/1.1\r\nHost: localhost\r\n"
                          "Content-Type: application/json\r\n"
                          "Content-Length: %zu\r\n\r\n",
                          path, bl);
        reqs[i].assign(head, hl);
        reqs[i].append(b, bl);
    }
    int epfd = epoll_create1(0);
    std::vector<CConn> conns(n_conns);
    long long sent = 0, done = 0, errors = 0, non2xx = 0;
    auto start_req = [&](CConn* c) {
        if (sent >= total_reqs) return;
        c->wbuf = reqs[c->body_idx];
        c->body_idx = (c->body_idx + n_conns) % n_bodies;
        c->woff = 0;
        c->t0 = std::chrono::steady_clock::now();
        c->inflight = true;
        sent++;
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.ptr = c;
        epoll_ctl(epfd, EPOLL_CTL_MOD, c->fd, &ev);
    };
    for (int i = 0; i < n_conns; i++) {
        CConn* c = &conns[i];
        c->fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
        c->body_idx = i % n_bodies;
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
        addr.sin_port = htons(port);
        connect(c->fd, (sockaddr*)&addr, sizeof addr);
        int one = 1;
        setsockopt(c->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.ptr = c;
        epoll_ctl(epfd, EPOLL_CTL_ADD, c->fd, &ev);
        start_req(c);
    }
    auto wall0 = std::chrono::steady_clock::now();
    auto deadline = wall0 + std::chrono::milliseconds(timeout_ms);
    epoll_event evs[64];
    while (done < total_reqs) {
        if (std::chrono::steady_clock::now() > deadline) break;
        int n = epoll_wait(epfd, evs, 64, 200);
        for (int i = 0; i < n; i++) {
            CConn* c = (CConn*)evs[i].data.ptr;
            if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
                errors++;
                epoll_ctl(epfd, EPOLL_CTL_DEL, c->fd, nullptr);
                close(c->fd);
                c->fd = -1;
                continue;
            }
            if ((evs[i].events & EPOLLOUT) && c->woff < c->wbuf.size()) {
                ssize_t w = write(c->fd, c->wbuf.data() + c->woff,
                                  c->wbuf.size() - c->woff);
                if (w > 0) c->woff += w;
                if (c->woff >= c->wbuf.size()) {
                    epoll_event ev{};
                    ev.events = EPOLLIN;
                    ev.data.ptr = c;
                    epoll_ctl(epfd, EPOLL_CTL_MOD, c->fd, &ev);
                }
            }
            if (evs[i].events & EPOLLIN) {
                char tmp[65536];
                for (;;) {
                    ssize_t r = read(c->fd, tmp, sizeof tmp);
                    if (r > 0) { c->rbuf.append(tmp, r); continue; }
                    if (r == 0) {
                        errors++;
                        epoll_ctl(epfd, EPOLL_CTL_DEL, c->fd, nullptr);
                        close(c->fd);
                        c->fd = -1;
                    }
                    break;
                }
                if (c->fd < 0) continue;
                // complete response? (headers + content-length body)
                size_t he = c->rbuf.find("\r\n\r\n");
                if (he == std::string::npos) continue;
                size_t cl = 0;
                {
                    size_t pos = c->rbuf.find("\r\n");
                    while (pos < he) {
                        size_t eol = c->rbuf.find("\r\n", pos + 2);
                        if (eol == std::string::npos || eol > he) eol = he;
                        const char* h = c->rbuf.data() + pos + 2;
                        size_t hl2 = eol - pos - 2;
                        if (hl2 > 15 && ieq(h, "content-length:", 15))
                            cl = strtoull(h + 15, nullptr, 10);
                        pos = eol;
                    }
                }
                if (c->rbuf.size() < he + 4 + cl) continue;
                // "HTTP/1.1 NNN ...": count a status outside 2xx
                if (c->rbuf.size() < 12 || c->rbuf[9] != '2') non2xx++;
                c->rbuf.erase(0, he + 4 + cl);
                if (c->inflight) {
                    auto dt = std::chrono::steady_clock::now() - c->t0;
                    if (done < total_reqs)
                        out_lat_us[done] =
                            std::chrono::duration<double, std::micro>(dt)
                                .count();
                    done++;
                    c->inflight = false;
                    start_req(c);
                }
            }
        }
    }
    *out_wall_s = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - wall0)
                      .count();
    *out_non2xx = non2xx;
    for (auto& c : conns)
        if (c.fd >= 0) close(c.fd);
    close(epfd);
    return done;
}

}  // extern "C"
