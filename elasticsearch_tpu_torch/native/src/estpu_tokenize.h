// ASCII word-boundary tokenizer (alnum runs, in-place lowercase), the
// port's own copy of the reference package's native/src/estpu_tokenize.h. The
// HTTP front (estpu_http.cpp) tokenizes fast-path query text with it, so
// it must give the same tokens as the analyzer that indexed the field:
// analysis/tokenizers.py StandardTokenizer plus lowercase, which on ASCII
// text splits on every character that is not a letter or a digit. Text
// with any non-ASCII byte never reaches it (the front falls back).
#pragma once
#include <cctype>

// Writes (start, end) byte offsets into `offsets` (2 ints per token) and
// lowercased bytes into `lowered` (same length as text). Returns the token
// count, or -1 if max_tokens is exceeded.
static inline int estpu_tokenize_ascii(const char* text, int len,
                                       int max_token_length, int* offsets,
                                       int max_tokens, char* lowered) {
    int n = 0;
    int i = 0;
    while (i < len) {
        unsigned char c = (unsigned char)text[i];
        bool word = (c < 128) && (isalnum(c) != 0);
        if (!word) {
            lowered[i] = (char)c;
            i++;
            continue;
        }
        int start = i;
        while (i < len) {
            unsigned char ch = (unsigned char)text[i];
            if (ch >= 128 || !isalnum(ch)) break;
            lowered[i] = (ch >= 'A' && ch <= 'Z') ? (char)(ch + 32)
                                                  : (char)ch;
            i++;
        }
        if (i - start <= max_token_length) {
            if (n >= max_tokens) return -1;
            offsets[2 * n] = start;
            offsets[2 * n + 1] = i;
            n++;
        }
    }
    return n;
}
